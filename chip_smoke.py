#!/usr/bin/env python
"""On-card smoke test of the whole main path: `python chip_smoke.py`.

Runs on one GPU, phase after phase, each checked against its plain
reference; prints each phase's wall and compile seconds on its own line,
and as the LAST line exactly one JSON object,
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
A failed check raises and exits non-zero with no such line; without a GPU
the script exits non-zero before any phase.

  device    JAX's platform, device kind and count; the card's name and
            power limit from nvidia-smi (a child process that stays off
            JAX).
  encode    ILS encode, "gather" and "matmul" conditioning, n=131072, m=7,
            h=256, d=128, 4 rounds: accept-if-better against an exact f64
            recompute, device cost within ENCODE_REL_TOL of it, the two
            modes' mean costs within 1%; vector-rounds/s.
  search    the exact device route over 1M codes, PQ-64 (m=8) and LSQ-64
            (m=7 + norm byte), h=256, nq=256, k=100 and k=10000: distances
            within adc.SCAN_REL_TOL of the f64 oracle, every id within that
            band of the k-th value and none below it missing; queries/s.
  ties      a tie-planted base (64 distinct code rows over 1M): ids at
            k=10000 equal the stable-argsort (dist, id) oracle id for id.
  bf16      precision="bf16": ids equal the oracle over the bf16-rounded
            tables, and the rounded metric differs from f32 by > 1e-6 of
            the error scale (the rounding was not compiled away).
  main_path a SIFT1M-shaped synthetic corpus (d=128, 100k train, 1M base,
            10k queries): Index.build("lsq") at 64 bits (m=7 + norm byte,
            h=256, base ilsiter=16), save, load, search at k=100 with
            ordered recall@1/10/100, then the scripts/serve.py loop
            answers JSON and binary-frame requests with Index.search's ids.
  gpu_tests the tests marked `gpu`, run in this process on the card.

--chips 4 runs only the four-card path and what it is compared with:
Index.search(mesh=...) through the serve loop against the single-card
exact route, and make_lsq_train_step on a 4-card mesh against one card.
--rehearse runs the same phases at tiny sizes on the CPU (the last line
then names platform "cpu"). One JAX process does everything: the serve
loop runs in-process, because a second process could not get the card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Encode cost contract: the in-loop f32 cost (ops/icm.cost_from_luts, LUTs
# built at "highest" precision) against an f64 recompute of ||x - recon||^2.
# Summing ~m^2 / 2 f32 terms of the size of the cost itself errs by ~1e-6
# of it; 1e-5 leaves room without admitting a TF32-built table (~1e-3).
ENCODE_REL_TOL = 1e-5
MODE_PARITY = 0.01  # gather vs matmul mean encode cost, relative


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Phases:
    """Per-phase wall and compile seconds. Compile time is what JAX
    reports for tracing, lowering and backend compilation inside the
    phase (a persistent-cache hit skips the backend compile)."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self, jax):
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self._EVENTS:
            self.compile_s += duration

    def run(self, name, fn, *args):
        c0, t0 = self.compile_s, time.perf_counter()
        info = fn(*args)
        wall = time.perf_counter() - t0
        extra = " ".join(f"{k}={v}" for k, v in (info or {}).items())
        print(f"[phase] {name}: ok wall_s={wall:.2f} "
              f"compile_s={self.compile_s - c0:.2f} {extra}", flush=True)
        return info


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` from a child process."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi: not available"
    return out.stdout.strip() or f"nvidia-smi: rc={out.returncode}"


def sizes(rehearse: bool) -> dict:
    if rehearse:
        return dict(enc_n=2048, enc_m=4, enc_h=64, enc_d=32, enc_rounds=2,
                    n=16384, nq=16, d=32, m_pq=4, m_lsq=3, h=64,
                    ks=(20, 1000), nq_ties=8, k_bf16=20,
                    ntrain=3000, nbase=12000, nquery=200, mp_m=4, mp_h=32,
                    mp_ilsiter=2, mp_d=32, mesh_n=8192)
    return dict(enc_n=1 << 17, enc_m=7, enc_h=256, enc_d=128, enc_rounds=4,
                n=1 << 20, nq=256, d=128, m_pq=8, m_lsq=7, h=256,
                ks=(100, 10000), nq_ties=64, k_bf16=100,
                ntrain=100_000, nbase=1_000_000, nquery=10_000, mp_m=7,
                mp_h=256, mp_ilsiter=16, mp_d=128, mesh_n=1 << 20)


# --------------------------------------------------------------- oracles

def f64_dists(luts64, B, extra64, rows=slice(None)):
    """f64 distance matrix [nq_rows, n] summed from the same f32 LUT
    entries the device scans."""
    lut = luts64[rows]
    full = np.zeros((lut.shape[0], B.shape[0]))
    if extra64 is not None:
        full += extra64[None, :]
    for i in range(B.shape[1]):
        full += lut[:, i, :][:, B[:, i]]
    return full


# ---------------------------------------------------------------- phases

def phase_encode(S, rng):
    from local_search_quantization.ops.icm import ils_encode

    n, m, h, d = S["enc_n"], S["enc_m"], S["enc_h"], S["enc_d"]
    rounds = S["enc_rounds"]
    X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 36.0).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C64, X64 = C.astype(np.float64), X.astype(np.float64)

    def exact_cost(B):
        r = np.zeros((n, d))
        for i in range(m):
            r += C64[i, B[:, i]]
        return np.sum((r - X64) ** 2, axis=1)

    cost0 = exact_cost(B0)
    info, means = {}, {}
    for mode in ("gather", "matmul"):
        def run(seed):
            out = ils_encode(jax.random.PRNGKey(seed), jnp.asarray(X),
                             jnp.asarray(B0), jnp.asarray(C),
                             ilsiter=rounds, icmiter=4, npert=min(4, m),
                             condition_mode=mode)
            return jax.block_until_ready(out)

        run(0)  # compile
        t0 = time.perf_counter()
        res = run(1)
        dt = time.perf_counter() - t0
        Bn = np.asarray(res.B)
        c_exact = exact_cost(Bn)
        check((c_exact <= cost0 * (1 + ENCODE_REL_TOL)).all(),
              f"{mode}: accept-if-better violated against the f64 cost")
        rel = float(np.max(np.abs(np.asarray(res.cost, np.float64) - c_exact)
                           / np.maximum(c_exact, 1.0)))
        check(rel <= ENCODE_REL_TOL,
              f"{mode}: device cost off the f64 recompute by {rel:.2e} "
              f"(> {ENCODE_REL_TOL})")
        check(c_exact.mean() < cost0.mean(), f"{mode}: no improvement")
        means[mode] = float(c_exact.mean())
        info[f"{mode}_vec_rounds_per_s"] = f"{n * rounds / dt:.0f}"
        info[f"{mode}_max_rel_cost_err"] = f"{rel:.2e}"
    parity = abs(means["gather"] - means["matmul"]) / means["gather"]
    check(parity <= MODE_PARITY,
          f"gather vs matmul mean cost differ by {parity:.3%}")
    info["mode_parity"] = f"{parity:.2e}"
    return info


def _scan_case(luts_fn, Q, B, extra, ks):
    """Exact device route on one base for each k: the f64 band check and
    queries/s (second call, codes already on the device)."""
    from local_search_quantization.ops import adc

    nq = Q.shape[0]
    state = adc.prepare_device_codes(B, extra)
    luts = luts_fn(jnp.asarray(Q))
    luts64 = np.asarray(luts, np.float64)
    extra64 = None if extra is None else extra.astype(np.float64)
    tol = adc.SCAN_REL_TOL * np.asarray(
        adc.scan_error_scale(luts, None if extra is None
                             else jnp.asarray(extra)), np.float64)
    out = {}
    results = {}
    for k in ks:
        def call():
            return adc._run_scan(luts_fn, Q, B, k=k, extra=extra,
                                 topk_method="exact", device_state=state)
        call()  # compile
        t0 = time.perf_counter()
        results[k] = call()
        out[k] = nq / (time.perf_counter() - t0)
    worst = 0.0
    viol = missing = 0
    for q0 in range(0, nq, 32):
        rows = slice(q0, min(q0 + 32, nq))
        full = f64_dists(luts64, B, extra64, rows)
        kths = np.partition(full, [k - 1 for k in ks], axis=1)
        t = tol[rows, None]
        for k in ks:
            ids = np.asarray(results[k].ids)[rows]
            dists = np.asarray(results[k].dists)[rows]
            at = np.take_along_axis(full, ids, axis=1)
            worst = max(worst, float(np.max(np.abs(dists - at) / t)))
            kth = kths[:, k - 1:k]
            viol += int(np.sum(at > kth + t))
            got = np.zeros(full.shape, bool)
            np.put_along_axis(got, ids, True, axis=1)
            missing += int(np.sum((full < kth - t) & ~got))
    check(worst <= 1.0, f"scan error {worst:.2f}x SCAN_REL_TOL")
    check(viol == 0, f"{viol} returned ids outside the oracle band")
    check(missing == 0, f"{missing} ids below the band not returned")
    return out, worst * adc.SCAN_REL_TOL


def phase_search(S, rng):
    from local_search_quantization.ops import adc

    n, nq, d, h = S["n"], S["nq"], S["d"], S["h"]
    Q = (rng.normal(size=(nq, d)) * 30.0).astype(np.float32)
    info = {}
    # PQ-64: m subspace codebooks, no extra term.
    m = S["m_pq"]
    C_sub = jnp.asarray(
        (rng.normal(size=(m, h, d // m)) * 12.0).astype(np.float32))
    B = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    qps, err = _scan_case(lambda q: adc.pq_query_luts(q, C_sub), Q, B, None,
                          S["ks"])
    for k, v in qps.items():
        info[f"pq_k{k}_qps"] = f"{v:.0f}"
    info["pq_max_rel_err"] = f"{err:.2e}"
    # LSQ-64: m full-dimensional codebooks + the norm term.
    m = S["m_lsq"]
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    dbn = _recon_sqnorms(C, B)
    Cj = jnp.asarray(C)
    qps, err = _scan_case(lambda q: adc.lsq_query_luts(q, Cj), Q, B, dbn,
                          S["ks"])
    for k, v in qps.items():
        info[f"lsq_k{k}_qps"] = f"{v:.0f}"
    info["lsq_max_rel_err"] = f"{err:.2e}"
    info["scan_rel_tol"] = adc.SCAN_REL_TOL
    return info


def _recon_sqnorms(C, B):
    r = np.zeros((B.shape[0], C.shape[2]), np.float32)
    for i in range(C.shape[0]):
        r += C[i, B[:, i]]
    return np.sum(r * r, axis=1, dtype=np.float64).astype(np.float32)


def phase_ties_and_bf16(S, rng):
    import ml_dtypes

    from local_search_quantization.ops import adc

    n, d, m, h, nq = S["n"], S["d"], S["m_lsq"], S["h"], S["nq_ties"]
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    proto = rng.integers(0, h, size=(64, m)).astype(np.uint8)
    assign = rng.integers(0, 64, size=n)
    B = proto[assign]
    dbn = _recon_sqnorms(C, proto)[assign]
    Q = (rng.normal(size=(nq, d)) * 30.0).astype(np.float32)
    Cj = jnp.asarray(C)
    luts = np.asarray(adc.lsq_query_luts(jnp.asarray(Q), Cj), np.float32)
    info = {}

    # Deep-k ties: stable argsort over ids IS the (dist, id) lexsort.
    k = S["ks"][-1]
    res = adc.linscan_lsq(B, Q, Cj, dbn, k=k, topk_method="exact")
    full = f64_dists(luts.astype(np.float64), B, dbn.astype(np.float64))
    oracle = np.argsort(full, axis=1, kind="stable")[:, :k]
    check(np.array_equal(np.asarray(res.ids), oracle),
          "deep-k ids differ from the lexicographic oracle")
    info["deepk_k"] = k

    # bf16: the oracle rounds the same f32 tables the device rounds.
    kb = S["k_bf16"]
    rl = luts.astype(ml_dtypes.bfloat16).astype(np.float64)
    check(np.any(rl != luts), "bf16 rounding must change the tables")
    full_r = f64_dists(rl, B, dbn.astype(np.float64))
    oracle_b = np.argsort(full_r, axis=1, kind="stable")[:, :kb]
    res_b = adc.linscan_lsq(B, Q, Cj, dbn, k=kb, topk_method="exact",
                            precision="bf16")
    ids_b = np.asarray(res_b.ids)
    check(np.array_equal(ids_b, oracle_b),
          "bf16 ids differ from the rounded-table oracle")
    scale = np.asarray(adc.scan_error_scale(jnp.asarray(luts),
                                            jnp.asarray(dbn)))[:, None]
    at_r = np.take_along_axis(full_r, ids_b, axis=1)
    at_f = np.take_along_axis(full, ids_b, axis=1)
    gap = float(np.max(np.abs(at_r - at_f) / scale))
    dev_err = float(np.max(np.abs(np.asarray(res_b.dists) - at_r) / scale))
    check(dev_err <= adc.SCAN_REL_TOL,
          f"bf16 distances off the rounded metric by {dev_err:.2e}: the "
          "rounding barrier did not hold")
    check(gap > 1e-6, f"rounded and f32 metrics indistinguishable ({gap})")
    info["bf16_metric_gap"] = f"{gap:.2e}"
    info["bf16_max_rel_err"] = f"{dev_err:.2e}"
    return info


def _serve_requests(idx, Q, k, mesh=None):
    """Drive scripts/serve.py's loop in-process with JSON and binary-frame
    requests; every answer must carry Index.search's ids."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from serve import serve

    req = io.BytesIO()
    spans = []
    for i, (a, b) in enumerate([(0, 3), (3, 8), (8, 9)]):
        req.write(json.dumps({"id": i, "vectors": Q[a:b].tolist(), "k": k,
                              "dists": False}).encode() + b"\n")
        spans.append((i, a, b, False))
    for i, (a, b) in enumerate([(16, 32), (32, 40)], start=10):
        req.write(json.dumps({"id": i, "binary_vectors": b - a,
                              "binary": True, "k": k}).encode() + b"\n")
        req.write(np.ascontiguousarray(Q[a:b], "<f4").tobytes())
        spans.append((i, a, b, True))
    req.write(b"EOF\n")
    req.seek(0)
    out = io.BytesIO()
    serve(idx, req, out, k=k, mesh=mesh)
    out.seek(0)
    ready = json.loads(out.readline())
    check(ready.get("ready") is True, f"serve did not announce ready: {ready}")
    for rid, a, b, binary in spans:
        head = json.loads(out.readline())
        check(head.get("id") == rid and "error" not in head,
              f"serve answered {head} to request {rid}")
        if binary:
            nq_, kk = head["nq"], head["k"]
            ids = np.frombuffer(out.read(nq_ * kk * 4), "<i4").reshape(nq_, kk)
            out.read(nq_ * kk * 4)  # distances
        else:
            ids = np.asarray(head["ids"])
        want = np.asarray(idx.search(Q[a:b], k, mesh=mesh).ids)
        check(np.array_equal(ids, want),
              f"serve request {rid}: ids differ from Index.search")
    return len(spans)


def phase_main_path(S, rng, niter, workdir):
    from local_search_quantization.index import Index
    from local_search_quantization.utils.eval import eval_recall
    from local_search_quantization.utils.synth import synthetic_dataset

    t0 = time.perf_counter()
    data = synthetic_dataset(0, d=S["mp_d"], n_train=S["ntrain"],
                             n_base=S["nbase"], n_query=S["nquery"])
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = Index.build(data.train, data.base, "lsq", m=S["mp_m"], h=S["mp_h"],
                      niter=niter, ilsiter=S["mp_ilsiter"], seed=0)
    t_build = time.perf_counter() - t0
    path = os.path.join(workdir, "index_lsq")
    idx.save(path)
    idx = Index.load(path)
    check(idx.B.dtype == np.uint8, f"loaded codes are {idx.B.dtype}")
    idx.search(data.query[:1], k=100)  # compile
    t0 = time.perf_counter()
    res = idx.search(data.query, k=100)
    t_search = time.perf_counter() - t0
    rec = eval_recall(data.gt, np.asarray(res.ids), 100, verbose=False)
    r1, r10, r100 = rec[0], rec[9], rec[99]
    check(r1 <= r10 <= r100 and r100 >= r1 + 0.1 and r100 > 0.5,
          f"recall out of order: r@1={r1} r@10={r10} r@100={r100}")
    nreq = _serve_requests(idx, data.query, 100)
    return {"niter": niter, "ilsiter": S["mp_ilsiter"], "n": idx.n,
            "nq": len(data.query), "data_s": f"{t_data:.1f}",
            "build_s": f"{t_build:.1f}", "search_qps":
            f"{len(data.query) / t_search:.0f}", "r@1": f"{r1:.4f}",
            "r@10": f"{r10:.4f}", "r@100": f"{r100:.4f}",
            "serve_requests": nreq}


class _Outcomes:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        # One count per test: its call, or the setup that skipped or
        # failed it (plus any failing teardown).
        if (report.when == "call" or report.failed
                or (report.skipped and report.when == "setup")):
            self.counts[report.outcome] += 1


def phase_gpu_tests(rehearse):
    import pytest

    # conftest.py forces the CPU platform unless told the caller owns it.
    os.environ["LSQ_TEST_PLATFORM"] = jax.devices()[0].platform
    tally = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[tally])
    c = tally.counts
    check(jax.devices()[0].platform == ("cpu" if rehearse else "gpu"),
          "the test phase changed the platform")
    check(rc == 0 and c["failed"] == 0, f"gpu tests failed: rc={rc} {c}")
    if rehearse:
        check(c["skipped"] > 0, "no gpu-marked tests were collected")
    else:
        check(c["passed"] > 0 and c["skipped"] == 0,
              f"gpu tests did not all run on the card: {c}")
    return c


def phase_mesh(S, rng, ndev):
    from local_search_quantization.index import Index
    from local_search_quantization.parallel.encode import make_lsq_train_step
    from local_search_quantization.parallel.mesh import data_mesh, shard_batch
    from local_search_quantization.utils.synth import synthetic_dataset

    devs = jax.devices()[:ndev]
    mesh, one = data_mesh(devs), data_mesh(devs[:1])
    info = {}
    # Mesh serving: serve loop over a 4-device mesh vs the single-device
    # exact route.
    data = synthetic_dataset(1, d=S["mp_d"], n_train=S["ntrain"] // 4,
                             n_base=S["mesh_n"], n_query=64)
    idx = Index.build(data.train, data.base, "lsq", m=S["mp_m"],
                      h=S["mp_h"], niter=2, ilsiter=4, seed=0)
    for k in S["ks"]:
        a = idx.search(data.query, k=k, mesh=mesh)
        b = idx.search(data.query, k=k)
        check(np.array_equal(np.asarray(a.ids), np.asarray(b.ids)),
              f"mesh ids differ from the single-device route at k={k}")
    info["mesh_serve_requests"] = _serve_requests(idx, data.query, 100,
                                                  mesh=mesh)
    # Training step: sharded codebook solve + encode vs one device.
    n, d, m, h = S["enc_n"], S["enc_d"], S["enc_m"], S["enc_h"]
    X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    out = {}
    for name, msh in (("one", one), ("mesh", mesh)):
        step = make_lsq_train_step(msh, h, ilsiter=2, icmiter=4,
                                   npert=min(4, m))
        # The step donates its codes argument: upload afresh per mesh.
        C, Bn, cost = step(jax.random.PRNGKey(0),
                           shard_batch(msh, jnp.asarray(X)),
                           shard_batch(msh, jnp.asarray(B)))
        out[name] = (np.asarray(C), np.asarray(cost, np.float64))
    (C1, c1), (C4, c4) = out["one"], out["mesh"]
    cdiff = float(np.max(np.abs(C4 - C1)) / np.max(np.abs(C1)))
    check(cdiff <= 2e-3, f"sharded codebook solve differs by {cdiff:.2e}")
    parity = abs(c4.mean() - c1.mean()) / c1.mean()
    check(parity <= MODE_PARITY,
          f"sharded vs single-device step cost differ by {parity:.3%}")
    info["codebook_rel_diff"] = f"{cdiff:.2e}"
    info["step_cost_parity"] = f"{parity:.2e}"
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="every phase at tiny sizes on the CPU")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--niter", type=int, default=None,
                    help="training iterations of the main-path build "
                         "(default 10, Index.build's; 2 in rehearsal)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "local_search_quantization")):
        sys.exit("chip_smoke.py: no local_search_quantization package next "
                 "to this script; run it from a checkout of the repository")
    if args.rehearse:
        # As many virtual CPU devices as the run would have cards.
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        os.environ["XLA_FLAGS"] = " ".join(
            flags + [f"--xla_force_host_platform_device_count={args.chips}"])
    sys.path.insert(0, HERE)

    global jax, jnp, np
    import jax
    import jax.numpy as jnp
    import numpy as np

    from local_search_quantization.routes import enable_compile_cache

    devices = jax.devices()
    platform = devices[0].platform
    want = "cpu" if args.rehearse else "gpu"
    if platform != want:
        sys.exit(f"chip_smoke.py: needs a GPU, JAX found {platform!r} "
                 f"devices (use --rehearse for the CPU run)")
    if len(devices) < args.chips:
        sys.exit(f"chip_smoke.py: --chips {args.chips} needs that many "
                 f"devices, JAX found {len(devices)}")
    cache = enable_compile_cache()
    S = sizes(args.rehearse)
    niter = args.niter or (2 if args.rehearse else 10)
    workdir = os.path.join(HERE, ".cache", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    print(f"[device] platform={platform} kind={devices[0].device_kind} "
          f"count={len(devices)} compile_cache={cache}", flush=True)
    print(f"[device] {card_name_and_power()}", flush=True)

    phases = Phases(jax)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.chips > 1:
        phases.run(f"mesh{args.chips}", phase_mesh, S, rng, args.chips)
    else:
        phases.run("encode", phase_encode, S, rng)
        phases.run("search", phase_search, S, rng)
        phases.run("ties_bf16", phase_ties_and_bf16, S, rng)
        phases.run("main_path", phase_main_path, S, rng, niter, workdir)
        phases.run("gpu_tests", phase_gpu_tests, args.rehearse)
    print(f"[total] wall_s={time.perf_counter() - t0:.1f} "
          f"compile_s={phases.compile_s:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
