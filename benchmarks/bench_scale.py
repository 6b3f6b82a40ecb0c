#!/usr/bin/env python
"""SIFT1B-scale path benchmarks.

Three phases, all sized so no phase needs more than one compile per shape:

1. **encode64m** — sustained ILS encode of >=64M rows with all data
   GENERATED ON DEVICE (jax.random), so the number is the device's, not
   the host upload's (33 GB of f32 vectors). Exercises the platform's
   conditioning route (routes.ROUTES) at sustained scale: 512 chunks x
   131072 rows x 16 ILS rounds.
2. **query100m** — the real `_run_scan` driver over a 100M-row host-side
   code array: exceeds `base_segment` (1<<26), so codes stream through in
   two device segments whose per-segment top-k lists are merged ON HOST —
   the analog of the reference scanners' 1e7-entry buffering
   (/root/reference/src/linscan/cpp/linscan_aqd.cpp:52-53). Wall-clock
   includes the per-segment H2D code transfer (as the reference's
   includes disk reads).
3. **k10000** — the reference linscan default depth
   (/root/reference/src/linscan/Linscan.jl:5) over 1M codes through the
   `auto` route (the exact streaming merge on a GPU).

Run phases individually:  python -m benchmarks.bench_scale encode64m
"""

import sys
import time

import numpy as np

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass


def encode64m(n_total=64 * 1024 * 1024, chunk=131072, ilsiter=16,
              icmiter=4, npert=4, m=7, h=256, d=128):
    import jax
    import jax.numpy as jnp

    from local_search_quantization.ops import icm

    nchunks = n_total // chunk
    key = jax.random.PRNGKey(0)
    kx, kb, kenc = jax.random.split(key, 3)
    C = jnp.asarray(
        (np.random.default_rng(0).normal(size=(m, h, d)) * 12.0)
        .astype(np.float32)
    )

    @jax.jit
    def make_chunk(k1):
        ka, kc = jax.random.split(k1)
        X = jax.random.normal(ka, (chunk, d), jnp.float32) * 40.0
        B0 = jax.random.randint(kc, (chunk, m), 0, h, dtype=jnp.int32)
        return X, B0

    def encode_one(k1, k2):
        X, B0 = make_chunk(k1)
        res = icm.ils_encode(
            k2, X, B0, C, ilsiter=ilsiter, icmiter=icmiter, npert=npert,
            condition_mode="auto",
        )
        return jnp.sum(res.cost), jnp.sum(res.B)

    kxs = jax.random.split(kx, nchunks)
    kes = jax.random.split(kenc, nchunks)
    # Warm-up compile on chunk 0.
    c0, b0 = encode_one(kxs[0], kes[0])
    float(c0)
    t0 = time.perf_counter()
    acc = []
    for i in range(nchunks):
        acc.append(encode_one(kxs[i], kes[i]))
        # Bounded in-flight: keep ~8 chunks queued, then force the oldest.
        if len(acc) >= 8:
            float(acc.pop(0)[0])
    for c, b in acc:
        float(c)
    dt = time.perf_counter() - t0
    vs = n_total / dt
    print(f"[encode64m] {n_total:,} rows x {ilsiter} ILS rounds in "
          f"{dt:.1f}s = {vs:,.0f} vec/s end-to-end "
          f"({vs * ilsiter:,.0f} vec/s per ILS round), "
          f"codes+cost device-resident", flush=True)


def query100m(n_total=100_000_000, nq=2048, k=1000, m=7, h=256, d=128):
    import jax
    import jax.numpy as jnp

    from local_search_quantization.ops import adc

    rng = np.random.default_rng(1)
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    print(f"[query100m] generating {n_total:,} host-side codes...",
          flush=True)
    B = rng.integers(0, h, size=(n_total, m), dtype=np.int32)
    dbn = (rng.normal(size=n_total).astype(np.float32) ** 2) * 1e4
    Q = rng.normal(size=(nq, d)).astype(np.float32) * 40.0
    nseg = -(-n_total // (1 << 26))
    for run in ("cold", "steady"):
        # Second pass reuses every compiled executable (remote compiles
        # are per-process on this backend) but still pays the full
        # host-transpose + H2D code streaming per segment — the honest
        # production cost of a >HBM scan (the reference's analog pays
        # disk reads, linscan_aqd.cpp:52-53).
        t0 = time.perf_counter()
        res = adc.linscan_lsq(B, Q + (1.0 if run == "steady" else 0.0),
                              jnp.asarray(C), dbn, k=k)
        dt = time.perf_counter() - t0
        assert res.ids.shape == (nq, k) and res.ids.max() < n_total
        assert (np.diff(res.dists, axis=1) >= -1e-5).all()
        print(f"[query100m:{run}] {nq} queries x k={k} over {n_total:,} "
              f"codes ({nseg} host-merged segments) in {dt:.1f}s = "
              f"{nq/dt:,.1f} qps incl. {B.nbytes/2**30:.1f} GB H2D code "
              f"streaming", flush=True)


def k10000(n=1_000_000, nq=1024, k=10000, m=7, h=256, d=128):
    import jax
    import jax.numpy as jnp

    from local_search_quantization.ops import adc

    rng = np.random.default_rng(2)
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    dbn = (rng.normal(size=n).astype(np.float32) ** 2) * 1e4
    Q = rng.normal(size=(nq, d)).astype(np.float32) * 40.0
    # Warm (compile) with a different query set, then measure.
    adc.linscan_lsq(B, Q + 1.0, jnp.asarray(C), dbn, k=k, query_chunk=256)
    t0 = time.perf_counter()
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=256)
    dt = time.perf_counter() - t0
    assert res.ids.shape == (nq, k)
    print(f"[k10000] {nq} queries x k={k} over {n:,} codes (auto route) "
          f"in {dt:.1f}s = {nq/dt:,.1f} qps on "
          f"{jax.devices()[0].device_kind}", flush=True)


if __name__ == "__main__":
    phases = sys.argv[1:] or ["encode64m", "query100m", "k10000"]
    for p in phases:
        globals()[p]()
