#!/usr/bin/env python
"""Serving-protocol overhead: scripts/serve.py vs direct Index.search.

The reference's serving story is bare in-process ccall scanners
(/root/reference/src/linscan/Linscan.jl:5-73) — it has no protocol to
measure. This pins what our production surface costs on top of the same
scan, in four response modes:

  json        — JSON request + ids + dists response (the default)
  json-ids    — JSON request, "dists": false (id-only)
  bin         — binary f32 query frame in, binary i32/f32 blocks out
  bin-ids     — binary both ways, ids only

Backends:
  --platform cpu (default): host native-scanner path (200k codes).
  --platform gpu: the device scan on the card.

One JAX process holds the device at a time (a JAX process reserves most
of a card's memory): the index build and the DIRECT phase each run in a
subprocess that exits before the next starts, then the server runs, and
this parent process, which pumps the queries, never imports JAX.

Usage:
  python benchmarks/bench_serve.py [--n 200000] [--nq 2048] [--k 100]
      [--batch 256] [--platform cpu|gpu] [--index DIR]
Prints one line per mode: qps + overhead vs direct.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import _bootstrap  # noqa: F401

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _queries(nq: int, d: int = 128) -> np.ndarray:
    # Query stream only (identical across phases/processes by seed);
    # SIFT-like magnitudes. Throughput is query-content-independent.
    rng = np.random.default_rng(123)
    return np.clip(rng.normal(120, 40, size=(nq, d)), 0,
                   255).astype("<f4")


def _build_index(path: str, n: int, platform: str) -> None:
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "build_index.py"),
         "--method", "pq", "--out", path, "--dataset", "synthetic",
         "--ntrain", "20000", "--nbase", str(n), "--m", "8", "--h", "256",
         "--niter", "10", "--platform", platform],
        cwd=REPO, check=True, timeout=3600,
    )


def _direct_qps(index: str, nq: int, k: int, batch: int,
                platform: str, precision: str = "f32") -> float:
    """Direct in-process Index.search qps, measured in THIS process."""
    import jax

    jax.config.update("jax_platforms", platform)
    from local_search_quantization.index import Index

    idx = Index.load(index)
    Q = _queries(nq, idx.d)
    idx.search(Q[:batch], k, precision=precision)  # warm: compile + upload
    t0 = time.perf_counter()
    for s in range(0, nq, batch):
        idx.search(Q[s:s + batch], k, precision=precision)
    return nq / (time.perf_counter() - t0)


def _pump(proc, Q: np.ndarray, k: int, batch: int, mode: str,
          trials: int = 3, precision: str = "f32") -> float:
    """Request/response pump over the serve.py stdio protocol (write-all
    then read-all deadlocks on pipe buffers). Binary pipes throughout;
    JSON text is just bytes on them. Requests are PRE-SERIALIZED outside
    the timed loop — the measurement isolates the SERVER-side protocol
    cost (parse + search + serialize) — and the
    best of `trials` passes is reported (shared-core noise)."""
    nq, d = Q.shape
    rd = proc.stdout

    # One pre-serialized request stream PER TRIAL, each with the query
    # rows rolled by the trial index, so no trial replays a byte-identical
    # stream.
    all_reqs = []
    for t in range(trials + 1):  # +1: stream 0 doubles as the warm pass
        Qt = np.roll(Q, t, axis=0)
        reqs = []
        for i, s in enumerate(range(0, nq, batch)):
            qb = Qt[s:s + batch]
            hdr = {"id": i, "k": k}
            if precision != "f32":
                hdr["precision"] = precision
            payload = b""
            if mode.startswith("bin"):
                hdr["binary_vectors"] = int(qb.shape[0])
                hdr["binary"] = True
                payload = np.ascontiguousarray(qb).tobytes()
            else:
                hdr["vectors"] = qb.tolist()
            if mode.endswith("ids"):
                hdr["dists"] = False
            reqs.append(json.dumps(hdr).encode() + b"\n" + payload)
        all_reqs.append(reqs)

    def roundtrip(r: bytes):
        proc.stdin.write(r)
        proc.stdin.flush()
        resp = json.loads(rd.readline())
        assert "error" not in resp, resp
        if mode.startswith("bin"):
            nb = resp["nq"] * resp["k"] * 4
            np.frombuffer(rd.read(nb), "<i4")
            if resp["binary"]["dists"]:
                np.frombuffer(rd.read(nb), "<f4")

    roundtrip(all_reqs[0][0])  # warm round-trip (compile/upload)
    best = float("inf")
    for t in range(trials):
        reqs = all_reqs[t + 1]
        t0 = time.perf_counter()
        for r in reqs:
            roundtrip(r)
        best = min(best, time.perf_counter() - t0)
    return nq / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--platform", default="cpu", choices=("cpu", "gpu"))
    ap.add_argument("--index", default=None,
                    help="prebuilt index dir (built if absent)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="scan precision for BOTH the direct phase and "
                         "every protocol request (the serving fast mode)")
    ap.add_argument("--_direct", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args._direct:
        qps = _direct_qps(args.index, args.nq, args.k, args.batch,
                          args.platform, args.precision)
        print(json.dumps({"direct_qps": qps}))
        return

    td = None
    index = args.index
    if index is None or not os.path.exists(index):
        if index is None:
            td = tempfile.TemporaryDirectory()
            index = os.path.join(td.name, "idx")
        _build_index(index, args.n, args.platform)

    # Direct phase in its own process, which exits before the server
    # starts: one JAX process on the device at a time.
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--_direct",
         "--index", index, "--nq", str(args.nq), "--k", str(args.k),
         "--batch", str(args.batch), "--platform", args.platform,
         "--precision", args.precision],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=3600,
    )
    direct_qps = json.loads(out.stdout.splitlines()[-1])["direct_qps"]

    serve_cmd = [sys.executable, os.path.join(REPO, "scripts", "serve.py"),
                 "--index", index, "--k", str(args.k)]
    serve_cmd += ["--platform", args.platform]
    proc = subprocess.Popen(serve_cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, cwd=REPO)
    ready = json.loads(proc.stdout.readline())
    assert ready.get("ready"), ready
    # The index's own dimension (the direct phase uses idx.d likewise) —
    # a d=960 index must not be pumped with d=128 queries.
    Q = _queries(args.nq, int(ready.get("d", 128)))

    rows = {}
    for mode in ("json", "json-ids", "bin", "bin-ids"):
        rows[mode] = _pump(proc, Q, args.k, args.batch, mode,
                           precision=args.precision)
    proc.stdin.write(b"EOF\n")
    proc.stdin.flush()
    proc.wait(timeout=60)
    if td is not None:
        td.cleanup()

    print(f"n={args.n} nq={args.nq} k={args.k} batch={args.batch} "
          f"platform={args.platform} precision={args.precision} | "
          f"direct {direct_qps:,.0f} qps")
    for mode, qps in rows.items():
        print(f"  {mode:9s} {qps:,.0f} qps  "
              f"(overhead {100 * (direct_qps / qps - 1):.0f}%)")


if __name__ == "__main__":
    main()
