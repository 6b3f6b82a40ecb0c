#!/usr/bin/env python
"""Training-stage and base-encode wall-clock at paper scale on the GPU.

Steady-state PQ/OPQ training (100k vectors, 100 iterations) and the LSQ-16
encode of 1M vectors end-to-end (including host transfers, with
encode_chunked's bounded dispatch-ahead pipeline).
Each stage is run twice; the second time is the steady-state number (the
first includes one-time compiles).

Run from the repo root: python -m benchmarks.bench_train_encode [stages]
stages: any of pq,opq,encode (default all).
"""

import sys
import time

import numpy as np

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass


def main():
    import jax
    import jax.numpy as jnp

    from local_search_quantization.models import train_opq, train_pq
    from local_search_quantization.ops.icm import encode_chunked
    from local_search_quantization.utils.config import OPQConfig, PQConfig

    stages = (sys.argv[1].split(",") if len(sys.argv) > 1
              else ["pq", "opq", "encode"])
    rng = np.random.default_rng(0)
    Xt = rng.integers(0, 256, size=(100_000, 128)).astype(np.float32)

    if "pq" in stages:
        times = []
        for seed in (0, 1):
            t0 = time.perf_counter()
            pq = train_pq(Xt, PQConfig(m=8, h=256, kmeans_maxiter=100,
                                       seed=seed))
            _ = float(pq.error)
            times.append(time.perf_counter() - t0)
        print(f"PQ train 100k x m=8 x 100 iters: first {times[0]:.1f}s "
              f"(compile), steady {times[1]:.1f}s", flush=True)

    if "opq" in stages:
        times = []
        for seed in (0, 1):
            t0 = time.perf_counter()
            opq = train_opq(Xt, OPQConfig(m=8, h=256, niter=100, seed=seed))
            _ = float(opq.obj[-1])
            times.append(time.perf_counter() - t0)
        print(f"OPQ train 100k x m=8 x 100 alternations: first {times[0]:.1f}s"
              f" (compile), steady {times[1]:.1f}s", flush=True)

    if "encode" in stages:
        n, d, m, h = 1_000_000, 128, 7, 256
        X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
        C = jnp.asarray((rng.normal(size=(m, h, d)) * 36.0).astype(np.float32))
        B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
        _ = encode_chunked(jax.random.PRNGKey(0), X[: 1 << 17], B0[: 1 << 17],
                           C, ilsiter=16, icmiter=4, npert=4)
        t0 = time.perf_counter()
        res = encode_chunked(jax.random.PRNGKey(1), X, B0, C,
                             ilsiter=16, icmiter=4, npert=4)
        dt = time.perf_counter() - t0
        print(f"LSQ-16 base encode of {n:,} vectors: {dt:.1f}s wall "
              f"({n / dt:,.0f} vec/s end-to-end incl. host transfers); "
              f"mean cost {float(np.mean(res.cost)):.2f}", flush=True)


if __name__ == "__main__":
    main()
