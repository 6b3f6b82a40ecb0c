#!/usr/bin/env python
"""ADC query throughput (QPS) at SIFT1M scale on the current backend."""

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

    from local_search_quantization.ops import adc

    n, d, m, h = 1_000_000, 128, 7, 256
    nq = 1024
    mode = sys.argv[1] if len(sys.argv) > 1 else "matmul"
    topk_method = sys.argv[4] if len(sys.argv) > 4 else "exact"
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    base_block = int(sys.argv[3]) if len(sys.argv) > 3 else (1 << 16)
    if len(sys.argv) > 5:  # e.g. 960 = GIST1M dimension
        d = int(sys.argv[5])
    rng = np.random.default_rng(0)
    C = (rng.normal(size=(m, h, d)) * 36.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng.integers(0, 256, size=(nq, d)).astype(np.float32)
    dbn = (rng.normal(size=n) ** 2 * 1e5).astype(np.float32)

    # Warm-up chunk (compiles the scan).
    t0 = time.perf_counter()
    adc.linscan_lsq(B[:base_block], Q[:256], jnp.asarray(C), dbn[:base_block],
                    k=k, query_chunk=256, mode=mode, base_block=base_block,
                    topk_method=topk_method)
    print(f"[warmup+compile {time.perf_counter()-t0:.1f}s]", file=sys.stderr)

    t0 = time.perf_counter()
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=256,
                          mode=mode, base_block=base_block,
                          topk_method=topk_method)
    dt = time.perf_counter() - t0
    # NOTE: second run needs a fresh compile for the full-size base; the
    # timing above includes that — subtract via a second identical-shape run.
    t0 = time.perf_counter()
    res = adc.linscan_lsq(B, Q + 1.0, jnp.asarray(C), dbn, k=k,
                          query_chunk=256, mode=mode, base_block=base_block,
                          topk_method=topk_method)
    dt2 = time.perf_counter() - t0
    qps = nq / dt2
    codes_per_sec = qps * n
    print(f"mode={mode}/{topk_method}: {qps:,.0f} qps over {n:,} codes (k={k}) "
          f"= {codes_per_sec:.3e} code-dists/s  [first={dt:.1f}s steady={dt2:.1f}s]")


if __name__ == "__main__":
    main()
