#!/usr/bin/env python
"""Viterbi (ChainQ) exact-encode throughput on the current backend.

Marginal-cost methodology: two sizes, min-of-trials, tiny forced fetch.
Per vector the DP does (m-1) * 2h^2 elementwise ops (min-plus over [h, h]
transitions) — no matmul formulation exists for min-plus.

Run from the repo root: python -m benchmarks.bench_viterbi [block]
"""

import sys
import time

import numpy as np

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass

N_LO, N_HI = 1 << 15, 1 << 17
TRIALS = 3


def main():
    import jax.numpy as jnp

    from local_search_quantization.ops.viterbi import viterbi_encode

    d, m, h = 128, 7, 256
    block = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    rng = np.random.default_rng(0)
    C = jnp.asarray((rng.normal(size=(m, h, d)) * 36.0).astype(np.float32))
    X = jnp.asarray(rng.integers(0, 256, size=(N_HI, d)).astype(np.float32))

    def run(n):
        B = viterbi_encode(X[:n], C, block=block)
        _ = np.asarray(B[:1])  # compile + force
        best = float("inf")
        for t in range(TRIALS):
            t0 = time.perf_counter()
            B = viterbi_encode(X[:n] + np.float32(t + 1), C, block=block)
            _ = np.asarray(B[:1])
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = run(N_LO), run(N_HI)
    v = (N_HI - N_LO) / max(t_hi - t_lo, 1e-9)
    ops = (m - 1) * 2 * h * h
    print(f"viterbi m={m} h={h} block={block}: {v:12,.0f} vec/s "
          f"({v * ops / 1e12:.2f} T minplus-ops/s)")


if __name__ == "__main__":
    main()
