#!/usr/bin/env python
"""Dev micro-benchmark: ICM conditioning strategies on the current backend."""

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

    from local_search_quantization.ops.icm import ils_encode

    n, d, m, h = 1 << 17, 128, 7, 256
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.integers(0, 256, size=(n, d)).astype(np.float32))
    C = jnp.asarray((rng.normal(size=(m, h, d)) * 36.0).astype(np.float32))
    B = jnp.asarray(rng.integers(0, h, size=(n, m), dtype=np.int32))
    key = jax.random.PRNGKey(0)

    modes = sys.argv[1:] or ["gather", "matmul"]
    for mode in modes:
        step = jax.jit(
            lambda key, B: ils_encode(
                key, X, B, C, ilsiter=1, icmiter=4, npert=4, condition_mode=mode
            )
        )
        jax.block_until_ready(step(key, B))  # compile
        iters = 5
        t0 = time.perf_counter()
        bb = B
        for i in range(iters):
            res = step(jax.random.fold_in(key, i), bb)
            bb = res.B
        jax.block_until_ready(res)
        dt = time.perf_counter() - t0
        print(f"{mode:8s}: {n * iters / dt:12.0f} vec/s  "
              f"({dt / iters * 1e3:.1f} ms/round) on "
              f"{jax.devices()[0].device_kind}")


if __name__ == "__main__":
    main()
