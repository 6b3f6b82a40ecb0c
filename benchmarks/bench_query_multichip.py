#!/usr/bin/env python
"""Multi-device query QPS smoke on a virtual 8-device CPU mesh.

Validates (and times) the sharded query path end-to-end: codes sharded on
the data axis, replicated LUTs, per-shard scan+top-k, one all-gather +
re-top-k merge (parallel/query.py). The absolute qps here is a CPU number —
the point is exercising the multi-device layout and its collective, which
real hardware would run over ICI (SURVEY.md §5: the only collective pattern
this domain needs). Run from the repo root:
python -m benchmarks.bench_query_multichip [k].
"""

import os
import sys
import time

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    from local_search_quantization.parallel.mesh import data_mesh
    from local_search_quantization.parallel.query import (
        sharded_linscan_lsq,
        sharded_linscan_pq,
    )

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n, d, m, h = 200_000, 128, 7, 256
    nq = 256
    rng = np.random.default_rng(0)
    C = (rng.normal(size=(m, h, d)) * 36.0).astype(np.float32)
    ds = -(-d // m)  # zero-padded subspace layout (ops/subspaces.py)
    C_sub = (rng.normal(size=(m, h, ds)) * 36.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng.integers(0, 256, size=(nq, d)).astype(np.float32)
    dbn = (rng.normal(size=n) ** 2 * 1e5).astype(np.float32)

    devices = jax.devices()
    assert len(devices) >= 8, f"expected 8 virtual devices, got {len(devices)}"
    mesh = data_mesh(devices[:8])
    print(f"[mesh] {mesh}", file=sys.stderr)

    for name, call in (
        ("lsq", lambda q: sharded_linscan_lsq(
            mesh, B, q, C, dbn, k=k, query_chunk=nq, block=1 << 14)),
        ("pq", lambda q: sharded_linscan_pq(
            mesh, B, q, C_sub, k=k, query_chunk=nq, block=1 << 14)),
    ):
        t0 = time.perf_counter()
        call(Q)  # compile + run
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = call(Q + 1.0)
        dt = time.perf_counter() - t0
        assert res.ids.shape == (nq, k)
        assert res.ids.min() >= 0 and res.ids.max() < n
        print(
            f"sharded_{name}: {nq / dt:,.0f} qps over {n:,} codes x 8 shards "
            f"(k={k})  [compile+first={warm:.1f}s steady={dt:.2f}s]"
        )


if __name__ == "__main__":
    main()
