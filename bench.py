#!/usr/bin/env python
"""Headline benchmark: ILS/ICM encoding throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Metric: vectors/second through one full ILS round (perturbation + 4 ICM
sweeps over m=7 codebooks at h=256, d=128 + per-vector accept-if-better) at
the reference's SIFT1M base-encoding config (demos/demo_lsq.jl:34-38 with
icmiter=4, npert=4, randord), with the conditioning the platform's route
picks (routes.ROUTES). This is the computation both training and base
encoding spend their time in, and the one the reference offloads to CUDA
(encode_icm_cuda.jl / cudautils.cu).

Timing: one jitted call runs ILS_ROUNDS rounds over n vectors — the
unary/pairwise LUT builds amortized over the rounds exactly as real base
encoding amortizes them — timed on the host clock around
block_until_ready, median of TRIALS calls after a compiling warm-up. The
rate is n * ILS_ROUNDS / median seconds. Exits non-zero without a GPU.

vs_baseline: ratio to the reference GPU encoder's estimated throughput on
the hardware it shipped for (NVIDIA Titan X): ~333k vec/s per ILS round,
an estimate from the kernel's memory traffic (the repo publishes no
numbers).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def baseline_vecs_per_sec(m: int = 7, icmiter: int = 4) -> float:
    """Reference CUDA encoder estimate at an (m, icmiter) shape.

    333k vec/s per ILS round at the demo config (m=7, icmiter=4), estimated
    from the kernel's memory traffic on the hardware the reference shipped
    for (Titan X): icmiter*m*(m-1) conditioning passes per vector dominate
    (encode_icm_cuda.jl:165-207, cudautils.cu:236-339), so the estimate
    scales as 1/(icmiter*m*(m-1)). At the PQ width m=8 the per-vector work
    is 56/42 = 1.33x larger -> ~250k vec/s. This function is the single
    machine-readable denominator for every ILS throughput ratio.
    """
    passes = icmiter * m * (m - 1)
    return 333_000.0 * (4 * 7 * 6) / passes


BASELINE_VECS_PER_SEC = baseline_vecs_per_sec(7, 4)  # headline config
ILS_ROUNDS = 16  # the base-encode round count ("LSQ-16")
TRIALS = 5


def main():
    import jax
    import jax.numpy as jnp

    from local_search_quantization.ops.icm import (
        ils_encode, resolve_condition_mode,
    )
    from local_search_quantization.routes import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    n, d, m, h = 1 << 17, 128, 7, 256
    icmiter, npert = 4, 4
    rng = np.random.default_rng(0)
    # SIFT-like scale (uint8-valued features) so LUT magnitudes are realistic.
    X = jnp.asarray(rng.integers(0, 256, size=(n, d)).astype(np.float32))
    C = jnp.asarray((rng.normal(size=(m, h, d)) * 36.0).astype(np.float32))
    B = jnp.asarray(rng.integers(0, h, size=(n, m), dtype=np.int32))
    mode = resolve_condition_mode("auto")

    fn = jax.jit(
        lambda key, B: ils_encode(
            key, X, B, C, ilsiter=ILS_ROUNDS, icmiter=icmiter, npert=npert,
            randord=True, condition_mode=mode,
        )
    )
    jax.block_until_ready(fn(jax.random.PRNGKey(0), B))  # compile
    times = []
    for t in range(TRIALS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(jax.random.PRNGKey(t + 1), B))
        times.append(time.perf_counter() - t0)
    vecs_per_sec = n * ILS_ROUNDS / float(np.median(times))
    print(
        f"[bench] {n} vecs x {ILS_ROUNDS} ILS rounds (icm={icmiter}, m={m}, "
        f"h={h}, d={d}, mode={mode}): median {np.median(times):.4f}s of "
        f"{TRIALS} on {dev.device_kind} ({card})",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "ils_encode_throughput",
                "value": round(vecs_per_sec, 1),
                "unit": "vectors/sec/chip (1 ILS round: 4 ICM sweeps, m=7, h=256, d=128)",
                "vs_baseline": round(vecs_per_sec / BASELINE_VECS_PER_SEC, 3),
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
