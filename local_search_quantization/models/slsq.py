"""Sparse LSQ: additive MCQ with L1-constrained (sparse) codebooks.

Same EM structure as LSQ, but the codebook update solves an L1-ball
constrained least-squares (FISTA, replacing the reference's MATLAB SPGL1
bridge) followed by keep-top-S thresholding; codebooks are full-dimensional
lifts of a PQ initialization. Training happens in the rotated space with R
fixed, exactly as the reference.
(Reference: train_lsq_sparse, /root/reference/src/lsq_sparse/LSQ_SPGL1.jl:7-120.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.costs import qerror
from local_search_quantization.ops.icm import ils_encode, resolve_condition_mode
from local_search_quantization.ops.norms import train_norm_codebook
from local_search_quantization.ops.prox import solve_l1_constrained, threshold_top_s
from local_search_quantization.ops.subspaces import pq_full_codebooks
from local_search_quantization.utils.config import SLSQConfig

Array = jax.Array


class SLSQModel(NamedTuple):
    C: Array  # [m, h, d] sparse codebooks (rotated space)
    B: Array  # [n, m] int32
    R: Array  # [d, d] (fixed; from the PQ/OPQ init)
    cbnorms: Array  # [h]
    B_norms: Array  # [n]
    obj: Array  # per-iteration objective
    l0: Array  # per-iteration nnz(C)
    l1: Array  # per-iteration ||C||_1


def train_lsq_sparse(
    X: Array,
    B: Array,
    C_sub_init: Array,
    R: Array,
    config: SLSQConfig = SLSQConfig(),
    *,
    key: Array | None = None,
    verbose: bool = False,
) -> SLSQModel:
    """Train sparse LSQ from a PQ init.

    Args:
      X: [n, d] training data (unrotated).
      B: [n, m] init codes (PQ's).
      C_sub_init: [m, h, ds] padded PQ codebooks (lifted to full-dim here,
        LSQ_SPGL1.jl:39-45).
      R: [d, d] rotation (identity for plain PQ init).
    """
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    X = jnp.asarray(X, jnp.float32)
    B = jnp.asarray(B, jnp.int32)
    R = jnp.asarray(R, jnp.float32)
    n, d = X.shape
    m, h = config.m, config.h
    S = config.S if config.S > 0 else d * h
    ils_kwargs = dict(
        ilsiter=config.ilsiter,
        icmiter=config.icmiter,
        npert=config.npert,
        randord=config.randord,
        condition_mode=resolve_condition_mode(config.condition_mode),
    )

    RX = X @ R
    C = pq_full_codebooks(jnp.asarray(C_sub_init), d)
    # tau from the init codebooks' L1 norm (demo_lsq_sparse.jl:32-41).
    tau = jnp.float32(config.tau_scale) * jnp.sum(jnp.abs(C))
    if verbose:
        print(f"Warm start error: {float(qerror(RX, B, C)):e}")

    def sparse_update(C_prev):
        K = solve_l1_constrained(B, RX, h, tau, C_prev,
                                 iters=config.prox_iters, lr=config.prox_lr)
        return threshold_top_s(K, S)

    C = sparse_update(C)
    if verbose:
        nnz = int(jnp.sum(C != 0))
        print(f"{nnz} non-zero elements. l1 norm is {float(jnp.sum(jnp.abs(C))):e}")

    key, sub = jax.random.split(key)
    B, _ = ils_encode(sub, RX, B, C, **ils_kwargs)

    objs, l0s, l1s = [], [], []
    for it in range(1, config.niter + 1):
        obj = float(qerror(RX, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:e}")
        C = sparse_update(C)
        l0s.append(float(jnp.sum(C != 0)))
        l1s.append(float(jnp.sum(jnp.abs(C))))
        key, sub = jax.random.split(key)
        B, _ = ils_encode(sub, RX, B, C, **ils_kwargs)

    key, sub = jax.random.split(key)
    cbnorms, B_norms = train_norm_codebook(sub, B, C, h)
    return SLSQModel(
        C, B, R, cbnorms, B_norms,
        np.asarray(objs, np.float32),
        np.asarray(l0s, np.float32),
        np.asarray(l1s, np.float32),
    )
