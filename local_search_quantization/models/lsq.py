"""LSQ: local-search quantization — the flagship full-MCQ trainer.

EM loop alternating a least-squares codebook update with iterated-local-search
ICM encoding; finishes by k-means-quantizing the reconstruction norms for the
query path. (Reference: train_lsq, /root/reference/src/lsq/LSQ.jl:10-88.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.costs import qerror
from local_search_quantization.ops.icm import ils_encode, resolve_condition_mode
from local_search_quantization.ops.norms import train_norm_codebook
from local_search_quantization.ops.solver import update_codebooks
from local_search_quantization.utils.config import LSQConfig

Array = jax.Array


class LSQModel(NamedTuple):
    C: Array  # [m, h, d] codebooks (in the *unrotated* data space)
    B: Array  # [n, m] int32 training codes
    cbnorms: Array  # [h] norm codebook (squared reconstruction norms)
    B_norms: Array  # [n] int32 norm codes of the training set
    obj: Array  # objective trace


def train_lsq(
    X: Array,
    B: Array,
    R: Array,
    config: LSQConfig = LSQConfig(),
    *,
    key: Array | None = None,
    verbose: bool = False,
) -> LSQModel:
    """Train LSQ warm-started from ChainQ (or OPQ) codes and rotation.

    Mirrors the reference flow (LSQ.jl:30-67): solve codebooks in the rotated
    space once, fold the rotation into the codebooks (C <- R C, row-major
    C @ R^T), then iterate entirely in the original data space:
    encode (ILS/ICM) <-> codebook least-squares.
    """
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    X = jnp.asarray(X, jnp.float32)
    B = jnp.asarray(B, jnp.int32)
    R = jnp.asarray(R, jnp.float32)
    h = config.h
    ils_kwargs = dict(
        ilsiter=config.ilsiter,
        icmiter=config.icmiter,
        npert=config.npert,
        randord=config.randord,
        condition_mode=resolve_condition_mode(config.condition_mode),
    )
    solve_kwargs = dict(
        method=config.codebook_method,
        ridge=config.ridge,
        niter=config.lsqr_niter,
    )

    # Initialize C in rotated space, then rotate the codebooks back.
    RX = X @ R
    C = update_codebooks(RX, B, h, **solve_kwargs)
    C = C @ R.T  # each center c -> R c
    if verbose:
        print(f"{-2:3d} {float(qerror(X, B, C)):.6e}")

    def encode(sub, B, C):
        """One ILS encode; in verbose mode also print the reference's
        per-round accept stats ("% codes equal / % better",
        encode_icm.jl:181-184)."""
        res = ils_encode(sub, X, B, C, **ils_kwargs, with_stats=verbose)
        if verbose:
            fb = np.asarray(res.frac_better) * 100
            feq = np.asarray(res.frac_equal) * 100
            print(
                "    ILS rounds: "
                + " ".join(
                    f"[{b:.2f}% better, {e:.2f}% codes equal]"
                    for b, e in zip(fb, feq)
                )
            )
        return res.B, res.cost

    # Initialize B.
    key, sub = jax.random.split(key)
    B, cost = encode(sub, B, C)
    if verbose:
        print(f"{-1:3d} {float(jnp.mean(cost)):.6e}")

    objs = []
    for it in range(1, config.niter + 1):
        obj = float(qerror(X, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:.6e}")
        # Stochastic relaxation (LSQ++, arXiv:1806.05643; beyond the
        # reference): temperature anneals linearly to zero, noise scaled to
        # the current per-dimension residual, so the final iterations are
        # plain LSQ and the accept-if-better encode contract is untouched.
        temp = max(0.0, 1.0 - it / config.niter)
        if config.sr_method == "SR-D" and temp > 0.0:
            key, knoise = jax.random.split(key)
            std = config.sr_scale * jnp.sqrt(temp * obj / X.shape[1])
            Xt = X + std * jax.random.normal(knoise, X.shape, X.dtype)
            C = update_codebooks(Xt, B, h, **solve_kwargs)
        else:
            C = update_codebooks(X, B, h, **solve_kwargs)
            if config.sr_method == "SR-C" and temp > 0.0:
                key, knoise = jax.random.split(key)
                std = config.sr_scale * jnp.sqrt(
                    temp * obj / (X.shape[1] * config.m)
                )
                C = C + std * jax.random.normal(knoise, C.shape, C.dtype)
        key, sub = jax.random.split(key)
        B, cost = encode(sub, B, C)

    # Norm codebook for the query path (LSQ.jl:69-85).
    key, sub = jax.random.split(key)
    cbnorms, B_norms = train_norm_codebook(sub, B, C, h)

    return LSQModel(C, B, cbnorms, B_norms, np.asarray(objs, np.float32))
