"""Optimized Product Quantization: PQ plus a learned global rotation.

Alternating minimization over (R, C, B): closed-form orthogonal Procrustes
rotation from the SVD of the data/reconstruction cross-covariance, per-subspace
center means, and nearest-center assignments.
(Reference: train_opq / quantize_opq, /root/reference/src/opq/OPQ.jl:11-101,
adapted there from M. Norouzi's Cartesian k-means code.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from local_search_quantization.models.pq import _assign_all, quantize_pq
from local_search_quantization.ops.kmeans import sq_distances
from local_search_quantization.ops.subspaces import (
    qerror_opq,
    reconstruct_pq,
    split_subspaces,
)
from local_search_quantization.utils.config import OPQConfig

Array = jax.Array


class OPQModel(NamedTuple):
    C_sub: Array  # [m, h, ds_max]
    B: Array  # [n, m] int32
    R: Array  # [d, d] rotation
    obj: Array  # [niter+1] objective trace


def quantize_opq(X: Array, R: Array, C_sub: Array) -> Array:
    """Rotate into code space, then PQ-encode. (Reference: OPQ.jl:11-19.)

    With row-major data the reference's `R' * X` is `X @ R`.
    """
    return quantize_pq(jnp.asarray(X) @ R, C_sub)


def _update_centers_batched(Xs: Array, B: Array, h: int, prev: Array) -> Array:
    """Per-subspace center means from assignments; empty centers keep their
    previous value (the reference leaves them at zero, OPQ.jl update_centers! —
    keeping the previous center is a strict improvement and changes nothing
    for non-empty clusters)."""

    def one(xs, labels, prev_c):
        # onehot^T @ X as a matmul rather than a segment_sum scatter
        # (see ops/kmeans._update_centers).
        oh = jax.nn.one_hot(labels, h, dtype=jnp.float32)  # [n, h], exact
        sums = jnp.einsum(
            "nh,nd->hd", oh, xs, preferred_element_type=jnp.float32,
            precision="highest",
        )
        counts = jnp.sum(oh, axis=0)
        means = sums / jnp.maximum(counts, 1.0)[:, None]
        return jnp.where((counts > 0)[:, None], means, prev_c)

    return jax.vmap(one)(Xs, B.T, prev)


@partial(jax.jit, static_argnames=("niter", "h"))
def _opq_loop(X: Array, Xs0_C: Array, B0: Array, R0: Array, niter: int, h: int):
    m = Xs0_C.shape[0]
    d = X.shape[1]

    def recon(C, B):
        # Shared padded-layout reconstruction (ops/subspaces.py).
        return reconstruct_pq(B, C, d)  # [n, d] in rotated space

    def body(carry, _):
        C, B, R = carry
        CB = recon(C, B)
        obj = jnp.mean(jnp.sum((CB @ R.T - X) ** 2, axis=-1))

        # Procrustes rotation update: R = U V^T from svd(X^T CB).
        U, _, Vh = jnp.linalg.svd(X.T @ CB, full_matrices=False)
        R = U @ Vh
        RXs = split_subspaces(X @ R, m)
        # Center update from current assignments, then reassign.
        C = _update_centers_batched(RXs, B, h, C)
        B = _assign_all(RXs, C)
        return (C, B, R), obj

    # The reference's `for iter=0:niter` (OPQ.jl:73-97) is INCLUSIVE:
    # niter+1 update iterations, with obj[iter] recorded at the START of
    # each — matched here entry-for-entry (obj has niter+1 entries and the
    # final update's improvement is, as in the reference, not in the
    # trace).
    (C, B, R), objs = jax.lax.scan(
        body, (Xs0_C, B0, R0), None, length=niter + 1
    )
    return C, B, R, objs


def train_opq(
    X: Array, config: OPQConfig = OPQConfig(), *, key: Array | None = None
) -> OPQModel:
    """Train OPQ: alternating rotation / centers / assignments.

    (Reference: train_opq, OPQ.jl:21-101; the whole loop is one compiled
    `lax.scan`, with the d x d SVD running on-device — d is tiny.)
    """
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    X = jnp.asarray(X, jnp.float32)
    n, d = X.shape
    m, h = config.m, config.h

    if config.init == "natural":
        R = jnp.eye(d, dtype=jnp.float32)
    elif config.init == "random":
        key, sub = jax.random.split(key)
        U, _, _ = jnp.linalg.svd(jax.random.normal(sub, (d, d)))
        R = U
    else:
        raise ValueError(f"unknown OPQ init {config.init!r}")

    RXs = split_subspaces(X @ R, m)
    # Initialize centers by sampling h distinct training vectors per
    # subspace, with an INDEPENDENT draw per subspace (the reference draws
    # `perm = sample(1:n, h)` inside the per-subspace loop, OPQ.jl:51-54;
    # one shared permutation would correlate the initial centers across
    # subspaces).
    key, sub = jax.random.split(key)
    perms = jax.vmap(lambda k_: jax.random.permutation(k_, n)[:h])(
        jax.random.split(sub, m)
    )  # [m, h]
    C0 = jax.vmap(lambda xs, p: xs[p])(RXs, perms)
    B0 = _assign_all(RXs, C0)

    C, B, R, objs = _opq_loop(X, C0, B0, R, config.niter, h)
    return OPQModel(C, B, R, objs)
