"""Product Quantization: independent k-means per dimension subspace.

(Reference: train_pq / quantize_pq, /root/reference/src/pq/PQ.jl:12-76.)
All m subspace codebooks train simultaneously via a vmapped batched k-means;
encoding is a vmapped distance-matmul + argmin.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from local_search_quantization.ops.kmeans import kmeans_batched, sq_distances
from local_search_quantization.ops.subspaces import (
    qerror_pq,
    split_subspaces,
)
from local_search_quantization.utils.config import PQConfig

Array = jax.Array


class PQModel(NamedTuple):
    C_sub: Array  # [m, h, ds_max] padded per-subspace codebooks
    B: Array  # [n, m] int32 training codes
    error: Array  # scalar train MSE


@jax.jit
def _assign_all(Xs: Array, C_sub: Array) -> Array:
    """Per-subspace nearest-center assignment: [m, n, ds] x [m, h, ds] -> [n, m]."""
    labels = jax.vmap(
        lambda xs, cs: jnp.argmin(sq_distances(xs, cs), axis=-1).astype(jnp.int32)
    )(Xs, C_sub)
    return labels.T


def quantize_pq(X: Array, C_sub: Array) -> Array:
    """Encode X with trained PQ codebooks. Returns [n, m] int32 codes.

    (Reference: quantize_pq, PQ.jl:12-41.)
    """
    m = C_sub.shape[0]
    return _assign_all(split_subspaces(X, m), C_sub)


def train_pq(
    X: Array, config: PQConfig = PQConfig(), *, key: Array | None = None
) -> PQModel:
    """Train PQ codebooks: k-means++ Lloyd's in each subspace.

    (Reference: train_pq, PQ.jl:44-76.)
    """
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    X = jnp.asarray(X, jnp.float32)
    Xs = split_subspaces(X, config.m)  # [m, n, ds_max]
    res = kmeans_batched(
        key, Xs, config.h, maxiter=config.kmeans_maxiter, tol=config.kmeans_tol
    )
    B = res.assignments.T.astype(jnp.int32)  # [n, m]
    err = qerror_pq(X, B, res.centers)
    return PQModel(res.centers, B, err)
