"""Zero-padded subspace layout for PQ/OPQ-style per-subspace codebooks.

The reference splits d dims into m contiguous subspaces of *unequal* size when
m does not divide d (`splitarray(1:d, m)`, /root/reference/src/utils.jl:152-177
— e.g. d=128, m=7 -> sizes [19,19,18,18,18,18,18]... first d%m parts one
larger). A stacked [m, h, ds] layout needs equal blocks, so subspaces are
zero-padded to the widest size: padded dimensions are zero in both data and
centers, so distances, k-means means, and reconstructions are unaffected.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from local_search_quantization.ops.costs import subspace_slices

Array = jax.Array


def padded_width(d: int, m: int) -> int:
    return -(-d // m)


def split_subspaces(X: Array, m: int) -> Array:
    """[n, d] -> [m, n, ds_max], each subspace zero-padded on the right."""
    X = jnp.asarray(X)
    n, d = X.shape
    spans = subspace_slices(d, m)
    w = padded_width(d, m)
    blocks = [
        jnp.pad(X[:, a:b], ((0, 0), (0, w - (b - a)))) for a, b in spans
    ]
    return jnp.stack(blocks)


def merge_subspaces(blocks: Array, d: int) -> Array:
    """[m, n, ds_max] -> [n, d], stripping the zero padding."""
    m = blocks.shape[0]
    spans = subspace_slices(d, m)
    parts = [blocks[i, :, : b - a] for i, (a, b) in enumerate(spans)]
    return jnp.concatenate(parts, axis=1)


def reconstruct_pq(B: Array, C_sub: Array, d: int) -> Array:
    """PQ reconstruction with the padded layout: [n, m] codes -> [n, d]."""
    gathered = jax.vmap(lambda Ci, bi: jnp.take(Ci, bi, axis=0), in_axes=(0, 1))(
        C_sub, B
    )  # [m, n, ds_max]
    return merge_subspaces(gathered, d)


def qerror_pq(X: Array, B: Array, C_sub: Array) -> Array:
    """MSE for per-subspace (PQ) codebooks.

    (Reference: `qerror_pq`, utils.jl:288-294.)
    """
    X = jnp.asarray(X)
    diff = reconstruct_pq(B, C_sub, X.shape[1]) - X
    return jnp.mean(jnp.sum(diff * diff, axis=-1))


def qerror_opq(X: Array, B: Array, C_sub: Array, R: Array) -> Array:
    """MSE for rotated per-subspace codebooks: mean ||R @ cb_n - x_n||^2.

    With row-major data the reference's column-vector rotation `R*CB`
    (utils.jl:297-310) becomes `CB @ R^T`.
    """
    X = jnp.asarray(X)
    diff = reconstruct_pq(B, C_sub, X.shape[1]) @ R.T - X
    return jnp.mean(jnp.sum(diff * diff, axis=-1))


def pq_full_codebooks(C_sub: Array, d: int) -> Array:
    """Lift padded per-subspace codebooks to full-dimensional [m, h, d].

    Codebook i is zero outside its dimension span — the same lift the sparse
    LSQ trainer performs on its PQ init
    (/root/reference/src/lsq_sparse/LSQ_SPGL1.jl:39-45).
    """
    m, h, w = C_sub.shape
    spans = subspace_slices(d, m)
    C = jnp.zeros((m, h, d), C_sub.dtype)
    for i, (a, b) in enumerate(spans):
        C = C.at[i, :, a:b].set(C_sub[i, :, : b - a])
    return C
