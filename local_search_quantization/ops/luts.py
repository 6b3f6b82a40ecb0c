"""Unary / pairwise lookup-table construction for the MCQ MRF.

The MCQ objective for a vector x and codes (b_1..b_m) is
    ||x - sum_i C[i, b_i]||^2
      = ||x||^2 + sum_i (||C[i,b_i]||^2 - 2 x.C[i,b_i])   (unary terms)
        + sum_{i<j} 2 C[i,b_i].C[j,b_j]                   (pairwise terms)

The reference builds these tables one codebook(-pair) at a time with BLAS
(`get_unaries` / `get_binaries`, /root/reference/src/utils.jl:94-144). Here the
stacked [m, h, d] codebook layout turns each into a single einsum (one
matmul for XLA).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def get_unaries(X: Array, C: Array, *, precision="highest") -> Array:
    """Unary terms: unaries[n, i, k] = ||C[i,k]||^2 - 2 x_n . C[i,k].

    Args:
      X: [n, d] data.
      C: [m, h, d] stacked codebooks.

    Returns:
      [n, m, h] float32.
    """
    cross = jnp.einsum(
        "nd,mhd->nmh", X, C, preferred_element_type=jnp.float32, precision=precision
    )
    sqnorm = jnp.sum(C * C, axis=-1, dtype=jnp.float32)  # [m, h]
    return sqnorm[None, :, :] - 2.0 * cross


def get_binaries(C: Array, *, precision="highest") -> Array:
    """All pairwise terms: binaries[i, j] = 2 * C[i] @ C[j]^T, an [h, h] table.

    Returns the full (symmetric-transpose) [m, m, h, h] tensor; entry (i, j)
    holds 2*C[i]C[j]^T so binaries[j, i] == binaries[i, j]^T. The diagonal is
    never used by ICM (a node is not conditioned on itself); it is left as
    computed. At m=8, h=256 this is 8*8*256*256*4 B = 16.8 MB, which an
    H100's 50 MB L2 cache holds whole during ICM's row gathers.
    """
    return 2.0 * jnp.einsum(
        "ihd,jkd->ijhk", C, C, preferred_element_type=jnp.float32, precision=precision
    )


def get_chain_binaries(C: Array, *, precision="highest") -> Array:
    """Chain pairwise terms: binaries[i] = 2 * C[i] @ C[i+1]^T for i=0..m-2.

    Returns [m-1, h, h]. Mirrors the inline construction in the reference's
    Viterbi driver (/root/reference/src/encodings/encode_chain.jl:102-105).
    """
    return 2.0 * jnp.einsum(
        "ihd,ikd->ihk",
        C[:-1],
        C[1:],
        preferred_element_type=jnp.float32,
        precision=precision,
    )
