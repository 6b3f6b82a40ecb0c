"""Exact chain (Viterbi) MCQ encoding as batched min-plus dynamic programming.

The reference decodes one vector at a time with scalar loops over h*h
transitions (/root/reference/src/encodings/encode_chain.jl:2-89). Here the
forward pass is a `lax.scan` over the m-1 chain edges whose body is a
min-plus "matmul": carry [nc, h] + transition [h, h] reduced over the
incoming state — vectorized across a whole block of vectors on the VPU.
The backtrace is a reverse `lax.scan` of [nc, h] gathers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from local_search_quantization.ops.luts import get_chain_binaries, get_unaries

Array = jax.Array


def _viterbi_block(X: Array, C: Array, bb: Array) -> Array:
    """Viterbi-encode one block of vectors. X: [nc, d] -> codes [nc, m]."""
    unaries = get_unaries(X, C)  # [nc, m, h]

    def fwd(carry, inputs):
        u_i, bb_i = inputs  # [nc, h], [h, h]
        # total[v, k, j] = cost of being in state k at node i-1 and moving to j.
        total = carry[:, :, None] + bb_i[None, :, :]  # [nc, h, h]
        best_k = jnp.argmin(total, axis=1).astype(jnp.int32)  # [nc, h]
        carry = jnp.min(total, axis=1) + u_i
        return carry, best_k

    carry0 = unaries[:, 0, :]
    us = jnp.moveaxis(unaries[:, 1:, :], 1, 0)  # [m-1, nc, h]
    carry, argmins = jax.lax.scan(fwd, carry0, (us, bb))

    last = jnp.argmin(carry, axis=-1).astype(jnp.int32)  # [nc]

    def bwd(code_next, argmin_i):
        # argmins[i][v, j] = best state at node i given state j at node i+1.
        code = jnp.take_along_axis(argmin_i, code_next[:, None], axis=1)[:, 0]
        return code, code

    _, codes_prefix = jax.lax.scan(bwd, last, argmins, reverse=True)  # [m-1, nc]
    return jnp.concatenate([codes_prefix.T, last[:, None]], axis=1)  # [nc, m]


@partial(jax.jit, static_argnames=("block",))
def _viterbi_padded(Xp: Array, C: Array, block: int) -> Array:
    bb = get_chain_binaries(C)  # [m-1, h, h]
    nb = Xp.shape[0] // block
    blocks = Xp.reshape(nb, block, Xp.shape[-1])
    return jax.lax.map(lambda xb: _viterbi_block(xb, C, bb), blocks).reshape(
        nb * block, C.shape[0]
    )


def viterbi_encode(X: Array, C: Array, *, block: int = 1024) -> Array:
    """Exact chain decoding of X against chain codebooks C.

    Args:
      X: [n, d] data (numpy or JAX).
      C: [m, h, d] full-dimensional chain codebooks (codebook i only interacts
        with i-1 and i+1).
      block: vectors per DP block; bounds the [block, h, h] transient
        (block=1024, h=256 -> 256 MB fp32 before fusion; XLA fuses the
        broadcast+min so the live footprint is far smaller).

    Returns:
      B: [n, m] int32 codes, the exact per-vector minimizers of the chain
      objective. (Reference driver: encode_chain.jl:93-123.)
    """
    n = X.shape[0]
    pad = (-n) % block
    Xp = jnp.asarray(X)
    if pad:
        Xp = jnp.concatenate([Xp, jnp.broadcast_to(Xp[-1:], (pad, X.shape[-1]))])
    return _viterbi_padded(Xp, C, block)[:n]
