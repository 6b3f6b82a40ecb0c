"""Reconstruction and quantization-error math shared by every MCQ method.

JAX counterparts of the reference's scalar-loop kernels
(`reconstruct`, `veccost`, `qerror`, `qerror_pq/opq` in
/root/reference/src/utils.jl:203-310): per-vector loops become whole-batch
gathers + reductions that XLA fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def reconstruct(B: Array, C: Array) -> Array:
    """Additive reconstruction: sum_i C[i, B[:, i], :].

    Args:
      B: [n, m] int codes (0-based).
      C: [m, h, d] stacked codebooks.

    Returns:
      [n, d] float32.
    """
    m = C.shape[0]
    # Gather per codebook then sum: [m, n, d] -> [n, d].
    gathered = jax.vmap(lambda Ci, bi: jnp.take(Ci, bi, axis=0), in_axes=(0, 1))(C, B)
    return jnp.sum(gathered, axis=0) if m > 1 else gathered[0]


def veccost(X: Array, B: Array, C: Array) -> Array:
    """Per-vector squared reconstruction error: ||x_n - sum_i C[i, b_ni]||^2.

    Returns [n] float32. (Reference: `veccost`, utils.jl:225-254.)
    """
    diff = reconstruct(B, C) - X
    return jnp.sum(diff * diff, axis=-1)


def qerror(X: Array, B: Array, C: Array) -> Array:
    """Mean squared quantization error over the dataset (scalar).

    (Reference: `qerror`, utils.jl:257-285.)
    """
    return jnp.mean(veccost(X, B, C))


def subspace_slices(d: int, m: int) -> list[tuple[int, int]]:
    """Contiguous (start, stop) spans splitting `d` dims into `m` parts.

    Mirrors the reference's `splitarray(1:d, m)` (utils.jl:152-177): when d is
    not divisible by m the first (d % m) parts get one extra dimension.
    """
    base, extra = divmod(d, m)
    spans = []
    start = 0
    for i in range(m):
        size = base + (1 if i < extra else 0)
        spans.append((start, start + size))
        start += size
    return spans
