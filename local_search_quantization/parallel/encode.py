"""Sharded (multi-device) LSQ training and encoding.

The database axis is embarrassingly parallel for encoding (codebooks/LUTs
replicated, zero collectives inside ICM) and needs exactly one all-reduce for
the codebook update (the Gram/AtX accumulators). This module expresses both
with `shard_map` over a 1-D mesh — the JAX counterpart of the
reference's Julia worker fan-out (/root/reference/src/encodings/encode_icm.jl:
151-175, codebook_update.jl:66-79), with XLA collectives instead of
SharedArrays.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from local_search_quantization.ops.icm import (
    ILSResult, ils_encode, resolve_condition_mode,
)
from local_search_quantization.ops.solver import code_gram
from local_search_quantization.parallel.mesh import DATA_AXIS, mesh_platform

Array = jax.Array


def sharded_ils_encode(
    mesh: Mesh,
    key: Array,
    X: Array,
    B0: Array,
    C: Array,
    *,
    ilsiter: int,
    icmiter: int,
    npert: int,
    randord: bool = True,
    condition_mode: str = "auto",
    axis: str = DATA_AXIS,
) -> ILSResult:
    """ILS-encode a database sharded over the mesh's data axis.

    Per-shard RNG streams are decorrelated by folding the shard index into
    the key — which also means each shard draws its OWN random ICM visit
    orders (the reference's master instead picks one `randperm(m)` per
    round for all workers, encode_icm.jl:151-175). Any visit order is a
    valid ICM sweep and the per-vector accept-if-better guarantee is
    order-independent, but a sharded run is NOT bit-comparable to a
    single-device run with the same key. condition_mode "auto" resolves
    through the route of the mesh's own platform (routes.ROUTES).
    """
    mode = resolve_condition_mode(condition_mode, mesh_platform(mesh))

    def local(key, X, B0, C):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return ils_encode(
            key, X, B0, C,
            ilsiter=ilsiter, icmiter=icmiter, npert=npert, randord=randord,
            condition_mode=mode,
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis, None), P()),
        out_specs=ILSResult(P(axis, None), P(axis)),
    )
    return fn(key, X, B0, C)


def sharded_update_codebooks(
    mesh: Mesh,
    X: Array,
    B: Array,
    h: int,
    *,
    ridge: float = 1e-4,
    n_valid: int | None = None,
    axis: str = DATA_AXIS,
) -> Array:
    """Codebook least-squares with shard-local Gram accumulation + one psum.

    Each shard builds its local G = A^T A and A^T X as one-hot matmuls; a
    single all-reduce pair merges them; the (tiny, [mh, mh]) Cholesky solve
    runs replicated on every device.

    n_valid: total TRUE row count when the sharded arrays carry padding
    (shard_batch duplicates the last row to divide by the mesh size —
    unmasked, those duplicates would be double-counted in the
    least-squares). Rows at global index >= n_valid get their codes set to
    -1, whose one-hot is all-zero, so they contribute nothing to G/AtX.
    """
    m = B.shape[1]
    d = X.shape[1]

    def local(X, B):
        if n_valid is not None:
            start = jax.lax.axis_index(axis) * X.shape[0]
            row = jnp.arange(X.shape[0], dtype=jnp.int32) + start
            B = jnp.where((row < n_valid)[:, None], B, -1)
        G, AtX = code_gram(B, X, h, pvary_axis=axis)
        G = jax.lax.psum(G, axis)
        AtX = jax.lax.psum(AtX, axis)
        lam = ridge * jnp.trace(G) / G.shape[0]
        K = jax.scipy.linalg.solve(
            G + lam * jnp.eye(G.shape[0], dtype=G.dtype), AtX, assume_a="pos"
        )
        return K.reshape(m, h, d)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(),
    )
    return fn(X, B)


def make_lsq_train_step(
    mesh: Mesh,
    h: int,
    *,
    ilsiter: int,
    icmiter: int,
    npert: int,
    randord: bool = True,
    ridge: float = 1e-4,
    n_valid: int | None = None,
    axis: str = DATA_AXIS,
):
    """One jitted, fully-sharded LSQ EM step: codebook solve + ILS encode.

    Returns step(key, X, B) -> (C, B_new, cost) with X/B sharded on the data
    axis and C replicated. This is the multi-device "training step" surface
    (also used by __graft_entry__.dryrun_multichip). Pass n_valid when the
    sharded arrays carry shard_batch padding (see sharded_update_codebooks).
    """

    @partial(jax.jit, donate_argnums=(2,))
    def step(key, X, B):
        C = sharded_update_codebooks(mesh, X, B, h, ridge=ridge,
                                     n_valid=n_valid, axis=axis)
        res = sharded_ils_encode(
            mesh, key, X, B, C,
            ilsiter=ilsiter, icmiter=icmiter, npert=npert, randord=randord,
            axis=axis,
        )
        return C, res.B, res.cost

    return step
