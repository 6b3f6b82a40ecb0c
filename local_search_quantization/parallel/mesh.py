"""Device-mesh plumbing for the database ("n") axis.

MCQ's only parallel pattern is: replicate the (tiny) codebooks/LUTs, shard
the database axis, and merge per-shard top-k at query time. The reference
realizes this with Julia Distributed workers writing disjoint SharedArray
column ranges (/root/reference/src/encodings/encode_icm.jl:151-175) and with
sequential GPU memory chunks (encode_icm_cuda.jl:261-288). Here it is a 1-D
`jax.sharding.Mesh` over the data axis: `jit` inserts the (almost zero)
collectives, including the query-time all-gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def data_mesh(devices=None, axis: str = DATA_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices).reshape(-1), (axis,))


def mesh_platform(mesh: Mesh) -> str:
    """Platform of the mesh's devices ("gpu"/"cpu").

    Routing decisions for a mesh must key off THIS, not the process's
    default devices: a CPU mesh (e.g. the virtual 8-device test mesh) in a
    GPU process runs the CPU route.
    """
    return mesh.devices.flat[0].platform


def shard_batch(mesh: Mesh, x, axis: str = DATA_AXIS):
    """Shard the leading (database) dimension across the mesh; pads by
    duplicating the last row if it is not divisible by the mesh size.

    The duplicated pad rows WOULD double-weight that row in any training
    statistic computed over the sharded array — pass the true row count as
    `n_valid` to sharded_update_codebooks / make_lsq_train_step so the pad
    rows are masked out of the least-squares accumulation."""
    n = x.shape[0]
    k = mesh.shape[axis]
    pad = (-n) % k
    if pad:
        x = jnp.concatenate([x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])])
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_cols(mesh: Mesh, x, axis: str = DATA_AXIS):
    """Shard the LAST dimension across the mesh — the transposed [m, n]
    device code layout (ops/adc.lut_scan_block) shards its n axis here."""
    spec = P(*([None] * (x.ndim - 1)), axis)
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicated(mesh: Mesh, x):
    """Fully replicate an array (codebooks, LUT tensors, rotations)."""
    return jax.device_put(x, NamedSharding(mesh, P()))
