"""Sharded ADC query: per-shard top-k scan + all-gather merge.

The closest thing this domain has to a collective pattern (SURVEY.md §5):
base codes sharded on the data axis, per-query LUTs replicated, each
device scans its shard and keeps a local top-k, then one all-gather +
re-top-k produces the global result. No per-code traffic crosses devices.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from local_search_quantization.ops.adc import (
    KNNResult,
    _scan_topk,
    lsq_query_luts,
    pq_query_luts,
    round_bf16,
)
from local_search_quantization.parallel.mesh import (
    DATA_AXIS, mesh_platform,
)
from local_search_quantization.routes import platform_route

Array = jax.Array


def sharded_scan_topk(
    mesh: Mesh,
    luts: Array,
    Bt: Array,
    extra: Array | None,
    k: int,
    *,
    block: int = 1 << 15,
    axis: str = DATA_AXIS,
    precision: str = "f32",
) -> KNNResult:
    """Scan a sharded code database; return global top-k per query.

    Bt: [m, n] TRANSPOSED device codes (ops/adc.lut_scan_block), sharded
    on `axis` along n (n divisible by mesh size * block — callers pad with
    +inf `extra` rows as in ops/adc._run_scan).

    Each shard runs the single-device streaming lax.top_k merge, which is
    exactly (dist, id)-lexicographic, and the merge preserves lex order for
    free: per-shard lists are id-ascending within a tie, shards own
    ascending global-id ranges, and lax.top_k's stable tie-break follows
    the shard-major candidate order — which IS global-id order across
    shards. So the mesh route agrees with the single-device exact route
    id-for-id.

    precision="bf16" is the serving fast mode: the LUTs are rounded to
    bf16 HERE — the single barrier site for the mesh path — so a direct
    caller gets the rounded metric its precision label promises, and the
    mesh route's ids match the single-device bf16 route id-for-id.
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    # The mesh's own platform (not the process default) must have a route.
    platform_route(mesh_platform(mesh))
    if precision == "bf16":
        luts = round_bf16(luts).astype(jnp.float32)
    nshards = mesh.shape[axis]
    shard_n = Bt.shape[1] // nshards

    def local(luts, Bt, extra):
        idx = jax.lax.axis_index(axis)
        n_loc = Bt.shape[1]
        res = _scan_topk(luts, Bt, extra, k, min(block, n_loc),
                         pvary_axis=axis)
        # Unfilled slots (k > valid rows in this shard) carry the -1 id
        # sentinel; offsetting it would forge a plausible id on another
        # shard. Keep the sentinel — its +inf distance loses the merge to
        # any real candidate, and surfaces honestly if none exists.
        gids = jnp.where(res.ids >= 0, res.ids + idx * shard_n, -1)
        # New leading axis of size 1 per shard; shard_map stacks to [S, nq, k].
        return KNNResult(res.dists[None], gids[None])

    in_extra = P(axis) if extra is not None else None
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, axis), in_extra),
        out_specs=KNNResult(P(axis, None, None), P(axis, None, None)),
    )
    per_shard = fn(luts, Bt, extra)  # [S, nq, k]

    # Merge the S per-shard top-k lists: one re-top-k over S*k candidates
    # per query (runs as a normal jitted op over the sharded arrays — the
    # all-gather this implies is the query path's only collective).
    nq = per_shard.dists.shape[1]
    nd_all = jnp.moveaxis(-per_shard.dists, 0, 1).reshape(nq, -1)
    id_all = jnp.moveaxis(per_shard.ids, 0, 1).reshape(nq, -1)
    nd, pos = jax.lax.top_k(nd_all, k)
    return KNNResult(-nd, jnp.take_along_axis(id_all, pos, axis=1))


def prepare_sharded_codes(mesh: Mesh, B, extra=None, *,
                          block: int = 1 << 15, axis: str = DATA_AXIS):
    """Pad + shard the code store ONCE for repeated mesh scans.

    Returns an opaque `device_state` for the sharded_linscan_* drivers —
    the transposed sharded codes and the (+inf-padded) extra term,
    exactly as _sharded_linscan builds them per call. A mesh server
    re-querying the same base otherwise re-uploads and re-shards the
    whole store every request (the same per-request tax the single-device
    route's adc.prepare_device_codes removes; Index.search(mesh=...)
    caches this). Must be built with the same mesh/block/axis the scan
    call uses.

    Staleness: the drivers validate only the padded SIZE of a passed
    state — a size-preserving mutation (e.g. tombstoning via the extra
    term) passes validation and serves stale results. Direct callers
    own the rebuild-after-any-mutation discipline; Index.search is safe
    via its private mutation counter."""
    from local_search_quantization.parallel.mesh import shard_cols

    B = np.asarray(B)
    n = B.shape[0]
    nshards = mesh.shape[axis]
    pad = (-n) % (nshards * block)
    extra = (np.zeros(n, np.float32) if extra is None
             else np.asarray(extra, np.float32))
    if pad:
        B = np.concatenate([B, np.zeros((pad, B.shape[1]), B.dtype)])
        extra = np.concatenate([extra, np.full(pad, np.inf, np.float32)])
    Bs = shard_cols(mesh, jnp.asarray(np.ascontiguousarray(B.T)), axis)
    es = shard_cols(mesh, jnp.asarray(extra), axis)
    return Bs, es


def _sharded_linscan(
    mesh: Mesh,
    B,
    Q,
    C: Array,
    luts_fn,
    extra,
    k: int,
    *,
    query_chunk: int,
    block: int,
    axis: str,
    precision: str = "f32",
    device_state=None,
) -> KNNResult:
    """Shared multi-device linscan driver: pad + shard the codes, then
    dispatch ALL query chunks before fetching any (same queue-then-fetch
    pattern as ops/adc._run_scan; queued results are small,
    [query_chunk, k] x2 per chunk). precision="bf16" rounds at
    sharded_scan_topk's boundary."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    from local_search_quantization.parallel.mesh import replicated

    B = np.asarray(B)
    Q = np.asarray(Q)
    n = B.shape[0]
    k = min(k, n)  # padded rows must never be reported as neighbors
    if Q.shape[0] == 0:
        return KNNResult(np.empty((0, k), np.float32),
                         np.empty((0, k), np.int32))
    nshards = mesh.shape[axis]
    if device_state is not None:
        exp = n + ((-n) % (nshards * block))
        if device_state[0].shape[1] != exp:
            raise ValueError(
                f"sharded device_state was prepared for a different "
                f"base/mesh/block (codes dim {device_state[0].shape[1]}, "
                f"expected {exp}) — rebuild with prepare_sharded_codes "
                f"after any mutation")
        Bs, es = device_state
    else:
        Bs, es = prepare_sharded_codes(mesh, B, extra, block=block,
                                       axis=axis)
    Cr = replicated(mesh, jnp.asarray(C))

    results, valid = [], []
    for start in range(0, Q.shape[0], query_chunk):
        qc = Q[start : start + query_chunk]
        npad = query_chunk - qc.shape[0]
        if npad:
            qc = np.concatenate([qc, np.broadcast_to(qc[-1:], (npad, qc.shape[1]))])
        luts = luts_fn(replicated(mesh, jnp.asarray(qc)), Cr)
        results.append(sharded_scan_topk(mesh, luts, Bs, es, k, block=block,
                                         axis=axis, precision=precision))
        valid.append(query_chunk - npad)
    out_d = [np.asarray(r.dists)[:v] for r, v in zip(results, valid)]
    out_i = [np.asarray(r.ids)[:v] for r, v in zip(results, valid)]
    return KNNResult(np.concatenate(out_d), np.concatenate(out_i))


def sharded_linscan_pq(
    mesh: Mesh,
    B,
    Q,
    C_sub: Array,
    k: int,
    *,
    R: Array | None = None,
    extra=None,
    query_chunk: int = 1024,
    block: int = 1 << 15,
    axis: str = DATA_AXIS,
    precision: str = "f32",
    device_state=None,
) -> KNNResult:
    """Multi-device PQ/OPQ scanner: shard codes, replicate subspace LUTs.

    Pass R to rotate queries into code space first (OPQ). `extra` is an
    optional [n] additive distance term (e.g. +inf tombstones from
    Index.delete); it defaults to zeros. precision="bf16" is the rounded
    serving mode (see sharded_scan_topk). device_state: pre-sharded codes
    from prepare_sharded_codes (mesh serving hot path).
    """
    Q = np.asarray(Q)
    if R is not None:
        Q = Q @ np.asarray(R)
    return _sharded_linscan(mesh, B, Q, C_sub, pq_query_luts, extra, k,
                            query_chunk=query_chunk, block=block,
                            axis=axis, precision=precision,
                            device_state=device_state)


def sharded_linscan_lsq(
    mesh: Mesh,
    B,
    Q,
    C: Array,
    db_norms,
    k: int,
    *,
    R: Array | None = None,
    query_chunk: int = 1024,
    block: int = 1 << 15,
    axis: str = DATA_AXIS,
    precision: str = "f32",
    device_state=None,
) -> KNNResult:
    """Multi-device additive-code scanner (LSQ/ChainQ + quantized norms).

    Pass R to rotate queries into the code space first (ChainQ).
    precision="bf16" is the rounded serving mode (see sharded_scan_topk).
    device_state: pre-sharded codes from prepare_sharded_codes (mesh
    serving hot path)."""
    Q = np.asarray(Q)
    if R is not None:
        Q = Q @ np.asarray(R)
    return _sharded_linscan(mesh, B, Q, C, lsq_query_luts,
                            np.asarray(db_norms, np.float32), k,
                            query_chunk=query_chunk, block=block,
                            axis=axis, precision=precision,
                            device_state=device_state)
