"""Asymmetric-distance (ADC) lookup-table kNN query engines.

JAX replacement for the reference's OpenMP C++ scanners
(/root/reference/src/linscan/cpp/linscan_aqd.cpp:37-102 for PQ/OPQ,
linscan_aqd_pairwise_byte.cpp:14-93 for additive codes + norms). The per-query
LUT build becomes one batched einsum; the code scan becomes [nq, nb] table
gathers accumulated over codebooks; `partial_sort` becomes `lax.top_k` with a
streaming merge over base chunks (the analog of the C++ scanners' 1e7-entry
buffering). Indices are returned 0-based.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


class KNNResult(NamedTuple):
    dists: Array  # [nq, k] ascending estimated (squared) distances
    ids: Array  # [nq, k] int32, 0-based base indices


def pq_query_luts(Q: Array, C_sub: Array) -> Array:
    """Per-query subspace distance tables for PQ/OPQ codes.

    luts[q, i, c] = || q_sub_i - C_sub[i, c] ||^2.  Q: [nq, d] -> [nq, m, h].
    C_sub uses the zero-padded subspace layout (ops/subspaces.py), so padded
    dims contribute (0-0)^2 = 0. (Reference LUT build: linscan_aqd.cpp:66-74.)
    """
    from local_search_quantization.ops.subspaces import split_subspaces

    m, h, ds = C_sub.shape
    Qs = jnp.moveaxis(split_subspaces(Q, m), 0, 1)  # [nq, m, ds]
    cross = jnp.einsum(
        "qis,ihs->qih",
        Qs,
        C_sub,
        preferred_element_type=jnp.float32,
        precision="highest",
    )
    qsq = jnp.sum(Qs * Qs, axis=-1, dtype=jnp.float32)  # [nq, m]
    csq = jnp.sum(C_sub * C_sub, axis=-1, dtype=jnp.float32)  # [m, h]
    return qsq[:, :, None] - 2.0 * cross + csq[None, :, :]


def lsq_query_luts(Q: Array, C: Array) -> Array:
    """Inner-product tables for additive (full-dimensional) codes.

    luts[q, i, c] = -2 * q . C[i, c].  Q: [nq, d], C: [m, h, d] -> [nq, m, h].
    (Reference: linscan_aqd_pairwise_byte.cpp:42-48.)
    """
    return -2.0 * jnp.einsum(
        "qd,ihd->qih", Q, C, preferred_element_type=jnp.float32, precision="highest"
    )


# Scan precision contract, shared by every device route, the tie
# certificate below and chip_smoke.py: a scanned distance lies within
# SCAN_REL_TOL * scan_error_scale(luts, extra) of the f64 sum of the same
# f32 LUT entries. Summing m + 1 f32 terms errs by at most ~(m + 1) * 2^-24
# (~5e-7 at m = 8) of the summands' magnitude; an H100 measured 9.5e-8 for
# both scan modes. The scale is the SUMMAND magnitude, not |distance|: the
# additive surrogate -2 q.r + ||r||^2 can cancel to ~0 while its terms are
# O(1e4). Precision.HIGH or DEFAULT would run the matmul mode in TF32 on
# that card (measured 1.9e-4, far outside the bound), hence HIGHEST below.
SCAN_REL_TOL = 1e-6


def scan_error_scale(luts: Array, extra: Array | None = None) -> Array:
    """[nq] summand magnitude of each query's scanned distances: the sum
    over codebooks of max |LUT entry| plus max |extra| (+inf entries are
    tombstones or padding, not magnitudes). Multiply by SCAN_REL_TOL for
    the absolute error bound of the scan."""
    scale = jnp.sum(jnp.max(jnp.abs(luts), axis=2), axis=1)
    if extra is not None:
        scale = scale + jnp.max(
            jnp.where(jnp.isfinite(extra), jnp.abs(extra), 0.0))
    return scale


def round_bf16(x: Array) -> Array:
    """Round to bf16 once, materialized: the bf16 serving-mode metric.

    The barrier is load-bearing: XLA simplifies a bare f32 -> bf16 -> f32
    convert pair back to the f32 input, silently un-rounding the tables
    (observed on an H100, where the scan over barrier-free rounded tables
    equals the f32 scan; CPU tests cannot see it). Callers wanting the
    rounded values back in f32 add .astype(jnp.float32)."""
    return jax.lax.optimization_barrier(x.astype(jnp.bfloat16))


def lut_scan_block(
    luts: Array,
    Bt_block: Array,
    extra: Array | None = None,
    pvary_axis: str | None = None,
    mode: str = "gather",
) -> Array:
    """Sum LUT entries for one base block: [nq, m, h] x [m, nb] -> [nq, nb].

    Bt_block is the TRANSPOSED [m, nb] code layout used device-side
    throughout the query path: codebook i's codes are one contiguous row,
    which is what the per-codebook gathers read.

    mode="gather" (default): per-codebook column gathers summed in f32 (the
    literal transcription of the C++ scanner's lookup loop,
    linscan_aqd.cpp:82-89). mode="matmul": dist = flat_lut . onehot(codes),
    one [nq, m*h] x [m*h, nb]-equivalent contraction at full f32
    precision. Both meet SCAN_REL_TOL; on an H100 the gathers are as fast
    as even a TF32 matmul and read uint8 codes directly.

    extra: optional [nb] additive term (quantized database norms for the
    additive-code scanner).
    """
    nq = luts.shape[0]
    m, nb = Bt_block.shape

    if mode == "matmul":
        h = luts.shape[2]
        onehot = jax.nn.one_hot(Bt_block, h, dtype=jnp.float32)  # [m, nb, h]
        acc = jnp.einsum(
            "qmh,mbh->qb",
            luts,
            onehot,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        def body(i, acc):
            # luts[:, i, :] is [nq, h]; gather columns by codebook i's codes.
            return acc + jnp.take(luts[:, i, :], Bt_block[i, :], axis=1)

        acc0 = jnp.zeros((nq, nb), jnp.float32)
        if pvary_axis is not None:
            acc0 = jax.lax.pcast(acc0, pvary_axis, to="varying")
        acc = jax.lax.fori_loop(0, m, body, acc0)
    if extra is not None:
        acc = acc + extra[None, :]
    return acc


@partial(jax.jit,
         static_argnames=("k", "block", "pvary_axis", "mode", "topk_method"))
def _scan_topk(
    luts: Array,
    Bt: Array,
    extra: Array | None,
    k: int,
    block: int,
    pvary_axis: str | None = None,
    mode: str = "gather",
    topk_method: str = "exact",
) -> KNNResult:
    """Streaming top-k ADC scan of the full base set for one query chunk.

    Bt: [m, n] transposed device codes (see lut_scan_block). `lax.scan`
    over base blocks; each step computes the [nq, block] distance
    tile and merges it into the running top-k (negated so lax.top_k's
    "largest" semantics give smallest distances).

    topk_method: "exact" uses lax.top_k (exact but ~linear-in-candidates
    cost — it dominates large-k queries); "approx" / "approx:0.99" uses
    lax.approx_max_k per block with the given recall target (default 0.95),
    followed by an exact merge, at the cost of a per-element miss
    probability of (1 - recall_target).
    """
    recall_target = None
    if topk_method.startswith("approx"):
        recall_target = (
            float(topk_method.split(":", 1)[1]) if ":" in topk_method else 0.95
        )
    nq = luts.shape[0]
    m, n = Bt.shape
    if n % block:
        # The caller owns padding (see _run_scan's pad-with-inf contract);
        # silently scanning only n // block full blocks would drop the tail
        # rows from the top-k with no error.
        raise ValueError(f"n={n} must be a multiple of block={block}")
    nblocks = n // block

    def step(carry, bi):
        best_nd, best_id = carry  # [nq, k] negated dists, ids
        Bblk = jax.lax.dynamic_slice(Bt, (0, bi * block), (m, block))
        eblk = (
            jax.lax.dynamic_slice(extra, (bi * block,), (block,))
            if extra is not None else None
        )
        tile = lut_scan_block(
            luts, Bblk, eblk, pvary_axis=pvary_axis, mode=mode,
        )
        ids = bi * block + jnp.arange(block, dtype=jnp.int32)[None, :]
        if recall_target is not None:
            bnd, bpos = jax.lax.approx_max_k(-tile, k, recall_target=recall_target)
            bid = jnp.take_along_axis(
                jnp.broadcast_to(ids, (nq, block)), bpos, axis=1
            )
            cand_nd = jnp.concatenate([best_nd, bnd], axis=1)
            cand_id = jnp.concatenate([best_id, bid], axis=1)
        else:
            cand_nd = jnp.concatenate([best_nd, -tile], axis=1)
            cand_id = jnp.concatenate(
                [best_id, jnp.broadcast_to(ids, (nq, block))], axis=1
            )
        nd, pos = jax.lax.top_k(cand_nd, k)
        return (nd, jnp.take_along_axis(cand_id, pos, axis=1)), None

    init = (
        jnp.full((nq, k), -jnp.inf, jnp.float32),
        jnp.full((nq, k), -1, jnp.int32),
    )
    if pvary_axis is not None:
        # Under shard_map (jax >= 0.8 vma typing) the scan carry must be
        # marked device-varying to match the per-shard outputs.
        init = jax.lax.pcast(init, pvary_axis, to="varying")
    idxs = jnp.arange(nblocks, dtype=jnp.int32)
    (nd, ids), _ = jax.lax.scan(step, init, idxs)
    return KNNResult(-nd, ids)


def _pick_group(n: int, k: int) -> int:
    """Tournament group width ~= sqrt(n/k): balances the two top_k calls
    (n/group minima vs k*group candidates). Power of two in [8, 256]."""
    g = 8
    while g < 256 and g * g * k < n:
        g *= 2
    return g


@partial(jax.jit,
         static_argnames=("k", "block", "mode", "group", "store_dists",
                          "certify"))
def _scan_topk_tournament(
    luts: Array,
    Bt: Array,
    extra: Array | None,
    k: int,
    block: int,
    mode: str = "gather",
    group: int | None = None,
    store_dists: bool = True,
    certify: bool = False,
) -> KNNResult:
    """EXACT top-k via a group-minima tournament (two passes).

    Pass 1 streams distance tiles, keeping per-group (width `group`) minima
    — no per-block lax.top_k merge (which dominated the streaming scan
    ~10:1 at k=1000). Any group containing a true top-k element has a
    minimum <= the k-th smallest value, so the kg=min(k, n/group) groups
    with smallest minima are a provable superset (ties only swap
    equal-valued candidates). Pass 2 selects exactly within the kg*group
    candidates. group ~ sqrt(n/k) balances the two top_k calls at
    ~2*sqrt(n*k) elements total vs n + (n/block)*k for the per-block merge.

    store_dists=True stashes the [nblocks, nq, block] tiles in HBM
    (nq*n*4 bytes; 1 GB at nq=256, n=1M) and pass 2 gathers — fastest.
    store_dists=False recomputes candidate distances from codes via LUT
    gathers — O(nq * k*group * m) work but O(1) extra memory, the streaming
    choice for SIFT1B-scale bases (fixes the round-1 twopass blowup).
    (Reference design point: partial_sort over a 1e7 buffer,
    linscan_aqd.cpp:52-53,91.)

    Tie caveat — alone, this path is NOT fully (dist, id)-lexicographic:
    a tie-mate exactly at the k-th value whose group lost the minima
    tournament never enters the candidate set, and lax.top_k's stable
    tie-break over the candidate axis follows group rank, not global id
    (retained ties ARE returned in ascending-id order by the final
    num_keys=2 sort — only boundary SURVIVAL is biased). certify=True
    turns both failure modes into a checkable certificate, returning
    (KNNResult, tied[nq] bool):

      * skipped-element bound: every element outside the candidate set
        lies in a LOSING group, so its distance >= T' = the best losing
        group's minimum (the (kg+1)-th smallest group min; +inf when
        every group wins). d[k-1] < T' proves nothing skipped can
        displace or tie the returned set.
      * candidate-boundary bound: one extra column (k+1 from the
        candidates) and d[k-1] < d[k] proves the value cut inside the
        candidate set is unambiguous.

    Queries with tied=False are therefore EXACTLY lexicographic; tied
    queries (measure-zero on continuous f32 distances) are rerouted by
    _run_scan through the lex-exact streaming merge, so every scan route
    shares one (dist, id) contract.

    Metric scoping of the certificate: in store mode (the default) the
    candidate distances come from the same tiles as T', so both checks
    are same-metric and strict — zero-slack cross-route id parity. In
    recompute mode the candidates are summed in a different f32
    accumulation order than the tiles that produced T', so the boundary
    check carries a slack of twice the scan error bound (each metric is
    within SCAN_REL_TOL of the exact sum): near-boundary queries may
    over-flag and pay a rerun (correct, just slower), and the un-flagged
    results are the exact top-k of the RECOMPUTED metric (strict
    cross-route id equality at ulp-level in-set near-ties is guaranteed
    by store mode only).
    """
    nq = luts.shape[0]
    m, n = Bt.shape
    h = luts.shape[2]
    if group is None:
        group = _pick_group(n, k)
    group = min(group, block)
    nblocks = n // block

    def step(carry, bi):
        Bblk = jax.lax.dynamic_slice(Bt, (0, bi * block), (m, block))
        eblk = (
            jax.lax.dynamic_slice(extra, (bi * block,), (block,))
            if extra is not None else None
        )
        tile = lut_scan_block(luts, Bblk, eblk, mode=mode)
        gmin = jnp.min(tile.reshape(nq, block // group, group), axis=-1)
        out = tile if store_dists else jnp.zeros((nq, 0), jnp.float32)
        return carry, (out, gmin)

    idxs = jnp.arange(nblocks, dtype=jnp.int32)
    _, (tiles, gmins) = jax.lax.scan(step, 0, idxs)
    gmins = jnp.moveaxis(gmins, 1, 0).reshape(nq, n // group)

    kg = min(k, n // group)
    if certify and kg < n // group:
        nmins, gidx_w = jax.lax.top_k(-gmins, kg + 1)
        gidx = gidx_w[:, :kg]  # [nq, kg] winning groups
        tprime = -nmins[:, kg]  # best LOSING group's min: skipped >= T'
    else:
        _, gidx = jax.lax.top_k(-gmins, kg)  # [nq, kg] winning groups
        # kg == n//group: every group won, nothing was skipped.
        tprime = jnp.full((nq,), jnp.inf, jnp.float32)
    cand_idx = (
        gidx[:, :, None] * group
        + jnp.arange(group, dtype=jnp.int32)[None, None, :]
    ).reshape(nq, kg * group)  # [nq, C] global candidate positions

    if store_dists:
        # tiles layout is [nblocks, nq, block]; gather without transposing
        # the big array (global pos p lives at flat ((p//block)*nq + q) *
        # block + p%block). int32 flat indexing needs nq*n < 2^31 — the
        # _run_scan driver auto-selects recompute mode beyond that.
        b, o = cand_idx // block, cand_idx % block
        q = jnp.arange(nq, dtype=jnp.int32)[:, None]
        flat = (b * nq + q) * block + o
        cand = jnp.take(tiles.reshape(-1), flat)
    else:
        # Keep every intermediate [nq, m, C] with the LARGE candidate axis
        # minor. The flat view of the transposed codes puts codebook i of
        # point p at i*n + p.
        C_ = kg * group
        marange = jnp.arange(m, dtype=jnp.int32)
        flat_idx = (
            cand_idx[:, None, :] + n * marange[None, :, None]
        )  # [nq, m, C]
        codes = jnp.take(Bt.reshape(-1), flat_idx.reshape(-1)).reshape(
            nq, m, C_
        )
        lut_flat = luts.reshape(nq, m * h)
        gidx2 = (marange[None, :, None] * h + codes).reshape(nq, m * C_)
        cand = jnp.sum(
            jnp.take_along_axis(lut_flat, gidx2, axis=1).reshape(nq, m, C_),
            axis=1,
        )
        if extra is not None:
            cand = cand + jnp.take(extra, cand_idx.reshape(-1)).reshape(
                nq, C_
            )

    # certify requests one extra candidate column for the boundary check
    # (k + 1 <= kg * group always: kg >= 1 and group >= 8 give >= 8k
    # candidates when kg == k, and the whole base when kg == n // group,
    # where _run_scan's 4 * k < n guard bounds k).
    k_req = k + 1 if certify else k
    nd, pos = jax.lax.top_k(-cand, k_req)
    ids = jnp.take_along_axis(cand_idx, pos, axis=1)
    # Sentinel contract shared by every scan path: +inf slots (tombstoned
    # rows / fewer than k live candidates) carry id -1, never a real row
    # id (downstream stages like refine.rerank rely on this).
    d = -nd
    ids = jnp.where(jnp.isinf(d), -1, ids).astype(jnp.int32)
    # Retained equal-distance ties ascend by id (top_k's stable order is
    # candidate-POSITION order = group rank, not id) — see the docstring's
    # tie caveat; boundary survival is certified (or rerouted) under
    # certify=True and group-rank-biased otherwise.
    d, ids = jax.lax.sort((d, ids), dimension=1, num_keys=2)
    if certify:
        fin = jnp.isfinite(d[:, k - 1])
        if store_dists:
            # Candidate dists came from the same tiles as tprime: the
            # boundary compare is same-metric, so strict >= is exact.
            at_bound = d[:, k - 1] >= tprime
        else:
            # Recompute mode sums LUT entries per candidate in a different
            # f32 accumulation order than lut_scan_block, so an ulp-level
            # divergence at the boundary could evade the flag. Each metric
            # is within the scan error bound of the exact sum, so twice
            # the bound covers their spread; a false flag only costs that
            # query a lex-exact rerun.
            slack = 2.0 * SCAN_REL_TOL * scan_error_scale(luts, extra)
            at_bound = d[:, k - 1] >= tprime - slack
        tied = fin & ((d[:, k - 1] == d[:, k]) | at_bound)
        return KNNResult(d[:, :k], ids[:, :k]), tied
    return KNNResult(d, ids)


def pad_rerun_idx(tq: np.ndarray) -> np.ndarray:
    """Pad a tie-rerun query-index vector to a power-of-two length >= 8
    by repeating its first index. The rerun's leading dim is otherwise
    data-dependent (the number of certificate-failing queries), and every
    DISTINCT count is a fresh jitted shape and a fresh compile. Bucketing
    bounds the family to log2(nq) shapes.
    Duplicate rows recompute the first tied query redundantly; callers
    scatter back only the first len(tq) rows.

    `tq` must be NONEMPTY (there is no first index to pad with); callers
    gate on `.any()` before building the rerun batch."""
    if len(tq) == 0:
        raise ValueError("pad_rerun_idx needs a nonempty index vector "
                         "(gate the rerun on tied.any() first)")
    size = 1 << max(3, int(len(tq) - 1).bit_length())
    return np.concatenate([tq, np.full(size - len(tq), tq[0], tq.dtype)])


def prepare_device_codes(B, extra=None, *, base_block: int = 1 << 16):
    """Upload codes ONCE for repeated scans over an unchanged base.

    Returns an opaque `device_state` for _run_scan/linscan_* — the
    transposed [m, n_padded] device codes plus the (+inf-padded) extra
    term, exactly as _run_scan would build them per call. A serving
    process that re-queries the same base pays the H2D code upload once
    instead of per request (Index.search caches this; the reference's
    scanners are in-process over host RAM, Linscan.jl:5-73, so they have
    no analogous cost to amortize).

    Must be built with the same `base_block` the scan call uses. The codes
    keep their dtype: uint8 codes are scanned as bytes, a quarter of the
    int32 traffic. Padded rows get +inf extra so they can never win a scan.
    """
    B = np.asarray(B)
    n = B.shape[0]
    pad = (-n) % base_block
    if pad:
        B = np.concatenate([B, np.zeros((pad, B.shape[1]), B.dtype)])
    extra_p = np.asarray(extra, np.float32) if extra is not None else None
    if pad:
        if extra_p is None:
            extra_p = np.zeros(n, np.float32)
        extra_p = np.concatenate(
            [extra_p, np.full(pad, np.inf, np.float32)])
    Bj = jnp.asarray(np.ascontiguousarray(B.T))
    extraj = jnp.asarray(extra_p) if extra_p is not None else None
    return Bj, extraj


def _native_ok(B: np.ndarray) -> bool:
    """The native scanner is built and can take these codes. uint8 codes
    are range-valid by construction — the min/max scans (two full passes
    over n*m elements per CALL) only run for wider dtypes, so long-lived
    servers store codes as uint8 (Index does at h <= 256)."""
    from local_search_quantization.utils import native as _nat

    return (_nat.available()
            and B.shape[1] <= 32
            and (B.dtype == np.uint8
                 or B.size == 0
                 or (B.min() >= 0 and B.max() < 256)))


def _run_scan(
    luts_fn,
    Q,
    B,
    *,
    k: int,
    extra=None,
    query_chunk: int = 256,
    base_block: int = 1 << 16,
    mode: str = "gather",
    topk_method: str = "auto",
    base_segment: int = 1 << 26,
    precision: str = "f32",
    device_state=None,
) -> KNNResult:
    """Driver: chunk queries on host, pad base to a block multiple, scan.

    topk_method="auto" follows the platform's route (routes.ROUTES): the
    native host scanner where the route allows it and the library is
    built, otherwise the exact streaming merge on the device. "native",
    "exact", "tournament" and "approx[:r]" force a route.

    Bases larger than `base_segment` rows (default 64M ~ 1.8 GB of codes)
    never land on the device whole: they stream through in host-side
    segments whose per-segment top-k lists are merged on the host — the
    SIFT1B-scale analog of the reference scanners' 1e7-entry buffering
    (linscan_aqd.cpp:52-53).

    precision="bf16" is the serving fast mode: the per-query LUTs are
    rounded ONCE to bf16 (then kept in f32 containers). The result is the
    EXACT (dist, id)-lexicographic top-k of the rounded-LUT distances — a
    deterministic contract, not a tolerance — and because the rounding
    happens here at the driver, every route (streaming merge, tournament,
    native scanner) scans the same rounded tables, so route parity is
    preserved in this mode too (sums may differ by f32 accumulation-order
    ulps across routes; boundary ids could swap only at such near-ties).
    The reference scanners are f32-only (linscan_aqd.cpp:66-74); "f32"
    remains the default and the parity configuration.
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    if precision == "bf16":
        inner_luts_fn = luts_fn

        def luts_fn(q):
            return round_bf16(inner_luts_fn(q)).astype(jnp.float32)

    Q = np.asarray(Q)
    B = np.asarray(B)
    n = B.shape[0]
    k = min(k, n)
    if device_state is not None:
        exp = n + ((-n) % base_block)
        if device_state[0].shape[1] != exp:
            raise ValueError(
                f"device_state was prepared for a different base/"
                f"base_block (codes dim {device_state[0].shape[1]}, "
                f"expected {exp}) — rebuild with prepare_device_codes "
                f"after any mutation")
        if n > base_segment:
            raise ValueError("device_state does not apply to the "
                             "segmented >base_segment streaming path")
    if n > base_segment:
        parts = []
        for s0 in range(0, n, base_segment):
            s1 = min(s0 + base_segment, n)
            # precision passes through: the segment re-wraps the already-
            # wrapped luts_fn (bf16 rounding is idempotent).
            seg = _run_scan(
                luts_fn, Q, B[s0:s1], k=min(k, s1 - s0),
                extra=None if extra is None else np.asarray(extra)[s0:s1],
                query_chunk=query_chunk, base_block=base_block, mode=mode,
                topk_method=topk_method, base_segment=base_segment,
                precision=precision,
            )
            # A (+inf, -1) sentinel must not be offset into a REAL id of
            # the previous segment (same id-forging class the tournament
            # path had; sentinel contract pinned in test_adc_eval).
            seg_ids = np.asarray(seg.ids)
            parts.append(KNNResult(
                seg.dists, np.where(seg_ids >= 0, seg_ids + s0, -1)))
        d_all = np.concatenate([p.dists for p in parts], axis=1)
        i_all = np.concatenate([p.ids for p in parts], axis=1)
        order = np.argsort(d_all, axis=1, kind="stable")[:, :k]
        return KNNResult(
            np.take_along_axis(d_all, order, axis=1),
            np.take_along_axis(i_all, order, axis=1),
        )
    if topk_method == "auto":
        from local_search_quantization.routes import platform_route

        # The exact streaming merge is (dist, id)-lexicographic with no
        # rerun phase — stable top_k over id-ascending blocks — so the
        # native scanner, the sharded-mesh route and this route agree
        # id-for-id even on tie-heavy small-h codes (route-parity tests
        # pin this).
        topk_method = ("native" if platform_route().host_scan
                       and _native_ok(B) else "exact")
    if topk_method == "native":
        # Host C++ scanner (AVX-512 VBMI in-register tables when built with
        # it): exact and far faster than any XLA-CPU scan (reference
        # analog: the OpenMP scanners, linscan_aqd.cpp:37-102).
        from local_search_quantization.utils import native as _nat

        if not _native_ok(B):
            raise ValueError(
                "topk_method='native' needs the native library "
                "(make -C native) and codes in [0, 256)"
            )
        luts = np.asarray(luts_fn(jnp.asarray(Q)), np.float32)
        d, i = _nat.linscan(
            luts,
            B if B.dtype == np.uint8 else B.astype(np.uint8),
            None if extra is None else np.asarray(extra, np.float32),
            k,
        )
        # KNNResult's documented ids dtype is int32 (same as the device
        # paths); n < 2^31 is guaranteed on this route (uint8 codes, host
        # memory).
        return KNNResult(d, i.astype(np.int32))
    if device_state is not None:
        # Pre-uploaded codes (prepare_device_codes): the serving hot path
        # skips the per-call pad + H2D transfer entirely.
        Bj, extraj = device_state
    else:
        # Same pad/transpose/upload contract as the cached path — ONE
        # implementation, so the two can never drift apart.
        Bj, extraj = prepare_device_codes(B, extra, base_block=base_block)

    # Dispatch ALL chunks asynchronously (JAX queues them back-to-back on
    # device), then fetch — a host sync per chunk would serialize compute
    # against the dispatch and fetch latency.
    results, valid, tie_work = [], [], []
    for start in range(0, Q.shape[0], query_chunk):
        qc = Q[start : start + query_chunk]
        npad = query_chunk - qc.shape[0]
        if npad:
            qc = np.concatenate([qc, np.broadcast_to(qc[-1:], (npad, qc.shape[1]))])
        luts = luts_fn(jnp.asarray(qc))
        tied = None
        if topk_method in ("tournament", "twopass") and 4 * k < Bj.shape[1]:
            # Stash-the-tiles mode only while the [nq, n] f32 buffer and its
            # int32 flat indexing stay comfortable; stream + recompute
            # (O(1) extra memory) beyond — SIFT1B-scale safe.
            import os as _os
            store = (query_chunk * Bj.shape[1] <= (1 << 28)
                     and _os.environ.get('LSQ_TOPK_STORE', '1') == '1')
            res, tied = _scan_topk_tournament(
                luts, Bj, extraj, k, base_block, mode=mode,
                store_dists=store, certify=True,
            )
        else:
            res = _scan_topk(luts, Bj, extraj, k, base_block, mode=mode,
                             topk_method="exact" if topk_method in (
                                 "tournament", "twopass") else topk_method)
        results.append(res)
        valid.append(query_chunk - npad)
        # The stashed LUT device buffers live until the post-fetch tie
        # pass below — O(total_nq * m * h) device memory (~7 KB/query at
        # m=7, h=256) on the tournament route. Dropping a chunk's LUTs
        # early would require syncing its tied mask per chunk, defeating
        # dispatch-all-then-fetch; the bound is tiny relative to the
        # [nq, n] scan itself.
        tie_work.append((tied, luts) if tied is not None else None)
    out_d = [np.asarray(r.dists)[:v] for r, v in zip(results, valid)]
    out_i = [np.asarray(r.ids)[:v] for r, v in zip(results, valid)]
    # Tournament lex contract, phase two (see _scan_topk_tournament's
    # certificate): rerun tied queries — measure-zero on continuous f32
    # distances — through the exactly-lexicographic streaming merge,
    # AFTER the bulk fetch so the hot path stays dispatch-all-then-fetch.
    for ci, work in enumerate(tie_work):
        if work is None:
            continue
        t = np.asarray(work[0])[: valid[ci]]
        if not t.any():
            continue
        tq = np.flatnonzero(t)
        # Bucketed leading dim (pad_rerun_idx): one compiled shape per
        # power-of-two tied-count instead of one per distinct count.
        tqp = jnp.asarray(pad_rerun_idx(tq))
        fix = _scan_topk(jnp.take(work[1], tqp, axis=0), Bj,
                         extraj, k, base_block, mode=mode,
                         topk_method="exact")
        out_d[ci], out_i[ci] = out_d[ci].copy(), out_i[ci].copy()
        out_d[ci][tq] = np.asarray(fix.dists)[: len(tq)]
        out_i[ci][tq] = np.asarray(fix.ids)[: len(tq)]
    return KNNResult(np.concatenate(out_d), np.concatenate(out_i))


def linscan_pq(
    B: Array, Q: Array, C_sub: Array, k: int = 10000, **kw
) -> KNNResult:
    """ADC kNN for PQ codes. B: [n, m] codes, Q: [nq, d], C_sub: [m, h, ds].

    (Reference: linscan_pq, Linscan.jl:5-27 -> linscan_aqd.cpp.)
    """
    return _run_scan(lambda q: pq_query_luts(q, C_sub), Q, B, k=k, **kw)


def linscan_opq(
    B: Array, Q: Array, C_sub: Array, R: Array, k: int = 10000, **kw
) -> KNNResult:
    """ADC kNN for OPQ codes: rotate queries into code space, then PQ scan.

    With row-major data the reference's `R' * X` (Linscan.jl:30-43) is Q @ R.
    """
    QR = np.asarray(Q) @ np.asarray(R)
    return linscan_pq(B, QR, C_sub, k, **kw)


def linscan_lsq(
    B: Array,
    Q: Array,
    C: Array,
    db_norms: Array,
    k: int = 10000,
    R: Array | None = None,
    **kw,
) -> KNNResult:
    """ADC kNN for additive codes with separately-quantized norms.

    dist[q, n] = -2 sum_i q.C[i, B[n, i]] + ||recon_n||^2 — a rank-respecting
    surrogate of the true squared distance (the ||q||^2 term is constant per
    query). db_norms: [n] float32 quantized reconstruction norms.
    (Reference: linscan_lsq, Linscan.jl:46-73 -> linscan_aqd_pairwise_byte.cpp.)
    """
    Qr = np.asarray(Q) @ np.asarray(R) if R is not None else Q
    return _run_scan(
        lambda q: lsq_query_luts(q, C), Qr, B, k=k, extra=np.asarray(db_norms), **kw
    )
