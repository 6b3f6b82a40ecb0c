"""IVF coarse partition over a quantized code store (beyond the reference).

The reference's query engines are exhaustive linear scanners
(/root/reference/src/linscan/Linscan.jl:5-73); production ANN serving
almost always fronts ADC with an inverted-file (IVF) coarse quantizer so
each query scans only the few lists nearest to it. This module adds that
layer on top of any trained model's codes:

    part = ivf.build_partition(B, xhat, extra, nlist=1024)
    res  = ivf.search(part, luts, k=100, probes=ivf.coarse_probes(Q, part, 32))

Design notes:
- The coarse quantizer trains on CODE RECONSTRUCTIONS, not original
  vectors: the ADC distance of a row is a function of its reconstruction
  only, so partitioning reconstructions aligns the coarse geometry with
  what the scanner actually ranks — and makes the partition buildable
  from a saved index alone (no original vectors needed).
- Grouped storage pads every list segment to 64-row alignment so the
  native AVX-512 VBMI scanner (native/lsq_native.cpp: lsq_linscan_ivf)
  runs whole in-register-table chunks with a live-lane mask on the last
  chunk; pad rows are excluded by per-list live lengths and can never be
  emitted.
- Distances over the probed candidate set are EXACT (the quantized sums
  only prune, same certified-lower-bound argument as the exhaustive fast
  scanner); the approximation is purely which rows are candidates, so
  recall converges to the exhaustive scanner's as nprobe -> nlist.
- Rows appended after the partition was built (Index.add) form a TAIL
  that callers scan exhaustively and merge (Index.search does this), so
  mutations never silently fall out of the candidate set.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from local_search_quantization.ops import adc

__all__ = [
    "IVFPartition",
    "build_partition",
    "coarse_probes",
    "search",
    "merge_knn",
    "topk_lex",
]


def topk_lex(d: np.ndarray, ids: np.ndarray, k: int):
    """Lexicographic-(dist, id) top-k of the FINITE candidates, with the
    scanners' sentinel padding: returns (dists [k] ascending f32,
    ids [k] int64), (+inf, -1) past the live candidates. The single home
    of the argpartition + lexsort idiom shared by the numpy scan paths
    and refine.rerank — the tie-break and sentinel contract live here.
    """
    out_d = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    keep = np.flatnonzero(np.isfinite(d))
    kq = min(k, keep.size)
    if kq:
        # argpartition alone resolves a tie block straddling the k
        # boundary ARBITRARILY (introselect order — found returning the
        # wrong tie-mates on small-h codes where the top-k is one giant
        # equal-code block). All boundary tie-mates share one distance,
        # so the lex order among them is id order: keep every element
        # strictly below the boundary value plus the `need` LOWEST ids
        # within the tie block (argpartition on ids). The final lexsort
        # then sees exactly kq candidates — cost is O(n + k log k) even
        # when the tie block is the whole array (the worst case that
        # motivated the fix would otherwise lexsort all n rows).
        dk = d[keep]
        thr = dk[np.argpartition(dk, kq - 1)[:kq]].max()
        below = keep[dk < thr]
        tie = keep[dk == thr]
        need = kq - below.size  # >= 1: the boundary value is in the top-kq
        if need < tie.size:
            tie = tie[np.argpartition(ids[tie], need - 1)[:need]]
        cand = np.concatenate([below, tie])
        o2 = np.lexsort((ids[cand], d[cand]))[:kq]
        out_d[:kq] = d[cand][o2]
        out_i[:kq] = ids[cand][o2]
    return out_d, out_i


def _lut_scan_row(luts_q: np.ndarray, codes: np.ndarray,
                  extra: np.ndarray | None, ids: np.ndarray, k: int):
    """One query's numpy ADC scan: LUT-gather sum over m codebooks (+
    extra term) then the shared sentinel-padded top-k. The single home of
    the numpy distance accumulation — the probed-path oracle and the
    tail scan must never diverge."""
    d = np.zeros(codes.shape[0], np.float32)
    for j in range(luts_q.shape[0]):
        d += luts_q[j][codes[:, j]]
    if extra is not None:
        d = d + extra
    return topk_lex(d, ids, k)


@dataclasses.dataclass
class IVFPartition:
    """Grouped code store + coarse centroids. All arrays are host numpy."""

    centroids: np.ndarray  # [nlist, d] f32, original space
    cnorms: np.ndarray  # [nlist] f32 squared centroid norms
    order: np.ndarray  # [n_g] int64 original ids (-1 on pad rows)
    starts: np.ndarray  # [nlist+1] int64 padded segment offsets (64-aligned)
    lives: np.ndarray  # [nlist] int64 live rows per segment
    codes_g: np.ndarray  # [n_g, m] uint8 grouped codes
    codesT_g: np.ndarray  # [m, n_g] uint8 plane-major copy (VBMI path)
    extra_g: np.ndarray | None  # [n_g] f32 norm terms / +inf tombstones
    pos_of_id: np.ndarray  # [n_grouped] int64: grouped position of each id
    n_grouped: int  # ids < n_grouped are in the partition; rest = tail
    emin: float  # lower bound of finite extra_g values (0 when None)

    @property
    def nlist(self) -> int:
        return int(self.lives.shape[0])

    def tombstone(self, ids: np.ndarray) -> None:
        """Mirror Index.delete into the grouped store: +inf the rows so no
        scan path can return them. Ids >= n_grouped live in the tail and
        are the caller's to handle."""
        ids = np.asarray(ids, np.int64)
        # Negative ids would wrap through pos_of_id and poison the wrong
        # row — filter both ends (callers like Index.delete validate, but
        # this is public API on the dataclass).
        ids = ids[(ids >= 0) & (ids < self.n_grouped)]
        if ids.size == 0:
            return
        if self.extra_g is None:
            self.extra_g = np.zeros(self.order.shape[0], np.float32)
        self.extra_g[self.pos_of_id[ids]] = np.inf

    def compact(self, new_of_old: np.ndarray) -> None:
        """Re-number after an Index.compact(): drop rows whose
        new_of_old[old_id] is -1, renumber the survivors, re-pad every
        segment. List assignments are preserved, so compaction no longer
        costs a partition rebuild (the coarse k-means is the expensive
        part). new_of_old must cover [0, n_grouped)."""
        nlist = self.nlist
        seg_rows = []  # per list: (codes, extras, new_ids)
        for li in range(nlist):
            s0, live = int(self.starts[li]), int(self.lives[li])
            pos = np.arange(s0, s0 + live)
            news = new_of_old[self.order[pos]]
            keep = news >= 0
            seg_rows.append((self.codes_g[pos[keep]],
                             None if self.extra_g is None
                             else self.extra_g[pos[keep]],
                             news[keep]))
        counts = np.array([r[2].size for r in seg_rows], np.int64)
        pads = (-counts) % 64
        starts = np.zeros(nlist + 1, np.int64)
        np.cumsum(counts + pads, out=starts[1:])
        n_g = int(starts[-1])
        m = self.codes_g.shape[1]
        order = np.full(n_g, -1, np.int64)
        codes_g = np.zeros((n_g, m), np.uint8)
        extra_g = None if self.extra_g is None else np.zeros(n_g, np.float32)
        for li, (cb, eb, ids) in enumerate(seg_rows):
            s0 = starts[li]
            order[s0:s0 + ids.size] = ids
            codes_g[s0:s0 + ids.size] = cb
            if extra_g is not None:
                extra_g[s0:s0 + ids.size] = eb
        n_new = int(counts.sum())
        pos_of_id = np.empty(n_new, np.int64)
        live_mask = order >= 0
        pos_of_id[order[live_mask]] = np.flatnonzero(live_mask)
        self.order, self.starts, self.lives = order, starts, counts
        self.codes_g = codes_g
        self.codesT_g = np.ascontiguousarray(codes_g.T)
        self.extra_g = extra_g
        self.pos_of_id = pos_of_id
        self.n_grouped = n_new
        # emin stays valid: dropping rows can only raise the true minimum.

    def to_arrays(self) -> dict:
        """Flat dict for npz persistence (extra_g omitted when None)."""
        out = {
            "centroids": self.centroids, "order": self.order,
            "starts": self.starts, "lives": self.lives,
            "codes_g": self.codes_g,
            "n_grouped": np.int64(self.n_grouped),
            "emin": np.float32(self.emin),
        }
        if self.extra_g is not None:
            out["extra_g"] = self.extra_g
        return out

    @classmethod
    def from_arrays(cls, a: dict) -> "IVFPartition":
        """Rebuild from to_arrays() output, validating the structural
        invariants the native scanner relies on (a corrupt file must fail
        here, not as an out-of-bounds read in C++)."""
        codes_g = np.ascontiguousarray(a["codes_g"], np.uint8)
        order = np.asarray(a["order"], np.int64)
        n_grouped = int(a["n_grouped"])
        starts = np.asarray(a["starts"], np.int64)
        lives = np.asarray(a["lives"], np.int64)
        n_g = codes_g.shape[0]
        if (order.shape[0] != n_g or starts.shape[0] != lives.shape[0] + 1
                or starts[0] != 0 or starts[-1] != n_g
                or (starts % 64).any() or (np.diff(starts) < lives).any()
                or (lives < 0).any()):
            raise ValueError("corrupt IVF partition arrays")
        live_mask = order >= 0
        ids = order[live_mask]
        if (ids.size != n_grouped or ids.max(initial=-1) >= n_grouped
                or np.unique(ids).size != n_grouped):
            raise ValueError("corrupt IVF partition ids")
        pos = np.empty(n_grouped, np.int64)
        pos[ids] = np.flatnonzero(live_mask)
        cent = np.asarray(a["centroids"], np.float32)
        return cls(
            centroids=cent,
            cnorms=(cent * cent).sum(axis=1),
            order=order,
            starts=np.asarray(a["starts"], np.int64),
            lives=np.asarray(a["lives"], np.int64),
            codes_g=codes_g,
            codesT_g=np.ascontiguousarray(codes_g.T),
            extra_g=(np.asarray(a["extra_g"], np.float32).copy()
                     if "extra_g" in a else None),
            pos_of_id=pos,
            n_grouped=n_grouped,
            emin=float(a["emin"]),
        )


def build_partition(
    B: np.ndarray,
    xhat: np.ndarray,
    extra: np.ndarray | None,
    nlist: int,
    *,
    seed: int = 0,
    sample: int = 1 << 18,
    iters: int = 25,
) -> IVFPartition:
    """Train coarse centroids on reconstructions and group the code store.

    B [n, m] codes (any int dtype, values < 256); xhat [n, d] f32
    reconstructions; extra [n] f32 norm terms / +inf tombstones or None.
    """
    import jax

    from local_search_quantization.ops import kmeans as km

    n, m = B.shape
    ns = min(sample, n)
    if nlist < 1 or nlist > ns:
        # k-means trains on the sample: nlist beyond it would fail deep in
        # the empty-cluster repair with an opaque top_k shape error.
        raise ValueError(
            f"nlist={nlist} out of range [1, {ns}] "
            f"(min of sample={sample} and n={n})")
    if int(B.max(initial=0)) > 255:
        raise ValueError("IVF grouped store is uint8: needs h <= 256 codes")
    xhat = np.asarray(xhat, np.float32)

    rng = np.random.default_rng(seed)
    sel = rng.choice(n, ns, replace=False) if ns < n else np.arange(n)
    res = km.kmeans(jax.random.PRNGKey(seed), xhat[sel], nlist,
                    maxiter=iters)
    centroids = np.asarray(res.centers, np.float32)
    cnorms = (centroids * centroids).sum(axis=1)

    # Assign every row to its nearest centroid, chunked [c, nlist] scores.
    assign = np.empty(n, np.int64)
    for s0 in range(0, n, 1 << 16):
        s1 = min(s0 + (1 << 16), n)
        sc = cnorms[None, :] - 2.0 * (xhat[s0:s1] @ centroids.T)
        assign[s0:s1] = np.argmin(sc, axis=1)

    counts = np.bincount(assign, minlength=nlist)
    pads = (-counts) % 64
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts + pads, out=starts[1:])
    n_g = int(starts[-1])

    # Stable grouping keeps ascending original ids inside each list.
    by_list = np.argsort(assign, kind="stable")
    order = np.full(n_g, -1, np.int64)
    codes_g = np.zeros((n_g, m), np.uint8)
    extra_arr = (None if extra is None
                 else np.asarray(extra, np.float32))
    extra_g = None if extra_arr is None else np.zeros(n_g, np.float32)
    Bu8 = np.ascontiguousarray(B, np.uint8)
    taken = 0
    for li in range(nlist):
        rows = by_list[taken:taken + counts[li]]
        taken += counts[li]
        s0 = starts[li]
        order[s0:s0 + rows.size] = rows
        codes_g[s0:s0 + rows.size] = Bu8[rows]
        if extra_g is not None:
            extra_g[s0:s0 + rows.size] = extra_arr[rows]
    pos = np.empty(n, np.int64)
    pos[order[order >= 0]] = np.flatnonzero(order >= 0)

    # emin over the LIVE rows only: the 0.0 alignment pads would drag the
    # bound below the true minimum and loosen the u16 prune for free.
    finite = (np.array([], np.float32) if extra_arr is None
              else extra_arr[np.isfinite(extra_arr)])
    return IVFPartition(
        centroids=centroids,
        cnorms=cnorms,
        order=order,
        starts=starts,
        lives=counts.astype(np.int64),
        codes_g=codes_g,
        codesT_g=np.ascontiguousarray(codes_g.T),
        extra_g=extra_g,
        pos_of_id=pos,
        n_grouped=n,
        emin=float(finite.min()) if finite.size else 0.0,
    )


def coarse_probes(Q: np.ndarray, part: IVFPartition, nprobe: int) -> np.ndarray:
    """[nq, nprobe] int32 nearest-list ids per query, ascending by coarse
    distance (closest first, so the scan threshold tightens early)."""
    Q = np.asarray(Q, np.float32)
    nprobe = min(nprobe, part.nlist)
    sc = part.cnorms[None, :] - 2.0 * (Q @ part.centroids.T)
    idx = np.argpartition(sc, nprobe - 1, axis=1)[:, :nprobe]
    dsel = np.take_along_axis(sc, idx, axis=1)
    idx = np.take_along_axis(idx, np.argsort(dsel, axis=1, kind="stable"),
                             axis=1)
    return np.ascontiguousarray(idx, np.int32)


def _numpy_scan(part: IVFPartition, luts: np.ndarray, k: int,
                probes: np.ndarray) -> adc.KNNResult:
    """Pure-numpy oracle/fallback: exact distances, (+inf, -1) sentinels
    past the live candidates. Returned DISTANCES match the native path
    exactly; exact-distance ties at the k-th boundary may pick a
    different tied row (this sorts lexicographically by (dist, id), the
    native scanner accepts in probe/scan order — both are valid members
    of the tie class)."""
    nq, m, h = luts.shape
    dists = np.full((nq, k), np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int64)
    for q in range(nq):
        segs = [np.arange(part.starts[p], part.starts[p] + part.lives[p])
                for p in probes[q] if p >= 0]
        rows = (np.concatenate(segs) if segs
                else np.array([], np.int64))
        if rows.size == 0:
            continue
        dists[q], ids[q] = _lut_scan_row(
            luts[q], part.codes_g[rows],
            None if part.extra_g is None else part.extra_g[rows],
            part.order[rows], k)
    return adc.KNNResult(dists, ids)


def search(part: IVFPartition, luts: np.ndarray, k: int,
           probes: np.ndarray, *, method: str = "auto") -> adc.KNNResult:
    """Scan the probed segments. luts [nq, m, h] f32 per-query ADC tables
    (adc.pq_query_luts / adc.lsq_query_luts semantics, so distances are
    directly comparable to the exhaustive linscans').

    method: "auto" = native scanner when built (VBMI chunks when compiled
    with AVX-512 VBMI), "numpy" = the pure-python fallback/oracle. The
    two return identical distances; exact-tie ids at the k-th boundary
    may differ (see _numpy_scan).
    """
    from local_search_quantization.utils import native

    luts = np.ascontiguousarray(luts, np.float32)
    if method == "numpy" or not native.has_ivf():
        return _numpy_scan(part, luts, k, probes)
    d, i = native.linscan_ivf(
        luts, part.codes_g, part.codesT_g, part.extra_g, part.order,
        part.starts, part.lives, probes, k, emin=part.emin)
    return adc.KNNResult(d, i)


def exhaustive_scan(luts: np.ndarray, codes: np.ndarray,
                    extra: np.ndarray | None, k: int) -> adc.KNNResult:
    """Exhaustive ADC scan of a code block with PREBUILT per-query LUTs —
    the tail path of Index._search_ivf (rows appended after the
    partition), so the tables built for the grouped scan are reused
    instead of re-deriving them through the method-routing ladder.
    Native scanner when available and the codes fit u8; numpy otherwise.
    """
    from local_search_quantization.utils import native

    codes = np.asarray(codes)
    n = codes.shape[0]
    k = min(k, n)
    if native.available() and int(codes.max(initial=0)) <= 255:
        d, i = native.linscan(luts, codes, extra, k)
        return adc.KNNResult(d, i)
    nq, m, _ = luts.shape
    dists = np.full((nq, k), np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int64)
    row_ids = np.arange(n, dtype=np.int64)
    extra_arr = None if extra is None else np.asarray(extra, np.float32)
    for q in range(nq):
        dists[q], ids[q] = _lut_scan_row(luts[q], codes, extra_arr,
                                         row_ids, k)
    return adc.KNNResult(dists, ids)


def merge_knn(a: adc.KNNResult, b: adc.KNNResult, k: int) -> adc.KNNResult:
    """Merge two per-query top-k lists into one lexicographic-(dist, id)
    top-k, preserving (+inf, -1) sentinel padding."""
    d = np.concatenate([a.dists, b.dists], axis=1)
    i = np.concatenate([a.ids, b.ids], axis=1)
    order = np.lexsort((i, d), axis=1)[:, :k]
    d = np.take_along_axis(d, order, axis=1)
    i = np.take_along_axis(i, order, axis=1)
    i[~np.isfinite(d)] = -1
    return adc.KNNResult(d, i)
