"""IVF coarse-partition serving layer (ivf.py + native lsq_linscan_ivf).

Beyond the reference (its scanners are exhaustive, Linscan.jl:5-73).
Oracle strategy: at nprobe = nlist every live row is a candidate, so the
result distances must match the exhaustive scanner's exactly (ties can
reorder ids between equal distances — the assertions are tie-robust: exact
distance arrays plus per-id recomputed-distance checks).
"""

import numpy as np
import pytest

from local_search_quantization import ivf
from local_search_quantization.index import Index
from local_search_quantization.utils import native


def _mk_clustered(rng, n, d, ncl=12, spread=0.35):
    centers = rng.normal(size=(ncl, d)).astype(np.float32) * 3.0
    lab = rng.integers(0, ncl, size=n)
    X = centers[lab] + rng.normal(size=(n, d)).astype(np.float32) * spread
    return X.astype(np.float32)


def _oracle_dist(part, luts, q, oid):
    """Recompute the exact ADC distance of original id oid for query q."""
    pos = part.pos_of_id[oid]
    d = sum(float(luts[q, j, part.codes_g[pos, j]])
            for j in range(luts.shape[1]))
    if part.extra_g is not None:
        d += float(part.extra_g[pos])
    return np.float32(d)


@pytest.fixture(scope="module")
def pq_index(rng_module):
    X = _mk_clustered(rng_module, 3000, 16)
    idx = Index.build(X[:800], X, "pq", m=2, h=16, niter=4)
    idx.build_ivf(nlist=8, sample=2000, iters=10, seed=0)
    return idx, X


@pytest.fixture(scope="module")
def rng_module():
    return np.random.default_rng(11)


def test_full_probe_matches_exhaustive(pq_index, rng_module):
    idx, X = pq_index
    Q = X[rng_module.integers(0, X.shape[0], 32)] + 0.01
    ex = idx.search(Q, k=25)
    iv = idx.search(Q, k=25, nprobe=idx.ivf.nlist)
    if native.available():
        # Both routes run the same native per-row arithmetic (adc_block's
        # sequential LUT sum), so the value top-k matches BITWISE. Ids are
        # only compared where the row's distance is untied: the native IVF
        # TopK resolves exact ties by probe/scan order, the exhaustive
        # scanner lexicographically (see test_numpy_and_native_paths_agree).
        np.testing.assert_array_equal(np.asarray(ex.dists), iv.dists)
        d = np.asarray(ex.dists)
        untied = (d != np.roll(d, 1, axis=1)) & (d != np.roll(d, -1, axis=1))
        untied[:, 0] = d[:, 0] != d[:, 1]
        untied[:, -1] = d[:, -1] != d[:, -2]
        np.testing.assert_array_equal(
            np.asarray(ex.ids)[untied], np.asarray(iv.ids)[untied])
    else:
        # Cross-route f32 tolerance — see test_compact_preserves_partition.
        np.testing.assert_allclose(np.asarray(ex.dists), iv.dists,
                                   rtol=1e-4, atol=1e-4)
    luts = idx._query_luts(Q)
    for q in range(Q.shape[0]):
        for j in range(25):
            oid = iv.ids[q, j]
            assert 0 <= oid < idx.n
            np.testing.assert_allclose(
                _oracle_dist(idx.ivf, luts, q, oid), iv.dists[q, j],
                rtol=1e-6, atol=1e-5)


def test_numpy_and_native_paths_agree(pq_index, rng_module):
    idx, X = pq_index
    Q = X[rng_module.integers(0, X.shape[0], 16)]
    luts = idx._query_luts(Q)
    probes = ivf.coarse_probes(Q, idx.ivf, 3)
    a = ivf.search(idx.ivf, luts, 10, probes, method="numpy")
    if not native.has_ivf():
        pytest.skip("native library without lsq_linscan_ivf")
    b = ivf.search(idx.ivf, luts, 10, probes)
    np.testing.assert_array_equal(a.dists, b.dists)
    # Ids cannot be compared positionally: exact-distance ties at the k-th
    # boundary resolve by (dist, id) in numpy and by probe/scan order in
    # the native TopK (both valid members of the tie class, and a tied
    # partner may sit OUTSIDE the returned window, so no local-uniqueness
    # filter can catch every such slot). Assert the oracle property
    # instead: every returned id's recomputed distance equals its slot.
    for res in (a, b):
        for q in range(Q.shape[0]):
            for j in range(10):
                if res.ids[q, j] < 0:
                    continue
                np.testing.assert_allclose(
                    _oracle_dist(idx.ivf, luts, q, res.ids[q, j]),
                    res.dists[q, j], rtol=1e-6, atol=1e-5)


def test_partial_probe_recall_and_validity(pq_index, rng_module):
    idx, X = pq_index
    Q = X[rng_module.integers(0, X.shape[0], 64)]
    ex = idx.search(Q, k=10)
    iv = idx.search(Q, k=10, nprobe=2)
    luts = idx._query_luts(Q)
    hits = 0
    for q in range(Q.shape[0]):
        assert list(iv.dists[q]) == sorted(iv.dists[q])
        for j in range(10):
            if iv.ids[q, j] < 0:
                assert np.isinf(iv.dists[q, j])
                continue
            np.testing.assert_allclose(
                _oracle_dist(idx.ivf, luts, q, iv.ids[q, j]),
                iv.dists[q, j], rtol=1e-6, atol=1e-5)
        hits += len(set(np.asarray(ex.ids[q])) & set(iv.ids[q])) / 10
    # Clustered data + self-queries: 2/8 lists must recover most of top-10.
    assert hits / Q.shape[0] > 0.7


def test_add_delete_and_tail(pq_index, rng_module):
    idx, X = pq_index
    n0 = idx.n
    xnew = _mk_clustered(rng_module, 3, 16)
    new_ids = idx.add(xnew)
    try:
        # Tail rows are scanned exhaustively: even nprobe=1 must see them.
        r = idx.search(xnew, k=5, nprobe=1)
        for i, oid in enumerate(new_ids):
            assert oid in r.ids[i], (oid, r.ids[i])
        # Tombstone one grouped row and one tail row; both must vanish.
        old = r.ids[0][(r.ids[0] >= 0) & (r.ids[0] < n0)]
        victim_grouped = int(old[0]) if old.size else 0
        idx.delete([victim_grouped, new_ids[0]])
        r2 = idx.search(xnew, k=5, nprobe=idx.ivf.nlist)
        assert new_ids[0] not in r2.ids[0]
        assert victim_grouped not in r2.ids.ravel()
    finally:
        # Restore module-scoped index state for other tests.
        idx._num = n0
        idx._tomb_buf[:] = False
        if idx._extra_buf is not None:
            idx._extra_buf[:] = 0.0
        if idx.ivf.extra_g is not None:
            idx.ivf.extra_g[:] = 0.0


def test_save_load_roundtrip(pq_index, tmp_path, rng_module):
    idx, X = pq_index
    p = str(tmp_path / "idx_ivf")
    idx.save(p)
    idx2 = Index.load(p)
    assert idx2.ivf is not None and idx2.ivf.nlist == idx.ivf.nlist
    Q = X[:8]
    a = idx.search(Q, k=10, nprobe=3)
    b = idx2.search(Q, k=10, nprobe=3)
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.ids, b.ids)


def test_compact_preserves_partition(rng_module):
    """compact() renumbers the grouped store in place (list assignments
    kept): post-compact full-probe search must equal the post-compact
    exhaustive scan, with the tail rows (added after build_ivf)
    renumbered behind the kept grouped rows."""
    X = _mk_clustered(rng_module, 600, 8, ncl=4)
    idx = Index.build(X[:300], X, "pq", m=2, h=16, niter=2)
    idx.build_ivf(nlist=4, sample=500, iters=5)
    tail_ids = idx.add(X[:3] + 0.01)
    idx.delete([5, 17, tail_ids[1]])
    n_groups_kept = idx.ivf.n_grouped - 2  # two grouped deletes
    idx.compact()
    assert idx.ivf is not None
    assert idx.ivf.n_grouped == n_groups_kept
    assert idx.n == 600 + 3 - 3
    Q = X[rng_module.integers(0, 600, 16)]
    ex = idx.search(Q, k=10)
    iv = idx.search(Q, k=10, nprobe=idx.ivf.nlist)
    # Cross-ROUTE comparison: without the native library the exhaustive
    # side runs the XLA scan (whose jit context may fuse the LUT build
    # into FMAs) while IVF runs the numpy scan — distances legitimately
    # differ by f32 rounding (~2e-5 rel observed). With native built both
    # sides share one scanner and match bitwise (test_full_probe_*).
    np.testing.assert_allclose(np.asarray(ex.dists), iv.dists,
                               rtol=1e-4, atol=1e-4)
    # The surviving tail rows (old tail_ids[0]/[2]; [1] was deleted, and
    # 2 grouped deletes precede the tail) must be found at their NEW ids.
    new_tail = [n_groups_kept, n_groups_kept + 1]
    r = idx.search(np.stack([X[0] + 0.01, X[2] + 0.01]), k=30,
                   nprobe=idx.ivf.nlist)
    assert new_tail[0] in r.ids[0], r.ids[0]
    assert new_tail[1] in r.ids[1], r.ids[1]
    # Structural invariants survive the renumbering (from_arrays checks).
    from local_search_quantization.ivf import IVFPartition

    IVFPartition.from_arrays(idx.ivf.to_arrays())


def test_additive_ivf_lsq_norms(rng_module):
    """Additive codes carry the quantized-norm extra term; full-probe IVF
    must reproduce the exhaustive additive scan's distances exactly."""
    X = _mk_clustered(rng_module, 1200, 16, ncl=6)
    idx = Index.build(X[:400], X, "lsq", m=2, h=16, niter=2, ilsiter=2)
    idx.build_ivf(nlist=4, sample=800, iters=5)
    Q = X[rng_module.integers(0, X.shape[0], 12)]
    ex = idx.search(Q, k=15)
    iv = idx.search(Q, k=15, nprobe=4)
    # Cross-route f32 tolerance — see test_compact_preserves_partition.
    np.testing.assert_allclose(np.asarray(ex.dists), iv.dists,
                               rtol=1e-4, atol=1e-4)


def test_pads_never_returned(pq_index, rng_module):
    """k larger than the probed live rows: sentinel padding, never -1 ids
    with finite distances, never pad rows."""
    idx, X = pq_index
    part = idx.ivf
    smallest = int(np.argmin(part.lives))
    Q = X[:4]
    luts = idx._query_luts(Q)
    probes = np.full((4, 1), smallest, np.int32)
    k = int(part.lives[smallest]) + 8
    res = ivf.search(part, luts, k, probes)
    got = int(part.lives[smallest])
    assert (res.ids[:, got:] == -1).all()
    assert np.isinf(res.dists[:, got:]).all()
    assert (res.ids[:, :got] >= 0).all()


def test_build_and_serve_with_ivf(tmp_path):
    """build_index.py --ivf-nlist -> serve.py: the nprobe protocol path."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "idx_ivf")
    subprocess.run(
        [sys.executable, "scripts/build_index.py", "--method", "pq",
         "--out", out, "--dataset", "synthetic", "--synth-d", "16",
         "--ntrain", "400", "--nbase", "1500", "--m", "2", "--h", "16",
         "--niter", "2", "--ivf-nlist", "8", "--platform", "cpu"],
        cwd=repo, check=True, capture_output=True, timeout=600)
    assert os.path.exists(os.path.join(out, "ivf.npz"))
    p = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", out, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=repo)
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["ivf_nlist"] == 8
        q = np.full((2, 16), 120.0).tolist()
        p.stdin.write(json.dumps({"id": 1, "vectors": q}) + "\n")
        p.stdin.write(json.dumps({"id": 2, "vectors": q, "nprobe": 8}) + "\n")
        p.stdin.write(json.dumps({"id": 3, "vectors": q, "nprobe": 2,
                                  "k": 3}) + "\n")
        p.stdin.write("EOF\n")
        p.stdin.flush()
        r1, r2, r3 = (json.loads(p.stdout.readline()) for _ in range(3))
    finally:
        p.stdin.close()
        assert p.wait(timeout=60) == 0
    # Full probe reproduces the exhaustive distances (cross-route f32
    # tolerance without native — see test_compact_preserves_partition);
    # partial is well-formed.
    np.testing.assert_allclose(np.asarray(r1["dists"]),
                               np.asarray(r2["dists"]),
                               rtol=1e-4, atol=1e-4)
    assert np.shape(r3["ids"]) == (2, 3)
    for row in r3["dists"]:
        assert row == sorted(row)


def test_load_reconciles_stale_partition(tmp_path, rng_module):
    """codes.npz and the sidecars are replaced by separate renames; a
    sidecar from an older save (generation mismatch) must be dropped.
    For LEGACY (pre-stamp) saves the row-count fallback applies, with
    the tombstone mask re-applied into a kept partition."""
    import os
    import shutil

    X = _mk_clustered(rng_module, 800, 8, ncl=4)
    idx = Index.build(X[:300], X, "pq", m=2, h=16, niter=2)
    idx.build_ivf(nlist=4, sample=500, iters=5)
    p = str(tmp_path / "idx")
    idx.save(p)
    stale_ivf = str(tmp_path / "ivf_stale.npz")
    shutil.copy(os.path.join(p, "ivf.npz"), stale_ivf)

    # Window 1: delete persisted to codes.npz, crash before ivf.npz —
    # the stale sidecar carries the previous save's generation: dropped.
    victim = int(idx.search(X[:1], k=1, nprobe=4).ids[0, 0])
    idx.delete([victim])
    idx.save(p)
    shutil.copy(stale_ivf, os.path.join(p, "ivf.npz"))  # simulate the crash
    idx2 = Index.load(p)
    assert idx2.ivf is None, "generation-stale partition survived load"
    assert victim not in idx2.search(X[:1], k=10).ids[0]

    # Legacy saves (no stamp anywhere): the row-count fallback keeps the
    # partition and re-applies the tombstones so a persisted delete can
    # still never resurface.
    def strip_gen(fp):
        with np.load(fp) as z:
            arrs = {k: z[k] for k in z.files if k != "gen"}
        np.savez(fp + ".tmp.npz", **arrs)
        os.replace(fp + ".tmp.npz", fp)

    shutil.copy(stale_ivf, os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "codes.npz"))
    idx2b = Index.load(p)
    assert idx2b.ivf is not None
    r = idx2b.search(X[:1], k=10, nprobe=idx2b.ivf.nlist)
    assert victim not in r.ids[0], "legacy path resurrected a delete"

    # Window 2 (legacy): compact persisted, crash before ivf removal —
    # n_grouped > n detects the pre-compact leftover.
    idx2b.compact()
    idx2b.save(p)
    shutil.copy(stale_ivf, os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "ivf.npz"))
    strip_gen(os.path.join(p, "codes.npz"))
    idx3 = Index.load(p)
    assert idx3.ivf is None  # n_grouped > n: dropped, not misused
    idx3.search(X[:1], k=5)  # exhaustive still serves


def test_nprobe_validation(pq_index):
    idx, X = pq_index
    with pytest.raises(ValueError, match="nprobe"):
        idx.search(X[:1], k=3, nprobe=-1)


def test_corrupt_partition_rejected(tmp_path, rng_module):
    from local_search_quantization.ivf import IVFPartition

    X = _mk_clustered(rng_module, 400, 8, ncl=4)
    idx = Index.build(X[:200], X, "pq", m=2, h=16, niter=2)
    idx.build_ivf(nlist=4, sample=300, iters=5)
    good = idx.ivf.to_arrays()
    bad = dict(good)
    bad["lives"] = good["lives"] + 1000  # exceeds the padded segments
    with pytest.raises(ValueError, match="corrupt"):
        IVFPartition.from_arrays(bad)
    bad = dict(good)
    bad["order"] = good["order"].copy()
    bad["order"][good["order"] >= 0] = 0  # duplicate ids
    with pytest.raises(ValueError, match="corrupt"):
        IVFPartition.from_arrays(bad)


def test_fuzz_native_numpy_parity():
    """Seeded fuzz over random partition structures: empty lists, lists
    smaller/larger than 64, tombstones, both native top-k modes, k at and
    past the candidate count. Distances must match the numpy oracle
    exactly; ids must satisfy the per-slot oracle property."""
    if not native.has_ivf():
        pytest.skip("native library without lsq_linscan_ivf")
    import os

    rng = np.random.default_rng(1234)
    for trial in range(6):
        m = int(rng.choice([2, 7, 8]))
        h = int(rng.choice([16, 256]))
        nlist = int(rng.integers(3, 9))
        counts = rng.integers(0, 180, size=nlist)
        counts[rng.integers(0, nlist)] = 0  # force an empty list
        n = int(counts.sum())
        if n == 0:
            continue
        pads = (-counts) % 64
        starts = np.zeros(nlist + 1, np.int64)
        np.cumsum(counts + pads, out=starts[1:])
        n_g = int(starts[-1])
        order = np.full(n_g, -1, np.int64)
        codes_g = np.zeros((n_g, m), np.uint8)
        extra_g = np.zeros(n_g, np.float32)
        perm = rng.permutation(n)
        taken = 0
        for li in range(nlist):
            rows = perm[taken:taken + counts[li]]
            taken += counts[li]
            s0 = starts[li]
            order[s0:s0 + rows.size] = rows
            codes_g[s0:s0 + rows.size] = rng.integers(
                0, h, size=(rows.size, m)).astype(np.uint8)
            extra_g[s0:s0 + rows.size] = rng.normal(50, 10, rows.size)
        # Tombstone a few rows.
        tomb = rng.integers(0, n, size=max(1, n // 20))
        pos = np.empty(n, np.int64)
        live = order >= 0
        pos[order[live]] = np.flatnonzero(live)
        extra_g[pos[tomb]] = np.inf
        cent = rng.normal(size=(nlist, 4)).astype(np.float32)
        part = ivf.IVFPartition(
            centroids=cent, cnorms=(cent * cent).sum(1), order=order,
            starts=starts, lives=counts.astype(np.int64),
            codes_g=codes_g, codesT_g=np.ascontiguousarray(codes_g.T),
            extra_g=extra_g, pos_of_id=pos, n_grouped=n,
            emin=float(extra_g[np.isfinite(extra_g)].min()))
        nq = 5
        luts = rng.normal(size=(nq, m, h)).astype(np.float32) * 10
        nprobe = int(rng.integers(1, nlist + 1))
        probes = np.stack([
            rng.choice(nlist, nprobe, replace=False).astype(np.int32)
            for _ in range(nq)])
        k = int(rng.choice([1, 7, 64, 150]))
        for topk_mode in ("heap", "buf"):
            os.environ["LSQ_NATIVE_TOPK"] = topk_mode
            try:
                a = ivf.search(part, luts, k, probes, method="numpy")
                b = ivf.search(part, luts, k, probes)
            finally:
                del os.environ["LSQ_NATIVE_TOPK"]
            np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=0,
                                       err_msg=f"trial {trial} {topk_mode}")
            for q in range(nq):
                for j in range(k):
                    oid = b.ids[q, j]
                    if oid < 0:
                        assert np.isinf(b.dists[q, j])
                        continue
                    np.testing.assert_allclose(
                        _oracle_dist(part, luts, q, oid), b.dists[q, j],
                        rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("method", ["opq", "chainq"])
def test_rotated_methods_full_probe(method, rng_module):
    """OPQ and ChainQ quantize in rotated space: both the reconstruction
    used for the coarse partition (recon @ R^T) and the query LUTs carry
    the rotation; full-probe IVF must match the exhaustive scan."""
    X = _mk_clustered(rng_module, 900, 16, ncl=5)
    idx = Index.build(X[:300], X, method, m=2, h=16, niter=2)
    idx.build_ivf(nlist=4, sample=600, iters=5)
    Q = X[rng_module.integers(0, X.shape[0], 10)]
    ex = idx.search(Q, k=12)
    iv = idx.search(Q, k=12, nprobe=4)
    np.testing.assert_allclose(np.asarray(ex.dists), iv.dists,
                               rtol=1e-5, atol=1e-4)


def test_h_over_256_rejected(rng_module):
    from local_search_quantization.ivf import build_partition

    B = rng_module.integers(0, 300, size=(600, 2)).astype(np.int32)
    xhat = rng_module.normal(size=(600, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="uint8"):
        build_partition(B, xhat, None, 4)



def test_refine_lifts_r1_and_roundtrips(tmp_path, rng_module):
    """SQ8 refine: reranked r@1 vs TRUE neighbors must beat the ADC-only
    r@1 (8-bit codes are coarse; exact rerank recovers it), distances are
    true squared L2, and the store persists + extends through add()."""
    X = _mk_clustered(rng_module, 4000, 16, ncl=10, spread=0.6)
    Q = X[rng_module.integers(0, X.shape[0], 64)] + \
        rng_module.normal(size=(64, 16)).astype(np.float32) * 0.05
    # True nearest neighbors (exact f32).
    gt = np.array([np.argmin(((X - q) ** 2).sum(1)) for q in Q])
    # h=64 (12-bit codes): cells hold ~1 row, so the true NN reliably
    # sits inside the 20-candidate ADC window for the rerank to find.
    idx = Index.build(X[:800], X, "pq", m=2, h=64, niter=3, refine="sq8")
    plain = idx.search(Q, k=1)
    ref = idx.search(Q, k=1, refine=20)
    r1_plain = float(np.mean(plain.ids[:, 0] == gt))
    r1_ref = float(np.mean(ref.ids[:, 0] == gt))
    assert r1_ref > r1_plain + 0.2, (r1_plain, r1_ref)
    # Reranked distances are true squared L2 of the DEQUANTIZED rows.
    got = idx.refine.decode(ref.ids[:, 0])
    d_true = ((got - Q) ** 2).sum(1)
    np.testing.assert_allclose(ref.dists[:, 0], d_true, rtol=1e-5, atol=1e-3)

    p = str(tmp_path / "idx_refine")
    idx.save(p)
    idx2 = Index.load(p)
    assert idx2.refine is not None and idx2.refine.kind == "sq8"
    ref2 = idx2.search(Q, k=1, refine=20)
    np.testing.assert_array_equal(ref.ids, ref2.ids)

    # add() extends the store with the frozen affine params.
    ids = idx2.add(Q[:2])
    r3 = idx2.search(Q[:2], k=3, refine=10)
    assert ids[0] in r3.ids[0] and ids[1] in r3.ids[1]
    # Deleted rows can never resurface through the rerank stage.
    idx2.delete([int(r3.ids[0][0])])
    r4 = idx2.search(Q[:2], k=3, refine=10)
    assert int(r3.ids[0][0]) not in r4.ids[0]


def test_refine_composes_with_ivf(pq_index, rng_module):
    idx, X = pq_index
    try:
        idx.attach_refine(X[: idx.n], kind="sq8")
        Q = X[rng_module.integers(0, X.shape[0], 16)]
        r = idx.search(Q, k=5, nprobe=3, refine=8)
        assert r.ids.shape == (16, 5)
        for q in range(16):
            assert list(r.dists[q]) == sorted(r.dists[q])
            x = idx.refine.decode(r.ids[q])
            d = ((x - Q[q][None]) ** 2).sum(1)
            np.testing.assert_allclose(r.dists[q], d, rtol=1e-5, atol=1e-3)
    finally:
        idx.refine = None
        idx.meta.pop("refine", None)


def test_refine_validation(pq_index, rng_module):
    idx, X = pq_index
    with pytest.raises(ValueError, match="refine"):
        idx.search(X[:1], k=3, refine=4)  # no store attached
    with pytest.raises(ValueError, match="id order"):
        idx.attach_refine(X[:5])  # wrong shape


def test_refine_composes_with_mesh(rng_module):
    """search(mesh=..., refine=r): first stage sharded over the virtual
    device mesh, exact rerank host-side — distances must be the true
    squared L2 of the dequantized candidates."""
    from local_search_quantization.parallel.mesh import data_mesh

    X = _mk_clustered(rng_module, 1000, 16, ncl=6)
    idx = Index.build(X[:300], X, "pq", m=2, h=64, niter=2, refine="sq8")
    Q = X[rng_module.integers(0, 1000, 8)]
    r = idx.search(Q, k=5, mesh=data_mesh(), refine=8)
    plain = idx.search(Q, k=5, refine=8)
    np.testing.assert_allclose(r.dists, plain.dists, rtol=1e-6, atol=1e-4)
    for q in range(8):
        x = idx.refine.decode(r.ids[q])
        d = ((x - Q[q][None]) ** 2).sum(1)
        np.testing.assert_allclose(r.dists[q], d, rtol=1e-5, atol=1e-3)


def test_generation_stamp_detects_renumbering_stale_sidecars(
        tmp_path, rng_module):
    """Row-count heuristics cannot detect a compact() renumbering when
    counts coincide (delete 1 + add 1); the per-save generation stamp
    must drop such sidecars."""
    import os
    import shutil

    X = _mk_clustered(rng_module, 700, 8, ncl=4)
    idx = Index.build(X[:250], X, "pq", m=2, h=16, niter=2, refine="sq8")
    idx.build_ivf(nlist=4, sample=500, iters=5)
    p = str(tmp_path / "idx")
    idx.save(p)
    stale_ivf = str(tmp_path / "s_ivf.npz")
    stale_rq = str(tmp_path / "s_rq.npz")
    shutil.copy(os.path.join(p, "ivf.npz"), stale_ivf)
    shutil.copy(os.path.join(p, "refine.npz"), stale_rq)

    idx.delete([3])
    idx.compact()            # renumbers: ids shift by one past id 3
    idx.add(X[:1] + 0.5)     # n back to 700; counts coincide with stale
    idx.build_ivf(nlist=4, sample=500, iters=5)
    assert idx.ivf.n_grouped == 700
    idx.save(p)
    # Simulate the crash-between-renames: stale sidecars next to new codes.
    shutil.copy(stale_ivf, os.path.join(p, "ivf.npz"))
    shutil.copy(stale_rq, os.path.join(p, "refine.npz"))
    idx2 = Index.load(p)
    assert idx2.ivf is None, "renumbering-stale partition survived load"
    assert idx2.refine is None, "renumbering-stale refine survived load"
    idx2.search(X[:1], k=3)  # exhaustive still serves


def test_segmented_scan_preserves_sentinels(rng_module):
    """The >base_segment host-merge path must not offset a -1 sentinel
    into a real id of the previous segment."""
    n, d, m, h = 600, 16, 2, 16
    C_sub = (rng_module.normal(size=(m, h, d // m)) * 5).astype(np.float32)
    B = rng_module.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng_module.normal(size=(3, d)).astype(np.float32) * 5
    extra = np.zeros(n, np.float32)
    extra[10:] = np.inf  # all live rows sit in the FIRST segment
    from local_search_quantization.ops import adc

    res = adc.linscan_pq(B, Q, C_sub, k=40, extra=extra,
                         base_segment=256)
    ids, dists = np.asarray(res.ids), np.asarray(res.dists)
    assert np.isinf(dists[:, 10:]).all()
    assert (ids[:, 10:] == -1).all(), ids[:, 10:]
    assert (ids[:, :10] >= 0).all() and (ids[:, :10] < 10).all()


def test_tombstone_negative_ids_noop(pq_index):
    idx, X = pq_index
    part = idx.ivf
    before = (None if part.extra_g is None else part.extra_g.copy())
    part.tombstone(np.array([-1, -5]))
    if before is None:
        assert part.extra_g is None or np.isfinite(part.extra_g).all()
    else:
        np.testing.assert_array_equal(part.extra_g, before)


def test_nlist_beyond_sample_rejected(rng_module):
    from local_search_quantization.ivf import build_partition

    B = rng_module.integers(0, 16, size=(500, 2)).astype(np.int32)
    xhat = rng_module.normal(size=(500, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="sample"):
        build_partition(B, xhat, None, nlist=200, sample=100)
