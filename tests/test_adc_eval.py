"""ADC scanners vs brute-force oracles; recall eval; norm quantization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.models import train_pq
from local_search_quantization.ops import adc, costs, norms
from local_search_quantization.ops.subspaces import (
    pq_full_codebooks,
    reconstruct_pq,
)
from local_search_quantization.utils.config import PQConfig
from local_search_quantization.utils.eval import eval_recall


def test_linscan_pq_matches_bruteforce(rng):
    n, nq, d, m, h = 500, 7, 16, 4, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    model = train_pq(X, PQConfig(m=m, h=h))
    B = np.asarray(model.B)
    k = 20
    res = adc.linscan_pq(B, Q, model.C_sub, k=k, query_chunk=4, base_block=128)
    # Oracle: exact ADC distance = || q - recon ||^2.
    recon = np.asarray(reconstruct_pq(jnp.asarray(B), model.C_sub, d))
    for qi in range(nq):
        d2 = np.sum((recon - Q[qi]) ** 2, axis=1)
        order = np.argsort(d2, kind="stable")[:k]
        np.testing.assert_allclose(
            np.sort(res.dists[qi]), np.sort(d2[order]), rtol=1e-3, atol=1e-3
        )
        # Same candidate set modulo ties.
        assert len(set(res.ids[qi]) & set(order)) >= k - 2


def test_linscan_lsq_matches_bruteforce(rng):
    n, nq, d, m, h = 400, 5, 12, 3, 8
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbnorms = np.sum(recon * recon, axis=1).astype(np.float32)
    k = 15
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=k, query_chunk=4,
                          base_block=128)
    for qi in range(nq):
        # The scanner's score: -2 q.recon + ||recon||^2 (drops ||q||^2).
        score = -2.0 * recon @ Q[qi] + dbnorms
        order = np.argsort(score, kind="stable")[:k]
        np.testing.assert_allclose(
            np.sort(res.dists[qi]), np.sort(score[order]), rtol=1e-3, atol=1e-3
        )
        assert len(set(res.ids[qi]) & set(order)) >= k - 2


def test_linscan_padding_never_wins(rng):
    # n deliberately not a multiple of base_block.
    n, d, m, h = 100, 8, 2, 4
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(3, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbnorms = np.sum(recon * recon, axis=1).astype(np.float32)
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=50, query_chunk=4,
                          base_block=64)
    assert res.ids.max() < n
    assert res.ids.min() >= 0


def test_eval_recall():
    gt = np.array([5, 3, 9, 0])
    ids = np.array(
        [
            [5, 1, 2, 4],  # rank 1
            [1, 3, 2, 4],  # rank 2
            [1, 2, 4, 9],  # rank 4
            [7, 8, 1, 2],  # not found
        ]
    )
    rec = eval_recall(gt, ids, 4, verbose=False)
    np.testing.assert_allclose(rec, [0.25, 0.5, 0.5, 0.75])


def test_quantize_norms_roundtrip(rng):
    n, d, m, h = 300, 8, 3, 16
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cbnorms, codes = norms.train_norm_codebook(
        jax.random.PRNGKey(0), jnp.asarray(B), jnp.asarray(C), h
    )
    codes2 = norms.quantize_norms(jnp.asarray(B), jnp.asarray(C), cbnorms)
    true = np.asarray(norms.reconstruction_sqnorms(jnp.asarray(B), jnp.asarray(C)))
    approx = np.asarray(cbnorms)[np.asarray(codes2)]
    # Quantized norms are close in relative terms.
    rel = np.abs(approx - true) / np.maximum(true, 1e-6)
    assert np.median(rel) < 0.2
    # quantize_norms at the training set is consistent with its own codebook:
    # every assignment is the argmin.
    d2 = (true[:, None] - np.asarray(cbnorms)[None, :]) ** 2
    np.testing.assert_array_equal(np.asarray(codes2), np.argmin(d2, axis=1))


def test_scalar_kmeans_heavy_tail_quality():
    # SIFT-scale squared norms (~1e5, lognormal): the f64 scalar trainer
    # must keep both the bulk (mean) and the tail (max) quantization
    # error at the intrinsic 256-bin level — values chosen with ~2x
    # slack over measured (mean rel 2.0e-3, max 1.2e4 at spread 4e4).
    v = np.exp(np.random.default_rng(7).normal(np.log(1e5), 0.36, 100_000))
    c = norms.scalar_kmeans(v, 256)
    assert np.all(np.diff(c) >= 0)
    q = c[np.searchsorted((c[1:] + c[:-1]) / 2.0, v)]
    err = np.abs(q - v)
    assert err.mean() / v.mean() < 4e-3
    assert err.max() < 3e4
    # Deterministic: same input -> bitwise-identical codebook.
    np.testing.assert_array_equal(c, norms.scalar_kmeans(v, 256))


def test_linscan_approx_topk_mode(rng):
    n, nq, d, m, h = 512, 4, 8, 2, 8
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbnorms = np.sum(recon * recon, axis=1).astype(np.float32)
    exact = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=10, query_chunk=4,
                            base_block=128)
    approx = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=10, query_chunk=4,
                             base_block=128, topk_method="approx:0.99")
    # High-recall approximate top-k recovers almost all of the exact set.
    overlap = np.mean([
        len(set(approx.ids[q]) & set(exact.ids[q])) / 10 for q in range(nq)
    ])
    assert overlap > 0.8


def test_linscan_base_segmentation_matches_whole(rng):
    """Host-side base segmentation (the >HBM streaming path) must return
    exactly the whole-base result, ids globally offset."""
    n, nq, d, m, h, k = 3000, 4, 8, 2, 8, 11
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    whole = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=4,
                            base_block=256)
    seg = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=4,
                          base_block=256, base_segment=1024)
    np.testing.assert_allclose(np.asarray(seg.dists), np.asarray(whole.dists),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(seg.ids).min() >= 0 and np.asarray(seg.ids).max() < n


def test_linscan_tournament_exactly_matches_streaming(rng, monkeypatch):
    """The group-minima tournament is EXACT: identical distances to the
    streaming lax.top_k path, in both stash-the-tiles and O(1)-memory
    recompute modes."""
    n, nq, d, m, h = 4096, 6, 8, 3, 8
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbnorms = np.sum(recon * recon, axis=1).astype(np.float32)
    k = 17
    exact = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=k, query_chunk=8,
                            base_block=1024)
    two = adc.linscan_lsq(B, Q, jnp.asarray(C), dbnorms, k=k, query_chunk=8,
                          base_block=1024, topk_method="tournament")
    np.testing.assert_allclose(np.asarray(two.dists), np.asarray(exact.dists),
                               rtol=1e-5, atol=1e-5)
    # Certified lex contract: both routes see bitwise-identical block
    # distances (same lut_scan_block), and the tournament's certify/rerun
    # phase makes its boundary survival exactly (dist, id)-lexicographic
    # — so the ids must MATCH the streaming merge id-for-id, ties or not.
    np.testing.assert_array_equal(np.asarray(two.ids), np.asarray(exact.ids))

    # Recompute mode (no [nq, n] stash): same result, including the norms
    # `extra` term re-added during candidate recomputation.
    luts = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C))
    rec = adc._scan_topk_tournament(
        luts, jnp.asarray(B.T), jnp.asarray(dbnorms), k, 1024,
        store_dists=False,
    )
    np.testing.assert_allclose(np.asarray(rec.dists),
                               np.asarray(exact.dists)[:nq],
                               rtol=1e-5, atol=1e-5)

    # Brute-force distance oracle (ids may swap on fp near-ties at the k-th
    # boundary; the value multiset is the exactness contract).
    full = -2.0 * Q @ recon.T + dbnorms[None, :]
    oracle_d = np.sort(full, axis=1)[:, :k]
    np.testing.assert_allclose(np.asarray(two.dists), oracle_d,
                               rtol=1e-4, atol=1e-4)

    # Certified recompute mode end-to-end (LSQ_TOPK_STORE=0 forces
    # the O(1)-memory route through _run_scan): the cross-metric
    # certificate's summand-magnitude slack must flag
    # boundary ties without being poisoned by +inf tombstone entries in
    # `extra` (an inf-scaled slack would flag EVERY query and rerun the
    # whole batch), and the rerouted results must still match the
    # streaming merge id-for-id.
    monkeypatch.setenv("LSQ_TOPK_STORE", "0")
    dbn_t = dbnorms.copy()
    dbn_t[:7] = np.inf  # tombstones ride the extra term
    ex_t = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn_t, k=k, query_chunk=8,
                           base_block=1024)
    rc_t = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn_t, k=k, query_chunk=8,
                           base_block=1024, topk_method="tournament")
    np.testing.assert_array_equal(np.asarray(rc_t.ids), np.asarray(ex_t.ids))
    assert not np.isin(np.arange(7), np.asarray(rc_t.ids)).any()
    _, tied = adc._scan_topk_tournament(
        luts, jnp.asarray(B.T), jnp.asarray(dbn_t), k, 1024,
        store_dists=False, certify=True)
    # h=8, m=3 gives only 512 distinct code rows over n=4096: every query
    # boundary sits inside a genuine tie block, so flagging ALL is the
    # CORRECT behavior here (and the id-parity assert above proves the
    # rerun restores exactness).
    assert bool(np.asarray(tied).all())
    # Poisoning check needs distance-distinct data (h=32 -> 32k distinct
    # rows): margins near the boundary are then orders of magnitude
    # larger than the cross-metric slack, so an all-flagged result could
    # only come from an inf-poisoned scale (the bug this guards).
    h2 = 32
    C2 = (rng.normal(size=(m, h2, d))).astype(np.float32)
    B2 = rng.integers(0, h2, size=(n, m), dtype=np.int32)
    recon2 = np.asarray(costs.reconstruct(jnp.asarray(B2), jnp.asarray(C2)))
    dbn2 = np.sum(recon2 * recon2, axis=1).astype(np.float32)
    dbn2[:7] = np.inf
    luts2 = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C2))
    _, tied2 = adc._scan_topk_tournament(
        luts2, jnp.asarray(B2.T), jnp.asarray(dbn2), k, 1024,
        store_dists=False, certify=True)
    assert not bool(np.asarray(tied2).any()), (
        "distinct-distance data flagged tied — the certificate slack "
        "scale is poisoned (|inf| extra?)")


@pytest.mark.parametrize("method",
                         ["tournament", "exact", "approx", "native"])
def test_scan_sentinel_contract(rng, method):
    """Every scan path shares the (+inf, -1) sentinel contract: none may
    return tombstoned rows' real ids at +inf distance (regression: the
    tournament path violated this, and refine.rerank converted such ids
    back into finite-distance results, resurrecting deletes). The exact
    streaming merge preserves -1 only through top_k's prefer-lower-index
    tie rule + the carry-first concat order — this pins that too."""
    from local_search_quantization.utils import native as nat

    if method == "native" and not nat.available():
        pytest.skip("native library not built")
    n, d, m, h = 600, 16, 2, 16
    C_sub = (rng.normal(size=(m, h, d // m)) * 5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.int32)
    Q = rng.normal(size=(4, d)).astype(np.float32) * 5
    extra = np.zeros(n, np.float32)
    extra[10:] = np.inf  # tombstone all but 10 rows
    res = adc.linscan_pq(B, Q, C_sub, k=40, extra=extra,
                         topk_method=method)
    dists, ids = np.asarray(res.dists), np.asarray(res.ids)
    assert np.isfinite(dists[:, :10]).all()
    assert (ids[:, :10] < 10).all() and (ids[:, :10] >= 0).all()
    assert np.isinf(dists[:, 10:]).all()
    assert (ids[:, 10:] == -1).all(), ids[:, 10:]


def test_pad_rerun_idx_buckets_shapes():
    """Every tie-rerun site feeds a data-dependent number of tied queries
    into a jitted scan; pad_rerun_idx must bucket that leading dim to a
    power of two >= 8 (each DISTINCT count would otherwise be a fresh
    compile) while keeping the original indices as a
    prefix so callers can scatter back the first len(tq) rows."""
    for count in (1, 2, 7, 8, 9, 129, 1000):
        tq = np.arange(count, dtype=np.int64) * 3
        p = adc.pad_rerun_idx(tq)
        assert len(p) >= max(8, count)
        assert (len(p) & (len(p) - 1)) == 0  # power of two
        np.testing.assert_array_equal(p[:count], tq)
        assert (p[count:] == tq[0]).all()  # pads are a real, valid query
    # Empty input has no first index to pad with; the precondition is an
    # explicit error, not an IndexError (callers gate on tied.any()).
    with pytest.raises(ValueError, match="nonempty"):
        adc.pad_rerun_idx(np.empty(0, np.int64))


def test_run_scan_device_state_matches_fresh_upload(rng):
    """prepare_device_codes + device_state (the serving-side code cache,
    Index._device_scan_state) must be result-identical to the per-call
    upload on both the streaming and tournament routes, and a state built
    for a different base/base_block must be rejected, not silently
    scanned."""
    n, nq, d, m, h = 1000, 6, 8, 2, 8
    C_sub = (rng.normal(size=(m, h, d // m)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    state = adc.prepare_device_codes(B, None, base_block=256)
    assert state[0].shape == (m, 1024)  # padded to the block multiple
    assert bool(jnp.isinf(state[1][n:]).all())  # pads can never win
    for method in ("exact", "tournament"):
        fresh = adc.linscan_pq(B, Q, C_sub, k=10, topk_method=method,
                               base_block=256)
        cached = adc.linscan_pq(B, Q, C_sub, k=10, topk_method=method,
                                base_block=256, device_state=state)
        np.testing.assert_array_equal(np.asarray(cached.ids),
                                      np.asarray(fresh.ids))
        np.testing.assert_array_equal(np.asarray(cached.dists),
                                      np.asarray(fresh.dists))
    with pytest.raises(ValueError, match="device_state"):
        adc.linscan_pq(B, Q, C_sub, k=10, base_block=384,
                       device_state=state)
    with pytest.raises(ValueError, match="device_state"):
        adc.linscan_pq(B[:700], Q, C_sub, k=10, base_block=256,
                       device_state=state)


def test_quantize_norms_chunked_matches_single_launch(rng):
    """quantize_norms row-chunking (the [n*m, d] reconstruction
    intermediate is a measured 27 GB HBM OOM at the GIST paper-scale
    shape) must be code-identical to the single-launch path, including
    a padded final block."""
    n, d, m, h = 1000, 12, 3, 16
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = jnp.asarray(rng.integers(0, h, size=(n, m), dtype=np.int32))
    cb = jnp.asarray(np.sort(rng.random(h)).astype(np.float32) * 50.0)
    whole = np.asarray(norms.quantize_norms(B, jnp.asarray(C), cb))
    chunked = np.asarray(norms.quantize_norms(B, jnp.asarray(C), cb,
                                              block=256))
    np.testing.assert_array_equal(chunked, whole)


@pytest.mark.parametrize("mode", ["gather", "matmul"])
def test_exact_route_within_precision_contract(rng, mode):
    """The exact streaming route against the f64 oracle at SIFT-like
    magnitudes (m=8, h=256): every returned distance is within
    SCAN_REL_TOL * scan_error_scale of the f64 sum of the same f32 LUT
    entries, every returned id lies within that band of the k-th value,
    and no id below the band is missing."""
    n, nq, d, m, h, k = 4096, 8, 32, 8, 256, 50
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    Q = (rng.normal(size=(nq, d)) * 30.0).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B.astype(np.int32)),
                                         jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, mode=mode,
                          topk_method="exact", base_block=1024)
    luts = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C))
    luts64 = np.asarray(luts, np.float64)
    full = luts64[:, np.arange(m)[:, None], B.T].sum(1) + dbn[None, :]
    tol = adc.SCAN_REL_TOL * np.asarray(
        adc.scan_error_scale(luts, jnp.asarray(dbn)), np.float64)[:, None]
    ids, dists = np.asarray(res.ids), np.asarray(res.dists)
    at = np.take_along_axis(full, ids, axis=1)
    assert (np.abs(dists - at) <= tol).all()
    kth = np.sort(full, axis=1)[:, k - 1:k]
    assert (at <= kth + tol).all()
    got = np.zeros(full.shape, bool)
    np.put_along_axis(got, ids, True, axis=1)
    assert not ((full < kth - tol) & ~got).any()


@pytest.mark.parametrize("h", [20, 200])
def test_exact_route_odd_h(rng, h):
    """h off any power of two scans exactly (codes index the LUT columns
    directly; no padded column can be selected)."""
    n, nq, d, m, k = 2048, 3, 8, 3, 9
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, base_block=512,
                          topk_method="exact")
    full = -2.0 * Q @ recon.T + dbn[None, :]
    np.testing.assert_allclose(np.asarray(res.dists),
                               np.sort(full, axis=1)[:, :k],
                               rtol=1e-4, atol=1e-4)
    assert np.asarray(res.ids).min() >= 0 and np.asarray(res.ids).max() < n


@pytest.mark.parametrize("method", ["exact", "tournament"])
def test_deepk_tie_blocks_lexicographic(rng, method):
    """Deep k over tie-heavy duplicated codes (h=4: the boundary tie block
    is hundreds wide): the returned ids are the (dist, id)-lexicographic
    oracle's, id for id — the streaming merge by construction, the
    tournament through its certify/rerun phase."""
    n, nq, d, m, h, k = 12000, 3, 8, 2, 4, 2100
    C_sub = jnp.asarray(rng.normal(size=(m, h, d // m)).astype(np.float32))
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    B[n // 2:] = B[: n - n // 2]  # massive exact ties
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    res = adc.linscan_pq(B, Q, C_sub, k=k, topk_method=method,
                         base_block=4096)
    luts = np.asarray(adc.pq_query_luts(jnp.asarray(Q), C_sub))
    full = luts[:, np.arange(m)[:, None], B.T].sum(1)
    ids_lex = np.lexsort(
        (np.broadcast_to(np.arange(n), full.shape), full), axis=1
    )[:, :k]
    np.testing.assert_array_equal(np.asarray(res.ids), ids_lex)
    np.testing.assert_allclose(
        np.asarray(res.dists),
        np.take_along_axis(full, ids_lex, axis=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["exact", "tournament", "native"])
def test_bf16_rounded_metric_ids_equal_oracle(rng, method):
    """precision="bf16" returns the EXACT lexicographic top-k of distances
    computed from bf16-ROUNDED LUTs — a deterministic contract, not a
    tolerance — on every route, because _run_scan rounds the tables once
    before routing. The rounding must actually bite, and the rounded
    mode must not fall off a quality cliff against f32."""
    from local_search_quantization.utils import native as _nat

    if method == "native" and not _nat.available():
        pytest.skip("native library not built")
    n, nq, d, m, h, k = 8192, 6, 8, 3, 8, 33
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    luts = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C))
    # Oracle over the ROUNDED tables (f64 sums of bf16-exact values).
    rl = np.asarray(jnp.asarray(luts).astype(jnp.bfloat16).astype(
        jnp.float32), np.float64)
    assert np.any(rl != np.asarray(luts)), "rounding must actually bite"
    full_r = rl[:, np.arange(m)[:, None], B.T].sum(1) + dbn[None, :]
    oracle_ids = np.lexsort(
        (np.broadcast_to(np.arange(n), full_r.shape), full_r), axis=1
    )[:, :k]
    res = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=8,
                          base_block=1024, topk_method=method,
                          precision="bf16")
    np.testing.assert_array_equal(np.asarray(res.ids), oracle_ids)
    exact = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=8,
                            base_block=1024, topk_method=method)
    overlap = np.mean([
        len(set(map(int, a)) & set(map(int, b))) / k
        for a, b in zip(np.asarray(exact.ids), oracle_ids)
    ])
    assert overlap >= 0.9, overlap
    with pytest.raises(ValueError, match="precision"):
        adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, precision="fp8")
