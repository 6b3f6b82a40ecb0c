"""Statistical contract of the SIFT-statistics synthetic corpus (v4).

The corpus is the quality evidence's foundation (the reference loads real
TEXMEX files, /root/reference/src/read/read_datasets.jl:16-34; offline we
substitute a calibrated generator). These tests pin the properties the
calibration established (utils/synth.py module docstring,
scripts/calibrate_corpus.py) so a generator change that silently breaks
them — and with them the golden gates and the paper-ordering assertion —
fails here with a named property instead of an opaque recall drift.
"""

import numpy as np

from local_search_quantization.utils.synth import synthetic_dataset


def _data(**kw):
    kw.setdefault("d", 128)
    kw.setdefault("n_train", 1000)
    kw.setdefault("n_base", 8000)
    kw.setdefault("n_query", 200)
    return synthetic_dataset(5, **kw)


def test_values_are_sift_like():
    """Nonnegative uint8-range integers (SIFT descriptor codomain)."""
    dd = _data()
    for x in (dd.train, dd.base, dd.query):
        assert x.dtype == np.float32
        assert x.min() >= 0.0 and x.max() <= 255.0
        np.testing.assert_array_equal(x, np.rint(x))


def test_norms_concentrate():
    """Real SIFT norms cluster tightly (renormalize+clip pipeline); the
    1-byte norm-quantization handicap calibration depends on this. v5
    concentrates SAMPLE norms (norm_sigma=0.10 -> CV ~0.10); v4 only
    concentrated center norms and its 0.31 sample CV made the norm byte
    invert the paper ordering at 1M scale (synth.py norm_sigma doc)."""
    dd = _data()
    nb = np.linalg.norm(dd.base, axis=1)
    assert nb.std() / nb.mean() < 0.15, nb.std() / nb.mean()


def test_ground_truth_is_exact():
    dd = _data(n_base=3000, n_query=64)
    d2 = ((dd.base[None, :, :] - dd.query[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(dd.gt, np.argmin(d2, axis=1))


def test_planted_queries_have_margin():
    """TEXMEX queries are matching descriptors of base scene points: most
    queries must have a true NN clearly below the distractor floor —
    the property that makes recall@N meaningful at 64-bit code budgets."""
    dd = _data()
    b2 = (dd.base ** 2).sum(1)
    d2 = b2[None, :] - 2.0 * dd.query @ dd.base.T  # + q2, rank-invariant
    part = np.partition(d2, (0, 1), axis=1)
    nn, second = part[:, 0], part[:, 1]
    median_floor = np.median(d2, axis=1)
    # Planted fraction is 0.9: at least ~80% of queries should have an
    # NN at under half the median distractor distance.
    frac_planted_like = np.mean(nn + (dd.query ** 2).sum(1) <
                                0.5 * (median_floor + (dd.query ** 2).sum(1)))
    assert frac_planted_like > 0.75, frac_planted_like
    # And the NN should usually be isolated from the runner-up (a
    # near-duplicate, not a random cluster member).
    assert np.mean(second - nn > 0) == 1.0


def test_quantization_hardness_band():
    """The v4 calibration targets a realistic quantization-noise ratio:
    within-cluster spread neither trivial (v2: mse/sqnorm ~0.5%, method
    separation vanished) nor overwhelming. Proxy without training: the
    per-cluster residual energy around a 64-means coarse model of the
    base, relative to mean squared norm, sits in a broad middle band."""
    dd = _data(n_base=6000)
    x = dd.base
    rng = np.random.default_rng(0)
    ctr = x[rng.choice(len(x), 64, replace=False)].copy()
    for _ in range(5):
        d2 = ((x ** 2).sum(1)[:, None] - 2 * x @ ctr.T
              + (ctr ** 2).sum(1)[None, :])
        a = d2.argmin(1)
        for j in range(64):
            sel = x[a == j]
            if len(sel):
                ctr[j] = sel.mean(0)
    resid = ((x - ctr[a]) ** 2).sum(1).mean()
    ratio = resid / (x ** 2).sum(1).mean()
    assert 0.05 < ratio < 0.6, ratio


def test_tiny_query_counts():
    """n_query so small that every query is planted (the fresh remainder
    draw is zero-size) must not crash, and must not perturb the generator
    state consumed by larger draws (zero-size rng draws are state-free)."""
    for nq in (1, 2):
        dd = _data(n_base=500, n_query=nq)
        assert dd.query.shape[0] == nq and dd.gt.shape[0] == nq
    big = _data(n_base=500, n_query=50)
    one = _data(n_base=500, n_query=1)
    np.testing.assert_array_equal(big.base, one.base)


def test_deterministic_given_seed():
    a = _data(n_base=2000, n_query=20)
    b = _data(n_base=2000, n_query=20)
    np.testing.assert_array_equal(a.base, b.base)
    np.testing.assert_array_equal(a.query, b.query)
    np.testing.assert_array_equal(a.gt, b.gt)


def test_corpus_fingerprint_matches_committed_artifacts():
    """Silent-corpus-drift guard: the committed
    quality artifacts carry the fingerprint of the generator that produced
    their corpus; the CURRENT generator must still produce that corpus.
    A calibration change must bump CORPUS_VERSION, re-pin the golden
    gates, and regenerate the artifacts — this test is what makes
    forgetting that loud."""
    import json
    import os

    from local_search_quantization.utils.synth import (
        CORPUS_VERSION,
        corpus_fingerprint,
    )

    assert CORPUS_VERSION == 5
    fp = corpus_fingerprint()
    assert fp == "v5-c46d0184714f7c20"
    root = os.path.join(os.path.dirname(__file__), "..")
    for name in ("recall_table_paperscale.json",
                 "recall_table_paperscale_128.json",
                 "recall_table_midscale_v5.json",
                 "recall_table_src.json", "recall_table_srd.json"):
        p = os.path.join(root, name)
        if not os.path.exists(p):
            continue
        with open(p) as f:
            t = json.load(f)
        assert t.get("corpus_fingerprint") == fp, (
            f"{name} was generated on corpus {t.get('corpus_fingerprint')} "
            f"but the current generator produces {fp} — regenerate the "
            "artifact or bump CORPUS_VERSION with re-pinned gates")
