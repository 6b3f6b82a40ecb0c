"""RVQ trainer (models/rvq.py) — beyond the reference; the additive
serving stack (norms + linscan_lsq + Index) applies verbatim."""

import numpy as np
import pytest

from local_search_quantization.index import Index
from local_search_quantization.models import train_rvq
from local_search_quantization.models.rvq import quantize_rvq
from local_search_quantization.ops import costs
from local_search_quantization.utils.config import RVQConfig


@pytest.fixture
def rng():  # function-scoped: tests stay order-independent
    return np.random.default_rng(42)


def test_stages_monotone_and_encode_matches_train(rng):
    X = (rng.normal(size=(2500, 24)) * 3).astype(np.float32)
    mod = train_rvq(X, RVQConfig(m=4, h=32, seed=1))
    obj = np.asarray(mod.obj)
    assert (np.diff(obj) < 0).all(), obj  # every stage strictly helps
    # Greedy encode reproduces the training assignment exactly.
    B2 = np.asarray(quantize_rvq(X, mod.C))
    np.testing.assert_array_equal(B2, np.asarray(mod.B))
    # The traced objective IS the reconstruction error of the codes.
    np.testing.assert_allclose(
        float(costs.qerror(X, mod.B, mod.C)), obj[-1], rtol=1e-5)


def test_rvq_index_lifecycle(rng, tmp_path):
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4
    X = (centers[rng.integers(0, 8, 3000)]
         + rng.normal(size=(3000, 16)).astype(np.float32) * 0.4)
    idx = Index.build(X[:800], X, "rvq", m=3, h=64, niter=10)
    assert idx.additive and idx.meta["bits"] == 3 * 6 + 8
    # Self-queries on clustered data: top-10 must contain the query's
    # own row most of the time.
    qi = rng.integers(0, 3000, 50)
    r = idx.search(X[qi], k=30)
    assert np.mean([qi[i] in r.ids[i] for i in range(50)]) > 0.6
    ids = idx.add(X[:2] + 0.01)
    r2 = idx.search(X[:2] + 0.01, k=50)
    assert ids[0] in r2.ids[0] and ids[1] in r2.ids[1]
    idx.delete([ids[0]])
    p = str(tmp_path / "idx_rvq")
    idx.save(p)
    idx2 = Index.load(p)
    assert idx2.method == "rvq" and idx2.n == 3002
    r3 = idx2.search(X[:2] + 0.01, k=50)
    assert ids[0] not in r3.ids[0] and ids[1] in r3.ids[1]
    # IVF + refine compose like any additive method.
    idx2.build_ivf(nlist=4, sample=2000, iters=5)
    iv = idx2.search(X[:2] + 0.01, k=50, nprobe=4)
    np.testing.assert_allclose(np.asarray(r3.dists), iv.dists,
                               rtol=1e-6, atol=1e-4)
