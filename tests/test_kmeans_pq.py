"""k-means and PQ/OPQ trainer tests."""

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.models import (
    quantize_opq,
    quantize_pq,
    train_opq,
    train_pq,
)
from local_search_quantization.ops import kmeans as km
from local_search_quantization.ops.subspaces import qerror_opq, qerror_pq
from local_search_quantization.utils.config import OPQConfig, PQConfig


def test_kmeans_recovers_separated_clusters(rng):
    centers = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 10.0]], np.float32)
    X = np.concatenate(
        [c + 0.05 * rng.normal(size=(50, 2)).astype(np.float32) for c in centers]
    )
    res = km.kmeans(jax.random.PRNGKey(0), jnp.asarray(X), 4)
    assert float(res.cost) < 0.1
    # Each true center is matched by some learned center.
    learned = np.asarray(res.centers)
    for c in centers:
        assert np.min(np.sum((learned - c) ** 2, axis=1)) < 0.1


def test_kmeans_objective_and_assignment_consistency(rng):
    X = rng.normal(size=(300, 8)).astype(np.float32)
    res = km.kmeans(jax.random.PRNGKey(1), jnp.asarray(X), 16)
    labels, costs = km.assign(jnp.asarray(X), res.centers)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(res.assignments))
    np.testing.assert_allclose(float(jnp.mean(costs)), float(res.cost), rtol=1e-5)


def test_kmeans_handles_duplicate_points(rng):
    # More centers than distinct points: empty-cluster repair must not NaN.
    X = np.repeat(rng.normal(size=(3, 4)).astype(np.float32), 10, axis=0)
    res = km.kmeans(jax.random.PRNGKey(2), jnp.asarray(X), 8)
    assert np.isfinite(np.asarray(res.centers)).all()
    assert float(res.cost) < 1e-6


def test_train_pq_improves_over_random_and_encodes(rng):
    X = rng.normal(size=(500, 32)).astype(np.float32)
    cfg = PQConfig(m=4, h=16, seed=0)
    model = train_pq(X, cfg)
    assert model.C_sub.shape == (4, 16, 8)
    assert model.B.shape == (500, 4)
    # Train error beats quantizing with random codebooks.
    Crand = jnp.asarray(rng.normal(size=(4, 16, 8)).astype(np.float32))
    Brand = quantize_pq(X, Crand)
    assert float(model.error) < float(qerror_pq(X, Brand, Crand))
    # Encoding the training set reproduces the training assignment cost.
    B2 = quantize_pq(X, model.C_sub)
    np.testing.assert_allclose(
        float(qerror_pq(X, B2, model.C_sub)), float(model.error), rtol=1e-4
    )


def test_train_pq_uneven_subspaces(rng):
    X = rng.normal(size=(200, 23)).astype(np.float32)  # 23 dims, 3 subspaces
    model = train_pq(X, PQConfig(m=3, h=8))
    assert float(model.error) > 0
    B = quantize_pq(X, model.C_sub)
    assert B.shape == (200, 3)


def test_train_opq_monotone_and_beats_pq(rng):
    # Correlated data: OPQ's rotation should help vs plain PQ.
    n, d = 600, 16
    A = rng.normal(size=(d, d)).astype(np.float32)
    X = (rng.normal(size=(n, d)).astype(np.float32) @ A).astype(np.float32)
    pq = train_pq(X, PQConfig(m=4, h=16, seed=3))
    opq = train_opq(X, OPQConfig(m=4, h=16, niter=15, seed=3))
    objs = np.asarray(opq.obj)
    # Objective is near-monotone decreasing (tiny numerical wiggle allowed).
    assert objs[-1] <= objs[0] * 1.001
    assert objs[-1] < float(pq.error) * 1.05
    # R orthogonal.
    R = np.asarray(opq.R)
    np.testing.assert_allclose(R @ R.T, np.eye(d), atol=1e-4)
    # quantize_opq reproduces the final objective.
    B2 = quantize_opq(X, opq.R, opq.C_sub)
    np.testing.assert_allclose(
        float(qerror_opq(X, B2, opq.C_sub, opq.R)), objs[-1], rtol=0.05
    )
