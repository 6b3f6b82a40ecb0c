"""Sparse LSQ: L1 projection / FISTA oracles and trainer behavior."""

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.models.pq import train_pq
from local_search_quantization.models.slsq import train_lsq_sparse
from local_search_quantization.ops import prox
from local_search_quantization.ops.costs import qerror
from local_search_quantization.utils.config import PQConfig, SLSQConfig
from local_search_quantization.utils.synth import synthetic_dataset


def test_project_l1_ball_oracle(rng):
    v = rng.normal(size=(6, 4)).astype(np.float32)
    for tau in (0.5, 2.0, 100.0):
        p = np.asarray(prox.project_l1_ball(jnp.asarray(v), jnp.float32(tau)))
        assert np.abs(p).sum() <= tau * 1.001
        if np.abs(v).sum() <= tau:
            np.testing.assert_array_equal(p, v)
        else:
            # Projection optimality: distance to any other feasible point
            # (sampled) is no smaller.
            for _ in range(20):
                w = rng.normal(size=v.shape).astype(np.float32)
                w = w / max(np.abs(w).sum() / tau, 1.0)
                assert np.sum((p - v) ** 2) <= np.sum((w - v) ** 2) + 1e-4


def test_solve_l1_constrained_matches_lstsq_when_unconstrained(rng):
    n, d, m, h = 300, 4, 2, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    A = np.zeros((n, m * h), np.float32)
    for i in range(m):
        A[np.arange(n), i * h + B[:, i]] = 1.0
    K, *_ = np.linalg.lstsq(A, X, rcond=None)
    tau = jnp.float32(10.0 * np.abs(K).sum())  # loose ball: unconstrained
    K0 = jnp.zeros((m, h, d), jnp.float32)
    sol = np.asarray(
        prox.solve_l1_constrained(jnp.asarray(B), jnp.asarray(X), h, tau, K0,
                                  iters=300)
    )
    r_ours = np.linalg.norm(A @ sol.reshape(m * h, d) - X)
    r_np = np.linalg.norm(A @ K - X)
    np.testing.assert_allclose(r_ours, r_np, rtol=2e-2)


def test_threshold_top_s(rng):
    K = rng.normal(size=(3, 4, 5)).astype(np.float32)
    out = np.asarray(prox.threshold_top_s(jnp.asarray(K), 7))
    assert (out != 0).sum() == 7
    kept = np.abs(out[out != 0])
    dropped = np.abs(K[out == 0])
    assert kept.min() >= dropped.max() - 1e-6


def test_train_lsq_sparse_end_to_end():
    data = synthetic_dataset(1, d=16, n_train=800, n_base=100, n_query=10)
    m, h = 4, 16
    pq = train_pq(data.train, PQConfig(m=m, h=h, seed=0))
    cfg = SLSQConfig(m=m, h=h, niter=3, ilsiter=2, icmiter=2, npert=1,
                     prox_iters=50, S=8 * 16, seed=0)
    R = np.eye(16, dtype=np.float32)
    model = train_lsq_sparse(data.train, pq.B, pq.C_sub, R, cfg)
    # Sparsity bound respected.
    assert model.l0[-1] <= cfg.S
    # Objective finite and decreasing-ish across iterations.
    assert np.isfinite(model.obj).all()
    assert model.obj[-1] <= model.obj[0] * 1.05
    # Codes valid.
    assert model.B.shape == (800, m)
    assert int(jnp.max(model.B)) < h
