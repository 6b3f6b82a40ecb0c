"""Viterbi encoder vs exhaustive search; codebook solvers vs lstsq oracle."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops import costs, solver, viterbi


def chain_cost(x, C, codes):
    recon = sum(C[i, codes[i]] for i in range(len(codes)))
    return np.sum((x - recon) ** 2)


def test_viterbi_matches_exhaustive(rng):
    """Viterbi must return the exact chain optimum (m=3, h=4: 64 combos)."""
    n, d, m, h = 10, 5, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    # Chain codebooks: only adjacent interactions matter, which holds for ANY
    # codebooks only if non-adjacent products vanish — instead build truly
    # chain-structured codebooks via overlapping dimension spans.
    C = np.zeros((m, h, d), np.float32)
    spans = [(0, 3), (1, 4), (3, 5)]  # codebook i overlaps only i+-1
    for i, (a, b) in enumerate(spans):
        C[i, :, a:b] = rng.normal(size=(h, b - a))
    B = np.asarray(viterbi.viterbi_encode(jnp.asarray(X), jnp.asarray(C), block=4))
    for nn in range(n):
        best = min(
            itertools.product(range(h), repeat=m),
            key=lambda codes: chain_cost(X[nn], C, codes),
        )
        got = chain_cost(X[nn], C, B[nn])
        want = chain_cost(X[nn], C, np.asarray(best))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_viterbi_beats_greedy(rng):
    n, d, m, h = 50, 8, 4, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B = viterbi.viterbi_encode(jnp.asarray(X), jnp.asarray(C), block=16)
    assert B.shape == (n, m)
    assert np.asarray(B).min() >= 0 and np.asarray(B).max() < h


def dense_design(B, h):
    n, m = B.shape
    A = np.zeros((n, m * h), np.float32)
    for i in range(m):
        A[np.arange(n), i * h + B[:, i]] = 1.0
    return A


def test_update_codebooks_cholesky_vs_lstsq(rng):
    n, d, m, h = 400, 6, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C = np.asarray(solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h))
    A = dense_design(B, h)
    K, *_ = np.linalg.lstsq(A, X, rcond=None)
    # Compare at the level of achieved residual (the solution itself is not
    # unique: codes' one-hot blocks each sum to 1, a rank deficiency).
    r_ours = np.linalg.norm(A @ C.reshape(m * h, d) - X)
    r_np = np.linalg.norm(A @ K - X)
    np.testing.assert_allclose(r_ours, r_np, rtol=1e-3)


def test_update_codebooks_lsqr_vs_lstsq(rng):
    n, d, m, h = 300, 5, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C = np.asarray(
        solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h, method="lsqr")
    )
    A = dense_design(B, h)
    K, *_ = np.linalg.lstsq(A, X, rcond=None)
    r_ours = np.linalg.norm(A @ C.reshape(m * h, d) - X)
    r_np = np.linalg.norm(A @ K - X)
    np.testing.assert_allclose(r_ours, r_np, rtol=1e-3)


def test_update_codebooks_unused_code_stays_small(rng):
    n, d, m, h = 200, 4, 2, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h - 2, size=(n, m), dtype=np.int32)  # codes h-2, h-1 unused
    C = np.asarray(solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h))
    assert np.abs(C[:, -2:, :]).max() < 1e-3


def test_chain_update_reduces_error(rng):
    n, d, m, h = 500, 12, 4, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Crand = (rng.normal(size=(m, h, d)) * 0.2).astype(np.float32)
    e0 = float(costs.qerror(jnp.asarray(X), jnp.asarray(B), jnp.asarray(Crand)))
    C = solver.update_codebooks_chain(jnp.asarray(X), jnp.asarray(B), h)
    e1 = float(costs.qerror(jnp.asarray(X), jnp.asarray(B), C))
    assert e1 < e0
    # Chain codebooks are zero outside their dimension span.
    spans = solver.chain_dims(d, m)
    Cn = np.asarray(C)
    for i, (a, b) in enumerate(spans):
        outside = np.concatenate([Cn[i, :, :a], Cn[i, :, b:]], axis=1)
        assert np.abs(outside).max() < 1e-5


def test_chain_update_is_optimal_for_chain_design(rng):
    """Against the dense lstsq restricted to the chain sparsity pattern."""
    n, d, m, h = 300, 8, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C = np.asarray(solver.update_codebooks_chain(jnp.asarray(X), jnp.asarray(B), h))
    # Reference behavior: per dim, restrict to covering codebooks and solve.
    spans = solver.chain_dims(d, m)
    A = dense_design(B, h)
    resid_ours = 0.0
    resid_opt = 0.0
    for dim in range(d):
        active = [i for i, (a, b) in enumerate(spans) if a <= dim < b]
        cols = np.concatenate([np.arange(i * h, (i + 1) * h) for i in active])
        K, *_ = np.linalg.lstsq(A[:, cols], X[:, dim], rcond=None)
        resid_opt += np.sum((A[:, cols] @ K - X[:, dim]) ** 2)
        resid_ours += np.sum(
            (A @ C.reshape(m * h, d)[:, dim] - X[:, dim]) ** 2
        )
    np.testing.assert_allclose(resid_ours, resid_opt, rtol=1e-3)


def test_update_codebooks_struct_generic(rng):
    """Generic structured solver: chain pattern must match the chain solver's
    achieved residual; full pattern must match the unstructured solver."""
    n, d, m, h = 300, 8, 3, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)

    # Chain coverage pattern.
    dim2cb = np.zeros((d, m), bool)
    for i, (a, b) in enumerate(solver.chain_dims(d, m)):
        dim2cb[a:b, i] = True
    Cg = np.asarray(
        solver.update_codebooks_struct(jnp.asarray(X), jnp.asarray(B), h, dim2cb)
    )
    Cc = np.asarray(solver.update_codebooks_chain(jnp.asarray(X), jnp.asarray(B), h))
    A = dense_design(B, h)
    r_g = np.linalg.norm(A @ Cg.reshape(m * h, d) - X)
    r_c = np.linalg.norm(A @ Cc.reshape(m * h, d) - X)
    np.testing.assert_allclose(r_g, r_c, rtol=1e-3)
    # Zero outside spans.
    for i in range(m):
        outside = ~dim2cb[:, i]
        if outside.any():
            assert np.abs(Cg[i, :, outside]).max() < 1e-6

    # Full coverage == unstructured solve.
    Cfull = np.asarray(
        solver.update_codebooks_struct(
            jnp.asarray(X), jnp.asarray(B), h, np.ones((d, m), bool)
        )
    )
    Cu = np.asarray(solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h))
    r_full = np.linalg.norm(A @ Cfull.reshape(m * h, d) - X)
    r_u = np.linalg.norm(A @ Cu.reshape(m * h, d) - X)
    np.testing.assert_allclose(r_full, r_u, rtol=1e-3)


def test_update_codebooks_struct_irregular_vs_lstsq(rng):
    """Genuinely irregular coverage (overlapping 3-codebook spans, a
    single-codebook dim, an all-codebooks dim — NOT expressible as the
    chain pattern) against a per-dimension restricted lstsq oracle, the
    reference's update_codebooks_generic semantics
    (codebook_update.jl:119-158)."""
    n, d, m, h = 400, 7, 4, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)

    dim2cb = np.zeros((d, m), bool)
    dim2cb[0, [0, 1, 2]] = True   # 3-codebook overlap
    dim2cb[1, [0, 1, 2]] = True   # same pattern, grouped with dim 0
    dim2cb[2, [1, 2, 3]] = True   # different 3-codebook overlap
    dim2cb[3, 3] = True           # single codebook
    dim2cb[4, :] = True           # all codebooks
    dim2cb[5, [0, 3]] = True      # non-adjacent pair
    dim2cb[6, [0, 3]] = True
    Cg = np.asarray(
        solver.update_codebooks_struct(jnp.asarray(X), jnp.asarray(B), h, dim2cb)
    )

    A = dense_design(B, h)
    for dim in range(d):
        active = np.flatnonzero(dim2cb[dim])
        cols = np.concatenate([np.arange(i * h, (i + 1) * h) for i in active])
        K, *_ = np.linalg.lstsq(A[:, cols], X[:, dim], rcond=None)
        r_opt = np.sum((A[:, cols] @ K - X[:, dim]) ** 2)
        r_ours = np.sum((A @ Cg.reshape(m * h, d)[:, dim] - X[:, dim]) ** 2)
        # Residual parity per dimension (solutions are non-unique; the
        # ridge keeps ours within a hair of the exact minimum).
        np.testing.assert_allclose(r_ours, r_opt, rtol=2e-3, atol=1e-4)
        # Zero outside the covering set.
        inactive = [i for i in range(m) if i not in active]
        for i in inactive:
            assert np.abs(Cg[i, :, dim]).max() < 1e-6
