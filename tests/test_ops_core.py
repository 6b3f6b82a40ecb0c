"""Unit oracles for the shared math kernels (SURVEY.md §4: test each kernel
against tiny brute-force NumPy references)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.ops import costs, luts, subspaces


def make_problem(rng, n=50, d=12, m=4, h=8):
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    return X, C, B


def test_unaries_oracle(rng):
    X, C, B = make_problem(rng)
    u = np.asarray(luts.get_unaries(jnp.asarray(X), jnp.asarray(C)))
    n, m, h = u.shape
    for nn in range(0, n, 7):
        for i in range(m):
            for k in range(h):
                expect = np.sum(C[i, k] ** 2) - 2 * np.dot(X[nn], C[i, k])
                np.testing.assert_allclose(u[nn, i, k], expect, rtol=1e-4, atol=1e-4)


def test_binaries_oracle(rng):
    X, C, B = make_problem(rng)
    b = np.asarray(luts.get_binaries(jnp.asarray(C)))
    m, _, h, _ = b.shape
    for i in range(m):
        for j in range(m):
            np.testing.assert_allclose(
                b[i, j], 2.0 * C[i] @ C[j].T, rtol=1e-4, atol=1e-4
            )
    # Symmetric-transpose structure.
    np.testing.assert_allclose(b[1, 2], b[2, 1].T, rtol=1e-5)


def test_chain_binaries(rng):
    _, C, _ = make_problem(rng)
    cb = np.asarray(luts.get_chain_binaries(jnp.asarray(C)))
    for i in range(C.shape[0] - 1):
        np.testing.assert_allclose(cb[i], 2.0 * C[i] @ C[i + 1].T, rtol=1e-4)


def test_reconstruct_veccost_qerror(rng):
    X, C, B = make_problem(rng)
    CB = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    expect = np.zeros_like(X)
    for i in range(B.shape[1]):
        expect += C[i, B[:, i]]
    np.testing.assert_allclose(CB, expect, rtol=1e-5, atol=1e-5)

    vc = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B), jnp.asarray(C)))
    np.testing.assert_allclose(vc, np.sum((expect - X) ** 2, axis=1), rtol=1e-4)

    qe = float(costs.qerror(jnp.asarray(X), jnp.asarray(B), jnp.asarray(C)))
    np.testing.assert_allclose(qe, np.mean(np.sum((expect - X) ** 2, axis=1)), rtol=1e-4)


def test_unary_binary_decomposition(rng):
    """veccost == ||x||^2 + unary terms + pairwise terms (the MRF identity
    ICM relies on)."""
    X, C, B = make_problem(rng, n=20)
    u = np.asarray(luts.get_unaries(jnp.asarray(X), jnp.asarray(C)))
    bb = np.asarray(luts.get_binaries(jnp.asarray(C)))
    vc = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B), jnp.asarray(C)))
    n, m = B.shape
    for nn in range(n):
        total = float(np.sum(X[nn] ** 2))
        for i in range(m):
            total += u[nn, i, B[nn, i]]
        for i in range(m):
            for j in range(i + 1, m):
                total += bb[i, j, B[nn, i], B[nn, j]]
        np.testing.assert_allclose(vc[nn], total, rtol=1e-3, atol=1e-3)


def test_subspace_slices():
    # d=128, m=7: first 128%7=2 parts get one extra dim (sizes 19,19,18,...).
    s = costs.subspace_slices(128, 7)
    sizes = [b - a for a, b in s]
    assert sizes == [19, 19, 18, 18, 18, 18, 18]
    assert s[0] == (0, 19) and s[-1] == (110, 128)
    assert costs.subspace_slices(128, 8) == [(i * 16, (i + 1) * 16) for i in range(8)]


def test_split_merge_roundtrip(rng):
    X = rng.normal(size=(10, 128)).astype(np.float32)
    for m in (7, 8):
        blocks = subspaces.split_subspaces(jnp.asarray(X), m)
        assert blocks.shape[0] == m
        back = np.asarray(subspaces.merge_subspaces(blocks, 128))
        np.testing.assert_array_equal(back, X)


def test_pq_full_codebooks(rng):
    d, m, h = 20, 3, 4
    w = subspaces.padded_width(d, m)
    C_sub = rng.normal(size=(m, h, w)).astype(np.float32)
    B = rng.integers(0, h, size=(15, m), dtype=np.int32)
    X = rng.normal(size=(15, d)).astype(np.float32)
    Cfull = subspaces.pq_full_codebooks(jnp.asarray(C_sub), d)
    # Reconstruction via full-dim gathers must match the padded PQ one.
    r1 = np.asarray(costs.reconstruct(jnp.asarray(B), Cfull))
    r2 = np.asarray(subspaces.reconstruct_pq(jnp.asarray(B), jnp.asarray(C_sub), d))
    np.testing.assert_allclose(r1, r2, rtol=1e-5, atol=1e-6)
    # And qerror_pq == qerror on the lifted codebooks.
    np.testing.assert_allclose(
        float(subspaces.qerror_pq(X, B, C_sub)),
        float(costs.qerror(jnp.asarray(X), jnp.asarray(B), Cfull)),
        rtol=1e-4,
    )
