"""ICM/ILS encoder invariants and oracle checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.ops import costs, icm, luts


def brute_force_best_code(X, C, j, B):
    """Oracle: exhaustive best code for codebook j given other codes fixed."""
    n, m = B.shape
    h = C.shape[1]
    best = np.zeros(n, np.int32)
    for nn in range(n):
        costs_ = np.zeros(h)
        for c in range(h):
            Bc = B[nn].copy()
            Bc[j] = c
            recon = sum(C[i, Bc[i]] for i in range(m))
            costs_[c] = np.sum((X[nn] - recon) ** 2)
        best[nn] = np.argmin(costs_)
    return best


def test_single_sweep_matches_exhaustive_conditional(rng):
    """One ICM visit of codebook j must produce the exhaustive conditional
    argmin (ICM's defining property)."""
    n, d, m, h = 12, 6, 3, 5
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)

    unaries = luts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    binaries = luts.get_binaries(jnp.asarray(C))
    for j in range(m):
        order = jnp.asarray([j], jnp.int32)
        B_new = np.asarray(
            icm.icm_sweeps(jnp.asarray(B), unaries, binaries, order, 1)
        )
        expect = brute_force_best_code(X, C, j, B)
        np.testing.assert_array_equal(B_new[:, j], expect)
        # Other codebooks untouched.
        others = [i for i in range(m) if i != j]
        np.testing.assert_array_equal(B_new[:, others], B[:, others])


def test_icm_never_increases_cost(rng):
    n, d, m, h = 64, 8, 4, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    unaries = luts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    binaries = luts.get_binaries(jnp.asarray(C))
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B), jnp.asarray(C)))
    order = jnp.arange(m, dtype=jnp.int32)
    B1 = icm.icm_sweeps(jnp.asarray(B), unaries, binaries, order, 4)
    cost1 = np.asarray(costs.veccost(jnp.asarray(X), B1, jnp.asarray(C)))
    # Pure ICM (no perturbation) is a coordinate descent: per-vector monotone.
    assert (cost1 <= cost0 + 1e-3).all()


def test_perturb_codes_properties(rng):
    n, m, h, npert = 200, 7, 16, 4
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Bp = np.asarray(
        icm.perturb_codes(jax.random.PRNGKey(0), jnp.asarray(B), npert, h)
    )
    changed = (Bp != B).sum(axis=1)
    # At most npert entries change per vector (a perturbed entry may draw its
    # old value), and codes stay in range.
    assert (changed <= npert).all()
    assert Bp.min() >= 0 and Bp.max() < h
    assert changed.mean() > npert * 0.5  # most perturbations actually change


def test_ils_encode_accept_if_better_invariant(rng):
    """The ILS accept step guarantees per-vector non-increasing cost — the
    invariant the reference prints as '% better' (encode_icm.jl:177-186)."""
    n, d, m, h = 128, 16, 4, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32) * 0.3
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))
    res = icm.ils_encode(
        jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C),
        ilsiter=4, icmiter=2, npert=2,
    )
    newcost = np.asarray(
        costs.veccost(jnp.asarray(X), res.B, jnp.asarray(C))
    )
    assert (newcost <= cost0 + 1e-3).all()
    np.testing.assert_allclose(np.asarray(res.cost), newcost, rtol=1e-4, atol=1e-3)
    # And it actually improves on average.
    assert newcost.mean() < cost0.mean()


def test_encode_chunked_matches_unchunked_shapes(rng):
    n, d, m, h = 300, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = rng.normal(size=(m, h, d)).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    res = icm.encode_chunked(
        jax.random.PRNGKey(0), X, B0, jnp.asarray(C),
        ilsiter=2, icmiter=2, npert=1, chunk=128,
    )
    assert res.B.shape == (n, m)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))
    assert (res.cost <= cost0 + 1e-3).all()


def test_encode_chunked_milestones_and_stats_stitching(rng):
    """Milestones stitched across chunk boundaries (incl. the padded tail
    chunk) keep the per-vector invariants: every milestone <= cost(B0),
    non-increasing across milestones, final == last milestone; stats
    weighting yields fractions in [0, 1]."""
    n, d, m, h = 300, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))
    tr = icm.encode_chunked(
        jax.random.PRNGKey(4), X, B0, jnp.asarray(C),
        ilsiter=3, icmiter=2, npert=1, chunk=128,
        milestones=(1, 3), with_stats=True,
    )
    msc = np.asarray(tr.milestone_cost)
    assert msc.shape == (2, n)
    assert (msc[0] <= cost0 + 1e-3).all()
    assert (msc[1] <= msc[0]).all()
    np.testing.assert_array_equal(np.asarray(tr.B), np.asarray(tr.milestone_B[1]))
    for f in (tr.frac_better, tr.frac_equal):
        f = np.asarray(f)
        assert f.shape == (3,) and (f >= 0).all() and (f <= 1).all()


def test_condition_matmul_matches_gather_exactly_on_small_ints(rng):
    """bf16 one-hot matmul conditioning == gather conditioning when all LUT
    values are small integers (exactly representable in bf16)."""
    import jax.numpy as jnp
    from local_search_quantization.ops.icm import _condition, _condition_matmul

    n, d, m, h = 32, 6, 4, 8
    C = rng.integers(-2, 3, size=(m, h, d)).astype(np.float32)
    X = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    unaries = luts.get_unaries(jnp.asarray(X), jnp.asarray(C))
    binaries = luts.get_binaries(jnp.asarray(C))
    for j in range(m):
        a = np.asarray(
            _condition(unaries[:, j, :], binaries[:, j], jnp.asarray(B), jnp.int32(j))
        )
        b = np.asarray(
            _condition_matmul(
                unaries[:, j, :], binaries[:, j], jnp.asarray(B), jnp.int32(j)
            )
        )
        np.testing.assert_array_equal(a, b)


def test_ils_encode_matmul_mode_invariants(rng):
    n, d, m, h = 128, 16, 4, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.3).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))
    res = icm.ils_encode(
        jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C),
        ilsiter=4, icmiter=2, npert=2, condition_mode="matmul",
    )
    newcost = np.asarray(costs.veccost(jnp.asarray(X), res.B, jnp.asarray(C)))
    assert (newcost <= cost0 + 1e-3).all()
    assert newcost.mean() < cost0.mean()


def test_ils_milestones_and_stats(rng):
    """milestones=(2,4) from ONE run: per-vector non-increasing costs across
    milestones, final == last milestone, stats in range, in both
    conditioning modes.
    (Reference: ilsiters vector API, encode_icm_cuda.jl:26,211-222; accept
    stats prints, encode_icm.jl:181-184.)"""
    n, d, m, h = 128, 16, 4, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.3).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))

    for mode in ("gather", "matmul"):
        tr = icm.ils_encode(
            jax.random.PRNGKey(3), jnp.asarray(X), jnp.asarray(B0),
            jnp.asarray(C), ilsiter=4, icmiter=2, npert=1,
            condition_mode=mode, milestones=[2, 4],  # list: wrapper coerces
            with_stats=True,
        )
        assert isinstance(tr, icm.ILSTrace)
        msc = np.asarray(tr.milestone_cost)  # [2, n]
        assert (msc[0] <= cost0 + 1e-3).all(), mode
        # Milestones are chained to the running exact-fp32 best, so the
        # per-vector non-increase holds EXACTLY (no epsilon slack).
        assert (msc[1] <= msc[0]).all(), mode
        # Milestone cost must be the exact cost of the milestone codes.
        for s in range(2):
            exact = np.asarray(
                costs.veccost(jnp.asarray(X), tr.milestone_B[s], jnp.asarray(C))
            )
            np.testing.assert_allclose(msc[s], exact, rtol=1e-4, atol=1e-3)
        # Final result == last milestone (milestone 4 == ilsiter 4).
        np.testing.assert_array_equal(
            np.asarray(tr.B), np.asarray(tr.milestone_B[1])
        )
        fb, fc = np.asarray(tr.frac_better), np.asarray(tr.frac_equal)
        assert fb.shape == (4,) and fc.shape == (4,)
        assert (fb >= 0).all() and (fb <= 1).all()
        assert (fc >= 0).all() and (fc <= 1).all()
        assert fb.max() > 0  # something improved in 4 rounds


def test_ils_encode_fuzz_shapes(rng):
    """Randomized (m, h, d, n) sweep: both conditioning modes must uphold
    the accept-if-better contract at arbitrary shapes (insurance against
    the reference's hard-coded-shape failure mode, cudautils.cu:58,93-95)."""
    for it in range(6):
        mode = ("gather", "matmul")[it % 2]
        m = int(rng.integers(2, 9))
        h = int(rng.integers(3, 40))
        d = int(rng.integers(4, 33))
        n = int(rng.integers(5, 150))
        X = rng.normal(size=(n, d)).astype(np.float32)
        C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
        B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
        cost0 = np.asarray(
            costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C))
        )
        res = icm.ils_encode(
            jax.random.PRNGKey(n), jnp.asarray(X), jnp.asarray(B0),
            jnp.asarray(C), ilsiter=2, icmiter=1, npert=1,
            condition_mode=mode,
        )
        B = np.asarray(res.B)
        assert B.min() >= 0 and B.max() < h, (m, h, d, n)
        newcost = np.asarray(
            costs.veccost(jnp.asarray(X), res.B, jnp.asarray(C))
        )
        assert (newcost <= cost0 + 1e-3).all(), (m, h, d, n)



@pytest.mark.parametrize("mode", ["gather", "matmul"])
def test_ils_encode_odd_h(rng, mode):
    """h off the power-of-two grid (64, 20) encodes in both conditioning
    modes: codes stay in range, accept-if-better holds, cost improves."""
    for h in (64, 20):
        n, d, m = 96, 16, 4
        X = rng.normal(size=(n, d)).astype(np.float32)
        C = (rng.normal(size=(m, h, d)) * 0.3).astype(np.float32)
        B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
        cost0 = np.asarray(
            costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C))
        )
        res = icm.ils_encode(
            jax.random.PRNGKey(2), jnp.asarray(X), jnp.asarray(B0),
            jnp.asarray(C), ilsiter=2, icmiter=2, npert=1,
            condition_mode=mode,
        )
        B = np.asarray(res.B)
        assert B.min() >= 0 and B.max() < h
        newcost = np.asarray(costs.veccost(jnp.asarray(X), res.B, jnp.asarray(C)))
        assert (newcost <= cost0 + 1e-3).all()
        assert newcost.mean() < cost0.mean()
