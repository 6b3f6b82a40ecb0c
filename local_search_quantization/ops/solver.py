"""Codebook updates: least-squares solves against one-hot code designs.

Given codes B [n, m] and data X [n, d], the codebook update solves

    min_K || A @ K - X ||_F^2,   A = [onehot(B[:,0]) ... onehot(B[:,m-1])]

with A an implicit [n, m*h] one-hot design matrix and K the [m*h, d]
flattened codebooks. The reference solves the d columns independently with
per-dimension LSQR across Julia worker processes
(/root/reference/src/codebook_update.jl:8-86). Here it is recast as ONE
batched dense problem:

- `update_codebooks` (default "cholesky"): form the Gram matrix G = A^T A
  (code co-occurrence counts, built as chunked one-hot matmuls)
  and solve (G + lambda*I) K = A^T X for all d columns at once.
- method "lsqr": a matrix-free batched LSQR (Paige & Saunders) where
  A @ V is an additive reconstruction (gather-sum) and A^T @ U is a
  segment-sum — all columns iterate in lockstep. Kept for numerical parity
  with the reference trajectory.
- `update_codebooks_chain` / `update_codebooks_struct`: structured variants
  where each dimension is only covered by a subset of codebooks
  (codebook_update.jl:88-169); each dimension-group becomes an independent
  (smaller) dense solve, batched with vmap.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.costs import subspace_slices

Array = jax.Array


def code_gram(B: Array, X: Array, h: int, *, chunk: int = 1 << 13,
              pvary_axis: str | None = None):
    """Accumulate G = A^T A [mh, mh] and A^T X [mh, d] in one-hot chunks.

    Runs as a `lax.scan` over n-chunks; the [chunk, m, h] one-hot transient
    stays bounded and both products are matmuls. G is the code
    co-occurrence matrix: block (i, j) counts joint code assignments of
    codebooks i and j.
    """
    n, m = B.shape
    pad = (-n) % chunk
    if pad:
        # Padded rows get an out-of-range code -> all-zero one-hot rows.
        B = jnp.concatenate([B, jnp.full((pad, m), -1, B.dtype)])
        X = jnp.concatenate([X, jnp.zeros((pad, X.shape[1]), X.dtype)])
    Bc = B.reshape(-1, chunk, m)
    Xc = X.reshape(-1, chunk, X.shape[1])

    def step(carry, inp):
        G, AtX = carry
        bc, xc = inp
        onehot = jax.nn.one_hot(bc, h, dtype=jnp.float32)  # [chunk, m, h]
        G = G + jnp.einsum(
            "cih,cjk->ijhk", onehot, onehot, preferred_element_type=jnp.float32
        )
        AtX = AtX + jnp.einsum(
            "cih,cd->ihd",
            onehot,
            xc,
            preferred_element_type=jnp.float32,
            precision="highest",
        )
        return (G, AtX), None

    init = (
        jnp.zeros((m, m, h, h), jnp.float32),
        jnp.zeros((m, h, X.shape[1]), jnp.float32),
    )
    if pvary_axis is not None:
        # Inside shard_map the scan carry must be marked device-varying up
        # front or the carry types won't match (jax >= 0.8 vma typing).
        init = jax.lax.pcast(init, pvary_axis, to="varying")
    (G, AtX), _ = jax.lax.scan(step, init, (Bc, Xc))
    mh = m * h
    G = jnp.moveaxis(G, 2, 1).reshape(mh, mh)
    return G, AtX.reshape(mh, X.shape[1])


@partial(jax.jit, static_argnames=("h", "ridge"))
def _solve_cholesky(B: Array, X: Array, h: int, ridge: float = 1e-4) -> Array:
    m = B.shape[1]
    G, AtX = code_gram(B, X, h)
    # Relative ridge: keeps unused codes at ~0 (LSQR's implicit minimal-norm
    # behavior) and regularizes the rank deficiency inherent to additive
    # codebooks (any constant can shuttle between codebooks).
    lam = ridge * jnp.trace(G) / G.shape[0]
    K = jax.scipy.linalg.solve(
        G + lam * jnp.eye(G.shape[0], dtype=G.dtype), AtX, assume_a="pos"
    )
    return K.reshape(m, h, X.shape[1])


def _A_matvec(V: Array, B: Array) -> Array:
    """A @ V for V [m, h, d] -> [n, d]: additive reconstruction."""
    gathered = jax.vmap(lambda Vi, bi: jnp.take(Vi, bi, axis=0), in_axes=(0, 1))(V, B)
    return jnp.sum(gathered, axis=0)


def _At_matvec(U: Array, B: Array, h: int, *, chunk: int = 1 << 13) -> Array:
    """A^T @ U for U [n, d] -> [m, h, d]: per-codebook one-hot matmuls
    (segment_sum is a scatter with serialized updates). Chunked over n
    exactly like code_gram: the [chunk, m, h] one-hot transient stays
    bounded (~57 MB at m=7, h=256) instead of materializing [n, m, h]
    whole — which, rebuilt every LSQR iteration, cost ~7 GB per matvec at
    n=1e6. fp32 summation order changes only across chunk boundaries
    (accumulator adds), far below the solve's own round-off."""
    n, m = B.shape
    d = U.shape[1]
    pad = (-n) % chunk
    if pad:
        # Out-of-range codes -> all-zero one-hot rows; zero U rows.
        B = jnp.concatenate([B, jnp.full((pad, m), -1, B.dtype)])
        U = jnp.concatenate([U, jnp.zeros((pad, d), U.dtype)])
    Bc = B.reshape(-1, chunk, m)
    Uc = U.reshape(-1, chunk, d)

    def step(acc, inp):
        bc, uc = inp
        oh = jax.nn.one_hot(bc, h, dtype=jnp.float32)  # [chunk, m, h]
        return acc + jnp.einsum(
            "cmh,cd->mhd", oh, uc, preferred_element_type=jnp.float32,
            precision="highest",
        ), None

    acc, _ = jax.lax.scan(step, jnp.zeros((m, h, d), jnp.float32), (Bc, Uc))
    return acc


@partial(jax.jit, static_argnames=("h", "niter"))
def _solve_lsqr(B: Array, X: Array, h: int, niter: int = 32) -> Array:
    """Batched matrix-free LSQR over all d right-hand sides simultaneously.

    Each column follows the textbook Golub-Kahan bidiagonalization with its
    own scalars (alpha/beta/rho...), vectorized as [d]-shaped lanes; the two
    operator applications per iteration are shared-structure gather/segment
    ops over the whole batch. niter=32 reaches the same objective as the
    reference's per-dimension IterativeSolvers.lsqr at default tolerances.
    """
    m = B.shape[1]
    d = X.shape[1]

    def norm(v, axes):
        return jnp.sqrt(jnp.sum(v * v, axis=axes))

    eps = 1e-12
    beta = norm(X, 0)  # [d]
    U = X / jnp.maximum(beta, eps)[None, :]
    V = _At_matvec(U, B, h)  # [m, h, d]
    alpha = norm(V, (0, 1))
    V = V / jnp.maximum(alpha, eps)[None, None, :]
    W = V
    K = jnp.zeros((m, h, d), jnp.float32)
    phibar = beta
    rhobar = alpha

    beta0 = beta  # ||b|| per column, for relative breakdown tolerances
    active = jnp.ones((d,), jnp.bool_)

    def step(state, _):
        U, V, W, K, alpha, beta, phibar, rhobar, active = state
        # Bidiagonalization: beta_{i+1} u_{i+1} = A v_i - alpha_i u_i
        U = _A_matvec(V, B) - alpha[None, :] * U
        beta = norm(U, 0)
        U = U / jnp.maximum(beta, eps)[None, :]
        # alpha_{i+1} v_{i+1} = A^T u_{i+1} - beta_{i+1} v_i
        V = _At_matvec(U, B, h) - beta[None, None, :] * V
        alpha = norm(V, (0, 1))
        V = V / jnp.maximum(alpha, eps)[None, None, :]
        # Orthogonal transformation (Givens) applied to the bidiagonal system.
        rho = jnp.sqrt(rhobar * rhobar + beta * beta)
        c = rhobar / jnp.maximum(rho, eps)
        s = beta / jnp.maximum(rho, eps)
        theta = s * alpha
        rhobar = -c * alpha
        # Convergence freeze: A is always rank-deficient here (each one-hot
        # block of a row sums to 1), so after ~rank(A) steps the step size
        # |phi| decays to round-off and then *regrows* from lost
        # orthogonality, destroying the solution. Once |phi| is negligible
        # the column is converged — freeze it permanently (sticky mask).
        phi = c * phibar
        active = active & (jnp.abs(phi) > 1e-6 * beta0)
        phi = jnp.where(active, phi, 0.0)
        phibar = s * phibar
        K = K + (phi / jnp.maximum(rho, eps))[None, None, :] * W
        W = V - (theta / jnp.maximum(rho, eps))[None, None, :] * W
        return (U, V, W, K, alpha, beta, phibar, rhobar, active), None

    state = (U, V, W, K, alpha, beta, phibar, rhobar, active)
    state, _ = jax.lax.scan(step, state, None, length=niter)
    return state[3]


def update_codebooks(
    X: Array,
    B: Array,
    h: int,
    *,
    method: str = "cholesky",
    ridge: float = 1e-4,
    niter: int = 32,
) -> Array:
    """Full (unstructured) codebook update. Returns C [m, h, d].

    method: "cholesky" (default, normal equations + ridge) or "lsqr".
    "lsmr" is accepted as an ALIAS of "lsqr" (the reference exposes both
    IterativeSolvers backends, codebook_update.jl:17-21; on the
    normal-equations-equivalent krylov space the two differ only in
    stopping heuristics, which the batched solver replaces with a fixed
    niter + sticky convergence freeze).

    (Reference driver: update_codebooks, codebook_update.jl:52-86.)
    """
    if method == "cholesky":
        return _solve_cholesky(B, X, h, ridge)
    if method in ("lsqr", "lsmr"):
        return _solve_lsqr(B, X, h, niter)
    raise ValueError(f"unknown codebook update method: {method!r}")


# ---------------------------------------------------------------------------
# Structured (chain / generic) updates
# ---------------------------------------------------------------------------


def chain_dims(d: int, m: int) -> list[tuple[int, int]]:
    """Dimension span covered by each of m chain codebooks.

    Chain layout (codebook i spans subspaces i-1..i of m-1 subspaces), as
    get_cbdims_chain (codebook_update.jl:88-102).
    """
    sub = subspace_slices(d, m - 1)
    spans = [sub[0]]
    for i in range(1, m - 1):
        spans.append((sub[i - 1][0], sub[i][1]))
    spans.append(sub[-1])
    return spans


@partial(jax.jit, static_argnames=("h", "ds_max", "ridge"))
def _chain_solve(
    B: Array, Xpad: Array, h: int, ds_max: int, ridge: float = 1e-4
) -> Array:
    """Solve the m-1 independent 2-codebook systems of the chain layout.

    Chain structure means each dimension subspace s is covered by exactly the
    codebook pair (s, s+1), so the d-dimensional problem splits into m-1
    dense [2h, 2h] solves — batched with vmap. Xpad: [m-1, n, ds_max]
    (subspace slices zero-padded to equal width).
    """
    n, m = B.shape
    onehot = jax.nn.one_hot(B, h, dtype=jnp.float32)  # [n, m, h]
    counts = jnp.sum(onehot, axis=0)  # [m, h]
    cooc = jnp.einsum(
        "nsh,nsk->shk", onehot[:, :-1], onehot[:, 1:],
        preferred_element_type=jnp.float32,
    )  # [m-1, h, h]

    def solve_one(cnt_a, cnt_b, co, oh_a, oh_b, xs):
        G = jnp.block(
            [[jnp.diag(cnt_a), co], [co.T, jnp.diag(cnt_b)]]
        )  # [2h, 2h]
        AtX = jnp.concatenate(
            [
                jnp.einsum(
                    "nh,nd->hd",
                    oh_a,
                    xs,
                    preferred_element_type=jnp.float32,
                    precision="highest",
                ),
                jnp.einsum(
                    "nh,nd->hd",
                    oh_b,
                    xs,
                    preferred_element_type=jnp.float32,
                    precision="highest",
                ),
            ]
        )  # [2h, ds]
        lam = ridge * jnp.trace(G) / G.shape[0]
        return jax.scipy.linalg.solve(
            G + lam * jnp.eye(G.shape[0], dtype=G.dtype), AtX, assume_a="pos"
        )

    return jax.vmap(solve_one)(
        counts[:-1],
        counts[1:],
        cooc,
        jnp.moveaxis(onehot[:, :-1], 1, 0),
        jnp.moveaxis(onehot[:, 1:], 1, 0),
        Xpad,
    )  # [m-1, 2h, ds_max]


def update_codebooks_chain(
    X: Array, B: Array, h: int, *, ridge: float = 1e-4
) -> Array:
    """Chain-structured codebook update. Returns full-dimensional C [m, h, d].

    (Reference: update_codebooks_chain, codebook_update.jl:161-169.)
    """
    X = jnp.asarray(X)
    n, d = X.shape
    m = B.shape[1]
    sub = subspace_slices(d, m - 1)
    ds_max = max(b - a for a, b in sub)
    Xpad = jnp.stack(
        [
            jnp.pad(X[:, a:b], ((0, 0), (0, ds_max - (b - a))))
            for a, b in sub
        ]
    )  # [m-1, n, ds_max]
    K = _chain_solve(B, Xpad, h, ds_max, ridge)  # [m-1, 2h, ds_max]
    C = np.zeros((m, h, d), np.float32)
    Khost = np.asarray(K)
    for s, (a, b) in enumerate(sub):
        ds = b - a
        C[s, :, a:b] += Khost[s, :h, :ds]
        C[s + 1, :, a:b] += Khost[s, h:, :ds]
    return jnp.asarray(C)


def update_codebooks_struct(
    X: Array,
    B: Array,
    h: int,
    dim2cb: np.ndarray,
    *,
    ridge: float = 1e-4,
) -> Array:
    """Generic structured codebook update: each dimension is covered by an
    arbitrary subset of codebooks.

    dim2cb: [d, m] bool — dim2cb[dim, i] iff codebook i spans dimension
    `dim` (the reference's dim2C map; update_codebooks_generic,
    codebook_update.jl:119-158). Dimensions sharing a coverage pattern are
    grouped and each group gets one restricted dense normal-equation solve.
    Returns full-dimensional C [m, h, d] (zero outside each codebook's span).
    """
    X = jnp.asarray(X)
    n, d = X.shape
    m = B.shape[1]
    dim2cb = np.asarray(dim2cb, bool)
    assert dim2cb.shape == (d, m), (dim2cb.shape, (d, m))

    # Group dims by identical coverage pattern (few groups in practice).
    patterns: dict[tuple, list[int]] = {}
    for dim in range(d):
        patterns.setdefault(tuple(dim2cb[dim]), []).append(dim)

    G_full, AtX_full = code_gram(B, X, h)  # [mh, mh], [mh, d]
    C = np.zeros((m, h, d), np.float32)
    for pat, dims in patterns.items():
        active = [i for i in range(m) if pat[i]]
        if not active:
            continue
        cols = np.concatenate([np.arange(i * h, (i + 1) * h) for i in active])
        G = jnp.asarray(np.asarray(G_full)[np.ix_(cols, cols)])
        AtX = jnp.asarray(np.asarray(AtX_full)[cols][:, dims])
        lam = ridge * jnp.trace(G) / G.shape[0]
        K = jax.scipy.linalg.solve(
            G + lam * jnp.eye(G.shape[0], dtype=G.dtype), AtX, assume_a="pos"
        )  # [|active|*h, |dims|]
        Khost = np.asarray(K).reshape(len(active), h, len(dims))
        for ai, i in enumerate(active):
            C[i, :, dims] += Khost[ai].T
    return jnp.asarray(C)
