"""L1-constrained least squares for sparse codebooks (FISTA + L1-ball projection).

JAX replacement for the reference's MATLAB/SPGL1 bridge
(/root/reference/src/codebook_update_sparse.jl:10-75, matlab/sparse_lsq_fun.m):
solve

    min_K 0.5 || A @ K - X ||_F^2   s.t.  ||K||_1 <= tau

where A is the implicit [n, m*h] one-hot code design. The solver is FISTA
with projection onto the L1 ball; the projection is the sort+threshold
algorithm (Duchi et al. 2008) — a single jnp.sort over the flattened
codebooks, no data-dependent control flow. The operator applications reuse the
gather-sum / segment-sum pair from the LSQR solver.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from local_search_quantization.ops.solver import _A_matvec, _At_matvec

Array = jax.Array


def project_l1_ball(K: Array, tau: Array) -> Array:
    """Euclidean projection of K (any shape) onto {||K||_1 <= tau}."""
    shape = K.shape
    v = jnp.abs(K.reshape(-1))
    total = jnp.sum(v)

    def _project(_):
        u = jnp.sort(v)[::-1]
        cssv = jnp.cumsum(u) - tau
        idx = jnp.arange(1, u.shape[0] + 1, dtype=v.dtype)
        cond = u * idx > cssv
        rho = jnp.sum(cond) - 1
        theta = jnp.maximum(cssv[rho] / (rho + 1.0), 0.0)
        w = jnp.maximum(v - theta, 0.0)
        return (jnp.sign(K.reshape(-1)) * w).reshape(shape)

    return jax.lax.cond(total <= tau, lambda _: K, _project, None)


def estimate_lipschitz(B: Array, h: int, iters: int = 12) -> Array:
    """Power iteration on A^T A for the FISTA step size (L = lambda_max)."""
    m = B.shape[1]
    v = jnp.ones((m, h, 1), jnp.float32)

    def step(v, _):
        v = v / jnp.maximum(jnp.sqrt(jnp.sum(v * v)), 1e-30)
        w = _At_matvec(_A_matvec(v, B), B, h)
        return w, jnp.sqrt(jnp.sum(w * w))

    v, norms = jax.lax.scan(step, v, None, length=iters)
    return norms[-1]


@partial(jax.jit, static_argnames=("h", "iters"))
def solve_l1_constrained(
    B: Array,
    X: Array,
    h: int,
    tau: Array,
    K0: Array,
    *,
    iters: int = 100,
    lr: float | None = None,
) -> Array:
    """FISTA for the tau-constrained LS problem, warm-started at K0 [m, h, d].

    lr: explicit step size; None uses 1/L with L estimated from the code
    co-occurrence counts (the safe default).
    (The reference warm-starts SPGL1 at the previous codebooks and retries
    cold on failure, codebook_update_sparse.jl:54-59; FISTA has no failure
    mode to retry.)
    """
    if lr is None:
        L = estimate_lipschitz(B, h)
        step = 1.0 / jnp.maximum(L, 1e-12)
    else:
        step = jnp.float32(lr)
    K0 = project_l1_ball(K0, tau)

    def body(carry, _):
        K, Y, t = carry
        grad = _At_matvec(_A_matvec(Y, B) - X, B, h)
        K_new = project_l1_ball(Y - step * grad, tau)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        Y_new = K_new + ((t - 1.0) / t_new) * (K_new - K)
        return (K_new, Y_new, t_new), None

    (K, _, _), _ = jax.lax.scan(body, (K0, K0, jnp.float32(1.0)), None, length=iters)
    return K


def threshold_top_s(K: Array, S: int) -> Array:
    """Keep the S largest-|.| entries of K, zero the rest.

    (Reference: update_codebooks_spgl1_threshold, codebook_update_sparse.jl:
    96-104.)
    """
    flat = jnp.abs(K.reshape(-1))
    if S >= flat.shape[0]:
        return K
    cutoff = jnp.sort(flat)[-S]
    return jnp.where(jnp.abs(K) >= cutoff, K, 0.0)
