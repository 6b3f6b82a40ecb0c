"""Batched k-means (Lloyd's) with k-means++ init, built on matmuls.

Replaces the reference's dependency on Clustering.jl `kmeans` plus its own
assignment/center kernels (/root/reference/src/opq/kmeans.jl:6-123,
/root/reference/src/pq/PQ.jl:59). Distances are computed as
||x||^2 - 2 x.c + ||c||^2 with the cross term a matmul; assignment/update
are whole-batch argmin + segment-sum. `vmap` over the leading axis trains all
m subspace codebooks of PQ simultaneously.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class KMeansResult(NamedTuple):
    centers: Array  # [k, d]
    assignments: Array  # [n] int32
    cost: Array  # scalar: mean squared distance
    iterations: Array  # scalar int32: Lloyd iterations executed


def sq_distances(X: Array, centers: Array, *, precision="highest") -> Array:
    """Pairwise squared Euclidean distances: [n, k]."""
    cross = jnp.einsum(
        "nd,kd->nk", X, centers, preferred_element_type=jnp.float32, precision=precision
    )
    xsq = jnp.sum(X * X, axis=-1, dtype=jnp.float32)
    csq = jnp.sum(centers * centers, axis=-1, dtype=jnp.float32)
    return xsq[:, None] - 2.0 * cross + csq[None, :]


def assign(X: Array, centers: Array) -> tuple[Array, Array]:
    """Nearest-center assignment. Returns ([n] int32 labels, [n] costs)."""
    d2 = sq_distances(X, centers)
    labels = jnp.argmin(d2, axis=-1).astype(jnp.int32)
    costs = jnp.take_along_axis(d2, labels[:, None], axis=-1)[:, 0]
    return labels, costs


def _update_centers(X: Array, labels: Array, k: int) -> tuple[Array, Array]:
    """Mean of assigned points per center. Returns (centers, counts).

    The per-center sum is the matmul onehot(labels)^T @ X rather than a
    scatter (segment_sum), whose serialized updates dominated paper-scale
    PQ training.
    """
    oh = jax.nn.one_hot(labels, k, dtype=jnp.float32)  # [n, k], exact
    onehot_sum = jnp.einsum(
        "nk,nd->kd", oh, X, preferred_element_type=jnp.float32,
        precision="highest",
    )
    counts = jnp.sum(oh, axis=0)
    safe = jnp.maximum(counts, 1.0)
    return onehot_sum / safe[:, None], counts


def kmeans_pp_init(key: Array, X: Array, k: int) -> Array:
    """k-means++ seeding (D^2 sampling), as Clustering.jl's `:kmpp` init.

    Runs as a `lax.scan` over k steps with an [n] min-distance carry; each step
    is one distance row + a categorical draw — O(n*d) per step, fully batched.
    """
    n = X.shape[0]
    key0, key_scan = jax.random.split(key)
    first = jax.random.randint(key0, (), 0, n)
    c0 = X[first]
    mind = jnp.sum((X - c0[None, :]) ** 2, axis=-1)

    def step(carry, key_i):
        mind, _ = carry

        # Sample proportionally to D^2 (guard the all-zero corner case).
        total = jnp.sum(mind)
        probs = jnp.where(total > 0, mind / jnp.maximum(total, 1e-30), 1.0 / n)
        idx = jax.random.choice(key_i, n, p=probs)
        c = X[idx]
        d2 = jnp.sum((X - c[None, :]) ** 2, axis=-1)
        return (jnp.minimum(mind, d2), c), c

    keys = jax.random.split(key_scan, k - 1)
    (_, _), centers_rest = jax.lax.scan(step, (mind, c0), keys)
    return jnp.concatenate([c0[None], centers_rest], axis=0)


@partial(jax.jit, static_argnames=("k", "maxiter", "tol"))
def kmeans(
    key: Array,
    X: Array,
    k: int,
    *,
    maxiter: int = 100,
    tol: float = 1e-6,
) -> KMeansResult:
    """Full Lloyd's k-means with k-means++ init and empty-cluster repair.

    Empty clusters are re-seeded at the currently worst-represented points
    (highest assignment cost), the standard repair also performed by
    Clustering.jl when a center loses all members. Convergence: stop when the
    objective improves by less than `tol` (relative), via `lax.while_loop`
    with a `maxiter` bound — compiled once, no dynamic shapes.
    """
    n = X.shape[0]
    centers0 = kmeans_pp_init(key, X, k)

    def repair(centers: Array, counts: Array, costs: Array) -> Array:
        # Re-seed empty centers at the top-|empty| highest-cost points.
        _, worst = jax.lax.top_k(costs, k)  # [k] candidate replacement points
        empty = counts == 0.0
        # rank of each empty slot among empties: 0,1,2,...
        rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
        repl = X[worst[jnp.clip(rank, 0, k - 1)]]
        return jnp.where(empty[:, None], repl, centers)

    def cond(state):
        _, _, _, prev_cost, cost, it = state
        # Multiplicative form of (prev-cost)/prev > tol: division by the
        # float32-max sentinel computes a subnormal reciprocal that a
        # flush-to-zero device turns into zero, silently ending the loop at
        # iteration 0.
        improved = (prev_cost - cost) > tol * prev_cost
        return jnp.logical_and(it < maxiter, improved)

    def body(state):
        centers, labels, costs, _, cost, it = state
        # M-step from the carried assignment, then one E-step (one distance
        # matmul per Lloyd iteration).
        new_centers, counts = _update_centers(X, labels, k)
        new_centers = repair(new_centers, counts, costs)
        new_labels, new_costs = assign(X, new_centers)
        return (new_centers, new_labels, new_costs, cost, jnp.mean(new_costs), it + 1)

    labels0, costs0 = assign(X, centers0)
    # prev_cost must be finite: (inf - cost)/inf is NaN and would end the
    # loop before the first Lloyd step.
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    init = (centers0, labels0, costs0, big, jnp.mean(costs0), jnp.int32(0))
    centers, labels, costs, _, cost, it = jax.lax.while_loop(cond, body, init)
    return KMeansResult(centers, labels, cost, it)


def kmeans_batched(
    key: Array, Xs: Array, k: int, *, maxiter: int = 100, tol: float = 1e-6
):
    """vmapped k-means over a leading batch axis: Xs is [m, n, ds].

    Trains all m subspace codebooks of PQ in one compiled program
    (the reference loops codebooks serially, /root/reference/src/pq/PQ.jl:57-72).
    """
    keys = jax.random.split(key, Xs.shape[0])
    return jax.vmap(lambda kk, xx: kmeans(kk, xx, k, maxiter=maxiter, tol=tol))(
        keys, Xs
    )
