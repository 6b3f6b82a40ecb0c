"""Norm quantization for the additive-code query path.

LSQ's scanner needs ||reconstruction||^2 per database vector; these are
k-means-quantized into an h-entry norm codebook so each vector spends one
extra byte (the reference's "m=7 codebooks + 1 norm byte = 64 bits" layout,
/root/reference/src/lsq/LSQ.jl:69-85, src/utils.jl:6-31).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.costs import reconstruct

Array = jax.Array


def reconstruction_sqnorms(B: Array, C: Array) -> Array:
    """||sum_i C[i, B[:, i]]||^2 per vector: [n] float32."""
    CB = reconstruct(B, C)
    return jnp.sum(CB * CB, axis=-1)


def scalar_kmeans(vals: np.ndarray, h: int, iters: int = 200) -> np.ndarray:
    """1-D Lloyd's in f64 on the host: [h] float64 centers, ascending.

    A 256-entry scalar codebook is a one-shot training step, so it runs
    in f64 numpy rather than through the batched device k-means: (a) squared
    norms sit at ~1e5 for SIFT-scale data, and the general kernel's
    expanded distance form (kmeans.py:29-36) squares them to ~6e10 where
    one f32 ulp is ~4096 — bin-width-scale cancellation noise this path
    avoids entirely; (b) it is deterministic (fixed seed, no device
    reduction-order variance); (c) it costs no XLA compile (~minutes
    through this backend's remote-compile hop) for a job that is ~6 s of
    host work at n=1e6. Quantization quality equals the f32 kernel's on
    well-scaled data (measured ~2e-3 relative mean error on lognormal
    sqnorms — that error is intrinsic to 256 bins, see
    scripts/diag_flip.py). O(n log n) sort once + O(n log h) per sweep.
    """
    v = np.sort(np.asarray(vals, dtype=np.float64))
    # k-means++ (D^2 sampling) init in f64 — quantile init starves the
    # heavy tail (the top 1/h quantile bin can span half the value range,
    # and 1-D Lloyd migration is too local to ever split it: measured 12x
    # worse max-error than D^2 seeding on lognormal sqnorms). Fixed seed:
    # the trainer stays deterministic.
    rng = np.random.default_rng(0)
    c = np.empty(h)
    c[0] = v[rng.integers(v.shape[0])]
    mind = (v - c[0]) ** 2
    for i in range(1, h):
        tot = mind.sum()
        if tot <= 0:
            c[i:] = c[i - 1]
            break
        # min() guards the pathological edge where cumsum[-1] < tot by a
        # rounding ulp (pairwise .sum() vs sequential cumsum) and
        # searchsorted lands one past the end.
        idx = min(np.searchsorted(np.cumsum(mind), rng.random() * tot),
                  v.shape[0] - 1)
        c[i] = v[idx]
        np.minimum(mind, (v - c[i]) ** 2, out=mind)
    c = np.sort(c)
    eps = max(1e-9, 1e-12 * abs(v[-1]))
    for _ in range(iters):
        mids = (c[1:] + c[:-1]) / 2.0
        idx = np.searchsorted(mids, v)
        sums = np.bincount(idx, weights=v, minlength=h)
        cnts = np.bincount(idx, minlength=h)
        newc = np.where(cnts > 0, sums / np.maximum(cnts, 1), c)
        if np.max(np.abs(newc - c)) <= eps:
            c = newc
            break
        c = newc
    return c


def train_norm_codebook(key: Array, B: Array, C: Array, h: int):
    """1-D k-means over reconstruction norms. Returns (cbnorms [h], codes [n]).

    (Reference: kmeans(dbnorms, h) at LSQ.jl:80 — Clustering.jl runs in
    f64, which is why the reference never sees the f32 cancellation that
    `scalar_kmeans` exists to avoid. `key` is kept for API stability; the
    scalar trainer is deterministic.)
    """
    del key
    sqnorms = np.asarray(reconstruction_sqnorms(B, C))
    centers = scalar_kmeans(sqnorms, h)
    mids = (centers[1:] + centers[:-1]) / 2.0
    codes = np.searchsorted(mids, sqnorms.astype(np.float64))
    return (jnp.asarray(centers, jnp.float32),
            jnp.asarray(codes, jnp.int32))


@jax.jit
def _quantize_norms_block(B: Array, C: Array, cbnorms: Array) -> Array:
    sqnorms = reconstruction_sqnorms(B, C)  # [n]
    d2 = (sqnorms[:, None] - cbnorms[None, :]) ** 2
    return jnp.argmin(d2, axis=-1).astype(jnp.int32)


def quantize_norms(B: Array, C: Array, cbnorms: Array,
                   *, block: int = 1 << 16) -> Array:
    """Assign each vector's reconstruction norm to its nearest codebook entry.

    Returns [n] int32 norm codes. (Reference: quantize_norms, utils.jl:6-31.)

    Chunked over rows: the reconstruction intermediate is [n*m, d] —
    26.8 GB at the GIST paper-scale shape (n=1M, m=7, d=960), more device
    memory than a card has. Fixed-size blocks (last one padded by
    repeating a row, so every chunk hits ONE compiled shape) bound it at
    ~1.8 GB while leaving small-n callers on the single-launch path.
    Blocks are dispatched back-to-back and fetched ONCE (a host sync per
    block would serialize compute against transfers); the chunked path
    returns host memory — every
    caller consumes the codes on host anyway, so round-tripping the
    concatenation through the device would be a pure upload tax.
    """
    n = B.shape[0]
    if n <= block:
        return _quantize_norms_block(B, C, cbnorms)
    B = jnp.asarray(B)
    outs, valid = [], []
    for s in range(0, n, block):
        blk = B[s:s + block]
        npad = block - blk.shape[0]
        if npad:
            blk = jnp.concatenate(
                [blk, jnp.broadcast_to(blk[-1:], (npad, blk.shape[1]))])
        outs.append(_quantize_norms_block(blk, C, cbnorms))
        valid.append(block - npad)
    outs = jax.device_get(outs)
    return np.concatenate([o[:v] for o, v in zip(outs, valid)])
