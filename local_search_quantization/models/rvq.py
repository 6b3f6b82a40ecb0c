"""RVQ: residual vector quantization — a beyond-reference additive trainer.

Sequential (greedy) multi-stage VQ: stage j runs k-means on the residual
left by stages 0..j-1, so training is m independent Lloyd's runs and
encoding is m sequential nearest-center assignments — no ICM/ILS search.
The reference implements no RVQ, but its papers benchmark against it
(ECCV'16 §5 compares LSQ to RVQ among the additive baselines); codes are
additive full-dimensional `[n, m] -> C [m, h, d]` exactly like ChainQ/LSQ,
so the whole additive serving stack (norm codebook, `adc.linscan_lsq`,
IVF, refine, Index) applies verbatim.

Quality sits between PQ and LSQ at equal bits: each stage is greedy-optimal
given the previous ones but stages are never revisited (that joint
refinement is exactly what LSQ's EM + ILS adds). Training cost is the
cheapest of the additive family — m k-means runs — which is why RVQ is a
common production starting point before investing in LSQ.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.kmeans import assign, kmeans
from local_search_quantization.ops.norms import train_norm_codebook
from local_search_quantization.utils.config import RVQConfig

Array = jax.Array


class RVQModel(NamedTuple):
    # Field layout mirrors LSQModel so every additive consumer
    # (checkpoint, Index, adc.linscan_lsq routing) treats both alike.
    C: Array  # [m, h, d] stage codebooks (original data space)
    B: Array  # [n, m] int32 training codes
    cbnorms: Array  # [h] norm codebook (squared reconstruction norms)
    B_norms: Array  # [n] int32 norm codes of the training set
    obj: Array  # [m] residual MSE after each stage (non-increasing)


def train_rvq(
    X: Array,
    config: RVQConfig = RVQConfig(),
    *,
    key: Array | None = None,
    verbose: bool = False,
) -> RVQModel:
    """Greedy residual k-means, one stage per codebook."""
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    X = jnp.asarray(X, jnp.float32)
    m, h = config.m, config.h
    residual = X
    Cs, Bs, objs = [], [], []
    for j in range(m):
        key, sub = jax.random.split(key)
        res = kmeans(sub, residual, h, maxiter=config.kmeans_maxiter)
        labels, _ = assign(residual, res.centers)
        residual = residual - res.centers[labels]
        obj = float(jnp.mean(jnp.sum(residual * residual, axis=-1)))
        Cs.append(res.centers)
        Bs.append(labels)
        objs.append(obj)
        if verbose:
            print(f"{j:3d} {obj:.6e}")
    C = jnp.stack(Cs)  # [m, h, d]
    B = jnp.stack(Bs, axis=1)  # [n, m]
    cbnorms, B_norms = train_norm_codebook(key, B, C, h)
    return RVQModel(C, B, cbnorms, B_norms, np.asarray(objs, np.float32))


@jax.jit
def quantize_rvq(X: Array, C: Array) -> Array:
    """Greedy sequential encode of new vectors: [n, m] int32 codes.

    Stage j assigns the residual after stages < j to its nearest center —
    identical to the training-time assignment rule, so encoding the train
    set reproduces the training codes exactly.
    """
    X = jnp.asarray(X, jnp.float32)
    residual = X
    out = []
    for j in range(C.shape[0]):  # m is small: unrolled under jit
        labels, _ = assign(residual, C[j])
        residual = residual - C[j][labels]
        out.append(labels)
    return jnp.stack(out, axis=1)
