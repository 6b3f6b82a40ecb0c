"""ChainQ: chain-structured multi-codebook quantization.

EM loop of: Procrustes rotation update, structured least-squares codebook
update (each dimension covered by at most two chain-adjacent codebooks), and
exact Viterbi encoding.
(Reference: train_chainq, /root/reference/src/chainq/chainq.jl:10-58.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from local_search_quantization.ops.costs import qerror, reconstruct
from local_search_quantization.ops.solver import update_codebooks_chain
from local_search_quantization.ops.viterbi import viterbi_encode
from local_search_quantization.utils.config import ChainQConfig

Array = jax.Array


class ChainQModel(NamedTuple):
    C: Array  # [m, h, d] full-dimensional chain codebooks
    B: Array  # [n, m] int32
    R: Array  # [d, d]
    obj: Array  # objective trace


@jax.jit
def _procrustes(X: Array, CB: Array) -> Array:
    U, _, Vh = jnp.linalg.svd(X.T @ CB, full_matrices=False)
    return U @ Vh


def train_chainq(
    X: Array,
    B: Array,
    R: Array,
    config: ChainQConfig = ChainQConfig(),
    *,
    C_sub_init: Array | None = None,
    verbose: bool = False,
) -> ChainQModel:
    """Train a chain quantizer, warm-started from OPQ codes/rotation.

    Args:
      X: [n, d] training data.
      B: [n, m] init codes (e.g. OPQ's).
      R: [d, d] init rotation (e.g. OPQ's).
      C_sub_init: unused placeholder for API parity — the first step
        re-solves the codebooks from (X, B) exactly as the reference does
        (chainq.jl:26-27), so the OPQ codebooks only enter through B.

    The rotation update needs the *unrotated* X each iteration, so the loop
    alternates host-side over jitted stages (each stage is compiled once).
    """
    X = jnp.asarray(X, jnp.float32)
    B = jnp.asarray(B, jnp.int32)
    R = jnp.asarray(R, jnp.float32)
    h = config.h
    objs = []

    RX = X @ R
    C = update_codebooks_chain(RX, B, h, ridge=config.ridge)
    if verbose:
        print(f"{-2:3d} {float(qerror(RX, B, C)):.6e}")
    B = viterbi_encode(RX, C)
    if verbose:
        print(f"{-1:3d} {float(qerror(RX, B, C)):.6e}")

    # The reference's `for iter = 0:niter` (chainq.jl:34-55) is INCLUSIVE:
    # niter+1 update iterations, obj recorded at the start of each —
    # matched entry-for-entry (niter+1 entries; the final update's
    # improvement is, as in the reference, not in the trace).
    for it in range(config.niter + 1):
        obj = float(qerror(RX, B, C))
        objs.append(obj)
        if verbose:
            print(f"{it:3d} {obj:.6e}")

        CB = reconstruct(B, C)  # [n, d] in rotated space
        R = _procrustes(X, CB)
        RX = X @ R
        C = update_codebooks_chain(RX, B, h, ridge=config.ridge)
        B = viterbi_encode(RX, C)

    return ChainQModel(C, B, R, np.asarray(objs, np.float32))
