"""local_search_quantization — multi-codebook quantization (MCQ) in JAX.

A from-scratch JAX/XLA framework with the capabilities of
una-dinosauria/local-search-quantization (ECCV'16 "Revisiting additive
quantization", ECCVW'16 "Solving multi-codebook quantization in the GPU"):

- PQ / OPQ: per-subspace k-means, learned rotation (Procrustes/SVD).
- ChainQ: chain-structured MCQ with exact Viterbi encoding.
- LSQ: full additive MCQ; iterated-local-search + ICM encoding, least-squares
  codebook updates.
- Sparse LSQ: L1-constrained codebook updates (proximal solver).
- ADC query engines (asymmetric-distance lookup-table scans) + recall eval.

Data model (differs deliberately from the reference's):
    X : [n, d]  float32      data, row-major
    B : [n, m]  int32        codes, 0-based (uint8 in a served Index)
    C : [m, h, d] float32    stacked codebooks
    R : [d, d]  float32      rotation

The reference stores X as d×n, codes as 1-based m×n Int16 and codebooks as a
Julia vector of d×h matrices (see /root/reference/src/utils.jl); stacking the
codebooks lets every LUT build be a single einsum.
"""

from local_search_quantization import models, ops, parallel, utils
from local_search_quantization.utils.config import (
    ChainQConfig,
    LSQConfig,
    OPQConfig,
    PQConfig,
    SLSQConfig,
)
from local_search_quantization.index import Index

__version__ = "0.1.0"

__all__ = [
    "models",
    "ops",
    "parallel",
    "utils",
    "Index",
    "PQConfig",
    "OPQConfig",
    "ChainQConfig",
    "LSQConfig",
    "SLSQConfig",
]
