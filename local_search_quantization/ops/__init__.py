"""Compute kernels: LUTs, costs, k-means, ICM/ILS, Viterbi, solvers, ADC."""

from local_search_quantization.ops import (
    adc,
    costs,
    icm,
    kmeans,
    luts,
    norms,
    prox,
    solver,
    subspaces,
    viterbi,
)
from local_search_quantization.ops.adc import linscan_lsq, linscan_opq, linscan_pq
from local_search_quantization.ops.costs import (
    qerror,
    reconstruct,
    subspace_slices,
    veccost,
)
from local_search_quantization.ops.icm import encode_chunked, ils_encode
from local_search_quantization.ops.kmeans import kmeans as kmeans_fit
from local_search_quantization.ops.luts import (
    get_binaries,
    get_chain_binaries,
    get_unaries,
)
from local_search_quantization.ops.norms import quantize_norms, train_norm_codebook
from local_search_quantization.ops.solver import (
    update_codebooks,
    update_codebooks_chain,
)
from local_search_quantization.ops.viterbi import viterbi_encode

__all__ = [
    "adc", "costs", "icm", "kmeans", "luts", "norms", "prox", "solver", "subspaces",
    "viterbi", "linscan_pq", "linscan_opq", "linscan_lsq", "qerror",
    "reconstruct", "subspace_slices", "veccost", "ils_encode", "encode_chunked",
    "kmeans_fit", "get_unaries", "get_binaries", "get_chain_binaries",
    "quantize_norms", "train_norm_codebook", "update_codebooks",
    "update_codebooks_chain", "viterbi_encode",
]
