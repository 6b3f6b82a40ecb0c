"""Trainers: PQ, OPQ, ChainQ, LSQ (and sparse LSQ)."""

from local_search_quantization.models.chainq import ChainQModel, train_chainq
from local_search_quantization.models.lsq import LSQModel, train_lsq
from local_search_quantization.models.opq import OPQModel, quantize_opq, train_opq
from local_search_quantization.models.pq import PQModel, quantize_pq, train_pq
from local_search_quantization.models.rvq import RVQModel, quantize_rvq, train_rvq
from local_search_quantization.models.slsq import SLSQModel, train_lsq_sparse

__all__ = [
    "PQModel", "train_pq", "quantize_pq",
    "OPQModel", "train_opq", "quantize_opq",
    "ChainQModel", "train_chainq",
    "LSQModel", "train_lsq",
    "RVQModel", "train_rvq", "quantize_rvq",
    "SLSQModel", "train_lsq_sparse",
]
