"""Platform layer: I/O, eval, config, synthetic data, checkpointing."""

from local_search_quantization.utils import (
    checkpoint,
    config,
    eval,
    io,
    native,
    profiling,
    synth,
)
from local_search_quantization.utils.eval import eval_recall
from local_search_quantization.utils.io import (
    bvecs_read,
    dataset_available,
    fvecs_read,
    ivecs_read,
    read_dataset,
)
from local_search_quantization.utils.synth import random_codes, synthetic_dataset

__all__ = [
    "checkpoint", "config", "eval", "io", "native", "profiling", "synth",
    "eval_recall", "fvecs_read", "ivecs_read", "bvecs_read", "read_dataset",
    "dataset_available", "synthetic_dataset", "random_codes",
]
