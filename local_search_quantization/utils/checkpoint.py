"""Artifact checkpointing between pipeline stages.

The reference has no persistence at all (HDF5 imported but never called,
SURVEY.md §5); here every trainer's NamedTuple model round-trips through a
single .npz file, so OPQ -> ChainQ -> LSQ -> base-encode pipelines can resume
at any stage. Uses numpy containers (host-side; artifacts are small — the
codes dominate at n*m int32), with the model class name recorded for typed
reload.
"""

from __future__ import annotations

import numpy as np

_REGISTRY: dict[str, type] = {}


def _registry():
    if not _REGISTRY:
        from local_search_quantization.models.chainq import ChainQModel
        from local_search_quantization.models.lsq import LSQModel
        from local_search_quantization.models.opq import OPQModel
        from local_search_quantization.models.pq import PQModel
        from local_search_quantization.models.rvq import RVQModel
        from local_search_quantization.models.slsq import SLSQModel

        for cls in (PQModel, OPQModel, ChainQModel, LSQModel, SLSQModel,
                    RVQModel):
            _REGISTRY[cls.__name__] = cls
    return _REGISTRY


def save_model(path: str, model) -> None:
    """Save any framework model NamedTuple to an .npz file."""
    fields = {f: np.asarray(getattr(model, f)) for f in model._fields}
    np.savez_compressed(path, __model__=type(model).__name__, **fields)


def load_model(path: str):
    """Load a model saved with save_model; returns the typed NamedTuple."""
    with np.load(path, allow_pickle=False) as data:
        name = str(data["__model__"])
        cls = _registry().get(name)
        if cls is None:
            raise ValueError(f"unknown model type {name!r} in {path}")
        return cls(**{f: data[f] for f in cls._fields})


def save_codes(path: str, B, extra: dict | None = None) -> None:
    """Save base-set codes (+ optional norm codes etc.)."""
    np.savez_compressed(path, B=np.asarray(B), **(extra or {}))


def load_codes(path: str):
    with np.load(path, allow_pickle=False) as data:
        return dict(data)
