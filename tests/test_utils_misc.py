"""Checkpointing, profiling, io readers, configs."""

import numpy as np
import pytest

from local_search_quantization.models import train_pq
from local_search_quantization.utils import checkpoint, io, profiling
from local_search_quantization.utils.config import LSQConfig, PQConfig


def test_model_checkpoint_roundtrip(tmp_path, rng):
    X = rng.normal(size=(200, 16)).astype(np.float32)
    model = train_pq(X, PQConfig(m=4, h=8))
    path = str(tmp_path / "pq.npz")
    checkpoint.save_model(path, model)
    loaded = checkpoint.load_model(path)
    assert type(loaded).__name__ == "PQModel"
    np.testing.assert_array_equal(np.asarray(model.B), loaded.B)
    np.testing.assert_allclose(np.asarray(model.C_sub), loaded.C_sub)


def test_codes_checkpoint_roundtrip(tmp_path, rng):
    B = rng.integers(0, 256, size=(100, 8)).astype(np.int32)
    path = str(tmp_path / "codes.npz")
    checkpoint.save_codes(path, B, {"norms": np.ones(100, np.float32)})
    data = checkpoint.load_codes(path)
    np.testing.assert_array_equal(data["B"], B)
    assert "norms" in data


def test_profiling_spans():
    profiling.reset()
    with profiling.span("phase_a"):
        pass
    with profiling.span("phase_a"):
        pass
    rep = profiling.report()
    assert rep["phase_a"][1] == 2


def test_fvecs_readers(tmp_path, rng):
    n, d = 23, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    path = str(tmp_path / "x.fvecs")
    with open(path, "wb") as f:
        for row in X:
            np.int32(d).tofile(f)
            row.tofile(f)
    np.testing.assert_array_equal(io.fvecs_read(path), X)
    np.testing.assert_array_equal(io.fvecs_read(path, count=5), X[:5])
    np.testing.assert_array_equal(io.fvecs_read(path, count=5, offset=3), X[3:8])

    I = rng.integers(0, 100, size=(n, d)).astype(np.int32)
    ipath = str(tmp_path / "x.ivecs")
    with open(ipath, "wb") as f:
        for row in I:
            np.int32(d).tofile(f)
            row.tofile(f)
    np.testing.assert_array_equal(io.ivecs_read(ipath), I)

    U = rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    bpath = str(tmp_path / "x.bvecs")
    with open(bpath, "wb") as f:
        for row in U:
            np.int32(d).tofile(f)
            row.tofile(f)
    np.testing.assert_array_equal(io.bvecs_read(bpath), U)


def test_fvecs_reader_rejects_corrupt(tmp_path):
    path = str(tmp_path / "bad.fvecs")
    with open(path, "wb") as f:
        np.int32(4).tofile(f)
        np.zeros(4, np.float32).tofile(f)
        np.int32(6).tofile(f)
        np.zeros(6, np.float32).tofile(f)
    with pytest.raises(ValueError):
        io.fvecs_read(path)


def test_read_dataset_unknown():
    with pytest.raises(ValueError, match="unknown"):
        io.read_dataset("NOPE1M")


def test_config_validation():
    with pytest.raises(ValueError):
        PQConfig(m=0)
    with pytest.raises(ValueError):
        PQConfig(h=1)
    with pytest.raises(ValueError):
        LSQConfig(m=4, npert=9)
    assert PQConfig(m=8, h=256).bits == 64
