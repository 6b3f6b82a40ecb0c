"""Card-only checks: what the GPU compiler makes of the device routes.

Each test takes the `gpu` fixture and skips on the CPU; chip_smoke.py runs
them on the card (`python chip_smoke.py`). The CPU suite holds the same
contracts on the CPU compiler (test_adc_eval, test_icm, test_routes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization import routes
from local_search_quantization.ops import adc, costs, icm

pytestmark = pytest.mark.gpu


def test_gpu_route_is_active(gpu):
    assert routes.platform_route() is routes.ROUTES["gpu"]
    assert icm.resolve_condition_mode("auto") == "matmul"


@pytest.mark.parametrize("mode", ["gather", "matmul"])
def test_gpu_scan_meets_precision_contract(gpu, mode):
    """Both scan modes stay within SCAN_REL_TOL of the f64 sum at SIFT-like
    magnitudes; a matmul that fell back to TF32 misses it by ~200x."""
    rng = np.random.default_rng(0)
    nq, nb, d, m, h = 64, 1 << 16, 128, 8, 256
    Q = (rng.normal(size=(nq, d)) * 30.0).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)
    Bt = rng.integers(0, h, size=(m, nb)).astype(np.uint8)
    extra = (rng.random(nb) * 1e5).astype(np.float32)
    luts = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C))
    tile = np.asarray(jax.jit(adc.lut_scan_block, static_argnames="mode")(
        luts, jnp.asarray(Bt), jnp.asarray(extra), mode=mode), np.float64)
    l64 = np.asarray(luts, np.float64)
    ref = extra.astype(np.float64)[None, :] + sum(
        l64[:, i, :][:, Bt[i]] for i in range(m))
    scale = np.asarray(adc.scan_error_scale(luts, jnp.asarray(extra)),
                       np.float64)[:, None]
    assert np.max(np.abs(tile - ref) / scale) <= adc.SCAN_REL_TOL


def test_gpu_bf16_rounding_survives_compilation(gpu):
    """round_bf16's barrier keeps XLA from folding f32 -> bf16 -> f32 back
    into the f32 input: the rounded tables equal host-side rounding."""
    import ml_dtypes

    x = np.random.default_rng(1).normal(size=(64, 7, 256)).astype(
        np.float32) * 1e3
    dev = np.asarray(jax.jit(
        lambda a: adc.round_bf16(a).astype(jnp.float32))(jnp.asarray(x)))
    host = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(dev, host)
    assert np.any(dev != x)


def test_gpu_auto_search_stays_on_device(gpu, monkeypatch):
    """With the native scanner reported present, an "auto" search on the
    card still scans on the device, from codes cached there as uint8."""
    from local_search_quantization.index import Index
    from local_search_quantization.utils import native
    from local_search_quantization.utils.synth import synthetic_dataset

    def host_scan(*a, **k):
        raise AssertionError("auto search left the device")

    monkeypatch.setattr(adc, "_native_ok", lambda B: True)
    monkeypatch.setattr(native, "linscan", host_scan)
    data = synthetic_dataset(2, d=32, n_train=2000, n_base=20000, n_query=16)
    idx = Index.build(data.train, data.base, "pq", m=4, h=64, niter=2)
    a = idx.search(data.query, k=50)
    b = idx.search(data.query, k=50)
    np.testing.assert_array_equal(np.asarray(a.ids), np.asarray(b.ids))
    assert idx._scan_cache is not None
    assert idx._scan_cache[1][0].dtype == jnp.uint8


def test_gpu_default_encode_accept_monotone(gpu):
    rng = np.random.default_rng(2)
    n, d, m, h = 4096, 128, 7, 256
    X = rng.integers(0, 256, size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 36.0).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    res = icm.ils_encode(jax.random.PRNGKey(0), jnp.asarray(X),
                         jnp.asarray(B0), jnp.asarray(C), ilsiter=2,
                         icmiter=4, npert=4, condition_mode="auto")
    c0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0),
                                  jnp.asarray(C)))
    c1 = np.asarray(costs.veccost(jnp.asarray(X), res.B, jnp.asarray(C)))
    assert (c1 <= c0 * (1 + 1e-5)).all()
    assert c1.mean() < c0.mean()
