"""The platform route table (routes.py) and the compile-cache placement."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization import routes
from local_search_quantization.ops import adc, icm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform, expect", [
    ("gpu", routes.Route(condition_mode="matmul", host_scan=False,
                         device_code_cache=True)),
    ("cpu", routes.Route(condition_mode="gather", host_scan=True,
                         device_code_cache=False)),
])
def test_route_table_entries(platform, expect):
    assert routes.platform_route(platform) == expect
    assert icm.resolve_condition_mode("auto", platform) == expect.condition_mode


def test_default_route_keys_on_first_device():
    assert routes.platform_route() is routes.ROUTES[
        jax.devices()[0].platform]


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no route"):
        routes.platform_route(platform)
    with pytest.raises(ValueError, match="no route"):
        icm.resolve_condition_mode("auto", platform)


@pytest.mark.parametrize("mode", ["kernel", "fused"])
def test_removed_condition_modes_rejected(rng, mode):
    n, d, m, h = 16, 8, 2, 8
    X = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    C = jnp.asarray(rng.normal(size=(m, h, d)).astype(np.float32))
    B0 = jnp.asarray(rng.integers(0, h, size=(n, m), dtype=np.int32))
    with pytest.raises(ValueError, match="condition_mode"):
        icm.ils_encode(jax.random.PRNGKey(0), X, B0, C, ilsiter=1,
                       icmiter=1, npert=1, condition_mode=mode)
    with pytest.raises(ValueError, match="condition_mode"):
        icm.encode_chunked(jax.random.PRNGKey(0), X, B0, C, ilsiter=1,
                           icmiter=1, npert=1, condition_mode=mode)


def _use_route(monkeypatch, platform):
    monkeypatch.setattr(routes, "platform_route",
                        lambda p=None: routes.ROUTES[platform])


@pytest.mark.parametrize("platform, reaches_host", [("cpu", True),
                                                    ("gpu", False)])
def test_auto_search_host_scanner_only_on_host_route(
        rng, monkeypatch, platform, reaches_host):
    """With the native library present, an "auto" search answers from the
    host scanner on the CPU route and never on the GPU route; an explicit
    topk_method="native" reaches it on any route."""
    from local_search_quantization.utils import native

    n, nq, d, m, h, k = 600, 4, 8, 2, 16, 10
    C_sub = (rng.normal(size=(m, h, d // m))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    exact = adc.linscan_pq(B, Q, C_sub, k=k, topk_method="exact")

    calls = []

    def fake_linscan(luts, codes, extra, kk):
        calls.append(kk)
        return np.asarray(exact.dists), np.asarray(exact.ids)

    _use_route(monkeypatch, platform)
    monkeypatch.setattr(adc, "_native_ok", lambda B: True)
    monkeypatch.setattr(native, "linscan", fake_linscan)
    res = adc.linscan_pq(B, Q, C_sub, k=k, topk_method="auto")
    np.testing.assert_array_equal(np.asarray(res.ids), np.asarray(exact.ids))
    assert bool(calls) == reaches_host
    adc.linscan_pq(B, Q, C_sub, k=k, topk_method="native")
    assert len(calls) == int(reaches_host) + 1


def test_index_gpu_route_keeps_byte_codes_on_device(monkeypatch):
    """On the GPU route Index.search uploads its codes once, as uint8, and
    serves repeated searches from that upload."""
    from local_search_quantization.index import Index
    from local_search_quantization.utils.synth import synthetic_dataset

    data = synthetic_dataset(5, d=16, n_train=400, n_base=1000, n_query=8)
    idx = Index.build(data.train, data.base, "pq", m=2, h=16, niter=2,
                      seed=0)
    assert idx.B.dtype == np.uint8
    host = idx.search(data.query, k=10)  # CPU route: no device cache
    assert idx._scan_cache is None

    _use_route(monkeypatch, "gpu")
    uploads = []
    prepare = adc.prepare_device_codes

    def counting_prepare(B, extra=None, **kw):
        uploads.append(np.asarray(B).dtype)
        return prepare(B, extra, **kw)

    monkeypatch.setattr(adc, "prepare_device_codes", counting_prepare)
    for _ in range(2):
        res = idx.search(data.query, k=10)
        np.testing.assert_array_equal(np.asarray(res.ids),
                                      np.asarray(host.ids))
    assert uploads == [np.uint8]
    assert idx._scan_cache[1][0].dtype == jnp.uint8


@pytest.mark.parametrize("case", ["env_set", "env_unset", "other_cwd"])
def test_compile_cache_placement(monkeypatch, tmp_path, case):
    before = jax.config.jax_compilation_cache_dir
    if case == "env_set":
        expect = str(tmp_path / "cc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", expect)
    else:
        expect = os.path.join(REPO, ".cache", "jax")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if case == "other_cwd":
        monkeypatch.chdir(tmp_path)
    try:
        assert routes.enable_compile_cache() == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
