"""Native host runtime (C++ scanner + readers) vs the Python/JAX paths."""

import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.ops import adc, costs
from local_search_quantization.utils import io, native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built (make -C native)"
)


def test_native_linscan_matches_python(rng):
    n, nq, d, m, h = 700, 9, 12, 3, 16
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    luts = np.asarray(adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C)))
    k = 20

    nd, ni = native.linscan(luts, B.astype(np.uint8), dbn, k)
    ref = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=16,
                          base_block=128)
    np.testing.assert_allclose(nd, ref.dists, rtol=1e-4, atol=1e-4)
    # ids equal modulo exact-distance ties
    same = (ni == ref.ids).mean()
    assert same > 0.95


def test_native_linscan_no_extra(rng):
    n, nq, m, h = 300, 4, 2, 8
    luts = rng.normal(size=(nq, m, h)).astype(np.float32)
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    nd, ni = native.linscan(luts, codes, None, 5)
    # Oracle
    for q in range(nq):
        d = np.zeros(n, np.float32)
        for j in range(m):
            d += luts[q, j, codes[:, j]]
        order = np.argsort(d, kind="stable")[:5]
        np.testing.assert_allclose(np.sort(nd[q]), np.sort(d[order]), rtol=1e-5)


@pytest.mark.parametrize("m", [7, 8, 15, 16])
def test_native_template_widths_vs_oracle(rng, m):
    """The scalar scanner's unrolled fill templates (adc_block<7/8/15/16>,
    native/lsq_native.cpp) must each match a numpy oracle exactly in id
    and value — the 128-bit widths (m=15/16) are the production wide-code
    paths (otherwise only reachable through the VBMI-gated parity grid;
    this runs on ANY build)."""
    n, nq, h, k = 4000, 3, 256, 64
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    luts = rng.normal(size=(nq, m, h)).astype(np.float32)
    extra = (rng.normal(size=n).astype(np.float32) ** 2) * 3
    nd, ni = native.linscan(luts, codes, extra, k, method="heap")
    for q in range(nq):
        d = extra.copy()
        for j in range(m):
            d = d + luts[q, j, codes[:, j]]
        order = np.lexsort((np.arange(n), d))[:k]
        np.testing.assert_array_equal(ni[q], order)
        np.testing.assert_allclose(nd[q], d[order], rtol=1e-6, atol=1e-6)


def _fast_supported():
    """True when the library was built with AVX-512 VBMI."""
    import ctypes

    lib = native._load()
    if lib is None or not hasattr(lib, "lsq_linscan_fast"):
        return False
    d = np.zeros((1, 1), np.float32)
    i = np.zeros((1, 1), np.int64)
    c = np.zeros((1, 1), np.uint8)
    lut = np.zeros((1, 1, 2), np.float32)
    rc = lib.lsq_linscan_fast(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        None, 1, 1, 1, 2, 1,
    )
    return rc == 0


@pytest.mark.parametrize(
    "n,nq,m,h,k,use_extra,ties",
    [
        (10_000, 4, 7, 256, 100, True, False),
        (10_000, 4, 8, 256, 1000, False, True),   # duplicated rows: exact ties
        (5_000, 3, 15, 256, 999, True, False),
        (300, 3, 8, 20, 300, False, False),        # k == n, h < 256
        (100, 2, 3, 64, 7, True, False),
        (65, 2, 8, 256, 64, False, False),         # single SIMD chunk
        (4_000, 2, 16, 256, 1, True, False),       # k = 1
        (20_000, 4, 8, 256, 512, True, False),     # buf mode, 64 | k: the
        # prologue ends with exactly k unsorted rows — the threshold must be
        # the max over them, not the last row's distance
        (20_000, 2, 8, 256, 1024, False, False),   # buf mode, 64 | k, no extra
    ],
)
def test_native_fast_bitwise_parity(rng, n, nq, m, h, k, use_extra, ties):
    """The AVX-512 VBMI scanner must return BIT-IDENTICAL (dists, ids) to
    the scalar heap scanner: its quantized u16 sums are only a pruning
    lower bound; accepts re-check in exact f32 with the same tie rules
    (lexicographic (dist, id) top-k)."""
    if not _fast_supported():
        pytest.skip("library built without AVX-512 VBMI")
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    if ties:
        codes[n // 2:] = codes[: n - n // 2]
    luts = (rng.normal(size=(nq, m, h)) * 10).astype(np.float32)
    extra = (
        (rng.normal(size=n).astype(np.float32) ** 2) * 5 if use_extra else None
    )
    d1, i1 = native.linscan(luts, codes, extra, k, method="heap")
    d2, i2 = native.linscan(luts, codes, extra, k, method="fast")
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)


def test_native_fast_constant_luts(rng):
    """Degenerate all-equal LUTs (zero span) must not divide by zero and
    still produce the lexicographic top-k (= first k row ids)."""
    if not _fast_supported():
        pytest.skip("library built without AVX-512 VBMI")
    n, nq, m, h, k = 500, 2, 4, 16, 10
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    luts = np.full((nq, m, h), 3.25, np.float32)
    d1, i1 = native.linscan(luts, codes, None, k, method="heap")
    d2, i2 = native.linscan(luts, codes, None, k, method="fast")
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(i2[0], np.arange(k))


def test_native_fast_constant_luts_varying_extra(rng):
    """Zero LUT span with a VARYING norm term: the quantized scale s is 0,
    so the u16 compare proves nothing and every chunk must be exact-checked
    (take_all), not pruned — the ranking lives entirely in `extra`."""
    if not _fast_supported():
        pytest.skip("library built without AVX-512 VBMI")
    n, nq, m, h, k = 5_000, 3, 4, 16, 10
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    luts = np.full((nq, m, h), 1.5, np.float32)
    extra = (rng.normal(size=n).astype(np.float32) ** 2) * 5
    d1, i1 = native.linscan(luts, codes, extra, k, method="heap")
    d2, i2 = native.linscan(luts, codes, extra, k, method="fast")
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(i1[0], np.argsort(extra, kind="stable")[:k])


class _NoFastProxy:
    """Wraps the loaded library pretending lsq_linscan_fast was not built."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name == "lsq_linscan_fast":
            raise AttributeError(name)
        return getattr(self._lib, name)


def test_native_method_routing_without_fast(rng, monkeypatch):
    """On a build lacking the VBMI entry point, method="fast" must raise
    (not silently fall through to the scalar scanner) and method="auto"
    must fall back to the scalar path, agreeing with "heap"."""
    lib = native._load()
    monkeypatch.setattr(native, "_LIB", _NoFastProxy(lib))
    monkeypatch.setattr(native, "_TRIED", True)
    n, nq, m, h, k = 400, 3, 4, 16, 11
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    luts = rng.normal(size=(nq, m, h)).astype(np.float32)
    with pytest.raises(RuntimeError, match="unsupported"):
        native.linscan(luts, codes, None, k, method="fast")
    d1, i1 = native.linscan(luts, codes, None, k, method="auto")
    d2, i2 = native.linscan(luts, codes, None, k, method="heap")
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)
    with pytest.raises(ValueError, match="unknown method"):
        native.linscan(luts, codes, None, k, method="bogus")


def test_native_fast_fuzz_parity(rng):
    """Seeded shape/content fuzz: the fixed parity grid has twice let an
    edge case through (64 | k threshold seeding; zero-span LUTs with
    varying extra), so randomize shapes, k, LUT degeneracies, tie-heavy
    codes, and extreme extra scales against the scalar oracle."""
    if not _fast_supported():
        pytest.skip("library built without AVX-512 VBMI")
    for trial in range(15):
        n = int(rng.integers(65, 20_000))
        m = int(rng.integers(1, 17))
        h = int(rng.integers(4, 257))
        k = int(rng.integers(1, min(n, 2048) + 1))
        codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
        if rng.random() < 0.3:  # heavy exact-tie pressure
            codes[n // 2:] = codes[: n - n // 2]
        luts = (rng.normal(size=(m, h)) * rng.uniform(0.01, 50)).astype(
            np.float32)[None].repeat(2, axis=0)
        luts += rng.normal(size=(2, m, h)).astype(np.float32)
        if rng.random() < 0.2:  # (near-)zero span
            luts[:] = np.float32(rng.normal())
        extra = None
        if rng.random() < 0.6:
            scale = 10.0 ** rng.integers(-2, 6)  # up to norm >> lut regime
            extra = (rng.normal(size=n).astype(np.float32) ** 2) * scale
        d1, i1 = native.linscan(luts, codes, extra, k, method="heap")
        d2, i2 = native.linscan(luts, codes, extra, k, method="fast")
        ctx = dict(trial=trial, n=n, m=m, h=h, k=k,
                   extra=extra is not None)
        np.testing.assert_array_equal(d1, d2, err_msg=str(ctx))
        np.testing.assert_array_equal(i1, i2, err_msg=str(ctx))


def test_native_tombstoned_rows_pad_with_sentinels(rng):
    """+inf extra rows (tombstones) are never returned; when fewer than k
    finite rows exist, both scanners pad with the (+inf, -1) sentinel
    instead of reading past the candidate set."""
    n, nq, m, h, k = 600, 3, 4, 16, 32
    codes = rng.integers(0, h, size=(n, m)).astype(np.uint8)
    luts = rng.normal(size=(nq, m, h)).astype(np.float32)
    extra = np.zeros(n, np.float32)
    keep = 20  # fewer finite rows than k
    extra[keep:] = np.inf
    for method in ("heap", "fast") if _fast_supported() else ("heap",):
        d, i = native.linscan(luts, codes, extra, k, method=method)
        assert np.all(i[:, :keep] < keep) and np.all(i[:, :keep] >= 0)
        np.testing.assert_array_equal(i[:, keep:], -1)
        assert np.all(np.isinf(d[:, keep:]))


def test_native_vecs_read_roundtrip(tmp_path, rng):
    # Write an fvecs file, read through both paths.
    n, d = 57, 9
    X = rng.normal(size=(n, d)).astype(np.float32)
    path = str(tmp_path / "test.fvecs")
    with open(path, "wb") as f:
        for row in X:
            np.int32(d).tofile(f)
            row.tofile(f)
    a = io.fvecs_read(path)
    b = native.vecs_read(path, np.float32)
    np.testing.assert_array_equal(a, X)
    np.testing.assert_array_equal(b, X)
    # Range read.
    c = native.vecs_read(path, np.float32, offset=10, count=20)
    np.testing.assert_array_equal(c, X[10:30])


def test_native_vecs_read_corrupt(tmp_path):
    path = str(tmp_path / "bad.fvecs")
    with open(path, "wb") as f:
        np.int32(4).tofile(f)
        np.zeros(4, np.float32).tofile(f)
        np.int32(5).tofile(f)  # inconsistent dim header
        np.zeros(5, np.float32).tofile(f)
    with pytest.raises(IOError):
        native.vecs_read(path, np.float32)
