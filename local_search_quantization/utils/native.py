"""ctypes bindings to the native host runtime (native/liblsqnative.so).

Gracefully degrades: `available()` is False when the library isn't built and
every caller falls back to the pure NumPy/JAX path. Build with
`make -C native`.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "liblsqnative.so",
    )


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("LSQ_NATIVE_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.lsq_linscan.restype = ctypes.c_int
        lib.lsq_linscan.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p,  # extra (nullable)
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        if hasattr(lib, "lsq_linscan_fast"):
            lib.lsq_linscan_fast.restype = ctypes.c_int
            lib.lsq_linscan_fast.argtypes = lib.lsq_linscan.argtypes
        if hasattr(lib, "lsq_linscan_ivf"):
            lib.lsq_linscan_ivf.restype = ctypes.c_int
            lib.lsq_linscan_ivf.argtypes = [
                ctypes.POINTER(ctypes.c_float),   # dists out
                ctypes.POINTER(ctypes.c_int64),   # ids out
                ctypes.POINTER(ctypes.c_uint8),   # codes_g [n_g, m]
                ctypes.c_void_p,                  # codesT_g [m, n_g] or NULL
                ctypes.POINTER(ctypes.c_float),   # luts [nq, m, h]
                ctypes.c_void_p,                  # extra_g [n_g] or NULL
                ctypes.POINTER(ctypes.c_int64),   # order [n_g]
                ctypes.POINTER(ctypes.c_int64),   # starts [nlist+1]
                ctypes.POINTER(ctypes.c_int64),   # lives [nlist]
                ctypes.POINTER(ctypes.c_int32),   # probes [nq, nprobe]
                ctypes.c_float,                   # emin
                ctypes.c_int64,                   # n_g
                ctypes.c_int64,                   # nq
                ctypes.c_int,                     # m
                ctypes.c_int,                     # h
                ctypes.c_int,                     # k
                ctypes.c_int,                     # nprobe
                ctypes.c_int64,                   # nlist
            ]
        lib.lsq_vecs_read.restype = ctypes.c_int64
        lib.lsq_vecs_read.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def has_ivf() -> bool:
    """True when the built library exports the IVF segment scanner."""
    lib = _load()
    return lib is not None and hasattr(lib, "lsq_linscan_ivf")


def linscan(luts: np.ndarray, codes: np.ndarray, extra: np.ndarray | None,
            k: int, method: str = "auto"):
    """Native ADC scan. luts [nq, m, h] f32, codes [n, m] uint8.

    method: "auto" uses the AVX-512 VBMI in-register-table scanner
    (lsq_linscan_fast) when the library was built with it, falling back to
    the scalar two-phase scanner; "fast"/"heap" force one path. Both paths
    return bit-identical results (the fast path's quantized sums are only
    a pruning lower bound; accepts are exact f32 through the same heap).

    Returns (dists [nq, k] f32 ascending, ids [nq, k] int64 0-based).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    luts = np.ascontiguousarray(luts, np.float32)
    codes = np.ascontiguousarray(codes, np.uint8)
    nq, m, h = luts.shape
    n = codes.shape[0]
    assert codes.shape[1] == m
    k = min(k, n)
    dists = np.empty((nq, k), np.float32)
    ids = np.empty((nq, k), np.int64)
    extra_arr = (
        np.ascontiguousarray(extra, np.float32) if extra is not None else None
    )
    args = (
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        luts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        extra_arr.ctypes.data if extra_arr is not None else None,
        n,
        nq,
        m,
        h,
        k,
    )
    if method not in ("auto", "fast", "heap"):
        raise ValueError(f"unknown method {method!r}")
    rc = 2
    if method in ("auto", "fast"):
        if hasattr(lib, "lsq_linscan_fast"):
            rc = lib.lsq_linscan_fast(*args)
        if rc == 2 and method == "fast":
            raise RuntimeError("lsq_linscan_fast unsupported in this build")
    if rc == 2:
        rc = lib.lsq_linscan(*args)
    if rc != 0:
        raise RuntimeError(f"lsq_linscan failed with code {rc}")
    return dists, ids


def linscan_ivf(luts: np.ndarray, codes_g: np.ndarray,
                codesT_g: np.ndarray | None, extra_g: np.ndarray | None,
                order: np.ndarray, starts: np.ndarray, lives: np.ndarray,
                probes: np.ndarray, k: int, *, emin: float = 0.0):
    """Native IVF-ADC scan over probed grouped segments (lsq_linscan_ivf).

    luts [nq, m, h] f32; codes_g [n_g, m] u8 grouped by list; codesT_g
    [m, n_g] u8 planes (None forces the scalar path); order [n_g] int64
    original ids; starts [nlist+1] 64-aligned padded offsets; lives
    [nlist] live rows per segment; probes [nq, nprobe] int32 list ids
    (-1 = unused). Returns (dists [nq, k] asc, ids [nq, k] int64); short
    result sets pad with (+inf, -1).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "lsq_linscan_ivf"):
        raise RuntimeError("native library not built; run `make -C native`")
    luts = np.ascontiguousarray(luts, np.float32)
    codes_g = np.ascontiguousarray(codes_g, np.uint8)
    nq, m, h = luts.shape
    n_g = codes_g.shape[0]
    assert codes_g.shape[1] == m
    probes = np.ascontiguousarray(probes, np.int32)
    nprobe = probes.shape[1]
    starts = np.ascontiguousarray(starts, np.int64)
    lives = np.ascontiguousarray(lives, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    nlist = lives.shape[0]
    dists = np.empty((nq, k), np.float32)
    ids = np.empty((nq, k), np.int64)
    if codesT_g is not None:
        codesT_g = np.ascontiguousarray(codesT_g, np.uint8)
        assert codesT_g.shape == (m, n_g)
    if extra_g is not None:
        extra_g = np.ascontiguousarray(extra_g, np.float32)
    rc = lib.lsq_linscan_ivf(
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        codes_g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        codesT_g.ctypes.data if codesT_g is not None else None,
        luts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        extra_g.ctypes.data if extra_g is not None else None,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lives.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        probes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        float(emin), n_g, nq, m, h, k, nprobe, nlist,
    )
    if rc != 0:
        raise RuntimeError(f"lsq_linscan_ivf failed with code {rc}")
    return dists, ids


def vecs_read(path: str, scalar: type, offset: int = 0, count: int | None = None):
    """Native bulk TEXMEX reader. scalar in (np.float32, np.int32, np.uint8)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built; run `make -C native`")
    scalar = np.dtype(scalar)
    sb = scalar.itemsize
    # Probe the dimension first to size the buffer.
    dim = ctypes.c_int(0)
    probe = np.empty(0, np.uint8)
    got = lib.lsq_vecs_read(
        path.encode(), sb, 0, 0, probe.ctypes.data, ctypes.byref(dim)
    )
    if got < 0:
        raise IOError(f"failed to read {path} (rc={got})")
    d = dim.value
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        total = f.tell() // (4 + d * sb)
    want = total - offset if count is None else min(count, total - offset)
    out = np.empty((want, d), scalar)
    got = lib.lsq_vecs_read(
        path.encode(), sb, offset, want, out.ctypes.data, ctypes.byref(dim)
    )
    if got < 0:
        raise IOError(f"failed to read {path} (rc={got})")
    return out[:got]
