#!/usr/bin/env python
"""Host-CPU ADC scan head-to-head: our native scanner vs the reference's.

The reference's C++ linscan (src/linscan/cpp/linscan_aqd.cpp,
linscan_aqd_pairwise_byte.cpp, driven by src/linscan/Linscan.jl) is its
headline query engine for CPU serving. This bench compiles the reference's
.cpp files UNMODIFIED out of /root/reference into /tmp (run-for-measurement
only; nothing is copied into this repo) and times them against
native/lsq_native.cpp's `lsq_linscan` on identical data, same machine, same
compiler flags (-O3 -fopenmp), both through ctypes:

- PQ/OPQ path: reference `linscan_aqd_query` builds its [m*256] squared-L2
  LUT in-loop per query; ours takes precomputed LUTs (numpy-vectorized LUT
  build INCLUDED in our measured time for fairness).
- Additive (LSQ + norms) path: reference `linscan_aqd_query_extra_byte`
  (inner-product LUTs + db-norm byte, 1-based ids) vs ours with
  extra=dbnorms.

Design deltas being measured: the reference materializes an [n] pair array
per query and partial_sorts it (plus a 1e7-entry re-buffering loop,
linscan_aqd.cpp:52-91); ours streams through a size-k max-heap with no
O(n) scratch (native/lsq_native.cpp:41-76).

Run from the repo root (CPU-only; does not touch the GPU):
    python -m benchmarks.bench_native_scan [n] [nq] [k ...]
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass

REF = "/root/reference/src/linscan/cpp"


def _build_ref(tmp="/tmp/ref_linscan"):
    """Compile the reference scanners unmodified (compile.sh flags)."""
    os.makedirs(tmp, exist_ok=True)
    libs = {}
    for src, lib in (("linscan_aqd.cpp", "linscan_aqd.so"),
                     ("linscan_aqd_pairwise_byte.cpp",
                      "linscan_aqd_pairwise_byte.so")):
        out = os.path.join(tmp, lib)
        if not os.path.exists(out):
            subprocess.run(
                ["g++", "-shared", "-O3", "-fPIC", os.path.join(REF, src),
                 "-o", out, "-fopenmp"],
                check=True,
            )
        libs[lib] = ctypes.CDLL(out)
    return libs


def _load_ours():
    from local_search_quantization.utils import native
    assert native.available(), "run `make -C native` first"
    return native


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    nq = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    ks = [int(x) for x in sys.argv[3:]] or [100, 1000]
    d, m, h = 128, 8, 256
    sub = d // m
    rng = np.random.default_rng(0)
    codes = rng.integers(0, h, size=(n, m), dtype=np.uint8)
    centers = (rng.normal(size=(m, h, sub)) * 36.0).astype(np.float32)
    queries = rng.integers(0, 256, size=(nq, d)).astype(np.float32)
    dbnorms = (rng.normal(size=n).astype(np.float32) ** 2) * 1e5
    full_cb = (rng.normal(size=(m, h, d)) * 12.0).astype(np.float32)

    ref = _build_ref()
    native = _load_ours()

    cptr = codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    results = {"n": n, "nq": nq, "threads": os.cpu_count()}

    for k in ks:
        # ---- PQ/OPQ (squared-L2 LUTs) ----
        rd = np.zeros((nq, k), np.float32)
        ri = np.zeros((nq, k), np.uint32)
        t0 = time.perf_counter()
        ref["linscan_aqd.so"].linscan_aqd_query(
            rd.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            cptr,
            centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(n), ctypes.c_uint32(nq), ctypes.c_int(m * 8),
            ctypes.c_int(k), ctypes.c_int(m), ctypes.c_int(d),
            ctypes.c_int(sub),
        )
        t_ref = time.perf_counter() - t0

        t0 = time.perf_counter()
        # LUT build is part of our measured time (the reference builds its
        # LUT inside the timed call).
        qs = queries.reshape(nq, m, sub)
        luts = ((qs[:, :, None, :] - centers[None, :, :, :]) ** 2).sum(
            -1, dtype=np.float32)  # [nq, m, h]
        od, oi = native.linscan(luts, codes, None, k, method="heap")
        t_ours = time.perf_counter() - t0

        t0 = time.perf_counter()
        qs = queries.reshape(nq, m, sub)
        luts = ((qs[:, :, None, :] - centers[None, :, :, :]) ** 2).sum(
            -1, dtype=np.float32)
        fd, fi = native.linscan(luts, codes, None, k, method="auto")
        t_fast = time.perf_counter() - t0
        assert np.array_equal(fd, od) and np.array_equal(fi, oi)
        agree = np.mean([
            len(np.intersect1d(ri[q].astype(np.int64), oi[q])) / k
            for q in range(nq)
        ])
        np.testing.assert_allclose(np.sort(od, 1), np.sort(rd, 1), rtol=2e-5)
        assert agree > 0.999, agree
        results[f"pq_k{k}"] = {
            "ref_qps": round(nq / t_ref, 1),
            "ours_qps": round(nq / t_ours, 1),
            "ours_fast_qps": round(nq / t_fast, 1),
            "speedup": round(t_ref / t_ours, 2),
            "speedup_fast": round(t_ref / t_fast, 2),
            "id_agreement": round(float(agree), 5),
        }
        print(json.dumps({f"pq_k{k}": results[f"pq_k{k}"]}), flush=True)

        # ---- additive + norms (inner-product LUTs + db norm byte) ----
        rd = np.zeros((nq, k), np.float32)
        ri32 = np.zeros((nq, k), np.int32)
        t0 = time.perf_counter()
        ref["linscan_aqd_pairwise_byte.so"].linscan_aqd_query_extra_byte(
            rd.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ri32.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cptr,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            full_cb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dbnorms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(nq), ctypes.c_int(n), ctypes.c_int(m),
            ctypes.c_int(h), ctypes.c_int(d), ctypes.c_int(k),
        )
        t_ref = time.perf_counter() - t0

        t0 = time.perf_counter()
        luts = np.ascontiguousarray(
            -2.0 * np.einsum("qd,mhd->qmh", queries, full_cb),
            dtype=np.float32)
        od, oi = native.linscan(luts, codes, dbnorms, k, method="heap")
        t_ours = time.perf_counter() - t0

        t0 = time.perf_counter()
        luts = np.ascontiguousarray(
            -2.0 * np.einsum("qd,mhd->qmh", queries, full_cb),
            dtype=np.float32)
        fd, fi = native.linscan(luts, codes, dbnorms, k, method="auto")
        t_fast = time.perf_counter() - t0
        assert np.array_equal(fd, od) and np.array_equal(fi, oi)
        # Reference ids are ONE-based here (linscan_aqd_pairwise_byte.cpp:76).
        agree = np.mean([
            len(np.intersect1d(ri32[q].astype(np.int64) - 1, oi[q])) / k
            for q in range(nq)
        ])
        np.testing.assert_allclose(np.sort(od, 1), np.sort(rd, 1), rtol=2e-5)
        assert agree > 0.999, agree
        results[f"lsq_k{k}"] = {
            "ref_qps": round(nq / t_ref, 1),
            "ours_qps": round(nq / t_ours, 1),
            "ours_fast_qps": round(nq / t_fast, 1),
            "speedup": round(t_ref / t_ours, 2),
            "speedup_fast": round(t_ref / t_fast, 2),
            "id_agreement": round(float(agree), 5),
        }
        print(json.dumps({f"lsq_k{k}": results[f"lsq_k{k}"]}), flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
