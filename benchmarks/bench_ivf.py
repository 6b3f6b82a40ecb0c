#!/usr/bin/env python
"""IVF-ADC serving bench at SIFT1M scale: qps + recall vs nprobe.

Runs the native IVF scanner (lsq_linscan_ivf, AVX-512 VBMI chunks) on the
paper-repro synthetic SIFT corpus (corpus v5; regenerate with
utils.synth.synthetic_dataset(0, d=128, n_train=1e5, n_base=1e6,
n_query=1e4) and np.savez to --corpus) with 64-bit PQ codes, against the
exhaustive native scanner as both the qps baseline and the ADC recall
ceiling. Everything is host/CPU — the point of this layer is serving
without an accelerator (the reference's linscan analog is also host C++,
Linscan.jl:5 -> linscan_aqd.cpp).

Stages cache to --cache so reruns skip train/encode/partition.

Run from the repo root:
    python -m benchmarks.bench_ivf [--nq 1000] [--nlist 1024]
"""

import argparse
import json
import os
import time

import numpy as np

try:  # repo-root sys.path shim for plain-file runs; see _bootstrap.py
    import _bootstrap  # noqa: F401
except ImportError:  # python -m benchmarks.X: root already on path
    pass


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", default=".corpus_v5_paper.npz")
    ap.add_argument("--cache", default="/tmp/ivf_bench_cache")
    ap.add_argument("--nq", type=int, default=1000)
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--sample", type=int, default=1 << 17)
    ap.add_argument("--kmeans-iters", type=int, default=15)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--method", default="pq", choices=["pq", "lsq"],
                    help="lsq consumes a repro_paper.py --stage-cache dir "
                         "(lsq.npz model + lsq_codes.npz milestones) so the "
                         "additive+norms path benches without retraining")
    ap.add_argument("--stage-cache", default=None,
                    help="repro stage-cache dir for --method lsq")
    ap.add_argument("--refine", type=int, default=0,
                    help="also sweep the exact-rerank pipeline with this "
                         "candidate factor (SQ8 store over the base set)")
    ap.add_argument("--out", default="ivf_curve.json")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from local_search_quantization import ivf
    from local_search_quantization.models.pq import quantize_pq, train_pq
    from local_search_quantization.ops import adc
    from local_search_quantization.ops.subspaces import reconstruct_pq
    from local_search_quantization.utils import native
    from local_search_quantization.utils.config import PQConfig

    assert native.has_ivf(), "build the native library: make -C native"
    os.makedirs(args.cache, exist_ok=True)
    z = np.load(args.corpus)
    xt, xb = z["train"], z["base"]
    xq, gt = z["query"][: args.nq], z["gt"][: args.nq]
    n, d = xb.shape
    m, h = 8, 256

    extra = None
    if args.method == "lsq":
        # 64-bit additive codes (m=7 + norm byte) from a repro stage cache
        # — the ILS base encode is GPU work, so this mode reuses the repro
        # pipeline's artifact instead of re-encoding.
        from local_search_quantization.ops import costs, norms
        from local_search_quantization.utils import checkpoint as ckpt

        assert args.stage_cache, "--method lsq needs --stage-cache"
        lsq = ckpt.load_model(os.path.join(args.stage_cache, "lsq.npz"))
        zc = ckpt.load_codes(os.path.join(args.stage_cache, "lsq_codes.npz"))
        B = np.asarray(zc["B"][-1])  # deepest ILS milestone
        m, h = B.shape[1], lsq.C.shape[1]
        bn = np.asarray(norms.quantize_norms(B, lsq.C, lsq.cbnorms))
        extra = np.asarray(lsq.cbnorms)[bn].astype(np.float32)

        def build_luts(q):
            return np.asarray(adc.lsq_query_luts(q, lsq.C), np.float32)

        def recon(blk):
            return np.asarray(costs.reconstruct(blk, lsq.C))
    else:
        codes_path = os.path.join(args.cache, "pq_codes.npz")
        if os.path.exists(codes_path):
            cz = np.load(codes_path)
            C_sub, B = cz["C_sub"], cz["B"]
            print(f"[ivf-bench] code cache hit: {codes_path}", flush=True)
        else:
            t0 = time.perf_counter()
            model = train_pq(xt, PQConfig(m=m, h=h, kmeans_maxiter=25,
                                          seed=0))
            t1 = time.perf_counter()
            B = np.empty((n, m), np.int32)
            for s0 in range(0, n, 1 << 17):
                s1 = min(s0 + (1 << 17), n)
                B[s0:s1] = np.asarray(quantize_pq(xb[s0:s1], model.C_sub))
            t2 = time.perf_counter()
            C_sub = np.asarray(model.C_sub)
            np.savez(codes_path, C_sub=C_sub, B=B)
            print(f"[ivf-bench] PQ train {t1 - t0:.1f}s "
                  f"encode {t2 - t1:.1f}s", flush=True)

        def build_luts(q):
            return np.asarray(adc.pq_query_luts(q, C_sub), np.float32)

        def recon(blk):
            return np.asarray(reconstruct_pq(blk, C_sub, d))

    part_path = os.path.join(args.cache,
                             f"part_{args.method}_{args.nlist}.npz")
    if os.path.exists(part_path):
        with np.load(part_path) as pz:
            part = ivf.IVFPartition.from_arrays(dict(pz))
        build_s = float(np.load(part_path)["build_s"])
        print(f"[ivf-bench] partition cache hit: {part_path}", flush=True)
    else:
        t0 = time.perf_counter()
        xhat = np.empty((n, d), np.float32)
        for s0 in range(0, n, 1 << 17):
            s1 = min(s0 + (1 << 17), n)
            xhat[s0:s1] = recon(B[s0:s1])
        part = ivf.build_partition(
            B, xhat, extra, args.nlist, seed=0, sample=args.sample,
            iters=args.kmeans_iters)
        build_s = time.perf_counter() - t0
        np.savez(part_path, build_s=np.float64(build_s),
                 **part.to_arrays())
        print(f"[ivf-bench] partition built in {build_s:.1f}s", flush=True)

    luts = build_luts(xq)
    codes_u8 = np.ascontiguousarray(B, np.uint8)
    k = args.k

    def recalls(ids):
        return {f"r@{nn}": round(float(
            np.mean([gt[q] in ids[q, :nn] for q in range(args.nq)])), 4)
            for nn in (1, 10, 100) if nn <= k}

    def timeit(fn):
        best = np.inf
        for _ in range(2):
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
        return out, args.nq / best

    # Exhaustive native scan: the qps baseline AND the ADC recall ceiling.
    (ed, ei), ex_qps = timeit(
        lambda: native.linscan(luts, codes_u8, extra, k))
    results = {
        "method": args.method,
        "n": n, "nq": args.nq, "k": k, "m": m, "h": h,
        "nlist": args.nlist, "partition_build_s": round(build_s, 1),
        "exhaustive": {"qps": round(ex_qps, 1), **recalls(ei)},
        "sweep": [],
    }
    print(json.dumps({"exhaustive": results["exhaustive"]}), flush=True)

    store = None
    if args.refine:
        from local_search_quantization.refine import RefineStore, rerank

        store = RefineStore.build(xb, "sq8")
        kc = min(args.refine * k, n)
        (rd, ri), rq = timeit(lambda: rerank(
            store, xq, native.linscan(luts, codes_u8, extra, kc)[1], k))
        results["exhaustive_refined"] = {
            "refine": args.refine, "qps": round(rq, 1), **recalls(ri)}
        print(json.dumps(
            {"exhaustive_refined": results["exhaustive_refined"]}),
            flush=True)

    for nprobe in (1, 2, 4, 8, 16, 32, 64, 128):
        if nprobe > args.nlist:
            break

        def run():
            # Probe selection is part of the serving cost (the exhaustive
            # baseline pays no analog), so it belongs inside the timing.
            # LUT construction is excluded from BOTH paths symmetrically.
            probes = ivf.coarse_probes(xq, part, nprobe)
            return ivf.search(part, luts, k, probes)

        res, qps = timeit(run)
        # Fraction of the exhaustive ADC top-k the probe-limited scan kept.
        vs_adc = float(np.mean([
            len(set(ei[q]) & set(res.ids[q])) / k for q in range(args.nq)]))
        row = {"nprobe": nprobe, "qps": round(qps, 1),
               "speedup": round(qps / ex_qps, 2),
               "adc_top{}_kept".format(k): round(vs_adc, 4),
               **recalls(res.ids)}
        results["sweep"].append(row)
        print(json.dumps(row), flush=True)

        if args.refine:
            from local_search_quantization.refine import rerank

            kc = args.refine * k

            def run_refined():
                probes = ivf.coarse_probes(xq, part, nprobe)
                cand = ivf.search(part, luts, kc, probes)
                return rerank(store, xq, np.asarray(cand.ids), k)

            rres, rqps = timeit(run_refined)
            rrow = {"nprobe": nprobe, "refine": args.refine,
                    "qps": round(rqps, 1),
                    "speedup": round(rqps / ex_qps, 2),
                    **recalls(rres.ids)}
            results["sweep"].append(rrow)
            print(json.dumps(rrow), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[ivf-bench] wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
