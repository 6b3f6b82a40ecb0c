#!/usr/bin/env python
"""Offline recall evaluation of a built index against exact ground truth.

Loads an index directory (scripts/build_index.py), runs the query set
through Index.search, and prints the recall@N milestone curve — the same
evaluation the reference performs inline in its demos
(/root/reference/src/linscan/Linscan.jl:76-117).

Queries/ground truth come from the named dataset when its TEXMEX files
are on disk, else from the deterministic synthetic corpus (which must be
generated with the same seed/sizes as the index build for the ground
truth to be meaningful — pass the build's --seed/--ntrain/--nbase).

Usage:
    python scripts/eval_index.py --index ./index_lsq --knn 1000
"""

from __future__ import annotations

import argparse
import json
import time

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--index", required=True)
    ap.add_argument("--dataset", default=None,
                    help="dataset for queries/gt; default: the index's "
                         "meta.json dataset")
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--query-chunk", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=0,
                    help="IVF probe count (needs build_index --ivf-nlist); 0 = exhaustive")
    ap.add_argument("--refine", type=int, default=0,
                    help="exact-rerank factor (needs build_index --refine)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="scan precision: bf16 = hi-only serving fast mode "
                         "(LUTs rounded once; exhaustive scans only)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default=None, help="optional JSON output path")
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    from local_search_quantization.index import Index
    from local_search_quantization.utils.eval import eval_recall
    from local_search_quantization.utils.io import (
        dataset_available, read_dataset,
    )
    from local_search_quantization.utils.synth import synthetic_dataset

    idx = Index.load(args.index)
    dataset = args.dataset or idx.meta.get("dataset", "synthetic")
    if dataset != "synthetic" and dataset_available(dataset):
        x_query = read_dataset(dataset + "_query", args.nquery).astype(
            np.float32)
        gt = read_dataset(dataset + "_groundtruth", args.nquery)[:, 0]
    else:
        print(f"[eval] {dataset} files not on disk; regenerating the "
              "synthetic corpus (seed/sizes from the index meta)")
        if "ntrain" not in idx.meta:
            raise SystemExit(
                "[eval] index meta lacks 'ntrain' (older build) — the "
                "synthetic corpus cannot be regenerated identically; "
                "rebuild the index or evaluate against dataset files")
        # The generator draws train, then base, then queries: identical
        # seed/ntrain/n reproduce the exact base the index encoded, and
        # a different n_query only changes the query draw.
        dd = synthetic_dataset(
            idx.meta.get("seed", 0), d=idx.d,
            n_train=idx.meta["ntrain"],
            n_base=idx.meta["n"], n_query=args.nquery)
        x_query, gt = dd.query, dd.gt

    k = min(args.knn, idx.n)
    t0 = time.time()
    ids = []
    for s in range(0, x_query.shape[0], args.query_chunk):
        res = idx.search(x_query[s:s + args.query_chunk], k=k,
                         nprobe=args.nprobe or None,
                         refine=args.refine or None,
                         precision=args.precision)
        ids.append(np.asarray(res.ids))
    ids = np.concatenate(ids)
    dt = time.time() - t0
    print(f"[eval] {x_query.shape[0]} queries x k={k} over {idx.n} codes "
          f"in {dt:.1f}s ({x_query.shape[0] / dt:.0f} qps)")
    curve = eval_recall(gt, ids, k)
    if args.out:
        table = {
            "index": args.index, "dataset": dataset, "k": k,
            "nprobe": args.nprobe or None,
            "refine": args.refine or None,
            "precision": args.precision,
            "nquery": int(x_query.shape[0]), "qps": x_query.shape[0] / dt,
            "recall": {f"r@{n}": float(curve[n - 1])
                       for n in (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)
                       if n <= k},
        }
        with open(args.out, "w") as f:
            json.dump(table, f, indent=2)
        print(f"[eval] wrote {args.out}")


if __name__ == "__main__":
    main()
