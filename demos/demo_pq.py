#!/usr/bin/env python
"""PQ end-to-end demo: train -> encode base -> query -> recall@N.

JAX equivalent of /root/reference/demos/demo_pq.jl. Runs on SIFT1M if
the TEXMEX files are under $LSQ_DATA (default ./data), otherwise on a
synthetic Gaussian-mixture corpus so the pipeline is always runnable.

Usage: python demos/demo_pq.py [--dataset SIFT1M|synthetic] [--ntrain 10000]
"""

from __future__ import annotations

import argparse
import time

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

from local_search_quantization.models import quantize_pq, train_pq
from local_search_quantization.ops import adc
from local_search_quantization.utils.config import PQConfig
from local_search_quantization.utils.eval import eval_recall
from local_search_quantization.utils.io import dataset_available, read_dataset
from local_search_quantization.utils.synth import synthetic_dataset
from local_search_quantization.ops.subspaces import qerror_pq


def load_data(args):
    if args.dataset != "synthetic" and dataset_available(args.dataset):
        x_train = read_dataset(args.dataset, args.ntrain).astype(np.float32)
        x_base = read_dataset(args.dataset + "_base", args.nbase).astype(np.float32)
        x_query = read_dataset(args.dataset + "_query", args.nquery).astype(np.float32)
        gt = read_dataset(args.dataset + "_groundtruth", args.nquery)[:, 0]
        return x_train, x_base, x_query, gt
    print(f"[demo] dataset {args.dataset} not found on disk; using synthetic data")
    d = synthetic_dataset(
        0,
        d=getattr(args, "synth_d", 64),
        n_train=args.ntrain,
        n_base=min(args.nbase, 1_000_000),
        n_query=min(args.nquery, 10_000),
    )
    return d.train, d.base, d.query, d.gt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before any backend use")
    ap.add_argument("--synth-d", type=int, default=64,
                    help="dimensionality of the synthetic fallback dataset")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    cfg = PQConfig(m=args.m, h=args.h)  # validate args before the data load
    x_train, x_base, x_query, gt = load_data(args)

    t = time.time()
    model = train_pq(x_train, cfg)
    print(f"Error in training is {float(model.error):e}  ({time.time()-t:.1f}s)")

    t = time.time()
    B_base = np.asarray(quantize_pq(x_base, model.C_sub))
    base_error = float(qerror_pq(x_base, B_base, model.C_sub))
    print(f"Error in base is {base_error:e}  ({time.time()-t:.1f}s)")

    t = time.time()
    res = adc.linscan_pq(B_base, x_query, model.C_sub, k=args.knn)
    print(f"Queried {x_query.shape[0]} queries in {time.time()-t:.1f}s")

    eval_recall(gt, res.ids, args.knn)


if __name__ == "__main__":
    main()
