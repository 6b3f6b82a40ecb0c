#!/usr/bin/env python
"""ChainQ end-to-end demo: OPQ init -> chain training -> exact Viterbi base
encoding -> norm quantization -> additive-ADC query -> recall@N.

The reference only uses ChainQ as LSQ's initializer (demos/demo_lsq.jl);
chain codes are additive full-dimensional codes, so the additive scanner
serves them directly — this demo completes ChainQ as a standalone method.
"""

from __future__ import annotations

import argparse
import time

import jax
import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

from local_search_quantization.models import train_chainq, train_opq
from local_search_quantization.ops import adc, costs, norms, viterbi
from local_search_quantization.utils.config import ChainQConfig, OPQConfig
from local_search_quantization.utils.eval import eval_recall

from demo_pq import load_data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--synth-d", type=int, default=64)
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    m, h = args.m, args.h
    opq_cfg = OPQConfig(m=m, h=h, niter=args.niter)  # validate before load
    x_train, x_base, x_query, gt = load_data(args)

    t = time.time()
    opq = train_opq(x_train, opq_cfg)
    print(f"Error after OPQ is {float(opq.obj[-1]):e}  ({time.time()-t:.1f}s)")

    t = time.time()
    chain = train_chainq(x_train, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=args.niter))
    print(f"Error after ChainQ is {float(chain.obj[-1]):e}  ({time.time()-t:.1f}s)")

    # Viterbi-encode the base set in the rotated space (exact per-vector).
    t = time.time()
    RXb = np.asarray(x_base) @ np.asarray(chain.R)
    B_base = np.asarray(viterbi.viterbi_encode(RXb, chain.C))
    dt = time.time() - t
    print(f"Base Viterbi encoding: {x_base.shape[0]/dt:.0f} vec/s  ({dt:.1f}s)")
    base_err = float(costs.qerror(RXb, B_base, chain.C))
    print(f"Error in base is {base_err:e}")

    # Norm codebook + query (additive scanner, queries rotated).
    key = jax.random.PRNGKey(0)
    cbnorms, _ = norms.train_norm_codebook(key, B_base[: 100_000], chain.C, h)
    bnorm_codes = np.asarray(norms.quantize_norms(B_base, chain.C, cbnorms))
    db_norms = np.asarray(cbnorms)[bnorm_codes]

    t = time.time()
    res = adc.linscan_lsq(B_base, x_query, chain.C, db_norms, k=args.knn,
                          R=np.asarray(chain.R))
    print(f"Queried {x_query.shape[0]} queries in {time.time()-t:.1f}s")
    eval_recall(gt, res.ids, args.knn)


if __name__ == "__main__":
    main()
