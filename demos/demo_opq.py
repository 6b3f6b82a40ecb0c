#!/usr/bin/env python
"""OPQ end-to-end demo: rotation + PQ train -> encode -> query -> recall@N.

JAX equivalent of /root/reference/demos/demo_opq.jl.
"""

from __future__ import annotations

import argparse
import time

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

from local_search_quantization.models import quantize_opq, train_opq
from local_search_quantization.ops import adc
from local_search_quantization.ops.subspaces import qerror_opq
from local_search_quantization.utils.config import OPQConfig
from local_search_quantization.utils.eval import eval_recall

from demo_pq import load_data  # shared dataset loader


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--nquery", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before any backend use")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    cfg = OPQConfig(m=args.m, h=args.h, niter=args.niter, init="natural")
    x_train, x_base, x_query, gt = load_data(args)

    t = time.time()
    model = train_opq(x_train, cfg)
    print(f"Error in training is {float(model.obj[-1]):e}  ({time.time()-t:.1f}s)")

    t = time.time()
    B_base = np.asarray(quantize_opq(x_base, model.R, model.C_sub))
    base_error = float(qerror_opq(x_base, B_base, model.C_sub, model.R))
    print(f"Error in base is {base_error:e}  ({time.time()-t:.1f}s)")

    t = time.time()
    res = adc.linscan_opq(B_base, x_query, model.C_sub, model.R, k=args.knn)
    print(f"Queried {x_query.shape[0]} queries in {time.time()-t:.1f}s")
    eval_recall(gt, res.ids, args.knn)


if __name__ == "__main__":
    main()
