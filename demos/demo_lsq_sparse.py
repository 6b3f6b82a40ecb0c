#!/usr/bin/env python
"""Sparse LSQ demo: PQ init -> L1-constrained codebook training (SLSQ1/SLSQ2).

JAX equivalent of /root/reference/demos/demo_lsq_sparse.jl — the
MATLAB/SPGL1 solver is replaced by an on-device FISTA + L1-ball projection.
SLSQ1: S = d*h, tau = 0.7*||C_PQ||_1. SLSQ2: S = d*h + d^2, tau = 0.9*...
(demo_lsq_sparse.jl:32-41).
"""

from __future__ import annotations

import argparse
import time

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

from local_search_quantization.models import train_pq
from local_search_quantization.models.slsq import train_lsq_sparse
from local_search_quantization.utils.config import PQConfig, SLSQConfig

from demo_pq import load_data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=10_000)
    ap.add_argument("--nbase", type=int, default=0)  # unused; training demo
    ap.add_argument("--nquery", type=int, default=0)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--variant", choices=["SLSQ1", "SLSQ2"], default="SLSQ1")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before any backend use")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    pq_cfg = PQConfig(m=args.m, h=args.h)  # validate args before the data load
    args.nbase, args.nquery = 1000, 100  # loader needs something
    x_train, *_ = load_data(args)
    d = x_train.shape[1]

    t = time.time()
    pq = train_pq(x_train, pq_cfg)
    print(f"PQ init error {float(pq.error):e}  ({time.time()-t:.1f}s)")

    if args.variant == "SLSQ1":
        S, tau_scale = d * args.h, 0.7
    else:
        S, tau_scale = d * args.h + d * d, 0.9

    cfg = SLSQConfig(
        m=args.m, h=args.h, niter=args.niter, S=S, tau_scale=tau_scale
    )
    R = np.eye(d, dtype=np.float32)
    t = time.time()
    model = train_lsq_sparse(x_train, pq.B, pq.C_sub, R, cfg, verbose=True)
    print(
        f"{args.variant}: final obj {model.obj[-1]:e}, "
        f"l0={int(model.l0[-1])} (S={S}), l1={model.l1[-1]:e}  "
        f"({time.time()-t:.1f}s)"
    )


if __name__ == "__main__":
    main()
