#!/usr/bin/env python
"""LSQ flagship demo: OPQ -> ChainQ -> LSQ init chain, ILS base encoding,
norm quantization, additive-ADC query, recall@N.

JAX equivalent of /root/reference/demos/demo_lsq.jl (and of
demo_lsq_gpu.jl — the batched ILS encoder *is* the accelerator path here).
Falls back to a synthetic corpus when SIFT1M is not on disk.
"""

from __future__ import annotations

import argparse
import time

import jax
import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

from local_search_quantization.models import train_chainq, train_lsq, train_opq
from local_search_quantization.ops import adc, costs, icm, norms
from local_search_quantization.utils.config import ChainQConfig, LSQConfig, OPQConfig
from local_search_quantization.utils.eval import eval_recall
from local_search_quantization.utils.checkpoint import load_model, save_model
from local_search_quantization.utils.io import dataset_available, read_dataset
from local_search_quantization.utils.synth import random_codes, synthetic_dataset


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
    ap.add_argument("--m", type=int, default=7)  # m codebooks + 1 norm byte
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--ilsiter-base", type=int, default=16)  # LSQ-16
    ap.add_argument("--milestones", default=None,
                    help="comma-separated ILS round milestones for the base "
                         "encode, e.g. 16,32 — one encode run yields an "
                         "LSQ-16 AND an LSQ-32 result (reference ilsiters "
                         "API, encode_icm_cuda.jl:26). Overrides "
                         "--ilsiter-base with the last milestone.")
    ap.add_argument("--knn", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sr", default="none", choices=["none", "SR-D", "SR-C"],
                    help="stochastic relaxation (LSQ++; beyond the reference)")
    ap.add_argument("--platform", default=None,
                    help="force a JAX platform (e.g. cpu) before any backend use")
    ap.add_argument("--synth-d", type=int, default=64,
                    help="dimensionality of the synthetic fallback dataset")
    ap.add_argument("--save-model", default=None, help="save trained LSQ model (.npz)")
    ap.add_argument("--load-model", default=None,
                    help="skip training; load an LSQ model saved by --save-model")
    args = ap.parse_args()
    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    m, h = args.m, args.h
    lsq_cfg = LSQConfig(m=m, h=h, niter=args.niter, seed=args.seed,
                        sr_method=args.sr)  # validate args before the data load
    x_train, x_base, x_query, gt = load_data(args)

    if args.load_model:
        lsq = load_model(args.load_model)
        print(f"Loaded LSQ model from {args.load_model}")
        run_pipeline_tail(args, lsq, lsq_cfg, x_base, x_query, gt)
        return

    # === OPQ initialization ===
    t = time.time()
    opq = train_opq(x_train, OPQConfig(m=m, h=h, niter=args.niter, seed=args.seed))
    print(f"Error after OPQ is {float(opq.obj[-1]):e}  ({time.time()-t:.1f}s)")

    # === ChainQ initialization ===
    t = time.time()
    chain = train_chainq(
        x_train, opq.B, opq.R, ChainQConfig(m=m, h=h, niter=args.niter)
    )
    print(f"Error after ChainQ is {float(chain.obj[-1]):e}  ({time.time()-t:.1f}s)")

    # === LSQ train ===
    t = time.time()
    lsq = train_lsq(x_train, chain.B, chain.R, lsq_cfg, verbose=True)
    print(f"Error after LSQ is {float(lsq.obj[-1]):e}  ({time.time()-t:.1f}s)")
    if args.save_model:
        save_model(args.save_model, lsq)
        print(f"Saved LSQ model to {args.save_model}")

    run_pipeline_tail(args, lsq, lsq_cfg, x_base, x_query, gt)


def run_pipeline_tail(args, lsq, lsq_cfg, x_base, x_query, gt):
    # Shapes come from the model itself, not the CLI: with --load-model the
    # flags may disagree with the artifact, and the artifact wins.
    m, h = lsq.C.shape[0], lsq.C.shape[1]
    if (m, h) != (args.m, args.h):
        print(f"[demo] model has m={m}, h={h}; overriding CLI --m/--h")

    # === Encode the base set (LSQ-<milestone> for each requested round) ===
    milestones = (
        tuple(int(x) for x in args.milestones.split(","))
        if args.milestones
        else (args.ilsiter_base,)
    )
    t = time.time()
    B0 = random_codes(args.seed, x_base.shape[0], m, h)
    enc = icm.encode_chunked(
        jax.random.PRNGKey(args.seed + 1), x_base, B0, lsq.C,
        ilsiter=milestones[-1], icmiter=lsq_cfg.icmiter,
        npert=lsq_cfg.npert, randord=lsq_cfg.randord,
        milestones=milestones,
    )
    dt = time.time() - t
    print(f"Base encoding: {x_base.shape[0] / dt:.0f} vec/s  ({dt:.1f}s)")

    for s, rounds in enumerate(milestones):
        B_ms = enc.milestone_B[s]
        base_error = float(np.mean(enc.milestone_cost[s]))
        print(f"=== LSQ-{rounds}: error in base is {base_error:e}")

        # === Quantize database norms ===
        bnorm_codes = np.asarray(norms.quantize_norms(B_ms, lsq.C, lsq.cbnorms))
        db_norms = np.asarray(lsq.cbnorms)[bnorm_codes]

        # === Query + recall ===
        t = time.time()
        res = adc.linscan_lsq(B_ms, x_query, lsq.C, db_norms, k=args.knn)
        print(f"Queried {x_query.shape[0]} queries in {time.time()-t:.1f}s")
        eval_recall(gt, res.ids, args.knn)


if __name__ == "__main__":
    main()
