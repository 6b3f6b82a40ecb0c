#!/usr/bin/env python
"""Build a serving index directory: train a quantizer, encode the base set,
persist everything `scripts/serve.py` needs.

Thin CLI over `local_search_quantization.index.Index.build` — the
production split the reference lacks: build once (GPU-heavy), serve
anywhere (the GPU device scan or the native CPU scanner).

Index directory layout (written by Index.save):
    meta.json   method / shapes / bit budget / build args
    model.npz   the trained model NamedTuple (utils/checkpoint.save_model)
    codes.npz   B [n, m] base codes; bnorm/cbnorms for the additive
                methods; tombstone mask when deletions were persisted

Usage:
    python scripts/build_index.py --method lsq --out ./index_lsq \
        --ntrain 100000 --nbase 1000000 --niter 10 --ilsiter 16
"""

from __future__ import annotations

import argparse
import time

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--method", required=True,
                    choices=["pq", "opq", "chainq", "lsq", "rvq"])
    ap.add_argument("--out", required=True, help="index directory to create")
    ap.add_argument("--dataset", default="SIFT1M")
    ap.add_argument("--ntrain", type=int, default=100_000)
    ap.add_argument("--nbase", type=int, default=1_000_000)
    ap.add_argument("--m", type=int, default=None,
                    help="codebooks; default 8 (pq/opq) or 7+norm byte "
                         "(chainq/lsq) = 64-bit codes")
    ap.add_argument("--h", type=int, default=256)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--ilsiter", type=int, default=16,
                    help="ILS rounds for the lsq base encode")
    ap.add_argument("--sr", default="none", choices=["none", "SR-D", "SR-C"],
                    help="LSQ stochastic relaxation (LSQ++, beyond the "
                         "reference); SR-C is the measured production-"
                         "quality recommendation")
    ap.add_argument("--sr-scale", type=float, default=1.0,
                    help="multiplier on the SR noise std")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synth-d", type=int, default=128)
    ap.add_argument("--ivf-nlist", type=int, default=None,
                    help="also build an IVF coarse partition with this many "
                         "lists (serve with per-request nprobe)")
    ap.add_argument("--refine", default=None, choices=["sq8", "f32"],
                    help="also keep a (scalar-quantized) copy of the base "
                         "vectors for exact re-ranking (per-request refine)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    from local_search_quantization.index import Index
    from local_search_quantization.utils.io import (
        dataset_available, read_dataset,
    )
    from local_search_quantization.utils.synth import synthetic_dataset

    if args.dataset != "synthetic" and dataset_available(args.dataset):
        x_train = read_dataset(args.dataset, args.ntrain).astype(np.float32)
        x_base = read_dataset(args.dataset + "_base", args.nbase).astype(
            np.float32)
        dataset = args.dataset
    else:
        print(f"[build] {args.dataset} files not on disk; synthetic corpus")
        dd = synthetic_dataset(args.seed, d=args.synth_d,
                               n_train=args.ntrain, n_base=args.nbase,
                               n_query=1)
        x_train, x_base = dd.train, dd.base
        dataset = "synthetic"

    t0 = time.time()
    idx = Index.build(
        x_train, x_base, args.method, m=args.m, h=args.h, niter=args.niter,
        ilsiter=args.ilsiter, seed=args.seed, verbose=True,
        refine=args.refine, sr=args.sr, sr_scale=args.sr_scale,
        meta={"dataset": dataset},
    )
    if args.ivf_nlist:
        idx.build_ivf(args.ivf_nlist, seed=args.seed)
    idx.meta["build_s"] = round(time.time() - t0, 1)
    idx.save(args.out)
    shown = {k: v for k, v in idx.meta.items() if k != "cbnorms"}
    print(f"[build] wrote {args.out} ({shown})")


if __name__ == "__main__":
    main()
