"""Sweep corpus knobs (v3/v4 calibration) and report ORACLE recalls for PQ/OPQ/LSQ.

Oracle recall (exact f64 distance-to-reconstruction ranking) is the
information-theoretic ceiling of any ADC scan for a fixed encoding, and
scripts/diag_flip.py shows the production scan sits within ~3 % of it —
so it is the right (and much cheaper) calibration signal. LSQ here is
initialized from OPQ codes directly (no ChainQ) to keep the sweep fast;
the full pipeline only shifts recalls slightly.

Usage: python scripts/calibrate_corpus.py mix0 [mix1 ...] [--noise X]
       [--alpha X] [--nbase N]
"""

import argparse
import time

import jax

jax.config.update("jax_platforms", "cpu")

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np  # noqa: E402

from local_search_quantization.models.lsq import train_lsq  # noqa: E402
from local_search_quantization.models.opq import (  # noqa: E402
    quantize_opq, train_opq,
)
from local_search_quantization.models.pq import (  # noqa: E402
    quantize_pq, train_pq,
)
from local_search_quantization.ops import icm, norms  # noqa: E402
from local_search_quantization.ops.costs import reconstruct  # noqa: E402
from local_search_quantization.ops.subspaces import reconstruct_pq  # noqa: E402
from local_search_quantization.utils.config import (  # noqa: E402
    LSQConfig, OPQConfig, PQConfig,
)
from local_search_quantization.utils.synth import (  # noqa: E402
    random_codes, synthetic_dataset,
)


def recall_oracle(recon64, q64, gt, ns=(1, 10, 100)):
    r2 = (recon64 ** 2).sum(1)
    hitrank = np.empty(q64.shape[0], np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = r2[None, :] - 2.0 * q64[s:s + 128] @ recon64.T
        rank = (d2 < d2[np.arange(d2.shape[0]), gt[s:s + 128]][:, None]).sum(1)
        hitrank[s:s + 128] = rank
    return {f"r@{n}": round(float((hitrank < n).mean()), 3) for n in ns}


def one(mix, noise, alpha, ntrain, nbase, nquery, niter, seed=0, h=256,
        norm_sigma=0.10, d=128):
    t0 = time.time()
    dd = synthetic_dataset(seed, d=d, n_train=ntrain, n_base=nbase,
                           n_query=nquery, noise=noise, query_alpha=alpha,
                           basis_mix=mix, norm_sigma=norm_sigma)
    q64 = dd.query.astype(np.float64)

    pq = train_pq(dd.train, PQConfig(m=8, h=h, kmeans_maxiter=niter, seed=seed))
    Bb = np.asarray(quantize_pq(dd.base, pq.C_sub))
    r_pq = recall_oracle(
        np.asarray(reconstruct_pq(Bb, pq.C_sub, d)).astype(np.float64),
        q64, dd.gt)

    opq = train_opq(dd.train, OPQConfig(m=8, h=h, niter=niter, seed=seed))
    Bb = np.asarray(quantize_opq(dd.base, opq.R, opq.C_sub))
    recon_rot = np.asarray(reconstruct_pq(Bb, opq.C_sub, d)).astype(np.float64)
    r_opq = recall_oracle(recon_rot, q64 @ np.asarray(opq.R, np.float64), dd.gt)

    opq7 = train_opq(dd.train, OPQConfig(m=7, h=h, niter=niter, seed=seed))
    lsq = train_lsq(dd.train, opq7.B, opq7.R,
                    LSQConfig(m=7, h=h, niter=niter, seed=seed))
    B0 = random_codes(seed, nbase, 7, h)
    enc = icm.encode_chunked(
        jax.random.PRNGKey(seed + 1), dd.base, B0, lsq.C, ilsiter=8,
        icmiter=4, npert=4, milestones=(8,))
    recon_lsq = np.asarray(
        reconstruct(enc.milestone_B[0], lsq.C)).astype(np.float64)
    r_lsq = recall_oracle(recon_lsq, q64, dd.gt)

    # Production LSQ ranking: quantized ||recon||^2 via the norm byte
    # (this is what linscan_lsq actually scans with).
    sq = (recon_lsq ** 2).sum(1)
    cb = norms.scalar_kmeans(sq, 256)
    dbn = cb[np.searchsorted((cb[1:] + cb[:-1]) / 2.0, sq)]
    hitrank = np.empty(q64.shape[0], np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = dbn[None, :] - 2.0 * q64[s:s + 128] @ recon_lsq.T
        rank = (d2 < d2[np.arange(d2.shape[0]), dd.gt[s:s + 128]][:, None]).sum(1)
        hitrank[s:s + 128] = rank
    r_lsqn = {f"r@{n}": round(float((hitrank < n).mean()), 3)
              for n in (1, 10, 100)}

    mse = dict(
        pq=float(pq.error), opq=float(opq.obj[-1]),
        lsq=float(np.mean(enc.milestone_cost[0])))
    hard = mse["lsq"] / sq.mean()  # SIFT1M@64bit sits near ~0.2
    print(f"[cal] d={d} mix={mix} noise={noise} alpha={alpha} ns={norm_sigma} "
          f"({time.time() - t0:.0f}s)\n"
          f"      mse: PQ={mse['pq']:.0f} OPQ={mse['opq']:.0f} "
          f"LSQ={mse['lsq']:.0f} lsq_mse/sqnorm={hard:.3f}\n"
          f"      PQ  {r_pq}\n      OPQ {r_opq}\n      LSQ {r_lsq}\n"
          f"      LSQ+normbyte {r_lsqn}", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("mixes", nargs="+", type=float)
    ap.add_argument("--noise", type=float, default=1.0)
    ap.add_argument("--alpha", type=float, default=0.35)
    ap.add_argument("--ntrain", type=int, default=8_000)
    ap.add_argument("--nbase", type=int, default=60_000)
    ap.add_argument("--nquery", type=int, default=800)
    ap.add_argument("--niter", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--norm-sigma", type=float, default=0.10,
                    help="v5 sample-norm lognormal sigma; <0 = None (v4 behavior)")
    ap.add_argument("--d", type=int, default=128,
                    help="descriptor dimension (960 = the GIST1M shape, "
                         "read_datasets.jl:22-26)")
    a = ap.parse_args()
    for mix in a.mixes:
        ns = None if a.norm_sigma < 0 else a.norm_sigma
        one(mix, a.noise, a.alpha, a.ntrain, a.nbase, a.nquery, a.niter,
            seed=a.seed, norm_sigma=ns, d=a.d)
