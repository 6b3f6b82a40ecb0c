"""Diagnose the paper-scale ordering flip (OPQ r@10 > LSQ on corpus v2).

Runs the repro pipeline at reduced scale on CPU and separates three
candidate causes:

1. encoding quality: per-vector base-cost distributions + the cost of each
   query's TRUE NN (the vector whose rank determines recall);
2. the norm byte: oracle recall with exact ||recon||^2 vs the 256-bin
   quantized norms (everything else identical);
3. corpus structure: whether exact distance-to-reconstruction ranking
   (the information-theoretic best any ADC can do) already flips.

Usage: python scripts/diag_flip.py [ntrain nbase nquery niter]
"""

import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np  # noqa: E402

from local_search_quantization.models.chainq import train_chainq  # noqa: E402
from local_search_quantization.models.lsq import train_lsq  # noqa: E402
from local_search_quantization.models.opq import quantize_opq, train_opq  # noqa: E402
from local_search_quantization.ops import icm, norms  # noqa: E402
from local_search_quantization.ops.costs import reconstruct  # noqa: E402
from local_search_quantization.ops.subspaces import reconstruct_pq  # noqa: E402
from local_search_quantization.utils.config import (  # noqa: E402
    ChainQConfig, LSQConfig, OPQConfig,
)
from local_search_quantization.utils.synth import (  # noqa: E402
    random_codes, synthetic_dataset,
)


def recall_at(gt, ids, milestones=(1, 10, 100)):
    hit = ids == np.asarray(gt)[:, None]
    any_hit = np.cumsum(hit, axis=1) > 0
    return {f"r@{n}": round(float(np.mean(any_hit[:, n - 1])), 4)
            for n in milestones if n <= ids.shape[1]}

args = [int(a) for a in sys.argv[1:]]
ntrain = args[0] if len(args) > 0 else 10_000
nbase = args[1] if len(args) > 1 else 100_000
nquery = args[2] if len(args) > 2 else 1_000
niter = args[3] if len(args) > 3 else 30
seed, h, d = 0, 256, 128
milestones = (8,)

print(f"[diag] corpus v2: train={ntrain} base={nbase} query={nquery} "
      f"niter={niter}")
dd = synthetic_dataset(seed, d=d, n_train=ntrain, n_base=nbase,
                       n_query=nquery)
xq64 = dd.query.astype(np.float64)
gt = dd.gt


def oracle_recall(recon64, q64, label):
    """Exact f64 ||q - recon||^2 ranking -> recall@{1,10,100}."""
    n = recon64.shape[0]
    r2 = (recon64 ** 2).sum(1)
    ids = np.empty((q64.shape[0], 100), np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = r2[None, :] - 2.0 * q64[s:s + 128] @ recon64.T
        ids[s:s + 128] = np.argsort(d2, axis=1)[:, :100]
    rec = recall_at(gt, ids, milestones=(1, 10, 100))
    print(f"[diag] {label}: {rec}")
    return rec


def lsq_adc_recall(recon64, dbn, q64, label):
    """ADC with an explicit ||recon||^2 term (exact or quantized)."""
    ids = np.empty((q64.shape[0], 100), np.int64)
    for s in range(0, q64.shape[0], 128):
        d2 = dbn[None, :] - 2.0 * q64[s:s + 128] @ recon64.T
        ids[s:s + 128] = np.argsort(d2, axis=1)[:, :100]
    rec = recall_at(gt, ids, milestones=(1, 10, 100))
    print(f"[diag] {label}: {rec}")
    return rec


def coststats(x, recon64, label):
    c = ((x.astype(np.float64) - recon64) ** 2).sum(1)
    nn = c[gt]  # cost of each query's true NN
    print(f"[diag] {label} per-vec cost: mean={c.mean():.1f} "
          f"med={np.median(c):.1f} p90={np.percentile(c, 90):.1f} "
          f"p99={np.percentile(c, 99):.1f} | true-NN rows: "
          f"mean={nn.mean():.1f} med={np.median(nn):.1f} "
          f"p90={np.percentile(nn, 90):.1f}")


# === OPQ m=8 ===
t = time.time()
opq = train_opq(dd.train, OPQConfig(m=8, h=h, niter=niter, seed=seed))
Bb = np.asarray(quantize_opq(dd.base, opq.R, opq.C_sub))
recon_rot = np.asarray(reconstruct_pq(Bb, opq.C_sub, d)).astype(np.float64)
q_rot = xq64 @ np.asarray(opq.R).astype(np.float64)
print(f"[diag] OPQ trained ({time.time() - t:.0f}s) train_mse="
      f"{float(opq.obj[-1]):.1f}")
coststats(dd.base.astype(np.float64) @ np.asarray(opq.R).astype(np.float64),
          recon_rot, "OPQ")
oracle_recall(recon_rot, q_rot, "OPQ oracle (exact dist-to-recon)")

# === LSQ m=7 + norms ===
t = time.time()
opq7 = train_opq(dd.train, OPQConfig(m=7, h=h, niter=niter, seed=seed))
chain = train_chainq(dd.train, opq7.B, opq7.R,
                     ChainQConfig(m=7, h=h, niter=niter))
lsq_cfg = LSQConfig(m=7, h=h, niter=niter, seed=seed)
lsq = train_lsq(dd.train, chain.B, chain.R, lsq_cfg)
B0 = random_codes(seed, nbase, 7, h)
enc = icm.encode_chunked(
    jax.random.PRNGKey(seed + 1), dd.base, B0, lsq.C,
    ilsiter=milestones[-1], icmiter=lsq_cfg.icmiter, npert=lsq_cfg.npert,
    randord=lsq_cfg.randord, milestones=milestones,
)
B_lsq = enc.milestone_B[0]
print(f"[diag] LSQ trained+encoded ({time.time() - t:.0f}s) train_mse="
      f"{float(lsq.obj[-1]):.1f} base_mse={float(np.mean(enc.milestone_cost[0])):.1f}")

recon_lsq = np.asarray(reconstruct(B_lsq, lsq.C)).astype(np.float64)
coststats(dd.base.astype(np.float64), recon_lsq, "LSQ")

# 3 ranking variants, strictly ordered by information:
oracle_recall(recon_lsq, xq64, "LSQ oracle (exact dist-to-recon)")
sq_exact = (recon_lsq ** 2).sum(1)
bn = np.asarray(norms.quantize_norms(B_lsq, lsq.C, lsq.cbnorms))
dbn = np.asarray(lsq.cbnorms).astype(np.float64)[bn]
print(f"[diag] norm-byte quantization: rel-err mean="
      f"{np.abs(dbn - sq_exact).mean() / sq_exact.mean():.2e} "
      f"max={np.abs(dbn - sq_exact).max():.1f} "
      f"(sqnorm spread std={sq_exact.std():.1f})")
lsq_adc_recall(recon_lsq, sq_exact, xq64, "LSQ ADC exact norms")
lsq_adc_recall(recon_lsq, dbn, xq64, "LSQ ADC quantized norms (production)")
