"""Golden end-to-end recall gates.

Pins recall@{1,10,100} for PQ, OPQ, and LSQ-8/LSQ-16 on the deterministic
SIFT-statistics corpus (utils/synth.py v5) at a CI-scale config. The
reference has no tests at all (SURVEY.md §4); its quality contract is "the
demos reproduce the papers' numbers" (/root/reference/README.md:171-177).
These gates are the CI-sized version of that contract: a quality
regression that preserves the LSQ > OPQ > PQ *ordering* (which
scripts/repro_paper.py asserts at paper scale) still fails here.

Golden values were measured on this exact config (seed 3 corpus, seed 0
models, CPU float32); the +/-0.03 absolute band covers cross-platform
numeric drift (BLAS reduction order flipping k-means ties), not sampling
noise — the corpus and all RNG are fully deterministic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.models import (
    train_chainq,
    train_lsq,
    train_opq,
    train_pq,
    quantize_opq,
    quantize_pq,
)
from local_search_quantization.ops import adc, icm, norms
from local_search_quantization.utils.config import (
    ChainQConfig,
    LSQConfig,
    OPQConfig,
    PQConfig,
)
from local_search_quantization.utils.synth import (
    random_codes,
    synthetic_dataset,
)

BAND = 0.03  # absolute recall tolerance (see module docstring)

# method -> {recall@N: golden}; measured under the conftest environment
# (8 virtual CPU devices — the host threadpool split shifts fp reduction
# orders enough to move small-sample recall by ~0.03 vs a 1-device run,
# which is exactly what the band absorbs).
# Corpus: v5 calibration (utils/synth.py: per-cluster direction banks
# basis_mix=0.4, 1.8x the v3 spread, plus v5's sample-norm concentration
# norm_sigma=0.10 — see the synth.py module docstring and
# scripts/calibrate_corpus.py). Absolute recalls at this 15k-base CI
# scale sit in a band comparable to the papers' SIFT1M curves. NOTE these
# pins are regression gates, not an ordering assertion (that is asserted
# at paper scale by scripts/repro_paper.py).
GOLDEN = {
    # Re-pinned on corpus v5 (sample-norm concentration, norm_sigma=0.10 —
    # see utils/synth.py). The additive family gains the most: the 1-byte
    # norm quantizer's tax collapses once sample norms concentrate the way
    # real SIFT's renormalization pipeline pins them, so at this CI scale
    # the full expected ordering already holds at r@10:
    # LSQ-8 0.836 > OPQ 0.744 > PQ 0.640 (ordering itself is asserted at
    # paper scale by scripts/repro_paper.py).
    "PQ": {1: 0.228, 10: 0.640, 100: 0.972},
    "OPQ": {1: 0.252, 10: 0.744, 100: 0.996},
    "LSQ-8": {1: 0.376, 10: 0.836, 100: 1.0},
    "LSQ-16": {1: 0.372, 10: 0.840, 100: 1.0},
    "ChainQ": {1: 0.264, 10: 0.736, 100: 1.0},
    # Beyond the reference: greedy residual VQ sits between PQ and LSQ at
    # equal bits, as expected for the family (models/rvq.py docstring).
    "RVQ": {1: 0.316, 10: 0.888, 100: 1.0},
    # Sparse LSQ at the reference's SLSQ1 budget (S = d*h -> l0 14% of
    # dense here): recall stays in the LSQ family's band — the trade the
    # method promises (LSQ_SPGL1.jl:7-120, demo_lsq_sparse.jl:32-41).
    "SLSQ1": {1: 0.248, 10: 0.808, 100: 0.996},
}


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(3, d=128, n_train=3000, n_base=15000,
                             n_query=250)


def recall_at(gt, ids, ns=(1, 10, 100)):
    # Thin adapter over the production curve (utils/eval.py) so the gates
    # pin exactly what eval_recall/repro report — no second recall impl.
    from local_search_quantization.utils.eval import eval_recall

    curve = eval_recall(gt, ids, max(ns), verbose=False)
    return {n: float(curve[n - 1]) for n in ns}


def check(method, rec):
    for n, want in GOLDEN[method].items():
        got = rec[n]
        assert abs(got - want) <= BAND, (
            f"{method} r@{n} = {got:.4f} drifted from golden {want:.4f} "
            f"(band +/-{BAND}); a deliberate quality change must update "
            f"tests/test_golden_recall.py AND re-run scripts/repro_paper.py"
        )


def test_golden_pq(data):
    pq = train_pq(data.train, PQConfig(m=8, h=64, kmeans_maxiter=30, seed=0))
    Bb = np.asarray(quantize_pq(data.base, pq.C_sub))
    res = adc.linscan_pq(Bb, data.query, pq.C_sub, k=100)
    check("PQ", recall_at(data.gt, res.ids))


def test_golden_opq(data):
    opq = train_opq(data.train, OPQConfig(m=8, h=64, niter=6, seed=0))
    Bb = np.asarray(quantize_opq(data.base, opq.R, opq.C_sub))
    res = adc.linscan_opq(Bb, data.query, opq.C_sub, opq.R, k=100)
    check("OPQ", recall_at(data.gt, res.ids))


def test_golden_rvq(data):
    from local_search_quantization.models import train_rvq
    from local_search_quantization.models.rvq import quantize_rvq
    from local_search_quantization.ops import norms
    from local_search_quantization.utils.config import RVQConfig

    mod = train_rvq(data.train, RVQConfig(m=7, h=64, kmeans_maxiter=30,
                                          seed=0))
    Bb = np.asarray(quantize_rvq(data.base, mod.C))
    bn = np.asarray(norms.quantize_norms(Bb, mod.C, mod.cbnorms))
    res = adc.linscan_lsq(Bb, data.query, mod.C,
                          np.asarray(mod.cbnorms)[bn], k=100)
    check("RVQ", recall_at(data.gt, res.ids))


def test_golden_chainq(data):
    from local_search_quantization.ops import viterbi

    m, h = 7, 64
    opq7 = train_opq(data.train, OPQConfig(m=m, h=h, niter=6, seed=0))
    chain = train_chainq(data.train, opq7.B, opq7.R,
                         ChainQConfig(m=m, h=h, niter=6))
    RXb = np.asarray(data.base, np.float32) @ np.asarray(chain.R)
    B = np.asarray(viterbi.viterbi_encode(RXb, chain.C))
    cbn, _ = norms.train_norm_codebook(jax.random.PRNGKey(2), B, chain.C, h)
    bn = np.asarray(norms.quantize_norms(B, chain.C, cbn))
    res = adc.linscan_lsq(B, data.query, chain.C, np.asarray(cbn)[bn],
                          k=100, R=np.asarray(chain.R))
    check("ChainQ", recall_at(data.gt, res.ids))


def test_golden_lsq_milestones(data):
    m, h = 7, 64
    opq7 = train_opq(data.train, OPQConfig(m=m, h=h, niter=6, seed=0))
    chain = train_chainq(data.train, opq7.B, opq7.R,
                         ChainQConfig(m=m, h=h, niter=6))
    cfg = LSQConfig(m=m, h=h, niter=6, seed=0)
    lsq = train_lsq(data.train, chain.B, chain.R, cfg)
    B0 = random_codes(0, data.base.shape[0], m, h)
    enc = icm.encode_chunked(
        jax.random.PRNGKey(1), data.base, B0, lsq.C, ilsiter=16,
        icmiter=cfg.icmiter, npert=cfg.npert, milestones=(8, 16),
        chunk=1 << 14,
    )
    for s_i, rounds in enumerate((8, 16)):
        B_ms = enc.milestone_B[s_i]
        bn = np.asarray(norms.quantize_norms(B_ms, lsq.C, lsq.cbnorms))
        dbn = np.asarray(lsq.cbnorms)[bn]
        res = adc.linscan_lsq(B_ms, data.query, lsq.C, dbn, k=100)
        check(f"LSQ-{rounds}", recall_at(data.gt, res.ids))


def test_golden_slsq(data):
    """Sparse LSQ (reference demos/demo_lsq_sparse.jl:11-46): PQ m=7 init,
    R=I, SLSQ1 budget S=d*h with tau = 0.7*||C_PQ||_1. Gates BOTH sides of
    the trade the method exists for: the codebooks actually go sparse
    (l0 <= S < dense) AND recall stays in the LSQ family's band."""
    from local_search_quantization.models.slsq import train_lsq_sparse
    from local_search_quantization.utils.config import SLSQConfig

    m, h = 7, 64
    d = data.train.shape[1]
    pq7 = train_pq(data.train, PQConfig(m=m, h=h, kmeans_maxiter=30, seed=0))
    cfg = SLSQConfig(m=m, h=h, niter=6, seed=0, S=d * h, tau_scale=0.7)
    sl = train_lsq_sparse(data.train, pq7.B, pq7.C_sub,
                          np.eye(d, dtype=np.float32), cfg)
    assert int(sl.l0[-1]) <= d * h < m * h * d  # sparse by construction
    B0 = random_codes(0, data.base.shape[0], m, h)
    enc = icm.encode_chunked(
        jax.random.PRNGKey(1), data.base, B0, sl.C, ilsiter=16,
        icmiter=cfg.icmiter, npert=cfg.npert, chunk=1 << 14,
    )
    bn = np.asarray(norms.quantize_norms(enc.B, sl.C, sl.cbnorms))
    res = adc.linscan_lsq(np.asarray(enc.B), data.query, sl.C,
                          np.asarray(sl.cbnorms)[bn], k=100)
    rec = recall_at(data.gt, res.ids)
    print("SLSQ golden-candidate:", rec, "l0:", int(sl.l0[-1]), "/", m * h * d)
    check("SLSQ1", rec)
