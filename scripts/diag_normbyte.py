#!/usr/bin/env python
"""Localize the paper-scale LSQ<->OPQ r@10 flip: how much recall does the
1-byte norm quantizer cost?

LSQ's 64-bit layout spends one byte on a 256-level k-means quantizer over
reconstruction sqnorms (reference src/utils.jl:5-30); PQ/OPQ pay no such
term. At paper scale on corpus v4 the additive methods (LSQ, ChainQ) both
show lower train MSE than OPQ yet lower r@10 — the shared suspect is that
byte. This scans the SAME stage-cached LSQ codes twice (quantized vs exact
f32 norms) over the SAME queries; the delta is the norm byte's recall
price in isolation. Run on CPU with the native scanner.
"""

import os
import sys

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)
import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from local_search_quantization.ops import adc, norms
    from local_search_quantization.utils import checkpoint as ckpt

    def recall_at(gt, ids, ns=(1, 2, 5, 10, 100)):
        return {f"r@{n}": float((ids[:, :n] == gt[:, None]).any(1).mean())
                for n in ns}

    cache = sys.argv[1] if len(sys.argv) > 1 else ".cache/stages_v4"
    corpus = sys.argv[2] if len(sys.argv) > 2 else ".cache/corpus_v4_paperscale.npz"
    z = np.load(corpus)
    xq, gt = z["query"], z["gt"]

    lsq = ckpt.load_model(os.path.join(cache, "lsq.npz"))
    zc = ckpt.load_codes(os.path.join(cache, "lsq_codes.npz"))
    B = np.asarray(zc["B"][-1])  # deepest milestone (LSQ-32)

    sq = np.asarray(norms.reconstruction_sqnorms(B, lsq.C))
    bn = np.asarray(norms.quantize_norms(B, lsq.C, lsq.cbnorms))
    dq = np.asarray(lsq.cbnorms)[bn].astype(np.float32)
    rel = np.abs(dq - sq) / np.maximum(np.abs(sq), 1e-9)
    print(f"norm-byte rel err: mean {rel.mean():.2e} p99 {np.quantile(rel, 0.99):.2e}")

    for name, extra in (("quantized(norm byte)", dq),
                        ("exact f32 norms", sq.astype(np.float32))):
        res = adc.linscan_lsq(B, xq, lsq.C, extra, k=1000,
                              topk_method="native")
        r = recall_at(gt, np.asarray(res.ids))
        print(f"LSQ-32 {name}: {r}")


if __name__ == "__main__":
    main()
