"""Exact re-ranking ("refine") stage over ADC candidates.

Beyond the reference (whose pipelines stop at ADC distances): a serving
index can keep a scalar-quantized copy of the original vectors and
re-rank the top ADC candidates with exact distances, recovering most of
the recall the code quantization loses — the standard production pairing
with a coarse/ADC first stage (cf. the papers' own observation that ADC
recall saturates well below exact search).

Storage is SQ8: per-dimension affine u8 (d bytes/vector — for SIFT d=128
that is 128 MB per 1M rows, the same as the reference's raw bvecs). The
re-ranking distance uses the DEQUANTIZED vector, so the stage is exact
with respect to the stored representation; "f32" storage keeps originals
bit-exact at 4x the footprint.

    rq = RefineStore.build(x_base, kind="sq8")
    res = rerank(rq, Q, candidate_ids, k)   # exact top-k of the candidates
"""

from __future__ import annotations

import dataclasses

import numpy as np

from local_search_quantization.ops import adc

__all__ = ["RefineStore", "rerank"]


@dataclasses.dataclass
class RefineStore:
    """Per-dimension affine-quantized (or raw f32) vector store."""

    kind: str  # "sq8" | "f32"
    data: np.ndarray  # [n, d] u8 (sq8) or f32
    off: np.ndarray  # [d] f32 (zeros for f32)
    scale: np.ndarray  # [d] f32 (ones for f32; dequant = off + u8 * scale)

    @property
    def n(self) -> int:
        return int(self.data.shape[0])

    @property
    def d(self) -> int:
        return int(self.data.shape[1])

    @classmethod
    def build(cls, X: np.ndarray, kind: str = "sq8") -> "RefineStore":
        X = np.asarray(X, np.float32)
        if kind == "f32":
            return cls("f32", X.copy(), np.zeros(X.shape[1], np.float32),
                       np.ones(X.shape[1], np.float32))
        if kind != "sq8":
            raise ValueError(f"refine kind must be sq8 or f32, got {kind!r}")
        off = X.min(axis=0)
        span = X.max(axis=0) - off
        scale = (span / 255.0).astype(np.float32)
        inv = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
        codes = np.clip(np.rint((X - off) * inv), 0, 255).astype(np.uint8)
        return cls("sq8", codes, off.astype(np.float32), scale)

    def append(self, X: np.ndarray) -> None:
        """Quantize new rows with the FROZEN affine params (values outside
        the original span clip — same frozen-model contract as the code
        encoder on add)."""
        X = np.asarray(X, np.float32)
        if self.kind == "f32":
            self.data = np.concatenate([self.data, X])
            return
        inv = np.where(self.scale > 0,
                       1.0 / np.maximum(self.scale, 1e-30), 0.0)
        codes = np.clip(np.rint((X - self.off) * inv), 0, 255).astype(
            np.uint8)
        self.data = np.concatenate([self.data, codes])

    def take(self, keep: np.ndarray) -> None:
        """Row subset in place (compact)."""
        self.data = np.ascontiguousarray(self.data[keep])

    def decode(self, ids: np.ndarray) -> np.ndarray:
        """[len(ids), d] f32 dequantized rows."""
        rows = self.data[ids]
        if self.kind == "f32":
            return rows
        return self.off[None, :] + rows.astype(np.float32) * self.scale[None, :]

    def to_arrays(self) -> dict:
        return {"refine_kind": np.bytes_(self.kind), "refine_data": self.data,
                "refine_off": self.off, "refine_scale": self.scale}

    @classmethod
    def from_arrays(cls, a: dict) -> "RefineStore":
        return cls(bytes(a["refine_kind"]).decode(),
                   np.asarray(a["refine_data"]),
                   np.asarray(a["refine_off"], np.float32),
                   np.asarray(a["refine_scale"], np.float32))


def rerank(store: RefineStore, Q: np.ndarray, cand_ids: np.ndarray,
           k: int) -> adc.KNNResult:
    """Exact squared-L2 top-k among each query's candidate ids.

    cand_ids [nq, c] int64 from an ADC stage; -1 entries (sentinel
    padding) are skipped. Output follows the scanners' contract:
    ascending (dist, id), (+inf, -1) padding past the live candidates.
    Distances are TRUE squared L2 (not the ADC surrogate), so they are
    comparable across methods but NOT to the first-stage distances.
    """
    from local_search_quantization.ivf import topk_lex

    Q = np.asarray(Q, np.float32)
    nq, c = cand_ids.shape
    dists = np.full((nq, k), np.inf, np.float32)
    ids = np.full((nq, k), -1, np.int64)
    for q in range(nq):
        cq = cand_ids[q]
        cq = cq[cq >= 0]
        if cq.size == 0:
            continue
        x = store.decode(cq)  # [c, d]
        dv = x - Q[q][None, :]
        d = np.einsum("cd,cd->c", dv, dv, dtype=np.float32)
        dists[q], ids[q] = topk_lex(d, cq, k)
    return adc.KNNResult(dists, ids)
