"""Servable MCQ index: one frozen trained model + a mutable code store.

The reference stops at demo scripts that train and query in one process
(/root/reference/demos/demo_lsq.jl); this is the library-level production
surface behind `scripts/build_index.py` / `scripts/serve.py`:

    idx = Index.build(x_train, x_base, method="lsq")   # GPU-heavy, once
    idx.save("./index_lsq")
    ...
    idx = Index.load("./index_lsq")                    # serve anywhere
    res = idx.search(queries, k=100)                   # device scan or
                                                       # native CPU scanner
    idx.add(new_vectors)      # encode with the frozen model, append
    idx.delete([3, 17])       # O(1) +inf tombstones; ids stay stable
    idx.save("./index_lsq")   # persist mutations atomically

Search routing lives in ops/adc.py (the device scan on a GPU, the native
AVX-512 scanner on CPU hosts; routes.py decides); this module owns the
lifecycle.
"""

from __future__ import annotations

import json
import os

import numpy as np

from local_search_quantization.ops import adc
from local_search_quantization.utils import checkpoint as ckpt

_METHODS = ("pq", "opq", "chainq", "lsq", "rvq")


def _scan_cache_enabled(n: int) -> bool:
    """Device-code scan cache gate: the platform's route keeps codes on the
    device (the CPU route serves from host RAM via the native scanner) and
    the base is below the streaming segment bound
    (adc.prepare_device_codes contract)."""
    from local_search_quantization.routes import platform_route

    return platform_route().device_code_cache and n <= (1 << 26)


class Index:
    """A frozen quantizer model + mutable codes, searchable and persistable.

    Attributes:
      method: one of "pq", "opq", "chainq", "lsq", "rvq".
      model: the trained model NamedTuple (PQModel/OPQModel/ChainQModel/
        LSQModel).
      B: [n, m] codes (uint8 when h <= 256, else int32).
      meta: provenance dict (build args, bit budget, dataset name).
    """

    def __init__(self, method: str, model, B: np.ndarray, *,
                 bnorm: np.ndarray | None = None,
                 tomb: np.ndarray | None = None,
                 meta: dict | None = None):
        if method not in _METHODS:
            raise ValueError(f"method must be one of {_METHODS}, got {method}")
        self.method = method
        self.model = model
        self.ivf = None  # optional coarse partition (build_ivf)
        self.refine = None  # optional exact-rerank store (attach_refine)
        self.meta = dict(meta or {})
        self.meta.setdefault("method", method)
        # Row storage is capacity-managed (amortized doubling on add):
        # `_n` rows of each `*_buf` are live; public views slice to _n.
        # Byte codes whenever they fit: the native scanner skips its
        # range-validation passes and the device scan reads a quarter of
        # the int32 bytes.
        B = np.asarray(B)
        if self.meta.get("h", 1 << 31) <= 256:
            B = np.ascontiguousarray(B, np.uint8)
        self._num = B.shape[0]
        self._B_buf = B
        self._tomb_buf = (np.zeros(self._num, bool) if tomb is None
                          else np.asarray(tomb, bool).copy())
        self._extra_buf = None  # pq/opq tombstone carrier, built lazily
        # Device-side scan cache bookkeeping: bumped on every mutation of
        # the codes/extra term so _device_scan_state (single-device) and
        # _mesh_scan_state (sharded) can reuse the uploaded codes across
        # searches (serving hot path).
        self._scan_ver = 0
        self._scan_cache = None
        self._mesh_scan_cache = None
        if self.additive:
            if bnorm is None:
                raise ValueError(f"{method} needs bnorm norm codes")
            self._cbnorms = np.asarray(self.model.cbnorms, np.float32) \
                if method in ("lsq", "rvq") else self._meta_cbnorms()
            self._bnorm_buf = np.asarray(bnorm)
            self._dbn_buf = self._cbnorms[self._bnorm_buf].astype(np.float32)
            self._dbn_buf[self._tomb_buf] = np.inf
        elif self._tomb_buf.any():
            self._extra_buf = np.where(
                self._tomb_buf, np.inf, 0.0).astype(np.float32)

    # Live-row views over the capacity buffers (writable: they are views).
    @property
    def B(self) -> np.ndarray:
        return self._B_buf[: self._num]

    @property
    def _tomb(self) -> np.ndarray:
        return self._tomb_buf[: self._num]

    @property
    def _bnorm(self) -> np.ndarray:
        return self._bnorm_buf[: self._num]

    @property
    def _dbn(self) -> np.ndarray:
        return self._dbn_buf[: self._num]

    @property
    def _extra(self) -> np.ndarray | None:
        e = self._extra_buf
        return None if e is None else e[: self._num]

    def _append_rows(self, B_new, bnorm_new=None):
        """Amortized-O(1)-per-row append into the capacity buffers."""
        add = B_new.shape[0]
        need = self._num + add
        cap = self._B_buf.shape[0]
        if need > cap:
            new_cap = max(need, 2 * cap)

            def grow(buf):
                out = np.empty((new_cap,) + buf.shape[1:], buf.dtype)
                out[:cap] = buf
                return out

            self._B_buf = grow(self._B_buf)
            self._tomb_buf = grow(self._tomb_buf)
            if self.additive:
                self._bnorm_buf = grow(self._bnorm_buf)
                self._dbn_buf = grow(self._dbn_buf)
            elif self._extra_buf is not None:
                self._extra_buf = grow(self._extra_buf)
        n0 = self._num
        self._B_buf[n0:need] = B_new.astype(self._B_buf.dtype)
        self._tomb_buf[n0:need] = False
        if self.additive:
            self._bnorm_buf[n0:need] = bnorm_new
            self._dbn_buf[n0:need] = self._cbnorms[bnorm_new]
        elif self._extra_buf is not None:
            self._extra_buf[n0:need] = 0.0
        self._num = need
        self._scan_ver += 1
        return n0

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, x_train, x_base, method: str = "lsq", *,
              m: int | None = None, h: int = 256, niter: int = 10,
              ilsiter: int = 16, seed: int = 0, verbose: bool = False,
              refine: str | None = None, sr: str = "none",
              sr_scale: float = 1.0,
              meta: dict | None = None) -> "Index":
        """Train a quantizer on x_train and encode x_base.

        Defaults give 64-bit codes at h=256: m=8 for pq/opq, m=7 plus a
        1-byte norm code for the additive methods (the reference demo
        budget, demos/demo_pq.jl:12-17, demo_lsq.jl:14-19).

        refine: "sq8" / "f32" also keeps a (scalar-quantized) copy of
        x_base for the exact re-ranking stage (search(refine=r)).

        sr: LSQ stochastic relaxation ("none" / "SR-D" / "SR-C"; LSQ++,
        arXiv:1806.05643 — beyond the reference). "SR-C" measured better
        paper-scale recall than plain LSQ; the default stays "none" for
        reference parity. lsq-only: training-time only (the
        frozen model serves identically), but other methods don't have
        the knob, so passing it with them is an error rather than a
        silent no-op.
        """
        import jax

        from local_search_quantization.models import (
            train_chainq, train_lsq, train_opq, train_pq,
        )
        from local_search_quantization.models.opq import quantize_opq
        from local_search_quantization.models.pq import quantize_pq
        from local_search_quantization.ops import icm, norms, viterbi
        from local_search_quantization.utils.config import (
            ChainQConfig, LSQConfig, OPQConfig, PQConfig,
        )
        from local_search_quantization.utils.synth import random_codes

        if refine not in (None, "sq8", "f32"):
            # Fail BEFORE the (potentially hours-long) train+encode.
            raise ValueError(
                f"refine must be None, 'sq8' or 'f32', got {refine!r}")
        if sr not in ("none", "SR-D", "SR-C"):
            raise ValueError(f"sr must be none/SR-D/SR-C, got {sr!r}")
        if sr != "none" and method != "lsq":
            raise ValueError(
                f"sr={sr!r} is an LSQ training knob (LSQConfig.sr_method); "
                f"method={method!r} has no stochastic-relaxation stage")
        if sr_scale != 1.0 and sr == "none":
            # Same silent-no-op class as sr-with-wrong-method: a sweep
            # over sr_scale that forgets sr= would train identical plain
            # LSQ models with no error and no meta stamp.
            raise ValueError(
                f"sr_scale={sr_scale} has no effect with sr='none' — "
                "pass sr='SR-C' or sr='SR-D'")
        additive = method in ("chainq", "lsq", "rvq")
        if m is None:
            m = 7 if additive else 8
        x_train = np.asarray(x_train, np.float32)
        x_base = np.asarray(x_base, np.float32)
        bnorm = None
        if method == "pq":
            model = train_pq(x_train, PQConfig(
                m=m, h=h, kmeans_maxiter=max(25, niter), seed=seed))
            B = np.asarray(quantize_pq(x_base, model.C_sub))
        elif method == "opq":
            model = train_opq(x_train, OPQConfig(
                m=m, h=h, niter=niter, seed=seed))
            B = np.asarray(quantize_opq(x_base, model.R, model.C_sub))
        elif method == "chainq":
            opq = train_opq(x_train, OPQConfig(
                m=m, h=h, niter=niter, seed=seed))
            model = train_chainq(x_train, opq.B, opq.R,
                                 ChainQConfig(m=m, h=h, niter=niter))
            B = np.asarray(viterbi.viterbi_encode(
                x_base @ np.asarray(model.R), model.C))
            key = jax.random.PRNGKey(seed + 2)
            cbn, _ = norms.train_norm_codebook(key, B[:100_000], model.C, h)
            # ChainQModel carries no norm codebook; stash it in meta.
            meta = dict(meta or {})
            meta["cbnorms"] = np.asarray(cbn).tolist()
            bnorm = np.asarray(norms.quantize_norms(B, model.C, cbn))
        elif method == "rvq":
            from local_search_quantization.models import (
                quantize_rvq, train_rvq,
            )
            from local_search_quantization.utils.config import RVQConfig

            model = train_rvq(x_train, RVQConfig(
                m=m, h=h, kmeans_maxiter=max(25, niter), seed=seed),
                verbose=verbose)
            B = np.asarray(quantize_rvq(x_base, model.C))
            bnorm = np.asarray(
                norms.quantize_norms(B, model.C, model.cbnorms))
        else:  # lsq
            opq = train_opq(x_train, OPQConfig(
                m=m, h=h, niter=niter, seed=seed))
            chain = train_chainq(x_train, opq.B, opq.R,
                                 ChainQConfig(m=m, h=h, niter=niter))
            cfg = LSQConfig(m=m, h=h, niter=niter, seed=seed,
                            npert=min(4, m), sr_method=sr,
                            sr_scale=sr_scale)
            model = train_lsq(x_train, chain.B, chain.R, cfg,
                              verbose=verbose)
            B0 = random_codes(seed, x_base.shape[0], m, h)
            enc = icm.encode_chunked(
                jax.random.PRNGKey(seed + 1), x_base, B0, model.C,
                ilsiter=ilsiter, icmiter=cfg.icmiter, npert=cfg.npert,
                randord=cfg.randord)
            B = np.asarray(enc.B)
            bnorm = np.asarray(
                norms.quantize_norms(B, model.C, model.cbnorms))
        full_meta = {
            "method": method, "m": m, "h": h, "d": int(x_train.shape[1]),
            "n": int(B.shape[0]), "ntrain": int(x_train.shape[0]),
            "bits": int(m * np.ceil(np.log2(h))) + (8 if additive else 0),
            "niter": niter, "seed": seed,
            "ilsiter": ilsiter if method == "lsq" else None,
        }
        if sr != "none":
            # Training provenance: which SR mode produced this model
            # (serving is unaffected, but quality claims need the stamp).
            full_meta["sr"] = sr
            if sr_scale != 1.0:
                full_meta["sr_scale"] = sr_scale
        full_meta.update(meta or {})
        idx = cls(method, model, B, bnorm=bnorm, meta=full_meta)
        if refine:
            idx.attach_refine(x_base, kind=refine)
        return idx

    @classmethod
    def load(cls, path: str) -> "Index":
        """Load an index directory written by save() / build_index.py.

        Codes come back uint8 at h <= 256 (see __init__), int32 otherwise.
        """
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        model = ckpt.load_model(os.path.join(path, "model.npz"))
        codes = ckpt.load_codes(os.path.join(path, "codes.npz"))
        B = codes["B"]
        if meta["h"] > 256:
            B = B.astype(np.int32, copy=False)
        if meta["method"] in ("chainq",) and "cbnorms" in codes:
            meta = dict(meta)
            meta["cbnorms"] = np.asarray(codes["cbnorms"]).tolist()
        idx = cls(meta["method"], model, B, bnorm=codes.get("bnorm"),
                  tomb=codes.get("tomb"), meta=meta)
        # Sidecar reconciliation: codes.npz and the ivf/refine sidecars
        # are replaced by SEPARATE renames, so a crash between them leaves
        # the pair out of step. The generation stamp (one fresh token per
        # save(), written into every file of that save) detects this
        # exactly; a sidecar whose stamp mismatches stamped codes is a
        # crash leftover and is dropped. Row-count checks remain as the
        # legacy fallback for pre-stamp saves (counts cannot detect a
        # compact() renumbering when they coincide, which is why the
        # stamp exists). A kept partition additionally gets the
        # authoritative tombstone mask re-applied (idempotent).
        import sys

        gen = codes.get("gen")

        def _sidecar_ok(side_gen, legacy_ok: bool, what: str) -> bool:
            if gen is not None:
                if side_gen is not None and bytes(side_gen) == bytes(gen):
                    return True
                print(f"[index] dropping stale {what} from an interrupted "
                      "save (generation mismatch with codes.npz)",
                      file=sys.stderr)
                return False
            return legacy_ok

        ivf_path = os.path.join(path, "ivf.npz")
        if os.path.exists(ivf_path):
            from local_search_quantization.ivf import IVFPartition

            with np.load(ivf_path) as z:
                arrs = dict(z)
            side_gen = arrs.pop("gen", None)
            part = IVFPartition.from_arrays(arrs)
            if _sidecar_ok(side_gen, part.n_grouped <= idx.n,
                           "IVF partition"):
                part.tombstone(np.flatnonzero(idx._tomb))
                idx.ivf = part
        rq_path = os.path.join(path, "refine.npz")
        if os.path.exists(rq_path):
            from local_search_quantization.refine import RefineStore

            with np.load(rq_path) as z:
                arrs = dict(z)
            side_gen = arrs.pop("gen", None)
            rq = RefineStore.from_arrays(arrs)
            if _sidecar_ok(side_gen, rq.n == idx.n and rq.d == idx.d,
                           "refine store"):
                idx.refine = rq
            else:
                idx.meta.pop("refine", None)
        idx._loaded_from = path  # lets save(path) skip the frozen model
        return idx

    def save(self, path: str) -> str:
        """Persist model + codes (+ norm codes, tombstones).

        Codes and meta are written via tmp + rename so a mid-write crash
        cannot corrupt them; the frozen model is written only when absent
        (it never changes after build, and skipping the rewrite removes
        the one non-atomic window). The on-disk code dtype is always
        int32 — the canonical format — even when this host serves a uint8
        working copy (see load()).
        """
        os.makedirs(path, exist_ok=True)
        model_path = os.path.join(path, "model.npz")
        if not (os.path.exists(model_path)
                and getattr(self, "_loaded_from", None) == path):
            model_tmp = os.path.join(path, "model.tmp.npz")
            ckpt.save_model(model_tmp, self.model)
            os.replace(model_tmp, model_path)
        # One generation stamp per save, shared by codes.npz and every
        # sidecar written in the same call. The codes/ivf/refine files are
        # replaced by SEPARATE renames, and row-count heuristics cannot
        # detect a compact() renumbering (counts can coincide after
        # delete+compact+add) — load() keeps a sidecar only when its
        # generation matches the codes file's, which closes every
        # crash-between-renames window exactly.
        import secrets

        gen = np.bytes_(secrets.token_hex(16))
        extra_cols: dict = {"tomb": self._tomb, "gen": gen}
        if self.additive:
            extra_cols["bnorm"] = self._bnorm
            extra_cols["cbnorms"] = self._cbnorms
        tmp = os.path.join(path, "codes.tmp.npz")  # savez appends .npz
        ckpt.save_codes(tmp, self.B.astype(np.int32, copy=False), extra_cols)
        out = os.path.join(path, "codes.npz")
        os.replace(tmp, out)
        ivf_path = os.path.join(path, "ivf.npz")
        if self.ivf is not None:
            ivf_tmp = os.path.join(path, "ivf.tmp.npz")
            np.savez(ivf_tmp, gen=gen, **self.ivf.to_arrays())
            # np.savez appends .npz to a non-.npz name; ivf.tmp.npz keeps it.
            os.replace(ivf_tmp, ivf_path)
        elif os.path.exists(ivf_path):
            os.remove(ivf_path)  # partition was dropped (e.g. compact)
        rq_path = os.path.join(path, "refine.npz")
        if self.refine is not None:
            rq_tmp = os.path.join(path, "refine.tmp.npz")
            np.savez(rq_tmp, gen=gen, **self.refine.to_arrays())
            os.replace(rq_tmp, rq_path)
        elif os.path.exists(rq_path):
            os.remove(rq_path)
        meta = {k: v for k, v in self.meta.items() if k != "cbnorms"}
        meta["n"] = self.n
        meta_tmp = os.path.join(path, "meta.tmp.json")
        with open(meta_tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(meta_tmp, os.path.join(path, "meta.json"))
        return out

    # -- properties --------------------------------------------------------

    @property
    def additive(self) -> bool:
        return self.method in ("chainq", "lsq", "rvq")

    @property
    def n(self) -> int:
        """Total rows including tombstoned ones (ids are stable)."""
        return int(self.B.shape[0])

    @property
    def active(self) -> int:
        return int(self.n - self._tomb.sum())

    @property
    def d(self) -> int:
        return int(self.meta["d"])

    def _meta_cbnorms(self) -> np.ndarray:
        """ChainQ's norm codebook lives beside the model (the ChainQModel
        NamedTuple has no cbnorms field), stashed in meta by build/load."""
        cbn = self.meta.get("cbnorms")
        if cbn is None:
            raise ValueError("chainq index is missing its norm codebook")
        return np.asarray(cbn, np.float32)

    # -- operations ---------------------------------------------------------

    def _reconstructions(self) -> np.ndarray:
        """[n, d] f32 code reconstructions in ORIGINAL space, chunked so
        one jitted program covers every block. The IVF coarse quantizer
        partitions these (the ADC distance of a row is a function of its
        reconstruction only, see ivf.py)."""
        import jax
        import jax.numpy as jnp

        from local_search_quantization.ops import costs
        from local_search_quantization.ops.subspaces import reconstruct_pq

        model, d = self.model, self.d
        if self.additive:
            base = lambda b: costs.reconstruct(b, jnp.asarray(model.C))
        else:
            base = lambda b: reconstruct_pq(b, jnp.asarray(model.C_sub), d)
        if self.method in ("opq", "chainq"):
            # These models quantize in rotated space: xhat = recon @ R^T.
            Rt = jnp.asarray(np.asarray(model.R, np.float32)).T
            fn = lambda b: base(b) @ Rt
        else:
            fn = base
        fn = jax.jit(fn)
        out = np.empty((self.n, d), np.float32)
        B = self.B.astype(np.int32, copy=False)
        ch = 1 << 16
        for s0 in range(0, self.n, ch):
            s1 = min(s0 + ch, self.n)
            blk = B[s0:s1]
            if blk.shape[0] < ch:  # pad so every block hits one executable
                blk = np.concatenate(
                    [blk, np.zeros((ch - blk.shape[0], blk.shape[1]),
                                   np.int32)])
            out[s0:s1] = np.asarray(fn(jnp.asarray(blk)))[: s1 - s0]
        return out

    def build_ivf(self, nlist: int = 1024, *, sample: int = 1 << 18,
                  iters: int = 25, seed: int = 0) -> None:
        """Build (or rebuild) the IVF coarse partition over all current
        rows; afterwards search(..., nprobe=p) scans only the p nearest
        lists per query plus any rows added later (the exhaustive tail).
        """
        from local_search_quantization import ivf as ivf_mod

        extra = self._dbn if self.additive else self._extra
        self.ivf = ivf_mod.build_partition(
            self.B, self._reconstructions(), extra, nlist,
            seed=seed, sample=sample, iters=iters)
        self.meta["ivf_nlist"] = int(nlist)

    def attach_refine(self, X, kind: str = "sq8") -> None:
        """Keep a (scalar-quantized) copy of the ORIGINAL vectors for the
        exact re-ranking stage. X must be the base set in id order
        ([n, d], matching every current row); afterwards search(refine=r)
        reranks the top r*k ADC candidates with exact distances."""
        from local_search_quantization.refine import RefineStore

        X = np.asarray(X, np.float32)
        if X.shape != (self.n, self.d):
            raise ValueError(
                f"refine vectors must be [{self.n}, {self.d}] in id order, "
                f"got {X.shape}")
        self.refine = RefineStore.build(X, kind)
        self.meta["refine"] = kind

    def _query_luts(self, Q: np.ndarray) -> np.ndarray:
        """[nq, m, h] ADC tables with the exhaustive linscans' semantics
        (L2 LUTs for pq/opq over rotated queries; -2<q,c> inner-product
        LUTs for the additive methods, norms carried separately)."""
        model = self.model
        if self.additive:
            Qr = Q @ np.asarray(model.R, np.float32) \
                if self.method == "chainq" else Q
            return np.asarray(adc.lsq_query_luts(Qr, model.C), np.float32)
        Qr = Q @ np.asarray(model.R, np.float32) \
            if self.method == "opq" else Q
        return np.asarray(adc.pq_query_luts(Qr, model.C_sub), np.float32)

    def _search_ivf(self, Q: np.ndarray, k: int, nprobe: int) -> adc.KNNResult:
        from local_search_quantization import ivf as ivf_mod

        part = self.ivf
        luts = self._query_luts(Q)
        probes = ivf_mod.coarse_probes(Q, part, nprobe)
        res = ivf_mod.search(part, luts, k, probes)
        ntail = self.n - part.n_grouped
        if ntail == 0:
            return res
        # Rows added after the partition was built: exhaustive scan + merge
        # (kept exact so recent inserts never fall out of the candidates).
        # Reuses the grouped scan's LUTs — they already encode the
        # method's rotation/norm semantics.
        t0 = part.n_grouped
        if self.additive:
            ex = self._dbn[t0:]
        else:
            ex = None if self._extra is None else self._extra[t0:]
        tail = ivf_mod.exhaustive_scan(luts, self.B[t0:], ex, min(k, ntail))
        tail = adc.KNNResult(tail.dists, np.where(
            tail.ids >= 0, tail.ids + t0, tail.ids))
        return ivf_mod.merge_knn(res, tail, k)

    def _device_scan_state(self):
        """Cached pre-uploaded device codes for the device scan route.

        Serving hot path: re-uploading a 1M-row store (7 MB of uint8
        codes plus 4 MB of norms) per request would be paid by every
        request. The cache key is `_scan_ver`, bumped by every code/extra
        mutation (add/delete/compact), so a stale upload can never serve
        a query. Only where the platform's route keeps codes on the
        device (the CPU route serves via the native scanner over host RAM)
        and only below the streaming segment bound
        (adc.prepare_device_codes contract).
        """
        if not _scan_cache_enabled(self.n):
            return None
        cached = self._scan_cache
        if cached is not None and cached[0] == self._scan_ver:
            return cached[1]
        extra = self._dbn if self.additive else self._extra
        state = adc.prepare_device_codes(self.B, extra)
        self._scan_cache = (self._scan_ver, state)
        return state

    def _mesh_scan_state(self, mesh):
        """Cached pre-sharded device codes for the mesh serving route —
        the multi-device analog of _device_scan_state (a mesh server
        otherwise re-uploads + re-shards the whole store per request).
        Keyed on the mutation counter AND the mesh object (a server
        holds one mesh; a different mesh rebuilds).

        Unlike the single-device gate, this one is backend-agnostic: the
        mesh route always pays the per-call transpose + pad + device_put
        regardless of platform (there is no native-scanner alternative
        under a mesh — virtual CPU meshes included), and the streaming
        bound applies PER SHARD, not to the whole store."""
        from local_search_quantization.parallel.mesh import DATA_AXIS

        nshards = mesh.shape.get(DATA_AXIS, 1)
        if self.n > nshards * (1 << 26):
            return None
        cached = self._mesh_scan_cache
        if (cached is not None and cached[0] == self._scan_ver
                and cached[1] is mesh):
            return cached[2]
        from local_search_quantization.parallel.query import (
            prepare_sharded_codes,
        )

        extra = self._dbn if self.additive else self._extra
        state = prepare_sharded_codes(
            mesh, self.B, extra)
        self._mesh_scan_cache = (self._scan_ver, mesh, state)
        return state

    def search(self, Q, k: int = 100, *, mesh=None,
               nprobe: int | None = None,
               refine: int | None = None,
               precision: str = "f32") -> adc.KNNResult:
        """ADC k-NN. Beyond `active` rows, results pad with the
        (+inf, -1) sentinel.

        mesh: an optional `jax.sharding.Mesh` — the database axis is
        sharded across its devices and each shard's top-k is merged
        (parallel/query.py), the multi-device serving path.
        nprobe: with a built IVF partition (build_ivf), scan only the
        nprobe nearest coarse lists per query (plus rows added since the
        partition) — approximate with exact distances over the candidate
        set; recall -> exhaustive as nprobe -> nlist. None/0 = exhaustive.
        refine: with an attached refine store, rerank the top refine*k
        ADC candidates by EXACT distance to the stored original vectors;
        returned distances are then true squared L2, not the ADC
        surrogate. Composes with nprobe.
        precision: "bf16" rounds the query LUTs to bf16 once and returns
        the exact top-k of that rounded metric. Exhaustive scans only
        (single-device and mesh routes; not IVF's host path — its
        probed-candidate distances are exact by design, ivf.py).
        Composes with refine — bf16 candidates reranked by exact f32
        vector distances is the recommended pairing when using it at
        all. Default "f32" matches the reference scanners exactly.
        """
        Q = np.asarray(Q, np.float32)
        if Q.ndim != 2 or Q.shape[1] != self.d:
            raise ValueError(f"queries must be [nq, {self.d}], got {Q.shape}")
        if not 1 <= k <= self.n:
            raise ValueError(f"k={k} out of range [1, {self.n}]")
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got "
                             f"{precision!r}")
        if precision != "f32" and nprobe is not None and nprobe != 0:
            raise ValueError(
                "precision='bf16' applies to the exhaustive scan routes "
                "(single-device or mesh); the IVF host path scans probed "
                "candidates at exact f32 by design")
        if refine is not None and refine != 0:
            from local_search_quantization.refine import rerank

            if self.refine is None:
                raise ValueError("refine given but no refine store; build "
                                 "with refine= or call attach_refine()")
            refine = int(refine)
            if refine < 1:
                raise ValueError(f"refine must be >= 1, got {refine}")
            kc = min(refine * k, self.n)
            cand = self.search(Q, kc, mesh=mesh, nprobe=nprobe,
                               precision=precision)
            # Belt and braces on the sentinel contract: a +inf first-stage
            # slot must never reach the reranker with a real id (the exact
            # rerank would resurrect a tombstoned row at a finite distance).
            cand_ids = np.where(np.isfinite(np.asarray(cand.dists)),
                                np.asarray(cand.ids), -1)
            return rerank(self.refine, Q, cand_ids, k)
        if nprobe is not None and nprobe != 0:
            if self.ivf is None:
                raise ValueError("nprobe given but no IVF partition; call "
                                 "build_ivf() first")
            if mesh is not None:
                raise ValueError("IVF search is a host serving path; "
                                 "mesh sharding applies to exhaustive scans")
            nprobe = int(nprobe)
            if nprobe < 1:
                raise ValueError(f"nprobe must be >= 1, got {nprobe}")
            return self._search_ivf(Q, k, nprobe)
        model = self.model
        if mesh is not None:
            from local_search_quantization.parallel import query as pq_mod

            B = self.B
            dev_m = self._mesh_scan_state(mesh)
            if self.additive:
                Qr = Q @ np.asarray(model.R, np.float32) \
                    if self.method == "chainq" else Q
                return pq_mod.sharded_linscan_lsq(
                    mesh, B, Qr, model.C, self._dbn, k, precision=precision,
                    device_state=dev_m)
            R = model.R if self.method == "opq" else None
            return pq_mod.sharded_linscan_pq(
                mesh, B, Q, model.C_sub, k, R=R, extra=self._extra,
                precision=precision, device_state=dev_m)
        dev = self._device_scan_state()
        if self.additive:
            R = np.asarray(model.R) if self.method == "chainq" else None
            return adc.linscan_lsq(self.B, Q, model.C, self._dbn, k=k, R=R,
                                   precision=precision, device_state=dev)
        if self.method == "opq":
            return adc.linscan_opq(self.B, Q, model.C_sub, model.R, k=k,
                                   extra=self._extra, precision=precision,
                                   device_state=dev)
        return adc.linscan_pq(self.B, Q, model.C_sub, k=k,
                              extra=self._extra, precision=precision,
                              device_state=dev)

    def add(self, X) -> list[int]:
        """Encode X with the frozen model and append; returns assigned ids.

        Batches pad to the next power of two so repeated adds reuse a few
        compiled encode programs instead of one per distinct batch size.
        """
        import jax

        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.d:
            raise ValueError(f"vectors must be [n, {self.d}], got {X.shape}")
        nreal = X.shape[0]
        p = 8
        while p < nreal:
            p *= 2
        Xp = X if p == nreal else np.concatenate(
            [X, np.repeat(X[:1], p - nreal, axis=0)])
        model = self.model
        if self.method == "pq":
            from local_search_quantization.models.pq import quantize_pq

            Bn = np.asarray(quantize_pq(Xp, model.C_sub))
        elif self.method == "opq":
            from local_search_quantization.models.opq import quantize_opq

            Bn = np.asarray(quantize_opq(Xp, model.R, model.C_sub))
        elif self.method == "chainq":
            from local_search_quantization.ops import viterbi

            Bn = np.asarray(viterbi.viterbi_encode(
                Xp @ np.asarray(model.R, np.float32), model.C))
        elif self.method == "rvq":
            from local_search_quantization.models.rvq import quantize_rvq

            Bn = np.asarray(quantize_rvq(Xp, model.C))
        else:  # lsq: ILS from random codes at the build's round count
            from local_search_quantization.ops import icm
            from local_search_quantization.utils.synth import random_codes

            m, h = self.meta["m"], self.meta["h"]
            # Encode key from a persistent monotone counter, not self.n:
            # after delete + compact + add, n can revisit an old value and
            # PRNGKey(n) would repeat a key (determinism footgun). The
            # counter is persisted in meta so reload continues the
            # sequence rather than restarting it.
            seq = int(self.meta.get("add_seq", 0))
            self.meta["add_seq"] = seq + 1
            key = jax.random.PRNGKey(seq)
            if nreal > (1 << 16):
                # Large batch: stream through encode_chunked like build()
                # — a whole-batch ils_encode would materialize the
                # [n, m, h] unary table (~7.5 GB f32 at 1M x 7 x 256),
                # and the power-of-two padding would up-to-double the
                # encode work. encode_chunked pads only the tail chunk.
                B0 = random_codes(seq, X.shape[0], m, h)
                enc = icm.encode_chunked(
                    key, X, B0, model.C,
                    ilsiter=self.meta.get("ilsiter") or 16, icmiter=4,
                    npert=min(4, m), randord=True)
            else:
                B0 = random_codes(seq, Xp.shape[0], m, h)
                enc = icm.ils_encode(
                    key, Xp, B0, model.C,
                    ilsiter=self.meta.get("ilsiter") or 16, icmiter=4,
                    npert=min(4, m), randord=True)
            Bn = np.asarray(enc.B)
        Bn = Bn[:nreal]
        bn = None
        if self.additive:
            from local_search_quantization.ops import norms

            bn = np.asarray(norms.quantize_norms(Bn, model.C, self._cbnorms))
        n0 = self._append_rows(Bn, bn)
        if self.refine is not None:
            self.refine.append(X)  # frozen affine params, real rows only
        return list(range(n0, n0 + nreal))

    def delete(self, ids) -> int:
        """Tombstone rows in O(1): their distance term becomes +inf, so no
        scanner can return them; ids stay stable."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise ValueError(f"delete ids out of range [0, {self.n})")
        self._tomb[ids] = True
        if self.additive:
            self._dbn[ids] = np.inf
        else:
            if self._extra_buf is None:
                self._extra_buf = np.zeros(self._B_buf.shape[0], np.float32)
            self._extra[ids] = np.inf
        if self.ivf is not None:
            self.ivf.tombstone(ids)  # mirror into the grouped store
        self._scan_ver += 1
        return int(ids.size)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows, renumbering the survivors densely.

        Returns old_of_new [active] int64 — old_of_new[j] is the previous
        id of the row now serving as id j (the caller's handle for
        remapping any external id references). Frees the tombstones'
        memory and scan work; ids are NOT stable across a compact.

        An IVF partition is renumbered in place (list assignments are
        preserved; only the dropped rows leave their segments), so
        compaction does not cost a coarse-quantizer rebuild.
        """
        keep = ~self._tomb
        if self.refine is not None:
            self.refine.take(keep)
        if self.ivf is not None:
            new_of_old = np.full(self.n, -1, np.int64)
            new_of_old[keep] = np.arange(int(keep.sum()))
            self.ivf.compact(new_of_old[: self.ivf.n_grouped])
        old_of_new = np.flatnonzero(keep)
        self._B_buf = np.ascontiguousarray(self.B[keep])
        if self.additive:
            self._bnorm_buf = self._bnorm[keep].copy()
            self._dbn_buf = np.ascontiguousarray(self._dbn[keep])
        else:
            self._extra_buf = None  # all survivors live: no carrier needed
        self._num = self._B_buf.shape[0]
        self._tomb_buf = np.zeros(self._num, bool)
        self.meta["n"] = self.n
        self._scan_ver += 1
        return old_of_new
