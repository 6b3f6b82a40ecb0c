#!/usr/bin/env python
"""Serve k-NN queries over an index built by scripts/build_index.py.

Thin CLI over `local_search_quantization.index.Index` speaking a
JSON-lines protocol on stdin/stdout. First output line announces
readiness (after the warm-up batch has compiled the query program):

    {"ready": true, "method": "lsq", "n": 1000000, "k": 100}

then one response per request line:

    query:    {"id": 7, "vectors": [[...d floats...], ...], "k": 100,
               "nprobe": 32}
           -> {"id": 7, "ids": [[...k ints...], ...],
               "dists": [[...k floats...], ...]}
              ("dists": false omits the distance payload — JSON float
              serialization dominates the protocol overhead; id-only
              responses cut it ~32% -> ~12% over the direct in-process
              search at k=100, benchmarks/bench_serve.py.

              BINARY FRAMES (opt-in, per request): instead of "vectors",
              send "binary_vectors": N and follow the request line
              immediately with N*d little-endian f32 bytes (row-major).
              "binary": true asks for a binary response: the server
              writes a JSON header line
                  {"id": 7, "nq": N, "k": K,
                   "binary": {"ids": "<i4", "dists": "<f4"|null}}
              followed by N*K*4 bytes of <i4 ids, then (unless
              "dists": false) N*K*4 bytes of <f4 distances. The two
              flags compose freely with JSON on the other side and with
              every query option; "add" also accepts "binary_vectors".
              Rationale: JSON float parse/serialize dominates the
              protocol overhead; the binary frame removes both sides'
              float text entirely.
              (nprobe only with an IVF partition in the index — scan the
              nprobe nearest coarse lists instead of everything; omit or
              0 for the exhaustive scan; --nprobe sets the default.
              "refine": r reranks the top r*k ADC candidates by exact
              distance to the stored original vectors — needs a refine
              store in the index; distances become true squared L2.
              "precision": "bf16" is the rounded serving mode — LUTs
              rounded to bf16 once, exact lexicographic top-k of the
              rounded metric; exhaustive scans only, composes with
              refine; --precision sets the default)
    insert:   {"op": "add", "id": 8, "vectors": [[...], ...]}
           -> {"id": 8, "added": [n0, n0+1, ...], "n": new_total}
              (encodes with the FROZEN trained model — PQ/OPQ subspace
              assignment, ChainQ Viterbi, LSQ ILS at the build's round
              count — and appends; ids are assigned consecutively)
    delete:   {"op": "delete", "id": 9, "ids": [3, 17]}
           -> {"id": 9, "deleted": 2, "n": total}
              (O(1) tombstones: the row's distance term is pinned to +inf
              so it can never be returned; ids stay stable)
    compact:  {"op": "compact", "id": 11} -> {"id": 11, "removed": r,
               "n": new_total}
              (drops tombstoned rows; survivor ids renumber densely IN
               ORDER, so clients can remap from their own delete history)
    persist:  {"op": "save", "id": 10} -> {"id": 10, "saved": ..., "n": ...}
              (writes the mutated codes back to the index directory)
    errors:   {"id": 7, "error": "..."}

Backend routing lives in ops/adc.py (routes.py decides): on a GPU the
device scan over codes cached on the card, on CPU hosts the native
AVX-512 scanner (when built) or the XLA scan. The reference's serving story is the bare C++ linscan
functions (src/linscan/Linscan.jl:5-73); this wraps the same operation as
a long-lived process so compiles/LUT setup are paid once, and adds
dynamic inserts/deletes, which the reference has no analog of at all.
"""

from __future__ import annotations

import argparse
import json
import sys

import _bootstrap  # noqa: F401,E402  (repo-root sys.path shim; see _bootstrap.py)

import numpy as np

# Per-request payload cap for binary frames (bytes, so a fat-d index
# doesn't admit multi-GB requests): over-cap but well-formed requests
# have their frame drained and are answered as errors; only negative /
# non-int counts (unknowable frame length, which would otherwise turn
# the exact-size read into a read-to-EOF mutual deadlock) are fatal.
_MAX_BINARY_BYTES = 512 << 20


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--index", required=True,
                    help="index directory from scripts/build_index.py")
    ap.add_argument("--k", type=int, default=100,
                    help="default neighbors per query (request may override)")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="default IVF probe count; 0 = exhaustive "
                         "(request may override; needs --ivf-nlist at build)")
    ap.add_argument("--refine", type=int, default=0,
                    help="default exact-rerank factor; 0 = off (request may "
                         "override; needs --refine at build)")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="default scan precision; bf16 = rounded-LUT "
                         "serving mode (request may override; exhaustive "
                         "scans only — rejected with nprobe)")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over an N-device data mesh "
                         "(Index.search(mesh=...): per-shard select + "
                         "all-gather merge, pre-sharded codes cached "
                         "across requests); 0 = single-device. "
                         "Exhaustive scans only — nprobe requests are "
                         "answered as errors in mesh mode.")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the compile-triggering dummy batch")
    args = ap.parse_args()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from local_search_quantization.index import Index
    from local_search_quantization.routes import enable_compile_cache

    enable_compile_cache()

    mesh = None
    if args.mesh < 0:
        raise SystemExit(f"--mesh must be >= 0, got {args.mesh}")
    if args.mesh:
        if args.nprobe:
            # Fail fast: every default query would otherwise answer as
            # an error after a healthy-looking "ready" line (IVF is a
            # host serving path; mesh sharding is exhaustive-only).
            raise SystemExit("--mesh and a nonzero --nprobe default are "
                             "incompatible (per-request nprobe still "
                             "answers as an error in mesh mode)")
        from local_search_quantization.parallel.mesh import data_mesh

        devs = jax.devices()[: args.mesh]
        if len(devs) < args.mesh:
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} devices, have "
                f"{len(devs)} (provision with XLA_FLAGS="
                f"--xla_force_host_platform_device_count=N for virtual "
                f"CPU meshes)")
        mesh = data_mesh(devs)

    idx = Index.load(args.index)
    if not args.no_warmup:
        # Warm with the server's DEFAULT precision: a bf16 server must
        # compile its program before "ready", not on the first request.
        idx.search(np.zeros((1, idx.d), np.float32), min(args.k, idx.n),
                   mesh=mesh, precision=args.precision)
    serve(idx, sys.stdin.buffer, sys.stdout.buffer, k=args.k,
          nprobe=args.nprobe, refine=args.refine, precision=args.precision,
          mesh=mesh, path=args.index)


def serve(idx, stdin, stdout, *, k: int = 100, nprobe: int = 0,
          refine: int = 0, precision: str = "f32", mesh=None,
          path: str | None = None) -> None:
    """Answer the protocol's requests from the binary stream `stdin` until
    EOF, writing responses to the binary stream `stdout`. The defaults
    are the server's (--k, --nprobe, --refine, --precision); `path` is
    where "save" writes. Runs in-process, so one JAX process on the card
    can both build an index and serve it (chip_smoke.py does)."""

    def emit(obj, blocks=()):
        stdout.write(json.dumps(obj).encode() + b"\n")
        for b in blocks:
            stdout.write(b)
        stdout.flush()

    def read_exact(nbytes: int) -> bytes:
        buf = stdin.read(nbytes)
        if buf is None or len(buf) != nbytes:
            raise EOFError(
                f"binary payload truncated "
                f"({0 if buf is None else len(buf)}/{nbytes} bytes)")
        return buf

    def parse_vectors(req, frame) -> np.ndarray:
        if frame is not None:
            return np.frombuffer(frame, "<f4").reshape(-1, idx.d)
        return np.asarray(req["vectors"], np.float32)

    emit({"ready": True, "method": idx.method, "n": idx.n, "d": idx.d,
          "k": k,
          "ivf_nlist": idx.ivf.nlist if idx.ivf else None,
          "refine": idx.refine.kind if idx.refine else None})

    while True:
        raw = stdin.readline()
        if not raw:
            break  # stream EOF
        line = raw.decode("utf-8", "replace").strip()
        if not line:
            continue  # stray blank line: ignore, don't shut down
        if line == "EOF":
            break
        req = None  # never attribute errors to the previous request's id
        blocks = ()
        try:
            req = json.loads(line)
            # Consume a declared binary frame IMMEDIATELY — before any op
            # validation can raise — so a bad request (unknown op, wrong
            # k, ...) never leaves unread payload desynchronizing the
            # stream. Only a NON-INT or NEGATIVE count is fatal (the
            # frame length is then unknowable and the stream cannot be
            # resynced); an over-cap but well-formed count has a
            # computable length, so its frame is DRAINED in bounded
            # chunks and the request answered as an error — one buggy
            # client must not take the server down. nb == 0 is rejected
            # too (an [0, d] batch is a fresh jitted shape — a compile
            # stall — and means nothing).
            frame = None
            if req.get("binary_vectors") is not None:
                nb = req["binary_vectors"]
                if (not isinstance(nb, int) or isinstance(nb, bool)
                        or nb < 0):
                    emit({"id": req.get("id"),
                          "error": "ValueError: binary_vectors must be a "
                                   f"non-negative int, got {nb!r}; frame "
                                   "length unknowable — closing the "
                                   "stream"})
                    print(f"serve.py: fatal binary_vectors={nb!r} "
                          "(unknowable frame length)", file=sys.stderr)
                    sys.exit(1)
                nbytes = nb * idx.d * 4
                if nb == 0 or nbytes > _MAX_BINARY_BYTES:
                    while nbytes > 0:  # drain: length IS computable
                        chunk = stdin.read(min(nbytes, 1 << 24))
                        if not chunk:
                            raise EOFError(
                                f"binary payload truncated while "
                                f"draining ({nbytes} bytes short)")
                        nbytes -= len(chunk)
                    raise ValueError(
                        f"binary_vectors={nb} out of range (1 to "
                        f"{_MAX_BINARY_BYTES // (idx.d * 4)} rows at "
                        f"d={idx.d}; {_MAX_BINARY_BYTES >> 20} MB cap)")
                frame = read_exact(nbytes)
            op = req.get("op", "query")
            if op == "delete":
                ndel = idx.delete(req["ids"])
                out = {"id": req.get("id"), "deleted": ndel, "n": idx.n}
            elif op == "compact":
                n0 = idx.n
                idx.compact()
                out = {"id": req.get("id"), "removed": n0 - idx.n,
                       "n": idx.n}
            elif op == "save":
                if path is None:
                    raise ValueError("this server has no index directory "
                                     "to save to")
                saved = idx.save(path)
                out = {"id": req.get("id"), "saved": saved, "n": idx.n}
            elif op == "add":
                added = idx.add(parse_vectors(req, frame))
                out = {"id": req.get("id"), "added": added, "n": idx.n}
            elif op == "query":
                res = idx.search(parse_vectors(req, frame),
                                 int(req.get("k", k)),
                                 mesh=mesh,
                                 nprobe=int(req.get("nprobe", nprobe))
                                 or None,
                                 refine=int(req.get("refine", refine))
                                 or None,
                                 precision=str(req.get("precision",
                                                       precision)))
                want_dists = bool(req.get("dists", True))
                if req.get("binary", False):
                    ids = np.ascontiguousarray(
                        np.asarray(res.ids).astype("<i4"))
                    out = {"id": req.get("id"), "nq": int(ids.shape[0]),
                           "k": int(ids.shape[1]),
                           "binary": {"ids": "<i4",
                                      "dists": "<f4" if want_dists
                                      else None}}
                    blocks = [ids.tobytes()]
                    if want_dists:
                        blocks.append(np.ascontiguousarray(
                            np.asarray(res.dists).astype("<f4")).tobytes())
                else:
                    out = {"id": req.get("id"),
                           "ids": np.asarray(res.ids).tolist()}
                    # "dists": false skips the float payload — JSON float
                    # serialization is the protocol's dominant overhead
                    # (benchmarks/bench_serve.py), and id-only clients
                    # are the common case.
                    if want_dists:
                        out["dists"] = np.asarray(res.dists).tolist()
            else:
                raise ValueError(f"unknown op {op!r}")
        except EOFError as e:
            # Truncated binary frame: the stream cannot resync. Exit
            # loudly — a silent 0-exit here would be indistinguishable
            # from a clean shutdown to the operator.
            print(f"serve.py: fatal {e}", file=sys.stderr)
            sys.exit(1)
        except Exception as e:  # malformed request must not kill the server
            rid = req.get("id") if isinstance(req, dict) else None
            out = {"id": rid, "error": f"{type(e).__name__}: {e}"}
            blocks = ()
        emit(out, blocks)


if __name__ == "__main__":
    main()
