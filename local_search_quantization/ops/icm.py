"""Batched iterated-local-search (ILS) + iterated conditional modes (ICM) encoder.

JAX replacement for both the reference's CPU encoder
(/root/reference/src/encodings/encode_icm.jl:4-189) and its CUDA encoder
(/root/reference/src/encodings/encode_icm_cuda.jl, cudautils.cu). The
reference processes one vector per CPU iteration / CUDA block; here every step
is a whole-batch tensor op:

- perturbation: `npert` distinct codebooks per vector re-randomized, via
  counter-based `jax.random` (replaces curand reservoir sampling,
  cudautils.cu:27-80);
- ICM conditioning: `unaries[:, j] + sum_{k!=j} binaries[j, k][B[:, k], :]`
  as [n, h] row-gathers from [h, h] LUTs, then an argmin over h
  (replaces condition_icm3's shared-memory tree reduction,
  cudautils.cu:236-339);
- accept-if-better: exact per-vector `jnp.where` on the squared cost, the
  invariant that makes the encoding objective non-increasing
  (encode_icm.jl:177-186).

The whole ILS loop is one compiled XLA program (`lax.scan` over ILS
iterations). The conditioning step has two XLA formulations, row gathers
and a one-hot matmul; `routes.py` picks one per platform.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from local_search_quantization.ops.luts import get_binaries, get_unaries

Array = jax.Array


class ILSResult(NamedTuple):
    B: Array  # [n, m] int32 codes
    cost: Array  # [n] float32 per-vector squared error


class ILSTrace(NamedTuple):
    """ILS result plus observability extras (reference parity features:
    the GPU encoder's `ilsiters::Vector` milestone API,
    encode_icm_cuda.jl:26,211-222, and the CPU encoder's per-round
    "N new codes are equal / better" prints, encode_icm.jl:179-184)."""

    B: Array  # [n, m] final codes
    cost: Array  # [n] final per-vector cost
    milestone_B: Array | None  # [n_ms, n, m] codes after milestones[i] rounds
    milestone_cost: Array | None  # [n_ms, n]
    frac_better: Array | None  # [ilsiter] fraction of vectors improved/round
    # Fraction of vectors whose PROPOSAL cost equals the previous cost
    # (the reference's `newcost .== prevcost` count, encode_icm.jl:180).
    frac_equal: Array | None  # [ilsiter]


def perturb_codes(key: Array, B: Array, npert: int, h: int) -> Array:
    """Re-randomize `npert` distinct codebook entries of each vector's code.

    Matches the reference's per-vector `sample(1:m, npert, replace=false)` +
    uniform new codes (encode_icm.jl:56-70). Distinct positions are drawn by
    ranking iid uniforms per row — an argsort over m<=16 lanes, negligible.
    """
    n, m = B.shape
    if npert <= 0:
        return B
    kpos, kval = jax.random.split(key)
    # npert distinct positions per row = the npert largest of m iid uniforms
    # (ties have probability 0): a top-k over the tiny m axis, cheaper than
    # argsort + scatter.
    u = jax.random.uniform(kpos, (n, m))
    kth = jax.lax.top_k(u, npert)[0][:, -1:]
    mask = u >= kth
    vals = jax.random.randint(kval, (n, m), 0, h, dtype=B.dtype)
    return jnp.where(mask, vals, B)


def _condition(
    unaries_j: Array, binaries_to_j: Array, B: Array, j: Array
) -> Array:
    """Absorb all pairwise terms into the unary of codebook j.

    The pairwise cost of candidate code c for codebook j given codebook k's
    current code b_k is binaries[k, j][b_k, c], so conditioning is a row
    gather from the (k, j) table — [n] indices into an [h, h] LUT.

    Args:
      unaries_j: [n, h] unary LUT for codebook j.
      binaries_to_j: [m, h, h] pairwise LUTs binaries[:, j] (source k -> j).
      B: [n, m] current codes.
      j: the codebook being updated (traced scalar).

    Returns:
      [n, h] conditioned scores.
    """
    m = B.shape[1]

    def body(k, acc):
        rows = jnp.take(binaries_to_j[k], B[:, k], axis=0)  # [n, h]
        return acc + jnp.where(k == j, 0.0, 1.0) * rows

    return jax.lax.fori_loop(0, m, body, unaries_j)


def _condition_matmul(
    unaries_j: Array, binaries_to_j: Array, B: Array, j: Array
) -> Array:
    """Matmul formulation of the conditioning step.

    The row gather binaries[k, j][B[:, k], :] equals onehot(B[:, k]) @
    binaries[k, j]; summing over k != j makes the whole conditioning ONE
    [n, m*h] x [m*h, h] matmul with a masked one-hot left operand, which
    runs on the tensor cores where per-(j,k) gathers are memory-bound.
    One-hot entries are exact in bf16; the binary LUTs are cast to bf16 (the per-vector
    accept-if-better check still uses exact fp32 costs, so a rounding-induced
    suboptimal ICM proposal can never increase the objective).
    """
    n, m = B.shape
    h = unaries_j.shape[1]
    onehot = jax.nn.one_hot(B, h, dtype=jnp.bfloat16)  # [n, m, h]
    mask = (jnp.arange(m) != j).astype(jnp.bfloat16)
    onehot = onehot * mask[None, :, None]
    cond = jax.lax.dot_general(
        onehot.reshape(n, m * h),
        binaries_to_j.astype(jnp.bfloat16).reshape(m * h, h),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return unaries_j + cond


def cost_from_luts(
    xsq: Array, unaries: Array, binaries: Array, B: Array
) -> Array:
    """Per-vector cost from the MRF decomposition (no reconstruction):

        ||x||^2 + sum_i unaries[n, i, B_i] + sum_{i<j} binaries[i, j, B_i, B_j]

    Mathematically equal to veccost (different fp summation order); much
    cheaper inside the ILS loop where the LUTs already exist — one [n, m]
    take_along + m(m-1)/2 scalar-per-vector gathers, vs rebuilding the
    [m, n, d] reconstruction.
    """
    n, m = B.shape
    h = unaries.shape[-1]
    u = jnp.take_along_axis(unaries, B[:, :, None], axis=2)[:, :, 0]  # [n, m]
    total = xsq + jnp.sum(u, axis=1)
    flat = binaries.reshape(m, m, h * h)
    for i in range(m):
        for j in range(i + 1, m):
            total = total + jnp.take(flat[i, j], B[:, i] * h + B[:, j], axis=0)
    return total


_CONDITION_FNS = {"gather": _condition, "matmul": _condition_matmul}


def resolve_condition_mode(mode: str, platform: str | None = None) -> str:
    """Map "auto" to the platform's conditioning (routes.ROUTES); validate
    an explicit "gather" / "matmul".

    platform: the devices that will RUN the program (e.g. a mesh's
    platform); defaults to jax.devices()[0]'s.
    """
    if mode == "auto":
        from local_search_quantization.routes import platform_route

        return platform_route(platform).condition_mode
    if mode not in _CONDITION_FNS:
        raise ValueError(
            f"condition_mode must be 'auto', 'gather' or 'matmul', got "
            f"{mode!r}")
    return mode


def icm_sweeps(
    B: Array,
    unaries: Array,
    binaries: Array,
    order: Array,
    icmiter: int,
    *,
    condition_mode: str = "gather",
) -> Array:
    """Run `icmiter` full ICM sweeps over the codebooks in `order`.

    Args:
      B: [n, m] codes.
      unaries: [n, m, h].
      binaries: [m, m, h, h] (full symmetric-transpose tensor).
      order: [m] int32 visit order (a permutation; shared across vectors, as
        in the reference's `to_look = randperm(m)`, encode_icm.jl:46-49).
      icmiter: number of sweeps (static).
    """

    cond_fn = _CONDITION_FNS[condition_mode]

    def sweep(B, _):
        def visit(B, j):
            scores = cond_fn(unaries[:, j, :], binaries[:, j], B, j)
            newcodes = jnp.argmin(scores, axis=-1).astype(B.dtype)
            return B.at[:, j].set(newcodes), None

        B, _ = jax.lax.scan(visit, B, order)
        return B, None

    B, _ = jax.lax.scan(sweep, B, None, length=icmiter)
    return B


def ils_encode(
    key: Array,
    X: Array,
    B0: Array,
    C: Array,
    *,
    ilsiter: int,
    icmiter: int,
    npert: int,
    randord: bool = True,
    condition_mode: str = "gather",
    milestones=None,
    with_stats: bool = False,
    nvalid: Array | None = None,
) -> ILSResult | ILSTrace:
    """Encode X against codebooks C with `ilsiter` rounds of perturb+ICM.

    Thin non-jitted wrapper: normalizes `milestones` to a hashable tuple
    (jit static args reject lists) before entering the jitted body.

    nvalid: optional TRACED row count; rows >= nvalid are treated as dead
    padding (their xsq is floored to -1e30 so proposals can never accept)
    and are excluded exactly from the with_stats fractions. Lets
    encode_chunked pad its tail chunk to the compiled shape without
    biasing the reference-parity "% better / % equal" stats.
    """
    return _ils_encode_jit(
        key, X, B0, C, nvalid, ilsiter=ilsiter, icmiter=icmiter,
        npert=npert, randord=randord,
        condition_mode=resolve_condition_mode(condition_mode),
        milestones=tuple(milestones) if milestones else (),
        with_stats=with_stats,
    )


@partial(
    jax.jit,
    static_argnames=(
        "ilsiter", "icmiter", "npert", "randord", "condition_mode",
        "milestones", "with_stats",
    ),
)
def _ils_encode_jit(
    key: Array,
    X: Array,
    B0: Array,
    C: Array,
    nvalid: Array | None = None,
    *,
    ilsiter: int,
    icmiter: int,
    npert: int,
    randord: bool,
    condition_mode: str,
    milestones: tuple,
    with_stats: bool,
) -> ILSResult | ILSTrace:
    """Jitted ILS encode body (see ils_encode).

    Equivalent to `ilsiter` calls of the reference's `encoding_icm`
    (encode_icm.jl:131-189) fused into one compiled program: the unary and
    pairwise LUTs are built once (they depend only on C), and each ILS round
    perturbs, sweeps, and keeps per-vector improvements.

    Args:
      milestones: optional strictly-increasing 1-based round indices; codes
        and costs are snapshotted after each such round in ONE run (the
        reference `ilsiters::Vector` API, encode_icm_cuda.jl:26,211-222) —
        an LSQ-16 and LSQ-32 curve from a single encode.
      with_stats: also return per-round fraction-improved and
        fraction-of-code-entries-changed (the reference's
        "% codes equal / % better" prints, encode_icm.jl:181-184).

    Returns ILSResult(B, cost), or ILSTrace when milestones/with_stats is
    requested. The final cost is guaranteed elementwise <= the cost of B0;
    each milestone cost is likewise <= cost(B0), and costs are
    non-increasing across milestones per vector.
    """
    milestones = tuple(milestones) if milestones else ()
    if milestones:
        assert tuple(sorted(set(milestones))) == milestones, milestones
        assert milestones[-1] <= ilsiter, (milestones, ilsiter)
    h = C.shape[1]
    m = C.shape[0]
    unaries = get_unaries(X, C)  # [n, m, h]
    binaries = get_binaries(C)  # [m, m, h, h]
    xsq = jnp.sum(X * X, axis=-1)
    n_rows = X.shape[0]
    n_dead = None
    if nvalid is not None:
        # Dead-row floor: -1e30 + any real-scale term is -1e30 exactly in f32, so
        # dead rows always propose cost == previous — never accepted, and
        # deterministically counted as "equal" (subtracted below).
        nvalid = jnp.asarray(nvalid, jnp.int32)
        xsq = jnp.where(jnp.arange(n_rows) < nvalid, xsq, -1e30)
        n_dead = (n_rows - nvalid).astype(jnp.float32)
    cost0 = cost_from_luts(xsq, unaries, binaries, B0)

    n_ms = len(milestones)
    ms_rounds = jnp.asarray([r - 1 for r in milestones], jnp.int32)

    def ils_round(carry, inp):
        B, cost, ms_B, ms_cost = carry
        r, key_i = inp
        kperm, kpert = jax.random.split(key_i)
        order = (
            jax.random.permutation(kperm, m)
            if randord
            else jnp.arange(m, dtype=jnp.int32)
        )
        Bp = perturb_codes(kpert, B, npert, h)
        Bp = icm_sweeps(
            Bp, unaries, binaries, order, icmiter, condition_mode=condition_mode
        )
        newcost = cost_from_luts(xsq, unaries, binaries, Bp)
        better = newcost < cost
        B_new = jnp.where(better[:, None], Bp, B)
        cost_new = jnp.where(better, newcost, cost)
        # Reference stats (encode_icm.jl:179-184): counts of vectors whose
        # proposal cost is better / exactly equal, before the accept.
        stats = (
            jnp.mean(better.astype(jnp.float32)),
            jnp.mean((newcost == cost).astype(jnp.float32)),
        )
        if n_ms:
            hit = r == ms_rounds  # [n_ms]
            ms_B = jnp.where(hit[:, None, None], B_new[None], ms_B)
            ms_cost = jnp.where(hit[:, None], cost_new[None], ms_cost)
        return (B_new, cost_new, ms_B, ms_cost), stats

    keys = jax.random.split(key, ilsiter)
    ms_B0 = jnp.broadcast_to(B0[None], (max(n_ms, 1),) + B0.shape)
    ms_c0 = jnp.broadcast_to(cost0[None], (max(n_ms, 1),) + cost0.shape)
    rounds = jnp.arange(ilsiter, dtype=jnp.int32)
    (B, cost, ms_B, ms_cost), (fb, fc) = jax.lax.scan(
        ils_round, (B0, cost0, ms_B0, ms_c0), (rounds, keys)
    )
    if with_stats and n_dead is not None:
        # The scan's per-round stats are means over ALL rows; rescale to
        # valid rows only (dead rows: deterministically not-better, equal).
        denom = jnp.maximum(nvalid.astype(jnp.float32), 1.0)
        fb = fb * n_rows / denom
        fc = jnp.maximum(fc * n_rows - n_dead, 0.0) / denom
    if not milestones and not with_stats:
        return ILSResult(B, cost)
    return ILSTrace(
        B, cost,
        ms_B if milestones else None,
        ms_cost if milestones else None,
        fb if with_stats else None,
        fc if with_stats else None,
    )


def encode_chunked(
    key: Array,
    X,
    B0,
    C: Array,
    *,
    ilsiter: int,
    icmiter: int,
    npert: int,
    randord: bool = True,
    condition_mode: str = "auto",
    chunk: int = 1 << 17,
    encode_fn=None,
    milestones: tuple | None = None,
    with_stats: bool = False,
) -> ILSResult | ILSTrace:
    """ILS-encode a large base set in fixed-size chunks.

    The [n, m, h] unary table dominates memory (n=1M, m=8, h=256 -> 8 GB
    fp32), so big datasets stream through in `chunk`-sized pieces — the same
    capacity trick as the reference GPU encoder's `nsplits`
    (encode_icm_cuda.jl:261-288) but with a single compiled program reused for
    every chunk (the tail chunk is padded to keep shapes static).

    milestones / with_stats behave as in ils_encode (milestone codes are
    stitched across chunks; per-round stats are weighted by chunk size).

    Chunks are dispatched ahead of fetching (up to `max_in_flight` queued
    on device): JAX runs the per-chunk programs back-to-back, overlapping
    each chunk's H2D upload and result D2H with the previous chunk's
    compute. A host sync per chunk would serialize transfers against
    compute; the reference GPU encoder syncs per split
    (encode_icm_cuda.jl:270-288). The in-flight bound caps
    device memory at ~max_in_flight * chunk * d * 4 bytes of queued inputs
    (SIFT1B-scale safe).

    Accepts numpy or JAX arrays; returns host-side ILSResult (or ILSTrace).
    """
    import numpy as np

    milestones = tuple(milestones) if milestones else ()
    n = X.shape[0]
    mode = resolve_condition_mode(condition_mode)
    # The default encoder threads the chunk's valid-row count through so
    # tail-pad rows are dead (exact stats); a custom encode_fn keeps the
    # plain (key, X, B0) signature and sees the padded chunk as-is.
    fn = encode_fn or (
        lambda k, x, b, nv=None: ils_encode(
            k, x, b, C, ilsiter=ilsiter, icmiter=icmiter, npert=npert,
            randord=randord, condition_mode=mode,
            milestones=milestones, with_stats=with_stats, nvalid=nv,
        )
    )
    default_fn = encode_fn is None
    max_in_flight = 4
    pending = []  # (device result, valid rows, padded rows) per chunk

    outB, outcost = [], []
    out_msB = [[] for _ in milestones]
    out_msc = [[] for _ in milestones]
    fb_acc = fc_acc = None
    total = 0

    def drain_one():
        nonlocal fb_acc, fc_acc, total
        res, valid, pad = pending.pop(0)
        outB.append(np.asarray(res.B)[:valid])
        outcost.append(np.asarray(res.cost)[:valid])
        if milestones:
            for s in range(len(milestones)):
                out_msB[s].append(np.asarray(res.milestone_B[s])[:valid])
                out_msc[s].append(np.asarray(res.milestone_cost[s])[:valid])
        if with_stats and res.frac_better is not None:
            # Default-encoder chunks carry exact valid-rows-only fractions
            # (nvalid dead-row accounting in ils_encode) — weight by valid.
            # A custom encode_fn measured the padded chunk, so its
            # fractions are over valid+pad rows and are weighted as such.
            w = valid if default_fn else valid + pad
            fb = np.asarray(res.frac_better) * w
            fc = np.asarray(res.frac_equal) * w
            fb_acc = fb if fb_acc is None else fb_acc + fb
            fc_acc = fc if fc_acc is None else fc_acc + fc
            total += w

    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        xs, bs = np.asarray(X[start:stop]), np.asarray(B0[start:stop])
        pad = chunk - (stop - start) if (stop - start) < chunk and start > 0 else 0
        if pad:
            xs = np.concatenate([xs, np.broadcast_to(xs[-1:], (pad,) + xs.shape[1:])])
            bs = np.concatenate([bs, np.broadcast_to(bs[-1:], (pad,) + bs.shape[1:])])
        key, sub = jax.random.split(key)
        if default_fn:
            res = fn(sub, jnp.asarray(xs), jnp.asarray(bs),
                     jnp.int32(stop - start))
        else:
            res = fn(sub, jnp.asarray(xs), jnp.asarray(bs))
        pending.append((res, stop - start, pad))
        if len(pending) >= max_in_flight:
            drain_one()
    while pending:
        drain_one()

    B = np.concatenate(outB)
    cost = np.concatenate(outcost)
    if not milestones and not with_stats:
        return ILSResult(B, cost)
    msB = np.stack([np.concatenate(x) for x in out_msB]) if milestones else None
    msc = np.stack([np.concatenate(x) for x in out_msc]) if milestones else None
    return ILSTrace(
        B, cost, msB, msc,
        fb_acc / total if fb_acc is not None else None,
        fc_acc / total if fc_acc is not None else None,
    )
