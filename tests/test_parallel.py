"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from local_search_quantization.ops import adc, costs, icm, solver
from local_search_quantization.parallel import data_mesh, replicated, shard_batch
from local_search_quantization.parallel.encode import (
    make_lsq_train_step,
    sharded_ils_encode,
    sharded_update_codebooks,
)
from local_search_quantization.parallel.query import sharded_linscan_lsq


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return data_mesh(jax.devices()[:8])


def test_sharded_codebook_update_matches_single(rng, mesh):
    n, d, m, h = 512, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C1 = np.asarray(solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h))
    C8 = np.asarray(
        sharded_update_codebooks(
            mesh, shard_batch(mesh, jnp.asarray(X)), shard_batch(mesh, jnp.asarray(B)), h
        )
    )
    np.testing.assert_allclose(C1, C8, rtol=2e-3, atol=2e-3)


def test_sharded_codebook_update_nondivisible_n(rng, mesh):
    """shard_batch pads by duplicating the last row; n_valid must mask the
    duplicates out of the least-squares or they are double-counted."""
    n, d, m, h = 500, 8, 3, 8  # 500 % 8 != 0 -> 4 duplicated pad rows
    X = rng.normal(size=(n, d)).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    C1 = np.asarray(solver.update_codebooks(jnp.asarray(X), jnp.asarray(B), h))
    C8 = np.asarray(sharded_update_codebooks(
        mesh, shard_batch(mesh, jnp.asarray(X)),
        shard_batch(mesh, jnp.asarray(B)), h, n_valid=n))
    np.testing.assert_allclose(C1, C8, rtol=2e-3, atol=2e-3)
    # Sanity that masking MATTERS here: without it the duplicated rows
    # bias the solve away from the single-chip result.
    C8_biased = np.asarray(sharded_update_codebooks(
        mesh, shard_batch(mesh, jnp.asarray(X)),
        shard_batch(mesh, jnp.asarray(B)), h))
    assert np.abs(C8_biased - C1).max() > np.abs(C8 - C1).max()


def test_sharded_ils_encode_improves_and_runs(rng, mesh):
    n, d, m, h = 512, 8, 3, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.4).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0), jnp.asarray(C)))
    res = sharded_ils_encode(
        mesh,
        jax.random.PRNGKey(0),
        shard_batch(mesh, jnp.asarray(X)),
        shard_batch(mesh, jnp.asarray(B0)),
        replicated(mesh, jnp.asarray(C)),
        ilsiter=2,
        icmiter=2,
        npert=1,
    )
    newcost = np.asarray(res.cost)
    assert (newcost <= cost0 + 1e-3).all()
    assert newcost.mean() < cost0.mean()


def test_lsq_train_step_end_to_end(rng, mesh):
    n, d, m, h = 512, 8, 3, 8
    X = shard_batch(mesh, jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)))
    B = shard_batch(mesh, jnp.asarray(rng.integers(0, h, (n, m), dtype=np.int32)))
    step = make_lsq_train_step(mesh, h, ilsiter=2, icmiter=2, npert=1)
    C, B1, cost1 = step(jax.random.PRNGKey(0), X, B)
    C2, B2, cost2 = step(jax.random.PRNGKey(1), X, B1)
    # EM property: full steps never increase the mean objective.
    assert float(cost2.mean()) <= float(cost1.mean()) * 1.001


def test_sharded_query_matches_single_chip(rng, mesh):
    n, nq, d, m, h = 1024, 16, 8, 3, 8
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    k = 10
    single = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=16,
                             base_block=256)
    multi = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k,
                                query_chunk=16, block=64)
    np.testing.assert_allclose(multi.dists, single.dists, rtol=1e-4, atol=1e-4)
    # ids may differ on exact ties; distances must agree.


def test_sharded_query_bf16_precision_matches_rounded_oracle(rng, mesh):
    """precision='bf16' on the mesh route: sharded_scan_topk rounds the
    LUTs ONCE, so the shard scans return the exact lexicographic top-k of
    the bf16-rounded metric — id-for-id against an f64 oracle over the
    same rounded tables, and id-for-id against the single-device bf16
    route."""
    n, nq, d, m, h = 2048, 8, 8, 3, 8
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    k = 20
    luts = adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C))
    rl = np.asarray(jnp.asarray(luts).astype(jnp.bfloat16).astype(
        jnp.float32), np.float64)
    assert np.any(rl != np.asarray(luts)), "rounding must actually bite"
    full_r = rl[:, np.arange(m)[:, None], B.T].sum(1) + dbn[None, :]
    oracle_ids = np.lexsort(
        (np.broadcast_to(np.arange(n), full_r.shape), full_r), axis=1
    )[:, :k]

    multi = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k,
                                query_chunk=8, block=256, precision="bf16")
    np.testing.assert_array_equal(np.asarray(multi.ids), oracle_ids)
    single = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=8,
                             base_block=256, precision="bf16")
    np.testing.assert_array_equal(np.asarray(single.ids), oracle_ids)
    with pytest.raises(ValueError, match="precision"):
        sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k,
                            precision="fp8")

    # A DIRECT sharded_scan_topk(precision="bf16") call (bypassing the
    # _sharded_linscan driver) must round the LUTs itself.
    from local_search_quantization.parallel.mesh import (
        replicated, shard_cols,
    )
    from local_search_quantization.parallel.query import (
        sharded_scan_topk,
    )

    Bs = shard_cols(mesh, jnp.asarray(np.ascontiguousarray(B.T)))
    es = shard_cols(mesh, jnp.asarray(dbn))
    direct = sharded_scan_topk(
        mesh, replicated(mesh, jnp.asarray(luts)), Bs, es, k,
        block=256, precision="bf16",
    )
    np.testing.assert_array_equal(np.asarray(direct.ids), oracle_ids)


def test_sharded_query_empty_and_custom_axis(rng):
    """nq=0 returns an empty KNNResult (no concatenate crash), and the
    drivers honor a custom mesh axis name end-to-end."""
    from local_search_quantization.parallel.query import sharded_linscan_pq

    mesh_x = data_mesh(jax.devices()[:4], axis="x")
    n, d, m, h = 256, 8, 2, 8
    C_sub = (rng.normal(size=(m, h, d // m)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    empty = sharded_linscan_pq(mesh_x, B, np.empty((0, d), np.float32),
                               jnp.asarray(C_sub), 5, block=64, axis="x")
    assert empty.dists.shape == (0, 5) and empty.ids.shape == (0, 5)
    Q = rng.normal(size=(6, d)).astype(np.float32)
    res = sharded_linscan_pq(mesh_x, B, Q, jnp.asarray(C_sub), 5,
                             query_chunk=4, block=64, axis="x")
    single = adc.linscan_pq(B, Q, jnp.asarray(C_sub), k=5, query_chunk=4,
                            base_block=64)
    np.testing.assert_allclose(res.dists, single.dists, rtol=1e-4, atol=1e-4)


def test_sharded_query_tiny_shards_k_exceeds_shard(rng, mesh):
    """k larger than each shard's valid rows: per-shard results carry -1
    sentinel slots whose ids must NOT be offset into plausible global ids
    (round-1 finding: -1 + idx*shard_n forged non-negative ids)."""
    n, nq, d, m, h = 128, 8, 8, 3, 8
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    k = 50  # > 128/8 = 16 valid rows per shard
    multi = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k,
                                query_chunk=8, block=64)
    single = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k, query_chunk=8,
                             base_block=64)
    ids = np.asarray(multi.ids)
    assert ids.min() >= 0 and ids.max() < n
    np.testing.assert_allclose(multi.dists, single.dists, rtol=1e-4, atol=1e-4)
    # k > n: the surplus slots must be honest sentinels, not forged ids.
    multi2 = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k=200,
                                 query_chunk=8, block=64)
    assert multi2.ids.shape == (nq, n)  # clamped to the true database size
    assert np.asarray(multi2.ids).min() >= 0


def test_graft_entry_single_and_multi():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # Driver path: self-provisions an 8-device virtual CPU platform in a
    # child process (asserting on the parent's single-device backend would
    # fail).
    g.dryrun_multichip(8)


def test_graft_entry_dryrun_inproc(monkeypatch):
    # Harness path: with the marker set and conftest's 8-CPU platform
    # already provisioned, the body runs in-process (no subprocess).
    import __graft_entry__ as g

    monkeypatch.setenv(g._INPROC_MARKER, "1")
    g.dryrun_multichip(8)


def test_sharded_pq_query_matches_single(rng, mesh):
    from local_search_quantization.models import train_pq
    from local_search_quantization.parallel.query import sharded_linscan_pq
    from local_search_quantization.utils.config import PQConfig

    X = rng.normal(size=(400, 16)).astype(np.float32)
    model = train_pq(X, PQConfig(m=4, h=8))
    Q = rng.normal(size=(12, 16)).astype(np.float32)
    k = 7
    single = adc.linscan_pq(np.asarray(model.B), Q, model.C_sub, k=k,
                            query_chunk=16, base_block=128)
    multi = sharded_linscan_pq(mesh, np.asarray(model.B), Q, model.C_sub, k,
                               query_chunk=16, block=64)
    np.testing.assert_allclose(multi.dists, single.dists, rtol=1e-4, atol=1e-4)


def test_tie_heavy_route_parity_exact_ids(rng, mesh):
    """The lexicographic (dist, id) tie contract, pinned ROUTE-FOR-ROUTE:
    on tie-heavy codes (h=4, m=2 -> 16 distinct codes over n=4096, so the
    top-k is a few ~256-way exact-tie blocks straddling the k boundary)
    the single-device streaming merge, the sharded-mesh route, the
    tournament, and the native host scanner (when built) must all return EXACTLY the np.lexsort oracle's ids — this is
    what keeps results reproducible bit-for-bit across serving routes
    (MIGRATION.md "Querying"; the reference's partial_sort leaves tie
    order unspecified, linscan_aqd.cpp:91)."""
    n, nq, d, m, h, k = 4096, 5, 8, 2, 4, 50
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)

    luts = np.asarray(adc.lsq_query_luts(jnp.asarray(Q), jnp.asarray(C)))
    full = luts[:, np.arange(m)[:, None], B.T].sum(1) + dbn[None, :]
    oracle_ids = np.lexsort(
        (np.broadcast_to(np.arange(n), full.shape), full), axis=1
    )[:, :k]

    routes = {
        "merge": adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k,
                                 query_chunk=8, base_block=512,
                                 topk_method="exact"),
        "mesh": sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, k,
                                    query_chunk=8, block=256),
    }
    from local_search_quantization.utils import native

    if native.available():
        routes["native"] = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k,
                                           topk_method="native")
    # The group-minima tournament joins the contract via its
    # certify/rerun phase: on this tie-heavy data the certificate fires on
    # nearly every query, routing through the lex-exact streaming merge.
    routes["tournament"] = adc.linscan_lsq(B, Q, jnp.asarray(C), dbn, k=k,
                                           query_chunk=8, base_block=512,
                                           topk_method="tournament")
    for name, res in routes.items():
        np.testing.assert_array_equal(
            np.asarray(res.ids), oracle_ids,
            err_msg=f"route '{name}' diverged from the lexicographic oracle",
        )


def test_sharded_device_state_matches_fresh_upload(rng, mesh):
    """prepare_sharded_codes + device_state (the mesh serving code
    cache) must be result-identical to the per-call shard/upload, and a
    state built for a different base must be rejected."""
    from local_search_quantization.parallel.query import (
        prepare_sharded_codes, sharded_linscan_lsq,
    )

    n, nq, d, m, h = 1000, 6, 8, 3, 8
    C = (rng.normal(size=(m, h, d)) * 0.5).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    Q = rng.normal(size=(nq, d)).astype(np.float32)
    recon = np.asarray(costs.reconstruct(jnp.asarray(B), jnp.asarray(C)))
    dbn = np.sum(recon * recon, axis=1).astype(np.float32)
    state = prepare_sharded_codes(mesh, B, dbn, block=64)
    # padded to a (nshards * block) multiple, +inf pads
    assert state[0].shape[1] % (8 * 64) == 0
    fresh = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, 10,
                                query_chunk=8, block=64)
    cached = sharded_linscan_lsq(mesh, B, Q, jnp.asarray(C), dbn, 10,
                                 query_chunk=8, block=64,
                                 device_state=state)
    np.testing.assert_array_equal(np.asarray(cached.ids),
                                  np.asarray(fresh.ids))
    np.testing.assert_array_equal(np.asarray(cached.dists),
                                  np.asarray(fresh.dists))
    with pytest.raises(ValueError, match="device_state"):
        sharded_linscan_lsq(mesh, B[:400], Q, jnp.asarray(C), dbn[:400],
                            10, query_chunk=8, block=64,
                            device_state=state)


def test_index_mesh_scan_cache_lifecycle(rng, mesh):
    """Index.search(mesh=...) reuses pre-sharded codes across calls and
    invalidates on mutation — the mesh-serving analog of the
    single-device device cache. The mesh cache is backend-agnostic (no gate stub
    needed: there is no native-scanner alternative under a mesh), so
    this exercises the LIVE cache on the CPU-mesh suite."""
    from local_search_quantization.index import Index
    from local_search_quantization.utils.synth import synthetic_dataset

    data = synthetic_dataset(7, d=16, n_train=400, n_base=1200, n_query=8)
    idx = Index.build(data.train, data.base, "pq", m=2, h=16, niter=2,
                      seed=0)
    base = idx.search(data.query, k=10, mesh=mesh)

    res1 = idx.search(data.query, k=10, mesh=mesh)
    assert idx._mesh_scan_cache is not None
    ver0 = idx._mesh_scan_cache[0]
    np.testing.assert_array_equal(np.asarray(res1.ids), np.asarray(base.ids))
    idx.search(data.query, k=10, mesh=mesh)
    assert idx._mesh_scan_cache[0] == ver0  # reused while unmutated

    victim = int(res1.ids[0, 0])
    idx.delete([victim])
    res2 = idx.search(data.query, k=10, mesh=mesh)
    assert idx._mesh_scan_cache[0] != ver0
    assert victim not in np.asarray(res2.ids)[0]


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_sharded_ils_encode_follows_mesh_route(rng, mesh, monkeypatch,
                                               platform):
    """Sharded encode resolves "auto" through the route of the MESH's
    platform (a GPU mesh runs the matmul conditioning under shard_map),
    and per-vector accept-if-better holds either way."""
    import local_search_quantization.parallel.encode as enc_mod

    seen = []
    inner = enc_mod.ils_encode

    def spy(*a, condition_mode, **kw):
        seen.append(condition_mode)
        return inner(*a, condition_mode=condition_mode, **kw)

    monkeypatch.setattr(enc_mod, "mesh_platform", lambda m: platform)
    monkeypatch.setattr(enc_mod, "ils_encode", spy)
    n, d, m, h = 256, 16, 4, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d)) * 0.3).astype(np.float32)
    B0 = rng.integers(0, h, size=(n, m), dtype=np.int32)
    cost0 = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(B0),
                                     jnp.asarray(C)))
    res = sharded_ils_encode(
        mesh, jax.random.PRNGKey(0),
        shard_batch(mesh, jnp.asarray(X)), shard_batch(mesh, jnp.asarray(B0)),
        replicated(mesh, jnp.asarray(C)), ilsiter=2, icmiter=2, npert=1,
    )
    from local_search_quantization.routes import ROUTES

    assert seen == [ROUTES[platform].condition_mode]
    newcost = np.asarray(costs.veccost(jnp.asarray(X), jnp.asarray(res.B),
                                       jnp.asarray(C)))
    assert (newcost <= cost0 + 1e-3).all()
    assert newcost.mean() < cost0.mean()
    np.testing.assert_allclose(np.asarray(res.cost), newcost, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("path", ["encode", "query"])
def test_mesh_on_unknown_platform_raises(rng, mesh, monkeypatch, path):
    import local_search_quantization.parallel.encode as enc_mod
    import local_search_quantization.parallel.query as q_mod

    n, d, m, h = 64, 8, 2, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    C = (rng.normal(size=(m, h, d))).astype(np.float32)
    B = rng.integers(0, h, size=(n, m), dtype=np.int32)
    with pytest.raises(ValueError, match="no route"):
        if path == "encode":
            monkeypatch.setattr(enc_mod, "mesh_platform", lambda m: "metal")
            sharded_ils_encode(mesh, jax.random.PRNGKey(0), jnp.asarray(X),
                               jnp.asarray(B), jnp.asarray(C), ilsiter=1,
                               icmiter=1, npert=1)
        else:
            monkeypatch.setattr(q_mod, "mesh_platform", lambda m: "metal")
            sharded_linscan_lsq(mesh, B, X[:4], jnp.asarray(C),
                                np.zeros(n, np.float32), 5, block=8)
