"""Library-level Index lifecycle: build / search / add / delete / save / load.

In-process complement to tests/test_serve.py's subprocess coverage; also
exercises the chainq path (norm codebook stored beside the codes, queries
rotated into the code space).
"""

import numpy as np
import pytest

from local_search_quantization.index import Index
from local_search_quantization.utils.synth import synthetic_dataset


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(5, d=16, n_train=400, n_base=1200, n_query=8)


@pytest.mark.parametrize("method", ["pq", "opq", "chainq", "rvq"])
def test_index_lifecycle(tmp_path, data, method, rng):
    idx = Index.build(data.train, data.base, method, m=2, h=16, niter=2,
                      ilsiter=2, seed=0)
    assert idx.n == 1200 and idx.active == 1200 and idx.d == 16

    res = idx.search(data.query, k=10)
    assert res.ids.shape == (8, 10)
    top1 = int(res.ids[0, 0])

    # Insert: the new vector lands in its own code's tie group (8-bit
    # codes here, so ~n/256 rows share it and lower ids win exact ties —
    # a wide k covers the whole group deterministically).
    xnew = rng.normal(120, 25, size=(3, 16)).astype(np.float32)
    added = idx.add(xnew)
    assert added == [1200, 1201, 1202] and idx.n == 1203
    r2 = idx.search(xnew[:1], k=50)
    assert 1200 in np.asarray(r2.ids)[0]

    # Delete both an original row and an added one.
    assert idx.delete([top1, 1200]) == 2
    assert idx.active == 1201
    r3 = idx.search(np.concatenate([data.query[:1], xnew[:1]]), k=50)
    assert top1 not in np.asarray(r3.ids)[0]
    assert 1200 not in np.asarray(r3.ids)[1]
    with pytest.raises(ValueError):
        idx.delete([idx.n])

    # Round-trip: mutations survive save/load; on-disk codes stay int32
    # (the canonical format) even when this CPU host serves uint8.
    path = str(tmp_path / "idx")
    idx.save(path)
    import os

    with np.load(os.path.join(path, "codes.npz")) as z:
        assert z["B"].dtype == np.int32
    idx2 = Index.load(path)
    assert idx2.n == 1203 and idx2.active == 1201
    r4 = idx2.search(xnew[:1], k=50)
    assert 1200 not in np.asarray(r4.ids)[0]
    np.testing.assert_allclose(np.asarray(r3.dists)[1],
                               np.asarray(r4.dists)[0], rtol=1e-5)
    # Re-saving a CPU-host working copy (uint8 codes) must not leak the
    # downgrade to disk: int32 stays the canonical format.
    assert idx2.B.dtype == np.uint8
    idx2.save(path)
    with np.load(os.path.join(path, "codes.npz")) as z:
        assert z["B"].dtype == np.int32

    # Multi-chip serving path: database sharded over the virtual 8-device
    # mesh must agree with the single-chip route (modulo exact-tie order),
    # tombstones included.
    from local_search_quantization.parallel.mesh import data_mesh

    mesh = data_mesh()
    r_mesh = idx.search(np.concatenate([data.query[:1], xnew[:1]]), k=50,
                        mesh=mesh)
    np.testing.assert_allclose(np.asarray(r_mesh.dists),
                               np.asarray(r3.dists), rtol=1e-4, atol=1e-3)
    assert (np.asarray(r_mesh.ids) == np.asarray(r3.ids)).mean() > 0.9
    assert top1 not in np.asarray(r_mesh.ids)[0]
    assert 1200 not in np.asarray(r_mesh.ids)[1]

    # k beyond active rows pads with the (+inf, -1) sentinel.
    idx3 = Index.build(data.train, data.base[:40], method, m=2, h=16,
                       niter=2, seed=0)
    idx3.delete(list(range(30)))
    r5 = idx3.search(data.query[:1], k=40)
    ids = np.asarray(r5.ids)[0]
    assert (ids[:10] >= 30).all() and (ids[10:] == -1).all()

    # Compaction renumbers survivors; results map through old_of_new.
    old_of_new = idx3.compact()
    np.testing.assert_array_equal(old_of_new, np.arange(30, 40))
    assert idx3.n == idx3.active == 10
    r6 = idx3.search(data.query[:1], k=10)
    np.testing.assert_array_equal(old_of_new[np.asarray(r6.ids)[0]],
                                  ids[:10])
    np.testing.assert_allclose(np.asarray(r6.dists)[0],
                               np.asarray(r5.dists)[0, :10], rtol=1e-5)


def test_index_build_sr_production_path(tmp_path, data):
    """The recommended production config (sr='SR-C') must be reachable
    through Index.build / build_index.py, stamped in meta, and serve
    identically in kind to a plain LSQ index."""
    idx = Index.build(data.train, data.base[:300], "lsq", m=2, h=16,
                      niter=2, ilsiter=2, seed=0, sr="SR-C")
    assert idx.meta["sr"] == "SR-C"
    res = idx.search(data.query, k=10)
    assert res.ids.shape == (8, 10)
    assert np.all(np.asarray(res.ids) >= 0)
    path = str(tmp_path / "idx_sr")
    idx.save(path)
    idx2 = Index.load(path)
    assert idx2.meta["sr"] == "SR-C"  # provenance survives the round-trip
    r2 = idx2.search(data.query, k=10)
    np.testing.assert_allclose(np.asarray(res.dists), np.asarray(r2.dists),
                               rtol=1e-5)
    # The knob is training-time-only and LSQ-only: other methods must
    # refuse it loudly rather than silently ignore it.
    with pytest.raises(ValueError, match="LSQ training knob"):
        Index.build(data.train, data.base[:50], "pq", m=2, h=16, sr="SR-C")
    with pytest.raises(ValueError, match="sr must be"):
        Index.build(data.train, data.base[:50], "lsq", m=2, h=16, sr="src")
    # sr_scale without sr is the same silent-no-op class: an sr_scale
    # sweep that forgets sr= would train identical plain-LSQ models.
    with pytest.raises(ValueError, match="sr_scale"):
        Index.build(data.train, data.base[:50], "lsq", m=2, h=16,
                    sr_scale=0.5)


def test_index_search_bf16_precision(data):
    """Index.search(precision='bf16'): the serving fast mode returns the
    exact top-k of the bf16-rounded-LUT metric (ops/adc._run_scan), so
    on continuous data it agrees with f32 almost id-for-id; invalid and
    unsupported combinations must refuse loudly."""
    idx = Index.build(data.train, data.base, "pq", m=2, h=16, niter=2,
                      seed=0)
    r32 = idx.search(data.query, k=10)
    rbf = idx.search(data.query, k=10, precision="bf16")
    assert rbf.ids.shape == (8, 10)
    overlap = np.mean([
        len(set(map(int, a)) & set(map(int, b))) / 10
        for a, b in zip(np.asarray(r32.ids), np.asarray(rbf.ids))
    ])
    assert overlap >= 0.9, overlap
    # The rounded metric's distances differ from f32 by at most the bf16
    # half-ulp envelope (rel ~2^-9 per LUT entry) — not bitwise equal,
    # not grossly off.
    np.testing.assert_allclose(np.asarray(rbf.dists), np.asarray(r32.dists),
                               rtol=2e-2, atol=2e-2)

    with pytest.raises(ValueError, match="precision"):
        idx.search(data.query, k=10, precision="fp8")
    idx.build_ivf(nlist=8)
    with pytest.raises(ValueError, match="bf16"):
        idx.search(data.query, k=10, nprobe=2, precision="bf16")


def test_index_device_scan_cache_lifecycle(data, monkeypatch):
    """The device-code scan cache (GPU serving hot path) must be
    result-transparent and invalidate on every mutation. The gate is
    stubbed on so the lifecycle runs on the CPU suite; routing inside
    adc still picks the CPU path, which accepts device_state."""
    import local_search_quantization.index as index_mod

    idx = Index.build(data.train, data.base, "pq", m=2, h=16, niter=2,
                      seed=0)
    base = idx.search(data.query, k=10)

    monkeypatch.setattr(index_mod, "_scan_cache_enabled", lambda n: True)
    res1 = idx.search(data.query, k=10)
    assert idx._scan_cache is not None
    ver0 = idx._scan_cache[0]
    np.testing.assert_array_equal(np.asarray(res1.ids), np.asarray(base.ids))

    # Cache reused while unmutated.
    idx.search(data.query, k=10)
    assert idx._scan_cache[0] == ver0

    # delete invalidates: the tombstoned row must vanish from results
    # served through a REBUILT cache, not linger in the stale upload.
    victim = int(res1.ids[0, 0])
    idx.delete([victim])
    res2 = idx.search(data.query, k=10)
    assert idx._scan_cache[0] != ver0
    assert victim not in np.asarray(res2.ids)[0]

    # add invalidates and the new rows are searchable.
    n0 = idx.n
    idx.add(data.base[:3])
    res3 = idx.search(data.query, k=idx.n)
    assert np.asarray(res3.ids).max() >= n0

    # compact invalidates and keeps results sane.
    idx.compact()
    res4 = idx.search(data.query, k=10)
    assert victim != -1 and np.asarray(res4.dists).shape == (8, 10)
