"""End-to-end build_index.py -> serve.py pipeline (subprocess, CPU).

Covers the production split the reference lacks: build once, serve from a
long-lived process over a JSON-lines protocol. Parity is asserted against
a direct in-process adc call on the same index files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(tmp_path, method):
    out = str(tmp_path / f"idx_{method}")
    subprocess.run(
        [sys.executable, "scripts/build_index.py", "--method", method,
         "--out", out, "--dataset", "synthetic", "--synth-d", "16",
         "--ntrain", "400", "--nbase", "1500", "--m", "2", "--h", "16",
         "--niter", "2", "--ilsiter", "2", "--platform", "cpu"],
        cwd=REPO, check=True, capture_output=True, timeout=600,
    )
    return out


def test_scripts_run_from_non_repo_cwd(tmp_path):
    """Regression: scripts must bootstrap sys.path themselves.

    `python scripts/foo.py` puts scripts/ at sys.path[0]; nothing
    pip-installs the package, so without the _bootstrap shim the CLI was
    dead from any fresh shell (round-2 verdict item 1). Run a real tiny
    build from a cwd that is neither the repo nor scripts/.
    """
    out = str(tmp_path / "idx")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "build_index.py"),
         "--method", "pq", "--out", out, "--dataset", "synthetic",
         "--synth-d", "16", "--ntrain", "400", "--nbase", "800",
         "--m", "2", "--h", "16", "--niter", "2", "--platform", "cpu"],
        cwd=str(tmp_path), check=True, capture_output=True, timeout=600,
    )
    assert {"meta.json", "model.npz", "codes.npz"} <= set(os.listdir(out))


@pytest.mark.parametrize("method", ["pq", "lsq"])
def test_build_and_serve(tmp_path, method, rng):
    idx = _build(tmp_path, method)
    assert {"meta.json", "model.npz", "codes.npz"} <= set(os.listdir(idx))

    # Snapshot the as-built index for the parity oracle below — the serve
    # session's "save" op rewrites codes.npz with the mutations.
    from local_search_quantization.utils import checkpoint as ckpt

    model = ckpt.load_model(os.path.join(idx, "model.npz"))
    codes0 = ckpt.load_codes(os.path.join(idx, "codes.npz"))

    p = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    try:
        ready = json.loads(p.stdout.readline())
        assert ready["ready"] and ready["method"] == method and ready["n"] == 1500
        q = rng.normal(120, 30, size=(3, 16)).astype(np.float32)
        p.stdin.write(json.dumps({"id": 1, "vectors": q.tolist()}) + "\n")
        p.stdin.write(json.dumps({"id": 2, "vectors": [[1.0]]}) + "\n")
        p.stdin.write(json.dumps({"id": 3, "bad": "req"}) + "\n")
        p.stdin.write(json.dumps({"id": 4, "vectors": q[:1].tolist(),
                                  "k": 2}) + "\n")
        p.stdin.write("{{{not json\n")
        xnew = rng.normal(130, 25, size=(2, 16)).astype(np.float32)
        p.stdin.write(json.dumps({"op": "add", "id": 6,
                                  "vectors": xnew.tolist()}) + "\n")
        # Probe depth 50, not 5: at m=2, h=16 the codes are 8-bit (256
        # cells for 1502 rows), so the inserted row's own cell can be
        # beaten by a few closer reconstructions and sits inside a tie
        # group that exact (dist, id) ordering breaks against the newest
        # (largest) id — its exact rank shifts with the model stream.
        p.stdin.write(json.dumps({"id": 7, "vectors": xnew[:1].tolist(),
                                  "k": 50}) + "\n")
        p.stdin.write(json.dumps({"op": "delete", "id": 8,
                                  "ids": [1500]}) + "\n")
        p.stdin.write(json.dumps({"id": 9, "vectors": xnew[:1].tolist(),
                                  "k": 50}) + "\n")
        p.stdin.write(json.dumps({"op": "delete", "id": 10,
                                  "ids": [99999]}) + "\n")
        p.stdin.write(json.dumps({"op": "save", "id": 11}) + "\n")
        # Per-request serving precision: bf16 scans the rounded-LUT
        # metric (still exact lexicographic top-k); invalid values are
        # answered as errors, not fatal.
        p.stdin.write(json.dumps({"id": 12, "vectors": q.tolist(),
                                  "precision": "bf16"}) + "\n")
        p.stdin.write(json.dumps({"id": 13, "vectors": q[:1].tolist(),
                                  "precision": "fp8"}) + "\n")
        # "dists": false — the id-only fast response (same ids, no float
        # payload; benchmarks/bench_serve.py pins the overhead win).
        p.stdin.write(json.dumps({"id": 14, "vectors": q.tolist(),
                                  "dists": False}) + "\n")
        p.stdin.write("EOF\n")
        p.stdin.flush()
        (r1, r2, r3, r4, r5, r6, r7, r8, r9, r10, r11, r12, r13, r14) = (
            json.loads(p.stdout.readline()) for _ in range(14))
    finally:
        p.stdin.close()
        assert p.wait(timeout=60) == 0

    assert np.shape(r1["ids"]) == (3, 5)
    for row in r1["dists"]:
        assert row == sorted(row)
    assert "error" in r2 and "error" in r3  # bad requests answered, not fatal
    assert np.shape(r4["ids"]) == (1, 2)
    # Unparseable line: the error must NOT inherit the previous request's id.
    assert "error" in r5 and r5["id"] is None
    # Dynamic insert: consecutive ids assigned, count grows, and a query
    # for the just-inserted vector finds it (deterministic given the seed).
    assert r6["added"] == [1500, 1501] and r6["n"] == 1502
    assert 1500 in r7["ids"][0], r7["ids"]
    # Delete tombstones the row: same query must no longer return it.
    assert r8["deleted"] == 1 and r8["n"] == 1502
    assert 1500 not in r9["ids"][0], r9["ids"]
    assert "error" in r10  # out-of-range delete refused
    assert r11["saved"].endswith("codes.npz")
    # bf16 mode answers post-mutation (1502 rows, id 1500 tombstoned);
    # the rounded metric agrees with f32 on most of a tiny top-5.
    assert np.shape(r12["ids"]) == (3, 5)
    assert 1500 not in np.asarray(r12["ids"]).ravel()
    overlap = np.mean([len(set(a) & set(b)) / 5
                       for a, b in zip(r12["ids"], r1["ids"])])
    assert overlap >= 0.6, (r12["ids"], r1["ids"])
    assert "error" in r13 and "precision" in r13["error"]
    # id-only response: ids present and valid, float payload omitted.
    assert np.shape(r14["ids"]) == (3, 5) and "dists" not in r14
    assert 1500 not in np.asarray(r14["ids"]).ravel()  # tombstone holds

    # The saved index must reload with the insert AND the tombstone intact.
    p2 = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    try:
        ready2 = json.loads(p2.stdout.readline())
        assert ready2["n"] == 1502
        p2.stdin.write(json.dumps({"id": 1, "vectors": xnew[:1].tolist(),
                                   "k": 50}) + "\n")
        p2.stdin.write("EOF\n")
        p2.stdin.flush()
        rr = json.loads(p2.stdout.readline())
        assert 1500 not in rr["ids"][0], rr["ids"]
    finally:
        p2.stdin.close()
        assert p2.wait(timeout=60) == 0

    # Parity of the pre-mutation responses with a direct in-process scan
    # over the as-built index snapshot.
    from local_search_quantization.ops import adc

    if method == "lsq":
        dbn = codes0["cbnorms"][codes0["bnorm"]].astype(np.float32)
        res = adc.linscan_lsq(codes0["B"], q, model.C, dbn, k=5)
    else:
        res = adc.linscan_pq(codes0["B"], q, model.C_sub, k=5)
    np.testing.assert_allclose(
        np.asarray(r1["dists"], np.float32), np.asarray(res.dists),
        rtol=1e-5, atol=1e-5)
    same = (np.asarray(r1["ids"]) == np.asarray(res.ids)).mean()
    assert same > 0.9  # modulo exact-distance ties


def test_serve_binary_frames(tmp_path, rng):
    """Opt-in binary frames: raw <f4 query payloads in, raw <i4/<f4
    response blocks out, byte-parity with the JSON responses, and stream
    resync safety when a framed request fails validation."""
    idx = _build(tmp_path, "pq")
    p = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO,
    )
    rd = p.stdout
    try:
        assert json.loads(rd.readline())["ready"]
        q = rng.normal(120, 30, size=(3, 16)).astype("<f4")

        def send(obj, payload=b""):
            p.stdin.write(json.dumps(obj).encode() + b"\n" + payload)
            p.stdin.flush()

        # Binary request, JSON response.
        send({"id": 1, "binary_vectors": 3}, q.tobytes())
        r1 = json.loads(rd.readline())
        assert np.shape(r1["ids"]) == (3, 5) and "error" not in r1

        # JSON request, binary response (ids + dists blocks).
        send({"id": 2, "vectors": q.tolist(), "binary": True})
        h2 = json.loads(rd.readline())
        assert h2["binary"] == {"ids": "<i4", "dists": "<f4"}
        ids2 = np.frombuffer(rd.read(h2["nq"] * h2["k"] * 4),
                             "<i4").reshape(h2["nq"], h2["k"])
        d2 = np.frombuffer(rd.read(h2["nq"] * h2["k"] * 4),
                           "<f4").reshape(h2["nq"], h2["k"])
        np.testing.assert_array_equal(ids2, np.asarray(r1["ids"]))
        np.testing.assert_allclose(d2, np.asarray(r1["dists"],
                                                  np.float32), rtol=1e-6)

        # Binary both ways, id-only.
        send({"id": 3, "binary_vectors": 3, "binary": True,
              "dists": False}, q.tobytes())
        h3 = json.loads(rd.readline())
        assert h3["binary"]["dists"] is None
        ids3 = np.frombuffer(rd.read(h3["nq"] * h3["k"] * 4),
                             "<i4").reshape(h3["nq"], h3["k"])
        np.testing.assert_array_equal(ids3, ids2)

        # A framed request that FAILS validation (unknown op) must still
        # consume its payload — the next request parses cleanly.
        send({"id": 4, "op": "nope", "binary_vectors": 3}, q.tobytes())
        assert "error" in json.loads(rd.readline())
        send({"id": 5, "vectors": q[:1].tolist(), "k": 2})
        r5 = json.loads(rd.readline())
        assert np.shape(r5["ids"]) == (1, 2), r5

        # Binary add: encodes and appends like the JSON form.
        xnew = rng.normal(130, 25, size=(2, 16)).astype("<f4")
        send({"op": "add", "id": 6, "binary_vectors": 2}, xnew.tobytes())
        r6 = json.loads(rd.readline())
        assert r6["added"] == [1500, 1501] and r6["n"] == 1502

        p.stdin.write(b"EOF\n")
        p.stdin.flush()
    finally:
        p.stdin.close()
        assert p.wait(timeout=60) == 0


def test_serve_binary_frame_fatalities(tmp_path, rng):
    """Malformed binary_vectors counts (negative / non-int / bool) make
    the frame length unknowable: the server answers with an error and
    exits NONZERO (a silent 0-exit would read as a clean shutdown), and
    never blocks in a read-to-EOF deadlock. A truncated frame likewise
    exits 1 with a diagnostic on stderr."""
    idx = _build(tmp_path, "pq")

    def spawn():
        return subprocess.Popen(
            [sys.executable, "scripts/serve.py", "--index", idx,
             "--k", "5", "--platform", "cpu", "--no-warmup"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, cwd=REPO,
        )

    for bad in (-1, "3x", True):
        p = spawn()
        try:
            assert json.loads(p.stdout.readline())["ready"]
            p.stdin.write(json.dumps(
                {"id": 1, "binary_vectors": bad}).encode() + b"\n")
            p.stdin.flush()
            resp = json.loads(p.stdout.readline())
            assert "error" in resp and "binary_vectors" in resp["error"]
            p.stdin.close()
            assert p.wait(timeout=60) == 1, bad
        finally:
            p.kill()

    # Over-cap but WELL-FORMED count: the frame length is computable, so
    # the server drains rather than dying — here the client closes
    # mid-drain, which is a truncation (exit 1, diagnosed), but a
    # cooperating client would get an error response and keep its
    # server. nb == 0 is the in-band-rejected case: error response, the
    # server LIVES and answers the next request.
    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps(
            {"id": 1, "binary_vectors": 10**9}).encode() + b"\n" + b"x" * 64)
        p.stdin.close()
        assert p.wait(timeout=60) == 1
        assert b"draining" in p.stderr.read()
    finally:
        p.kill()

    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        p.stdin.write(json.dumps(
            {"id": 1, "binary_vectors": 0}).encode() + b"\n")
        p.stdin.flush()
        resp = json.loads(p.stdout.readline())
        assert "error" in resp and "out of range" in resp["error"]
        q0 = rng.normal(120, 30, size=(1, 16)).astype("<f4")
        p.stdin.write(json.dumps(
            {"id": 2, "binary_vectors": 1, "k": 3}).encode() + b"\n"
            + q0.tobytes())
        p.stdin.flush()
        r2 = json.loads(p.stdout.readline())
        assert "error" not in r2 and np.shape(r2["ids"]) == (1, 3)
        p.stdin.write(b"EOF\n")
        p.stdin.flush()
        p.stdin.close()
        assert p.wait(timeout=60) == 0
    finally:
        p.kill()

    p = spawn()
    try:
        assert json.loads(p.stdout.readline())["ready"]
        q = rng.normal(120, 30, size=(3, 16)).astype("<f4")
        p.stdin.write(json.dumps(
            {"id": 2, "binary_vectors": 4}).encode() + b"\n" + q.tobytes())
        p.stdin.close()  # truncated: promised 4 rows, sent 3
        assert p.wait(timeout=60) == 1
        assert b"truncated" in p.stderr.read()
    finally:
        p.kill()


def test_serve_mesh_mode(tmp_path, rng):
    """serve.py --mesh N answers through the sharded-mesh route
    (virtual 8-CPU mesh in the subprocess) with id parity against the
    single-device server, and mutations take effect on the very next
    mesh query (the pre-sharded code cache, live on every backend,
    must invalidate; the lifecycle is pinned by
    test_index_mesh_scan_cache_lifecycle)."""
    idx = _build(tmp_path, "pq")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")

    def ask(proc, rid, vecs, k=5):
        proc.stdin.write((json.dumps(
            {"id": rid, "vectors": vecs.tolist(), "k": k}) + "\n"))
        proc.stdin.flush()
        return json.loads(proc.stdout.readline())

    q = rng.normal(120, 30, size=(3, 16)).astype(np.float32)
    p1 = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    p8 = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu", "--mesh", "8"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO,
        env=env)
    try:
        assert json.loads(p1.stdout.readline())["ready"]
        assert json.loads(p8.stdout.readline())["ready"]
        r1 = ask(p1, 1, q)
        r8 = ask(p8, 1, q)
        np.testing.assert_array_equal(np.asarray(r8["ids"]),
                                      np.asarray(r1["ids"]))
        # Second query reuses the pre-sharded cache; same answer.
        r8b = ask(p8, 2, q)
        np.testing.assert_array_equal(np.asarray(r8b["ids"]),
                                      np.asarray(r8["ids"]))
        # Mutation invalidates: the deleted row must vanish immediately.
        victim = int(r8["ids"][0][0])
        p8.stdin.write(json.dumps({"op": "delete", "id": 3,
                                   "ids": [victim]}) + "\n")
        p8.stdin.flush()
        assert json.loads(p8.stdout.readline())["deleted"] == 1
        r8c = ask(p8, 4, q)
        assert victim not in np.asarray(r8c["ids"]).ravel()
        for p in (p1, p8):
            p.stdin.write("EOF\n")
            p.stdin.flush()
            p.stdin.close()
            assert p.wait(timeout=120) == 0
    finally:
        # kill() (not a bare wait) so a mid-body failure can't hang the
        # test on a blocked server and mask the real assertion error.
        for p in (p1, p8):
            p.kill()


def test_serve_protocol_fuzz(tmp_path, rng):
    """Protocol robustness: a long stream of malformed / hostile / valid
    requests must each elicit exactly one well-formed JSON response (a
    result or an error) and must never kill the server — the only
    documented fatal paths are unknowable binary-frame lengths and
    truncated frames, excluded here (covered by
    test_serve_binary_frame_fatalities). Blank lines are ignored, not
    treated as shutdown."""
    import random

    idx = _build(tmp_path, "pq")
    p = subprocess.Popen(
        [sys.executable, "scripts/serve.py", "--index", idx, "--k", "5",
         "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        assert json.loads(p.stdout.readline())["ready"]
        rnd = random.Random(0)
        q = rng.normal(120, 30, size=(2, 16)).astype(np.float32)
        junk_lines = ['{"k":', "nonsense", "[1, 2, 3]", '"a string"',
                      "123", "{}", "null", "true",
                      '{"op": "query"}', '{"op": 5, "vectors": []}']
        hostile_reqs = [
            {"vectors": q.tolist(), "k": -5},
            {"vectors": q.tolist(), "k": 0},
            {"vectors": q.tolist(), "k": 10**9},
            {"vectors": [[1.0, 2.0]]},          # wrong d
            {"vectors": "not-a-matrix"},
            {"vectors": [["x"] * 16]},
            {"vectors": q.tolist(), "nprobe": 4},   # no IVF partition
            {"vectors": q.tolist(), "refine": 4},   # no refine store
            {"vectors": q.tolist(), "precision": "int8"},
            {"op": "frobnicate", "vectors": q.tolist()},
            {"op": "delete", "ids": [-1]},
            {"op": "delete", "ids": "nope"},
            {"op": "add", "vectors": [[1.0]]},
            {"op": "compact"},
        ]
        n_sent = 0
        ok_queries = 0
        for i in range(150):
            roll = rnd.random()
            if roll < 0.1:
                p.stdin.write("\n")  # blank: ignored, no response
                p.stdin.flush()
                continue
            if roll < 0.35:
                line = rnd.choice(junk_lines)
            elif roll < 0.75:
                line = json.dumps({"id": i, **rnd.choice(hostile_reqs)})
            else:
                line = json.dumps({"id": i, "vectors": q.tolist(),
                                   "k": rnd.choice([1, 3, 5])})
            p.stdin.write(line + "\n")
            p.stdin.flush()
            resp = json.loads(p.stdout.readline())  # exactly one line each
            n_sent += 1
            assert isinstance(resp, dict)
            if "error" not in resp and "ids" in resp:
                ok_queries += 1
        assert n_sent > 100 and ok_queries > 10
        # Still healthy after the hostile stream: one clean query.
        p.stdin.write(json.dumps({"id": "final",
                                  "vectors": q.tolist()}) + "\n")
        p.stdin.flush()
        final = json.loads(p.stdout.readline())
        assert final["id"] == "final" and "ids" in final, final
        p.stdin.write("EOF\n")
        p.stdin.flush()
        p.stdin.close()
        assert p.wait(timeout=60) == 0
    finally:
        p.kill()
