"""Serving in the port — ``Pipeline.serve``, the micro-batcher, the JSONL and
TCP loops, ``update``, hot reload and store snapshots — against the JAX
package on the CPU.

Stores are built with the hash encoder, whose embeddings agree with the JAX
package's to 1e-6 (``tests/test_torch_ingest.py``). The port's pipeline serves
the JAX store's exact bits (``DeviceStore.from_reference``), also after a
reload, because each package normalizing on its own can move a row by an
f32 ulp and, at a lattice rounding boundary, an int8 value (ROADMAP.md,
Queue 3, known difference (a)). Tolerances: on int8 stores the responses are
equal as JSON, distances included (every score is an exact integer dot); on
bf16 stores ids, paths and order are equal and distances agree within 1e-6
(the packages sum f32 scores in different orders).

Every socket and thread join has a timeout, so nothing here can hang.
"""

import io
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.pipeline import MalformedRequest as JaxMalformed
from better_search_rag_rust_tpu.pipeline import Pipeline as JaxPipeline
from better_search_rag_rust_tpu_torch import batcher as pbatcher
from better_search_rag_rust_tpu_torch.batcher import DynamicBatcher
from better_search_rag_rust_tpu_torch.cli import make_tcp_server, serve_loop
from better_search_rag_rust_tpu_torch.ops import _build
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.pipeline import (
    MalformedRequest,
    Pipeline,
    _serve_batch_shape,
)
from better_search_rag_rust_tpu_torch.store import device_cache as dc
from better_search_rag_rust_tpu_torch.store import vectorstore as pvs
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

REPO = Path(__file__).resolve().parents[1]
DIM = 96
TIMEOUT = 60


def _tree(root: Path, n: int) -> None:
    root.mkdir(parents=True)
    for i in range(n):
        (root / f"File{i}.java").write_text(
            f"public class File{i} {{ void method{i}() {{ int v{i * 7}; }} }}")


def _cfg(root, store_dir, dtype="int8", top_k=5, vocab_size=4096, **store):
    return PipelineConfig(
        corpus=CorpusConfig(root=str(root), extensions=("java",),
                            files_per_batch=4),
        encoder=EncoderConfig(backend="hash", dim=DIM, vocab_size=vocab_size,
                              max_tokens=64, batch_size=4),
        store=StoreConfig(dir=str(store_dir), **store),
        search=SearchConfig(top_k=top_k, chunk_rows=256, store_dtype=dtype),
    )


def _build_store(tmp: Path, n_files: int = 12, dtype="int8", **kw):
    root, store_dir = tmp / "repo", tmp / "vstore"
    _tree(root, n_files)
    cfg = _cfg(root, store_dir, dtype, **kw)
    build = Pipeline(cfg, device="cpu")
    build.ingest_shard()
    build.merge()
    return root, cfg.replace(skip_process=True)


def _from_ref(js) -> DeviceStore:
    return DeviceStore.from_reference(np.asarray(js.data), js.num_rows,
                                      js.dim, js.matryoshka_from,
                                      device="cpu")


def _port_on_jax_bits(cfg, jax_pipe) -> Pipeline:
    """A port pipeline that loads (and reloads) the JAX store's bits."""
    pp = Pipeline(cfg, device="cpu")
    pp.load_device_store = lambda: _from_ref(jax_pipe.load_device_store())
    pp.engine(store=_from_ref(jax_pipe.engine().store))
    return pp


# ---------------------------------------------------------------------------
# One scripted request list through both packages
# ---------------------------------------------------------------------------


def _script(malformed, vecs):
    return [
        None,
        {"id": 1, "query": "public class File3 void method3"},
        {"id": "batch", "queries": ["method one", "int v14", "File7"], "k": 2},
        None,
        {"id": 3, "vector": vecs[0].tolist(), "k": 1},
        {"id": 4, "vectors": vecs[1:4].tolist()},
        malformed("Expecting value: line 1 column 1 (char 0)"),
        {"id": 6, "query": "x", "k": True},
        {"id": 7, "vectors": [[1.0, 2.0, 3.0]]},
        {"id": 8, "k": 99, "query": "x"},
        {"id": 9},
        None,
        {"id": 10, "cmd": "reload"},
        {"id": 11, "queries": ["void method5", "public class"]},
        {"id": 12, "vectors": vecs[4:9].tolist(), "k": 3},
    ]


@pytest.fixture(scope="module", params=["int8", "bfloat16"])
def scripted(request, tmp_path_factory, mesh1):
    _root, cfg = _build_store(tmp_path_factory.mktemp("serve"),
                              dtype=request.param)
    jp = JaxPipeline(cfg, mesh=mesh1)
    vecs = np.random.default_rng(5).standard_normal((9, DIM)).astype(
        np.float32)
    want = list(jp.serve(iter(_script(JaxMalformed, vecs)), depth=2))
    return request.param, cfg, jp, vecs, want


def _assert_same_responses(dtype, got, want):
    assert [r.get("id") for r in got] == [r.get("id") for r in want]
    if dtype == "int8":
        assert got == want
        return
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        if "results" not in w:
            assert g == w
            continue
        assert [[(e["path"], e["row"]) for e in q] for q in g["results"]] \
            == [[(e["path"], e["row"]) for e in q] for q in w["results"]]
        np.testing.assert_allclose(
            [e["distance"] for q in g["results"] for e in q],
            [e["distance"] for q in w["results"] for e in q], atol=1e-6,
            rtol=0)


@pytest.mark.parametrize("depth", [1, 3])
def test_serve_matches_jax(scripted, depth):
    dtype, cfg, jp, vecs, want = scripted
    pp = _port_on_jax_bits(cfg, jp)
    got = list(pp.serve(iter(_script(MalformedRequest, vecs)), depth=depth))
    _assert_same_responses(dtype, got, want)
    errors = {r["id"]: r["error"] for r in got if "error" in r}
    assert "malformed JSON" in errors[None]
    assert "k must be a positive integer" in errors[6]
    assert "query dim 3 != store dim 96" in errors[7]
    assert "exceeds the serve-wide top_k" in errors[8]
    assert got[-3] == {"id": 10, "reloaded": True, "rows": 12}
    assert got[0]["results"][0][0]["path"].endswith("File3.java")


def test_serve_through_batcher_matches_jax(scripted):
    dtype, cfg, jp, vecs, want = scripted
    pp = _port_on_jax_bits(cfg, jp)
    with DynamicBatcher(pp.engine(), k=5, window_ms=2.0) as b:
        got = list(pp.serve(iter(_script(MalformedRequest, vecs)), batcher=b))
        assert b.generation == 1 and b.manifest_by_gen[1] is not None
    _assert_same_responses(dtype, got, want)


# ---------------------------------------------------------------------------
# The micro-batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    mat = np.random.default_rng(11).standard_normal((600, 32)).astype(
        np.float32)
    return SearchEngine(DeviceStore.from_host(mat, "int8", device="cpu"),
                        SearchConfig(top_k=10))


def test_batcher_futures_equal_search(engine):
    """24 client threads (more than the cores) with a short switch interval:
    every future equals engine.search of its rows and no count is lost."""
    rng = np.random.default_rng(0)
    mat = engine.effective_store()
    picks = [mat[rng.integers(0, 600, 1 + i % 3).tolist()] for i in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with DynamicBatcher(engine, k=10, window_ms=5.0) as b:
            results = {}

            def client(i):
                results[i] = (picks[i], b.submit(picks[i]))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(24)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
                assert not t.is_alive()
            futures = list(results.values())
    finally:
        sys.setswitchinterval(old)
    assert len(futures) == 24
    for q, fut in futures:
        ids, dists = fut.result(timeout=TIMEOUT)
        want_ids, want_d = engine.search(q, 10)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(dists, want_d)
        assert fut.generation == 0
    rows = sum(q.shape[0] for q in picks)
    assert b.stats.requests == 24
    assert b.stats.queries == b.stats.batched_queries == rows


def test_batcher_coalesces(engine):
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, window_ms=200.0) as b:
        barrier = threading.Barrier(16)
        futs, lock = [], threading.Lock()

        def client(i):
            barrier.wait(TIMEOUT)
            f = b.submit(mat[i])
            with lock:
                futs.append(f)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        for f in futs:
            f.result(timeout=TIMEOUT)
    assert b.stats.requests == 16 and b.stats.batches < 16
    assert b.stats.coalescing() > 1.0


def test_batcher_backpressure_close_and_bad_dim(engine):
    mat = engine.effective_store()
    with DynamicBatcher(engine, k=10, max_batch=2, window_ms=0.0,
                        depth=1) as b:
        futs = [b.submit(mat[i:i + 1]) for i in range(24)]
        with pytest.raises(ValueError, match="query dim"):
            b.submit(np.zeros((1, 7), np.float32))
        for f in futs:
            f.result(timeout=TIMEOUT)
    assert b.stats.batched_queries == 24
    b = DynamicBatcher(engine, k=10, window_ms=500.0)
    fut = b.submit(mat[:1])
    b.close()  # flushes the open window instead of dropping it
    assert fut.done() and fut.result(timeout=0)[0].shape == (1, 10)
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(mat[:1])
    with pytest.raises(RuntimeError, match="closed"):
        b.swap_engine(engine)


def test_batcher_swap_contract_and_memory_refusal(engine, monkeypatch):
    rng = np.random.default_rng(2)
    other = SearchEngine(DeviceStore.from_host(
        rng.standard_normal((64, 32)).astype(np.float32), "int8",
        device="cpu"), SearchConfig(top_k=10))
    wrong = SearchEngine(DeviceStore.from_host(
        rng.standard_normal((64, 16)).astype(np.float32), device="cpu"))
    with DynamicBatcher(engine, k=10, max_batch=8, window_ms=1.0) as b:
        # stores on the CPU: no device limit, the check is skipped
        assert pbatcher._device_bytes_limit((engine.store.data,)) == 0
        with pytest.raises(ValueError, match="dim"):
            b.swap_engine(wrong)
        both = engine.store.data.nbytes + other.store.data.nbytes
        monkeypatch.setattr(pbatcher, "_device_bytes_limit",
                            lambda tensors: both)
        with pytest.raises(RuntimeError, match="double-residency"):
            b.swap_engine(other)
        assert b.engine is engine and b.generation == 0
        assert b.swap_engine(other, force=True) == 1 and b.engine is other
        monkeypatch.setattr(pbatcher, "_device_bytes_limit",
                            lambda tensors: both * 4)
        for i in range(11):
            gen = b.swap_engine(engine if i % 2 else other,
                                manifest=[f"g{i}"])
        assert gen == 12 and set(b.manifest_by_gen) == set(range(4, 13))
        ids, _ = b.submit(other.store.effective_matrix()[5]).result(TIMEOUT)
        assert ids[0, 0] == 5 and b.k == 10
        assert not b.register_manifest(engine, ["x"])  # not the served one
        assert b.register_manifest(other, ["y"]) and \
            b.manifest_by_gen[12] == ["g10"]  # first registration wins


def test_serve_batch_shapes():
    assert [_serve_batch_shape(n) for n in (1, 2, 3, 5, 9, 1024)] == \
        [1, 2, 4, 8, 16, 1024]
    assert _serve_batch_shape(1025) == 2048


# ---------------------------------------------------------------------------
# JSONL and TCP loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    _root, cfg = _build_store(tmp_path_factory.mktemp("loop"))
    return Pipeline(cfg, device="cpu")


def test_jsonl_round_trip(served):
    lines = "\n".join([
        json.dumps({"id": 1, "query": "public class File0"}),
        "",
        "{this is not json",
        json.dumps({"id": 3, "queries": ["a method", "another"], "k": 1}),
    ])
    out = io.StringIO()
    assert serve_loop(served, io.StringIO(lines), out, k=5, depth=2) == 0
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(resp) == 3 and resp[0]["id"] == 1 and "results" in resp[0]
    assert "malformed JSON" in resp[1]["error"]
    assert [len(q) for q in resp[2]["results"]] == [1, 1]
    assert resp[0] == next(iter(served.serve(
        [{"id": 1, "query": "public class File0"}])))


def _client(host, port, reqs):
    with socket.create_connection((host, port), timeout=TIMEOUT) as s:
        f = s.makefile("rw", encoding="utf-8")
        for r in reqs:
            f.write(json.dumps(r) + "\n")
        f.flush()
        s.shutdown(socket.SHUT_WR)
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("window_ms", [0.0, 50.0])
def test_tcp_two_connections(served, window_ms):
    b = (DynamicBatcher(served.engine(), k=5, window_ms=window_ms)
         if window_ms else None)
    server = make_tcp_server(served, "127.0.0.1", 0, k=5, depth=2, batcher=b)
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        reqs_a = [{"id": i, "query": f"method {i}"} for i in range(3)]
        reqs_b = [{"id": "bad"}, {"id": "ok", "queries": ["File1"], "k": 1}]
        out = {}
        threads = [threading.Thread(
            target=lambda n=n, r=r: out.__setitem__(n, _client(host, port, r)))
            for n, r in (("a", reqs_a), ("b", reqs_b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        assert [r["id"] for r in out["a"]] == [0, 1, 2]
        assert "error" in out["b"][0] and "results" in out["b"][1]
        assert out["a"] == list(served.serve(iter(reqs_a)))
        # a synchronous client: one request, wait for its answer, repeat
        with socket.create_connection((host, port), timeout=TIMEOUT) as s:
            f = s.makefile("rw", encoding="utf-8")
            for i in range(2):
                f.write(json.dumps({"id": i, "query": "method one"}) + "\n")
                f.flush()
                assert json.loads(f.readline())["id"] == i
    finally:
        server.shutdown()
        server.server_close()
        if b is not None:
            b.close()


def test_cli_serve_stdio():
    """``serve`` as a subprocess over stdin/stdout, and ``--help``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # the CLI has no vocab flag: the store takes the default vocab
        root, cfg = _build_store(Path(tmp), vocab_size=30528)
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        args = [sys.executable, "-m", "better_search_rag_rust_tpu_torch",
                "serve", "--root", str(root), "--store-dir", cfg.store.dir,
                "--encoder-backend", "hash", "--dim", str(DIM),
                "--max-tokens", "64", "--encode-batch-size", "4",
                "--store-dtype", "float32", "--top-k", "3", "--device", "cpu",
                "--serve-depth", "2"]
        text = (root / "File4.java").read_text()
        lines = [{"id": 1, "query": text}, {"id": 2},
                 {"id": 3, "cmd": "reload"}]
        proc = subprocess.run(
            args, input="".join(json.dumps(r) + "\n" for r in lines),
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        resp = [json.loads(line) for line in proc.stdout.splitlines()]
        assert resp[0]["results"][0][0]["path"].endswith("File4.java")
        assert "error" in resp[1] and resp[2]["reloaded"] is True
        assert "serving 12 rows" in proc.stderr


# ---------------------------------------------------------------------------
# update, reload, snapshots
# ---------------------------------------------------------------------------


def _edit_tree(root: Path, n_files: int) -> None:
    (root / "File5.java").write_text("public class File5 { String xenolith; }")
    (root / "File0.java").unlink()
    (root / "Fresh.java").write_text("class Fresh { int meteorite; }")
    # touched, same content: an identity refresh, no re-embed
    os.utime(root / f"File{n_files - 1}.java",
             ns=(time.time_ns(), time.time_ns() + 10**9))


def test_update_then_reload(tmp_path):
    root, cfg = _build_store(tmp_path, n_files=8)
    server = Pipeline(cfg, device="cpu")

    def requests():
        yield {"id": 1, "query": "public class File2 void method2"}
        _edit_tree(root, 8)
        stats = Pipeline(cfg, device="cpu").update()
        assert (stats.rows_reembedded, stats.embeddings,
                stats.rows_deleted) == (1, 1, 1)
        yield {"id": 2, "cmd": "reload"}
        yield {"id": 3, "query": "class File5 String xenolith"}
        yield {"id": 4, "query": "class Fresh int meteorite"}

    resps = list(server.serve(requests(), depth=2))
    assert [r["id"] for r in resps] == [1, 2, 3, 4]
    assert resps[0]["results"][0][0]["path"].endswith("File2.java")
    assert resps[1] == {"id": 2, "reloaded": True, "rows": 8}
    assert resps[2]["results"][0][0]["path"].endswith("File5.java")
    assert resps[3]["results"][0][0]["path"].endswith("Fresh.java")
    assert pvs.global_ahead_marker(cfg.store.dir).exists()
    assert Pipeline(cfg, device="cpu").update().embeddings == 0  # no-op


def test_reload_midupdate_errors_then_heals(tmp_path):
    _root, cfg = _build_store(tmp_path, n_files=6)
    server = Pipeline(cfg, device="cpu")
    good = pvs.load_manifest(cfg.store.dir)

    def requests():
        yield {"id": 1, "query": "public class File2 void method2"}
        # one rename of an update landed, the next not: a manifest shorter
        # than the store, with the marker re-baselined so only the
        # row-count cross-check can catch it
        pvs.manifest_path(cfg.store.dir).write_text(json.dumps(good[:-1]))
        pvs.write_update_commit(cfg.store.dir)
        yield {"id": 2, "cmd": "reload"}
        yield {"id": 3, "query": "public class File3 void method3"}
        pvs.manifest_path(cfg.store.dir).write_text(json.dumps(good))
        pvs.write_update_commit(cfg.store.dir)
        yield {"id": 4, "query": "public class File3 void method3"}
        yield {"id": 5, "cmd": "reload"}

    resps = list(server.serve(requests()))
    assert [r["id"] for r in resps] == [1, 2, 3, 4, 5]
    assert "does not match" in resps[1]["error"]
    assert "retry" in resps[2]["error"]
    assert resps[3]["results"][0][0]["path"].endswith("File3.java")
    assert resps[4] == {"id": 5, "reloaded": True, "rows": 6}


def test_batcher_reload_swaps_for_every_connection(tmp_path):
    root, cfg = _build_store(tmp_path, n_files=8)
    server = Pipeline(cfg, device="cpu")
    with DynamicBatcher(server.engine(), k=5, max_batch=8,
                        window_ms=1.0) as b:

        def conn_a():
            yield {"id": "a1", "query": "public class File2 void method2"}
            _edit_tree(root, 8)
            Pipeline(cfg, device="cpu").update()
            yield {"id": "a2", "cmd": "reload"}
            yield {"id": "a3", "query": "class Fresh int meteorite"}

        ra = list(server.serve(conn_a(), batcher=b))
        assert ra[1] == {"id": "a2", "reloaded": True, "rows": 8}
        assert ra[2]["results"][0][0]["path"].endswith("Fresh.java")
        rb = list(server.serve([{"id": "b1", "query": "File7 method7"}],
                               batcher=b))
        assert rb[0]["results"][0][0]["path"].endswith("File7.java")
        assert b.generation == 1


class _JaxHashModel:
    """The JAX hash encoder behind the port's EncoderService."""

    def __init__(self, enc):
        self.enc = enc

    def encode_tokens_device(self, ids, mask):
        return torch.from_numpy(np.array(self.enc.encode_tokens(ids, mask)))


@pytest.mark.parametrize("encoder", ["shared", "own"])
def test_update_bitwise_jax(tmp_path, mesh1, encoder):
    """The port's update and the JAX package's, on copies of one store dir
    and the same edited tree. With the JAX hash encoder behind both
    ("shared") every file is byte for byte the same: the row edits, the
    compaction, the appends and the writes agree exactly. With each
    package's own encoder the re-embedded and appended rows differ by at
    most 1e-6 (the packages' f32 mean and norm round differently, as in
    tests/test_torch_ingest.py); the kept rows, the manifest, the attrs
    and the ahead marker stay bitwise."""
    root, cfg = _build_store(tmp_path / "base", n_files=10)
    a, b = tmp_path / "jax_copy", tmp_path / "port_copy"
    shutil.copytree(cfg.store.dir, a)
    shutil.copytree(cfg.store.dir, b)
    _edit_tree(root, 10)
    jp = JaxPipeline(cfg.replace(store=StoreConfig(dir=str(a))), mesh=mesh1)
    js = jp.update()
    pp = Pipeline(cfg.replace(store=StoreConfig(dir=str(b))), device="cpu")
    if encoder == "shared":
        pp.encoder.encoder = _JaxHashModel(jp.encoder.encoder)
    ps = pp.update()
    assert (ps.embeddings, ps.rows_reembedded, ps.rows_deleted) == (
        js.embeddings, js.rows_reembedded, js.rows_deleted) == (1, 1, 1)
    names = ["manifest.json", "manifest.attrs.json", "global.parquet.ahead"]
    if encoder == "shared":
        names.append("global.parquet")
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    ma = pvs.read_matrix_slice(a / "global.parquet", 0, 10)
    mb = pvs.read_matrix_slice(b / "global.parquet", 0, 10)
    manifest = json.loads((b / "manifest.json").read_text())
    fresh = [i for i, p in enumerate(manifest)
             if p.endswith(("File5.java", "Fresh.java"))]
    kept = [i for i in range(10) if i not in fresh]
    np.testing.assert_array_equal(ma[kept], mb[kept])
    np.testing.assert_allclose(ma[fresh], mb[fresh], atol=1e-6, rtol=0)
    assert pvs.validate_update_commit(b) is None


def test_snapshot_round_trip_and_fallbacks(tmp_path, monkeypatch):
    _root, cfg = _build_store(tmp_path, n_files=10, use_snapshot=True)
    snap = dc.snapshot_dir(cfg.store.dir)
    first = Pipeline(cfg, device="cpu").engine().store   # writes it
    meta = dc.read_meta(snap)
    assert meta["dtype"] == "int8" and meta["num_rows"] == 10
    assert set(meta["source"]) == {"rows", "bytes", "mtime_ns"}

    def no_parquet(*a, **kw):
        raise AssertionError("loaded from Parquet")

    with monkeypatch.context() as m:
        m.setattr(DeviceStore, "from_parquet", staticmethod(no_parquet))
        again = Pipeline(cfg, device="cpu").engine().store
    assert torch.equal(again.data, first.data) and again.num_rows == 10

    # another dtype: falls back to Parquet and rewrites the snapshot
    bf = Pipeline(cfg.replace(search=SearchConfig(top_k=5,
                                                  store_dtype="bfloat16")),
                  device="cpu").engine().store
    assert bf.dtype == torch.bfloat16
    assert dc.read_meta(snap)["dtype"] == "bfloat16"

    # a stale source (a rewrite the mtime pre-check cannot see): fallback
    path = pvs.global_store_path(cfg.store.dir)
    t = dc.meta_path(snap).stat().st_mtime_ns - 10**9
    os.utime(path, ns=(t, t))
    cfg16 = cfg.replace(search=SearchConfig(top_k=5, store_dtype="bfloat16"))
    calls = []
    real = DeviceStore.from_parquet
    with monkeypatch.context() as m:
        m.setattr(DeviceStore, "from_parquet", staticmethod(
            lambda *a, **kw: calls.append(1) or real(*a, **kw)))
        Pipeline(cfg16, device="cpu").engine()
    assert calls == [1]
    assert dc.read_meta(snap)["source"]["mtime_ns"] == t


def test_build_lock_builds_once(monkeypatch, tmp_path):
    """Threads reaching their first kernel together build and load once."""
    calls = []

    def fake_build_all():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return {name: (tmp_path / f"{name}.so", 0.0, "")
                for name in _build.SOURCES}

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "_LIBRARIES", {})
    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert len(calls) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)
    assert _build.library("attention") is not got[0] and len(calls) == 1


def test_serve_bench_on_cpu():
    """``bench/serve.py`` at a small size: every request answered and equal
    to ``engine.search`` of its query, the reference suite's output keys."""
    import dataclasses

    from better_search_rag_rust_tpu_torch.bench.serve import (
        SUITES,
        run_serve_suite,
    )
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    suite = dataclasses.replace(SUITES["search_1m_int8"], rows=3000, dim=64,
                                top_k=20)
    before = dict(tk.launch_counts)
    res = run_serve_suite(suite=suite, clients=6, requests_per_client=4,
                          outstanding=2, window_ms=5.0, device="cpu")
    assert tk.launch_counts == before  # plain versions on the CPU
    assert res["answered"] == res["requests"] == 24
    assert res["failed"] == res["mismatched"] == 0
    assert res["recall_at_10"] == 1.0 and res["coalescing"] >= 1.0
    assert res["store_dtype"] == "int8" and res["platform"] == "cpu"
    assert {"metric", "value", "unit", "vs_baseline", "single_request_qps",
            "p50_latency_ms", "p99_latency_ms", "clients", "outstanding",
            "upload", "window_ms", "depth", "rows", "dim", "top_k",
            "devices"} <= set(res)
