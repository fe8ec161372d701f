"""Build mode of the port (ingest -> shard -> merge -> search) against the
JAX package, with the hash encoder on a 40-file tree.

Bounds: merged rows within 1e-6 of the JAX package's (one gather and an
f32 mean in either package, summed in another order); manifests, identity
sidecars and ids exactly equal; MRR = recall = overlap = 1.0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import (
    CorpusConfig,
    EncoderConfig,
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.pipeline import Pipeline as JaxPipeline
from better_search_rag_rust_tpu.store import vectorstore as jvs
from better_search_rag_rust_tpu_torch import pipeline as ppipe
from better_search_rag_rust_tpu_torch.pipeline import Pipeline
from better_search_rag_rust_tpu_torch.store import vectorstore as pvs

REPO = Path(__file__).resolve().parents[1]
N_FILES = 40


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """40 seeded Java files of random ``tokN`` words in two directories,
    plus a ``.txt`` file the walk leaves out."""
    root = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(0)
    for i in range(N_FILES):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        body = " ".join(f"tok{rng.integers(0, 5000)}" for _ in range(60))
        (sub / f"F{i}.java").write_text(f"class F{i} {{ {body} }}")
    (root / "b" / "notes.txt").write_text("not java")
    return root


def _cfg(root, store_dir, **kw):
    return PipelineConfig(
        corpus=CorpusConfig(root=str(root), files_per_batch=8),
        encoder=EncoderConfig(backend="hash", dim=64, max_tokens=64,
                              batch_size=8),
        store=StoreConfig(dir=str(store_dir)),
        search=SearchConfig(top_k=10, query_idx=7),
        checkpoint_every_batches=2,
        **kw,
    )


@pytest.fixture(scope="module")
def built(tree, tmp_path_factory):
    """The same tree built by each package into its own store."""
    d = tmp_path_factory.mktemp("stores")
    port = Pipeline(_cfg(tree, d / "port"), device="cpu").run()
    import jax

    from better_search_rag_rust_tpu.parallel import create_mesh

    mesh1 = create_mesh(devices=jax.devices()[:1])
    ref = JaxPipeline(_cfg(tree, d / "jax"), mesh=mesh1).run()
    return d / "port", d / "jax", port, ref, mesh1


def test_run_matches_jax(built):
    port_dir, jax_dir, port, ref, _ = built
    assert (port.mrr, port.recall, port.overlap) == (1.0, 1.0, 1.0)
    assert port.num_vectors == ref.num_vectors == N_FILES
    assert port.ingest.files_found == ref.ingest.files_found == N_FILES
    assert port.ingest.embeddings == N_FILES and port.ingest.failed_batches == 0
    assert [i for i, _ in port.top_k] == [i for i, _ in ref.top_k]
    assert "BENCHMARK REPORT" in port.report
    a = pvs.read_matrix_slice(pvs.global_store_path(port_dir), 0, N_FILES)
    b = jvs.read_matrix_slice(jvs.global_store_path(jax_dir), 0, N_FILES)
    np.testing.assert_allclose(a, b, atol=1e-6)
    for name in ("manifest.json", "manifest.attrs.json", "rank_0.paths.json",
                 "rank_0.attrs.json", "rank_0.progress", "encoder.json"):
        assert json.loads((port_dir / name).read_text()) == json.loads(
            (jax_dir / name).read_text()), name
    manifest = json.loads((port_dir / "manifest.json").read_text())
    assert manifest == sorted(manifest) and len(manifest) == N_FILES
    assert all(m.endswith(".java") for m in manifest)
    assert jvs.validate_update_commit(port_dir) is None
    assert pvs.validate_update_commit(jax_dir) is None


def test_each_package_serves_the_others_store(built):
    port_dir, jax_dir, _, _, mesh1 = built
    rng = np.random.default_rng(1)
    queries = rng.standard_normal((6, 64)).astype(np.float32)
    for store_dir in (port_dir, jax_dir):
        cfg = _cfg("unused", store_dir).replace(skip_process=True)
        p = Pipeline(cfg, device="cpu")
        j = JaxPipeline(cfg, mesh=mesh1)
        pr, jr = p.run(), j.run()
        assert [i for i, _ in pr.top_k] == [i for i, _ in jr.top_k]
        ids, _ = p.engine().search(queries, 10)
        jids, _ = j.engine().search(queries, 10)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        report = p.evaluate(num_queries=16, k=5)
        assert report["oracle_overlap"] == report["mrr"] == 1.0


def test_query_returns_the_file_first(built, tree):
    port_dir, _, _, _, _ = built
    p = Pipeline(_cfg(tree, port_dir).replace(skip_process=True),
                 device="cpu")
    manifest = json.loads((port_dir / "manifest.json").read_text())
    texts = [Path(manifest[i]).read_text() for i in (0, 13, 39)]
    ranked = p.query(texts, k=3)
    assert [r[0][0] for r in ranked] == [manifest[i] for i in (0, 13, 39)]
    assert [r[0][1] for r in ranked] == [0, 13, 39]
    assert all(len(r) == 3 and r[0][2] < 1e-3 for r in ranked)


def test_encoder_drift_warns_when_packages_mix(built, tree, monkeypatch):
    """A store whose encoder.json the JAX package's nomic encoder wrote,
    queried through the port's nomic encoder: the attention names differ
    (``fused`` vs ``torch-fused``), so the query warns, once."""
    from better_search_rag_rust_tpu.models.encoder import (
        create_encoder as jax_create_encoder,
    )

    port_dir = built[0]
    logs = []
    monkeypatch.setattr(ppipe, "host_log", logs.append)
    same = Pipeline(_cfg(tree, port_dir).replace(skip_process=True),
                    device="cpu")
    same.query(["tok1 tok2"], k=1)
    assert not any("WARNING" in m for m in logs)   # hash meta: equal

    enc_cfg = EncoderConfig(backend="nomic", dim=64, num_layers=1,
                            num_heads=4, mlp_dim=64, max_tokens=64,
                            vocab_size=211, batch_size=8)
    cfg = _cfg(tree, port_dir).replace(skip_process=True, encoder=enc_cfg)
    meta = pvs.load_encoder_meta(port_dir)
    pvs.write_encoder_meta(port_dir, jax_create_encoder(enc_cfg).numerics)
    try:
        mixed = Pipeline(cfg, device="cpu")
        mixed.query(["tok1 tok2"], k=1)
        mixed.query(["tok3"], k=1)
    finally:
        pvs.write_encoder_meta(port_dir, meta)
    warnings = [m for m in logs if "encoder numerics differ" in m]
    assert len(warnings) == 1
    assert "'fused', 'torch-fused'" in warnings[0]


def test_failed_batch_is_logged_and_skipped(tree, tmp_path, monkeypatch):
    """One batch whose forward fails is logged and counted; the others are
    stored, and the manifest stays aligned with the rows."""
    logs = []
    monkeypatch.setattr(ppipe, "host_log", logs.append)
    p = Pipeline(_cfg(tree, tmp_path / "fail"), device="cpu")
    real = p.encoder.dispatch
    calls = []

    def flaky(tb, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return real(tb, **kw)

    p.encoder.dispatch = flaky
    stats = p.ingest_shard()
    assert stats.failed_batches == 1 and stats.embeddings == N_FILES - 8
    assert p.merge() == N_FILES - 8
    manifest = json.loads((tmp_path / "fail" / "manifest.json").read_text())
    assert len(manifest) == N_FILES - 8
    assert any("batch 1 failed (8 files): device fault" in m for m in logs)


def test_resume_from_progress_marker(tree, tmp_path, built):
    """A crash after the first checkpoint (2 batches = 16 files) leaves the
    shard behind its corpus; resume embeds only the rest and lands on the
    same store as a clean run, rows past the marker truncated."""
    port_dir = built[0]
    d = tmp_path / "resume"
    cfg = _cfg(tree, d, resume=True)
    p = Pipeline(cfg, device="cpu")
    calls = []
    real = p._embed_paths_pipelined

    def crash_after_first_checkpoint(paths, stats, on_batch, file_offset=0):
        def wrapped(batch_idx, files_through, kept, emb):
            on_batch(batch_idx, files_through, kept, emb)
            if batch_idx == 2:       # checkpointed after batch 1, not 2
                raise KeyboardInterrupt
        calls.append(len(paths))
        return real(paths, stats, wrapped, file_offset)

    p._embed_paths_pipelined = crash_after_first_checkpoint
    with pytest.raises(KeyboardInterrupt):
        p.ingest_shard()
    marker = json.loads((d / "rank_0.progress").read_text())
    assert marker == {"files": 16, "rows": 16}
    p2 = Pipeline(cfg, device="cpu")
    stats = p2.ingest_shard()
    assert stats.files_read == N_FILES - 16 and stats.embeddings == N_FILES
    p2.merge()
    a = pvs.read_matrix_slice(pvs.global_store_path(d), 0, N_FILES)
    b = pvs.read_matrix_slice(pvs.global_store_path(port_dir), 0, N_FILES)
    np.testing.assert_array_equal(a, b)
    assert (json.loads((d / "manifest.json").read_text())
            == json.loads((port_dir / "manifest.json").read_text()))


def test_partial_merge_refused(tree, tmp_path):
    d = tmp_path / "partial"
    p = Pipeline(_cfg(tree, d), device="cpu")
    p.ingest_shard()
    with pytest.raises(FileNotFoundError, match="shard 1 missing"):
        p.merge(num_shards=2)
    cfg = _cfg(tree, d, allow_partial_merge=True)
    assert Pipeline(cfg, device="cpu").merge(num_shards=2) == N_FILES
    assert pvs.partial_merge_marker(d).exists()
    with pytest.raises(RuntimeError, match="partial merge"):
        Pipeline(_cfg(tree, d).replace(skip_process=True),
                 device="cpu").engine()
    # the JAX package refuses the port's partial store the same way
    with pytest.raises(RuntimeError, match="partial merge"):
        JaxPipeline(_cfg(tree, d).replace(skip_process=True)).engine()


def test_ahead_marker_refuses_merge(tree, tmp_path):
    d = tmp_path / "ahead"
    p = Pipeline(_cfg(tree, d), device="cpu")
    p.ingest_shard()
    pvs.global_ahead_marker(d).write_text("{}")
    with pytest.raises(RuntimeError, match="AHEAD"):
        p.merge()
    assert Pipeline(_cfg(tree, d, force_merge=True),
                    device="cpu").merge() == N_FILES
    assert not pvs.global_ahead_marker(d).exists()


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "better_search_rag_rust_tpu_torch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_run_and_ingest(tree, tmp_path):
    common = ["--root", str(tree), "--encoder-backend", "hash", "--dim", "64",
              "--max-tokens", "64", "--top-k", "5", "--device", "cpu"]
    proc = _cli("ingest", "--store-dir", str(tmp_path / "a"), *common)
    assert proc.returncode == 0, proc.stderr
    assert f"ingested {N_FILES} embeddings from {N_FILES} files" in proc.stdout
    proc = _cli("run", "--store-dir", str(tmp_path / "b"), *common)
    assert proc.returncode == 0, proc.stderr
    assert "MRR=1.0000" in proc.stdout and "BENCHMARK REPORT" in proc.stdout
    target = sorted(Path(tree).rglob("*.java"))[5]
    proc = _cli("run", "--store-dir", str(tmp_path / "c"), *common,
                "--query", target.read_text())
    assert proc.returncode == 0, proc.stderr
    first = [ln for ln in proc.stdout.splitlines() if "  1. " in ln]
    assert first and str(target) in first[0]


def test_parquet_io_takes_the_system_allocator(tree, tmp_path):
    """The port's Parquet reads and writes run on Arrow's system memory
    pool: with torch in the process, Arrow's bundled mimalloc pool
    segfaulted now and then in the merge's first read (the CLI runs of
    ``test_cli_run_and_ingest`` and the two-process run of
    ``test_torch_multiprocess.py`` died with -11 under a loaded machine)."""
    import pyarrow as pa

    p = Pipeline(_cfg(tree, tmp_path / "pool"), device="cpu")
    p.ingest_shard()
    assert p.merge() == N_FILES
    assert pa.default_memory_pool().backend_name == "system"
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch, pyarrow as pa\n"
         "from better_search_rag_rust_tpu_torch.store import vectorstore\n"
         f"vectorstore.ParquetVectorStore("
         f"{str(tmp_path / 'pool' / 'global.parquet')!r},"
         " empty=False)\n"
         "print(pa.default_memory_pool().backend_name)"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["system"]
