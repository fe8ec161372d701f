"""The port's serve-mode pipeline and CLI on a store the JAX package built.

Four ingest shards are written with the reference's ParquetVectorStore and
merged with its merge_vector_stores; the port then serves that store.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from better_search_rag_rust_tpu.config import (
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.pipeline import Pipeline as JaxPipeline
from better_search_rag_rust_tpu.store import vectorstore as jvs
from better_search_rag_rust_tpu.utils.testing import mock_embeddings
from better_search_rag_rust_tpu_torch.pipeline import Pipeline
from better_search_rag_rust_tpu_torch.store import vectorstore as pvs

REPO = Path(__file__).resolve().parents[1]
DIM = 64
SHARD_ROWS = (700, 0, 1300, 1000)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("vstore")
    for shard, n in enumerate(SHARD_ROWS):
        s = jvs.local_store(d, shard)
        if n:
            s.append_many(mock_embeddings(n, DIM, seed=shard))
        s.persist()
    jvs.merge_vector_stores(len(SHARD_ROWS), d).persist()
    return d


def _cfg(store_dir, **search):
    return PipelineConfig(
        store=StoreConfig(dir=str(store_dir)),
        search=SearchConfig(top_k=10, query_idx=1234, **search),
        skip_process=True,
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_run_matches_jax_pipeline(store_dir, mesh1, dtype):
    cfg = _cfg(store_dir, store_dtype=dtype)
    result = Pipeline(cfg, device="cpu").run()
    assert (result.mrr, result.recall, result.overlap) == (1.0, 1.0, 1.0)
    assert result.num_vectors == sum(SHARD_ROWS) and result.ingest is None
    assert "BENCHMARK REPORT" in result.report
    ref = JaxPipeline(cfg, mesh=mesh1).run()
    assert [i for i, _ in result.top_k] == [i for i, _ in ref.top_k]
    np.testing.assert_allclose([d for _, d in result.top_k],
                               [d for _, d in ref.top_k], atol=1e-5)


def test_evaluate(store_dir):
    p = Pipeline(_cfg(store_dir), device="cpu")
    report = p.evaluate(num_queries=32, k=20)
    assert report["mrr"] == report["recall_at_k"] == 1.0
    assert report["oracle_overlap"] == 1.0
    assert report["num_queries"] == 32.0 and report["k"] == 20.0


def test_partial_merge_refused(store_dir, tmp_path):
    d = tmp_path / "partial"
    s = jvs.local_store(d, 0)
    s.append_many(mock_embeddings(50, DIM, seed=1))
    s.persist()
    jvs.merge_vector_stores(2, d, allow_partial=True).persist()
    with pytest.raises(RuntimeError, match="partial merge"):
        Pipeline(_cfg(d), device="cpu").engine()
    cfg = _cfg(d).replace(allow_partial_merge=True)
    assert Pipeline(cfg, device="cpu").engine().store.num_rows == 50


def test_unported_phases_raise(store_dir, tmp_path, capsys):
    """Serving, update, the f32cert route and --profile-dir are ported
    (tests/test_torch_serve.py, tests/test_torch_f32cert.py,
    tests/test_torch_bench.py); the scan routes are not, and raise.
    ``--profile-dir`` on ``search`` writes its trace."""
    from better_search_rag_rust_tpu_torch import cli

    for kernel in ("scan", "blockmax"):
        p = Pipeline(_cfg(store_dir, kernel=kernel), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            p.engine().search(np.ones((1, DIM), np.float32), 5)
    trace_dir = tmp_path / "trace"
    assert cli.main(["search", "--store-dir", str(store_dir), "--device",
                     "cpu", "--profile-dir", str(trace_dir)]) == 0
    assert "MRR=1.0000" in capsys.readouterr().out
    assert len(list(trace_dir.glob("trace_*.json"))) == 1


def test_default_device_is_the_card(store_dir, monkeypatch):
    """``device=None`` means CUDA and raises without a card — the pipeline
    never picks the CPU on its own; the CLI fails the same way."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(_cfg(store_dir))
    assert Pipeline(_cfg(store_dir), device="cpu").device.type == "cpu"
    from better_search_rag_rust_tpu_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["search", "--store-dir", str(store_dir)])


def test_reader_bitwise_equals_reference(store_dir):
    path = pvs.global_store_path(store_dir)
    assert path == jvs.global_store_path(store_dir)
    n = pvs.parquet_row_count(path)
    assert n == jvs.parquet_row_count(path) == sum(SHARD_ROWS)
    for off, length in ((0, n), (0, 1), (699, 2), (1999, 1001)):
        a = pvs.read_matrix_slice(path, off, length)
        b = jvs.read_matrix_slice(path, off, length)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    with pytest.raises(IndexError):
        pvs.read_matrix_slice(path, n, 1)
    assert pvs.load_manifest(store_dir) == jvs.load_manifest(store_dir)
    assert pvs.partial_merge_marker(store_dir) == jvs.partial_merge_marker(
        store_dir)


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "better_search_rag_rust_tpu_torch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_cli_search_and_evaluate(store_dir):
    proc = _cli("search", "--store-dir", str(store_dir), "--top-k", "5",
                "--query-idx", "42", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "MRR=1.0000" in proc.stdout and "BENCHMARK REPORT" in proc.stdout
    assert "row       42" in proc.stdout
    proc = _cli("evaluate", "--store-dir", str(store_dir), "--top-k", "5",
                "--num-queries", "16", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert '"oracle_overlap": 1.0' in proc.stdout
