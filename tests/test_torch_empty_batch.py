"""An empty query batch on every route and entry point, against the JAX
package.

The JAX engine answers ``[0, k']`` ids and distances to ``Q = 0`` queries;
``Pipeline.query([])`` is ``[]`` and ``Pipeline.evaluate(0, k)`` reports
zeros. The port must do the same: each route returns its empty result before
it tiles the batch (``global``, ``rescore``, ``f32cert``), and so do
``oracle_topk``, ``search_device``, ``search_stream`` and the pipeline.
"""

import os

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import SearchConfig as JaxSearchConfig
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu_torch.config import SearchConfig
from better_search_rag_rust_tpu_torch.ops import topk as port_topk
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from test_torch_search import both_stores

ROWS, DIM, K = 4096, 64, 10
ROUTES = [("global", "bfloat16"), ("global", "float32"),
          ("rescore", "bfloat16"), ("rescore", "float32"),
          ("f32cert", "float32")]


@pytest.fixture(scope="module")
def stores(mesh1):
    mat = np.random.default_rng(4).standard_normal((ROWS, DIM)).astype(
        np.float32)
    return {dt: both_stores(mesh1, mat, dt) for dt in ("bfloat16", "float32")}


def _engines(stores, kernel, dtype):
    js, ps = stores[dtype]
    jax_engine = JaxEngine(js, JaxSearchConfig(top_k=K, kernel=kernel))
    port = SearchEngine(ps, SearchConfig(top_k=K, kernel=kernel,
                                         store_dtype=dtype))
    return jax_engine, port


@pytest.mark.parametrize("kernel,dtype", ROUTES)
def test_search_on_empty_batch_matches_jax(stores, kernel, dtype):
    jax_engine, port = _engines(stores, kernel, dtype)
    empty = np.zeros((0, DIM), np.float32)
    j_ids, j_d = jax_engine.search(empty, K)
    assert port.kernel_name(K) == kernel
    ids, dists = port.search(empty, K)
    assert ids.shape == np.asarray(j_ids).shape == (0, K)
    assert dists.shape == np.asarray(j_d).shape == (0, K)
    assert ids.dtype == np.int64 and dists.dtype == np.float32
    o_ids, o_d = port.oracle_topk(empty, K)
    j_o_ids, _ = jax_engine.oracle_topk(empty, K)
    assert o_ids.shape == np.asarray(j_o_ids).shape == o_d.shape == (0, K)


@pytest.mark.parametrize("kernel,dtype", ROUTES)
def test_entry_points_on_empty_batch(stores, kernel, dtype):
    """``search_device``, ``search_async``/``collect`` and a stream that
    carries an empty batch between two full ones."""
    _jax, port = _engines(stores, kernel, dtype)
    empty = np.zeros((0, DIM), np.float32)
    queries = np.asarray(stores[dtype][0].data, np.float32)[:5, :DIM]
    vals, ids = port.search_device(port.prepare_device_queries(empty), K)
    assert vals.shape == ids.shape == (0, K)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64
    assert port.collect(port.search_async(empty, K))[0].shape == (0, K)
    want = port.search(queries, K)
    got = list(port.search_stream([queries, empty, queries], K, depth=2))
    assert [g[0].shape for g in got] == [(5, K), (0, K), (5, K)]
    for g in (got[0], got[2]):
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[1], want[1])


@pytest.mark.parametrize("route", ["global", "rescore", "f32cert"])
def test_route_functions_return_empty_before_tiling(stores, route):
    _js, ps = stores["float32"]
    q = torch.zeros((0, DIM), dtype=torch.float32)
    if route == "global":
        vals, ids = port_topk.global_topk(ps.data, q, K, ps.num_rows, 256)
    elif route == "rescore":
        vals, ids = port_topk.rescore_topk(ps.data, q, K, ps.num_rows,
                                           q_tile=512, block=128,
                                           sub_block=64)
    else:
        vals, ids = port_topk.rescore_f32_certified(ps.data, q, K,
                                                    ps.num_rows)
    assert vals.shape == ids.shape == (0, K)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int64


def test_pipeline_query_and_evaluate_on_empty_batch(tmp_path):
    from better_search_rag_rust_tpu import config as jc
    from better_search_rag_rust_tpu.pipeline import Pipeline as JaxPipeline
    from better_search_rag_rust_tpu_torch import config as pc
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline

    src = tmp_path / "src"
    src.mkdir()
    for i in range(40):
        (src / f"F{i}.java").write_text(f"class F{i} {{ tok{i} tok{i * 7} }}")

    def cfg(m, skip):
        return m.PipelineConfig(
            corpus=m.CorpusConfig(root=str(src), extensions=("java",)),
            encoder=m.EncoderConfig(backend="hash", dim=64),
            store=m.StoreConfig(dir=os.fspath(tmp_path / "st")),
            search=m.SearchConfig(top_k=5), skip_process=skip)

    Pipeline(cfg(pc, False), device="cpu").run()
    port = Pipeline(cfg(pc, True), device="cpu")
    jax_pipe = JaxPipeline(cfg(jc, True))
    assert port.query([]) == jax_pipe.query([]) == []
    want = jax_pipe.evaluate(0, 5)
    assert want == {"num_queries": 0, "k": 5, "mrr": 0, "recall_at_k": 0,
                    "oracle_overlap": 0}
    assert port.evaluate(0, 5) == want
