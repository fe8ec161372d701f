"""The certified f32 route of the port (K1 + K4 + K6, dense fallback on K3)
against the JAX package.

The JAX kernels run in interpret mode on the CPU, as tests/test_search.py
runs them; the port's wrappers take their plain PyTorch versions because
the tensors lie on the CPU. Inputs come from numpy seeds and go to both.

* K4 moves bytes: its plain version equals the JAX kernel bit for bit on
  every dtype.
* K6 on dyadic rows (16 entries of +-1/4: every product and sum exact in
  f32) and on the int8 lattice (an exact integer dot times one constant):
  bit for bit; on normal rows within ``TOL`` (the packages sum in other
  orders).
* The route: ids and distances bitwise on dyadic stores; on normal stores
  distances within ``TOL`` and ids equal wherever neighbouring scores are
  more than ``TOL`` apart. Against the port's own oracle likewise. On the
  CPU plain K6 (a batched product) and plain K3 (a matrix product) may sum
  in different orders; on the card they share one FMA chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import (
    PipelineConfig,
    SearchConfig,
    StoreConfig,
)
from better_search_rag_rust_tpu.ops import quantize as jq
from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu_torch.ops import topk as port_topk
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.pipeline import Pipeline
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore
from test_torch_search import TOL, assert_topk_agree, both_stores, dyadic

CERT_ON = SearchConfig(f32_certified="on")


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _bits(x: np.ndarray) -> np.ndarray:
    """Raw bytes of an array (bf16 from either package) for bitwise
    comparison."""
    return np.ascontiguousarray(x).view(np.uint8)


def _store_rows(kind, dtype, rows, dim, seed):
    """(numpy rows for JAX, torch rows for the port) with the same bits."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        mat = jq.quantize_unit_host(_unit(rng.standard_normal((rows, dim))))
        return mat, torch.from_numpy(mat)
    mat = (dyadic(rng, rows, dim) if kind == "dyadic"
           else _unit(rng.standard_normal((rows, dim))))
    mat[20:28] = mat[3]                        # duplicate rows
    if dtype == "bfloat16":
        j = np.asarray(jnp.asarray(mat, jnp.bfloat16))
        t = torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
        return j, t
    return mat, torch.from_numpy(mat)


# -- (a) K4 gather_rows --------------------------------------------------------


@pytest.mark.parametrize("dtype,unit", [
    ("float32", 8), ("float32", 16), ("bfloat16", 16), ("int8", 32),
])
def test_gather_rows_plain_matches_pallas_bitwise(dtype, unit):
    rows, t, ks = 1024, 8, 8
    mat, tmat = _store_rows("normal", dtype, rows, 64, seed=unit)
    rng = np.random.default_rng(unit + 1)
    ids = rng.integers(0, rows // unit, size=(t, ks)).astype(np.int32)
    ids[:, 1] = ids[:, 0]                      # repeated ids
    ids[3] = ids[2]
    out = ref.gather_rows(jnp.asarray(mat), jnp.asarray(ids), unit=unit,
                          cpg=4, interpret=True)
    pout = port.gather_rows(tmat, torch.from_numpy(ids), unit=unit)
    assert pout.shape == (t, ks * unit, 64) and pout.dtype == tmat.dtype
    np.testing.assert_array_equal(_bits(pout.view(torch.uint8).numpy()),
                                  _bits(np.asarray(out)))


def test_gather_rows_out_of_range_fill():
    """An id outside [0, R/unit) gives 0xFF bytes (NaN on a float store)
    and never reads past the store; the other units are the store's."""
    mat = torch.arange(64 * 4, dtype=torch.float32).view(64, 4)
    ids = torch.tensor([[0, -1, 7], [8, 3, 2 ** 31 - 1]], dtype=torch.int32)
    out = port.gather_rows(mat, ids, unit=8).view(2, 3, 8, 4)
    bad = torch.tensor([[False, True, False], [True, False, True]])
    assert torch.isnan(out[bad]).all()
    assert bool((out[bad].view(torch.int32) == -1).all())
    assert torch.equal(out[0, 0], mat[:8]) and torch.equal(out[0, 2], mat[56:])
    assert torch.equal(out[1, 1], mat[24:32])


# -- (b) K6 block_scores -------------------------------------------------------


@pytest.mark.parametrize("kind,dtype", [
    ("dyadic", "float32"), ("dyadic", "bfloat16"), ("normal", "float32"),
    ("normal", "bfloat16"), ("lattice", "int8"),
])
def test_block_scores_plain_matches_pallas(kind, dtype):
    t, c, dim = 8, 256, 64
    mat, tmat = _store_rows(kind, dtype, t * c + 8, dim, seed=3)
    q, tq = mat[:t], tmat[:t].contiguous()
    g, tg = mat[8:].reshape(t, c, dim), tmat[8:].reshape(t, c, dim)
    out = np.asarray(ref.block_scores(jnp.asarray(q), jnp.asarray(g),
                                      interpret=True))
    pout = port.block_scores(tq, tg.contiguous())
    assert pout.shape == (t, c) and pout.dtype == torch.float32
    if kind == "normal":
        np.testing.assert_allclose(pout.numpy(), out, rtol=0, atol=TOL)
    else:
        np.testing.assert_array_equal(pout.numpy(), out)


def test_block_scores_of_gathered_rows_equal_k2_on_dyadic():
    """Plain K6 over plain K4's rows scores the pairs plain K2 scores, bit
    for bit where every sum is exact."""
    mat, tmat = _store_rows("dyadic", "float32", 2048, 64, seed=4)
    tq = tmat[:16].contiguous()
    ids = torch.sort(torch.from_numpy(np.random.default_rng(5).integers(
        0, 2048 // 8, size=(16, 32)).astype(np.int32)), dim=1).values
    rows = port.gather_rows(tmat, ids, unit=8)
    assert torch.equal(port.block_scores(tq, rows),
                       port.gather_rescore(tq, tmat, ids, unit=8))


# -- (c) the route against the JAX engine and the oracle ----------------------


def _cert_matrix(kind):
    """The JAX test's store (tests/test_search.py:989-996) or its dyadic
    twin: 16384 x 64, a duplicate cluster, a zero row."""
    rng = np.random.default_rng(11)
    mat = (dyadic(rng, 16384, 64) if kind == "dyadic"
           else rng.standard_normal((16384, 64)).astype(np.float32))
    mat[9000:9010] = mat[17]
    mat[4096] = 0.0
    return mat, mat[rng.integers(0, 16384, 16)]


@pytest.fixture(scope="module", params=["normal", "dyadic"])
def cert_pair(request, mesh1):
    mat, queries = _cert_matrix(request.param)
    js, ps = both_stores(mesh1, mat, "float32")
    return request.param, js, ps, queries


@pytest.mark.parametrize("k", [1, 10, 100])
def test_route_matches_jax_and_oracle(cert_pair, k):
    kind, js, ps, queries = cert_pair
    j_eng = JaxEngine(js, CERT_ON)
    assert j_eng._resolve_kernel(k) == "f32cert"
    j_ids, j_d = j_eng.search(queries, k=k)
    eng = SearchEngine(ps, CERT_ON)
    assert eng.kernel_name(k) == "f32cert"
    port_topk.reset_cert_counts()
    p_ids, p_d = eng.search(queries, k)
    tiles = dict(port_topk.cert_counts)
    assert sum(tiles.values()) == 1
    if kind == "normal":
        assert tiles["certified"] == 1       # the fast branch answered
    assert_topk_agree(kind, j_ids, j_d, p_ids, p_d)
    o_ids, o_d = eng.oracle_topk(queries, k)
    assert_topk_agree(kind, o_ids, o_d, p_ids, p_d)


def test_route_falls_back_on_duplicate_store():
    """The all-duplicate store of tests/test_search.py:1003-1014: the
    certificate cannot hold (excluded units tie the boundary), the dense
    branch answers, bitwise the oracle's."""
    rng = np.random.default_rng(12)
    dup = np.tile(rng.standard_normal((64, 64)).astype(np.float32), (128, 1))
    eng = SearchEngine(DeviceStore.from_host(dup, "float32", device="cpu"),
                       CERT_ON)
    port_topk.reset_cert_counts()
    ids, dists = eng.search(dup[:8], 10)
    assert port_topk.cert_counts == {"certified": 0, "dense": 1}
    o_ids, o_d = eng.oracle_topk(dup[:8], 10)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(dists, o_d)
    np.testing.assert_array_equal(ids[0], 64 * np.arange(10))


def test_route_refuses_what_it_cannot_certify():
    rng = np.random.default_rng(1)
    mat = rng.standard_normal((1024, 32)).astype(np.float32)
    bf = SearchEngine(DeviceStore.from_host(mat, "bfloat16", device="cpu"),
                      SearchConfig(kernel="f32cert"))
    assert bf.kernel_name(10) == "f32cert"
    with pytest.raises(ValueError, match="f32-only"):
        bf.search(mat[:2], 10)
    f32 = SearchEngine(DeviceStore.from_host(mat, "float32", device="cpu"),
                       SearchConfig(kernel="f32cert"))
    with pytest.raises(ValueError, match="pool too small"):
        f32.search(mat[:2], 120)


# -- (e) routing gates ---------------------------------------------------------


@pytest.mark.parametrize("dtype,cfg,k,route", [
    ("float32", {}, 10, "global"),                        # auto on this backend
    ("float32", {"f32_certified": "off"}, 10, "global"),
    ("float32", {"f32_certified": "on"}, 10, "f32cert"),
    ("float32", {"f32_certified": "on"}, 129, "global"),  # over the budget
    ("bfloat16", {"f32_certified": "on"}, 10, "global"),  # not an f32 store
    ("float32", {"kernel": "f32cert"}, 10, "f32cert"),
    ("float32", {"kernel": "f32cert", "f32_certified": "off"}, 10, "f32cert"),
])
def test_routing_gates_match_jax(mesh1, dtype, cfg, k, route):
    """The gates of tests/test_search.py:1017-1036: the port's kernel_name
    is the JAX engine's _resolve_kernel."""
    rng = np.random.default_rng(13)
    mat = rng.standard_normal((4096, 64)).astype(np.float32)
    js, ps = both_stores(mesh1, mat, dtype)
    config = SearchConfig(**cfg)
    assert JaxEngine(js, config)._resolve_kernel(k) == route
    assert SearchEngine(ps, config).kernel_name(k) == route


# -- (f) every entry point reaches the route ----------------------------------


def test_entry_points_reach_the_route(tmp_path):
    rng = np.random.default_rng(21)
    mat = rng.standard_normal((4096, 32)).astype(np.float32)
    queries = mat[rng.integers(0, 4096, 24)]
    store = DeviceStore.from_host(mat, "float32", device="cpu")
    cfg = SearchConfig(kernel="f32cert", top_k=10, store_dtype="float32")
    eng = SearchEngine(store, cfg)
    ids, dists = eng.search(queries, 10)
    np.testing.assert_array_equal(ids, eng.oracle_topk(queries, 10)[0])
    port_topk.reset_cert_counts()
    np.testing.assert_array_equal(
        eng.collect(eng.search_async(queries, 10))[0], ids)
    for s_ids, s_d in eng.search_stream([queries, queries], 10, depth=2):
        np.testing.assert_array_equal(s_ids, ids)
        np.testing.assert_array_equal(s_d, dists)
    vals, d_ids = eng.search_device(eng.prepare_device_queries(queries), 10)
    np.testing.assert_array_equal(d_ids.numpy(), ids)
    assert port_topk.cert_counts["certified"] + port_topk.cert_counts[
        "dense"] == 4
    pipe = Pipeline(PipelineConfig(store=StoreConfig(dir=str(tmp_path)),
                                   search=cfg, skip_process=True),
                    device="cpu")
    assert pipe.engine(store).kernel_name() == "f32cert"
    (resp,) = pipe.serve([{"id": 1, "vectors": queries.tolist()}], k=10)
    assert [[r["row"] for r in res] for res in resp["results"]] == \
        ids.tolist()


def test_cli_search_evaluate_serve_on_f32cert(tmp_path, capsys, monkeypatch):
    """``search``, ``evaluate`` and ``serve`` with ``--kernel f32cert
    --store-dtype float32`` through the CLI's normal entry point."""
    import io
    import json

    from better_search_rag_rust_tpu.store import vectorstore as jvs
    from better_search_rag_rust_tpu.utils.testing import mock_embeddings
    from better_search_rag_rust_tpu_torch import cli

    rows = mock_embeddings(1500, 64, seed=0)
    shard = jvs.local_store(tmp_path, 0)
    shard.append_many(rows)
    shard.persist()
    jvs.merge_vector_stores(1, tmp_path).persist()
    common = ["--store-dir", str(tmp_path), "--device", "cpu", "--kernel",
              "f32cert", "--store-dtype", "float32", "--top-k", "20"]
    assert cli.main(["search", *common]) == 0
    assert "MRR=1.0000" in capsys.readouterr().out
    assert cli.main(["evaluate", *common, "--num-queries", "16"]) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[0])
    assert report["mrr"] == report["oracle_overlap"] == 1.0
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(
        {"id": 1, "vector": rows[7].tolist()}) + "\n"))
    assert cli.main(["serve", *common]) == 0
    captured = capsys.readouterr()
    assert "kernel=f32cert" in captured.err
    (resp,) = [json.loads(line) for line in captured.out.splitlines()]
    assert resp["id"] == 1 and len(resp["results"][0]) == 20
    assert resp["results"][0][0]["row"] == 7
