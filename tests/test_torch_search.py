"""The port's selection routes and SearchEngine against the JAX engine.

Both packages score the same store bits: the port's store is built from the
JAX store's array with ``DeviceStore.from_reference``. Queries go to both as
numpy. On the CPU the port runs its routes through the plain kernels.

* Dyadic stores (rows of 16 entries +-1/4; duplicate rows): every score is
  exact, so ids must match bit for bit, ties to the lowest row id.
* Random stores: ids must match wherever the JAX scores around a position
  are more than 1e-5 apart, and distances agree within 1e-5 (the two
  packages sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu.store.device_store import (
    DeviceStore as JaxStore,
    _normalize_cast,
)
from better_search_rag_rust_tpu_torch.metrics import top_k_overlap
from better_search_rag_rust_tpu_torch.ops import topk as port_topk
from better_search_rag_rust_tpu_torch.ops.distance import normalize_rows
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.ops.quantize import cast_rows_to
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

TOL = 1e-5


def dyadic(rng, n, d):
    out = np.zeros((n, d), dtype=np.float32)
    for i in range(n):
        cols = rng.choice(d, size=16, replace=False)
        out[i, cols] = rng.choice([-0.25, 0.25], size=16)
    return out


def make_matrix(kind, rows, dim, seed):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        mat = dyadic(rng, rows, dim)
    else:
        mat = rng.standard_normal((rows, dim)).astype(np.float32)
    mat[rows // 2] = mat[3]             # duplicate rows: ties to the lower id
    mat[rows // 3: rows // 3 + 4] = mat[5]
    mat[7] = 0.0                        # a zero row
    queries = np.concatenate([mat[[3, 5, 9, 7]], -mat[[11]],
                              make_queries(rng, kind, dim)])
    return mat, queries


def make_queries(rng, kind, dim, n=3):
    if kind == "dyadic":
        return dyadic(rng, n, dim)
    return rng.standard_normal((n, dim)).astype(np.float32)


def both_stores(mesh, mat, dtype):
    js = JaxStore.from_host(mat, mesh, dtype=dtype)
    ps = DeviceStore.from_reference(np.asarray(js.data), js.num_rows, js.dim,
                                    js.matryoshka_from, device="cpu")
    return js, ps


def assert_topk_agree(kind, j_ids, j_d, p_ids, p_d):
    assert p_ids.shape == j_ids.shape and p_ids.dtype == np.int64
    if kind == "dyadic":
        np.testing.assert_array_equal(p_ids, j_ids)
        np.testing.assert_array_equal(p_d, j_d)
        return
    np.testing.assert_allclose(p_d, j_d, atol=TOL, rtol=0)
    gaps = np.diff(j_d, axis=1)
    big = np.ones(j_d.shape[:1] + (1,), dtype=bool)
    clear = (np.concatenate([big, gaps > TOL], axis=1)
             & np.concatenate([gaps > TOL, big], axis=1))
    np.testing.assert_array_equal(p_ids[clear], j_ids[clear])


STORES = [
    # (kind, rows, dim, dtype): f32 at 256-d takes the high-dim rescore
    # geometry (64- or 16-row units), bf16 at 128-d the low-dim one.
    ("dyadic", 4096, 256, "float32"),
    ("normal", 4096, 256, "float32"),
    ("dyadic", 4096, 128, "bfloat16"),
    ("normal", 4096, 128, "bfloat16"),
    ("normal", 300, 64, "bfloat16"),    # tiny: k=500 > rows, dense only
]


@pytest.fixture(scope="module", params=STORES, ids=lambda s: "-".join(map(str, s)))
def pair(request, mesh1):
    kind, rows, dim, dtype = request.param
    mat, queries = make_matrix(kind, rows, dim, seed=rows + dim)
    js, ps = both_stores(mesh1, mat, dtype)
    return kind, js, ps, queries, {}


def jax_search(pair, kernel, k):
    """The JAX engine's answer, computed once per (store, kernel, k): its
    CPU routes do not depend on the argmax setting."""
    _kind, js, _ps, queries, cache = pair
    if (kernel, k) not in cache:
        cache[kernel, k] = JaxEngine(js, SearchConfig(kernel=kernel)).search(
            queries, k)
    return cache[kernel, k]


@pytest.mark.parametrize("kernel", ["rescore", "auto"])
@pytest.mark.parametrize("argmax", ["auto", "off"])
@pytest.mark.parametrize("k", [1, 10, 100, 500])
def test_engine_matches_jax(pair, kernel, argmax, k):
    kind, _js, ps, queries, _ = pair
    cfg = SearchConfig(kernel=kernel, rescore_argmax=argmax)
    j_ids, j_d = jax_search(pair, kernel, k)
    eng = SearchEngine(ps, cfg)
    p_ids, p_d = eng.search(queries, k)
    assert_topk_agree(kind, j_ids, j_d, p_ids, p_d)
    o_ids, _ = eng.oracle_topk(queries, k)
    assert top_k_overlap(o_ids.tolist(), p_ids.tolist(), k) == 1.0
    if kernel == "auto":
        assert eng.kernel_name(k) == "global"   # small stores stay dense


def _port_route_inputs(ps, queries):
    q = normalize_rows(torch.from_numpy(queries))
    return ps.data, cast_rows_to(q, ps.dtype).contiguous()


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("geometry", [(64, 128), (16, 128), (128, 1024)])
def test_routes_match_jax(pair, k, geometry):
    """rescore_topk (at each reference geometry) and global_topk directly,
    against the JAX engine's dense route on the same store."""
    kind, _js, ps, queries, _ = pair
    sub, block = geometry
    k_eff = min(k, ps.num_rows)
    j_ids, j_d = jax_search(pair, "global", k_eff)
    data, qc = _port_route_inputs(ps, queries)
    routes = [port_topk.global_topk(data, qc, k_eff, ps.num_rows, q_tile=4)]
    if port_topk.rescore_feasible(ps.padded_rows, k_eff, sub, block):
        for argmax in (False, True):
            routes.append(port_topk.rescore_topk(
                data, qc, k_eff, ps.num_rows, q_tile=8, block=block,
                sub_block=sub, argmax_fast=argmax))
    for vals, ids in routes:
        assert vals.dtype == torch.float32 and ids.dtype == torch.int64
        d = (1.0 - torch.clamp(vals, -1.0, 1.0)).numpy()
        assert_topk_agree(kind, j_ids, j_d, ids.numpy(), d)


def test_global_topk_macro_chunks_merge(mesh1):
    """Macro chunking with a running merge gives the one-chunk answer."""
    mat, queries = make_matrix("dyadic", 4096, 128, seed=3)
    _, ps = both_stores(mesh1, mat, "float32")
    data, qc = _port_route_inputs(ps, queries)
    one = port_topk.global_topk(data, qc, 50, ps.num_rows)
    many = port_topk.global_topk(data, qc, 50, ps.num_rows, macro_rows=1024)
    assert torch.equal(one[1], many[1]) and torch.equal(one[0], many[0])


def test_argmax_fast_path_and_overflow_fallback(mesh1, monkeypatch):
    """The argmax fast branch and the danger-overflow fallback to the full
    gather both run, and both give the JAX engine's ids bit for bit on a
    dyadic store (where the plain kernels' scores are exact)."""
    rng = np.random.default_rng(17)
    mat = dyadic(rng, 4096, 256)
    # query row 64 duplicated inside its own unit and in the next unit: at
    # k=2 both selected units are danger units (second max == the max)
    mat[[65, 128, 129]] = mat[64]
    queries = mat[[64, 300, 1000, 2047]]
    js, ps = both_stores(mesh1, mat, "float32")
    j_ids, j_d = JaxEngine(js, SearchConfig(kernel="global")).search(
        queries, 2)
    data, qc = _port_route_inputs(ps, queries)

    calls = []
    full = port_topk._full_gather
    monkeypatch.setattr(port_topk, "_full_gather",
                        lambda *a: calls.append(1) or full(*a))
    for units, expect_full in ((4, 0), (1, 1)):
        calls.clear()
        vals, ids = port_topk.rescore_topk(
            data, qc, 2, ps.num_rows, q_tile=4, block=128, sub_block=64,
            argmax_fast=True, danger_units=units)
        assert len(calls) == expect_full
        np.testing.assert_array_equal(ids.numpy(), j_ids)
        np.testing.assert_array_equal(
            (1.0 - torch.clamp(vals, -1, 1)).numpy(), j_d)


def test_probes(mesh1):
    """The verify recipe's probes: bad k / dims raise, 1-D queries promote,
    empty and 3-D matrices are refused, duplicate rows tie to the lowest
    id."""
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((500, 32)).astype(np.float32)
    mat[[100, 250, 499]] = mat[17]
    eng = SearchEngine(DeviceStore.from_host(mat, device="cpu"))
    for k in (0, -3):
        with pytest.raises(ValueError):
            eng.search(mat[:2], k)
    with pytest.raises(ValueError):
        eng.search(np.ones((2, 31), np.float32), 5)
    ids, dists = eng.search(mat[17], 4)
    assert ids.shape == (1, 4)
    np.testing.assert_array_equal(ids[0], [17, 100, 250, 499])
    assert eng.search_single(mat[17], 2)[0][0] == 17
    with pytest.raises(ValueError):
        DeviceStore.from_host(np.zeros((0, 32), np.float32), device="cpu")
    with pytest.raises(ValueError):
        DeviceStore.from_host(np.zeros((2, 3, 4), np.float32), device="cpu")


def test_stream_async_and_device_paths_agree(mesh1):
    mat, queries = make_matrix("normal", 4096, 256, seed=9)
    _, ps = both_stores(mesh1, mat, "bfloat16")
    eng = SearchEngine(ps, SearchConfig(kernel="rescore"))
    ids, dists = eng.search(queries, 10)
    for s_ids, s_d in eng.search_stream([queries, queries], 10, depth=2):
        np.testing.assert_array_equal(s_ids, ids)
        np.testing.assert_array_equal(s_d, dists)
    vals, d_ids = eng.search_device(eng.prepare_device_queries(queries), 10)
    np.testing.assert_array_equal(d_ids.numpy(), ids)
    # store-dtype upload: exact against the oracle fed the same bits
    up_ids, _ = next(eng.search_stream([queries], 10, upload="store"))
    o_ids, _ = eng.oracle_topk(queries, 10, upload="store")
    assert top_k_overlap(o_ids.tolist(), up_ids.tolist(), 10) == 1.0
    assert eng.supports_store_upload()
    eq = eng.effective_queries(queries)
    assert eq.dtype == np.float32 and eq.shape == queries.shape


def test_matryoshka_truncation(mesh1):
    rng = np.random.default_rng(4)
    mat = rng.standard_normal((700, 64)).astype(np.float32)
    full = SearchEngine(DeviceStore.from_host(mat, device="cpu",
                                              matryoshka_dim=32))
    trunc = SearchEngine(DeviceStore.from_host(mat[:, :32].copy(),
                                               device="cpu"))
    assert full.store.matryoshka_from == 64
    np.testing.assert_array_equal(full.search(mat[:5], 7)[0],
                                  trunc.search(mat[:5, :32], 7)[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normalize_cast_matches_jax(dtype):
    """Independent normalization against the reference's _normalize_cast.
    The f32 norms are summed in another order, so a row may scale by one
    or two f32 ulps apart: in bf16 at most 1e-4 of the elements may then
    differ, each by at most one bf16 ulp; in f32 every element stays
    within a relative 2^-21 (a few f32 ulps)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2000, 256)).astype(np.float32)
    x[5] = 0.0
    j = np.asarray(_normalize_cast(jnp.asarray(x), dtype)).astype(np.float32)
    p = cast_rows_to(normalize_rows(torch.from_numpy(x)), dtype).float().numpy()
    assert np.all(p[5] == 0.0) and np.all(j[5] == 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(p, j, rtol=2.0 ** -21, atol=0)
        return
    diff = p != j
    assert diff.mean() <= 1e-4
    ulp = 2.0 ** (np.floor(np.log2(np.abs(j[diff]))) - 7)
    assert np.all(np.abs(p[diff] - j[diff]) <= ulp)


def test_from_reference_carries_bits(mesh1):
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((1500, 100)).astype(np.float32)
    js, ps = both_stores(mesh1, mat, "bfloat16")
    assert ps.dtype == torch.bfloat16 and ps.padded_rows % 1024 == 0
    np.testing.assert_array_equal(
        ps.effective_matrix(), np.asarray(js.effective_matrix()))
    assert torch.count_nonzero(ps.data[1500:]) == 0


def test_int8_store_refused():
    """int8 stores are served now (tests/test_torch_int8.py); a store dtype
    the kernels do not take is still refused at build time."""
    assert DeviceStore.from_host(np.ones((4, 8), np.float32), "int8",
                                 device="cpu").dtype == torch.int8
    for dtype in ("float16", "int16", torch.uint8):
        with pytest.raises(ValueError, match="unsupported store dtype"):
            DeviceStore.from_host(np.ones((4, 8), np.float32), dtype,
                                  device="cpu")
