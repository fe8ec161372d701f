"""Non-finite inputs on the rescore route, and a battery suite that returns
no dict.

The store is 64 x 32 standard normal rows (seed 0, row 10 = row 3, row 7 =
0), built by the JAX ``DeviceStore.from_host`` and carried across with
``DeviceStore.from_reference``, searched with ``SearchConfig(kernel=
"rescore")``. The argmax fast path ranks each selected unit by its K1
maximum and names its argmax row; a NaN maximum fails every comparison, so
the path used to hand out the id ``INT32_MAX`` (past the store) and drop
the unit's real rows. Now a query tile whose unit maxima or danger scores
are not finite takes the full gather, and a store holding a NaN or an
infinity never takes the fast path: the route answers what it answers with
``rescore_argmax="off"``:

* a NaN store row, and a NaN query entry: the JAX engine's ids;
* a +-inf query entry: the port's own oracle's ids (the JAX engine returns
  its 2^31 sentinel there: ROADMAP.md, Known differences (e));
* never an id at or past the row count for a query that is finite.
"""

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu.store.device_store import DeviceStore as JaxStore
from better_search_rag_rust_tpu_torch.bench import suite
from better_search_rag_rust_tpu_torch.ops import topk as port_topk
from better_search_rag_rust_tpu_torch.ops.distance import normalize_rows
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.ops.quantize import cast_rows_to
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

ROWS = 64


def base_matrix():
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((ROWS, 32)).astype(np.float32)
    mat[10] = mat[3]
    mat[7] = 0.0
    return mat


def nan_row_case():
    """Row 5 holds a NaN; the queries are rows 5 (a NaN query) and 6."""
    mat = base_matrix()
    mat[5, 0] = np.nan
    return mat, mat[[5, 6]], 4


def nan_query_case():
    mat = base_matrix()
    q = mat[[0, 1]].copy()
    q[:, 0] = np.nan
    return mat, q, 3


def inf_query_case(sign):
    mat = base_matrix()
    q = mat[[1]].copy()
    q[0, 0] = sign * np.inf
    return mat, q, 3


def both(mesh, mat, dtype):
    js = JaxStore.from_host(mat, mesh, dtype=dtype)
    ps = DeviceStore.from_reference(np.asarray(js.data), js.num_rows, js.dim,
                                    js.matryoshka_from, device="cpu")
    return js, ps


def port_ids(ps, queries, k, argmax):
    eng = SearchEngine(ps, SearchConfig(kernel="rescore",
                                        rescore_argmax=argmax))
    assert eng.kernel_name(k) == "rescore"
    return eng.search(queries, k)[0]


def jax_ids(js, queries, k):
    return JaxEngine(js, SearchConfig(kernel="rescore")).search(queries, k)[0]


DTYPES = ["float32", "bfloat16", "int8"]
ARGMAX = ["auto", "off", "on"]


@pytest.mark.parametrize("argmax", ARGMAX)
@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_row_answers_the_jax_ids(mesh1, dtype, argmax):
    mat, queries, k = nan_row_case()
    js, ps = both(mesh1, mat, dtype)
    ids = port_ids(ps, queries, k, argmax)
    np.testing.assert_array_equal(ids, jax_ids(js, queries, k))
    assert (ids[1] < ROWS).all()           # row 6's query is finite
    if dtype != "int8":                    # int8 quantizes the NaN to 0
        np.testing.assert_array_equal(ids, [[0, 1, 2, 3], [5, 6, 12, 27]])


@pytest.mark.parametrize("argmax", ARGMAX)
@pytest.mark.parametrize("dtype", DTYPES)
def test_nan_query_answers_the_jax_ids(mesh1, dtype, argmax):
    mat, queries, k = nan_query_case()
    js, ps = both(mesh1, mat, dtype)
    ids = port_ids(ps, queries, k, argmax)
    np.testing.assert_array_equal(ids, jax_ids(js, queries, k))
    np.testing.assert_array_equal(ids, [[0, 1, 2], [0, 1, 2]])


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("argmax", ARGMAX)
@pytest.mark.parametrize("dtype", DTYPES)
def test_inf_query_answers_the_port_oracle(mesh1, dtype, argmax, sign):
    mat, queries, k = inf_query_case(sign)
    _js, ps = both(mesh1, mat, dtype)
    ids = port_ids(ps, queries, k, argmax)
    oracle = SearchEngine(ps).oracle_topk(queries, k)[0]
    np.testing.assert_array_equal(ids, oracle)
    assert (ids < ROWS).all()


@pytest.mark.parametrize("case", ["nan_row", "nan_query", "inf_query"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_argmax_tile_takes_the_full_gather(mesh1, dtype, case):
    """:func:`rescore_topk` itself, at the argmax geometry (64-row units,
    128-row blocks) and at 16-row units: with the fast path asked for, a
    tile with a non-finite unit maximum or danger score answers exactly as
    the full gather does, and finite queries get only ids inside the
    store."""
    mat, queries, k = {"nan_row": nan_row_case, "nan_query": nan_query_case,
                       "inf_query": lambda: inf_query_case(1)}[case]()
    _js, ps = both(mesh1, mat, dtype)
    qc = cast_rows_to(normalize_rows(torch.from_numpy(queries)),
                      ps.dtype).contiguous()
    finite = torch.isfinite(qc.float()).all(dim=1)
    for sub in (64, 16):
        got = [port_topk.rescore_topk(ps.data, qc, k, ps.num_rows, block=128,
                                      sub_block=sub, argmax_fast=fast)
               for fast in (True, False)]
        assert torch.equal(got[0][1], got[1][1])
        assert (got[0][1][finite] < ROWS).all()


@pytest.mark.parametrize("dtype,value,finite", [
    ("float32", np.nan, False), ("bfloat16", np.nan, False),
    ("float32", np.inf, False), ("float32", 1.0, True),
    ("bfloat16", 1.0, True), ("int8", np.nan, True)])
def test_store_finiteness_gates_the_fast_path(mesh1, dtype, value, finite):
    """A store with a NaN or an infinity (after normalization every entry
    of its row) runs the route as under ``"off"`` whatever the mode: the
    card's K1 keeps a unit's maximum finite past a NaN row, so the fast
    path could not see the row. int8 stores are always finite."""
    mat = base_matrix()
    mat[20, 3] = value
    _js, ps = both(mesh1, mat, dtype)
    for mode in ("auto", "on"):
        eng = SearchEngine(ps, SearchConfig(kernel="rescore",
                                            rescore_argmax=mode))
        assert eng._store_finite() is finite
        low_dim_int8 = mode == "auto" and dtype == "int8"  # the reference's rule
        assert eng._argmax_enabled() is (finite and not low_dim_int8)
    off = SearchEngine(ps, SearchConfig(kernel="rescore",
                                        rescore_argmax="off"))
    assert not off._argmax_enabled()
    queries = base_matrix()[[20, 21, 3]]
    np.testing.assert_array_equal(port_ids(ps, queries, 5, "auto"),
                                  port_ids(ps, queries, 5, "off"))


# -- the battery --------------------------------------------------------------


@pytest.mark.parametrize("bad", [None, [1.0, 2.0], "12 q/s", 7.5])
def test_battery_wraps_a_suite_that_returns_no_dict(monkeypatch, bad):
    """A suite that returns something other than a dict is recorded as an
    error inside the battery's guard, and every other suite still runs."""
    def fake_search(name, s, device=None, seed=0):
        return bad if name == "search_1m_f32" else {"value": 1.0}

    monkeypatch.setattr(suite, "run_search_suite", fake_search)
    for fn in ("_run_jabref", "_run_serve", "_run_finetune"):
        monkeypatch.setattr(suite, fn, lambda *a, **k: {"value": 2.0})
    monkeypatch.setattr(suite, "run_encode_suite", lambda **k: {"value": 3.0})
    res = suite.run_battery_suite(device="cpu")
    bad_entry = res["battery"]["search_1m_f32"]
    assert bad_entry["error"].startswith("TypeError: suite search_1m_f32 "
                                         f"returned a {type(bad).__name__}")
    assert "wall_s" in bad_entry
    assert suite.battery_errors(res) == {"search_1m_f32": bad_entry["error"]}
    others = {n: r for n, r in res["battery"].items() if n != "search_1m_f32"}
    assert len(others) == 9 and all("error" not in r for r in others.values())
    assert res["value"] == 1.0


def test_finetune_tp_points_at_the_multi_gpu_item(tmp_path):
    from better_search_rag_rust_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="Queue 1 item 2\\)"):
        cli.main(["finetune", "--root", str(tmp_path), "--tp", "2",
                  "--device", "cpu"])
