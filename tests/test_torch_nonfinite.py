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

NaN rule (both packages' ``m2_sort_key``): a NaN score ranks above +inf,
whatever its sign. The sign of a NaN is the CPU's alone (the card writes
every NaN score as 0x7FFFFFFF), so stores built by the port answer, for a
NaN of either sign, what the JAX engine answers for the NaN with the sign
clear (:data:`chip_smoke.NAN_PINS`, which the card's phase 28 holds too).
The bf16 cast writes a NaN as ml_dtypes does (0x7FC0 / 0xFFC0), and the
plain K1/K3 agree with the interpret-mode Pallas kernels on NaN rows. The
file passes under every ATen CPU capability (the vectorised cast used to
write 0xFFFF): two cases rerun it under ``default`` and ``avx2``.
"""

import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import chip_smoke
from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu.store.device_store import DeviceStore as JaxStore
from better_search_rag_rust_tpu_torch.bench import suite
from better_search_rag_rust_tpu_torch.ops import topk as port_topk
from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
from better_search_rag_rust_tpu_torch.ops.distance import normalize_rows
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.ops.quantize import (
    cast_rows_to,
    cast_rows_to_host,
)
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

ROWS = 64
REPO = Path(__file__).resolve().parents[1]


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
    of its row) runs the route as under ``"off"`` whatever the mode: a
    unit whose maximum is NaN names no argmax row for the fast path. int8
    stores are always finite."""
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


# -- NaN bits and the NaN rule ------------------------------------------------


def _nan_bits(sign, payload):
    return np.uint32((0xFF800000 if sign < 0 else 0x7F800000) | payload)


def _with_nans(n, sign, payload, seed=0):
    """``n`` f32 values: normal draws, big values that round to +-inf and
    exact bf16 ties, with NaNs of one sign and payload at every 3rd place."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    edge = np.array([3.4e38, -3.4e38, np.inf, -np.inf, 1.00390625,
                     1.01171875, -0.0, 1e-40], np.float32)
    x[1::5] = np.resize(edge, x[1::5].shape)
    bits = x.view(np.uint32)
    bits[::3] = _nan_bits(sign, payload)
    return bits.view(np.float32)


@pytest.mark.parametrize("length", [1, 7, 16, 33, 4096])
@pytest.mark.parametrize("payload", [0x400000, 0x000001, 0x7FFFFF])
@pytest.mark.parametrize("sign", [1, -1])
def test_bf16_cast_writes_ml_dtypes_nan_bits(sign, payload, length):
    """``cast_rows_to`` (and its host twin) give ml_dtypes' bf16 bits: a
    NaN of either sign and any payload as 0x7FC0 / 0xFFC0, every other
    value as torch's own round to nearest even. The lengths take torch's
    scalar tail and its vectorised body."""
    x = _with_nans(length, sign, payload)
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    for got in (cast_rows_to(torch.from_numpy(x.copy()), "bfloat16"),
                cast_rows_to_host(x.copy(), "bfloat16")):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                      .view(np.uint16), want)
    nan = np.isnan(x)
    assert (want[nan] == (0xFFC0 if sign < 0 else 0x7FC0)).all()
    plain = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(want[~nan], plain.view(np.uint16)[~nan])


@pytest.mark.parametrize("sign", [1, -1])
def test_sort_keys_are_the_reference_on_nan(sign):
    """``m2_sort_key`` and ``pack_m2_argmax_key`` give the reference's bits
    on NaNs of either sign and several payloads, beside finite values:
    every NaN ranks above +inf."""
    nans = np.array([_nan_bits(sign, p) for p in (0x400000, 1, 0x7FFFFF,
                                                  0x123456)]).view(np.float32)
    x = np.concatenate([nans, np.array([np.inf, -np.inf, 1.0, -1.0, 0.0,
                                        -0.0, -3.0], np.float32)])
    arg = np.arange(x.size, dtype=np.int32) % 128
    key = tk.m2_sort_key(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(key, np.asarray(ref.m2_sort_key(
        jnp.asarray(x))))
    np.testing.assert_array_equal(
        tk.pack_m2_argmax_key(torch.from_numpy(x), torch.from_numpy(arg))
        .numpy(),
        np.asarray(ref.pack_m2_argmax_key(jnp.asarray(x), jnp.asarray(arg))))
    assert (key[:nans.size] > key[nans.size]).all()  # above +inf


NAN_CASES = {"nan_row": nan_row_case, "nan_query": nan_query_case}
#: (dtype, route, rescore_argmax): every route of every dtype
PORT_ROUTES = [(dt, kernel, argmax) for dt in DTYPES for kernel, argmax in (
    ("rescore", "auto"), ("rescore", "off"), ("rescore", "on"),
    ("global", "auto"), ("f32cert", "auto")) if kernel != "f32cert"
    or dt == "float32"]


def _signed(mat, queries, sign):
    """The case with every NaN given ``sign`` (the cases use np.nan, whose
    sign is clear)."""
    out = []
    for a in (mat.copy(), queries.copy()):
        bits = a.view(np.uint32)
        bits[np.isnan(a)] = _nan_bits(sign, 0x400000)
        out.append(a)
    return out


def _route_config(kernel, argmax):
    if kernel == "f32cert":  # the reference's rule: "auto" routes it
        return SearchConfig(kernel="auto", f32_certified="on")
    return SearchConfig(kernel=kernel, rescore_argmax=argmax)


def _mesh1():
    import jax

    from better_search_rag_rust_tpu.parallel import create_mesh

    return create_mesh(devices=jax.devices()[:1])


@lru_cache(maxsize=None)
def _jax_answer(case, dtype, kernel, argmax):
    """The JAX engine's ids on the case as written (NaN with the sign
    clear), from the JAX ``from_host`` store."""
    mat, queries, k = NAN_CASES[case]()
    js = JaxStore.from_host(mat, _mesh1(), dtype=dtype)
    eng = JaxEngine(js, _route_config(kernel, argmax))
    return np.asarray(eng.search(queries, k)[0])


@pytest.mark.parametrize("dtype,kernel,argmax", PORT_ROUTES)
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("case", list(NAN_CASES))
def test_port_built_store_answers_the_jax_ids(case, sign, dtype, kernel,
                                              argmax):
    """A store built by the port itself (``from_host`` on the CPU, the bf16
    cast included) with row 5 or the queries NaN of either sign answers the
    JAX engine's ids for the NaN with the sign clear, on every route, and
    the pins the card's phase 28 holds. On bf16 and int8 the store holds
    the JAX ``from_host`` store's bits for either sign (f32 may differ by
    an ulp of normalization: ROADMAP.md, Known differences (a))."""
    mat, queries, k = NAN_CASES[case]()
    mat, queries = _signed(mat, queries, sign)
    ps = DeviceStore.from_host(mat, dtype=dtype, device="cpu")
    eng = SearchEngine(ps, _route_config(kernel, argmax))
    assert eng.kernel_name(k) == kernel
    ids = eng.search(queries, k)[0]
    np.testing.assert_array_equal(ids, _jax_answer(case, dtype, kernel,
                                                   argmax))
    np.testing.assert_array_equal(ids, chip_smoke.NAN_PINS[case][dtype])
    if dtype != "float32":
        js_mat = np.asarray(JaxStore.from_host(
            mat, _mesh1(), dtype=dtype).data)[:ROWS, :mat.shape[1]]
        got = ps.data[:ROWS].contiguous().view(torch.uint8).numpy()
        np.testing.assert_array_equal(
            got, np.ascontiguousarray(js_mat).view(np.uint8))


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("case", ["nan_row", "nan_query", "inf_query"])
def test_chip_smoke_cases_are_these(case, sign):
    """``chip_smoke.nan_case`` (phase 28's pinned cases, which cannot import
    this file) builds these cases bit for bit."""
    if case == "inf_query":
        want = inf_query_case(sign)
    else:
        mat, queries, k = NAN_CASES[case]()
        want = (*_signed(mat, queries, sign), k)
    got = chip_smoke.nan_case(case, sign)
    assert got[2] == want[2]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sign", [1, -1])
def test_port_built_store_on_inf_query(sign, dtype):
    """A +-inf query entry on a store the port built: the port's oracle's
    ids on every route (ROADMAP.md, Known differences (e)), which are the
    card's pins."""
    mat, queries, k = inf_query_case(sign)
    ps = DeviceStore.from_host(mat, dtype=dtype, device="cpu")
    oracle = SearchEngine(ps).oracle_topk(queries, k)[0]
    np.testing.assert_array_equal(oracle, chip_smoke.NAN_PINS["inf_query"][
        dtype])
    for kernel, argmax in (("rescore", "on"), ("rescore", "off"),
                           ("global", "auto")):
        eng = SearchEngine(ps, _route_config(kernel, argmax))
        np.testing.assert_array_equal(eng.search(queries, k)[0], oracle)


def _dyadic_nan_operands(dtype, sign, rows=1024, dim=64, t=16):
    """Dyadic unit rows (16 entries of +-1/4: every score exact in f32, so
    both packages agree bit for bit) with NaN rows of ``sign`` at a unit's
    first row (64), mid-unit (200), in the last block (990) and a whole
    unit (320-335), and one NaN query (3); bf16 operands hold the JAX
    package's NaN bits."""
    rng = np.random.default_rng(7)
    mat = np.zeros((rows, dim), np.float32)
    for i in range(rows):
        cols = rng.choice(dim, size=16, replace=False)
        mat[i, cols] = rng.choice([-0.25, 0.25], size=16)
    qs = mat[rng.integers(0, rows, t)].copy()
    nan = np.float32(_nan_bits(sign, 0x400000).view(np.float32))
    for r in (64, 200, 990):
        mat[r] = nan
    mat[320:336] = nan
    qs[3] = nan
    return (mat, qs, cast_rows_to(torch.from_numpy(mat), dtype).contiguous(),
            cast_rows_to(torch.from_numpy(qs), dtype).contiguous(),
            getattr(jnp, dtype))


@pytest.mark.parametrize("sub,block,emit_width", [(16, 128, 0), (64, 256, 128),
                                                  (8, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [1, -1])
def test_plain_k1_k3_match_pallas_on_nan_rows(sign, dtype, sub, block,
                                              emit_width):
    """Plain K1 (unit maxima, the packed (m2, argmax) key, coarse maxima)
    and plain K3 (scores, maxima of blocks of ``2 * sub`` rows) against
    the interpret-mode Pallas kernels on NaN rows of either sign: NaN in
    the same places, every finite output and every key bit for bit. A unit whose max is NaN has
    no attaining row (argmax ``sub``) and a NaN m2, in both."""
    mat, qs, tmat, tqs, jdt = _dyadic_nan_operands(dtype, sign)
    valid = 1000
    outs = ref.matmul_blockmax2_only(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.int32(valid),
        interpret=True, sub=sub, block=block, emit_block=True,
        emit_argmax=True, emit_width=emit_width)
    pouts = tk.matmul_blockmax2_only(
        tqs, tmat, valid, sub=sub, block=block, emit_block=True,
        emit_argmax=True, emit_width=emit_width)
    for got, want in zip(pouts, outs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bms = pouts[0].numpy()
    nan_units = np.isnan(bms)
    assert nan_units[320 // sub].all() and nan_units[:valid // sub, 3].all()
    assert ((pouts[1].numpy()[nan_units] & 0x7F) == sub % 128).all()
    sims, bm_t = ref.matmul_blockmax(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.int32(valid),
        interpret=True, block=sub * 2)
    psims, pbm_t = tk.matmul_blockmax(tqs, tmat, valid, block=sub * 2)
    np.testing.assert_array_equal(psims.numpy(), np.asarray(sims))
    np.testing.assert_array_equal(pbm_t.numpy(), np.asarray(bm_t))
    assert np.isnan(pbm_t.numpy()[64 // (sub * 2)]).all()


@pytest.mark.parametrize("capability", ["default", "avx2"])
def test_file_passes_under_cpu_capability(capability):
    """This file again, in a subprocess under ``ATEN_CPU_CAPABILITY`` (torch's
    scalar and AVX2 kernels; the run itself takes the machine's own)."""
    env = {**os.environ, "ATEN_CPU_CAPABILITY": capability,
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-o", "addopts=",
         "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "not cpu_capability",
         str(Path(__file__).resolve())],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
    assert " passed" in proc.stdout and "failed" not in proc.stdout


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
    """``--tp`` is no longer refused: over one process it exits with the
    JAX package's message, since 2 model ranks do not divide 1."""
    from better_search_rag_rust_tpu_torch import cli

    with pytest.raises(SystemExit, match="--tp 2 does not divide 1 devices"):
        cli.main(["finetune", "--root", str(tmp_path), "--tp", "2",
                  "--device", "cpu"])
