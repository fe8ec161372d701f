"""K17 ``normalize_cast`` on the CPU: its plain version against the JAX
package's ``_normalize_cast`` and against a numpy emulation of the norm
order, and the engine's and the store's rows through it.

Tolerances: the JAX package sums a row's squares in XLA's order, K17 in its
own stated order (``csrc/topk_kernels.cu``, THE NORM ORDER), so f32 rows
agree within 4 ulps and the bf16 and int8 values equal or one step apart,
at most 1e-4 of them unequal. Against the numpy emulation of the same
order: bit for bit, on zero, subnormal, overflowing, infinite and NaN rows
as well.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu.store.device_store import DeviceStore as JaxStore
from better_search_rag_rust_tpu.store.device_store import _normalize_cast
from better_search_rag_rust_tpu_torch.ops import engine as port_engine
from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.ops.quantize import cast_rows_to
from better_search_rag_rust_tpu_torch.store import device_store as port_store
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

DIMS = [32, 100, 256, 768]
DTYPES = ["float32", "bfloat16", "int8"]
F32_ULPS = 4
STEP_SHARE = 1e-4


def _rows(dim, n=1024, seed=0):
    return np.random.default_rng(seed + dim).standard_normal(
        (n, dim)).astype(np.float32)


def _ordered(bits):
    """f32 bit patterns -> integers in the order of their values, so that
    a difference of integers counts ulps across zero too."""
    b = bits.astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _bits(y):
    """A store-dtype result as integers: f32 and bf16 bit patterns, int8
    values."""
    y = np.asarray(y)
    if y.dtype == np.float32:
        return y.view(np.int32)
    if y.dtype == ml_dtypes.bfloat16:
        return y.view(np.int16)
    return y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", DIMS)
def test_plain_matches_jax_normalize_cast(dim, dtype):
    x = _rows(dim)
    want = np.asarray(_normalize_cast(jnp.asarray(x), dtype))
    got = tk.normalize_cast_plain(torch.from_numpy(x), dtype)
    if dtype == "float32":
        ulps = np.abs(_ordered(_bits(got.numpy())) - _ordered(_bits(want)))
        assert ulps.max() <= F32_ULPS
        return
    got = got.view(torch.int16) if dtype == "bfloat16" else got
    g = got.numpy().astype(np.int32)
    w = _bits(want).astype(np.int32)
    assert np.abs(g - w).max() <= 1
    assert (g != w).mean() <= STEP_SHARE


def _edge_rows(dim):
    """Rows at the edges of the norm: random, zero, -0.0, subnormal (their
    squares underflow to 0), tiny (squares subnormal), overflowing (the sum
    of squares is inf), one +inf, one -inf, all inf, one NaN of each sign,
    all NaN; random signs throughout."""
    rng = np.random.default_rng(dim)
    base = rng.standard_normal((12, dim)).astype(np.float32)
    rows = base.copy()
    rows[1] = 0.0
    rows[2] = -0.0
    rows[3] = base[3] * np.float32(1e-40)
    rows[4] = base[4] * np.float32(1e-21)
    rows[5] = base[5] * np.float32(1e20)
    rows[6, dim // 2] = np.inf
    rows[7, 0] = -np.inf
    rows[8] = np.copysign(np.float32(np.inf), base[8])
    nan = np.array([0x7FC00000, 0xFFC00001], np.uint32).view(np.float32)
    rows[9, dim - 1] = nan[0]
    rows[10, 1] = nan[1]
    rows[11] = nan[0]
    return rows


def _emulate(x, dtype):
    """The norm order in numpy float32, written from the rule: pad D to a
    multiple of 128, view the row as [chunk, lane, j], add each lane's
    squares chunk by chunk and j by j from +0.0, halve the 32 lane sums;
    sqrt, the zero guard, one division; then the store dtype's rounding."""
    n, d = x.shape
    xp = np.zeros((n, -(-d // 128) * 128), np.float32)
    xp[:, :d] = x
    xp = xp.reshape(n, -1, 32, 4)
    with np.errstate(all="ignore"):
        v = np.zeros((n, 32), np.float32)
        for c in range(xp.shape[1]):
            for j in range(4):
                v = v + xp[:, c, :, j] * xp[:, c, :, j]
        for h in (16, 8, 4, 2, 1):
            v[:, :h] = v[:, :h] + v[:, h:2 * h]
        norm = np.sqrt(v[:, :1])
        y = x / np.where(norm == 0, np.float32(1), norm)
        if dtype == "float32":
            return y
        if dtype == "bfloat16":
            return y.astype(ml_dtypes.bfloat16)
        r = np.clip(np.rint(y * np.float32(127)), -127, 127)
        return np.where(np.isnan(r), 0, r).astype(np.int8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", DIMS)
def test_plain_is_the_norm_order_bit_for_bit(dim, dtype):
    x = np.concatenate([_edge_rows(dim), _rows(dim, n=64)])
    got = tk.normalize_cast_plain(torch.from_numpy(x), dtype)
    got = got.view(torch.int16) if dtype == "bfloat16" else got
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_emulate(x, dtype)))


def test_row_sumsq_is_the_lane_order():
    """The sum of a row whose squares are powers of two far apart depends
    on the order: 2^24 + 1 rounds back to 2^24, so a 1 added to lane 0's
    2^24 is lost, while lanes 1 and 3 meet first in the tree (h = 2) and
    their 2 survives."""
    x = torch.zeros((2, 256))
    x[0, 0], x[0, 1], x[0, 5] = 4096.0, 1.0, 1.0   # lane 0 (j 0, 1), lane 1
    x[1, 0], x[1, 4], x[1, 12] = 4096.0, 1.0, 1.0  # lanes 0, 1 and 3
    s = tk.row_sumsq_plain(x)
    assert s[0].item() == 2.0 ** 24
    assert s[1].item() == 2.0 ** 24 + 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_out_is_written_in_place(dtype):
    x = torch.from_numpy(_rows(100, n=40))
    want = tk.normalize_cast_plain(x, dtype)
    data = torch.zeros((64, 100), dtype=want.dtype)
    got = tk.normalize_cast(x, dtype, out=data[8:48])
    assert got.data_ptr() == data[8:48].data_ptr()
    assert torch.equal(data[8:48], want)
    assert not data[:8].any() and not data[48:].any()


@pytest.mark.parametrize("call,error", [
    (lambda x: tk.normalize_cast(x.double(), "bfloat16"), TypeError),
    (lambda x: tk.normalize_cast(x, "int8", normalize=False), ValueError),
    (lambda x: tk.normalize_cast(x[0], "float32"), ValueError),
    (lambda x: tk.normalize_cast(x, "bfloat16",
                                 out=torch.empty((4, 32), dtype=torch.int8)),
     ValueError),
    (lambda x: tk.normalize_cast(x, "bfloat16",
                                 out=torch.empty((4, 33),
                                                 dtype=torch.bfloat16)),
     ValueError),
])
def test_refuses_what_it_does_not_take(call, error):
    with pytest.raises(error):
        call(torch.ones((4, 32)))


def test_cast_rows_to_bf16_is_k17_without_normalization():
    x = torch.from_numpy(_edge_rows(100))
    want = tk.normalize_cast(x, "bfloat16", normalize=False)
    assert torch.equal(cast_rows_to(x, "bfloat16").view(torch.int16),
                       want.view(torch.int16))
    np.testing.assert_array_equal(
        want.view(torch.int16).numpy(),
        x.numpy().astype(ml_dtypes.bfloat16).view(np.int16))


def _spy(monkeypatch, module):
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return tk.normalize_cast(*args, **kwargs)

    monkeypatch.setattr(module, "normalize_cast", spy)
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_and_store_rows_go_through_normalize_cast(monkeypatch, dtype):
    mat = _rows(64, n=3000)
    store_calls = _spy(monkeypatch, port_store)
    monkeypatch.setattr(port_store, "_BUILD_ROWS", 1024)
    store = DeviceStore.from_host(mat, dtype, device="cpu")
    assert store_calls == [(1024, 64), (1024, 64), (952, 64)]
    want = tk.normalize_cast_plain(torch.from_numpy(mat), dtype)
    assert torch.equal(store.data[:3000], want)
    query_calls = _spy(monkeypatch, port_engine)
    eng = SearchEngine(store)
    qs = _rows(64, n=9, seed=5)
    eff = eng.effective_queries(qs)
    assert query_calls == [(9, 64)]
    want = tk.normalize_cast_plain(torch.from_numpy(qs), dtype)
    np.testing.assert_array_equal(eff, want.float().numpy())
    eng.search(qs, 5)
    assert query_calls == [(9, 64)] * 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_built_store_answers_the_jax_ids(mesh1, dtype):
    mat = _rows(96, n=3000, seed=11)
    mat[70] = mat[2]
    mat[9] = 0.0
    qs = np.concatenate([mat[[2, 9, 500]], _rows(96, n=13, seed=12)])
    js = JaxStore.from_host(mat, mesh1, dtype=dtype)
    want = JaxEngine(js, SearchConfig()).search(qs, 10)
    ps = DeviceStore.from_host(mat, dtype, device="cpu")
    got = SearchEngine(ps).search(qs, 10)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
