"""The int8 lattice store of the port against the JAX package.

Tolerance: none. An int8 score is an exact integer dot times one f32
constant, so the quantization, the plain K1/K2/K3 (the CUDA kernels' CPU
versions), the engine's ids and its distances must all equal the JAX
package's bit for bit — its Pallas kernels run in interpret mode, its
engine on one emulated device. The port's stores carry the JAX store's
lattice integers (``DeviceStore.from_reference``): each package normalizing
on its own may move a row by an f32 ulp, and at a rounding boundary that
moves a lattice value (ROADMAP.md, Queue 3, known difference (a)).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.config import SearchConfig
from better_search_rag_rust_tpu.ops import quantize as jq
from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu.ops.engine import SearchEngine as JaxEngine
from better_search_rag_rust_tpu.store.device_store import DeviceStore as JaxStore
from better_search_rag_rust_tpu_torch.metrics import top_k_overlap
from better_search_rag_rust_tpu_torch.ops import quantize as pq
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.ops.topk import serial_topk
from better_search_rag_rust_tpu_torch.store import vectorstore as pvs
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

REPO = Path(__file__).resolve().parents[1]
R, T = 1024, 16


def _unit(x):
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(n == 0.0, 1.0, n)).astype(np.float32)


def _lattice(seed, rows=R, dim=128, t=T):
    """Lattice rows of unit vectors with cross-unit and in-unit duplicates,
    a zero row, and queries that repeat store rows."""
    rng = np.random.default_rng(seed)
    mat = _unit(rng.standard_normal((rows, dim)))
    mat[40:48] = mat[3]
    mat[100] = mat[101]
    mat[9] = 0.0
    qs = np.concatenate([mat[[3, 100, 9]],
                         _unit(rng.standard_normal((t - 3, dim)))])
    s, q = jq.quantize_unit_host(mat), jq.quantize_unit_host(qs)
    return s, q, torch.from_numpy(s), torch.from_numpy(q)


def test_scale_constant_and_source_bits():
    assert pq.INT8_INV_SCALE2 == jq.INT8_INV_SCALE2
    bits = int(np.float32(pq.INT8_INV_SCALE2).view(np.uint32))
    src = (REPO / "better_search_rag_rust_tpu_torch/ops/csrc/topk_kernels.cu"
           ).read_text()
    assert f"INT8_INV_SCALE2_BITS = {bits:#010x}u" in src


def test_quantize_bitwise_reference():
    rng = np.random.default_rng(3)
    x = _unit(rng.standard_normal((257, 96)))
    x[0] = 0.0
    x[1, :4] = [1.0, -1.0, 0.5 / 127, -0.5 / 127]   # ends and half points
    x[2, :3] = [2.5 / 127, np.nextafter(np.float32(1.5 / 127), 0), 1.5 / 127]
    want = jq.quantize_unit_host(x)
    np.testing.assert_array_equal(want, np.asarray(jq.quantize_unit(
        jnp.asarray(x))))
    got = pq.quantize_unit(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pq.quantize_unit_host(x), want)
    np.testing.assert_array_equal(pq.cast_rows_to_host(x, "int8").numpy(),
                                  want)
    assert want.min() >= -127
    s = pq.quantize_unit_host(x)
    np.testing.assert_array_equal(pq.int8_sims_host(s, s[:7]),
                                  jq.int8_sims_host(s, s[:7]))


@pytest.mark.parametrize("sub", [16, 64])
@pytest.mark.parametrize("emit", ["argmax_block", "argmax", "block", "bms"])
def test_k1_int8_plain_matches_pallas(sub, emit):
    """Both int8 emissions of the JAX kernel: the integer tournament
    (``emit_argmax``) and the integer-domain bms-only pass."""
    s, q, ts, tq = _lattice(seed=sub)
    valid = 1000  # a padded tail, with a partially padded unit
    argmax, block = "argmax" in emit, "block" in emit
    out = ref.matmul_blockmax2_only(
        jnp.asarray(q), jnp.asarray(s), jnp.int32(valid), interpret=True,
        sub=sub, block=128, emit_block=block, emit_argmax=argmax)
    pout = port.matmul_blockmax2_only(tq, ts, valid, sub=sub, block=128,
                                      emit_block=block, emit_argmax=argmax)
    out = out if isinstance(out, tuple) else (out,)
    pout = pout if isinstance(pout, tuple) else (pout,)
    assert len(out) == len(pout) == 1 + argmax + block
    for a, b in zip(pout, out):
        assert a.dtype == (torch.int32 if b.dtype == jnp.int32
                           else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("unit", [16, 64])
def test_k2_int8_plain_matches_pallas(unit):
    s, q, ts, tq = _lattice(seed=unit, rows=2048)
    rng = np.random.default_rng(unit + 1)
    ids = np.sort(rng.integers(0, 2048 // unit, size=(T, 8)), axis=1
                  ).astype(np.int32)
    out = ref.gather_rescore(jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids),
                             unit=unit, cpg=128 // unit, interpret=True)
    pout = port.gather_rescore(tq, ts, torch.from_numpy(ids), unit=unit)
    np.testing.assert_array_equal(pout.numpy(), np.asarray(out))


@pytest.mark.parametrize("valid", [R, 1000])
def test_k3_int8_plain_matches_pallas(valid):
    s, q, ts, tq = _lattice(seed=valid)
    sims, bm_t = ref.matmul_blockmax(jnp.asarray(q), jnp.asarray(s),
                                     jnp.int32(valid), interpret=True)
    psims, pbm = port.matmul_blockmax(tq, ts, valid)
    np.testing.assert_array_equal(psims.numpy(), np.asarray(sims))
    np.testing.assert_array_equal(pbm.numpy(), np.asarray(bm_t))
    want = jq.int8_sims_host(s, q)
    np.testing.assert_array_equal(psims.numpy()[:, :valid], want[:, :valid])


def test_int8_plain_kernels_agree_with_each_other():
    """K2 at each unit's argmax row == K1's unit max == K3's score there."""
    _s, _q, ts, tq = _lattice(seed=11)
    sub = 64
    bms, key = port.matmul_blockmax2_only(tq, ts, R, sub=sub, block=128,
                                          emit_argmax=True)
    arg = (key & 0x7F).to(torch.int64).T
    units = torch.arange(R // sub).expand(T, -1)
    resc = port.gather_rescore(tq, ts, units.to(torch.int32).contiguous(),
                               unit=sub).view(T, R // sub, sub)
    assert torch.equal(torch.gather(resc, 2, arg[:, :, None])[:, :, 0], bms.T)
    sims, _ = port.matmul_blockmax(tq, ts, R)
    assert torch.equal(torch.gather(sims, 1, units * sub + arg), bms.T)


def test_int8_wrapper_refuses_wide_dims():
    q = torch.zeros((8, 1044), dtype=torch.int8)
    s = torch.zeros((256, 1044), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 dim"):
        port.matmul_blockmax(q, s, 256)


# ---------------------------------------------------------------------------
# Engine parity on the JAX store's lattice bits
# ---------------------------------------------------------------------------


def _matrix(rows, dim, seed):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((rows, dim)).astype(np.float32)
    mat[rows // 2] = mat[3]                 # duplicates tie to the lower id
    mat[rows // 3: rows // 3 + 4] = mat[5]
    mat[7] = 0.0
    queries = np.concatenate([mat[[3, 5, 9, 7]], -mat[[11]],
                              rng.standard_normal((5, dim)).astype(np.float32)])
    return mat, queries


# (rows, dim, matryoshka): 512-d takes the argmax fast path with 64-row
# units; 128-d turns it off under "auto" (the low-dim int8 rule); 512 -> 256
# is a Matryoshka store whose queries arrive at 512-d, also argmax off.
STORES = [(8192, 512, None), (8192, 128, None), (8192, 512, 256)]


@pytest.fixture(scope="module", params=STORES,
                ids=lambda s: "-".join(map(str, s)))
def pair(request, mesh1):
    rows, dim, mat_dim = request.param
    mat, queries = _matrix(rows, dim, seed=rows + dim)
    js = JaxStore.from_host(mat, mesh1, dtype="int8", matryoshka_dim=mat_dim)
    ps = DeviceStore.from_reference(np.asarray(js.data), js.num_rows, js.dim,
                                    js.matryoshka_from, device="cpu")
    assert ps.dtype == torch.int8
    return js, ps, queries, {}


def _jax(pair, k, upload="f32"):
    js, _ps, queries, cache = pair
    if (k, upload) not in cache:
        eng = JaxEngine(js, SearchConfig(kernel="global"))
        cache[k, upload] = next(eng.search_stream([queries], k, upload=upload))
    return cache[k, upload]


@pytest.mark.parametrize("kernel", ["rescore", "global"])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_engine_int8_matches_jax(pair, kernel, k):
    _js, ps, queries, _ = pair
    j_ids, j_d = _jax(pair, k)
    eng = SearchEngine(ps, SearchConfig(kernel=kernel))
    assert eng.kernel_name(k) == kernel
    if ps.dim * 2 < 1024:
        assert not eng._argmax_enabled()
    ids, dists = eng.search(queries, k)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(dists, j_d)
    assert ids[0, 0] == 3 and ids[1, 0] == 5   # lowest copy wins the tie
    o_ids, o_d = eng.oracle_topk(queries, k)
    np.testing.assert_array_equal(o_ids, ids)
    np.testing.assert_array_equal(o_d, dists)
    # the NumPy integer oracle over the same lattice
    eff_s = eng.effective_store().astype(np.int8)
    eff_q = eng.effective_queries(queries).astype(np.int8)
    n_ids, n_d = serial_topk(eff_s, eff_q, k,
                             sims=pq.int8_sims_host(eff_s, eff_q))
    np.testing.assert_array_equal(n_ids, ids)
    np.testing.assert_array_equal(n_d, dists)


def test_engine_int8_store_upload(pair):
    """``upload="store"`` quantizes on the host and uploads a quarter of the
    f32 bytes; the results are the JAX package's on the same host bits."""
    _js, ps, queries, _ = pair
    eng = SearchEngine(ps, SearchConfig(kernel="rescore"))
    assert eng.supports_store_upload()
    qc = eng.prepare_upload_queries(queries)
    assert qc.dtype == torch.int8 and qc.element_size() == 1
    j_ids, j_d = _jax(pair, 10, upload="store")
    ids, dists = next(eng.search_stream([queries], 10, upload="store"))
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(dists, j_d)
    o_ids, _ = eng.oracle_topk(queries, 10, upload="store")
    assert top_k_overlap(o_ids.tolist(), ids.tolist(), 10) == 1.0


def test_int8_store_builders(tmp_path):
    """from_host / from_parquet / synthetic build lattice stores; the port's
    own normalization agrees with the JAX store's lattice except where an
    f32 ulp crosses a rounding boundary (at most 1e-4 of the values, each
    by one lattice step)."""
    import jax

    from better_search_rag_rust_tpu.parallel import create_mesh

    rng = np.random.default_rng(6)
    mat = rng.standard_normal((3000, 96)).astype(np.float32)
    mat[17] = 0.0
    ps = DeviceStore.from_host(mat, "int8", device="cpu")
    assert ps.dtype == torch.int8 and ps.padded_rows == 3072
    eff = ps.effective_matrix()
    assert eff.dtype == np.float32 and np.all(eff == np.round(eff))
    assert np.all(eff[17] == 0) and np.abs(eff).max() <= 127
    js = JaxStore.from_host(mat, create_mesh(devices=jax.devices()[:1]),
                            dtype="int8")
    j = np.asarray(js.effective_matrix())
    diff = eff != j
    assert diff.mean() <= 1e-4 and np.all(np.abs(eff - j)[diff] == 1)
    s = pvs.global_store(tmp_path)
    s.append_many(mat)
    s.persist()
    from_pq = DeviceStore.from_parquet(pvs.global_store_path(tmp_path),
                                       "int8", device="cpu")
    assert torch.equal(from_pq.data, ps.data)
    syn = DeviceStore.synthetic(2048, 64, "int8", seed=1, device="cpu")
    assert syn.dtype == torch.int8 and syn.num_rows == 2048
