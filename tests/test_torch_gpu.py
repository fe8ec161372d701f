"""CUDA kernels of the port on the card: against their plain versions, each
other, and the oracle. Marked ``gpu``; without a card every test skips.

The machine with the card has no jax, so run this file without the suite's
conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu_torch.config import SearchConfig
from better_search_rag_rust_tpu_torch.metrics import top_k_overlap
from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, dtype, rows=4096, dim=256, t=40, seed=0):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    mat = torch.randn((rows, dim), generator=g, device=cuda)
    mat = (mat / mat.norm(dim=1, keepdim=True)).to(dtype).contiguous()
    q = mat[torch.randint(0, rows, (t,), generator=g, device=cuda)]
    return q.contiguous(), mat


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub", [16, 64])
@pytest.mark.parametrize("dim", [256, 100])  # 100: a ragged D chunk
def test_k1_matches_plain(cuda, dtype, sub, dim):
    q, mat = _operands(cuda, dtype, dim=dim)
    valid = 4000
    out = tk.matmul_blockmax2_only(q, mat, valid, sub=sub, block=128,
                                   emit_block=True, emit_argmax=True)
    ref = tk.matmul_blockmax2_only_plain(q, mat, valid, sub=sub, block=128,
                                         emit_block=True, emit_argmax=True)
    torch.cuda.synchronize()
    assert (out[0] - ref[0]).abs().max() <= TOL
    assert (out[2] - ref[2]).abs().max() <= TOL
    sims = q.float() @ mat.float().T
    sims[:, valid:] = tk.PAD_SIM
    top2 = sims.T.reshape(-1, sub, q.shape[0]).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL
    assert torch.equal((out[1] & 0x7F)[clear], (ref[1] & 0x7F)[clear])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("unit,ks", [(64, 4), (64, 100), (16, 8), (128, 3)])
def test_k2_matches_plain_and_k1(cuda, dtype, unit, ks):
    q, mat = _operands(cuda, dtype)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    ids = torch.randint(0, mat.shape[0] // unit, (q.shape[0], ks),
                        generator=g, device=cuda).to(torch.int32)
    out = tk.gather_rescore(q, mat, ids, unit=unit)
    ref = tk.gather_rescore_plain(q, mat, ids, unit=unit)
    assert (out - ref).abs().max() <= TOL
    # bitwise identity with K3's scores of the same pairs
    sims, _ = tk.matmul_blockmax(q, mat, mat.shape[0])
    rows = (ids.long()[:, :, None] * unit
            + torch.arange(unit, device=cuda)).reshape(q.shape[0], -1)
    assert torch.equal(out, torch.gather(sims, 1, rows))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", [128, 64])
def test_k3_matches_plain(cuda, dtype, block):
    q, mat = _operands(cuda, dtype, t=300)
    sims, bm = tk.matmul_blockmax(q, mat, 4001, block=block)
    p_sims, p_bm = tk.matmul_blockmax_plain(q, mat, 4001, block=block)
    assert (sims - p_sims).abs().max() <= TOL
    assert (bm - p_bm).abs().max() <= TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_identity_with_k3(cuda, dtype):
    q, mat = _operands(cuda, dtype)
    bms, key = tk.matmul_blockmax2_only(q, mat, 4096, sub=64, block=128,
                                        emit_argmax=True)
    sims, _ = tk.matmul_blockmax(q, mat, 4096)
    s3 = sims.view(q.shape[0], -1, 64)
    assert torch.equal(bms.T, s3.amax(dim=2))
    arg = (key & 0x7F).T.long()
    assert torch.equal(torch.gather(s3, 2, arg[:, :, None])[:, :, 0], bms.T)
    m2 = torch.where(torch.arange(64, device=cuda) == arg[:, :, None],
                     tk.PAD_SIM, s3).amax(dim=2)
    assert torch.equal(key.T, tk.pack_m2_argmax_key(m2, arg))


# -- the f32 tile against the exact chain ---------------------------------------


def _chain_outputs(chain, valid, t, sub=8, block=64, ew=128):
    """What K1 (sub ``sub``, argmax, coarse maxima at ``ew``), K3 and K5
    (block ``block``) must return, from the exact chain's scores."""
    chain = chain.clone()
    chain[:, valid:] = tk.PAD_SIM
    bms, arg, m2 = tk._plain_units(chain.T.reshape(-1, sub, t), True)
    bm = bms.reshape(-1, ew // sub, t).amax(dim=1)
    bm_t = chain.view(t, -1, block).amax(dim=2).T.contiguous()
    return chain, (bms, tk.pack_m2_argmax_key(m2, arg), bm), bm_t


def _hold_f32_tile_to_chain(q, mat, valid, sub=8, ew=128):
    """K1, K3 and K5 on f32 operands equal the exact FMA chain bit for bit,
    one launch each."""
    t = q.shape[0]
    want_sims, want_k1, want_bm_t = _chain_outputs(
        tk.fma_chain_scores(q, mat), valid, t, sub=sub, ew=ew)
    before = dict(tk.launch_counts)
    sims, bm_t = tk.matmul_blockmax(q, mat, valid, block=64)
    k5 = tk.matmul_blockmax_only(q, mat, valid, block=64)
    k1 = tk.matmul_blockmax2_only(q, mat, valid, sub=sub, block=max(ew, 128),
                                  emit_block=True, emit_argmax=True,
                                  emit_width=ew)
    torch.cuda.synchronize()
    assert torch.equal(sims, want_sims)
    assert torch.equal(bm_t, want_bm_t) and torch.equal(k5, want_bm_t)
    for got, want in zip(k1, want_k1):
        assert torch.equal(got, want)
    for name in ("matmul_blockmax", "matmul_blockmax_only",
                 "matmul_blockmax2_only"):
        assert tk.launch_counts[name] == before[name] + 1


@pytest.mark.parametrize("dim", [768, 100, 99, 2])
@pytest.mark.parametrize("t", [1, 40, 129, 300])
def test_f32_tile_is_the_fma_chain(cuda, dim, t):
    """K1 (emit width 128, and 256 through K10's row-tile walk), K3 and K5
    f32 bit for bit :func:`fma_chain_scores`: D on the 16-byte path (768,
    100) and the 4-byte one (99, 2), one query, a ragged query tile and
    two, valid rows inside the last row tile; raw normal queries and a
    store row among them."""
    g = torch.Generator(device=cuda)
    g.manual_seed(dim * 1000 + t)
    mat = torch.randn((1024, dim), generator=g, device=cuda)
    q = torch.randn((t, dim), generator=g, device=cuda)
    q[0] = mat[17]
    _hold_f32_tile_to_chain(q, mat, 1000)
    # K1 at emit width 256: K10's row-tile walk over the same tile
    _hold_f32_tile_to_chain(q, mat, 1000, sub=16, ew=256)


@pytest.mark.parametrize("dim", [768, 100])
def test_f32_tile_unaligned_view_is_the_fma_chain(cuda, dim):
    """Operands that are storage-offset views one float past a 16-byte
    boundary take the 4-byte copies and still give the chain's bits; K1 at
    emit width 256 (K10's row-tile walk) too."""
    g = torch.Generator(device=cuda)
    g.manual_seed(dim)
    mat = torch.randn(1024 * dim + 1, generator=g, device=cuda)[1:].view(1024, dim)
    q = torch.randn(130 * dim + 1, generator=g, device=cuda)[1:].view(130, dim)
    assert mat.data_ptr() % 16 and q.data_ptr() % 16 and mat.is_contiguous()
    _hold_f32_tile_to_chain(q, mat, 1000, sub=16, ew=256)


def test_wrapper_raises_on_refused_launch(cuda):
    """A bad launch surfaces as an exception, never a silent fallback."""
    q, mat = _operands(cuda, torch.float32)
    with pytest.raises(ValueError):
        tk.matmul_blockmax2_only(q, mat[:4000], 4000, sub=16)
    before = dict(tk.launch_counts)
    tk.matmul_blockmax(q, mat, 4096)
    assert tk.launch_counts["matmul_blockmax"] == before["matmul_blockmax"] + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel,argmax", [
    ("rescore", "auto"), ("rescore", "off"), ("global", "auto"),
])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_engine_exact_against_oracle(cuda, dtype, kernel, argmax, k):
    rng = np.random.default_rng(k)
    mat = rng.standard_normal((20000, 256)).astype(np.float32)
    mat[[5000, 5001, 9000]] = mat[17]          # duplicates: lowest id first
    store = DeviceStore.from_host(mat, dtype, device=cuda)
    eng = SearchEngine(store, SearchConfig(kernel=kernel,
                                           rescore_argmax=argmax))
    queries = mat[rng.integers(0, 20000, 64)]
    queries[0] = mat[17]
    ids, dists = eng.search(queries, k)
    o_ids, o_d = eng.oracle_topk(queries, k)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(dists, o_d)
    assert top_k_overlap(o_ids.tolist(), ids.tolist(), k) == 1.0
    if k >= 4:
        np.testing.assert_array_equal(ids[0, :4], [17, 5000, 5001, 9000])


# -- the int8 bodies of K1/K2/K3 ----------------------------------------------


def _int8_operands(cuda, dim, rows=4096, t=40):
    from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit

    q, mat = _operands(cuda, torch.float32, rows=rows, dim=dim, t=t)
    return quantize_unit(q).contiguous(), quantize_unit(mat).contiguous()


@pytest.mark.parametrize("sub", [16, 64])
@pytest.mark.parametrize("dim", [256, 768, 102])  # 102: a ragged last pack
def test_k1_int8_matches_plain_bitwise(cuda, sub, dim):
    """Bound: none. An int8 score is an exact integer dot times one f32
    constant, so kernel and plain version agree bit for bit, keys too."""
    q, mat = _int8_operands(cuda, dim)
    before = tk.launch_counts["matmul_blockmax2_only_int8"]
    for argmax, block in ((True, True), (True, False), (False, True),
                          (False, False)):
        out = tk.matmul_blockmax2_only(q, mat, 4000, sub=sub, block=128,
                                       emit_block=block, emit_argmax=argmax)
        ref = tk.matmul_blockmax2_only_plain(q, mat, 4000, sub=sub,
                                             block=128, emit_block=block,
                                             emit_argmax=argmax)
        for a, b in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(a, b)
    assert tk.launch_counts["matmul_blockmax2_only_int8"] == before + 4


@pytest.mark.parametrize("dim", [256, 768, 102])
@pytest.mark.parametrize("unit,ks", [(64, 4), (64, 100), (16, 8)])
def test_k2_k3_int8_match_plain_bitwise(cuda, dim, unit, ks):
    q, mat = _int8_operands(cuda, dim)
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    ids = torch.randint(0, mat.shape[0] // unit, (q.shape[0], ks),
                        generator=g, device=cuda).to(torch.int32)
    out = tk.gather_rescore(q, mat, ids, unit=unit)
    assert torch.equal(out, tk.gather_rescore_plain(q, mat, ids, unit=unit))
    sims, bm = tk.matmul_blockmax(q, mat, 4001)
    p_sims, p_bm = tk.matmul_blockmax_plain(q, mat, 4001)
    assert torch.equal(sims, p_sims) and torch.equal(bm, p_bm)
    rows = (ids.long()[:, :, None] * unit
            + torch.arange(unit, device=cuda)).reshape(q.shape[0], -1)
    valid = rows < 4001
    assert torch.equal(out[valid], torch.gather(sims, 1, rows)[valid])


def test_k2_int8_unaligned_rows(cuda):
    """Rows of an odd dim start at odd byte offsets: the packs are built a
    byte at a time and still agree bit for bit."""
    q, mat = _int8_operands(cuda, 99, rows=1024)
    ids = torch.arange(8, device=cuda, dtype=torch.int32).expand(
        q.shape[0], 8).contiguous()
    assert torch.equal(tk.gather_rescore(q, mat, ids, unit=16),
                       tk.gather_rescore_plain(q, mat, ids, unit=16))


@pytest.mark.parametrize("kernel,argmax", [
    ("rescore", "auto"), ("rescore", "off"), ("global", "auto"),
])
@pytest.mark.parametrize("dim", [768, 256])
def test_engine_int8_exact_against_oracle(cuda, kernel, argmax, dim):
    rng = np.random.default_rng(dim)
    mat = rng.standard_normal((20000, dim)).astype(np.float32)
    mat[[5000, 5001, 9000]] = mat[17]
    store = DeviceStore.from_host(mat, "int8", device=cuda)
    eng = SearchEngine(store, SearchConfig(kernel=kernel,
                                           rescore_argmax=argmax))
    queries = mat[rng.integers(0, 20000, 64)]
    queries[0] = mat[17]
    tk.reset_launch_counts()
    ids, dists = eng.search(queries, 100)
    o_ids, o_d = eng.oracle_topk(queries, 100)
    np.testing.assert_array_equal(ids, o_ids)
    np.testing.assert_array_equal(dists, o_d)
    np.testing.assert_array_equal(ids[0, :4], [17, 5000, 5001, 9000])
    first = "matmul_blockmax2_only" if kernel == "rescore" else "matmul_blockmax"
    assert tk.launch_counts[first + "_int8"] > 0
    assert tk.launch_counts[first] == 0


# -- the int8 score tile on the s8 tensor cores (wgmma fed by TMA) ------------


def _tile_i8_operands(cuda, case, rows=2048, t=200):
    """int8 operands of one case: the lattice at D 99, 100 (the thread-staged
    slabs), 256 and 768 (TMA); raw rows of which 70 % are -128 at D 1040
    (``sum_d |q_d r_d| < 2^24`` asserted: the dots stay exact in f32); or
    768-d views whose rows start one byte past 16-byte alignment."""
    rng = np.random.default_rng(len(case) + rows)
    dim = int(case.split("_")[0][1:])
    if case.endswith("neg128"):
        def heavy(n):
            m = rng.integers(-128, 128, size=(n, dim), dtype=np.int64)
            m[rng.random((n, dim)) < 0.7] = -128
            return m.astype(np.int8)
        mat = heavy(rows)
        q = np.concatenate([mat[[3, 100, 7]], np.full((1, dim), -128, np.int8),
                            heavy(t - 4)])
        mag = np.abs(q.astype(np.int64)) @ np.abs(mat.astype(np.int64)).T
        assert mag.max() < 2 ** 24
    else:
        from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit_host

        m = rng.standard_normal((rows, dim)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        mat = quantize_unit_host(m)
        q = np.concatenate([mat[[3, 100, 7]], quantize_unit_host(
            -m[rng.integers(0, rows, t - 3)])])
    q, mat = torch.from_numpy(q).to(cuda), torch.from_numpy(mat).to(cuda)
    if case.endswith("offset"):
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        q, mat = shifted(q), shifted(mat)
        assert q.data_ptr() % 16 and mat.data_ptr() % 16 and mat.is_contiguous()
    return q, mat


@pytest.mark.parametrize("case", ["d99", "d100", "d256", "d768", "d1040_neg128",
                                  "d768_offset"])
def test_int8_tile_kernels_match_plain_bitwise(cuda, case):
    """K1 (ew 128 and, on K10's walk, ew 256), K3, K5 and K10 (scores and
    the raw key) on int8 operands, bit for bit their plain versions: 200
    queries (a ragged query tile), 2048 rows with the last 37 masked; every
    launch counted."""
    q, mat = _tile_i8_operands(cuda, case)
    valid = mat.shape[0] - 37
    names = ("matmul_blockmax2_only_int8", "matmul_blockmax_int8",
             "matmul_blockmax_only", "matmul_blockmax2x")
    before = {n: tk.launch_counts[n] for n in names}
    pairs = []
    for kw in (dict(sub=16, block=128), dict(sub=128, block=1024, emit_width=256)):
        kw.update(emit_block=True, emit_argmax=True)
        pairs.append((tk.matmul_blockmax2_only(q, mat, valid, **kw),
                      tk.matmul_blockmax2_only_plain(q, mat, valid, **kw)))
    pairs.append((tk.matmul_blockmax(q, mat, valid),
                  tk.matmul_blockmax_plain(q, mat, valid)))
    pairs.append((tk.matmul_blockmax_only(q, mat, valid, block=32),
                  tk.matmul_blockmax_only_plain(q, mat, valid, block=32)))
    kw = dict(sub=64, emit_sims=True, emit_arg=True, emit_raw_key=True)
    pairs.append((tk.matmul_blockmax2x(q, mat, valid, **kw),
                  tk.matmul_blockmax2x_plain(q, mat, valid, **kw)))
    torch.cuda.synchronize()
    for got, want in pairs:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    after = {n: tk.launch_counts[n] - before[n] for n in names}
    assert after == {"matmul_blockmax2_only_int8": 2, "matmul_blockmax_int8": 1,
                     "matmul_blockmax_only": 1, "matmul_blockmax2x": 1}, after


@pytest.mark.parametrize("block", [1, 2, 8])
def test_k5_int8_small_blocks_are_k3_bm(cuda, block):
    """K5's int8 block maxima at blocks of 1-8 rows (one or a few rows per
    lane of its max pass) bit for bit K3's ``bm_t`` and the plain version's."""
    q, mat = _tile_i8_operands(cuda, "d256")
    bm = tk.matmul_blockmax_only(q, mat, 2000, block=block)
    _, k3_bm = tk.matmul_blockmax(q, mat, 2000, block=block)
    plain = tk.matmul_blockmax_only_plain(q, mat, 2000, block=block)
    torch.cuda.synchronize()
    assert torch.equal(bm, k3_bm) and torch.equal(bm, plain)


# -- K4 gather_rows, K6 block_scores and the certified f32 route ---------------


@pytest.mark.parametrize("dtype,dim,unit", [
    (torch.float32, 768, 8), (torch.bfloat16, 768, 16), (torch.int8, 768, 32),
    (torch.float32, 99, 1), (torch.int8, 99, 3),   # runs off 16-byte alignment
])
def test_k4_matches_plain_bitwise(cuda, dtype, dim, unit):
    """Bound: none — K4 moves bytes. An id outside [0, R/unit) gives 0xFF
    bytes and reads nothing past the store."""
    rows = 6144  # a multiple of every unit here
    if dtype == torch.int8:
        q, mat = _int8_operands(cuda, dim, rows=rows)
    else:
        q, mat = _operands(cuda, dtype, rows=rows, dim=dim)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    n_units = mat.shape[0] // unit
    ids = torch.randint(0, n_units, (40, 24), generator=g, device=cuda)
    ids[:, 1] = ids[:, 0]
    ids[5, 2], ids[6, 3], ids[7, 4] = -1, n_units, 2**31 - 1
    ids = ids.to(torch.int32).contiguous()
    before = tk.launch_counts["gather_rows"]
    out = tk.gather_rows(mat, ids, unit=unit)
    ref = tk.gather_rows_plain(mat, ids, unit=unit)
    torch.cuda.synchronize()
    assert tk.launch_counts["gather_rows"] == before + 1
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
    bad = out.view(40, 24, unit, dim)[[5, 6, 7], [2, 3, 4]]
    assert bool((bad.view(torch.uint8) == 0xFF).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dim", [768, 100])
def test_k6_equals_k3_and_k2(cuda, dtype, dim):
    """K6 over K4's rows gives K3's and K2's scores of the same pairs bit
    for bit (one scoring body); against its plain version within TOL on
    float rows and bit for bit on int8."""
    if dtype == torch.int8:
        q, mat = _int8_operands(cuda, dim, rows=4096)
    else:
        q, mat = _operands(cuda, dtype, rows=4096, dim=dim)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    ids = torch.sort(torch.randint(0, 4096 // 8, (q.shape[0], 64),
                                   generator=g, device=cuda), dim=1).values
    ids = ids.to(torch.int32).contiguous()
    rows = tk.gather_rows(mat, ids, unit=8)
    out = tk.block_scores(q, rows)
    sims, _ = tk.matmul_blockmax(q, mat, 4096)
    pos = (ids.long()[:, :, None] * 8
           + torch.arange(8, device=cuda)).reshape(q.shape[0], -1)
    assert torch.equal(out, torch.gather(sims, 1, pos))
    assert torch.equal(out, tk.gather_rescore(q, mat, ids, unit=8))
    ref = tk.block_scores_plain(q, rows)
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max() <= TOL


def test_f32cert_route_exact_on_both_branches(cuda):
    """The certified route at 65,536 x 768 f32 equals the oracle bit for
    bit: on random rows the certificate holds, on a store of one repeated
    64-row block it fails and the dense branch answers."""
    from better_search_rag_rust_tpu_torch.ops import topk as port_topk

    rng = np.random.default_rng(0)
    mats = {
        "certified": rng.standard_normal((65536, 768)).astype(np.float32),
        "dense": np.tile(rng.standard_normal((64, 768)).astype(np.float32),
                         (1024, 1)),
    }
    for branch, mat in mats.items():
        eng = SearchEngine(DeviceStore.from_host(mat, "float32", device=cuda),
                           SearchConfig(f32_certified="on"))
        queries = mat[rng.integers(0, 65536, 512)]
        tk.reset_launch_counts()
        port_topk.reset_cert_counts()
        ids, dists = eng.search(queries, 100)
        assert port_topk.cert_counts[branch] == 1, port_topk.cert_counts
        for name in ("matmul_blockmax2_only", "gather_rows", "block_scores"):
            assert tk.launch_counts[name] > 0, tk.launch_counts
        o_ids, o_d = eng.oracle_topk(queries, 100)
        np.testing.assert_array_equal(ids, o_ids)
        np.testing.assert_array_equal(dists, o_d)


def test_batcher_reads_the_card_memory(cuda):
    from better_search_rag_rust_tpu_torch.batcher import _device_bytes_limit

    t = torch.zeros(4, device=cuda)
    assert _device_bytes_limit((t,)) == torch.cuda.get_device_properties(
        cuda).total_memory


# -- K8 fused_attention_qkv ---------------------------------------------------


def _attention_operands(cuda, b, s, h, hd, seed=0):
    import math

    from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * hd), generator=g, device=cuda)
    lens = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    lens[-1] = 0                                   # a fully padded row
    valid = torch.arange(s, device=cuda)[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32).contiguous()
    cos, sin = (torch.from_numpy(t).to(cuda)
                for t in rotary_tables(s, hd, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    return (qkv.to(torch.bfloat16), c2.contiguous(), s2.contiguous(), bias,
            valid, 1.0 / math.sqrt(hd))


@pytest.mark.parametrize("b,s,h,hd", [
    (4, 72, 3, 16), (3, 200, 2, 32), (8, 512, 12, 64), (2, 136, 4, 128),
    (2, 1024, 2, 64),
])
def test_k8_matches_plain(cuda, b, s, h, hd):
    """Bound: max |diff| < 0.02 and cosine > 0.999 on valid query rows (the
    JAX package's kernel-vs-einsum bound); fully padded rows finite."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd)
    before = ak.launch_counts["fused_attention_qkv"]
    out = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    ref = ak.fused_attention_qkv_plain(qkv, c2, s2, bias, h, scale)
    torch.cuda.synchronize()
    assert ak.launch_counts["fused_attention_qkv"] == before + 1
    assert torch.isfinite(out.float()).all()
    a, r = out.float()[valid], ref.float()[valid]
    assert (a - r).abs().max() < 0.02
    assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999


def test_k8_refuses_what_it_does_not_take(cuda):
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, 2, 64, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        ak.fused_attention_qkv(qkv.float(), c2, s2, bias, 2, scale)
    q24, c24, s24, b24, _, _ = _attention_operands(cuda, 2, 64, 2, 24)
    with pytest.raises(ValueError, match="head dims"):
        ak.fused_attention_qkv(q24, c24, s24, b24, 2, scale)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_attention_qkv(qkv, c2.t().contiguous().t(), s2, bias, 2,
                               scale)


def test_encoder_fused_matches_plain_attention(cuda):
    """The bf16 encoder on K8 against the same weights on the plain f32-logit
    chain: cosine >= 0.999 per embedding row."""
    from better_search_rag_rust_tpu_torch.models.nomic import (
        NomicBertConfig,
        NomicEncoder,
    )

    cfg = dict(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
               mlp_dim=512, max_tokens=128)
    fused = NomicEncoder(NomicBertConfig(attention_impl="fused", **cfg),
                         seed=1, device=cuda)
    plain = NomicEncoder(NomicBertConfig(attention_impl="xla", **cfg),
                         state_dict=fused.model.state_dict(), device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(16, 128)).astype(np.int32)
    mask = (np.arange(128)[None, :]
            < rng.integers(1, 129, size=16)[:, None]).astype(np.int32)
    a = fused.encode_tokens(ids, mask)
    b = plain.encode_tokens(ids, mask)
    assert np.all(np.sum(a * b, axis=1) >= 0.999)


# -- K9 fused_attention_qkv_bwd and training ----------------------------------


@pytest.mark.parametrize("b,s,h,hd", [
    (4, 72, 3, 16), (3, 200, 2, 32), (8, 512, 12, 64), (2, 136, 4, 128),
    (2, 1024, 2, 64), (2, 1024, 1, 128),
])
def test_k9_matches_plain(cuda, b, s, h, hd):
    """Bound: cosine >= 0.999 and max |diff| <= 1e-2 * max |plain| for each
    of dq, dk and dv (the kernel and plain version sum in other orders,
    then round to bf16); every value finite, the fully padded row too;
    the kernel deterministic (no atomics: two launches agree bitwise)."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    g = torch.randn((b, s, h * hd), generator=gen, device=cuda).to(
        torch.bfloat16)
    before = ak.launch_counts["fused_attention_qkv_bwd"]
    out = ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale)
    again = ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale)
    ref = ak.fused_attention_qkv_bwd_plain(qkv, c2, s2, bias, g, h, scale)
    torch.cuda.synchronize()
    assert ak.launch_counts["fused_attention_qkv_bwd"] == before + 2
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    for a, r in zip(out.double().chunk(3, -1), ref.double().chunk(3, -1)):
        assert float((a * r).sum() / (a.norm() * r.norm())) >= 0.999
        assert (a - r).abs().max() <= 1e-2 * r.abs().max()


def _k9_case(cuda, b, s, h, hd, seed=0, mul=1):
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd,
                                                          seed=seed)
    qkv = qkv * mul
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed + 7)
    g = torch.randn((b, s, h * hd), generator=gen, device=cuda).to(
        torch.bfloat16)
    out = ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale)
    again = ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale)
    ref = ak.fused_attention_qkv_bwd_plain(qkv, c2, s2, bias, g, h, scale)
    torch.cuda.synchronize()
    return out, again, ref, valid


def _k9_within_bound(out, ref):
    """Phase 9's bound for each of dq, dk and dv: max |diff| <= 1e-2 max
    |plain| and cosine >= 0.999."""
    for a, r in zip(out.double().chunk(3, -1), ref.double().chunk(3, -1)):
        assert float((a * r).sum() / (a.norm() * r.norm())) >= 0.999
        assert (a - r).abs().max() <= 1e-2 * r.abs().max()


@pytest.fixture(scope="module")
def k9_dump_lib():
    """A debug build of the attention source (``bench/ab_attn.py``'s
    ``@dump``: K9_DUMP) whose K9 writes both passes' p, dp and ds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    return next(iter(ab_attn.build([ab_attn.source_path("@dump")]).values()))[0]


@pytest.mark.parametrize("s,hd", [
    (136, 64), (512, 64), (520, 64), (72, 128), (1024, 128), (200, 16),
    (136, 32), (72, 16), (1024, 32), (40, 64),
])
def test_k9_p_and_ds_bitwise_across_passes(cuda, k9_dump_lib, s, hd):
    """The query kernel takes Q K^T and G V^T, the key kernel K Q^T and V
    G^T: each k16 step must give each (query, key) cell the same f32 both
    ways, so that p, dp and ds agree bit for bit between the kernels (else
    bf16(p) and ds drift between dq and dk/dv). Every cell of every head,
    with a fully padded batch row, at partial 64-row tiles (S % 64 != 0,
    S 40 below one tile), S % 16 == 8, every head width and S 1024."""
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    b, h = 2, 2
    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd, seed=3)
    g = torch.randn((b, s, h * hd), device=cuda).to(torch.bfloat16)
    res = ab_attn.k9_dump_compare(k9_dump_lib, qkv, c2, s2, bias, g, h, scale)
    assert res["written"] and res["cells"] == b * h * s * s
    assert res["p"] and res["dp"] and res["ds"], res


@pytest.mark.parametrize("s,hd", [
    (72, 64), (136, 64), (72, 128), (136, 128),   # S % 16 == 8
    (512, 64), (520, 64), (512, 128), (520, 128),  # whole / partial last tile
    (1024, 64), (1024, 128),                       # the longest sequence
    (72, 16), (520, 16), (1024, 16),               # hd 16: the 32-byte swizzle
    (72, 32), (520, 32), (1024, 32),               # hd 32: the 64-byte swizzle
    (8, 64), (40, 16), (64, 128), (128, 32),       # one tile or less a block
])
def test_k9_at_the_layout_edges(cuda, s, hd):
    """Partial 64-row tiles (S % 64 != 0, rows past S read as zeros and not
    stored; a consumer whose whole tile lies past S), half-empty k16 steps
    (S % 16 == 8), one block's worth of rows or fewer, and S 1024, at every
    head width, with a fully padded batch row: within phase 9's bound of
    the plain version, the fully padded row too, every value finite and
    two launches bit for bit."""
    out, again, ref, valid = _k9_case(cuda, 2, s, 2, hd)
    assert not bool(valid[-1].any())
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    _k9_within_bound(out, ref)
    _k9_within_bound(out[-1], ref[-1])


def test_k9_bodies_do_not_spill(cuda):
    """ptxas's report of the tree's attention source: the rotary pre-pass,
    the query kernel and the key kernel at hd 16, 32, 64 and 128, each
    with 0 bytes of spill stores and loads."""
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    _lib, report = next(iter(ab_attn.build([ab_attn.TREE_SOURCE]).values()))
    bodies = [line for line in report
              if any(k in line for k in ("k9_rotate_qk", "k9_wg_query", "k9_wg_key"))]
    assert len(bodies) == 12, report
    for line in bodies:
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
        assert spills and spills.groups() == ("0", "0"), line


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_k9_bitwise_across_launches(cuda, hd):
    """No atomics and fixed reduction orders: two launches agree bit for
    bit at every head width."""
    out, again, ref, _ = _k9_case(cuda, 3, 200, 2, hd, seed=1)
    assert torch.equal(out, again)
    _k9_within_bound(out, ref)


def test_k9_with_qkv_scaled_by_8(cuda):
    """qkv x 8 (exact in bf16): logits 64x wider, p near one-hot. The bound
    is relative to max |plain| (phase 9's), so it scales with the
    gradients as test_k8_k7_with_qkv_scaled_by_8 scales its absolute bound
    by 8."""
    out, again, ref, _ = _k9_case(cuda, 4, 200, 3, 64, seed=3, mul=8)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, again)
    _k9_within_bound(out, ref)


def test_k9_unaligned_operands_are_copied(cuda):
    """K9 reads qkv and g through TMA: views off a 16-byte
    boundary are copied to aligned ones, and the result is the aligned
    operands' bit for bit."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = 2, 64, 2, 64
    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd)
    g = torch.randn((b, s, h * hd), device=cuda).to(torch.bfloat16)
    shifted = torch.empty(qkv.numel() + 8, dtype=qkv.dtype, device=cuda)
    q_off = shifted[1:1 + qkv.numel()].view(qkv.shape)
    q_off.copy_(qkv)
    g_shift = torch.empty(g.numel() + 8, dtype=g.dtype, device=cuda)
    g_off = g_shift[3:3 + g.numel()].view(g.shape)
    g_off.copy_(g)
    assert q_off.data_ptr() % 16 and g_off.data_ptr() % 16
    assert torch.equal(
        ak.fused_attention_qkv_bwd(q_off, c2, s2, bias, g_off, h, scale),
        ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale))


def test_k9_refuses_what_it_does_not_take(cuda):
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, 2, 64, 2, 64)
    g = torch.zeros((2, 64, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ak.fused_attention_qkv_bwd(qkv.float(), c2, s2, bias, g.float(), 2,
                                   scale)
    with pytest.raises(ValueError, match="contiguous"):
        ak.fused_attention_qkv_bwd(qkv, c2, s2, bias,
                                   g.transpose(0, 1).contiguous()
                                   .transpose(0, 1), 2, scale)


def test_fused_model_gives_wqkv_a_gradient(cuda):
    """The K8 output carries a gradient on the card: backward through a
    ``fused`` NomicBertModel reaches Wqkv through K9."""
    from better_search_rag_rust_tpu_torch.models.nomic import (
        NomicBertConfig,
        NomicBertModel,
        init_random,
    )
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    cfg = NomicBertConfig(vocab_size=1000, hidden_size=256, num_layers=2,
                          num_heads=4, mlp_dim=512, max_tokens=128,
                          attention_impl="fused", param_dtype=torch.float32)
    model = NomicBertModel(cfg, device=cuda)
    init_random(model, 0)
    ids = torch.randint(1, 1000, (4, 128), device=cuda)
    mask = torch.ones_like(ids)
    probe = torch.randn((4, 128, 256), device=cuda)
    before = ak.launch_counts["fused_attention_qkv_bwd"]
    (model(ids, mask).float() * probe).sum().backward()
    assert ak.launch_counts["fused_attention_qkv_bwd"] == before + 2
    for layer in model.encoder.layers:
        grad = layer.attn.Wqkv.weight.grad
        assert grad is not None and grad.dtype == torch.float32
        assert bool(torch.isfinite(grad).all()) and grad.abs().sum() > 0


def test_trainer_steps_on_the_card(cuda):
    from better_search_rag_rust_tpu_torch.models.nomic import NomicBertConfig
    from better_search_rag_rust_tpu_torch.models.train import (
        ContrastiveTrainer,
    )

    cfg = NomicBertConfig(vocab_size=1000, hidden_size=128, num_layers=2,
                          num_heads=2, mlp_dim=256, max_tokens=64)
    tr = ContrastiveTrainer(cfg, learning_rate=1e-3, device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 1000, size=(16, 64)).astype(np.int32)
    mask = np.ones_like(ids)
    losses = [tr.train_step(ids, mask, ids, mask) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -- K5 matmul_blockmax_only, K7 fused_attention, the empty batch ---------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("block", [128, 32])
@pytest.mark.parametrize("t,valid", [(40, 4096), (300, 4001)])
def test_k5_is_k3_bm_and_matches_plain(cuda, dtype, block, t, valid):
    """K5's block maxima are K3's bit for bit (one score chain); against
    the plain version within 1e-5 (0 on int8, an exact integer dot)."""
    if dtype == torch.int8:
        q, mat = _int8_operands(cuda, 256, t=t)
    else:
        q, mat = _operands(cuda, dtype, t=t)
    before = tk.launch_counts["matmul_blockmax_only"]
    bm = tk.matmul_blockmax_only(q, mat, valid, block=block)
    assert tk.launch_counts["matmul_blockmax_only"] == before + 1
    _, k3_bm = tk.matmul_blockmax(q, mat, valid, block=block)
    plain = tk.matmul_blockmax_only_plain(q, mat, valid, block=block)
    torch.cuda.synchronize()
    assert bm.shape == (mat.shape[0] // block, t)
    assert torch.equal(bm, k3_bm)
    assert (bm - plain).abs().max() <= (0 if dtype == torch.int8 else TOL)


@pytest.mark.parametrize("b,s,h,hd", [(4, 72, 3, 16), (8, 512, 12, 64),
                                      (2, 136, 4, 128)])
def test_k7_matches_plain_and_k8(cuda, b, s, h, hd):
    """K7 against its plain version within K8's bound, and on the
    transposed Wqkv layout bit for bit K8's output."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd)
    q, k, v = (x.contiguous() for x in
               qkv.view(b, s, 3, h, hd).permute(2, 0, 3, 1, 4))
    before = ak.launch_counts["fused_attention"]
    out = ak.fused_attention(q, k, v, c2, s2, bias, scale)
    ref = ak.fused_attention_plain(q, k, v, c2, s2, bias, scale)
    k8 = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    torch.cuda.synchronize()
    assert ak.launch_counts["fused_attention"] == before + 1
    assert torch.isfinite(out.float()).all()
    rows = valid[:, None, :].expand(b, h, s)
    a, r = out.float()[rows], ref.float()[rows]
    assert (a - r).abs().max() < 0.02
    assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999
    assert torch.equal(out.permute(0, 2, 1, 3).reshape(b, s, h * hd), k8)


@pytest.mark.parametrize("kernel,dtype", [
    ("global", "bfloat16"), ("rescore", "bfloat16"), ("rescore", "int8"),
    ("f32cert", "float32"),
])
def test_empty_batch_on_every_route(cuda, kernel, dtype):
    """Q = 0 gives [0, k] results on every route and entry point."""
    store = DeviceStore.synthetic(4096, 64, dtype, 0, device=cuda)
    eng = SearchEngine(store, SearchConfig(top_k=10, kernel=kernel,
                                           store_dtype=dtype))
    assert eng.kernel_name(10) == kernel
    empty = np.zeros((0, 64), np.float32)
    some = store.data[:5].float().cpu().numpy()
    ids, dists = eng.search(empty, 10)
    assert ids.shape == dists.shape == (0, 10)
    vals, dev_ids = eng.search_device(eng.prepare_device_queries(empty), 10)
    assert vals.shape == dev_ids.shape == (0, 10)
    assert eng.oracle_topk(empty, 10)[0].shape == (0, 10)
    want = eng.search(some, 10)
    got = list(eng.search_stream([some, empty, some], 10, depth=2))
    assert got[1][0].shape == (0, 10)
    for g in (got[0], got[2]):
        np.testing.assert_array_equal(g[0], want[0])


# -- K1 at emit widths above 128 rows, K10 matmul_blockmax2x -----------------


def _k10_operands(cuda, dtype, t=40, dim=256):
    if dtype == torch.int8:
        return _int8_operands(cuda, dim, t=t)
    return _operands(cuda, dtype, t=t, dim=dim)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
@pytest.mark.parametrize("sub,block,ew", [(128, 1024, 256), (64, 1024, 512),
                                          (16, 2048, 2048)])
@pytest.mark.parametrize("argmax", [True, False])
def test_k1_wide_emit_matches_plain(cuda, dtype, sub, block, ew, argmax):
    """K1 at coarse widths above its 128-row tile: unit outputs equal the
    ew-128 launch's bit for bit, coarse maxima the max of its 128-row ones;
    against the plain version within 1e-5 (0 on int8)."""
    q, mat = _k10_operands(cuda, dtype)
    kw = dict(sub=sub, block=block, emit_block=True, emit_argmax=argmax)
    wide = tk.matmul_blockmax2_only(q, mat, 4001, emit_width=ew, **kw)
    narrow = tk.matmul_blockmax2_only(q, mat, 4001, emit_width=128, **kw)
    plain = tk.matmul_blockmax2_only_plain(q, mat, 4001, emit_width=ew, **kw)
    torch.cuda.synchronize()
    assert wide[-1].shape == (mat.shape[0] // ew, q.shape[0])
    for a, b in zip(wide[:-1], narrow[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(wide[-1], narrow[-1].view(-1, ew // 128, q.shape[0])
                       .amax(dim=1))
    assert (wide[0] - plain[0]).abs().max() <= (0 if dtype == torch.int8
                                                 else TOL)
    assert (wide[-1] - plain[-1]).abs().max() <= (0 if dtype == torch.int8
                                                   else TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("sub,ew", [(8, 128), (16, 64), (64, 256),
                                    (128, 1024)])
def test_k10_is_k1_bitwise(cuda, dtype, sub, ew):
    """One score tile: K10's unit and coarse maxima are K1's, its (arg, m2)
    pack into K1's key, its t-major maxima are the transpose."""
    q, mat = _k10_operands(cuda, dtype)
    bms, key, bm = tk.matmul_blockmax2_only(
        q, mat, 4001, sub=sub, block=ew, emit_block=True, emit_argmax=True,
        emit_width=ew)
    before = tk.launch_counts["matmul_blockmax2x"]
    k_bms, arg, m2, k_bm = tk.matmul_blockmax2x(
        q, mat, 4001, sub=sub, emit_arg=True, emit_m2=True, emit_width=ew)
    (t_bms,) = tk.matmul_blockmax2x(q, mat, 4001, sub=sub, t_major=True)
    torch.cuda.synchronize()
    assert tk.launch_counts["matmul_blockmax2x"] == before + 2
    assert torch.equal(k_bms, bms) and torch.equal(k_bm, bm)
    assert torch.equal(arg, key & 0x7F)
    assert torch.equal(tk.pack_m2_argmax_key(m2, arg), key)
    assert torch.equal(t_bms, bms.T)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("t", [40, 300])
def test_k10_sims_are_k3_and_match_plain(cuda, dtype, t):
    q, mat = _k10_operands(cuda, dtype, t=t, dim=100 if dtype != torch.int8
                           else 102)
    sims, bms, bm = tk.matmul_blockmax2x(q, mat, 4001, sub=8, emit_sims=True,
                                         emit_width=128)
    k3_sims, _ = tk.matmul_blockmax(q, mat, 4001)
    p_sims, p_bms, p_bm = tk.matmul_blockmax2x_plain(
        q, mat, 4001, sub=8, emit_sims=True, emit_width=128)
    torch.cuda.synchronize()
    assert torch.equal(sims, k3_sims.T)
    bound = 0 if dtype == torch.int8 else TOL
    for a, b in ((sims, p_sims), (bms, p_bms), (bm, p_bm)):
        assert a.shape == b.shape and (a - b).abs().max() <= bound


@pytest.mark.parametrize("sub", [64, 128])
@pytest.mark.parametrize("ew", [0, 256])
def test_k10_int8_raw_key_and_scale_match_plain(cuda, sub, ew):
    """The raw integer key and a runtime scale, bit for bit the plain
    version's (exact integer dots); raw int8 rows in [-127, 127]."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    mat = torch.randint(-127, 128, (4096, 256), generator=g, device=cuda,
                        dtype=torch.int8)
    q = torch.randint(-127, 128, (40, 256), generator=g, device=cuda,
                      dtype=torch.int8)
    scale = float(np.float32(1.0) / np.float32(490000.0))
    kw = dict(sub=sub, emit_raw_key=True, emit_arg=True, emit_width=ew,
              inv_scale2=scale)
    got = tk.matmul_blockmax2x(q, mat, 4001, **kw)
    want = tk.matmul_blockmax2x_plain(q, mat, 4001, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


# -- K11 gather_copy and K12 gather_rescore_mm (the DMA gather prototypes) -----


def _unit_ids(cuda, n_units, t, ks, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    ids = torch.randint(0, n_units, (t, ks), generator=g, device=cuda)
    return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()


@pytest.mark.parametrize("dim,unit", [(256, 128), (768, 16), (136, 16),
                                      (128, 1)])
def test_k11_matches_plain_bitwise(cuda, dim, unit):
    """Bound: none — K11 moves bytes (a 64 KB unit in two 32 KB chunks at
    256 x 128). An id outside [0, R/unit) gives NaN and reads nothing."""
    _, mat = _operands(cuda, torch.bfloat16, rows=4096, dim=dim)
    n_units = 4096 // unit
    ids = _unit_ids(cuda, n_units, 40, 12, dim + unit)
    before = tk.launch_counts["gather_copy"]
    out = tk.gather_copy(mat, ids, unit=unit)
    torch.cuda.synchronize()
    assert tk.launch_counts["gather_copy"] == before + 1
    assert out.shape == (40, 12 * tk.V0_COLS) and out.dtype == torch.float32
    assert torch.equal(out, tk.gather_copy_plain(mat, ids, unit=unit))
    rows = tk.gather_rows(mat, ids, unit=unit).view(40, 12, unit, dim)
    assert torch.equal(out.view(40, 12, -1), rows[:, :, 0, :128].float())
    bad = ids.clone()
    bad[3, 2], bad[5, 7] = -1, n_units
    got = tk.gather_copy(mat, bad, unit=unit).view(40, 12, -1)
    assert bool(got[3, 2].isnan().all()) and bool(got[5, 7].isnan().all())
    keep = torch.ones((40, 12), dtype=torch.bool, device=cuda)
    keep[3, 2] = keep[5, 7] = False
    assert torch.equal(got[keep], out.view(40, 12, -1)[keep])


def test_k11_k12_refuse_what_they_do_not_take(cuda):
    q, mat = _operands(cuda, torch.float32, rows=4096, dim=256)
    ids = _unit_ids(cuda, 32, 40, 4, 0)
    with pytest.raises(TypeError, match="bf16"):
        tk.gather_copy(mat, ids, unit=128)
    with pytest.raises(TypeError, match="bf16"):
        tk.gather_rescore_mm(q, mat, ids, q, mat[:128], unit=128)
    q, mat = q.bfloat16(), mat.bfloat16()
    with pytest.raises(ValueError, match="at least 128"):
        tk.gather_copy(mat[:, :64].contiguous(), ids, unit=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.gather_rescore_mm(q, mat, ids, q, mat[:100], unit=128)


@pytest.mark.parametrize("copies,n", [(0, 128), (1, 128), (3, 256),
                                      (7, 512)])
@pytest.mark.parametrize("unit,ks", [(16, 8), (128, 3)])
def test_k12_is_k2_and_k5_and_matches_plain(cuda, copies, n, unit, ks):
    """K12's scores are K2's bit for bit (one arithmetic rule), its ``mmo`` K5's
    block maxima transposed bit for bit (one score tile, one reduction);
    against its plain version within 1e-5. ``tq`` 300 spans three query
    tiles; ``copies`` 0 leaves ``mmo`` NaN."""
    q, mat = _operands(cuda, torch.bfloat16, rows=4096, dim=256)
    mmq, mms = _operands(cuda, torch.bfloat16, rows=n, dim=256, t=300,
                         seed=5)
    ids = _unit_ids(cuda, 4096 // unit, 40, ks, unit)
    ids[1, 0] = -1
    before = tk.launch_counts["gather_rescore_mm"]
    mmo, scores = tk.gather_rescore_mm(q, mat, ids, mmq, mms, unit=unit,
                                       copies=copies)
    torch.cuda.synchronize()
    assert tk.launch_counts["gather_rescore_mm"] == before + 1
    assert scores.shape == (40, ks * unit) and mmo.shape == (300, n // 128)
    k2 = tk.gather_rescore(q, mat, ids, unit=unit)
    assert torch.equal(scores.isnan(), k2.isnan())
    assert torch.equal(scores.nan_to_num(), k2.nan_to_num())
    p_mmo, p_scores = tk.gather_rescore_mm_plain(q, mat, ids, mmq, mms,
                                                 unit=unit, copies=copies)
    ok = ~scores.isnan()
    assert (scores[ok] - p_scores[ok]).abs().max() <= TOL
    if copies:
        assert torch.equal(mmo, tk.matmul_blockmax_only(mmq, mms, n).T)
        assert (mmo - p_mmo).abs().max() <= TOL
    else:
        assert bool(mmo.isnan().all())


def test_k12_product_alone(cuda):
    """No ids (KS 0): the launch runs the product's copies alone."""
    q, mat = _operands(cuda, torch.bfloat16, rows=4096, dim=256)
    mms = mat[:256].contiguous()
    ids = torch.empty((40, 0), dtype=torch.int32, device=cuda)
    mmo, scores = tk.gather_rescore_mm(q, mat, ids, q, mms, unit=16,
                                       copies=5)
    torch.cuda.synchronize()
    assert scores.shape == (40, 0)
    assert torch.equal(mmo, tk.matmul_blockmax_only(q, mms, 256).T)


@pytest.mark.parametrize("unit,G", [(16, 1), (16, 4), (32, 2), (128, 1)])
@pytest.mark.parametrize("dim", [256, 100])  # 100: a ragged D chunk
def test_k13_matches_plain_and_its_diagonal_is_k2(cuda, unit, G, dim):
    """K13's full cross of each 8-query group against its plain version
    within TOL; its diagonal (each query's own sub-blocks) is K2's scores
    at the same unit bit for bit (one mma order). An id outside [0,
    R/unit) scores NaN for all 8 queries of its group."""
    from better_search_rag_rust_tpu_torch.bench.proto_fused import extract_diag

    q, mat = _operands(cuda, torch.bfloat16, rows=4096, dim=dim)
    ids = _unit_ids(cuda, 4096 // unit, 40, 8, unit + G)
    before = tk.launch_counts["gather_cross"]
    out = tk.gather_cross(q, mat, ids, unit=unit, G=G)
    torch.cuda.synchronize()
    assert tk.launch_counts["gather_cross"] == before + 1
    assert out.shape == (8 // G, 40, 8 * G * unit)
    assert (out - tk.gather_cross_plain(q, mat, ids, unit=unit, G=G)
            ).abs().max() <= TOL
    assert torch.equal(extract_diag(out, S=unit, G=G),
                       tk.gather_rescore(q, mat, ids, unit=unit))
    bad = ids.clone()
    bad[9, 1] = -1  # group 1, query 1 of it, slot 1
    got = tk.gather_cross(q, mat, bad, unit=unit, G=G)
    j, g = 1 // G, 1 % G
    cols = slice((g * 8 + 1) * unit, (g * 8 + 2) * unit)
    assert bool(got[j, 8:16, cols].isnan().all())
    got[j, 8:16, cols] = out[j, 8:16, cols]
    assert torch.equal(got, out)


def test_k13_refuses_what_it_does_not_take(cuda):
    """T % 8 and k % G (the script's grid would drop the tail), f32
    operands (the prototype is bf16); k 0 launches nothing."""
    q, mat = _operands(cuda, torch.bfloat16, rows=4096, dim=256)
    ids = _unit_ids(cuda, 256, 40, 6, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        tk.gather_cross(q[:36].contiguous(), mat, ids[:36].contiguous(),
                        unit=16, G=1)
    with pytest.raises(ValueError, match="multiple of G"):
        tk.gather_cross(q, mat, ids, unit=16, G=4)
    with pytest.raises(TypeError, match="bf16"):
        tk.gather_cross(q.float(), mat.float(), ids, unit=16, G=1)
    before = tk.launch_counts["gather_cross"]
    out = tk.gather_cross(q, mat, ids[:, :0].contiguous(), unit=16, G=2)
    assert out.shape == (0, 40, 256)
    assert tk.launch_counts["gather_cross"] == before


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
@pytest.mark.parametrize("dim", [768, 100, 64])  # 100: a ragged k16 step
def test_bf16_scores_within_f64_bound(cuda, kernel, dim):
    """Every bf16 score on the tensor cores within ``D * 2^-23 * sum |q_d
    r_d|`` of the float64 product of the same bf16 operands
    (``tk.score_bound``): the check that a wrong fragment layout cannot
    pass, where K1 = K2 = K3 would if all three shared it."""
    q, mat = _operands(cuda, torch.bfloat16, dim=dim, t=40)
    t, rows = q.shape[0], mat.shape[0]
    if kernel == "K3":
        sims, _ = tk.matmul_blockmax(q, mat, rows)
        exact, bound = tk.score_bound(q, mat)
    elif kernel == "K1":
        sims = tk.matmul_blockmax2_only(q, mat, rows, sub=16)
        exact, bound = tk.score_bound(q, mat)
        exact = exact.T.reshape(-1, 16, t).amax(dim=1)
        bound = bound.T.reshape(-1, 16, t).amax(dim=1)
    else:
        ids = _unit_ids(cuda, rows // 16, t, 12, dim)
        sims = tk.gather_rescore(q, mat, ids, unit=16)
        cols = (ids.long()[:, :, None] * 16
                + torch.arange(16, device=cuda)).reshape(t, -1)
        exact, bound = tk.score_bound(q, mat[cols])
    torch.cuda.synchronize()
    excess = (sims.double() - exact).abs() - bound
    assert float(excess.max()) <= 0.0, float(excess.max())


@pytest.mark.parametrize("argmax", ["on", "off"])
def test_rescore_duplicate_clusters_exact(cuda, argmax):
    """A store with duplicate clusters (one spanning two 64-row units, one
    across far units, a zero row) through the rescore route, argmax fast
    path on and off: ids and distances bit for bit ``oracle_topk`` (K3)."""
    rng = np.random.default_rng(11)
    mat = rng.standard_normal((40000, 768)).astype(np.float32)
    mat[1000:1040] = mat[17]
    mat[[30000, 30001, 39000]] = mat[500]
    mat[77] = 0.0
    store = DeviceStore.from_host(mat, "bfloat16", device=cuda)
    eng = SearchEngine(store, SearchConfig(kernel="rescore",
                                           rescore_argmax=argmax))
    queries = mat[rng.integers(0, 40000, 256)]
    queries[:3] = mat[[17, 500, 1020]]
    for k in (10, 100):
        assert eng.kernel_name(k) == "rescore"
        ids, dists = eng.search(queries, k)
        o_ids, o_d = eng.oracle_topk(queries, k)
        np.testing.assert_array_equal(ids, o_ids)
        np.testing.assert_array_equal(dists, o_d)


# -- K8 / K7 on the tensor cores -----------------------------------------------


def _head_major(qkv, h):
    b, s, width = qkv.shape
    return tuple(x.contiguous() for x in
                 qkv.view(b, s, 3, h, width // (3 * h)).permute(2, 0, 3, 1, 4))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_k7_k8_bitwise_across_launches_and_layouts(cuda, hd):
    """Two launches of K8, and of K7, agree bit for bit (no atomics); K7 on
    the transposed Wqkv output equals K8 bit for bit at every head width."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h = 3, 200, 2
    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd, seed=1)
    q, k, v = _head_major(qkv, h)
    k8 = [ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale) for _ in range(2)]
    k7 = [ak.fused_attention(q, k, v, c2, s2, bias, scale) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k8[0], k8[1]) and torch.equal(k7[0], k7[1])
    assert torch.equal(k7[0].permute(0, 2, 1, 3).reshape(b, s, h * hd), k8[0])


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_k8_fully_padded_row_at_s_mod_16_is_8(cuda, hd):
    """S 136 leaves half of the last k16 step past S: those keys must get
    e = 0, not the bias. A fully padded batch row then averages its S real
    V rows uniformly, as the plain version does (bound 0.02, the JAX
    package's)."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h = 2, 136, 2
    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd)
    assert not bool(valid[-1].any())               # the fully padded row
    out = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    ref = ak.fused_attention_qkv_plain(qkv, c2, s2, bias, h, scale)
    torch.cuda.synchronize()
    mean_v = qkv[-1].float().view(s, 3, h, hd)[:, 2].mean(dim=0).reshape(-1)
    assert (out[-1].float() - ref[-1].float()).abs().max() < 0.02
    assert (out[-1].float() - mean_v[None, :]).abs().max() < 0.02


def test_k8_k7_with_qkv_scaled_by_8(cuda):
    """qkv x 8 (exact in bf16): logits 64x wider stress the exponential and
    the max. Bound: the JAX package's 0.02 scaled by the same 8 (the context
    is a weighted mean of v, so its bf16 steps grow with v) and cosine >
    0.999 on valid rows; K7 = K8 bit for bit."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = 4, 200, 3, 64
    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd, seed=3)
    qkv = qkv * 8
    out = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    ref = ak.fused_attention_qkv_plain(qkv, c2, s2, bias, h, scale)
    k7 = ak.fused_attention(*_head_major(qkv, h), c2, s2, bias, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    a, r = out.float()[valid], ref.float()[valid]
    assert (a - r).abs().max() < 0.02 * 8
    assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999
    assert torch.equal(k7.permute(0, 2, 1, 3).reshape(b, s, h * hd), out)


@pytest.mark.parametrize("hd,s", [
    (64, 784), (64, 792),      # the mma.sync build's boundary at hd 64
    (64, 512), (64, 520),      # persistent / a block a head, K resident, V streamed
    (64, 832), (64, 840),      # K resident, V streamed (an older mode boundary)
    (128, 256), (128, 264),    # persistent / K resident, V streamed at hd 128
    (128, 384), (128, 392),
    (128, 512), (128, 520),    # K resident, V streamed / both streamed
    (128, 704), (128, 712),    # both streamed, one key tile apart
    (128, 1024),               # the longest sequence at the widest head
])
def test_k8_k7_at_the_shared_memory_edges(cuda, hd, s):
    """Each side of the shared-memory boundaries between the block modes
    (persistent to a block a head with V streamed: S 512 / 520 at hd 64,
    256 / 264 at hd 128; to both streamed: 512 / 520 at hd 128; an older
    mode's 832 / 840 and 384 / 392 and the mma.sync build's 784 / 792
    kept), the streamed one across key tiles, and S 1024 at hd 128: K8
    within the bound of its plain version, K7 bit for bit K8."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, h = 2, 2
    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd)
    out = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    ref = ak.fused_attention_qkv_plain(qkv, c2, s2, bias, h, scale)
    k7 = ak.fused_attention(*_head_major(qkv, h), c2, s2, bias, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    a, r = out.float()[valid], ref.float()[valid]
    assert (a - r).abs().max() < 0.02
    assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999
    assert torch.equal(k7.permute(0, 2, 1, 3).reshape(b, s, h * hd), out)


def test_k8_k7_unaligned_operands_are_copied(cuda):
    """TMA reads K and V from 16-byte aligned bases: a view off a 16-byte
    boundary is copied to an aligned one, not read misaligned nor refused;
    the result is the aligned operands' bit for bit."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = 2, 64, 2, 64
    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd)
    shifted = torch.empty(qkv.numel() + 8, dtype=qkv.dtype, device=cuda)
    off = shifted[1:1 + qkv.numel()].view(qkv.shape)
    off.copy_(qkv)
    assert off.is_contiguous() and off.data_ptr() % 16
    assert torch.equal(ak.fused_attention_qkv(off, c2, s2, bias, h, scale),
                       ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale))
    q, k, v = _head_major(qkv, h)
    q_off = shifted[1:1 + q.numel()].view(q.shape)
    q_off.copy_(q)
    assert torch.equal(ak.fused_attention(q_off, k, v, c2, s2, bias, scale),
                       ak.fused_attention(q, k, v, c2, s2, bias, scale))


def test_k8_k7_bodies_do_not_spill(cuda):
    """ptxas's report of the tree's attention source: K8 and K7 in each
    block mode a head width reaches (hd 16 and 32: persistent; hd 64 also a
    block a head, K resident with V streamed; hd 128 also both streamed),
    each with 0 bytes of spill stores and loads."""
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    _lib, report = next(iter(ab_attn.build([ab_attn.TREE_SOURCE]).values()))
    bodies = [line for line in report
              if "k8_fused_attention_qkv" in line or "k7_fused_attention" in line]
    assert len(bodies) == 14, report
    for line in bodies:
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
        assert spills and spills.groups() == ("0", "0"), line


@pytest.fixture(scope="module")
def attend_mma_sync_lib():
    """The attention source with K8/K7 on ``mma.sync`` as shipped before
    the wgmma body (``bench/ab_attn.py``'s ``@mma_sync``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    return next(iter(ab_attn.build([ab_attn.source_path("@mma_sync")]).values()))[0]


@contextlib.contextmanager
def _attention_library(lib):
    """The attention wrappers launch from the ctypes library ``lib`` inside
    the block."""
    from better_search_rag_rust_tpu_torch.ops import _build

    saved = _build._LIBRARIES.get("attention")
    _build._LIBRARIES["attention"] = _build.KernelLibrary(lib, Path(lib._name), 0.0, "")
    try:
        yield
    finally:
        if saved is None:
            _build._LIBRARIES.pop("attention", None)
        else:
            _build._LIBRARIES["attention"] = saved


@pytest.mark.parametrize("hd,s", [
    (16, 72), (16, 1024), (32, 200), (32, 1024),   # persistent; resident in mma.sync
    (64, 136), (64, 512), (64, 800),                # persistent; V streamed above 512
    (64, 840), (64, 1024),                          # V streamed in both
    (128, 136), (128, 320), (128, 392), (128, 1024),  # persistent, V streamed, the ring
])
def test_k8_k7_are_the_mma_sync_build_bitwise(cuda, attend_mma_sync_lib, hd, s):
    """Every output of K8 and K7 on wgmma is the mma.sync build's bit for
    bit: the logits by the same k16 sums (a wgmma k16 step with scale-d = 0
    is mma.sync's from +0.0) added in the same order, the same max, e and l
    order, PV accumulated in the instruction in the same key order (the PV
    probe: the two instructions' accumulations agree), at every head width,
    S % 16 == 8, partial key tiles, both sides of each build's resident /
    streamed boundary, and a fully padded batch row."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, h = 3, 2
    qkv, c2, s2, bias, valid, scale = _attention_operands(cuda, b, s, h, hd, seed=s + hd)
    hm = _head_major(qkv, h)
    got = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
           ak.fused_attention(*hm, c2, s2, bias, scale))
    with _attention_library(attend_mma_sync_lib):
        want = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
                ak.fused_attention(*hm, c2, s2, bias, scale))
    torch.cuda.synchronize()
    assert not bool(valid[-1].any())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["random", "constant", "scaled_negative"])
def test_k8_k7_other_biases_are_the_mma_sync_build_bitwise(cuda, attend_mma_sync_lib, kind):
    """Key biases other than 0 / -1e9 (a random bias on every key, one
    constant nonzero bias) and a negative scale: every output the mma.sync
    build's bit for bit, the pass-2 tile skip sound on each."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = 2, 520, 2, 64
    qkv, c2, s2, bias, _valid, scale = _attention_operands(cuda, b, s, h, hd, seed=11)
    if kind == "random":
        bias = torch.randn(bias.shape, device=cuda).contiguous()
    elif kind == "constant":
        bias = torch.full_like(bias, 2.5)
    else:
        scale = -scale
    hm = _head_major(qkv, h)
    got = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
           ak.fused_attention(*hm, c2, s2, bias, scale))
    with _attention_library(attend_mma_sync_lib):
        want = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
                ak.fused_attention(*hm, c2, s2, bias, scale))
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("hd", [64, 128])
def test_k8_k7_nan_keys_are_the_mma_sync_build_bitwise(cuda, attend_mma_sync_lib, hd):
    """A NaN in one padded key's k (past its row's length, in a key tile
    that pass 2 would otherwise skip: every e there is 0) and one in a
    query's q: the NaN logits keep their tiles, so every output, NaN or
    not, has the mma.sync build's bits."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h = 2, 512, 2
    qkv, c2, s2, bias, _valid, scale = _attention_operands(cuda, b, s, h, hd, seed=7)
    bias[0, 100:] = -1e9                             # row 0: 100 keys
    qkv[0, 400, (h + 1) * hd + 3] = float("nan")     # a padded key of head 1, tile 6
    qkv[1, 5, 0 * hd + 1] = float("nan")             # a query of head 0
    hm = _head_major(qkv, h)
    got = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
           ak.fused_attention(*hm, c2, s2, bias, scale))
    with _attention_library(attend_mma_sync_lib):
        want = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
                ak.fused_attention(*hm, c2, s2, bias, scale))
    torch.cuda.synchronize()
    assert bool(got[0][0, :, hd:].isnan().all()) and bool(got[0][1, 5, :hd].isnan().all())
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("value", ["nan", "inf", "-inf"])
@pytest.mark.parametrize("hd", [64, 128])
def test_k8_k7_nonfinite_v_at_a_padded_key_is_the_mma_sync_build_bitwise(
        cuda, attend_mma_sync_lib, hd, value):
    """A NaN or an inf in one padded key's v (past its row's length, in a
    key tile whose e is all 0, which pass 2 skips where V is finite):
    bf16(0) times it is NaN, so the tile runs, the head's column of that
    lane is NaN on every query row, and every output has the mma.sync
    build's bits."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h = 2, 512, 2
    qkv, c2, s2, bias, _valid, scale = _attention_operands(cuda, b, s, h, hd, seed=9)
    bias[0, 100:] = -1e9                             # row 0: 100 keys
    qkv[0, 400, (2 * h + 1) * hd + 5] = float(value)  # v of head 1 at a padded key, tile 6
    hm = _head_major(qkv, h)
    got = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
           ak.fused_attention(*hm, c2, s2, bias, scale))
    with _attention_library(attend_mma_sync_lib):
        want = (ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale),
                ak.fused_attention(*hm, c2, s2, bias, scale))
    torch.cuda.synchronize()
    nan = got[0].isnan()
    assert bool(nan[0, :, hd + 5].all()) and int(nan.sum()) == s
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int16), w.view(torch.int16))


def test_k8_is_the_mma_sync_build_bitwise_on_the_ab_operands(cuda, attend_mma_sync_lib):
    """The same on the operands of ``bench/ab_attn.py`` (its encoder shape,
    S 512, H 12, hd 64, at 16 batch rows; random key lengths, the last row
    fully padded)."""
    from better_search_rag_rust_tpu_torch.bench import ab_attn
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    qkv, c2, s2, bias, _valid, scale = ab_attn.operands(16, 0)
    got = ak.fused_attention_qkv(qkv, c2, s2, bias, ab_attn.H, scale)
    with _attention_library(attend_mma_sync_lib):
        want = ak.fused_attention_qkv(qkv, c2, s2, bias, ab_attn.H, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# -- K2 / K6 on the gather mainloop (gather_scores) ----------------------------


def _gather_operands(cuda, dtype, dim, rows=2048, t=24, offset=0):
    """Unit rows and queries of ``dtype`` (int8: the lattice); ``offset``
    elements in front of each in its buffer, so that a nonzero offset gives
    bases off the 16-byte (and for 1 or 2, the 4-byte) boundary."""
    if dtype == torch.int8:
        q, mat = _int8_operands(cuda, dim, rows=rows, t=t)
    else:
        q, mat = _operands(cuda, dtype, rows=rows, dim=dim, t=t)
    if not offset:
        return q, mat

    def shifted(x):
        buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=cuda)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        return view

    return shifted(q), shifted(mat)


def _gather_ids(cuda, t, n_units, ks, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    ids = torch.randint(0, n_units, (t, ks), generator=g, device=cuda)
    return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()


def _check_k2_k6(q, mat, ids, unit):
    """K2 bit for bit: f32 ``fma_chain_scores`` of the same pairs (and its
    plain version within TOL), int8 its plain version, bf16 K3's scores of
    the same pairs; K6 over K4's rows bit for bit K2."""
    t = q.shape[0]
    out = tk.gather_rescore(q, mat, ids, unit=unit)
    cols = (ids.long()[:, :, None] * unit
            + torch.arange(unit, device=q.device)).reshape(t, -1)
    if mat.dtype == torch.float32:
        chain = tk.fma_chain_scores(q, mat[cols])
        assert torch.equal(out, chain)
        ref = tk.gather_rescore_plain(q, mat, ids, unit=unit)
        assert (out - ref).abs().max() <= TOL
    elif mat.dtype == torch.int8:
        assert torch.equal(out, tk.gather_rescore_plain(q, mat, ids, unit=unit))
    else:
        sims, _ = tk.matmul_blockmax(q.contiguous(), mat.contiguous(), mat.shape[0])
        assert torch.equal(out, torch.gather(sims, 1, cols))
        ref = tk.gather_rescore_plain(q, mat, ids, unit=unit)
        assert (out - ref).abs().max() <= TOL
    rows = tk.gather_rows(mat, ids, unit=unit)
    k6 = tk.block_scores(q, rows)
    torch.cuda.synchronize()
    assert torch.equal(k6, out)
    if mat.dtype == torch.int8:
        assert torch.equal(k6, tk.block_scores_plain(q, rows))
    else:
        assert (k6 - tk.block_scores_plain(q, rows)).abs().max() <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dim", [768, 256, 130, 100, 99])
@pytest.mark.parametrize("unit,ks", [(64, 4), (8, 100), (16, 9)])
def test_gather_mainloop_bitwise(cuda, dtype, dim, unit, ks):
    """The 16-byte, 4-byte and byte staging paths (by D * itemsize) and a
    last block of fewer than 128 candidate rows (16 x 9)."""
    q, mat = _gather_operands(cuda, dtype, dim)
    ids = _gather_ids(cuda, q.shape[0], mat.shape[0] // unit, ks, seed=dim)
    _check_k2_k6(q, mat, ids, unit)


@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 1), (torch.float32, 3), (torch.bfloat16, 1),
    (torch.bfloat16, 2), (torch.int8, 1), (torch.int8, 4)])
@pytest.mark.parametrize("dim", [768, 100])
def test_gather_mainloop_unaligned_views(cuda, dtype, offset, dim):
    """Row-offset views whose bases sit off the 16-byte boundary (offset
    elements into their buffers) take the 4-byte copies (f32; bf16 at 4
    bytes; int8 at 4) or the byte copies (bf16 at 2 bytes, int8 at 1),
    with the same bits."""
    q, mat = _gather_operands(cuda, dtype, dim, offset=offset)
    assert (mat.data_ptr() | q.data_ptr()) % 16
    ids = _gather_ids(cuda, q.shape[0], mat.shape[0] // 16, 12, seed=offset)
    _check_k2_k6(q, mat, ids, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dim", [768, 99])
def test_gather_mainloop_invalid_ids_score_nan(cuda, dtype, dim):
    """Ids -1, n_units and 2^31 - 1 read nothing and score NaN over their
    whole unit; the other units keep their bits."""
    q, mat = _gather_operands(cuda, dtype, dim)
    unit, n_units = 16, mat.shape[0] // 16
    ids = _gather_ids(cuda, q.shape[0], n_units, 8, seed=5)
    bad = ids.clone()
    bad[0, 0], bad[3, 7], bad[5, 2] = -1, n_units, 2**31 - 1
    out = tk.gather_rescore(q, mat, bad, unit=unit).view(q.shape[0], 8, unit)
    good = tk.gather_rescore(q, mat, ids, unit=unit).view(q.shape[0], 8, unit)
    mask = torch.zeros(out.shape[:2], dtype=torch.bool, device=cuda)
    mask[0, 0] = mask[3, 7] = mask[5, 2] = True
    assert bool(out[mask].isnan().all())
    assert torch.equal(out[~mask], good[~mask])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("argmax", ["auto", "off"])
def test_rescore_nonfinite_inputs_on_the_card(cuda, dtype, argmax):
    """The non-finite probe of ``tests/test_torch_nonfinite.py`` on the
    card: a NaN store row (row 5) with queries rows 5 and 6, k 4, gives the
    JAX engine's ids (read on the CPU: ``[[0, 1, 2, 3], [5, 6, 12, 27]]``);
    a NaN and a +-inf query entry give the port's oracle's ids; no finite
    query gets an id past the store."""
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((64, 32)).astype(np.float32)
    mat[10], mat[7] = mat[3], 0.0
    nan_mat = mat.copy()
    nan_mat[5, 0] = np.nan
    cfg = SearchConfig(kernel="rescore", rescore_argmax=argmax)
    eng = SearchEngine(DeviceStore.from_host(nan_mat, dtype, device=cuda), cfg)
    ids = eng.search(nan_mat[[5, 6]], 4)[0]
    np.testing.assert_array_equal(ids, [[0, 1, 2, 3], [5, 6, 12, 27]])
    eng = SearchEngine(DeviceStore.from_host(mat, dtype, device=cuda), cfg)
    assert eng._argmax_enabled() is (argmax == "auto")
    for value in (np.nan, np.inf, -np.inf):
        q = mat[[0, 1, 9]].copy()
        q[:2, 0] = value
        ids = eng.search(q, 3)[0]
        np.testing.assert_array_equal(ids, eng.oracle_topk(q, 3)[0])
        assert (ids[2] < 64).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("rows,n", [(10, 8), (5000, 3), (600_000, 2)])
def test_sharded_engine_on_the_card_equals_one_shard(cuda, dtype, rows, n):
    """Shards on one card (empty shards at 10 rows on 8; K3 per shard at
    600,000 rows on 2, where one shard takes K1 + K2 on bf16 and int8):
    ids and distances bit for bit the one-shard engine's on the same rows,
    the oracle's too, ties across a shard boundary to the lowest id."""
    from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu_torch.store.device_store import (
        shard_layout,
    )

    g = np.random.default_rng(rows + n)
    mat = g.standard_normal((rows, 128)).astype(np.float32)
    per_dev = shard_layout(rows, n)[0]
    if per_dev < rows:
        mat[per_dev] = mat[per_dev - 1]   # a tie across the boundary
    queries = np.concatenate([mat[[0, min(per_dev, rows) - 1]],
                              g.standard_normal((6, 128)).astype(np.float32)])
    one = DeviceStore.from_host(mat, dtype, device=cuda)
    many = one.reshard(create_mesh(devices=[cuda] * n))
    for route in ("auto", "global"):
        cfg = SearchConfig(kernel=route)
        e1, en = SearchEngine(one, cfg), SearchEngine(many, cfg)
        for k in (1, 10, 100):
            a, b = e1.search(queries, k), en.search(queries, k)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert b[0].max() < rows
        o1, on = e1.oracle_topk(queries, 100), en.oracle_topk(queries, 100)
        np.testing.assert_array_equal(o1[0], on[0])
        np.testing.assert_array_equal(o1[1], on[1])
        assert top_k_overlap(on[0].tolist(), b[0].tolist(), 100) == 1.0


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.device_count()


def _multi_card_case(rows=1_200_000, dim=256, seed=17):
    g = np.random.default_rng(seed)
    mat = g.standard_normal((rows, dim)).astype(np.float32)
    mat[rows // 2] = mat[rows // 2 - 1]
    queries = np.concatenate([mat[[0, rows // 2 - 1, rows - 1]],
                              g.standard_normal((253, dim)).astype(np.float32)])
    return mat, queries


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_sharded_engine_over_every_card_equals_one_shard(cards, dtype):
    """One process, one shard on each card (the JAX single-host mesh):
    ids and distances bit for bit one shard's on cuda:0."""
    from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh

    mat, queries = _multi_card_case()
    one = DeviceStore.from_host(mat, dtype, device="cuda:0")
    mesh = create_mesh()
    assert [str(s.device) for s in mesh.shards] == [
        f"cuda:{i}" for i in range(cards)]
    many = one.reshard(mesh)
    assert [t.device.index for t in many.shards] == list(range(cards))
    e1, en = SearchEngine(one), SearchEngine(many)
    for k in (1, 100):
        a, b = e1.search(queries, k), en.search(queries, k)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(en.oracle_topk(queries, 100)[0], b[0])


_NCCL_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[2])
from test_torch_gpu import _multi_card_case
from better_search_rag_rust_tpu_torch.bench import BenchmarkManager
from better_search_rag_rust_tpu_torch.launch import maybe_init_distributed
from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh
from better_search_rag_rust_tpu_torch.store.device_store import DeviceStore

torch.backends.cuda.matmul.allow_tf32 = False
assert maybe_init_distributed()
rank = dist.get_rank()
mat, queries = _multi_card_case()
store = DeviceStore.from_host(mat, sys.argv[3], mesh=create_mesh())
engine = SearchEngine(store)
ids, dists = engine.search(queries, 100)
o_ids, o_d = engine.oracle_topk(queries, 100)
rows = store.take_rows(np.array([0, len(mat) // 2, len(mat) - 1]))
bench = BenchmarkManager()
bench.record_duration("op", 0.5 + rank, 10)
stats = bench.gather_timings()["op"]
if rank == 0:
    np.savez(sys.argv[1], ids=ids, dists=dists, o_ids=o_ids, o_d=o_d,
             rows=rows.float().cpu().numpy(),
             info=np.array([dist.get_backend(), str(store.device),
                            engine.kernel_name(100), stats.max_host,
                            stats.total_items], dtype=object))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_nccl_ranks_equal_one_process(cards, dtype, tmp_path):
    """One process a card on NCCL (the ``BSR_*`` env): rank 0's search and
    oracle bit for bit one process's one-shard engine, rows across the
    ranks, the timing gather over every rank."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "rank0.npz"
    env = dict(os.environ, PYTHONPATH=str(here.parent),
               BSR_COORDINATOR=f"127.0.0.1:{port}",
               BSR_NUM_PROCESSES=str(cards), BSR_DIST_TIMEOUT_S="120")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _NCCL_WORKER, str(out), str(here), dtype],
        env=dict(env, BSR_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(cards)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
    got = np.load(out, allow_pickle=True)
    backend, device, route, max_host, items = got["info"].tolist()
    assert (backend, device) == ("nccl", "cuda:0")
    assert (max_host, items) == (cards - 1, 10 * cards)
    mat, queries = _multi_card_case()
    one = SearchEngine(DeviceStore.from_host(mat, dtype, device="cuda:0"))
    ids, dists = one.search(queries, 100)
    np.testing.assert_array_equal(got["ids"], ids)
    np.testing.assert_array_equal(got["dists"], dists)
    np.testing.assert_array_equal(got["o_ids"], ids)
    want = one.store.take_rows(np.array([0, len(mat) // 2, len(mat) - 1]))
    np.testing.assert_array_equal(got["rows"], want.float().cpu().numpy())


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four or more CUDA cards")
    return torch.cuda.device_count()


@pytest.mark.parametrize("world, meshes", [(2, "2x1,1x2"), (4, "2x2")])
def test_nccl_training_ranks_match_one_process(four_cards, tmp_path, world,
                                               meshes):
    """DP 2 x 1, TP 1 x 2 and DP x TP 2 x 2 (sequence parallel) at 12 x
    768 on NCCL, one rank a card (``bench/train_parallel.py``): the first
    step's loss and gradients against one process's on cuda:0 (chip_smoke
    phase 26's bounds), 3 decreasing steps equal on every rank, 24 K8 and
    24 K9 launches a step on each."""
    import json
    import math
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "result.json"
    env = dict(os.environ, PYTHONPATH=str(repo),
               BSR_COORDINATOR=f"127.0.0.1:{port}",
               BSR_NUM_PROCESSES=str(world), BSR_DIST_TIMEOUT_S="120")
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "better_search_rag_rust_tpu_torch.bench.train_parallel",
         "--meshes", meshes, "--out", str(out)],
        env=dict(env, BSR_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-3000:])
    want = {"fused_attention_qkv": 24, "fused_attention_qkv_bwd": 24}
    for res in json.loads(out.read_text()):
        c, ranks = res["check"], res["ranks"]
        assert res["backend"] == "nccl"
        assert [r["device"] for r in ranks] == [f"cuda:{i}"
                                                for i in range(world)]
        assert abs(c["loss"] - c["one_process_loss"]) <= 5e-3
        assert c["min_cos"] > 0.99 and c["max_norm_dev"] <= 0.05, c
        losses = ranks[0]["losses"]
        assert all(math.isfinite(x) for x in losses)
        assert losses[-1] < losses[0]
        for r in ranks:
            assert r["losses"] == losses
            assert r["first_step_launches"] == want
            assert r["launches_per_step"] == want


# -- K14 / K15 / K16 flash attention -------------------------------------------


def _flash_operands(cuda, b, h, s, hd, seed=0, sq=None):
    """bf16 q, do ``[B, H, Sq, hd]``, k, v ``[B, H, S, hd]`` and segment ids
    from the attention mask (row 0 whole, the last row a third real, the
    rest random lengths): pad tokens are their own segment."""
    sq = sq or s
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    q, do = (torch.randn((b, h, sq, hd), generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, s, hd), generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))

    def seg(n):
        lens = torch.randint(1, n + 1, (b,), generator=g, device=cuda)
        lens[0], lens[-1] = n, max(1, n // 3)
        return (torch.arange(n, device=cuda)[None, :]
                < lens[:, None]).to(torch.int32)

    return q, k, v, do, seg(sq), seg(s) if sq != s else None


def _close(a, r, rel=1e-2):
    a, r = a.double(), r.double()
    cos = float((a * r).sum() / (a.norm() * r.norm()))
    return float((a - r).abs().max()) <= rel * float(r.abs().max()) and \
        cos >= 0.999


@pytest.mark.parametrize("b,h,s,hd", [
    (2, 3, 256, 16), (2, 3, 384, 32), (4, 12, 512, 64), (2, 2, 256, 128),
    (1, 2, 2048, 64),
])
def test_flash_kernels_match_plain(cuda, b, h, s, hd):
    """K14 against plain K14 on every row, pad rows included (max |diff| <
    0.02, cosine > 0.999: K8's bound; l and m to 1e-5 relative); K15 and
    K16 against their plain versions on the kernel's own l and m (max
    |diff| <= 1e-2 of the largest entry, cosine >= 0.999: K9's bound)."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    q, k, v, do, seg, _ = _flash_operands(cuda, b, h, s, hd)
    scale = 1.0 / hd ** 0.5
    before = dict(fk.launch_counts)
    o, l, m = fk.flash_attention_fwd(q, k, v, seg, seg, scale)
    po, pl, pm = fk.flash_attention_fwd_plain(q, k, v, seg, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fk.flash_attention_bwd_dkv(q, k, v, seg, seg, l, m, do, di, scale)
    dq = fk.flash_attention_bwd_dq(q, k, v, seg, seg, l, m, do, di, scale)
    pdk, pdv = fk.flash_attention_bwd_dkv_plain(q, k, v, seg, seg, l, m, do,
                                                di, scale)
    pdq = fk.flash_attention_bwd_dq_plain(q, k, v, seg, seg, l, m, do, di,
                                          scale)
    torch.cuda.synchronize()
    assert {n: fk.launch_counts[n] - before[n] for n in before} == dict.fromkeys(
        before, 1)
    assert torch.isfinite(o.float()).all()
    a, r = o.float(), po.float()
    assert (a - r).abs().max() < 0.02
    assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999
    assert float(((l - pl).abs() / pl).max()) <= 1e-5
    assert float(((m - pm).abs() / pm.abs().clamp_min(1.0)).max()) <= 1e-5
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert torch.isfinite(got.float()).all() and _close(got, want)


def _flash_backward_close(fk, q, k, v, do, seg_q, seg_kv, scale):
    """K15 and K16 against their plain versions on the kernel forward's l
    and m (``_close``); returns the tile plan."""
    o, l, m = fk.flash_attention_fwd(q, k, v, seg_q, seg_kv, scale)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg_q, seg_kv, l, m, do, di, scale)
    dk, dv = fk.flash_attention_bwd_dkv(*args)
    dq = fk.flash_attention_bwd_dq(*args)
    pdk, pdv = fk.flash_attention_bwd_dkv_plain(*args)
    pdq = fk.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    for got, want in ((dq, pdq), (dk, pdk), (dv, pdv)):
        assert torch.isfinite(got.float()).all() and _close(got, want)
    plan = fk.backward_tile_plan(seg_q, seg_kv, m)
    ids_plan = fk.segment_tile_plan(seg_q, seg_kv)
    assert (plan is None and ids_plan is None) or torch.equal(ids_plan, plan)
    return plan


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_cross_lengths_and_no_segments(cuda, hd):
    """Sq 256 against Sk 384 with segment ids of each length, and no
    segment ids at all (one segment): K14 and K15 / K16 against the plain
    versions."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    q, k, v, do, seg_q, seg_kv = _flash_operands(cuda, 2, 2, 384, hd, sq=256)
    scale = 1.0 / hd ** 0.5
    for sq_ids, kv_ids in ((seg_q, seg_kv), (None, None)):
        o, _, _ = fk.flash_attention_fwd(q, k, v, sq_ids, kv_ids, scale)
        po, _, _ = fk.flash_attention_fwd_plain(q, k, v, sq_ids, kv_ids, scale)
        assert (o.float() - po.float()).abs().max() < 0.02
        _flash_backward_close(fk, q, k, v, do, sq_ids, kv_ids, scale)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_backward_shuffled_and_lonely_segments(cuda, hd):
    """Two cases of the tile plan on the card, K15 and K16 within
    ``_close`` of their plain versions: shuffled, non-contiguous segment
    ids (each 64-token tile draws a base id, each token the base plus 0-2,
    shuffled within the tile: some tiles' ranges disjoint, so pairs are
    skipped), and a query row with no key of its own segment (its tile is
    never skipped)."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    b, s = 2, 512
    q, k, v, do, _seg, _ = _flash_operands(cuda, b, 2, s, hd, seed=6)
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    base = torch.randint(0, 4, (b, s // 64, 1), generator=g, device=cuda) * 10
    ids = (base + torch.randint(0, 3, (b, s // 64, 64), generator=g,
                                device=cuda)).reshape(b, s)
    perm = torch.argsort(torch.rand((b, s // 64, 64), generator=g,
                                    device=cuda), dim=-1)
    ids = torch.gather(ids.reshape(b, s // 64, 64), 2, perm).reshape(b, s)
    ids = ids.to(torch.int32).contiguous()
    plan = _flash_backward_close(fk, q, k, v, do, ids, ids, 1.0 / hd ** 0.5)
    assert bool(plan.any())
    seg = torch.zeros((b, s), dtype=torch.int32, device=cuda)
    seg[:, 256:] = 1
    seg_q = seg.clone()
    seg_q[0, 70] = -5  # no key has segment -5
    plan = _flash_backward_close(fk, q, k, v, do, seg_q, seg, 1.0 / hd ** 0.5)
    assert not bool(plan[0, 1].any()) and bool(plan[1].any())


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_backward_bitwise_across_runs(cuda, hd):
    """No atomics: two backward passes through :class:`FlashAttention` give
    the same bits."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    q, k, v, do, seg, _ = _flash_operands(cuda, 2, 3, 512, hd, seed=4)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fk.flash_attention(*leaves, fk.SegmentIds(seg, seg),
                           1.0 / hd ** 0.5).backward(do)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _k14_layouts(cuda, hd):
    """K14's layouts beside the padded self-attention: ``(name, q, k, v,
    seg_q, seg_kv)`` with a ragged Sq (200 queries against 256 keys, the
    query ids the key ids' first 200), cross lengths (256 against 384), a
    query row whose segment no key has, and no segment ids."""
    q, k, v, _do, seg_q, seg_kv = _flash_operands(cuda, 3, 2, 384, hd, seed=8,
                                                  sq=256)
    k2, v2 = k[:, :, :256].contiguous(), v[:, :, :256].contiguous()
    lonely = seg_kv[:, :256].clone()
    lonely[1, 70] = 9  # no key has segment 9
    return [("ragged", q[:, :, :200].contiguous(), k2, v2,
             seg_kv[:, :200].contiguous(), seg_kv[:, :256].contiguous()),
            ("cross", q, k, v, seg_q, seg_kv),
            ("lonely", q, k2, v2, lonely, seg_kv[:, :256].contiguous()),
            ("none", q, k2, v2, None, None)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_forward_layouts_plan_and_bits(cuda, hd):
    """K14 against its plain version at every head width on a ragged Sq,
    cross lengths, a lonely query row and no segment ids (o within K8's
    bound, l and m to 1e-5 relative); with the ids' tile plan on and off
    (o, l and m bit for bit; the plan skips pairs on every layout with
    ids), and two runs bit for bit."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    scale = 1.0 / hd ** 0.5
    for name, q, k, v, seg_q, seg_kv in _k14_layouts(cuda, hd):
        plan = fk.segment_tile_plan(seg_q, seg_kv)
        on = fk.flash_attention_fwd(q, k, v, seg_q, seg_kv, scale, plan=plan)
        again = fk.flash_attention_fwd(q, k, v, seg_q, seg_kv, scale, plan=plan)
        off = fk.flash_attention_fwd(q, k, v, seg_q, seg_kv, scale, plan=None)
        po, pl, pm = fk.flash_attention_fwd_plain(q, k, v, seg_q, seg_kv, scale)
        torch.cuda.synchronize()
        assert name == "none" or bool(plan.any()), name
        for a, b, c in zip(on, again, off):
            assert torch.equal(a, b) and torch.equal(a, c), name
        o, l, m = on
        assert torch.isfinite(o.float()).all(), name
        a, r = o.float(), po.float()
        assert (a - r).abs().max() < 0.02, name
        assert float((a * r).sum() / (a.norm() * r.norm())) > 0.999, name
        assert float(((l - pl).abs() / pl).max()) <= 1e-5, name
        assert float(((m - pm).abs() / pm.abs().clamp_min(1.0)).max()) <= 1e-5


def test_flash_refuses_what_it_does_not_take(cuda):
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    q, k, v, _do, seg, _ = _flash_operands(cuda, 1, 2, 256, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        fk.flash_attention_fwd(q.float(), k.float(), v.float(), seg, seg)
    wide = torch.zeros((1, 2, 256, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fk.flash_attention_fwd(wide, wide, wide, seg, seg)
    with pytest.raises(ValueError, match="divisible"):
        fk.flash_attention_fwd(q[:, :, :200], k[:, :, :200], v[:, :, :200],
                               seg[:, :200], seg[:, :200])


def test_flash_encoder_and_trainer_run_the_kernels(cuda):
    """The encoder and the trainer with ``attention_impl="flash"`` at 2
    layers: one K14 launch a layer in a forward, 2 x 2 K14, K15 and K16
    launches in a training step (two towers); embeddings at cosine 0.999
    per row of the ``xla`` path's on the same weights; a finite loss."""
    from better_search_rag_rust_tpu_torch.models.nomic import (
        NomicBertConfig,
        NomicEncoder,
    )
    from better_search_rag_rust_tpu_torch.models.train import (
        ContrastiveTrainer,
    )
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    cfg = dict(vocab_size=1000, hidden_size=256, num_layers=2, num_heads=4,
               mlp_dim=512, max_tokens=256)
    flash = NomicEncoder(NomicBertConfig(attention_impl="flash", **cfg),
                         seed=1, device=cuda)
    plain = NomicEncoder(NomicBertConfig(attention_impl="xla", **cfg),
                         state_dict=flash.model.state_dict(), device=cuda)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 1000, size=(8, 256)).astype(np.int32)
    mask = (np.arange(256)[None, :]
            < rng.integers(1, 257, size=8)[:, None]).astype(np.int32)
    fk.reset_launch_counts()
    a = flash.encode_tokens(ids, mask)
    assert fk.launch_counts["flash_attention_fwd"] == 2
    assert np.all(np.sum(a * plain.encode_tokens(ids, mask), axis=1) >= 0.999)
    tr = ContrastiveTrainer(NomicBertConfig(attention_impl="flash", **cfg),
                            device=cuda)
    fk.reset_launch_counts()
    loss = tr.train_step(ids, mask, ids[::-1].copy(), mask[::-1].copy())
    assert np.isfinite(loss)
    assert fk.launch_counts == dict.fromkeys(fk.launch_counts, 4)


# -- NaN rows and queries: the kernels' maxima propagate NaN ------------------

#: a NaN's bits in each float store dtype, sign clear and set (ml_dtypes')
NAN_BITS = {torch.bfloat16: (0x7FC0, 0xFFC0 - (1 << 16)),
            torch.float32: (0x7FC00000, 0xFFC00000 - (1 << 32))}
#: store rows made NaN: a unit's first row, mid-unit, the last block, and a
#: whole 64-row unit
NAN_ROWS = (64, 200, 3990, *range(320, 384))


def _nan_operands(cuda, dtype, sign, t=40):
    """``_operands`` with ``NAN_ROWS`` set to NaN of ``sign``, query 3 NaN
    and query 5 the NaN row 200."""
    q, mat = _operands(cuda, dtype, t=t)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    bits = NAN_BITS[dtype][sign < 0]
    mat.view(ints)[list(NAN_ROWS)] = bits
    q.view(ints)[3] = bits
    q[5] = mat[200]
    return q, mat


def _same_nans(out, ref, tol=TOL):
    """NaN in the same places and with the same bits; every other value
    within ``tol`` (the plain product sums in another order)."""
    nan = torch.isnan(out)
    assert torch.equal(nan, torch.isnan(ref))
    assert torch.equal(out.view(torch.int32)[nan], ref.view(torch.int32)[nan])
    assert (out[~nan] - ref[~nan]).abs().max() <= tol
    return nan


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sub,block,ew", [(8, 128, 128), (16, 128, 0),
                                          (64, 128, 0), (64, 1024, 256)])
def test_k1_propagates_nan_like_plain(cuda, dtype, sign, sub, block, ew):
    """K1 (ew 256: K10's row-tile walk) on NaN rows and queries of either
    sign: unit and coarse maxima NaN where the plain version's are, with
    its bits; on a NaN unit the key bit for bit the plain one (no
    attaining row: argmax ``sub``, m2 NaN); elsewhere the argmax where the
    unit's top two differ."""
    q, mat = _nan_operands(cuda, dtype, sign)
    kw = dict(sub=sub, block=block, emit_block=True, emit_argmax=True,
              emit_width=ew)
    bms, key, bm = tk.matmul_blockmax2_only(q, mat, 4001, **kw)
    p_bms, p_key, p_bm = tk.matmul_blockmax2_only_plain(q, mat, 4001, **kw)
    torch.cuda.synchronize()
    nan = _same_nans(bms, p_bms)
    assert nan[320 // sub:384 // sub].all() and nan[:4001 // sub, 3].all()
    assert nan[64 // sub].all() and nan[3990 // sub].all()
    assert torch.equal(key[nan], p_key[nan])
    assert ((key[nan] & 0x7F) == sub % 128).all()
    _same_nans(bm, p_bm)
    sims = tk.matmul_blockmax_plain(q, mat, 4001)[0]
    top2 = sims.T.reshape(-1, sub, q.shape[0]).topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > TOL) & ~nan
    assert torch.equal((key & 0x7F)[clear], (p_key & 0x7F)[clear])


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", [128, 32])
def test_k3_k5_propagate_nan_like_plain(cuda, dtype, sign, block):
    """K3's scores and block maxima, and K5's (bit for bit K3's), on NaN
    rows and queries of either sign: NaN where the plain version has it,
    with its bits; every block holding a NaN row has a NaN maximum."""
    q, mat = _nan_operands(cuda, dtype, sign)
    sims, bm = tk.matmul_blockmax(q, mat, 4001, block=block)
    p_sims, p_bm = tk.matmul_blockmax_plain(q, mat, 4001, block=block)
    bm5 = tk.matmul_blockmax_only(q, mat, 4001, block=block)
    torch.cuda.synchronize()
    _same_nans(sims, p_sims)
    nan = _same_nans(bm, p_bm)
    for r in NAN_ROWS:
        assert nan[r // block].all()
    assert torch.equal(bm5.view(torch.int32), bm.view(torch.int32))


@pytest.mark.parametrize("dtype,kernel,argmax", [
    (dt, kernel, argmax) for dt in ("float32", "bfloat16", "int8")
    for kernel, argmax in (("rescore", "auto"), ("rescore", "off"),
                           ("rescore", "on"), ("global", "auto"),
                           ("f32cert", "auto"))
    if kernel != "f32cert" or dt == "float32"])
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("case", ["nan_row", "nan_query", "inf_query"])
def test_nan_pins_on_the_card(cuda, case, sign, dtype, kernel, argmax):
    """The 64 x 32 cases of tests/test_torch_nonfinite.py, the store built
    by the port on the card: every route answers the CPU tests' pins
    (``chip_smoke.NAN_PINS``) for a NaN or an infinity of either sign."""
    import chip_smoke

    mat, queries, k = chip_smoke.nan_case(case, sign)
    store = DeviceStore.from_host(mat, dtype=dtype, device=cuda)
    cfg = (SearchConfig(kernel="auto", f32_certified="on")
           if kernel == "f32cert" else
           SearchConfig(kernel=kernel, rescore_argmax=argmax))
    eng = SearchEngine(store, cfg)
    assert eng.kernel_name(k) == kernel
    np.testing.assert_array_equal(eng.search(queries, k)[0],
                                  chip_smoke.NAN_PINS[case][dtype])


@pytest.mark.parametrize("offset", [0, 1])  # 1: x off the 16-byte boundary
@pytest.mark.parametrize("n", [1, 7, 16, 33, 4096, 1024 * 768])
def test_k17_cast_is_its_plain_version_bitwise(cuda, n, offset):
    """K17 with normalization off (the bf16 cast alone) writes the plain
    version's bf16 bits — ml_dtypes' NaN (0x7FC0 / 0xFFC0 by sign, any
    payload), round to nearest even elsewhere (+-inf, overflow, subnormals,
    ties) — on its 16-byte path and its scalar one, one launch a call."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n)
    x = torch.randn(n + offset, generator=g, device=cuda)
    bits = x.view(torch.int32)
    bits[offset::3] = 0x7FC00000
    bits[offset + 1::7] = 0xFFC00000 - (1 << 32)
    bits[offset + 2::11] = 0x7F800001
    bits[offset + 4::13] = 0x7F7FFFFF   # rounds up to +inf
    bits[offset + 5::17] = 0x00000001   # the smallest subnormal
    bits[offset + 6::19] = 0x3F808000   # a tie: 1 + 2^-8, to even (1.0)
    v = x[offset:]
    before = tk.launch_counts["normalize_cast"]
    got = tk.normalize_cast(v, torch.bfloat16, normalize=False)
    assert tk.launch_counts["normalize_cast"] == before + 1
    want = tk.normalize_cast_plain(v, torch.bfloat16, normalize=False)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(got.view(torch.int16).cpu(), tk.normalize_cast_plain(
        v.cpu(), torch.bfloat16, normalize=False).view(torch.int16))


def _k17_rows(cuda, n, d, offset, seed=0):
    """``[n, d]`` f32 rows on the card (``offset`` floats past an aligned
    base: 1 takes K17's 4-byte path) with, where n allows, a zero row, a
    subnormal row, a tiny row (squares subnormal), an overflowing row (sum
    of squares inf), +inf, -inf and all-inf rows and NaN rows of each
    sign; and the indices of the rows left finite."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed + n + d)
    buf = torch.randn(n * d + offset, generator=g, device=cuda)
    x = buf[offset:].view(n, d)
    edits = [lambda r: r.zero_(), lambda r: r.mul_(1e-40),
             lambda r: r.mul_(1e-21), lambda r: r.mul_(1e20),
             lambda r: r[d // 2:d // 2 + 1].fill_(float("inf")),
             lambda r: r[:1].fill_(-float("inf")),
             lambda r: r.fill_(float("inf")),
             lambda r: r.view(torch.int32)[-1:].fill_(0x7FC00000),
             lambda r: r.view(torch.int32)[1:2].fill_(0xFFC00001 - (1 << 32)),
             lambda r: r.view(torch.int32).fill_(0x7FC00000)]
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(n))
    special = rows[:len(edits)].tolist() if n >= 2 * len(edits) else []
    for r, edit in zip(special, edits):
        edit(x[r])
    nonfinite = set(special[4:])
    return x, [r for r in range(n) if r not in nonfinite]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [32, 100, 768, 1024])
@pytest.mark.parametrize("n", [1, 7, 1024, 131072])
def test_k17_normalize_cast_is_its_plain_version_bitwise(cuda, n, d, offset,
                                                         dtype):
    """K17 is one launch a call and writes its plain version's bits on the
    card, every row included (zero, subnormal, overflowing, infinite and
    NaN rows; the card's NaN is canonical, so a NaN row's bits are the
    plain version's on the same device), on the 16-byte path (offset 0,
    D % 4 == 0) and the 4-byte one; its finite rows are also the CPU
    plain version's bits (on up to 4,096 of them)."""
    x, finite = _k17_rows(cuda, n, d, offset)
    before = tk.launch_counts["normalize_cast"]
    got = tk.normalize_cast(x, dtype)
    assert tk.launch_counts["normalize_cast"] == before + 1
    want = tk.normalize_cast_plain(x, dtype)
    torch.cuda.synchronize()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}[dtype]
    assert torch.equal(got.view(ints), want.view(ints))
    rows = torch.tensor(finite[:4096], device=cuda)
    cpu = tk.normalize_cast_plain(x[rows].cpu(), dtype)
    assert torch.equal(got[rows].view(ints).cpu(), cpu.view(ints))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k17_fills_the_store_in_place(cuda, dtype):
    """``DeviceStore.from_host`` fills each block with one K17 launch,
    written into the store: its rows are the CPU store's bits."""
    import better_search_rag_rust_tpu_torch.store.device_store as ds

    mat = np.random.default_rng(4).standard_normal((3000, 100)).astype(
        np.float32)
    before = tk.launch_counts["normalize_cast"]
    old = ds._BUILD_ROWS
    ds._BUILD_ROWS = 1024
    try:
        store = DeviceStore.from_host(mat, dtype, device=cuda)
    finally:
        ds._BUILD_ROWS = old
    assert tk.launch_counts["normalize_cast"] == before + 3
    cpu = DeviceStore.from_host(mat, dtype, device="cpu")
    assert torch.equal(store.data.cpu(), cpu.data)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k17_effective_queries_are_the_card_bits(cuda, dtype):
    """``effective_queries`` (the plain version, on the CPU) equals the bits
    the card's ``_cast_queries`` scores, on finite queries."""
    rng = np.random.default_rng(5)
    store = DeviceStore.from_host(
        rng.standard_normal((4096, 768)).astype(np.float32), dtype,
        device=cuda)
    eng = SearchEngine(store)
    qs = rng.standard_normal((300, 768)).astype(np.float32)
    card = eng._cast_queries(torch.from_numpy(qs).to(cuda))
    np.testing.assert_array_equal(
        card.float().cpu().numpy().view(np.int32),
        eng.effective_queries(qs).view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k17_query_prep_runs_no_torch_normalization(cuda, dtype):
    """On the card ``_cast_queries`` is one K17 launch: it dispatches no
    aten op but an allocation (so no ``aten::mul``, ``aten::sum``,
    ``aten::div`` or ``aten::sqrt``), and the profiler, after a warm-up
    cycle, records its kernel and no other kernel or aten op with device
    time."""
    import chip_smoke

    store = DeviceStore.synthetic(4096, 768, dtype, 0, device=cuda)
    eng = SearchEngine(store)
    q = torch.randn((1024, 768), device=cuda)
    ops = chip_smoke.dispatched_ops(lambda: eng._cast_queries(q))
    assert ops == {"aten.empty"}
    for op in ("aten.mul", "aten.sum", "aten.div", "aten.sqrt"):
        assert op not in ops, (op, ops)
    torch.cuda.synchronize()
    before = tk.launch_counts["normalize_cast"]
    eng._cast_queries(q)
    assert tk.launch_counts["normalize_cast"] == before + 1
    _ms, recorded, others = chip_smoke.k17_profile(
        lambda: eng._cast_queries(q), 4)
    assert recorded, "the profiler recorded no K17 kernel"
    assert not others, others


@pytest.mark.parametrize("kind", ["unit", "normal", "cancel_mixed", "special"])
def test_wgmma_k16_step_is_mma_sync_bitwise(cuda, kind):
    """The instruction probe: one bf16 k16 step's f32 sums on ``wgmma``
    m64n128k16 with scale-d = 0 (the score tile of K1/K3/K5/K10/K12) and on
    ``mma.sync`` m16n8k16 from +0.0 (K2/K6's gather, K12's gather and K13)
    agree bit for bit on unit rows, raw normal rows, rows built for
    cancellation and mixed exponents, and random bit patterns (subnormals,
    +-inf, NaN): what K1 = K2 = K3 rests on."""
    import chip_smoke

    rows, q = chip_smoke.probe_operands(kind, 0, rows=1024, dim=768,
                                        device=cuda)
    wg, mma = tk.probe_bf16_k16(rows, q)
    torch.cuda.synchronize()
    counts = chip_smoke.probe_counts(wg, mma)
    assert counts["differ"] == 0, counts


@pytest.mark.parametrize("steps", [8, 32])
@pytest.mark.parametrize("kind", ["unit", "normal", "cancel_mixed", "special",
                                  "softmax"])
def test_pv_probe_wgmma_accumulates_as_mma_sync(cuda, kind, steps):
    """The PV probe's finding, stated as an assertion: a bf16 product's k16
    steps accumulated inside ``wgmma`` m64n64k16 (scale-d = 1 from zero, A
    from registers, B MN-major: K8's PV) and inside ``mma.sync`` m16n8k16
    (from +0.0: the mma.sync K8's PV) agree bit for bit over 8 and 32 steps
    on every kind of data, so K8's PV stays inside the instruction
    (``ATT_PV_ADDS`` false) and keeps the older build's bits."""
    import chip_smoke

    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    a, b = chip_smoke.pv_probe_operands(kind, 0, steps, rows=1024, device=cuda)
    wg, mma = ak.probe_pv_acc(a, b)
    torch.cuda.synchronize()
    counts = chip_smoke.probe_counts(wg, mma)
    assert counts["differ"] == 0, counts


# -- the bf16 score tile on wgmma against the mma.sync tile -------------------


@pytest.fixture(scope="module")
def bf16_mma_sync_lib():
    """The search kernels built with the bf16 score tile on ``mma.sync``
    (``bench/ab_topk.py``'s ``@bf16_mma_sync``: the tile as shipped before
    the wgmma tile), bound with the package's signatures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from better_search_rag_rust_tpu_torch.bench import ab_topk

    builds = ab_topk.build([ab_topk.source_path("@bf16_mma_sync")])
    return next(iter(builds.values()))[0]


@contextlib.contextmanager
def _topk_library(lib):
    """The wrappers launch from the ctypes library ``lib`` inside the block."""
    from better_search_rag_rust_tpu_torch.ops import _build

    saved = _build._LIBRARIES.get("topk")
    _build._LIBRARIES["topk"] = _build.KernelLibrary(lib, Path(lib._name), 0.0, "")
    try:
        yield
    finally:
        if saved is None:
            _build._LIBRARIES.pop("topk", None)
        else:
            _build._LIBRARIES["topk"] = saved


def _bf16_tile_operands(cuda, case, rows=2048, t=200):
    """bf16 operands of one case: unit rows, the queries three store rows
    and negated store rows (200: a ragged query tile), at D 768 or 64 (TMA)
    or 100 (a k16 step 4 features into D: the producer stages the slabs);
    ``_offset``: 768-d views whose rows start 2 bytes past 16-byte
    alignment (staged); ``_nan``: NaN in rows 5 (either sign) and 1000."""
    rng = np.random.default_rng(len(case) + rows)
    dim = int(case.split("_")[0][1:])
    m = rng.standard_normal((rows, dim)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = np.concatenate([m[[3, 100, 7]], -m[rng.integers(0, rows, t - 3)]])
    mat = torch.from_numpy(m).to(cuda).to(torch.bfloat16)
    q = torch.from_numpy(q).to(cuda).to(torch.bfloat16)
    if case.endswith("nan"):  # 0x7FC0 and 0xFFC0
        mat.view(torch.int16)[5, 0] = 0x7FC0
        mat.view(torch.int16)[1000, dim // 2] = -64
    if case.endswith("offset"):
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        q, mat = shifted(q), shifted(mat)
        assert q.data_ptr() % 16 and mat.data_ptr() % 16 and mat.is_contiguous()
    return q.contiguous(), mat.contiguous()


def _bf16_tile_outputs(q, mat, valid):
    """Every output of the bf16 score tile's kernels: K1 at sub 8, 16 and 64
    (key, block maxima at ew 128) and at sub 128 / ew 256 (K10's walk), K3,
    K5 at block 32, K10 (scores, argmax, second max at sub 16) and K12 (one
    copy of the product, and its gather)."""
    cuda = q.device
    outs = []
    for sub in (8, 16, 64):
        outs += tk.matmul_blockmax2_only(q, mat, valid, sub=sub, block=128,
                                         emit_block=True, emit_argmax=True)
    outs += tk.matmul_blockmax2_only(q, mat, valid, sub=128, block=1024,
                                     emit_block=True, emit_argmax=True,
                                     emit_width=256)
    outs += tk.matmul_blockmax(q, mat, valid)
    outs.append(tk.matmul_blockmax_only(q, mat, valid, block=32))
    outs += tk.matmul_blockmax2x(q, mat, valid, sub=16, emit_sims=True,
                                 emit_arg=True, emit_m2=True)
    ids = _unit_ids(cuda, mat.shape[0] // 16, q.shape[0], 8, 2)
    outs += tk.gather_rescore_mm(q, mat, ids, q, mat, unit=16, copies=1)
    torch.cuda.synchronize()
    return outs


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", ["d768", "d64", "d100", "d768_offset",
                                  "d768_nan"])
def test_bf16_tile_is_the_mma_sync_tile_bitwise(cuda, bf16_mma_sync_lib, case):
    """The bf16 score tile on wgmma fed by TMA (or by the producer warp
    where TMA cannot read: D 100, bases 2 bytes off) gives every output of
    K1, K3, K5, K10 and K12 bit for bit what the mma.sync tile gives:
    ``valid_rows`` inside the last tile, 200 queries (a ragged query
    tile), NaN rows of either sign. Each launch is counted."""
    q, mat = _bf16_tile_operands(cuda, case)
    valid = mat.shape[0] - 37
    names = ("matmul_blockmax2_only", "matmul_blockmax", "matmul_blockmax_only",
             "matmul_blockmax2x", "gather_rescore_mm")
    before = {n: tk.launch_counts[n] for n in names}
    got = _bf16_tile_outputs(q, mat, valid)
    assert {n: tk.launch_counts[n] - before[n] for n in names} == {
        "matmul_blockmax2_only": 4, "matmul_blockmax": 1,
        "matmul_blockmax_only": 1, "matmul_blockmax2x": 1,
        "gather_rescore_mm": 1}
    with _topk_library(bf16_mma_sync_lib):
        want = _bf16_tile_outputs(q, mat, valid)
    assert len(got) == len(want) == 21
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(_bits(a), _bits(b)), i


def test_bf16_identity_on_nan_rows(cuda):
    """Phase 3's identity on a bf16 store with NaN rows of either sign: on a
    finite unit K2 at K1's argmax row == K1's unit max == K3's score there,
    bit for bit; a unit holding a NaN row has K1's max NaN (0x7FFFFFFF),
    its argmax ``sub``, and K2's scores of the unit are K3's bit for bit."""
    sub = 64
    q, mat = _bf16_tile_operands(cuda, "d768_nan", rows=4096, t=40)
    n = mat.shape[0]
    bms, key = tk.matmul_blockmax2_only(q, mat, n, sub=sub, block=128,
                                        emit_argmax=True)
    sims, _ = tk.matmul_blockmax(q, mat, n)
    units = torch.arange(n // sub, device=cuda).repeat(q.shape[0], 1)
    resc = tk.gather_rescore(q, mat, units.to(torch.int32).contiguous(),
                             unit=sub).view(q.shape[0], -1, sub)
    torch.cuda.synchronize()
    s3 = sims.view(q.shape[0], -1, sub)
    nan_unit = s3.isnan().any(dim=2)
    assert bool(nan_unit[:, [0, 1000 // sub]].all()) and int(nan_unit.sum()) == 2 * q.shape[0]
    arg = (key & 0x7F).T.long()
    k1_max = bms.T
    assert bool((arg[nan_unit] == sub).all())
    assert bool((k1_max[nan_unit].view(torch.int32) == 0x7FFFFFFF).all())
    assert torch.equal(_bits(resc[nan_unit]), _bits(s3[nan_unit]))
    fin = ~nan_unit
    a = arg.clamp(max=sub - 1)[:, :, None]
    k2_at = torch.gather(resc, 2, a)[:, :, 0]
    k3_at = torch.gather(s3, 2, a)[:, :, 0]
    assert torch.equal(k2_at[fin], k1_max[fin]) and torch.equal(k3_at[fin], k1_max[fin])
