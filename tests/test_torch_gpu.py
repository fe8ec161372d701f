"""CUDA kernels of the port on the card: against their plain versions, each
other, and the oracle. Marked ``gpu``; without a card every test skips.

The machine with the card has no jax, so run this file without the suite's
conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

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
    (136, 32),
])
def test_k9_p_and_ds_bitwise_across_passes(cuda, k9_dump_lib, s, hd):
    """The query pass takes Q K^T and g V^T, the key pass K Q^T and V g^T:
    m16n8k16 must give each (query, key) cell the same f32 both ways, so
    that p, dp and ds agree bit for bit between the passes (else bf16(p)
    and ds drift between dq and dk/dv). Every cell of every head, with a
    fully padded batch row, on both sides of the query pass's one-tile /
    two-tile edge (S 512 / 520) and at S % 16 == 8."""
    from better_search_rag_rust_tpu_torch.bench import ab_attn

    b, h = 2, 2
    qkv, c2, s2, bias, _, scale = _attention_operands(cuda, b, s, h, hd, seed=3)
    g = torch.randn((b, s, h * hd), device=cuda).to(torch.bfloat16)
    res = ab_attn.k9_dump_compare(k9_dump_lib, qkv, c2, s2, bias, g, h, scale)
    assert res["written"] and res["cells"] == b * h * s * s
    assert res["p"] and res["dp"] and res["ds"], res


@pytest.mark.parametrize("s,hd", [
    (72, 64), (136, 64), (72, 128), (136, 128),   # S % 16 == 8
    (512, 64), (520, 64), (512, 128), (520, 128),  # one / two tiles a warp
    (1024, 64), (1024, 128),                       # the longest sequence
])
def test_k9_at_the_layout_edges(cuda, s, hd):
    """Both sides of the query pass's edge (a warp holds one key tile's
    logits and dp up to S 512, two above, restaging the first), half-empty
    k16 steps (S % 16 == 8) and S 1024, with a fully padded batch row:
    within phase 9's bound of the plain version, the fully padded row too,
    every value finite and two launches bit for bit."""
    out, again, ref, valid = _k9_case(cuda, 2, s, 2, hd)
    assert not bool(valid[-1].any())
    assert torch.equal(out, again)
    assert torch.isfinite(out.float()).all()
    _k9_within_bound(out, ref)
    _k9_within_bound(out[-1], ref[-1])


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
    """K9 stages qkv and g 16 bytes per cp.async: views off a 16-byte
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
    (64, 784), (64, 792),      # K and V resident / both streamed
    (128, 704), (128, 712),    # both streamed, one key tile apart
    (128, 1024),               # the longest sequence at the widest head
])
def test_k8_k7_at_the_shared_memory_edges(cuda, hd, s):
    """Each side of the shared-memory boundary between the resident and the
    streamed staging, the streamed one at hd 128, and S 1024 at hd 128: K8
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
    """cp.async copies 16 bytes at a time: a view off a 16-byte boundary is
    copied to an aligned one, not read misaligned nor refused; the result
    is the aligned operands' bit for bit."""
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
