"""The int8 score tile of K1/K3/K5/K10 on the CPU: its shared-memory and
register layout in numpy, and the plain versions at its edge cases against
the JAX package.

On the card the tile runs ``wgmma.mma_async ... m64n128k32.s32.s8.s8``
(``score_tile_i8`` in ``ops/csrc/topk_kernels.cu``): TMA writes slabs of 128
rows x 128 bytes in the 128-byte swizzle (or the producer warp stages the
same layout where TMA cannot read the operands), each warpgroup's wgmma
reads 64 store rows and 128 queries through shared-memory descriptors
(start address, 1024-byte stride between 8-row atoms, layout type
SWIZZLE_128B) advanced 32 bytes per k32 step, and each thread writes its 64
s32 accumulators to the score tile ``st``. The emulation below follows
that layout byte for byte and asserts that each (row, query) cell of a 128
x 128 tile collects exactly the D products of its own row and query, in
values and in indices, and that one crossed swizzle bit breaks it — the
fault the kernels' identities (K1 = K2 = K3) could not see if every kernel
shared it.

The plain versions (what the wrappers run on CPU tensors, and what the card
holds the kernels to) are held to the JAX package's Pallas kernels in
interpret mode, bit for bit: an int8 score is an exact integer dot times
one f32 constant. Shapes: D 100 (a ragged last slab and k32 step, the
thread-staged path on the card), D 1040 with rows that are mostly -128 (the
widest int8 dim the wrappers take; raw int8 such as P14's may hold -128,
which the lattice never does), and ``valid_rows`` inside the last 128-row
tile. The dots stay exact in f32 only while ``sum_d |q_d r_d| < 2^24``;
``_neg128_heavy`` asserts that of its data.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit_host

REPO = Path(__file__).resolve().parents[1]
SLAB = 128     # bytes (features) of a row per slab: one TMA box's width
ATOM = 1024    # one 8-row swizzle atom: the descriptors' stride byte offset
TILE = 128     # store rows and queries per tile (TR = TQ)
K_STEP = 32    # features per wgmma m64n128k32


# -- the layout, emulated -----------------------------------------------------


def swizzle128(addr):
    """The 128-byte swizzle on shared-memory byte addresses (1024-byte
    aligned slabs): address bits [4:6] XOR bits [7:9]."""
    return addr ^ (((addr >> 7) & 7) << 4)


def crossed_swizzle(addr):
    """The swizzle with one bit crossed: bits [4:6] XOR bits [8:10]."""
    return addr ^ (((addr >> 8) & 7) << 4)


def tma_box(mat, r0, d0, fill=0, swz=swizzle128):
    """The slab one TMA box writes: rows [r0, r0 + 128) x bytes [d0, d0 +
    128) of ``mat`` at their swizzled offsets, ``fill`` past either edge."""
    n, d = mat.shape
    rows = np.arange(TILE)[:, None]
    cols = np.arange(SLAB)[None, :]
    gr, gd = r0 + rows, d0 + cols
    inside = (gr < n) & (gd < d)
    vals = np.where(inside, mat[np.minimum(gr, n - 1), np.minimum(gd, d - 1)],
                    fill)
    out = np.full(TILE * SLAB, fill, dtype=mat.dtype)
    out[swz(rows * SLAB + cols)] = vals
    return out


def staged_slab(mat, r0, d0, fill=0):
    """The slab the producer warp stages where TMA cannot read
    (``stage_slab_i8``): row r's 16-byte chunk c at ``r * 128 + 16 * (c ^ (r
    & 7))``, ``fill`` past either edge."""
    n, d = mat.shape
    r = np.arange(TILE)[:, None, None]
    c = np.arange(SLAB // 16)[None, :, None]
    b = np.arange(16)[None, None, :]
    gr, gd = r0 + r, d0 + 16 * c + b
    inside = (gr < n) & (gd < d)
    vals = np.where(inside, mat[np.minimum(gr, n - 1), np.minimum(gd, d - 1)],
                    fill)
    out = np.full(TILE * SLAB, fill, dtype=mat.dtype)
    out[(r * SLAB + 16 * (c ^ (r & 7)) + b).ravel()] = vals.ravel()
    return out


def desc_read(smem, start, rows, swz=swizzle128):
    """``[rows, 32]``: what one k32 step of a K-major SWIZZLE_128B
    descriptor at byte ``start`` hands wgmma — row m's byte j at ``start +
    (m // 8) * 1024 + (m % 8) * 128 + j``, through the swizzle."""
    m = np.arange(rows)[:, None]
    j = np.arange(K_STEP)[None, :]
    return smem[swz(start + (m // 8) * ATOM + (m % 8) * SLAB + j)]


def d_fragment(warp, lane, i):
    """The PTX layout of wgmma's m64nN accumulator: register ``i`` of lane
    ``lane`` in warp ``warp`` (of 4) of a warpgroup holds (row, column)."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * ((i % 4) // 2), 8 * (i // 4) + 2 * t + i % 2


def epilogue_cell(warp, lane, j, h, e):
    """The kernel's write of the score tile: (st row, st column, register)
    of thread ``(warp, lane)`` (warps 0-7 of the two consumer warpgroups)
    at loop indices ``j < 16, h < 2, e < 2``."""
    g, t = lane >> 2, lane & 3
    return ((warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * h,
            8 * j + 2 * t + e, 4 * j + 2 * h + e)


def emulate_tile(q, s, row0, q0, slab=tma_box, swz_read=swizzle128,
                 fill=0, reduce=None):
    """The tile's 128 x 128 score cells from the emulated slabs and reads.
    ``reduce(A [64, 32], B [128, 32])`` folds one k32 step into the cells
    (default: the integer product); returns ``[2 warpgroups] -> [64, 128]``
    of whatever ``reduce`` accumulates."""
    d = s.shape[1]
    reduce = reduce or (lambda a, b: a.astype(np.int64) @ b.astype(np.int64).T)
    acc = [None, None]
    for sl in range(-(-d // SLAB)):
        smem = np.concatenate([slab(s, row0, sl * SLAB, fill),
                               slab(q, q0, sl * SLAB, fill)])
        for wg in range(2):
            for k in range(SLAB // K_STEP):
                if sl * SLAB + K_STEP * k >= d:   # no step wholly past D
                    continue
                a = desc_read(smem, wg * 64 * SLAB + K_STEP * k, 64, swz_read)
                b = desc_read(smem, TILE * SLAB + K_STEP * k, TILE, swz_read)
                step = reduce(a, b)
                acc[wg] = step if acc[wg] is None else acc[wg] + step
    return acc


def scatter_st(acc):
    """The score tile ``st [128, 128]`` the consumer threads write from
    their registers, each register read through :func:`d_fragment`."""
    st = np.full((TILE, TILE), np.iinfo(np.int64).min, dtype=np.int64)
    for warp in range(8):
        for lane in range(32):
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        r, c, i = epilogue_cell(warp, lane, j, h, e)
                        m, n = d_fragment(warp & 3, lane, i)
                        st[r, c] = acc[warp >> 2][m, n]
    return st


def _tile_operands(dim, rows=300, t=200, seed=0):
    rng = np.random.default_rng(seed + dim)
    s = rng.integers(-128, 128, size=(rows, dim), dtype=np.int64).astype(np.int8)
    q = rng.integers(-128, 128, size=(t, dim), dtype=np.int64).astype(np.int8)
    return q, s


def _exact(q, s):
    return q.astype(np.int64) @ s.astype(np.int64).T


def test_epilogue_is_a_bijection_onto_the_tile():
    """The 256 consumer threads' 64 registers each cover every (row, query)
    cell of the 128 x 128 tile once, and the cell a register is written to
    is the cell the PTX layout says it holds."""
    seen = np.zeros((TILE, TILE), dtype=np.int64)
    for warp in range(8):
        for lane in range(32):
            regs = set()
            for j in range(16):
                for h in range(2):
                    for e in range(2):
                        r, c, i = epilogue_cell(warp, lane, j, h, e)
                        m, n = d_fragment(warp & 3, lane, i)
                        assert (r, c) == ((warp >> 2) * 64 + m, n)
                        regs.add(i)
                        seen[r, c] += 1
            assert regs == set(range(64))
    assert (seen == 1).all()


@pytest.mark.parametrize("dim", [768, 100, 1040])
def test_staged_slab_is_the_tma_box(dim):
    """The producer warp's staging writes TMA's swizzled bytes, zero padded
    the same way past D and past the last row (here queries past Tn)."""
    q, s = _tile_operands(dim, rows=200)
    for r0 in (0, 128):
        for d0 in range(0, dim, SLAB):
            assert np.array_equal(staged_slab(s, r0, d0), tma_box(s, r0, d0))


@pytest.mark.parametrize("dim", [768, 100, 1040])
def test_each_cell_collects_its_own_d_products(dim):
    """Track indices instead of values: every k32 step hands cell (m, n) of
    warpgroup wg the features j of store row 64 wg + m and query n, the same
    feature on both sides; over the k loop each of the D features exactly
    once, padding (-1) only past D."""
    rows, t = 256, 200
    s_idx = np.arange(rows * dim, dtype=np.int64).reshape(rows, dim)
    q_idx = np.arange(t * dim, dtype=np.int64).reshape(t, dim)
    for row0, q0 in ((0, 0), (128, 128)):   # the second query tile is ragged
        steps = emulate_tile(q_idx, s_idx, row0, q0, fill=-1, reduce=lambda a, b: [(a, b)])
        for wg in range(2):
            a = np.concatenate([x for x, _ in steps[wg]], axis=1)  # [64, K]
            b = np.concatenate([y for _, y in steps[wg]], axis=1)  # [128, K]
            assert a.shape[1] == b.shape[1] == 32 * -(-dim // 32)
            real = a >= 0
            assert (real == (np.arange(a.shape[1]) < dim)[None, :]).all()
            assert (a[real].reshape(64, dim) // dim
                    == (row0 + 64 * wg + np.arange(64))[:, None]).all()
            feats = a[:, :dim] % dim
            assert (feats == np.arange(dim)[None, :]).all()
            qv = np.arange(TILE) + q0 < t
            assert (b[~qv] == -1).all()           # zeros past Tn
            assert (b[qv][:, :dim] // dim == (q0 + np.arange(TILE))[qv][:, None]).all()
            assert (b[qv][:, :dim] % dim == feats[:1]).all()
            assert (b[:, dim:] == -1).all()


@pytest.mark.parametrize("dim,slab", [(768, tma_box), (100, tma_box),
                                      (1040, tma_box), (100, staged_slab),
                                      (1040, staged_slab)])
def test_tile_values_are_the_exact_dots(dim, slab):
    """Values: the emulated tile through both slab writers equals the exact
    integer product of its rows and queries (queries past Tn score 0)."""
    q, s = _tile_operands(dim)
    want = _exact(q, s)
    for row0, q0 in ((0, 0), (128, 128)):
        st = scatter_st(emulate_tile(q, s, row0, q0, slab=slab))
        qv = q0 + np.arange(TILE) < q.shape[0]
        rv = row0 + np.arange(TILE) < s.shape[0]
        block = want[q0:q0 + TILE, row0:row0 + TILE].T   # [rows, queries]
        assert np.array_equal(st[np.ix_(rv, qv)], block)
        assert (st[:, ~qv] == 0).all()


@pytest.mark.parametrize("dim", [768, 100])
def test_crossed_swizzle_bit_fails(dim):
    """Reading with one swizzle bit crossed (or none) gives wrong dots:
    the emulation sees a layout fault."""
    q, s = _tile_operands(dim)
    want = _exact(q, s)[:TILE, :TILE].T
    for swz in (crossed_swizzle, lambda a: a):
        st = scatter_st(emulate_tile(q, s, 0, 0, swz_read=swz))
        assert not np.array_equal(st, want)
    assert np.array_equal(scatter_st(emulate_tile(q, s, 0, 0)), want)


# -- the plain versions against the JAX package (interpret mode) -------------


T = 16
R, VALID = 1024, 1000   # VALID inside the last 128-row tile


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _neg128_heavy(rng, rows, dim, t):
    """Raw int8 rows of which 70 % of the entries are -128; queries: three
    store rows, an all -128 row and heavy random rows. Exactness in f32
    needs ``sum_d |q_d r_d| < 2^24``; asserted."""
    def heavy(n):
        m = rng.integers(-128, 128, size=(n, dim), dtype=np.int64)
        m[rng.random((n, dim)) < 0.7] = -128
        return m.astype(np.int8)
    s = heavy(rows)
    q = np.concatenate([s[[3, 100, 7]], np.full((1, dim), -128, np.int8),
                        heavy(t - 4)])
    mag = np.abs(q.astype(np.int64)) @ np.abs(s.astype(np.int64)).T
    assert mag.max() < 2 ** 24, mag.max()
    return q, s


def _operands(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "d1040_neg128":
        q, s = _neg128_heavy(rng, R, 1040, T)
    else:  # the lattice at a ragged D
        m = rng.standard_normal((R, 100)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        m[40:48] = m[3]
        s = quantize_unit_host(m)
        q = np.concatenate([s[[3, 100, 7]], quantize_unit_host(
            m[rng.integers(0, R, T - 3)] * -1.0)])
    return jnp.asarray(q), jnp.asarray(s), torch.from_numpy(q), torch.from_numpy(s)


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CASES = ["d100_lattice", "d1040_neg128"]


@pytest.mark.parametrize("case", CASES)
def test_plain_k1_int8_matches_pallas(case):
    jq, js, tq, ts = _operands(case)
    kw = dict(sub=16, block=128, emit_block=True, emit_argmax=True)
    _equal(port.matmul_blockmax2_only(tq, ts, VALID, **kw),
           ref.matmul_blockmax2_only(jq, js, jnp.int32(VALID), interpret=True, **kw))


@pytest.mark.parametrize("case", CASES)
def test_plain_k3_int8_matches_pallas(case):
    jq, js, tq, ts = _operands(case)
    _equal(port.matmul_blockmax(tq, ts, VALID),
           ref.matmul_blockmax(jq, js, jnp.int32(VALID), interpret=True))


@pytest.mark.parametrize("case", CASES)
def test_plain_k5_int8_matches_pallas(case):
    jq, js, tq, ts = _operands(case)
    _equal(port.matmul_blockmax_only(tq, ts, VALID, block=64),
           ref.matmul_blockmax_only(jq, js, jnp.int32(VALID), interpret=True,
                                    block=64))


def _emit_var(monkeypatch, dim):
    """``scripts/proto_emit_var.py`` with its geometry set to this store:
    its ``k1only`` kernel emits K10's raw int8 key."""
    path = REPO / "scripts" / "proto_emit_var.py"
    spec = importlib.util.spec_from_file_location("_proto_emit_var_tile", path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setattr(sys, "argv", [str(path)])
    spec.loader.exec_module(mod)
    for key, value in dict(R=R, VALID=VALID, D=dim, Q=T, RT=512, RT_T=512,
                           EW=256).items():
        setattr(mod, key, value)
    return mod


@pytest.mark.parametrize("case", CASES)
def test_plain_k10_raw_key_matches_pallas(case, monkeypatch):
    """The RAW tile's integer key (``acc * 128 + 127 - row``, masked rows
    ``_PAD_ACC``), unit maxima at sub 128, against the script's k1only."""
    jq, js, tq, ts = _operands(case)
    key, bms, _bmi = _emit_var(monkeypatch, js.shape[1]).run_tvariant(
        "k1only")(jq, js)
    got_bms, got_key = port.matmul_blockmax2x(tq, ts, VALID, sub=128,
                                              emit_raw_key=True)
    _equal((got_key, got_bms), (key, bms))
