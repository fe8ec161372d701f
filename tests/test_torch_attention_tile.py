"""The wgmma forward of K8/K7 on the CPU: its shared-memory and register
maps in numpy, and a numpy reference in the kernel's tile order against the
JAX kernel.

On the card ``attend`` (``ops/csrc/attention_kernels.cu``) runs both products
of a head on ``wgmma.mma_async ... m64nNk16.f32.bf16.bf16``: TMA writes K and
V as 64-row boxes in ``TileLayout``'s swizzle (the layout of
``tests/test_torch_attention_bwd_wgmma.py``, whose boxes, descriptors and
accumulator maps these tests reuse); the producer warpgroup rotates each K
tile in place (``rotate_tile``: lane d's partner d + hd/2 at ``tile_byte``);
each consumer warp holds the rotated q of its 16 rows as wgmma's register A
fragments (``load_q_frags``); S = Q_r K_r^T reads the K tile K-major
(``qk64``); bf16(e) is repacked C -> A and V read MN-major (``acc_rows``).
The emulation follows the source's address arithmetic on integer values
(exact in float64) and asserts that

* ``tile_byte`` is where TMA writes each lane;
* the in-place rotary pairs every lane with its partner inside the swizzled
  row at hd 16 / 32 / 64 / 128 (rows past S untouched), and a crossed
  partner (hd/2 lanes on in the unswizzled row) fails;
* q's register fragments hold the rotary at wgmma's A layout;
* each logit collects its own rows' products, one k16 step at a time, and a
  K tile in a crossed swizzle fails;
* the C -> A repack puts bf16(e) where PV reads it;
* V read MN-major gives every key once, and V read K-major fails.

The ``mma.sync`` fragment helpers further up (``load_q_frags``, ``qk_tile``,
``pv_tile``, ``ldmatrix_x4``: the K8 that ``bench/attend_mma_sync.cuh``
keeps as ``bench/ab_attn.py``'s ``@mma_sync`` reference) serve
``tests/test_torch_attention_bwd_tile.py``'s emulation of the mma.sync K9.

Then a numpy reference of K8 in the kernel's tile order — 64 query rows by
64 keys, pass 1 for the exact row max, pass 2 for e, the f32 sum in each
thread's order and bf16(e) . V, the division after PV; keys past S masked
to e = 0 with zero V rows, query rows past S zero and not stored — at S 72,
136 and 200 (S % 16 == 8 and 0, S % 64 != 0) and hd 16 to 128 with a fully
padded batch row, held to the JAX ``fused_attention_qkv`` in interpret mode
within the JAX package's own kernel-vs-einsum bound (max |diff| < 0.02,
cosine > 0.999 on valid query rows; ``tests/test_models.py``). Giving the
keys past S the padded keys' bias instead of e = 0 breaks the fully padded
row, which a test shows. Pass 2's skip keeps a key tile whose e is all 0
where its V holds a NaN or an inf: the warpgroup's walk over a V tile
reads each byte once and flags exactly those. The PV probe's plain version
takes its k16 steps in order. Last, ``bench/ab_attn.py``'s source variants
still apply to the tree's source, its corpus lengths are the tokenizer's,
and its float64 reference is K8's function.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops.attention_pallas import (
    fused_attention_qkv as jax_fused_attention_qkv,
    rotary_roll_tables as jax_rotary_roll_tables,
)
from better_search_rag_rust_tpu_torch.bench import ab_attn
from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
from better_search_rag_rust_tpu_torch.ops import _build
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

ATT_TOL, ATT_COS = 0.02, 0.999
AKN = 64                       # keys per tile (``AKN`` in the source)
LANE = np.arange(32)
G, T = LANE // 4, LANE % 4     # group id, thread in group
HDS = [16, 32, 64, 128]


# -- the PTX ISA's m16n8k16 layout and ldmatrix ---------------------------------

# A (16 x 16): register r, half h of lane (g, t) is row A_ROW[r], column
# A_COL[r] + h; B (16 x 8): register r, half h is row 2t + 8r + h, column g;
# C (16 x 8): element e is row g + 8 (e >> 1), column 2t + (e & 1).
A_ROW = np.stack([G, G + 8, G, G + 8], 1)
A_COL = np.stack([2 * T, 2 * T, 2 * T + 8, 2 * T + 8], 1)
C_ROW = np.stack([G, G, G + 8, G + 8], 1)
C_COL = np.stack([2 * T, 2 * T + 1, 2 * T, 2 * T + 1], 1)


def a_matrix(a):
    """[32, 4, 2] A fragments -> the 16 x 16 matrix they hold."""
    m = np.full((16, 16), np.nan)
    for h in range(2):
        m[A_ROW, A_COL + h] = a[..., h]
    return m


def mma(a, b, c):
    """c + A B for fragments a [32, 4, 2], b [32, 2, 2], c [32, 4]."""
    bm = np.full((16, 8), np.nan)
    for r in range(2):
        for h in range(2):
            bm[2 * T + 8 * r + h, G] = b[:, r, h]
    prod = a_matrix(a) @ bm
    assert not np.isnan(prod).any()            # every slot filled exactly
    return c + prod[C_ROW, C_COL]


def ldmatrix_x4(smem, addrs, trans=False):
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16``: lanes 8i .. 8i+7
    give the (element) addresses of the rows of matrix i; lane (g, t) gets
    row g, elements 2t, 2t + 1 (``.trans``: column g, rows 2t, 2t + 1) of
    each matrix. Returns [32, 4, 2]."""
    mats = smem[np.asarray(addrs).reshape(4, 8)[:, :, None] + np.arange(8)]
    if trans:
        mats = mats.transpose(0, 2, 1)
    regs = mats[:, G[:, None], 2 * T[:, None] + np.arange(2)]  # [4, 32, 2]
    return regs.transpose(1, 0, 2)


def k_base(ld, crossed=False):
    """``qk_tile``'s row address of each lane in a K tile: keys 0-7 | 8-15 of
    the pair by lane bit 4, d 0-7 | 8-15 of the step by lane bit 3.
    ``crossed`` swaps the two bits (``tile_pv``'s map, without ``.trans``)."""
    if crossed:
        return ((LANE & 7) + (((LANE >> 3) & 1) << 3)) * ld + ((LANE >> 4) << 3)
    return ((LANE & 7) + ((LANE >> 4) << 3)) * ld + (((LANE >> 3) & 1) << 3)


def v_base(ld):
    """``tile_pv``'s row address of each lane in a V tile: keys 0-7 | 8-15
    of the step by lane bit 3, dims 0-7 | 8-15 of the pair by lane bit 4."""
    return ((LANE & 7) + (((LANE >> 3) & 1) << 3)) * ld + ((LANE >> 4) << 3)


# -- the kernel's routines, lane by lane ---------------------------------------


def rotary(x, cos2, s2):
    """The reference rotary: x*cos2 + roll(x, hd/2)*s2, row by row."""
    return x * cos2 + np.roll(x, x.shape[-1] // 2, axis=-1) * s2


def load_q_frags(q, cos2, s2, r0, S):
    """``load_q_frags``: [32, hd/16, 4, 2] A fragments of the rotated rows
    r0 .. r0 + 15 of q [S, hd], each lane's rotary from its own lanes."""
    hd = q.shape[1]
    nu = hd // 8
    qa = np.zeros((32, hd // 16, 4, 2))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for hr in range(2):
            s = r0 + g + 8 * hr
            if s >= S:
                continue
            d = [8 * u + 2 * t for u in range(nu)]
            x = [q[s, du:du + 2] for du in d]
            c = [cos2[s, du:du + 2] for du in d]
            sn = [s2[s, du:du + 2] for du in d]
            for u in range(nu):
                up = (u + nu // 2) % nu
                qa[lane, u >> 1, (u & 1) * 2 + hr] = x[u] * c[u] + x[up] * sn[u]
    return qa


def qk_tile(qa, kt, ld, crossed=False):
    """``qk_tile`` on a staged K tile kt [AKN, hd] (pitch ld): the raw dots
    as a [16, AKN] matrix (rows of the query tile, keys of the tile), each
    k16 step from zero and added to the dot."""
    hd = kt.shape[1]
    smem = np.zeros(AKN * ld + 16)
    for r in range(AKN):
        smem[r * ld:r * ld + hd] = kt[r]
    base = k_base(ld, crossed)
    acc = np.zeros((32, AKN // 8, 4))
    zero = np.zeros((32, 4))
    for p in range(AKN // 16):
        for ks in range(hd // 16):
            b = ldmatrix_x4(smem, base + 16 * p * ld + 16 * ks)
            acc[:, 2 * p] += mma(qa[:, ks], b[:, 0:2], zero)
            acc[:, 2 * p + 1] += mma(qa[:, ks], b[:, 2:4], zero)
    out = np.zeros((16, AKN))
    for j in range(AKN // 8):
        out[C_ROW, 8 * j + C_COL] = acc[:, j]
    return out


def repack(e):
    """``tile_pv``'s C -> A repack of e [16, AKN] (held as QK^T's C
    fragments): the A fragments [AKN/16, 32, 4, 2] of PV's k16 steps."""
    pa = np.zeros((32, AKN // 8, 2, 2))
    for j in range(AKN // 8):
        pa[:, j, 0] = np.stack([e[G, 8 * j + 2 * T], e[G, 8 * j + 2 * T + 1]], 1)
        pa[:, j, 1] = np.stack([e[G + 8, 8 * j + 2 * T],
                                e[G + 8, 8 * j + 2 * T + 1]], 1)
    return np.stack([np.stack([pa[:, 2 * kk, 0], pa[:, 2 * kk, 1],
                               pa[:, 2 * kk + 1, 0], pa[:, 2 * kk + 1, 1]], 1)
                     for kk in range(AKN // 16)])


def pv_tile(e, vt, ld):
    """``tile_pv``'s product on a staged V tile vt [AKN, hd] (pitch ld):
    bf16(e) . V as a [16, hd] matrix."""
    hd = vt.shape[1]
    smem = np.zeros(AKN * ld + 16)
    for r in range(AKN):
        smem[r * ld:r * ld + hd] = vt[r]
    base = v_base(ld)
    a_steps = repack(e)
    o = np.zeros((32, hd // 8, 4))
    for kk in range(AKN // 16):
        for dq in range(hd // 16):
            b = ldmatrix_x4(smem, base + 16 * kk * ld + 16 * dq, trans=True)
            o[:, 2 * dq] = mma(a_steps[kk], b[:, 0:2], o[:, 2 * dq])
            o[:, 2 * dq + 1] = mma(a_steps[kk], b[:, 2:4], o[:, 2 * dq + 1])
    out = np.zeros((16, hd))
    for j in range(hd // 8):
        out[C_ROW, 8 * j + C_COL] = o[:, j]
    return out


def _ints(rng, *shape, lo=-8, hi=9):
    return rng.integers(lo, hi, size=shape).astype(np.float64)


# -- the wgmma body, emulated ---------------------------------------------------


def _wg():
    """``tests/test_torch_attention_bwd_wgmma.py``, whose TMA boxes,
    descriptors and accumulator maps K8 shares (imported at use: that file
    imports this one's helpers)."""
    import test_torch_attention_bwd_wgmma as wg

    return wg


ROWS = 64                      # rows of a wgmma tile (``WG_ROWS``)


def tile_byte(r, d, hd):
    """``tile_byte``: the byte of lane d of row r in a 64-row tile as TMA
    writes it (column chunk d / (W / 2), its 16-byte piece at the swizzled
    place)."""
    lay = _wg().tile_layout(hd)
    w, cb = lay["W"], lay["CHUNK_BYTES"]
    x = d % (w // 2)
    return ((d // (w // 2)) * cb + r * w
            + 16 * ((x // 8) ^ ((r // (128 // w)) % (w // 16))) + 2 * (x % 8))


def plain_partner(r, d, hd):
    """The crossed rule: the partner lane hd/2 lanes on in the unswizzled
    row (what ``tile_byte`` of lane d plus hd bytes would read)."""
    return (tile_byte(r, d - hd // 2, hd) + hd) % (ROWS * hd * 2)


def rotate_tile(tile, k0, S, cos2, s2, hd, partner=tile_byte):
    """``rotate_tile`` on a tile of bf16 elements (held as float64): for
    each row below S and lane pair j, j + 1 of its low half, the partner
    lanes j + hd/2, j + hd/2 + 1 at ``partner``'s byte; both rotated from
    the values as TMA wrote them, the kernel's thread items in any order
    (each touches its own four lanes)."""
    out = tile.copy()
    h2 = hd // 2
    for r in range(min(ROWS, S - k0)):
        s = k0 + r
        for j in range(0, h2, 2):
            lo, hi = tile_byte(r, j, hd) // 2, partner(r, j + h2, hd) // 2
            xl, xh = tile[lo:lo + 2], tile[hi:hi + 2]
            out[lo:lo + 2] = xl * cos2[s, j:j + 2] + xh * s2[s, j:j + 2]
            out[hi:hi + 2] = xh * cos2[s, j + h2:j + h2 + 2] + xl * s2[s, j + h2:j + h2 + 2]
    return out


def tile_rows(tile, hd):
    """A tile read back K-major, every k16 step (``desc_k``): [64, hd]."""
    wg = _wg()
    return np.concatenate([wg.read_k(tile, hd, kk) for kk in range(hd // 16)], 1)


def wg_q_frags(q, cos2, s2, base, S):
    """``load_q_frags`` of the four warps of a consumer warpgroup (warp w's
    rows base + 16 w ..), read as wgmma's A operand: [64, hd] (register r,
    half h of lane (g, t) in warp w: row 16 w + g + 8 (r & 1), k 16 ks + 2 t
    + 8 (r >> 1) + h)."""
    hd = q.shape[1]
    a = np.full((ROWS, hd), np.nan)
    for w in range(4):
        qa = load_q_frags(q, cos2, s2, base + 16 * w, S)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for ks in range(hd // 16):
                for r in range(4):
                    row, k = 16 * w + g + 8 * (r & 1), 16 * ks + 2 * t + 8 * (r >> 1)
                    a[row, k:k + 2] = qa[lane, ks, r]
    return a


def qk64(a, ktile, hd):
    """``qk64`` cell by cell: each k16 step of A (q_r, [64, hd]) against
    the K tile read K-major, as the accumulator registers; returns the
    steps [hd/16, 64, 64]."""
    wg = _wg()
    return np.stack([wg.from_registers(wg.registers(
        a[:, 16 * kk:16 * kk + 16] @ wg.read_k(ktile, hd, kk).T))
        for kk in range(hd // 16)])


def pv(e, vtile, hd):
    """``acc_rows`` for PV: bf16(e) [64 queries, 64 keys] repacked C -> A,
    times the V tile read MN-major, k16 steps in increasing order within
    each column unit; returns [64, hd]."""
    wg = _wg()
    un, uc = wg.template_constant("UN", hd), wg.template_constant("UC", hd)
    a = wg.pack_a(wg.registers(e))
    acc = np.zeros((uc, 4, 32, un // 2))
    for kk in range(4):
        for c in range(uc):
            acc[c] += wg.registers(a[:, 16 * kk:16 * kk + 16] @ wg.read_mn(vtile, hd, kk, c, un))
    return np.concatenate([wg.from_registers(acc[c]) for c in range(uc)], 1)


@pytest.mark.parametrize("hd", HDS)
def test_tile_byte_is_where_tma_writes_each_lane(hd):
    """The kernel's lane address is the TMA box's: every (row, lane) of a
    tile lands at ``tile_byte``, each byte pair once."""
    mat = np.arange(ROWS * hd, dtype=np.float64).reshape(ROWS, hd) + 1
    tile, _ = _wg().tma_tile(mat, 0, hd)
    at = np.array([[tile_byte(r, d, hd) // 2 for d in range(hd)] for r in range(ROWS)])
    np.testing.assert_array_equal(tile[at], mat)
    assert len(np.unique(at)) == ROWS * hd


@pytest.mark.parametrize("hd", HDS)
def test_in_place_rotary_finds_each_partner_in_the_swizzled_row(hd):
    """The producer's rotary of a landed K tile, in TMA's swizzle (hd 16 /
    32 / 64: 32- / 64- / 128-byte swizzles, the partner piece p ^ hd/16 of
    the same row; hd 128: the same place of the other column chunk), read
    back as the wgmma descriptors read it, is the reference rotary of each
    key row; rows past S (a partial last tile of S 136) stay zero."""
    rng = np.random.default_rng(hd + 10)
    S = 136
    k, cos2, s2 = _ints(rng, S, hd), _ints(rng, S, hd), _ints(rng, S, hd)
    want = rotary(k, cos2, s2)
    for k0 in range(0, S, ROWS):
        tile, _ = _wg().tma_tile(k, k0, hd)
        got = tile_rows(rotate_tile(tile, k0, S, cos2, s2, hd), hd)
        rows = np.arange(k0, k0 + ROWS)
        exp = np.where((rows < S)[:, None], want[np.minimum(rows, S - 1)], 0)
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("hd", HDS)
def test_in_place_rotary_with_a_crossed_partner_fails(hd):
    """Taking the partner hd/2 lanes on in the unswizzled row pairs the
    wrong pieces (or the next row): the rotated tile is wrong."""
    rng = np.random.default_rng(hd + 11)
    k, cos2, s2 = _ints(rng, ROWS, hd), _ints(rng, ROWS, hd), _ints(rng, ROWS, hd)
    tile, _ = _wg().tma_tile(k, 0, hd)
    got = tile_rows(rotate_tile(tile, 0, ROWS, cos2, s2, hd, partner=plain_partner), hd)
    assert not np.array_equal(got, rotary(k, cos2, s2))


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("base,S", [(0, 72), (64, 72)])  # (64, 72): rows past S
def test_q_fragments_hold_the_rotary_at_the_wgmma_a_layout(hd, base, S):
    """``load_q_frags`` for the four warps of a warpgroup holds, as
    wgmma's register A operand, the rotary of the tile's 64 query rows
    (each lane's partner from the thread's own lanes), zeros past S."""
    rng = np.random.default_rng(hd + base)
    q, cos2, s2 = _ints(rng, S, hd), _ints(rng, S, hd), _ints(rng, S, hd)
    rows = np.arange(base, base + ROWS)
    want = np.zeros((ROWS, hd))
    live = rows < S
    want[live] = rotary(q[rows[live]], cos2[rows[live]], s2[rows[live]])
    np.testing.assert_array_equal(wg_q_frags(q, cos2, s2, base, S), want)


@pytest.mark.parametrize("hd", HDS)
def test_each_logit_collects_its_own_rows_products_step_by_step(hd):
    """S = Q_r K_r^T with A from registers and the K tile read K-major:
    each k16 step gives each (query, key) cell exactly its 16 products, the
    steps sum to the dot, and a one-hot q row reads back k's lane."""
    rng = np.random.default_rng(hd + 1)
    q, k = _ints(rng, ROWS, hd), _ints(rng, ROWS, hd)
    ones, zeros = np.ones((ROWS, hd)), np.zeros((ROWS, hd))
    tile, _ = _wg().tma_tile(k, 0, hd)
    steps = qk64(wg_q_frags(q, ones, zeros, 0, ROWS), tile, hd)
    for kk in range(hd // 16):
        np.testing.assert_array_equal(steps[kk], q[:, 16 * kk:16 * kk + 16] @ k[:, 16 * kk:16 * kk + 16].T)
    np.testing.assert_array_equal(steps.sum(0), q @ k.T)
    for d in range(0, hd, 5):
        onehot = np.zeros((ROWS, hd))
        onehot[:, d] = 1.0
        got = qk64(wg_q_frags(onehot, ones, zeros, 0, ROWS), tile, hd).sum(0)
        np.testing.assert_array_equal(got, np.broadcast_to(k[:, d], (ROWS, ROWS)))


@pytest.mark.parametrize("hd", [16, 64])
def test_k_tile_in_a_crossed_swizzle_fails(hd):
    """K written with the swizzle's bits one place too high and read by the
    descriptors' swizzle gives wrong logits: the emulation notices."""
    rng = np.random.default_rng(hd + 2)
    q, k = _ints(rng, ROWS, hd), _ints(rng, ROWS, hd)
    wg = _wg()
    tile, _ = wg.tma_tile(k, 0, hd, wg.crossed_swizzle)
    a = wg_q_frags(q, np.ones((ROWS, hd)), np.zeros((ROWS, hd)), 0, ROWS)
    assert not np.array_equal(qk64(a, tile, hd).sum(0), q @ k.T)


def test_repack_puts_bf16_e_where_pv_reads_it():
    """The C -> A repack of a tile's e (keys past S zero, as a partial last
    tile leaves them) is wgmma's A operand of PV cell for cell."""
    e = np.arange(ROWS * ROWS, dtype=np.float64).reshape(ROWS, ROWS) + 1
    e[:, 40:] = 0.0
    wg = _wg()
    np.testing.assert_array_equal(wg.pack_a(wg.registers(e)), e)


@pytest.mark.parametrize("hd", HDS)
def test_pv_gives_every_key_once(hd):
    """bf16(e) V with the V tile read MN-major (hd 128: two 64-column
    units) is the product, and with e one key at a time each context cell
    reads that key's V row once."""
    rng = np.random.default_rng(hd + 3)
    e, v = _ints(rng, ROWS, ROWS, lo=0), _ints(rng, ROWS, hd)
    tile, _ = _wg().tma_tile(v, 0, hd)
    np.testing.assert_array_equal(pv(e, tile, hd), e @ v)
    for key in range(0, ROWS, 7):
        onehot = np.zeros((ROWS, ROWS))
        onehot[:, key] = 1.0
        np.testing.assert_array_equal(pv(onehot, tile, hd), np.broadcast_to(v[key], (ROWS, hd)))


def test_v_read_k_major_fails():
    """V read K-major (as K is) hands PV the tile's rows where it reads
    columns: the product is wrong."""
    rng = np.random.default_rng(7)
    hd = 64
    e, v = _ints(rng, ROWS, ROWS, lo=0), _ints(rng, ROWS, hd)
    wg = _wg()
    tile, _ = wg.tma_tile(v, 0, hd)
    a = wg.pack_a(wg.registers(e))
    got = sum(a[:, 16 * kk:16 * kk + 16] @ wg.read_k(tile, hd, kk).T for kk in range(4))
    assert not np.array_equal(got, e @ v)


def _skip_below():
    """``ATT_SKIP_BELOW`` of the source."""
    import re

    src = ab_attn.TREE_SOURCE.read_text()
    return float(re.search(r"constexpr float ATT_SKIP_BELOW = (-?[0-9.]+)f;", src).group(1))


def live_tiles(lg):
    """Pass 1's mask of the key tiles pass 2 needs for a warpgroup's logits
    lg [64, n 64] f32 (keys past S -inf): thread t of a row's quad holds
    columns 8 jj + 2 t, + 1 of each tile; a tile is live if any thread's
    tile maximum (NaN dropped, as the row maximum drops it) minus its
    running maximum (this tile included) is not at or below ATT_SKIP_BELOW,
    or if any of the thread's logits in it is NaN."""
    f32 = np.float32
    below = f32(_skip_below())
    rows, nk = lg.shape
    cells = lg.reshape(rows, nk // 64, 8, 4, 2)      # [row, tile, jj, t, pair]
    tmax = np.fmax.reduce(np.fmax.reduce(cells, axis=4), axis=2)  # [row, tile, t]
    run = np.fmax.accumulate(tmax, axis=1)
    nan = np.isnan(cells).any(axis=(2, 4))
    with np.errstate(invalid="ignore"):
        return (nan | ~((tmax - run).astype(f32) <= below)).any(axis=(0, 2))


@pytest.mark.parametrize("mul", [1.0, 8.0])
def test_skipped_key_tiles_hold_only_zero_e(mul):
    """Pass 2 skips a key tile of a warpgroup's 64 rows only where every e
    of it is exactly 0 in f32 (so l and PV keep their bits): on rows with
    keys padded past their length (bias -1e9), a fully padded row (every
    tile kept), logits 8x wider, and a NaN logit (its tile kept)."""
    f32 = np.float32
    rng = np.random.default_rng(int(mul))
    S, hd = 520, 64
    q, k = rng.standard_normal((64, hd)) * mul, rng.standard_normal((S, hd)) * mul
    dots = (_bf16(q) @ _bf16(k).T).astype(f32)
    nk = -(-S // 64) * 64
    for length, skipped in ((0, False), (200, True)):
        bias = np.where(np.arange(S) < length, 0.0, -1e9).astype(f32)
        lg = np.full((64, nk), -np.inf, f32)
        lg[:, :S] = ((dots * f32(1 / 8)).astype(f32) + bias).astype(f32)
        live = live_tiles(lg)
        m = lg.max(axis=1)
        with np.errstate(over="ignore"):
            e = np.exp((lg - m[:, None]).astype(f32)).astype(f32)
        dead = np.repeat(~live, 64)
        assert (e[:, dead] == 0).all()
        assert bool((~live).any()) == skipped
    assert not live[5]                                  # keys 320 .. 383, all padded
    lg[3, 330] = np.nan
    assert live_tiles(lg)[5]


def _nonfinite_mask():
    """``v_tile_nonfinite``'s exponent mask ``E`` of the source."""
    import re

    src = ab_attn.TREE_SOURCE.read_text()
    return int(re.search(r"constexpr uint32_t E = (0x[0-9A-Fa-f]+)u;", src).group(1), 16)


def v_tile_nonfinite(bits, hd):
    """``v_share_nonfinite`` of each of a warpgroup's 128 threads on a V
    tile's bf16 bits (uint16, in TMA's byte order), OR-ed as
    ``v_tile_nonfinite``'s ``bar.red.or`` and the persistent producer's
    warp words do: thread t reads the 16 bytes at 16 t + 2048 u (u < BYTES
    / 2048) as four 32-bit words, and a halfword whose bits under E's half
    equal them sets its flag (``__vcmpeq2``). Returns the vote and how
    often each byte was read."""
    e = _nonfinite_mask()
    words = bits.view(np.uint32)
    nbytes = ROWS * hd * 2
    reads = np.zeros(nbytes, int)
    bad = False
    for t in range(128):
        for u in range(nbytes // 2048):
            off = 16 * t + 2048 * u
            reads[off:off + 16] += 1
            for w in words[off // 4:off // 4 + 4]:
                x = int(w) & e
                bad |= (x & 0xFFFF) == (e & 0xFFFF) or (x >> 16) == (e >> 16)
    return bad, reads


def _v_bits(v):
    """The bf16 bits of V rows, in order."""
    return np.ascontiguousarray(v, dtype=np.float32).astype(
        ml_dtypes.bfloat16).view(np.uint16).reshape(-1)


@pytest.mark.parametrize("hd", HDS)
def test_v_check_reads_every_lane_once_and_flags_only_nan_and_inf(hd):
    """The warpgroup's walk over a V tile reads each byte once, and the
    vote is set by a NaN of either sign or an inf of either sign anywhere
    in the tile, never by a finite value (the largest of each sign, a
    subnormal, -0)."""
    rng = np.random.default_rng(hd)
    bits = _v_bits(rng.standard_normal((ROWS, hd)))
    bad, reads = v_tile_nonfinite(bits, hd)
    assert not bad and (reads == 1).all()
    for pattern in (0x7F7F, 0xFF7F, 0x0001, 0x8000):
        b = bits.copy()
        b[rng.integers(b.size)] = pattern
        assert not v_tile_nonfinite(b, hd)[0]
    for pattern in (0x7FC0, 0xFFC0, 0xFFFF, 0x7F81, 0x7F80, 0xFF80):
        for at in (0, b.size - 1, int(rng.integers(b.size))):
            b = bits.copy()
            b[at] = pattern
            assert v_tile_nonfinite(b, hd)[0]


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_a_tile_whose_e_is_zero_runs_where_its_v_is_not_finite(value):
    """bf16(0) times a NaN or an inf is NaN: a key tile that pass 1 marks
    dead (every e 0) still runs where its V tile holds one, so the context
    has the NaNs of the order that runs every tile, and with finite V the
    skip changes nothing; dropping the V check loses the NaNs."""
    f32 = np.float32
    rng = np.random.default_rng(5)
    S, hd, length = 520, 64, 200
    q, k = rng.standard_normal((64, hd)), rng.standard_normal((S, hd))
    dots = (_bf16(q) @ _bf16(k).T).astype(f32)
    nk = -(-S // 64) * 64
    bias = np.where(np.arange(S) < length, 0.0, -1e9).astype(f32)
    lg = np.full((64, nk), -np.inf, f32)
    lg[:, :S] = ((dots * f32(1 / 8)).astype(f32) + bias).astype(f32)
    live = live_tiles(lg)
    with np.errstate(over="ignore"):
        e = _bf16(np.exp((lg - lg.max(axis=1)[:, None]).astype(f32)))
    v = np.zeros((nk, hd))
    v[:S] = _bf16(rng.standard_normal((S, hd)))

    def pass2(v, skip=True, check=True):
        out = np.zeros((64, hd))
        for j in range(nk // 64):
            t = slice(64 * j, 64 * j + 64)
            if skip and not live[j] and not (check and v_tile_nonfinite(_v_bits(v[t]), hd)[0]):
                continue
            with np.errstate(invalid="ignore"):
                out += e[:, t] @ v[t]
        return out

    assert not live[5]                                  # keys 320 .. 383, all padded
    np.testing.assert_array_equal(pass2(v), pass2(v, skip=False))
    v[330, 5] = value
    got, want = pass2(v), pass2(v, skip=False)
    assert np.isnan(got[:, 5]).all() and np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    assert not np.isnan(pass2(v, check=False)).any()


def test_corpus_lengths_are_the_tokenizers_mask():
    """``bench/ab_attn.py``'s corpus lengths: the build-mode tree's files
    take 406 tokens (CLS, ``class``, ``F<i>``, ``{``, 400 words, ``}``,
    SEP), the JabRef corpus's lie in [2, S]; the shares count padded keys
    and the 64-key tiles wholly past a row's length, every tile of a fully
    padded row running."""
    assert (ab_attn.corpus_lengths("java", 8, 512) == 406).all()
    lens = ab_attn.corpus_lengths("jabref", 16, 512)
    assert lens.shape == (16,) and ((lens >= 2) & (lens <= 512)).all()
    keys, tiles = ab_attn.pad_shares(np.array([406] * 4), 512)
    assert keys == pytest.approx(1 - 406 / 512) and tiles == pytest.approx(1 / 8)
    assert ab_attn.pad_shares(np.array([0, 512]), 512) == (0.5, 0.0)


# -- the PV probe's plain version -------------------------------------------------


def test_pv_probe_plain_adds_each_step_once_in_order():
    """``probe_pv_acc_plain``: each k16 step's exact sum added to the
    running f32 sum with one rounding, steps in increasing order: 1, then
    2^-24 twice, stays 1 (each add ties to even), where the steps taken the
    other way round, or summed at once, give 1 + 2^-23."""
    a = torch.zeros((64, 64), dtype=torch.bfloat16)
    b = torch.ones((64, 64), dtype=torch.bfloat16)
    a[:, 0], a[:, 16], a[:, 32] = 1.0, 2.0 ** -24, 2.0 ** -24
    wg, mma = ak.probe_pv_acc(a, b)                 # CPU: the plain version
    assert torch.equal(wg, mma) and bool((wg == 1.0).all())
    flipped = torch.zeros_like(a)
    flipped[:, 0], flipped[:, 16], flipped[:, 32] = 2.0 ** -24, 2.0 ** -24, 1.0
    got, _ = ak.probe_pv_acc_plain(flipped, b)
    assert bool((got == np.float32(1 + 2.0 ** -23)).all())


def test_pv_probe_refuses_what_it_does_not_take():
    a = torch.zeros((64, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        ak.probe_pv_acc(a.float(), a)
    with pytest.raises(ValueError, match="PV probe"):
        ak.probe_pv_acc(a[:32], a)
    with pytest.raises(ValueError, match="PV probe"):
        ak.probe_pv_acc(a, a[:, :32])


# -- K8 in the kernel's tile order against the JAX kernel -----------------------


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _running_sums(e, keys):
    """l in ``attend``'s order: the thread of quad position t adds a row's
    cells 8 jj + 2 t and + 1 of each n8 group of keys below ``keys`` as ((l
    + e0) + e1), group after group, tile after tile; then the quad, (l_0 +
    l_1) + (l_2 + l_3). e [R, nk] f32."""
    f32 = np.float32
    c = e.reshape(e.shape[0], -1, 4, 2)         # [R, n8 group, t, pair]
    l = np.zeros((e.shape[0], 4), f32)
    for grp in range(keys // 8):
        l = ((l + c[:, grp, :, 0]).astype(f32) + c[:, grp, :, 1]).astype(f32)
    return ((l[:, 0] + l[:, 1]).astype(f32) + (l[:, 2] + l[:, 3]).astype(f32)).astype(f32)


def k8_tile_order(qkv, cos2, s2, bias, heads, scale, pad_bias=False):
    """K8 as ``attend`` takes it, in numpy f32: per (b, h) and 64-row query
    tile, over 64-key tiles, pass 1 the exact row max of the logits (each
    k16 step of the dot from +0.0 and added with one rounding, then times
    scale plus the key's bias), pass 2 e = exp(l - m), the f32 sum of e in
    each thread's key order and then the quad (:func:`_running_sums`), and
    bf16(e) . V accumulated a k16 step at a time; the division after PV
    and one rounding. Keys past S get e = 0 against zero K and V rows
    (``pad_bias``: the padded keys' bias -1e9 instead, the wrong rule);
    query rows past S run on zero q and are dropped."""
    f32 = np.float32
    steps = _wg()._steps
    b, S, width = qkv.shape
    hd = width // (3 * heads)
    nk = -(-S // ROWS) * ROWS
    out = np.zeros((b, S, heads * hd), f32)
    for bi in range(b):
        kb = np.full(nk, -1e9 if pad_bias else 0.0, f32)
        kb[:S] = bias[bi]
        live = np.arange(nk) < S
        for h in range(heads):
            def head(c):
                return qkv[bi, :, (c * heads + h) * hd:(c * heads + h + 1) * hd]

            qr, kr, v = (np.zeros((nk, hd), f32) for _ in range(3))
            qr[:S] = _bf16(rotary(head(0), cos2, s2))
            kr[:S] = _bf16(rotary(head(1), cos2, s2))
            v[:S] = head(2)
            for r0 in range(0, nk, ROWS):
                lg = np.concatenate([
                    ((steps(qr[r0:r0 + ROWS], kr[k0:k0 + ROWS]) * f32(scale)).astype(f32)
                     + kb[k0:k0 + ROWS]).astype(f32) for k0 in range(0, nk, ROWS)], 1)
                if not pad_bias:
                    lg[:, ~live] = -np.inf
                m = lg.max(axis=1)
                e = np.exp((lg - m[:, None]).astype(f32)).astype(f32)
                den = _running_sums(e, nk if pad_bias else S)
                eb = _bf16(e).astype(np.float64)
                ctx = np.zeros((ROWS, hd), f32)
                for k0 in range(0, nk, 16):
                    ctx = (ctx + (eb[:, k0:k0 + 16] @ v[k0:k0 + 16]).astype(f32)).astype(f32)
                rows = slice(r0, min(r0 + ROWS, S))
                out[bi, rows, h * hd:(h + 1) * hd] = _bf16(
                    ctx / den[:, None])[:rows.stop - r0]
    return out


def _inputs(b, heads, S, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng.standard_normal((b, S, 3 * heads * hd)))
    lens = rng.integers(1, S + 1, size=b)
    lens[-1] = 0                                   # one fully padded row
    valid = np.arange(S)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    cos, sin = rotary_tables(S, hd, 1000.0)
    return qkv, valid, bias, cos, sin


def _jax(qkv, bias, cos, sin, heads, scale):
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    got = jax_fused_attention_qkv(jnp.asarray(qkv, jnp.bfloat16), jc2, js2,
                                  jnp.asarray(bias), heads, scale,
                                  interpret=True)
    return np.asarray(got, np.float32), np.asarray(jc2), np.asarray(js2)


@pytest.mark.parametrize("S,hd", [(72, 16), (136, 32), (200, 64), (72, 128),
                                  (136, 128)])
def test_tile_order_reference_matches_jax_kernel(S, hd):
    b, heads = 2, 2
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin = _inputs(b, heads, S, hd, seed=S + hd)
    want, c2, s2 = _jax(qkv, bias, cos, sin, heads, scale)
    got = k8_tile_order(qkv, c2, s2, bias, heads, scale)
    assert np.isfinite(got).all()
    a, r = got[valid], want[valid]
    assert np.abs(a - r).max() < ATT_TOL
    assert float((a * r).sum() / (np.linalg.norm(a) * np.linalg.norm(r))) > ATT_COS
    # the fully padded row: every key's e is 1, the context V's plain mean
    assert np.abs(got[-1] - want[-1]).max() < ATT_TOL


def test_padded_keys_need_e_zero_not_the_bias():
    """With S % 64 != 0 the last key tile runs past S. Bias -1e9 on those
    keys is harmless where a row has a real key (e ~ 0), but in a fully
    padded row every real logit is ~ -1e9 too, so the padded keys get e ~ 1
    and their zero V rows shrink the mean: e = 0 is the rule."""
    S, hd, heads = 72, 16, 2
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin = _inputs(2, heads, S, hd, seed=5)
    want, c2, s2 = _jax(qkv, bias, cos, sin, heads, scale)
    good = k8_tile_order(qkv, c2, s2, bias, heads, scale)
    bad = k8_tile_order(qkv, c2, s2, bias, heads, scale, pad_bias=True)
    assert np.abs(good[-1] - want[-1]).max() < ATT_TOL
    assert np.abs(bad[-1] - want[-1]).max() > ATT_TOL
    np.testing.assert_array_equal(bad[0][valid[0]], good[0][valid[0]])


# -- bench/ab_attn.py on the CPU ------------------------------------------------


@pytest.mark.parametrize("name", sorted(ab_attn.VARIANTS))
def test_ab_attn_variants_edit_the_tree_source(name):
    """Each variant's edit still applies to the tree's source (an edit that
    no longer matches would time the tree under the variant's name) and
    keeps every entry point the package binds."""
    src = ab_attn.TREE_SOURCE.read_text()
    out = ab_attn.VARIANTS[name](src)
    assert out != src
    for entry in _build.SOURCES["attention"][1]:
        assert f"{entry}(" in out


def test_reference64_matches_the_plain_version():
    """The float64 evaluation that the A/B and phases 6 / 18 hold K8 to is
    K8's function: within the kernel bound of the plain version, the fully
    padded row too."""
    b, heads, S, hd = 2, 2, 40, 16
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin = _inputs(b, heads, S, hd, seed=9)
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    ref = ab_attn.reference64(tq, c2, s2, tb, heads, scale, chunk=1)
    plain = ak.fused_attention_qkv_plain(tq, c2, s2, tb, heads, scale)
    assert ref.dtype == torch.float64 and ref.shape == plain.shape
    assert float((ref - plain.double()).abs().max()) < ATT_TOL


def test_unaligned_operands_are_copied_to_a_16_byte_boundary():
    """The forward wrappers hand the kernels 16-byte aligned operands: a view
    off the boundary is copied (same values, contiguous), an aligned one is
    passed as it is."""
    base = torch.arange(72, dtype=torch.bfloat16)
    aligned = torch.arange(64, dtype=torch.bfloat16)
    off = base[1:65]
    assert off.data_ptr() % 16 and not aligned.data_ptr() % 16
    a, o = ak._aligned16(aligned, off)
    assert a is aligned
    assert o.data_ptr() % 16 == 0 and o.is_contiguous() and torch.equal(o, off)
