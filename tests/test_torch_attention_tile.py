"""The tensor-core forward of K8/K7 on the CPU: its register and shared-memory
maps in numpy, and a numpy reference in the kernel's tile order against the
JAX kernel.

On the card ``attend`` (``ops/csrc/attention_kernels.cu``) runs both products
of a head on ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``: a warp
holds the rotated q of 16 query rows as A fragments loaded straight from
global memory (``load_q_frags``: lane (g, t) holds rows g, g + 8 at lanes
8u + 2t, + 1, and the rotary partner of each is the same thread's); K sits in
shared memory at a pitch of hd + 8 bf16 and reaches the B fragments through
``ldmatrix.x4`` (``qk_tile``); the f32 accumulators of QK^T repack as the A
fragments of bf16(e) . V (``tile_pv``), whose B fragments come through
``ldmatrix.x4.trans`` of the V tile. The emulation below follows the source's
lane arithmetic and the PTX ISA's fragment layout, on integer values (exact
in float64), and asserts that

* the A fragments of q hold the rotary of q, computed from the thread's own
  partner lanes, at the positions m16n8k16 reads;
* each (query, key) logit of a tile collects exactly the hd products of its
  own q and k rows;
* the C -> A repack puts bf16(e)[q][t] where PV's A fragment reads it;
* ``ldmatrix.trans`` of V gives each context cell every e[q][t] v[t][d]
  once (one key at a time);
* one crossed index (K's row address taking the group bit where it takes
  the thread-in-group bit) fails — the fault that the kernels' own identity
  (K7 = K8 bit for bit) could not see, since both share the routine.

Then a numpy reference of K8 in the kernel's tile order — 16 query rows by
64 keys, pass 1 for the exact row max, pass 2 for e, the f32 sum and
bf16(e) . V, the division after PV; keys past S masked to e = 0 with zero V
rows, query rows past S zero and not stored — at S 72, 136 and 200 (S % 16
== 8 and 0, S % 64 != 0) and hd 16 to 128 with a fully padded batch row, held
to the JAX ``fused_attention_qkv`` in interpret mode within the JAX package's
own kernel-vs-einsum bound (max |diff| < 0.02, cosine > 0.999 on valid query
rows; ``tests/test_models.py``). Giving the keys past S the padded keys'
bias instead of e = 0 breaks the fully padded row, which a test shows.
Last, ``bench/ab_attn.py``'s source variants still apply to the tree's
source, and its float64 reference is K8's function.
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


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("r0,S", [(0, 40), (32, 40)])  # (32, 40): rows past S
def test_q_fragments_hold_the_rotary_at_the_a_layout(hd, r0, S):
    rng = np.random.default_rng(hd)
    q, cos2, s2 = _ints(rng, S, hd), _ints(rng, S, hd), _ints(rng, S, hd)
    qa = load_q_frags(q, cos2, s2, r0, S)
    want = np.zeros((16, hd))
    rows = np.arange(r0, min(r0 + 16, S))
    want[rows - r0] = rotary(q[rows], cos2[rows], s2[rows])
    for ks in range(hd // 16):
        np.testing.assert_array_equal(a_matrix(qa[:, ks]),
                                      want[:, 16 * ks:16 * ks + 16])


@pytest.mark.parametrize("hd", HDS)
def test_each_logit_collects_its_own_rows_products(hd):
    """Every (query, key) cell of the tile is q_row . k_row over all hd
    lanes, and each of the hd products lands once: with one-hot q rows the
    cell reads back k's lane exactly."""
    rng = np.random.default_rng(hd + 1)
    ld = hd + 8
    q, k = _ints(rng, 16, hd), _ints(rng, AKN, hd)
    qa = load_q_frags(q, np.ones((16, hd)), np.zeros((16, hd)), 0, 16)
    np.testing.assert_array_equal(qk_tile(qa, k, ld), q @ k.T)
    for d in range(hd):
        onehot = np.zeros((16, hd))
        onehot[:, d] = 1.0
        qa = load_q_frags(onehot, np.ones((16, hd)), np.zeros((16, hd)), 0, 16)
        np.testing.assert_array_equal(qk_tile(qa, k, ld),
                                      np.broadcast_to(k[:, d], (16, AKN)))


@pytest.mark.parametrize("hd", [16, 64])
def test_crossed_k_address_fails(hd):
    """K's row address with the group and step bits crossed reads the wrong
    lanes: the emulation notices."""
    rng = np.random.default_rng(hd + 2)
    q, k = _ints(rng, 16, hd), _ints(rng, AKN, hd)
    qa = load_q_frags(q, np.ones((16, hd)), np.zeros((16, hd)), 0, 16)
    assert not np.array_equal(qk_tile(qa, k, hd + 8, crossed=True), q @ k.T)


def test_repack_puts_each_e_where_pv_reads_it():
    e = np.arange(16 * AKN, dtype=np.float64).reshape(16, AKN)
    for kk, a in enumerate(repack(e)):
        np.testing.assert_array_equal(a_matrix(a), e[:, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("hd", HDS)
def test_pv_collects_every_key_once(hd):
    """bf16(e) . V through ldmatrix.trans equals the product, and with e one
    key at a time each context cell reads that key's V row once."""
    rng = np.random.default_rng(hd + 3)
    ld = hd + 8
    e, v = _ints(rng, 16, AKN, lo=0), _ints(rng, AKN, hd)
    np.testing.assert_array_equal(pv_tile(e, v, ld), e @ v)
    for key in range(0, AKN, 7 if hd > 32 else 1):
        onehot = np.zeros((16, AKN))
        onehot[:, key] = 1.0
        np.testing.assert_array_equal(pv_tile(onehot, v, ld),
                                      np.broadcast_to(v[key], (16, hd)))


def test_v_without_trans_fails():
    """ldmatrix without .trans hands PV the V tile's rows where it reads
    columns: the product is wrong."""
    rng = np.random.default_rng(7)
    hd, ld = 16, 24
    e, v = _ints(rng, 16, AKN, lo=0), _ints(rng, AKN, hd)
    smem = np.zeros(AKN * ld + 16)
    for r in range(AKN):
        smem[r * ld:r * ld + hd] = v[r]
    b = ldmatrix_x4(smem, v_base(ld), trans=False)
    o = mma(repack(e)[0], b[:, 0:2], np.zeros((32, 4)))
    got = np.zeros((16, 8))
    got[C_ROW, C_COL] = o
    assert not np.array_equal(got, e[:, :16] @ v[:16, :8])


# -- K8 in the kernel's tile order against the JAX kernel -----------------------


def _bf16(x):
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def k8_tile_order(qkv, cos2, s2, bias, heads, scale, pad_bias=False):
    """K8 as ``attend`` takes it, in numpy f32: per (b, h) and 16-row query
    tile, pass 1 over 64-key tiles for the exact row max, pass 2 for
    e = exp(l - m), the f32 sum of e and bf16(e) . V, the division after PV
    and one rounding. Keys past S get e = 0 against zero K and V rows
    (``pad_bias``: the padded keys' bias -1e9 instead, the wrong rule);
    query rows past S run on zero q and are dropped."""
    b, S, width = qkv.shape
    hd = width // (3 * heads)
    nk = -(-S // AKN) * AKN
    s16 = -(-S // 16) * 16
    out = np.zeros((b, S, heads * hd), np.float32)
    for bi in range(b):
        kb = np.full(nk, -1e9 if pad_bias else 0.0, np.float32)
        kb[:S] = bias[bi]
        for h in range(heads):
            def head(c):
                return qkv[bi, :, (c * heads + h) * hd:(c * heads + h + 1) * hd]

            qr = np.zeros((s16, hd), np.float32)
            kr = np.zeros((nk, hd), np.float32)
            v = np.zeros((nk, hd), np.float32)
            qr[:S] = _bf16(rotary(head(0), cos2, s2))
            kr[:S] = _bf16(rotary(head(1), cos2, s2))
            v[:S] = head(2)
            for r0 in range(0, s16, 16):
                q = qr[r0:r0 + 16]
                m = np.full(16, -np.inf, np.float32)
                for k0 in range(0, nk, AKN):
                    keys = np.arange(k0, k0 + AKN) < S
                    lg = (q @ kr[k0:k0 + AKN].T) * np.float32(scale) + kb[k0:k0 + AKN]
                    if not pad_bias:
                        lg = lg[:, keys]
                    m = np.maximum(m, lg.max(axis=1))
                den = np.zeros(16, np.float32)
                ctx = np.zeros((16, hd), np.float32)
                for k0 in range(0, nk, AKN):
                    keys = np.arange(k0, k0 + AKN) < S
                    lg = (q @ kr[k0:k0 + AKN].T) * np.float32(scale) + kb[k0:k0 + AKN]
                    d = lg - m[:, None]
                    if not pad_bias:
                        d = np.where(keys[None, :], d, -np.inf)
                    e = np.exp(d).astype(np.float32)
                    den += e.sum(axis=1, dtype=np.float32)
                    ctx += _bf16(e) @ v[k0:k0 + AKN]
                rows = slice(r0, min(r0 + 16, S))
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
