"""The mma.sync backward K9 on the CPU: its fragment maps in numpy and a
numpy reference in the kernel's tile order against the JAX kernel.

This is the design the wgmma K9 replaced (``tests/
test_torch_attention_bwd_wgmma.py`` emulates the tree's); it stays as the
older build that ``bench/ab_attn.py`` times the tree against, and as K8's
fragment maps seen from the backward. There ``k9_bwd_query`` and
``k9_bwd_key`` ran every product on
``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` in K8's fragment
layout (``tests/test_torch_attention_tile.py`` emulates K8's routines; this
file reuses them). The query pass holds the rotated q and g of 16 query
rows as A fragments (``load_q_frags``, ``load_a_frags``), takes the logits
by K8's ``qk_tile`` and dp = g v^T by ``dot_tile`` (the same B map), and
dq = ds . K_r with ds repacked C -> A and K_r by ``ldmatrix.trans``
(``pv_acc``, ``tile_pv``'s map). The key pass turns the products round:
the keys are the M rows, their A fragments come by ``ldmatrix`` from the
staged K and V (``ldsm_a_frags``), S^T = K_r Q_r^T and dP^T = V g^T run
through the same two routines, and dV = bf16(P)^T g, dK = dS^T Q_r take the
repacked tiles and g, Q_r by ``ldmatrix.trans``. The emulation asserts, on
integer values (exact in float64), that

* the A fragments of g and of a staged tile hold the rows m16n8k16 reads,
  and a crossed row address (the row and step bits of the lane swapped)
  fails;
* S^T and dP^T put every (key, query) cell where the C fragments say, each
  collecting exactly its own hd products;
* the C -> A repack of bf16(P)^T and dS^T and ``ldmatrix.trans`` of g and
  Q_r give dV and dK every query's row once (one query at a time); the
  query pass's ds . K_r every key's row once;
* dK's rotary adjoint in registers pairs each lane with its partner d +
  hd/2 in the same thread.

Then a numpy reference of K9 in the kernel's tile order — the query pass
over blocks of 16 query rows and 64-key tiles (logits kept, the exact max,
the f32 sum, p, row = sum(dp p), ds, dq = ds k_r), the key pass over blocks
of 64 keys and 32-query tiles (p from the stored max and sum, dv, dk); keys
past S masked to p = 0 against zero K and V rows, query rows past S on zero
q and g and not stored — at S 72, 136 and 200 and hd 16 to 128 with a fully
padded batch row, held to ``jax.vjp`` of the JAX
``fused_attention_qkv_diff`` in interpret mode within ``chip_smoke.py``
phase 9's bound (max |diff| <= 1e-2 max |ref| and cosine >= 0.999 for each
of dq, dk and dv). Giving the keys past S the padded keys' bias instead of
p = 0 breaks the fully padded row, which a test shows. Last,
``bench/ab_attn.py``'s float64 reference of the backward is K9's function.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops.attention_pallas import (
    fused_attention_qkv_diff as jax_fused_attention_qkv_diff,
    rotary_roll_tables as jax_rotary_roll_tables,
)
from better_search_rag_rust_tpu_torch.bench import ab_attn
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak
from test_torch_attention_tile import (
    AKN,
    C_COL,
    C_ROW,
    HDS,
    G,
    LANE,
    T,
    _bf16,
    _inputs,
    _ints,
    a_matrix,
    ldmatrix_x4,
    load_q_frags,
    pv_tile,
    qk_tile,
    rotary,
)

BWD_REL, BWD_COS = 1e-2, 0.999
KB, KQ = 64, 32                # keys of a key-pass block, queries of its tiles


# -- the backward's own routines, lane by lane ---------------------------------


def load_a_frags(x, r0, S):
    """``load_a_frags``: [32, hd/16, 4, 2] A fragments of rows r0 .. r0 + 15
    of x [S, hd] as they are (``load_q_frags``'s layout, no rotary)."""
    hd = x.shape[1]
    a = np.zeros((32, hd // 16, 4, 2))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for hr in range(2):
            s = r0 + g + 8 * hr
            if s >= S:
                continue
            for u in range(hd // 8):
                a[lane, u >> 1, (u & 1) * 2 + hr] = x[s, 8 * u + 2 * t:8 * u + 2 * t + 2]
    return a


def a_base(ld, crossed=False):
    """``ldsm_a_frags``'s row address of each lane in a staged tile: rows
    0-7 | 8-15 by lane bit 3, k 0-7 | 8-15 of the step by lane bit 4
    (``crossed`` swaps the two bits)."""
    if crossed:
        return ((LANE & 7) + ((LANE >> 4) << 3)) * ld + (((LANE >> 3) & 1) << 3)
    return ((LANE & 7) + (((LANE >> 3) & 1) << 3)) * ld + ((LANE >> 4) << 3)


def ldsm_a_frags(rows, ld, crossed=False):
    """``ldsm_a_frags`` on 16 staged rows [16, hd] (pitch ld): [32, hd/16,
    4, 2] A fragments."""
    hd = rows.shape[1]
    smem = np.zeros(16 * ld + 16)
    for r in range(16):
        smem[r * ld:r * ld + hd] = rows[r]
    base = a_base(ld, crossed)
    return np.stack([ldmatrix_x4(smem, base + 16 * ks)
                     for ks in range(hd // 16)], axis=1)


def c_fragments(m):
    """A [16, AKN] matrix as the C fragments [32, AKN/8, 4] that hold it."""
    return np.stack([m[C_ROW, 8 * j + C_COL] for j in range(AKN // 8)], 1)


def adjoint_in_registers(dk_frags, cos2, s2, hd):
    """The key pass's epilogue: dK's rotary adjoint from the C fragments
    [32, hd/8, 4] of a [16, hd] tile (row r's tables cos2[r], s2[r]), lane d
    paired with n8 tile j + hd/16 of the same thread."""
    out = np.zeros((16, hd))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for hr in range(2):
            r = g + 8 * hr
            for j in range(hd // 8):
                jp = (j + hd // 16) % (hd // 8)
                for h in range(2):
                    d, dpart = 8 * j + 2 * t + h, 8 * jp + 2 * t + h
                    out[r, d] = (dk_frags[lane, j, 2 * hr + h] * cos2[r, d]
                                 + dk_frags[lane, jp, 2 * hr + h] * s2[r, dpart])
    return out


# -- the maps --------------------------------------------------------------------


@pytest.mark.parametrize("hd", HDS)
@pytest.mark.parametrize("r0,S", [(0, 40), (32, 40)])  # (32, 40): rows past S
def test_g_fragments_hold_g_at_the_a_layout(hd, r0, S):
    rng = np.random.default_rng(hd + 10)
    x = _ints(rng, S, hd)
    a = load_a_frags(x, r0, S)
    want = np.zeros((16, hd))
    rows = np.arange(r0, min(r0 + 16, S))
    want[rows - r0] = x[rows]
    for ks in range(hd // 16):
        np.testing.assert_array_equal(a_matrix(a[:, ks]),
                                      want[:, 16 * ks:16 * ks + 16])


@pytest.mark.parametrize("hd", HDS)
def test_staged_a_fragments_hold_the_rows(hd):
    """``ldsm_a_frags`` gives the key pass's K and V rows as A fragments; the
    rotated q of ``load_q_frags`` and K rotated in shared memory meet the
    same A matrix."""
    rng = np.random.default_rng(hd + 11)
    rows = _ints(rng, 16, hd)
    fa = ldsm_a_frags(rows, hd + 8)
    for ks in range(hd // 16):
        np.testing.assert_array_equal(a_matrix(fa[:, ks]),
                                      rows[:, 16 * ks:16 * ks + 16])
    cos2, s2 = _ints(rng, 16, hd), _ints(rng, 16, hd)
    rot = ldsm_a_frags(rotary(rows, cos2, s2), hd + 8)
    np.testing.assert_array_equal(rot, load_q_frags(rows, cos2, s2, 0, 16))


@pytest.mark.parametrize("hd", [16, 64])
def test_crossed_a_address_fails(hd):
    """The staged A rows with the row and step bits of the lane crossed read
    the wrong quarter of the tile: the emulation notices."""
    rng = np.random.default_rng(hd + 12)
    rows = _ints(rng, 16, hd)
    fa = ldsm_a_frags(rows, hd + 8, crossed=True)
    assert not np.array_equal(a_matrix(fa[:, 0]), rows[:, :16])


@pytest.mark.parametrize("hd", HDS)
def test_key_major_products_put_each_cell_in_place(hd):
    """S^T = K_r Q_r^T and dP^T = V g^T with the 16 keys as M rows and 64
    queries as N: each (key, query) cell is its rows' dot, and with one-hot
    key rows it reads the query row's lane back exactly."""
    rng = np.random.default_rng(hd + 13)
    ld = hd + 8
    k, q = _ints(rng, 16, hd), _ints(rng, AKN, hd)
    np.testing.assert_array_equal(qk_tile(ldsm_a_frags(k, ld), q, ld), k @ q.T)
    v, g = _ints(rng, 16, hd), _ints(rng, AKN, hd)
    np.testing.assert_array_equal(qk_tile(ldsm_a_frags(v, ld), g, ld), v @ g.T)
    for d in range(0, hd, 5):
        onehot = np.zeros((16, hd))
        onehot[:, d] = 1.0
        np.testing.assert_array_equal(qk_tile(ldsm_a_frags(onehot, ld), q, ld),
                                      np.broadcast_to(q[:, d], (16, AKN)))


@pytest.mark.parametrize("hd", HDS)
def test_dv_dk_collect_every_query_once(hd):
    """dV = bf16(P)^T g and dK = dS^T Q_r: the key-major C fragments repack
    as A fragments (n8 tiles of queries become k16 steps), g and Q_r come
    by ldmatrix.trans; with P one query at a time each key's row reads that
    query's row once."""
    rng = np.random.default_rng(hd + 14)
    ld = hd + 8
    pt, g = _ints(rng, 16, AKN, lo=0), _ints(rng, AKN, hd)
    dst, qr = _ints(rng, 16, AKN), _ints(rng, AKN, hd)
    np.testing.assert_array_equal(pv_tile(pt, g, ld), pt @ g)
    np.testing.assert_array_equal(pv_tile(dst, qr, ld), dst @ qr)
    for query in range(0, AKN, 7 if hd > 32 else 1):
        onehot = np.zeros((16, AKN))
        onehot[:, query] = 1.0
        np.testing.assert_array_equal(pv_tile(onehot, g, ld),
                                      np.broadcast_to(g[query], (16, hd)))
        np.testing.assert_array_equal(pv_tile(onehot, qr, ld),
                                      np.broadcast_to(qr[query], (16, hd)))


@pytest.mark.parametrize("hd", HDS)
def test_query_pass_ds_k_collects_every_key_once(hd):
    """dq = ds . K_r: ds [16 queries, 64 keys] repacked from the C fragments
    that held the logits, K_r by ldmatrix.trans of the rotated tile."""
    rng = np.random.default_rng(hd + 15)
    ld = hd + 8
    ds, kr = _ints(rng, 16, AKN), _ints(rng, AKN, hd)
    np.testing.assert_array_equal(pv_tile(ds, kr, ld), ds @ kr)
    for key in range(0, AKN, 9 if hd > 32 else 1):
        onehot = np.zeros((16, AKN))
        onehot[:, key] = 1.0
        np.testing.assert_array_equal(pv_tile(onehot, kr, ld),
                                      np.broadcast_to(kr[key], (16, hd)))


@pytest.mark.parametrize("hd", HDS)
def test_dk_adjoint_pairs_lanes_in_one_thread(hd):
    rng = np.random.default_rng(hd + 16)
    dk = _ints(rng, 16, hd)
    cos2, s2 = _ints(rng, 16, hd), _ints(rng, 16, hd)
    frags = np.stack([dk[C_ROW, 8 * j + C_COL] for j in range(hd // 8)], 1)
    want = dk * cos2 + np.roll(dk * s2, hd // 2, axis=-1)
    np.testing.assert_array_equal(adjoint_in_registers(frags, cos2, s2, hd),
                                  want)


def test_c_fragments_cover_the_tile_once():
    m = np.arange(16 * AKN, dtype=np.float64).reshape(16, AKN)
    frags = c_fragments(m)
    assert sorted(frags.ravel()) == list(m.ravel())


# -- K9 in the kernel's tile order against the JAX kernel -------------------------


def k9_tile_order(qkv, cos2, s2, bias, g, heads, scale, pad_bias=False):
    """K9 as the two kernels take it, in numpy f32. Query pass: per (b, h)
    and 16-row block, the logits and dp of 64-key tiles kept, the exact row
    max, e = exp(l - m), the f32 sum, p = e / sum, row = sum(dp p), ds =
    bf16(p (dp - row) scale), dq_r = ds k_r, the adjoint and one rounding.
    Key pass: per 64-key block and 32-query tile, p from the stored max and
    sum, dp, ds, dv += bf16(p)^T g, dk_r += ds^T q_r. Keys past S get p = 0
    (``pad_bias``: the padded keys' bias -1e9 instead, the wrong rule)
    against zero K and V rows; query rows past S run on zero q and g and
    are not stored."""
    b, S, width = qkv.shape
    hd = width // (3 * heads)
    n = -(-S // AKN) * AKN
    f32 = np.float32
    out = np.zeros((b, S, width), f32)

    def adjoint(x, rows):
        return x * cos2[rows] + np.roll(x * s2[rows], hd // 2, axis=-1)

    for bi in range(b):
        kb = np.full(n, -1e9 if pad_bias else 0.0, f32)
        kb[:S] = bias[bi]
        live = np.arange(n) < S
        for h in range(heads):
            def head(c):
                return qkv[bi, :, (c * heads + h) * hd:(c * heads + h + 1) * hd]

            qr, kr, v, gg = (np.zeros((n, hd), f32) for _ in range(4))
            qr[:S] = _bf16(rotary(head(0), cos2, s2))
            kr[:S] = _bf16(rotary(head(1), cos2, s2))
            v[:S] = head(2)
            gg[:S] = g[bi, :, h * hd:(h + 1) * hd]
            m, l, row = (np.zeros(n, f32) for _ in range(3))
            for r0 in range(0, -(-S // 16) * 16, 16):
                lg = np.zeros((16, n), f32)
                dp = np.zeros((16, n), f32)
                for k0 in range(0, n, AKN):
                    t = slice(k0, k0 + AKN)
                    lg[:, t] = (qr[r0:r0 + 16] @ kr[t].T) * f32(scale) + kb[t]
                    dp[:, t] = gg[r0:r0 + 16] @ v[t].T
                if not pad_bias:
                    lg[:, ~live] = -np.inf
                mm = lg.max(axis=1)
                e = np.exp(lg - mm[:, None]).astype(f32)
                ll = e.sum(axis=1, dtype=f32)
                p = e / ll[:, None]
                rw = (dp * p).sum(axis=1, dtype=f32)
                ds = _bf16(p * (dp - rw[:, None]) * f32(scale))
                rows = np.arange(r0, min(r0 + 16, S))
                dq = adjoint((ds @ kr)[:len(rows)], rows)
                out[bi, rows, h * hd:(h + 1) * hd] = _bf16(dq)
                m[r0:r0 + 16], l[r0:r0 + 16], row[r0:r0 + 16] = mm, ll, rw
            for k0 in range(0, n, KB):
                keys = slice(k0, k0 + KB)
                dv = np.zeros((KB, hd), f32)
                dk = np.zeros((KB, hd), f32)
                for q0 in range(0, n, KQ):
                    qs = slice(q0, q0 + KQ)
                    lgt = (kr[keys] @ qr[qs].T) * f32(scale) + kb[keys, None]
                    ok = live[None, qs] & (live[keys, None] | pad_bias)
                    with np.errstate(all="ignore"):  # masked cells
                        pt = np.exp(lgt - m[None, qs]) / l[None, qs]
                    pt = np.where(ok, pt, 0.0).astype(f32)
                    dpt = v[keys] @ gg[qs].T
                    dst = _bf16(pt * (dpt - row[None, qs]) * f32(scale))
                    dv += _bf16(pt) @ gg[qs]
                    dk += dst @ qr[qs]
                rows = np.arange(k0, min(k0 + KB, S))
                sl = rows - k0
                out[bi, rows, ((1 * heads + h) * hd):((1 * heads + h + 1) * hd)] = (
                    _bf16(adjoint(dk[sl], rows)))
                out[bi, rows, ((2 * heads + h) * hd):((2 * heads + h + 1) * hd)] = (
                    _bf16(dv[sl]))
    return out


def _jax_vjp(qkv, bias, cos, sin, g, heads, scale):
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    _, vjp = jax.vjp(lambda x: jax_fused_attention_qkv_diff(
        x, jc2, js2, jnp.asarray(bias), heads, scale, True),
        jnp.asarray(qkv, jnp.bfloat16))
    got = vjp(jnp.asarray(g, jnp.bfloat16))[0]
    return np.asarray(got, np.float32), np.asarray(jc2), np.asarray(js2)


def _grads(b, heads, S, hd, seed):
    qkv, valid, bias, cos, sin = _inputs(b, heads, S, hd, seed)
    g = _bf16(np.random.default_rng(seed + 1).standard_normal(
        (b, S, heads * hd)))
    return qkv, valid, bias, cos, sin, g


def _within_bound(got, want):
    for a, r in zip(np.split(got.astype(np.float64), 3, axis=-1),
                    np.split(want.astype(np.float64), 3, axis=-1)):
        assert np.abs(a - r).max() <= BWD_REL * np.abs(r).max()
        assert float((a * r).sum() / (np.linalg.norm(a) * np.linalg.norm(r))) >= BWD_COS


@pytest.mark.parametrize("S,hd", [(72, 16), (136, 32), (200, 64), (72, 128),
                                  (136, 128)])
def test_tile_order_reference_matches_jax_backward(S, hd):
    b, heads = 2, 2
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin, g = _grads(b, heads, S, hd, seed=S + hd)
    assert not valid[-1].any()                    # the fully padded row
    want, c2, s2 = _jax_vjp(qkv, bias, cos, sin, g, heads, scale)
    got = k9_tile_order(qkv, c2, s2, bias, g, heads, scale)
    assert np.isfinite(got).all()
    _within_bound(got, want)
    _within_bound(got[-1], want[-1])              # the fully padded row


def test_padded_keys_need_p_zero_not_the_bias():
    """With S % 64 != 0 the last key tile runs past S. The padded keys'
    bias -1e9 on those keys is harmless where a row has a real key, but in
    a fully padded row every real logit is ~ -1e9 too: the padded keys
    then take p ~ 1/64 each from the S real ones, and the gradients of
    that row leave the bound; p = 0 is the rule."""
    S, hd, heads = 72, 16, 2
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin, g = _grads(2, heads, S, hd, seed=5)
    want, c2, s2 = _jax_vjp(qkv, bias, cos, sin, g, heads, scale)
    good = k9_tile_order(qkv, c2, s2, bias, g, heads, scale)
    bad = k9_tile_order(qkv, c2, s2, bias, g, heads, scale, pad_bias=True)
    _within_bound(good[-1], want[-1])
    with pytest.raises(AssertionError):
        _within_bound(bad[-1], want[-1])
    np.testing.assert_array_equal(bad[0], good[0])


def test_reference64_bwd_matches_the_plain_version():
    """The float64 backward that bench/ab_attn.py and phase 9 hold K9 to is
    K9's function: within phase 9's bound of the plain version, the fully
    padded row too, and its error line reads 0 cells off on itself."""
    b, heads, S, hd = 2, 2, 40, 16
    scale = 1.0 / math.sqrt(hd)
    qkv, valid, bias, cos, sin, g = _grads(b, heads, S, hd, seed=9)
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos), torch.from_numpy(sin))
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tg = torch.from_numpy(g).to(torch.bfloat16)
    tb = torch.from_numpy(bias)
    ref = ab_attn.reference64_bwd(tq, c2, s2, tb, tg, heads, scale, chunk=1)
    plain = ak.fused_attention_qkv_bwd_plain(tq, c2, s2, tb, tg, heads, scale)
    assert ref.dtype == torch.float64 and ref.shape == plain.shape
    _within_bound(plain.double().numpy(), ref.numpy())
    _within_bound(plain[-1].double().numpy(), ref[-1].numpy())
    assert " 0 of " in ab_attn.bwd_error(ref.to(torch.bfloat16), ref)
