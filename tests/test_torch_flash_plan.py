"""The kernels' tile plan: K14, K15 and K16 skip the (query tile, key
tile) pairs it marks, so every pair it marks must add exact zeros.

``backward_tile_plan`` (the rule read off the forward's ``m``) is checked
on the CPU against the plain backward's own ``p = exp(s - m) * (1 / l)``
(``_recompute_p``) and ``ds`` (``_ds``), from the plain forward's ``l`` and
``m``, on numpy-seeded inputs at small sizes: the encoder's contiguous
masks (pad tokens their own segment), shuffled non-contiguous segment ids
(hypothesis), Sq 256 against Sk 384, a query row with no key of its own
segment, and no segment ids. ``segment_tile_plan``, the plan the kernels
take (made from the ids alone, once a batch), is held equal to it on each
of those layouts, and to a tile-by-tile reading of the rule on a ragged
Sq. A plain walk of 64-key tiles in K14's order gives ``o``, ``l`` and
``m`` bit for bit equal with the planned pairs skipped and computed. Last,
the card-time refusal of ``auto``/``fused`` past K8's 1,024 tokens, which
leaves the CPU's resolution the JAX package's.

Tolerances: none. A skipped pair's ``p`` and ``ds`` are exactly 0.0 on
every element (``exp`` of a difference near the mask value underflows),
a row whose maximum is the mask value is never skipped, and the plans and
the walks compare with ``torch.equal``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from better_search_rag_rust_tpu.models.nomic import (
    _resolve_attention_impl as jax_resolve,
)
from better_search_rag_rust_tpu_torch.config import EncoderConfig
from better_search_rag_rust_tpu_torch.models import nomic
from better_search_rag_rust_tpu_torch.models.encoder import create_encoder
from better_search_rag_rust_tpu_torch.models.train import ContrastiveTrainer
from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

T = fk.PLAN_TILE


def _operands(rng, b, h, sq, sk, hd):
    q = torch.from_numpy(rng.standard_normal((b, h, sq, hd), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, h, sk, hd),
                                                 dtype=np.float32))
            for _ in range(2))
    do = torch.from_numpy(rng.standard_normal((b, h, sq, hd), dtype=np.float32))
    return q, k, v, do


def _encoder_segments(rng, b, s):
    """The encoder's ids: 1 on each row's first ``len`` tokens, 0 on the
    pad tokens (row 0 whole)."""
    lens = rng.integers(1, s + 1, size=b)
    lens[0] = s
    return torch.from_numpy((np.arange(s)[None, :] < lens[:, None])
                            .astype(np.int32))


def _check_plan(q, k, v, do, seg_q, seg_kv):
    """The plan against the plain backward's ``p`` and ``ds``: every
    skipped pair exactly zero, every row with its maximum at the mask value
    in no skipped pair. Returns the plan."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, l, m = fk.flash_attention_fwd_plain(q, k, v, seg_q, seg_kv, scale)
    plan = fk.backward_tile_plan(seg_q, seg_kv, m)
    b, _h, sq, _ = q.shape
    sk = k.shape[2]
    assert plan.shape == (b, sq // T, sk // T) and plan.dtype == torch.bool
    p = fk._recompute_p(q, k, seg_q, seg_kv, l, m, scale)
    di = (o.float() * do.float()).sum(-1)
    ds = fk._ds(p, do, v, di, scale)
    skip = plan.repeat_interleave(T, 1).repeat_interleave(T, 2)[:, None]
    skip = skip.expand_as(p)
    assert torch.all(p[skip] == 0.0)
    assert torch.all(ds[skip] == 0.0)
    # a row without a key of its own segment: m near the mask value
    lonely = (m <= fk.DEFAULT_MASK_VALUE / 2).any(dim=1)  # [B, Sq]
    lonely_tiles = lonely.reshape(b, sq // T, T).any(-1)
    assert not torch.any(plan & lonely_tiles[:, :, None])
    _check_ids_plan(plan, seg_q, seg_kv)
    return plan


def _check_ids_plan(want, seg_q, seg_kv):
    """The kernels' plan from the ids alone equals ``want`` (the plan read
    off the forward's ``m``), through the self-attention shortcut (``seg_q
    is seg_kv``) where the two are one tensor, and through the per-row
    lookup on a copy of the key ids."""
    if seg_kv is seg_q:
        assert torch.equal(fk.segment_tile_plan(seg_q, seg_q), want)
    assert torch.equal(fk.segment_tile_plan(seg_q, seg_kv.clone()), want)


@pytest.mark.parametrize("b,h,s,hd,seed", [
    (2, 2, 256, 16, 0), (3, 2, 384, 32, 1), (4, 1, 512, 16, 2),
])
def test_plan_skips_exact_zeros_on_encoder_masks(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = _operands(rng, b, h, s, s, hd)
    seg = _encoder_segments(rng, b, s)
    plan = _check_plan(q, k, v, do, seg, seg)
    assert not plan[0].any()  # row 0 is one segment


def test_plan_skips_on_an_encoder_mask_by_the_segment_rule():
    """Row 1 has 100 real tokens of 256: its whole tiles of real tokens
    (tile 0) against its whole pad tiles (2, 3) are skipped both ways, and
    nothing that touches tile 1 (tokens 64-127, both segments)."""
    rng = np.random.default_rng(3)
    q, k, v, do = _operands(rng, 2, 2, 256, 256, 16)
    seg = torch.ones((2, 256), dtype=torch.int32)
    seg[1, 100:] = 0
    plan = _check_plan(q, k, v, do, seg, seg)
    want = torch.zeros((4, 4), dtype=torch.bool)
    want[0, 2:] = want[2:, 0] = True
    assert torch.equal(plan[1], want) and not plan[0].any()


def test_plan_cross_lengths():
    """Sq 256 against Sk 384, segment ids of each length."""
    rng = np.random.default_rng(4)
    q, _, _, do = _operands(rng, 3, 2, 256, 256, 32)
    _, k, v, _ = _operands(rng, 3, 2, 384, 384, 32)
    seg_q = _encoder_segments(rng, 3, 256)
    seg_kv = _encoder_segments(rng, 3, 384)
    seg_kv[1, 200:] = 0
    seg_q[1, :] = 1
    seg_q[1, 200:] = 0
    plan = _check_plan(q, k, v, do, seg_q, seg_kv)
    assert plan[1].any()


def test_plan_never_skips_a_row_without_an_own_segment_key():
    """Query token 70 of row 0 is in segment -5, which no key has: its
    row's maximum is the mask value and its p is not zero, so its tile (1)
    is in no skipped pair, though the tiles' id ranges are disjoint from
    tiles 2 and 3 and the tile's other rows would allow it."""
    rng = np.random.default_rng(5)
    q, k, v, do = _operands(rng, 2, 2, 256, 256, 16)
    seg = torch.zeros((2, 256), dtype=torch.int32)
    seg[:, 128:] = 1
    seg_q = seg.clone()
    seg_q[0, 70] = -5
    plan = _check_plan(q, k, v, do, seg_q, seg)
    scale = 0.25
    _o, l, m = fk.flash_attention_fwd_plain(q, k, v, seg_q, seg, scale)
    assert bool((m[0, :, 70] < fk.DEFAULT_MASK_VALUE / 2).all())
    p = fk._recompute_p(q, k, seg_q, seg, l, m, scale)
    assert bool((p[0, :, 70] != 0.0).any())
    assert not plan[0, 1].any()
    # the same tile without the lonely token is skipped against tiles 2, 3
    plan_whole = fk.backward_tile_plan(seg, seg, torch.zeros_like(m))
    assert plan_whole[0, 1, 2:].all()


def test_no_segment_ids_skip_nothing():
    rng = np.random.default_rng(6)
    q, k, v, do = _operands(rng, 2, 2, 256, 256, 16)
    _o, _l, m = fk.flash_attention_fwd_plain(q, k, v, None, None, 0.25)
    assert fk.backward_tile_plan(None, None, m) is None
    assert fk.segment_tile_plan(None, None) is None


@settings(max_examples=12, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**31 - 1), sq=st.sampled_from([128, 256]),
       sk=st.sampled_from([128, 256]), spread=st.integers(0, 3),
       shuffle_all=st.booleans())
def test_plan_skips_exact_zeros_on_shuffled_segments(seed, sq, sk, spread,
                                                     shuffle_all):
    """Non-contiguous ids: each 64-token tile draws a base id and each token
    the base plus 0..spread, shuffled within the tile (``shuffle_all``: over
    the whole row), so tiles' ranges may or may not meet; ids in q that no
    key has make rows without an own-segment key."""
    rng = np.random.default_rng(seed)
    b = 2
    q, _, _, do = _operands(rng, b, 2, sq, sq, 16)
    _, k, v, _ = _operands(rng, b, 2, sk, sk, 16)

    def ids(n):
        base = rng.integers(0, 4, size=(b, n // T, 1)) * 10
        tok = base + rng.integers(0, spread + 1, size=(b, n // T, T))
        tok = tok.reshape(b, n)
        for row in tok:
            if shuffle_all:
                rng.shuffle(row)
            else:
                for t0 in range(0, n, T):
                    rng.shuffle(row[t0:t0 + T])
        return torch.from_numpy(tok.astype(np.int32))

    _check_plan(q, k, v, do, ids(sq), ids(sk))


def test_plan_share_on_phase27_lengths():
    """Phase 27's rule (each row's length uniform in [S/8, S], row 0 whole)
    at S 2,048: the skipped share of the 64 x 64 tile pairs against the
    estimate 2 x (1 - x) per row, x = L / S (whole tiles only: each row
    loses at most one tile of each segment to the tile straddling L)."""
    rng = np.random.default_rng(7)
    b, s = 64, 2048
    lens = rng.integers(s // 8, s + 1, size=b)
    lens[0] = s
    seg = torch.from_numpy((np.arange(s)[None, :] < lens[:, None])
                           .astype(np.int32))
    m = torch.zeros((b, 1, s))  # every row has a key of its own segment
    plan = fk.backward_tile_plan(seg, seg, m)
    share = plan.float().mean(dim=(1, 2)).numpy()
    x = lens / s
    estimate = 2 * x * (1 - x)
    n = s // T
    assert np.all(share <= estimate + 1e-12)
    assert np.all(share >= estimate - 2 * (2 / n))
    assert abs(share.mean() - estimate.mean()) < 0.04
    assert 0.28 < share.mean() < 0.38


def _layout(name, rng):
    """Segment ids ``(seg_q, seg_kv)`` of one layout at Sq 256 (Sk 384
    where the lengths cross); ``seg_kv is seg_q`` for self-attention."""
    b = 3
    if name == "encoder":
        seg = _encoder_segments(rng, b, 256)
        seg[1] = 1
        seg[1, 100:] = 0  # 100 real tokens: pairs to skip
        return seg, seg
    if name == "shuffled":
        base = rng.integers(0, 4, size=(b, 256 // T, 1)) * 10
        tok = (base + rng.integers(0, 3, size=(b, 256 // T, T))).reshape(b, 256)
        for row in tok:
            for t0 in range(0, 256, T):
                rng.shuffle(row[t0:t0 + T])
        seg = torch.from_numpy(tok.astype(np.int32))
        return seg, seg
    if name == "cross":
        seg_q = _encoder_segments(rng, b, 256)
        seg_kv = _encoder_segments(rng, b, 384)
        seg_q[1], seg_kv[1] = 1, 1
        seg_q[1, 200:], seg_kv[1, 200:] = 0, 0
        return seg_q, seg_kv
    if name == "lonely":
        seg = torch.zeros((b, 256), dtype=torch.int32)
        seg[:, 128:] = 1
        seg_q = seg.clone()
        seg_q[0, 70] = -5  # no key has segment -5
        seg_q[2, 200] = 7
        return seg_q, seg
    assert name == "none"
    return None, None


@pytest.mark.parametrize("layout", ["encoder", "shuffled", "cross", "lonely",
                                    "none"])
def test_ids_plan_equals_the_plan_read_off_m(layout):
    """``segment_tile_plan`` (the ids alone, once a batch) equals
    ``backward_tile_plan`` on the plain forward's ``m`` on each layout: the
    encoder's masks, shuffled ids, cross lengths, rows whose segment no key
    has (their tiles never skipped), no segment ids."""
    rng = np.random.default_rng(11)
    seg_q, seg_kv = _layout(layout, rng)
    sk = 256 if seg_kv is None else seg_kv.shape[1]
    q, _, _, _ = _operands(rng, 3, 2, 256, 256, 16)
    _, k, v, _ = _operands(rng, 3, 2, sk, sk, 16)
    _o, _l, m = fk.flash_attention_fwd_plain(q, k, v, seg_q, seg_kv, 0.25)
    want = fk.backward_tile_plan(seg_q, seg_kv, m)
    got = fk.segment_tile_plan(seg_q, seg_kv)
    if layout == "none":
        assert want is None and got is None
        return
    assert torch.equal(got, want)
    _check_ids_plan(want, seg_q, seg_kv)
    if layout == "lonely":
        assert not got[0, 1].any() and not got[2, 3].any()
        assert got[1, 1, 2:].all()


def _rule_by_tiles(seg_q, seg_kv):
    """The skip rule read tile by tile over each tile's real rows: the id
    ranges disjoint and every real query row with a key of its own
    segment."""
    b, sq = seg_q.shape
    sk = seg_kv.shape[1]
    nq, nk = -(-sq // T), -(-sk // T)
    want = torch.zeros((b, nq, nk), dtype=torch.bool)
    for i in range(b):
        keys = set(seg_kv[i].tolist())
        for a in range(nq):
            rows = seg_q[i, a * T:(a + 1) * T]
            if not all(x in keys for x in rows.tolist()):
                continue
            for c in range(nk):
                cols = seg_kv[i, c * T:(c + 1) * T]
                want[i, a, c] = bool(rows.max() < cols.min()
                                     or cols.max() < rows.min())
    return want


@pytest.mark.parametrize("sq", [200, 129, 256])
def test_ragged_query_plan_takes_its_last_tile_over_real_rows(sq):
    """A ragged Sq (the forward takes any Sq >= 128) plans ``ceil(Sq/64)``
    query tiles, the last over its real rows only: at Sq 200, rows 192-199
    all pad, their tile is skipped against the real key tiles (rows past
    Sq taken as real ids would keep it)."""
    rng = np.random.default_rng(12)
    seg_kv = _encoder_segments(rng, 3, 256)
    seg_kv[1] = 1
    seg_kv[1, 150:] = 0
    seg_q = seg_kv[:, :sq].clone()
    got = fk.segment_tile_plan(seg_q, seg_kv)
    assert got.shape == (3, -(-sq // T), 4)
    assert torch.equal(got, _rule_by_tiles(seg_q, seg_kv))
    if sq == 200:
        assert got[1, 3, :2].all()


def _k14_walk(q, k, v, seg_q, seg_kv, scale, skip):
    """K14's arithmetic in plain torch, in its order: per 64-row query
    tile, the 64-key tiles in increasing order (those ``skip`` marks left
    out), ``m_next = max(m, rowmax(s))``, ``alpha = exp(m - m_next)``, ``l
    = alpha l + sum(p)``, ``acc = alpha acc + bf16(p) v``; ``o = acc / l``.
    Returns ``(o, l, m)``."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    s_all = fk._logits(q, k, seg_q, seg_kv, scale)
    o = torch.empty((b, h, sq, hd))
    l_out = torch.empty((b, h, sq))
    m_out = torch.empty((b, h, sq))
    for a in range(-(-sq // T)):
        rows = slice(a * T, min(sq, (a + 1) * T))
        n = rows.stop - rows.start
        m = torch.full((b, h, n, 1), -torch.inf)
        l = torch.zeros((b, h, n, 1))
        acc = torch.zeros((b, h, n, hd))
        for c in range(sk // T):
            keep = ~skip[:, a, c]
            if not keep.any():
                continue
            cols = slice(c * T, (c + 1) * T)
            s = s_all[:, :, rows, cols]
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next)
            l_new = l * alpha + p.sum(-1, keepdim=True)
            acc_new = acc * alpha + torch.matmul(
                p.to(torch.bfloat16).float(), v[:, :, cols].float())
            sel = keep[:, None, None, None]
            m = torch.where(sel, m_next, m)
            l = torch.where(sel, l_new, l)
            acc = torch.where(sel, acc_new, acc)
        o[:, :, rows] = acc / l
        l_out[:, :, rows], m_out[:, :, rows] = l[..., 0], m[..., 0]
    return o, l_out, m_out


@pytest.mark.parametrize("layout,sq", [("encoder", 256), ("shuffled", 256),
                                       ("cross", 256), ("lonely", 256),
                                       ("encoder", 200)])
def test_k14_walk_is_bitwise_with_the_plan_on_and_off(layout, sq):
    """Skipping the planned pairs leaves K14's ``o``, ``l`` and ``m`` bit
    for bit as they are: after a row's first own-segment tile a masked tile
    gives alpha = exp(0) = 1 and p = 0; before it, that tile's alpha = 0
    wipes the masked sums. Checked with a plain walk of K14's tile order on
    bf16-valued operands, pad rows and a ragged Sq included; the plan skips
    pairs on every layout."""
    rng = np.random.default_rng(13)
    seg_q, seg_kv = _layout(layout, rng)
    seg_q = seg_q[:, :sq]
    if seg_kv is not seg_q and seg_kv.shape[1] == sq:
        seg_kv = seg_kv.clone()
    sk = seg_kv.shape[1]
    q, _, _, _ = _operands(rng, 3, 2, sq, sq, 32)
    _, k, v, _ = _operands(rng, 3, 2, sk, sk, 32)
    q, k, v = (t.to(torch.bfloat16).float() for t in (q, k, v))
    plan = fk.segment_tile_plan(seg_q, seg_kv)
    assert plan.any()
    scale = 1.0 / math.sqrt(32)
    on = _k14_walk(q, k, v, seg_q, seg_kv, scale, plan)
    off = _k14_walk(q, k, v, seg_q, seg_kv, scale, torch.zeros_like(plan))
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    po, _pl, pm = fk.flash_attention_fwd_plain(q, k, v, seg_q, seg_kv, scale)
    assert torch.equal(on[2], pm)
    assert float((on[0] - po).abs().max()) < 1e-2


@pytest.mark.parametrize("impl,max_tokens,device,raises", [
    ("auto", 2048, "cuda", True), ("fused", 1032, "cuda", True),
    ("auto", 1024, "cuda", False), ("flash", 2048, "cuda", False),
    ("xla_bf16", 2048, "cuda", False), ("auto", 2044, "cuda", False),
    ("auto", 2048, "cpu", False), ("fused", 4096, "cpu", False),
])
def test_fused_past_k8_refused_on_the_card(impl, max_tokens, device, raises):
    """On a CUDA device, ``auto``/``fused`` past ``KERNEL_MAX_SEQ`` raises
    a ``ValueError`` that names ``flash`` (no card needed: the device type
    is an argument); ``max_tokens`` 2,044 resolves to ``xla_bf16`` (not a
    multiple of 8), which takes any length; the CPU is not refused."""
    if raises:
        with pytest.raises(ValueError, match="attention_impl='flash'"):
            nomic.refuse_fused_past_kernel(impl, max_tokens, 64, device)
    else:
        nomic.refuse_fused_past_kernel(impl, max_tokens, 64, device)


def test_cpu_encoder_past_k8_resolves_as_the_jax_package():
    """Built on the CPU at 2,048 tokens with ``auto``, the encoder service
    and the trainer construct, and the resolution is the JAX package's
    (``fused``, recorded as ``torch-fused``)."""
    small = dict(dim=32, num_layers=1, num_heads=2, mlp_dim=64,
                 vocab_size=128, max_tokens=2048)
    svc = create_encoder(EncoderConfig(backend="nomic", **small),
                         device="cpu")
    want = jax_resolve("auto", seq_len=2048, head_dim=16)
    assert want == "fused"
    assert svc.numerics["attention_impl"] == f"torch-{want}"
    assert nomic._resolve_attention_impl("auto", 2048, 16) == want
    cfg = nomic.NomicBertConfig(hidden_size=32, num_layers=1, num_heads=2,
                                mlp_dim=64, vocab_size=128, max_tokens=2048)
    ContrastiveTrainer(cfg, device="cpu")
