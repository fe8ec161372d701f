"""The backward's tile plan (``ops/flash_kernels.py:backward_tile_plan``):
K15 and K16 skip the (query tile, key tile) pairs it marks, so every pair
it marks must add exact zeros. Checked on the CPU against the plain
backward's own ``p = exp(s - m) * (1 / l)`` (``_recompute_p``) and ``ds``
(``_ds``), from the plain forward's ``l`` and ``m``, on numpy-seeded inputs
at small sizes: the encoder's contiguous masks (pad tokens their own
segment), shuffled non-contiguous segment ids (hypothesis), Sq 256 against
Sk 384, a query row with no key of its own segment, and no segment ids.

Tolerances: none. A skipped pair's ``p`` and ``ds`` are exactly 0.0 on
every element (``exp`` of a difference near the mask value underflows),
and a row whose maximum is the mask value is never skipped.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

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
    return plan


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
