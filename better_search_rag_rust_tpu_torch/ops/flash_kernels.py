"""Flash attention with segment ids: wrappers and plain versions.

Counterpart of ``jax.experimental.pallas.ops.tpu.flash_attention`` (jax
0.9.0), the library module the JAX encoder calls with
``attention_impl="flash"`` (``better_search_rag_rust_tpu/models/nomic.py``).
Its public layout is kept: :data:`DEFAULT_MASK_VALUE`, :class:`SegmentIds`
and :func:`flash_attention` on ``[B, H, S, hd]``. Its three Pallas kernels
have hand-written CUDA kernels (``csrc/flash_kernels.cu``) and, here, a
wrapper and a plain PyTorch version each:

* K14 :func:`flash_attention_fwd` <- ``_flash_attention_impl`` (:758);
* K15 :func:`flash_attention_bwd_dkv` <- ``_flash_attention_bwd_dkv``
  (:1121);
* K16 :func:`flash_attention_bwd_dq` <- ``_flash_attention_bwd_dq`` (:1456).

A wrapper takes its plain version only because its tensors lie on the CPU
(that is how the CPU tests run the encoder and the trainer); for CUDA
tensors it launches the kernel or raises — there is no fallback. Each
kernel launch adds one to :data:`launch_counts`.

:func:`flash_attention` is differentiable: :class:`FlashAttention` pairs
K14 with K15 and K16 as its backward, as the library's ``custom_vjp``
(:254-322) pairs its kernels. On the CPU the backward is the plain backward
from the saved ``l`` and ``m``, not autograd of the plain forward, so the
CPU tests hold the port's backward arithmetic to the library's.

The plain versions follow the library's rounding points: the forward
walks the keys in blocks of 128 (its ``block_k``) with its online softmax,
the unnormalised ``p`` rounded to v's dtype per block (one block: ``p``
normalised first, its single-step kernel); the backward recomputes ``p =
exp(s - m) * (1 / l)``. The CUDA kernels walk 64-key tiles, so on the card
they agree with the plain versions to a tolerance, not bit for bit.

The kernels skip the tile pairs that add exact zeros, by one tile plan
made from the segment ids alone (:func:`segment_tile_plan`; the encoder
makes it once a batch for all its layers, :class:`FlashAttention` saves it
for the backward); the plain versions compute every pair.
:func:`backward_tile_plan`, the same rule read off the forward's ``m``,
is the tests' oracle for it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

#: The library's mask logit: finite, so a row whose first key blocks are
#: all of another segment stays finite (see ``csrc/flash_kernels.cu``).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
#: The library's default block sizes (``BlockSizes.get_default``): every
#: block is 128 rows or keys.
BLOCK = 128
#: Head widths the CUDA kernels are instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: Tokens of a tile of :func:`segment_tile_plan`.
PLAN_TILE = 64
#: What a wrapper's ``plan`` takes: True, the plan of the segment ids
#: (:func:`segment_tile_plan`); None, every tile; or a plan.
Plan = Union[bool, None, torch.Tensor]

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = {"flash_attention_fwd": 0,
                                 "flash_attention_bwd_dkv": 0,
                                 "flash_attention_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class SegmentIds(NamedTuple):
    """Segment ids of the q and kv sequences, ``[B, Sq]`` and ``[B, Sk]``
    integers: a token attends only to tokens of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


def _verify_block(block_name: str, dim_name: str, block: int, dim: int,
                  should_divide: bool = True) -> None:
    """The library's ``_verify_block``, with its messages."""
    if block > dim:
        raise ValueError(f"{block_name}={block} should be smaller or equal "
                         f"to {dim_name}={dim}")
    if should_divide and dim % block != 0:
        raise ValueError(f"{dim_name}={dim} should be divisible by "
                         f"{block_name}={block}")


def _check_inputs(q, k, v, segment_ids) -> None:
    """What the library's ``flash_attention`` and its forward refuse, with
    its exception types and messages."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, hd = q.shape
    bk, hk, sk, hdk = k.shape
    bv, hv, skv, hdv = v.shape
    if b != bk or b != bv:
        raise ValueError(f"Batch size mismatch: got {b}, {bk} and {bv} (for "
                         f"q, k, v respectively)")
    if h != hk or h != hv:
        raise ValueError(f"Head count mismatch: got {h}, {hk}, {hv} (for q, "
                         f"k, v respectively)")
    if hd != hdk:
        raise ValueError(f"Model dimension mismatch: got {hd} and {hdk} (for "
                         f"q and k respectively)")
    if hd != hdv:
        raise NotImplementedError(
            "V model dimension unequal to KV model dimension unsupported")
    if sk != skv:
        raise ValueError(f"KV sequence length mismatch: got {sk} and {skv}")
    if segment_ids is not None:
        if tuple(segment_ids.q.shape) != (b, sq):
            raise ValueError(f"Q segment ids shape mismatch: expected "
                             f"(batch_size={b}, q_seq_len={sq},), got "
                             f"{tuple(segment_ids.q.shape)}")
        if tuple(segment_ids.kv.shape) != (b, sk):
            raise ValueError(f"KV segment ids shape mismatch: expected "
                             f"(batch_size={b}, kv_seq_len={sk},), got "
                             f"{tuple(segment_ids.kv.shape)}")
    _verify_block("block_q", "q_seq_len", BLOCK, sq, should_divide=False)
    _verify_block("block_k_major", "kv_seq_len", BLOCK, sk)
    _verify_block("block_b", "batch", 1, b, should_divide=False)
    if sk != BLOCK and hd > BLOCK and hd % BLOCK:  # its multi-block kernel
        raise NotImplementedError(
            f"head_dim={hd} should be a multiple of {BLOCK} if larger")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if segment_ids is not None:
        devices |= {segment_ids.q.device, segment_ids.kv.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _check_backward(sq: int) -> None:
    """The library's backward blocks: the queries divide into blocks of
    128 too (``block_q_major_dkv``)."""
    _verify_block("block_q_major_dkv", "q_seq_len", BLOCK, sq)


def _mask(seg_q, seg_kv) -> torch.Tensor:
    """``[B, 1, Sq, Sk]`` f32: 0 where the segments agree, else
    :data:`DEFAULT_MASK_VALUE`."""
    same = seg_q[:, None, :, None] == seg_kv[:, None, None, :]
    return torch.where(same, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)


def _logits(q, k, seg_q, seg_kv, sm_scale: float) -> torch.Tensor:
    """The library's logits: the f32 product of q and k (exact products of
    the operands), times ``sm_scale``, plus the segment mask."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if sm_scale != 1.0:
        s = s * sm_scale
    if seg_q is not None:
        s = s + _mask(seg_q, seg_kv)
    return s


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, seg_q: Optional[torch.Tensor],
                              seg_kv: Optional[torch.Tensor],
                              sm_scale: float = 1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain K14: ``(o, l, m)`` — ``o`` in q's dtype, ``l`` and ``m`` f32
    ``[B, H, Sq]`` — by the library's forward kernel, block by block:
    ``m_next = max(m_prev, rowmax(s))``, ``p = exp(s - m_next)``, ``l_next =
    sum(p) + exp(m_prev - m_next) * l_prev``, the accumulator rescaled by
    ``l_corr / l_next`` and ``(p in v's dtype) . v / l_next`` added (its
    ``_flash_attention_kernel_single_batch``, :340). With one key block,
    its single-step kernel (:474): ``p`` normalised before the product."""
    sk = k.shape[2]
    if sk == BLOCK:
        s = _logits(q, k, seg_q, seg_kv, sm_scale)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        p = p / l
        o = torch.matmul(p.to(v.dtype).float(), v.float())
        return o.to(q.dtype), l[..., 0], m[..., 0]
    b, h, sq, hd = q.shape
    m = torch.full((b, h, sq, 1), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, sk, BLOCK):
        end = start + BLOCK
        s = _logits(q, k[:, :, start:end],
                    seg_q, None if seg_kv is None else seg_kv[:, start:end],
                    sm_scale)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_next)
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(dim=-1, keepdim=True) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        acc = acc * (l_corr * inv)
        acc = acc + torch.matmul(p.to(v.dtype).float(),
                                 v[:, :, start:end].float()) * inv
        m, l = m_next, l_next
    return acc.to(q.dtype), l[..., 0], m[..., 0]


def _recompute_p(q, k, seg_q, seg_kv, l, m, sm_scale):
    """The backward's ``p = exp(s - m) * (1 / l)`` (library :860-868)."""
    s = _logits(q, k, seg_q, seg_kv, sm_scale)
    return torch.exp(s - m[..., None]) * (1.0 / l[..., None])


def _ds(p, do, v, di, sm_scale):
    """``ds = (do . v^T - di) * p``, times ``sm_scale`` (library
    :889-895)."""
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (dp - di[..., None]) * p
    if sm_scale != 1.0:
        ds = ds * sm_scale
    return ds


def flash_attention_bwd_dkv_plain(q, k, v, seg_q, seg_kv, l, m, do, di,
                                  sm_scale: float = 1.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K15: ``(dk, dv)`` in k's and v's dtypes by the library's dkv
    kernel (:795): ``dv = (p in do's dtype)^T . do`` and ``dk = (ds in do's
    dtype)^T . q``, f32 sums of the rounded operands."""
    p = _recompute_p(q, k, seg_q, seg_kv, l, m, sm_scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = _ds(p, do, v, di, sm_scale)
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, seg_q, seg_kv, l, m, do, di,
                                 sm_scale: float = 1.0) -> torch.Tensor:
    """Plain K16: ``dq = (ds in k's dtype) . k`` in q's dtype, by the
    library's dq kernel (:1147)."""
    p = _recompute_p(q, k, seg_q, seg_kv, l, m, sm_scale)
    ds = _ds(p, do, v, di, sm_scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, segment_ids: Optional[SegmentIds], o,
                              l, m, do, sm_scale: float = 1.0
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The library's backward (``_flash_attention_bwd``, :286): ``di =
    sum(o * do)`` in f32, then plain K15 and plain K16. Returns ``(dq, dk,
    dv)``."""
    seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
    di = (o.float() * do.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, seg_q, seg_kv, l, m, do,
                                           di, sm_scale)
    dq = flash_attention_bwd_dq_plain(q, k, v, seg_q, seg_kv, l, m, do, di,
                                      sm_scale)
    return dq, dk, dv


def backward_tile_plan(seg_q: Optional[torch.Tensor],
                       seg_kv: Optional[torch.Tensor],
                       m: torch.Tensor) -> Optional[torch.Tensor]:
    """The tile plan read off the forward's ``m``: ``[B, Sq/64, Sk/64]``
    bool, True where the (query tile, key tile) pair of 64 tokens each adds
    exact zeros to dk, dv and dq. The kernels take :func:`segment_tile_plan`,
    the same rule from the ids alone; this is its oracle in the tests. A
    pair is skipped only when the tiles' segment-id ranges ``[min, max]``
    are disjoint (every query-key pair then takes the mask, for any ids,
    contiguous or not) and every query row of the tile has a real maximum
    in every head, ``m > MASK / 2``: a
    row with a key of its own segment has a real logit as its ``m``, so
    ``exp(MASK + x - m)`` underflows to exactly 0 and so does ``ds``. A row
    without one has ``m`` near the mask value and a non-zero ``p``, and its
    tile is never skipped. No segment ids: None (nothing is skipped).
    ``Sq`` and ``Sk`` are multiples of 64; ``m`` is the forward's ``[B, H,
    Sq]``."""
    if seg_q is None:
        return None
    b, sq = seg_q.shape
    sk = seg_kv.shape[1]
    qmin, qmax = seg_q.reshape(b, sq // PLAN_TILE, PLAN_TILE).aminmax(dim=-1)
    kmin, kmax = ((qmin, qmax) if seg_kv is seg_q else
                  seg_kv.reshape(b, sk // PLAN_TILE, PLAN_TILE).aminmax(dim=-1))
    real = m.reshape(b, -1, sq // PLAN_TILE, PLAN_TILE).amin(dim=(1, 3)) \
        > DEFAULT_MASK_VALUE / 2
    disjoint = ((qmax[:, :, None] < kmin[:, None, :])
                | (kmax[:, None, :] < qmin[:, :, None]))
    return disjoint & real[:, :, None]


def _tile_ranges(seg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each 64-token tile's smallest and largest id, ``[B, ceil(S/64)]``
    each; a ragged last tile over its real tokens (padded with its last
    id, which moves neither)."""
    b, s = seg.shape
    pad = -s % PLAN_TILE
    if pad:
        seg = torch.cat([seg, seg[:, -1:].expand(b, pad)], dim=1)
    return seg.reshape(b, -1, PLAN_TILE).aminmax(dim=-1)


def segment_tile_plan(seg_q: Optional[torch.Tensor],
                      seg_kv: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
    """The tile plan of K14, K15 and K16 from the segment ids alone:
    ``[B, ceil(Sq/64), ceil(Sk/64)]`` bool, True where the (query tile, key
    tile) pair of 64 tokens each is skipped. A pair is skipped when the
    tiles' id ranges ``[min, max]`` are disjoint (every query-key pair takes
    the mask) and every real query row of the tile has a key of its own
    segment somewhere in ``seg_kv`` (its ``m`` is then a real logit, so
    every ``p`` of the pair is exactly 0 in the forward and the backward; a
    row without one is never skipped). With ``seg_q is seg_kv`` (the
    encoder's self-attention) every row sees its own key; otherwise each
    row is looked up in its batch row's sorted ``seg_kv``. A ragged last
    tile takes its range over its real tokens. No segment ids: None
    (nothing is skipped). The same plan as :func:`backward_tile_plan` reads
    off the forward's ``m``, without the forward."""
    if seg_q is None:
        return None
    b, sq = seg_q.shape
    qmin, qmax = _tile_ranges(seg_q)
    kmin, kmax = (qmin, qmax) if seg_kv is seg_q else _tile_ranges(seg_kv)
    disjoint = ((qmax[:, :, None] < kmin[:, None, :])
                | (kmax[:, None, :] < qmin[:, :, None]))
    if seg_kv is seg_q:
        return disjoint
    keys = seg_kv.sort(dim=1).values
    ids = seg_q.to(keys.dtype).contiguous()
    at = torch.searchsorted(keys, ids).clamp_max(keys.shape[1] - 1)
    own = keys.gather(1, at) == ids  # [B, Sq]: the row has a key of its own
    pad = -sq % PLAN_TILE
    if pad:
        own = torch.cat([own, own.new_ones((b, pad))], dim=1)
    return disjoint & own.reshape(b, -1, PLAN_TILE).all(dim=-1)[:, :, None]


def _plan_for(plan: Plan, q: torch.Tensor, k: torch.Tensor,
              seg_q: Optional[torch.Tensor], seg_kv: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """The tile plan a kernel reads: ``plan`` as a wrapper takes it
    (:data:`Plan`), made from the ids where it is True, and a given plan
    checked against the operands' shape. The plain versions on the CPU
    read none (every pair), so True makes nothing there."""
    if plan is None:
        return None
    if plan is True:
        if q.device.type == "cpu":
            return None
        return segment_tile_plan(seg_q, seg_kv)
    b, _h, sq, _hd = q.shape
    want = (b, -(-sq // PLAN_TILE), -(-k.shape[2] // PLAN_TILE))
    if (tuple(plan.shape) != want or plan.dtype != torch.bool
            or plan.device != q.device):
        raise ValueError(f"a tile plan is bool {list(want)} on {q.device}, "
                         f"got {plan.dtype} {list(plan.shape)} on "
                         f"{plan.device}")
    return plan.contiguous()


def _check_kernel(name: str, *tensors) -> None:
    """What the CUDA kernels take beyond the library's shapes: bf16 q/k/v
    (and do), their head widths, contiguous operands and a grid that
    fits."""
    q = tensors[0]
    b, h, sq, hd = q.shape
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the {name} kernel takes bfloat16 q/k/v (and do), "
                        f"got {sorted({str(t.dtype) for t in tensors})}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous operands")
    if b * h * max(sq, tensors[1].shape[2]) >= 2**31:
        raise ValueError(f"{b} x {h} heads x {sq} rows too large")


def _kernel_segments(seg_q, seg_kv, b: int, sq: int, sk: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' int32 segment ids; without any, one segment (the mask
    adds 0 everywhere, which is the library's function without ids)."""
    if seg_q is None:
        return (torch.zeros((b, sq), dtype=torch.int32, device=device),
                torch.zeros((b, sk), dtype=torch.int32, device=device))
    return (seg_q.to(torch.int32).contiguous(),
            seg_kv.to(torch.int32).contiguous())


def _aligned16(*tensors) -> tuple:
    """The kernels read their streamed operands by TMA and bulk copies: an
    operand off a 16-byte boundary (a view may be; a fresh tensor is not)
    is copied."""
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in tensors)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg_q: Optional[torch.Tensor],
                        seg_kv: Optional[torch.Tensor], sm_scale: float = 1.0,
                        plan: Plan = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K14. The forward with residuals: ``q [B, H, Sq, hd]``, ``k, v [B, H,
    Sk, hd]``, segment ids ``[B, Sq]`` / ``[B, Sk]`` (or both None) ->
    ``(o, l, m)``. Replaces ``_flash_attention_impl`` (:758). On the card:
    bf16 operands, hd in :data:`KERNEL_HEAD_DIMS`, contiguous; it skips
    the pairs of ``plan`` (:data:`Plan`), which leaves o, l and m bit for
    bit as they are."""
    segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
    _check_inputs(q, k, v, segs)
    plan = _plan_for(plan, q, k, seg_q, seg_kv)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, seg_q, seg_kv, sm_scale)
    _check_kernel("K14", q, k, v)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    sq_i, skv_i = _kernel_segments(seg_q, seg_kv, b, sq, sk, q.device)
    q, k, v, sq_i, skv_i = _aligned16(q, k, v, sq_i, skv_i)
    o = torch.empty_like(q)
    l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    from ._build import library

    lib = library("flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.lib.bsr_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sq_i.data_ptr(),
            skv_i.data_ptr(), None if plan is None else plan.data_ptr(), b,
            h, sq, sk, hd, float(sm_scale), o.data_ptr(), l.data_ptr(),
            m.data_ptr(), stream)
    lib.check("flash_attention_fwd", err)
    launch_counts["flash_attention_fwd"] += 1
    return o, l, m


def _check_bwd_operands(q, k, l, m, do, di) -> None:
    b, h, sq, hd = q.shape
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    for name, t in (("l", l), ("m", m), ("di", di)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{b}, {h}, {sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if len({t.device for t in (q, k, l, m, do, di)}) != 1:
        raise ValueError("backward operands on several devices")
    _check_backward(sq)


def _launch_bwd(name: str, q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                sm_scale, outs) -> None:
    """Launch K15 (``outs`` = dk, dv) or K16 (``outs`` = dq)."""
    _check_kernel(name, q, k, v, do)
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    sq_i, skv_i = _kernel_segments(seg_q, seg_kv, b, sq, sk, q.device)
    q, k, v, do, sq_i, skv_i = _aligned16(q, k, v, do, sq_i, skv_i)
    inv_l, m, di = _aligned16(*(t.contiguous() for t in (inv_l, m, di)))
    plan_ptr = None if plan is None else plan.contiguous().data_ptr()
    from ._build import library

    lib = library("flash")
    entry = {"K15": "bsr_flash_attention_bwd_dkv",
             "K16": "bsr_flash_attention_bwd_dq"}[name]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib.lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sq_i.data_ptr(),
            skv_i.data_ptr(), inv_l.data_ptr(), m.data_ptr(), do.data_ptr(),
            di.data_ptr(), plan_ptr, b, h, sq, sk, hd, float(sm_scale),
            *(t.data_ptr() for t in outs), stream)
    lib.check(entry, err)
    launch_counts[{"K15": "flash_attention_bwd_dkv",
                   "K16": "flash_attention_bwd_dq"}[name]] += 1


def _bwd_dkv_kernel(q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                    sm_scale) -> Tuple[torch.Tensor, torch.Tensor]:
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("K15", q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                sm_scale, (dk, dv))
    return dk, dv


def _bwd_dq_kernel(q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                   sm_scale) -> torch.Tensor:
    dq = torch.empty_like(q)
    _launch_bwd("K16", q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                sm_scale, (dq,))
    return dq


def flash_attention_bwd_dkv(q, k, v, seg_q, seg_kv, l, m, do, di,
                            sm_scale: float = 1.0, plan: Plan = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15. ``(dk, dv)`` from the forward's operands, its ``l`` and ``m``,
    the output's gradient ``do`` and ``di = sum(o * do)`` (f32 ``[B, H,
    Sq]``). Replaces ``_flash_attention_bwd_dkv`` (:1121). On the card it
    skips the pairs of ``plan`` (:data:`Plan`)."""
    segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
    _check_inputs(q, k, v, segs)
    _check_bwd_operands(q, k, l, m, do, di)
    plan = _plan_for(plan, q, k, seg_q, seg_kv)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, seg_q, seg_kv, l, m, do,
                                             di, sm_scale)
    return _bwd_dkv_kernel(q, k, v, seg_q, seg_kv, torch.reciprocal(l), m, do,
                           di, plan, sm_scale)


def flash_attention_bwd_dq(q, k, v, seg_q, seg_kv, l, m, do, di,
                           sm_scale: float = 1.0, plan: Plan = True
                           ) -> torch.Tensor:
    """K16. ``dq`` from the same operands as K15. Replaces
    ``_flash_attention_bwd_dq`` (:1456)."""
    segs = None if seg_q is None else SegmentIds(seg_q, seg_kv)
    _check_inputs(q, k, v, segs)
    _check_bwd_operands(q, k, l, m, do, di)
    plan = _plan_for(plan, q, k, seg_q, seg_kv)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, seg_q, seg_kv, l, m, do,
                                            di, sm_scale)
    return _bwd_dq_kernel(q, k, v, seg_q, seg_kv, torch.reciprocal(l), m, do,
                          di, plan, sm_scale)


class FlashAttention(torch.autograd.Function):
    """K14 forward; K15 then K16 backward, the counterpart of the library's
    ``_flash_attention`` custom VJP (:254-322). The tile plan is made once
    (or taken from the caller) and serves all three kernels. Saves q, k, v,
    o, l, m, the segment ids and the plan; ``di = sum(o * do)`` is computed
    here in plain torch, as the library computes it outside its kernels.
    The segment ids, ``sm_scale`` and the plan get no gradient. On the card
    ``1 / l`` is made once for both backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sm_scale, plan):
        # the library's checks before the plan is made from the ids
        _check_inputs(q, k, v, None if seg_q is None else SegmentIds(seg_q, seg_kv))
        plan = _plan_for(plan, q, k, seg_q, seg_kv)
        o, l, m = flash_attention_fwd(q, k, v, seg_q, seg_kv, sm_scale, plan)
        ctx.save_for_backward(q, k, v, o, l, m, seg_q, seg_kv, plan)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m, seg_q, seg_kv, plan = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = (o.float() * do.float()).sum(dim=-1)
        if q.device.type == "cpu":
            dk, dv = flash_attention_bwd_dkv(q, k, v, seg_q, seg_kv, l, m, do,
                                             di, ctx.sm_scale)
            dq = flash_attention_bwd_dq(q, k, v, seg_q, seg_kv, l, m, do, di,
                                        ctx.sm_scale)
            return dq, dk, dv, None, None, None, None
        _check_bwd_operands(q, k, l, m, do, di)
        inv_l = torch.reciprocal(l)
        dk, dv = _bwd_dkv_kernel(q, k, v, seg_q, seg_kv, inv_l, m, do, di,
                                 plan, ctx.sm_scale)
        dq = _bwd_dq_kernel(q, k, v, seg_q, seg_kv, inv_l, m, do, di, plan,
                            ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[SegmentIds] = None,
                    sm_scale: float = 1.0, *, plan: Plan = True
                    ) -> torch.Tensor:
    """Softmax attention ``[B, H, Sq, hd]`` x ``[B, H, Sk, hd]`` -> ``[B,
    H, Sq, hd]`` in q's dtype, a token attending only to tokens of its own
    segment (``segment_ids``; None: one segment), logits scaled by
    ``sm_scale``. Differentiable in q, k and v (K15 and K16).

    The library's ``flash_attention`` (:137) without ``ab``, ``causal`` and
    ``block_sizes``, which the JAX encoder does not pass: its default
    blocks of 128 ask Sq >= 128 and Sk a multiple of 128 (and, for the
    backward, Sq a multiple of 128 too), and raise its ``ValueError``
    otherwise. On the card: bf16 operands and hd in
    :data:`KERNEL_HEAD_DIMS`; non-contiguous operands are copied. ``plan``
    (:data:`Plan`): the tile plan of the three kernels, made here from the
    segment ids unless the caller made it (:func:`segment_tile_plan`, as
    the encoder does once a batch for all its layers)."""
    seg_q, seg_kv = (None, None) if segment_ids is None else segment_ids
    if q.device.type == "cuda":
        q, k, v = (t.contiguous() for t in (q, k, v))
    return FlashAttention.apply(q, k, v, seg_q, seg_kv, sm_scale, plan)
