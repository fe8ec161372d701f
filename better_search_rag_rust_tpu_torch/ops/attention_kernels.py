"""Fused rotary + attention of the encoder: wrappers and plain versions.

Counterpart of ``better_search_rag_rust_tpu/ops/attention_pallas.py``. The
two Pallas kernels on the encoder's paths, K8 ``fused_attention_qkv`` (:177,
the forward) and K9 ``_fused_qkv_bwd`` (:290, its recompute backward), have
hand-written CUDA kernels (``csrc/attention_kernels.cu``) and, here, a
wrapper and a plain PyTorch version each. A wrapper takes its plain version
only because its tensors lie on the CPU (that is how the CPU tests run the
encoder and the trainer); for CUDA tensors it launches the kernel or raises
— there is no fallback. Each kernel launch adds one to :data:`launch_counts`.

:func:`fused_attention_qkv` is differentiable: :class:`FusedAttentionQKV`
pairs the K8 wrapper with the K9 wrapper as its backward, the counterpart
of ``fused_attention_qkv_diff`` (:358). On the CPU the backward is the plain
K9, not autograd of the plain forward, so the CPU tests hold the port's
backward arithmetic against the JAX kernel's.

The kernels and their plain versions sum in different orders (the plain
versions go through [B, H, S, S] f32 tensors and f32 matrix products), so
on the card they agree to a tolerance, not bit for bit: the JAX package's
own bound for K8 against the einsum chain is max |diff| < 0.02 with cosine >
0.999 on valid query rows (``tests/test_models.py:369-373``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = {"fused_attention_qkv": 0,
                                 "fused_attention_qkv_bwd": 0}

#: Head widths the CUDA kernels are instantiated for (their register tiles).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: Longest sequence whose [32, S] f32 logits tile fits in shared memory
#: (``MAX_S`` in the CUDA source), forward and backward.
KERNEL_MAX_SEQ = 1024


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def rotary_roll_tables(cos: torch.Tensor, sin: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[S, hd/2]`` cos/sin -> full-lane ``[S, hd]`` ``(cos2, s2)`` for the
    roll form ``rot(x) = x*cos2 + roll(x, hd/2)*s2``: lane j < hd/2 computes
    ``x1*cos - x2*sin``, lane j >= hd/2 ``x2*cos + x1*sin`` — NeoX
    rotate-halves, the reference's ``rotary_roll_tables`` (:47)."""
    return torch.cat([cos, cos], dim=-1), torch.cat([-sin, sin], dim=-1)


def fused_attention_qkv_plain(qkv: torch.Tensor, cos2: torch.Tensor,
                              s2: torch.Tensor, bias: torch.Tensor,
                              heads: int, scale: float) -> torch.Tensor:
    """Plain K8: the same function as :func:`fused_attention_qkv`, through
    ``[B, H, S, S]`` f32 logits. Rotary in f32 rounded once to the input
    dtype; f32 logits of the rounded q and k; ``e = exp(l - max)``, the
    denominator summing the f32 ``e`` while AV takes ``e`` rounded to the
    input dtype; normalization after AV."""
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    dt = qkv.dtype
    x = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]

    def rot(t):
        tf = t.to(torch.float32)
        return (tf * cos2 + torch.roll(tf, hd // 2, dims=-1) * s2).to(dt)

    q = rot(x[0]).to(torch.float32)
    k = rot(x[1]).to(torch.float32)
    v = x[2].to(torch.float32)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[:, None, None, :]
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    denom = e.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(e.to(dt).to(torch.float32), v)     # [B, H, S, hd] f32
    out = (ctx / denom).to(dt)
    return out.permute(0, 2, 1, 3).reshape(b, s, heads * hd)


def _check(qkv, cos2, s2, bias, heads: int) -> int:
    """Validate shapes, dtypes, devices and contiguity; return hd."""
    if qkv.dim() != 3 or heads <= 0 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"bad qkv shape {tuple(qkv.shape)} for {heads} heads")
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    if s % 8:
        raise ValueError(f"sequence length {s} must be a multiple of 8")
    if hd % 2:
        raise ValueError(f"head dim {hd} must be even (rotate-halves)")
    if tuple(cos2.shape) != (s, hd) or tuple(s2.shape) != (s, hd):
        raise ValueError(f"rotary tables must be [{s}, {hd}], got "
                         f"{tuple(cos2.shape)} and {tuple(s2.shape)}")
    if tuple(bias.shape) != (b, s):
        raise ValueError(f"bias must be [{b}, {s}], got {tuple(bias.shape)}")
    if not (cos2.dtype == s2.dtype == bias.dtype == torch.float32):
        raise TypeError("cos2, s2 and bias must be float32")
    devices = {t.device for t in (qkv, cos2, s2, bias)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")
    return hd


def _check_kernel(name: str, hd: int, heads: int, *tensors) -> None:
    """What the CUDA kernels take beyond :func:`_check`: bf16 qkv (and g),
    their head widths, S up to :data:`KERNEL_MAX_SEQ`, contiguous operands
    and a grid that fits."""
    qkv = tensors[0]
    b, s, _ = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bfloat16 qkv, got "
                        f"{qkv.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if s > KERNEL_MAX_SEQ:
        raise ValueError(f"the {name} kernel takes sequences up to "
                         f"{KERNEL_MAX_SEQ}, got {s}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("qkv, cos2, s2, bias (and g) must be contiguous")
    if b * heads * (-(-s // 32)) >= 2**31:
        raise ValueError(f"grid of {b} x {heads} heads x {s} rows too large")


def _fused_attention_qkv_fwd(qkv: torch.Tensor, cos2: torch.Tensor,
                             s2: torch.Tensor, bias: torch.Tensor, heads: int,
                             scale: float) -> torch.Tensor:
    """The K8 wrapper: the plain version for CPU tensors, the kernel for
    CUDA tensors (or an exception)."""
    hd = _check(qkv, cos2, s2, bias, heads)
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, cos2, s2, bias, heads, scale)
    _check_kernel("K8", hd, heads, qkv, cos2, s2, bias)
    b, s, _ = qkv.shape
    out = torch.empty((b, s, heads * hd), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    from ._build import library

    lib = library("attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.lib.bsr_fused_attention_qkv(
            qkv.data_ptr(), cos2.data_ptr(), s2.data_ptr(), bias.data_ptr(),
            b, s, heads, hd, float(scale), out.data_ptr(), stream)
    lib.check("fused_attention_qkv", err)
    launch_counts["fused_attention_qkv"] += 1
    return out


def fused_attention_qkv_bwd_plain(qkv: torch.Tensor, cos2: torch.Tensor,
                                  s2: torch.Tensor, bias: torch.Tensor,
                                  g: torch.Tensor, heads: int,
                                  scale: float) -> torch.Tensor:
    """Plain K9: the gradient of :func:`fused_attention_qkv` with respect to
    qkv, through ``[B, H, S, S]`` f32, rounding where the TPU kernel rounds
    (``attention_pallas.py:214-281``): the softmax recomputed from the
    rotated q and k (each rounded once to qkv's dtype), ``p = e / sum(e)``
    normalized before the products, ``dv = round(p)^T g``, ``dp = g v^T``,
    ``row = sum(dp * p)``, ``ds = round(p * (dp - row) * scale)``,
    ``dq_r = ds k_r`` and ``dk_r = ds^T q_r`` in f32, then the rotary adjoint
    ``x*cos2 + roll(x*s2, hd/2)`` and one rounding. ``g`` (the context's
    gradient, ``[B, S, H*hd]``) is cast to qkv's dtype first, as JAX does
    (:350). Returns ``dqkv`` in qkv's layout and dtype."""
    b, s, width = qkv.shape
    hd = width // (3 * heads)
    dt = qkv.dtype
    x = qkv.view(b, s, 3, heads, hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, hd]
    gf = g.to(dt).view(b, s, heads, hd).permute(0, 2, 1, 3).to(torch.float32)

    def rot(t):
        tf = t.to(torch.float32)
        return (tf * cos2 + torch.roll(tf, hd // 2, dims=-1) * s2).to(dt)

    def rot_adjoint(t):
        return t * cos2 + torch.roll(t * s2, hd // 2, dims=-1)

    qr = rot(x[0]).to(torch.float32)
    kr = rot(x[1]).to(torch.float32)
    v = x[2].to(torch.float32)
    logits = torch.matmul(qr, kr.transpose(-1, -2)) * scale + bias[:, None, None, :]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(dt).to(torch.float32).transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.transpose(-1, -2))
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - row) * scale).to(dt).to(torch.float32)
    dq = rot_adjoint(torch.matmul(ds, kr))
    dk = rot_adjoint(torch.matmul(ds.transpose(-1, -2), qr))
    dqkv = torch.stack([dq, dk, dv]).to(dt)                  # [3, B, H, S, hd]
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, width)


def fused_attention_qkv_bwd(qkv: torch.Tensor, cos2: torch.Tensor,
                            s2: torch.Tensor, bias: torch.Tensor,
                            g: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """K9. The recompute backward of :func:`fused_attention_qkv`: the
    forward's own inputs plus ``g [B, S, H*hd]`` in qkv's dtype (the
    context's gradient) -> ``dqkv [B, S, 3*H*hd]`` in the Wqkv layout.

    Replaces ``attention_pallas._fused_qkv_bwd`` (:290). On the card: the
    same limits as K8, and ``g`` bf16 and contiguous."""
    hd = _check(qkv, cos2, s2, bias, heads)
    b, s, _ = qkv.shape
    if tuple(g.shape) != (b, s, heads * hd):
        raise ValueError(f"g must be [{b}, {s}, {heads * hd}], got "
                         f"{tuple(g.shape)}")
    if g.dtype != qkv.dtype:
        raise TypeError(f"g must have qkv's dtype {qkv.dtype}, got {g.dtype}")
    if g.device != qkv.device:
        raise ValueError(f"g on {g.device}, qkv on {qkv.device}")
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, cos2, s2, bias, g, heads,
                                             scale)
    _check_kernel("K9", hd, heads, qkv, cos2, s2, bias, g)
    dqkv = torch.empty_like(qkv)
    # per-row softmax max, sum and sum(dp * p), pass 1 to pass 2
    stats = torch.empty((3, b, heads, s), dtype=torch.float32,
                        device=qkv.device)
    if b == 0:
        return dqkv
    from ._build import library

    lib = library("attention")
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.lib.bsr_fused_attention_qkv_bwd(
            qkv.data_ptr(), cos2.data_ptr(), s2.data_ptr(), bias.data_ptr(),
            g.data_ptr(), b, s, heads, hd, float(scale), stats.data_ptr(),
            dqkv.data_ptr(), stream)
    lib.check("fused_attention_qkv_bwd", err)
    launch_counts["fused_attention_qkv_bwd"] += 1
    return dqkv


class FusedAttentionQKV(torch.autograd.Function):
    """K8 forward, K9 backward: the counterpart of
    ``fused_attention_qkv_diff`` (``attention_pallas.py:358-370``). Saves the
    forward's inputs only; the softmax is recomputed. The rotary tables, the
    key-padding bias, ``heads`` and ``scale`` get no gradient."""

    @staticmethod
    def forward(ctx, qkv, cos2, s2, bias, heads, scale):
        ctx.save_for_backward(qkv, cos2, s2, bias)
        ctx.heads, ctx.scale = heads, scale
        return _fused_attention_qkv_fwd(qkv, cos2, s2, bias, heads, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, cos2, s2, bias = ctx.saved_tensors
        g = g.to(qkv.dtype).contiguous()
        dqkv = fused_attention_qkv_bwd(qkv, cos2, s2, bias, g, ctx.heads,
                                       ctx.scale)
        return dqkv, None, None, None, None, None


def fused_attention_qkv(qkv: torch.Tensor, cos2: torch.Tensor,
                        s2: torch.Tensor, bias: torch.Tensor, heads: int,
                        scale: float) -> torch.Tensor:
    """K8. Rotary + softmax attention straight off the Wqkv projection:
    ``qkv [B, S, 3*H*hd]`` (q, k, v of head h at lanes ``(c*H + h)*hd``),
    rotary tables ``cos2, s2 [S, hd]`` f32 (:func:`rotary_roll_tables`),
    additive key-padding ``bias [B, S]`` f32 -> context ``[B, S, H*hd]`` in
    qkv's dtype, ready for ``out_proj``. Differentiable in qkv, with K9
    (:func:`fused_attention_qkv_bwd`) as the backward.

    Replaces ``attention_pallas.fused_attention_qkv`` (:177) and
    ``fused_attention_qkv_diff`` (:358). On the card: bf16 qkv, hd in
    :data:`KERNEL_HEAD_DIMS`, S a multiple of 8 up to
    :data:`KERNEL_MAX_SEQ`, every operand contiguous."""
    return FusedAttentionQKV.apply(qkv, cos2, s2, bias, heads, scale)
