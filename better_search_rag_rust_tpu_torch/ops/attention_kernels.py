"""Fused rotary + attention of the encoder: wrapper and plain version.

Counterpart of ``better_search_rag_rust_tpu/ops/attention_pallas.py``. The
Pallas kernel on the encoder's path, K8 ``fused_attention_qkv`` (:177), has a
hand-written CUDA kernel (``csrc/attention_kernels.cu``) and, here, a wrapper
and a plain PyTorch version of the same function. The wrapper takes the plain
version only because its tensors lie on the CPU (that is how the CPU tests
run the encoder); for CUDA tensors it launches the kernel or raises — there
is no fallback. Each kernel launch adds one to :data:`launch_counts`.

The kernel and its plain version sum in different orders (the plain version
goes through [B, H, S, S] f32 logits and two f32 matrix products), so on the
card they agree to a tolerance, not bit for bit: the JAX package's own bound
for its kernel against the einsum chain is max |diff| < 0.02 with cosine >
0.999 on valid query rows (``tests/test_models.py:369-373``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = {"fused_attention_qkv": 0}

#: Head widths the CUDA kernel is instantiated for (its register tiles).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: Longest sequence whose [32, S] f32 logits tile fits in shared memory
#: (``MAX_S`` in the CUDA source).
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


def fused_attention_qkv(qkv: torch.Tensor, cos2: torch.Tensor,
                        s2: torch.Tensor, bias: torch.Tensor, heads: int,
                        scale: float) -> torch.Tensor:
    """K8. Rotary + softmax attention straight off the Wqkv projection:
    ``qkv [B, S, 3*H*hd]`` (q, k, v of head h at lanes ``(c*H + h)*hd``),
    rotary tables ``cos2, s2 [S, hd]`` f32 (:func:`rotary_roll_tables`),
    additive key-padding ``bias [B, S]`` f32 -> context ``[B, S, H*hd]`` in
    qkv's dtype, ready for ``out_proj``.

    Replaces ``attention_pallas.fused_attention_qkv`` (:177). On the card:
    bf16 qkv, hd in :data:`KERNEL_HEAD_DIMS`, S a multiple of 8 up to
    :data:`KERNEL_MAX_SEQ`, every operand contiguous."""
    hd = _check(qkv, cos2, s2, bias, heads)
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, cos2, s2, bias, heads, scale)
    b, s, _ = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the K8 kernel takes bfloat16 qkv, got {qkv.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the K8 kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {hd}")
    if s > KERNEL_MAX_SEQ:
        raise ValueError(f"the K8 kernel takes sequences up to "
                         f"{KERNEL_MAX_SEQ}, got {s}")
    if not all(t.is_contiguous() for t in (qkv, cos2, s2, bias)):
        raise ValueError("qkv, cos2, s2 and bias must be contiguous")
    if b * heads * (-(-s // 32)) >= 2**31:
        raise ValueError(f"grid of {b} x {heads} heads x {s} rows too large")
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
