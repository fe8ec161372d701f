"""The encoder layer's elementwise glue: wrappers and plain versions.

The JAX package's encoder layer (``better_search_rag_rust_tpu/models/
nomic.py``) is one jitted program in which XLA fuses the residual add, the
f32 LayerNorm and the rounding (``:392-396``, ``:399-403``, ``:430-432``)
and the MLP gate ``y * silu(gate)`` (``:354-359``; ``gelu(y)`` with
``activation="gelu"``) into a few passes over memory. No Pallas kernel does
this; here hand-written CUDA kernels do (``csrc/encoder_kernels.cu``), one
pass each, forward and backward, with a wrapper and a plain PyTorch version
each:

* K18 :func:`add_layer_norm`: ``round_dt(LN(round_dt(x + r)))``, flax's
  LayerNorm (``use_fast_variance``: ``var = max(0, E[s^2] - E[s]^2)``, its
  ``_normalize`` order) on rows ``[N, D]``;
* K18b :func:`add_layer_norm_bwd`: its gradient ``ds`` (for both ``x`` and
  ``r``), ``dgamma`` and ``dbeta``, summed in a fixed order;
* K19 :func:`swiglu`: ``round_dt(a * round_dt(silu(g)))``, or
  ``round_dt(gelu(g))``, torch's CUDA formulas;
* K19b :func:`swiglu_bwd`: torch autograd's gradients of the same.

A wrapper takes its plain version only because its tensors lie on the CPU
(that is how the CPU tests run the encoder and the trainer); for CUDA
tensors it launches the kernel or raises — there is no fallback. Each
kernel launch adds one to :data:`launch_counts`. :class:`AddLayerNorm` and
:class:`SwiGlu` are the ``torch.autograd.Function`` s the model calls.

The plain versions compute in the kernels' order (the source header's
THE LANE ORDER, the block partials of ``dgamma``/``dbeta``), every scalar a
tensor on the operands' device (torch divides by a CPU scalar on the card
by multiplying with its reciprocal), the square root correctly rounded (the
f64 root rounded to f32). So on the card the kernels equal them bit for
bit; on finite rows the CPU's plain K18 gives the card's bits too (the
card tests hold it), while K19's ``expf`` and ``erff`` are the CPU's own.
Float64 runs the same plain arithmetic in float64
(``torch.autograd.gradcheck``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = {"add_layer_norm": 0,
                                 "add_layer_norm_bwd": 0,
                                 "swiglu": 0,
                                 "swiglu_bwd": 0}

#: THE LANE ORDER (``csrc/encoder_kernels.cu``): lane ``l`` of 32 holds the
#: features ``LANE_CHUNK * c + LANE_WIDTH * l + j``.
LANES, LANE_CHUNK, LANE_WIDTH = 32, 256, 8
#: Widest row the K18 kernels hold in registers (``LN_MAX_CHUNKS`` chunks).
KERNEL_MAX_DIM = 1024
#: K18b's blocks of ``WARPS`` warps (:func:`k18b_blocks`).
K18B_MAX_BLOCKS, WARPS = 264, 8
ACTIVATIONS = ("swiglu", "gelu")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"swiglu": 0, "gelu": 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def k18b_blocks(rows: int) -> int:
    """K18b's grid: ``min(ceil(rows / 8), 264)`` blocks of 8 warps; the
    order of its ``dgamma``/``dbeta`` sums follows from it."""
    return max(1, min(-(-rows // WARPS), K18B_MAX_BLOCKS))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def lane_sums(v: torch.Tensor) -> torch.Tensor:
    """``[N]`` sums of the rows of ``v [N, D]`` in THE LANE ORDER: lane
    ``l`` adds its features ``256 c + 8 l + j`` (``c`` ascending, then ``j =
    0..7``) from +0.0, one rounded add each; then the lane sums halve,
    ``v[i] += v[i + h]`` for ``h = 16, 8, 4, 2, 1``. Features past ``D``
    are the kernel's +0.0 pad, which leaves a sum as it is, so they are
    skipped."""
    acc = torch.zeros((v.shape[0], LANES), dtype=v.dtype, device=v.device)
    for c0 in range(0, v.shape[1], LANE_CHUNK):
        for j in range(LANE_WIDTH):
            # lane l's feature j
            col = v[:, c0 + j:c0 + LANE_CHUNK:LANE_WIDTH]
            acc[:, :col.shape[1]] += col
    h = LANES // 2
    while h:
        acc[:, :h] += acc[:, h:2 * h]
        h //= 2
    return acc[:, 0]


def _row_stats(x, r, eps):
    """K18's ``s = round_dt(x + r)`` in the accumulation dtype and its
    ``mean``, ``rstd`` and ``vfac`` (``d var / d v`` of flax's ``max(0,
    v)``: 1 where ``v > 0``, 1/2 at a tie, 0 where clipped or NaN), each
    ``[N, 1]``."""
    s = (x + r).to(_acc_dtype(x))
    d = _scalar(float(s.shape[1]), s)
    mean = lane_sums(s) / d
    v = lane_sums(s * s) / d - mean * mean
    zero = _scalar(0.0, s)
    var = torch.where(v < zero, zero, v)
    # the correctly rounded root: the f64 root rounded to f32 (torch's f32
    # sqrt on the CPU is not correctly rounded); then a correctly rounded 1/x
    root = torch.sqrt((var + _scalar(eps, s)).double()).to(s.dtype)
    rstd = _scalar(1.0, s) / root
    vfac = torch.where(v > zero, _scalar(1.0, s),
                       torch.where(v == zero, _scalar(0.5, s), zero))
    return s, mean[:, None], rstd[:, None], vfac[:, None]


def add_layer_norm_plain(x, r, gamma, beta, eps: float):
    """Plain K18 on ``[N, D]``: ``s = round_dt(x + r)``; ``mean = sum(s) /
    D``, ``v = sum(s * s) / D - mean * mean`` (sums in THE LANE ORDER),
    ``var = v < 0 ? 0 : v``, ``rstd = 1 / sqrt(var + eps)``; ``y =
    round_dt((s - mean) * (rstd * gamma) + beta)`` in x's dtype."""
    s, mean, rstd, _ = _row_stats(x, r, eps)
    dt = s.dtype
    y = (s - mean) * (rstd * gamma.to(dt)) + beta.to(dt)
    return y.to(x.dtype)


def column_sums(t: torch.Tensor) -> torch.Tensor:
    """``[D]`` sums over the rows of ``t [N, D]`` in K18b's order: with G =
    :func:`k18b_blocks` and W = 8 G warps, warp ``w`` adds rows ``w, w + W,
    ...`` in order from +0.0; block ``b``'s partial is its warp 0's sums plus
    warp 1's, ... plus warp 7's; the total is +0.0 plus the partials, ``b``
    ascending. Rows past N are the +0.0 the kernel never adds."""
    n, d = t.shape
    blocks = k18b_blocks(n)
    w = WARPS * blocks
    steps = -(-n // w)
    padded = torch.zeros((steps * w, d), dtype=t.dtype, device=t.device)
    padded[:n] = t
    acc = torch.zeros((w, d), dtype=t.dtype, device=t.device)
    for i in range(steps):
        acc += padded[i * w:(i + 1) * w]
    acc = acc.view(blocks, WARPS, d)
    part = acc[:, 0].clone()
    for k in range(1, WARPS):
        part += acc[:, k]
    total = torch.zeros(d, dtype=t.dtype, device=t.device)
    for b in range(blocks):
        total += part[b]
    return total


def add_layer_norm_bwd_plain(dy, x, r, gamma, eps: float):
    """Plain K18b on ``[N, D]``: ``(ds, dgamma, dbeta)``, ``ds`` in dy's
    dtype (the gradient of both ``x`` and ``r``), the others in the
    accumulation dtype. With ``g = dy * gamma`` and ``xh = (s - mean) *
    rstd``: ``ds = round_dt(rstd * ((g - mg) - xh * mgx))``, ``mg = sum(g)
    / D``, ``mgx = (sum(g * xh) / D) * vfac`` (sums in THE LANE ORDER);
    ``dgamma = sum(dy * xh)``, ``dbeta = sum(dy)`` over rows
    (:func:`column_sums`)."""
    s, mean, rstd, vfac = _row_stats(x, r, eps)
    dt = s.dtype
    d = _scalar(float(s.shape[1]), s)
    dyf = dy.to(dt)
    xh = (s - mean) * rstd
    g = dyf * gamma.to(dt)
    mg = (lane_sums(g) / d)[:, None]
    mgx = (lane_sums(g * xh) / d)[:, None] * vfac
    ds = rstd * ((g - mg) - xh * mgx)
    return ds.to(dy.dtype), column_sums(dyf * xh), column_sums(dyf)


def swiglu_plain(a, g, activation: str = "swiglu"):
    """Plain K19: ``a * F.silu(g)`` (``round_dt`` after each, torch's
    rounding points) or, with ``activation="gelu"``, ``F.gelu(g)`` exact
    (``a`` unused)."""
    if activation == "gelu":
        return F.gelu(g, approximate="none")
    return a * F.silu(g)


def swiglu_bwd_plain(dy, a, g, activation: str = "swiglu"):
    """Plain K19b, torch autograd's ops for :func:`swiglu_plain`: ``(da,
    dg)`` = ``(dy * silu(g), silu_backward(dy * a, g))``; gelu ``(None,
    gelu_backward(dy, g))``."""
    if activation == "gelu":
        return None, torch.ops.aten.gelu_backward(dy, g, approximate="none")
    return dy * F.silu(g), torch.ops.aten.silu_backward(dy * a, g)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _launch(name: str, fn_name: str, like: torch.Tensor, *args) -> None:
    """Call a C entry point on ``like``'s device and current stream; raise
    on its returned CUDA error; count the launch."""
    from ._build import library

    lib = library("encoder")
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(lib.lib, fn_name)(*args, stream)
    lib.check(name, err)
    launch_counts[name] += 1


def _check_rows(name: str, gamma: torch.Tensor, *rows: torch.Tensor) -> None:
    """Rows ``[N, D]`` of one shape and one float dtype and ``gamma`` (and
    beta) ``[D]`` on one device."""
    x = rows[0]
    if x.dim() != 2:
        raise ValueError(f"{name} takes rows [N, D], got {tuple(x.shape)}")
    for t in rows[1:]:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands of one shape and dtype, got "
                             f"{tuple(x.shape)} {x.dtype} and "
                             f"{tuple(t.shape)} {t.dtype}")
    if tuple(gamma.shape) != (x.shape[1],):
        raise ValueError(f"{name}: gamma/beta must be [{x.shape[1]}], got "
                         f"{tuple(gamma.shape)}")
    if not x.dtype.is_floating_point:
        raise ValueError(f"{name} takes floating rows, got {x.dtype}")
    _check_device(name, *rows, gamma)


def _check_device(name: str, *tensors: torch.Tensor) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices: "
                         f"{sorted(map(str, devices))}")
    if tensors[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")


def _check_kernel_dtype(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the {name} kernel takes bfloat16 or float32, got "
                         f"{x.dtype}")


def _check_norm_kernel(name: str, x: torch.Tensor, *params: torch.Tensor):
    _check_kernel_dtype(name, x)
    if x.shape[1] > KERNEL_MAX_DIM:
        raise ValueError(f"the {name} kernel takes rows up to "
                         f"{KERNEL_MAX_DIM} features, got {x.shape[1]}")
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError(f"the {name} kernel takes float32 gamma/beta")


def add_layer_norm(x, r, gamma, beta, eps: float):
    """K18. Rows ``x, r [N, D]`` (bf16 or f32 on the card, D <= 1,024) and
    ``gamma, beta [D]`` f32 -> ``round_dt(LN(round_dt(x + r)))`` in x's
    dtype (:func:`add_layer_norm_plain`'s arithmetic)."""
    _check_rows("add_layer_norm", gamma, x, r)
    _check_device("add_layer_norm", x, beta)
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, r, gamma, beta, eps)
    _check_norm_kernel("K18", x, gamma, beta)
    x, r = x.contiguous(), r.contiguous()
    gamma, beta = gamma.contiguous(), beta.contiguous()
    y = torch.empty_like(x)
    if x.shape[0]:
        _launch("add_layer_norm", "bsr_add_layer_norm", x, x.data_ptr(),
                r.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                x.shape[0], x.shape[1], float(eps), _DTYPE_CODES[x.dtype])
    return y


def add_layer_norm_bwd(dy, x, r, gamma, eps: float):
    """K18b. ``dy, x, r [N, D]`` (one dtype) and ``gamma [D]`` ->
    ``(ds, dgamma, dbeta)`` (:func:`add_layer_norm_bwd_plain`'s
    arithmetic and order; ``ds`` in dy's dtype, the others f32)."""
    _check_rows("add_layer_norm_bwd", gamma, dy, x, r)
    if x.device.type == "cpu":
        return add_layer_norm_bwd_plain(dy, x, r, gamma, eps)
    _check_norm_kernel("K18b", x, gamma)
    dy, x, r, gamma = (t.contiguous() for t in (dy, x, r, gamma))
    n, d = x.shape
    ds = torch.empty_like(x)
    dgamma = torch.zeros(d, dtype=torch.float32, device=x.device)
    dbeta = torch.zeros(d, dtype=torch.float32, device=x.device)
    if n:
        blocks = k18b_blocks(n)
        partial = torch.empty((blocks, 2, d), dtype=torch.float32,
                              device=x.device)
        _launch("add_layer_norm_bwd", "bsr_add_layer_norm_bwd", x,
                dy.data_ptr(), x.data_ptr(), r.data_ptr(), gamma.data_ptr(),
                ds.data_ptr(), partial.data_ptr(), dgamma.data_ptr(),
                dbeta.data_ptr(), n, d, float(eps), blocks,
                _DTYPE_CODES[x.dtype])
    return ds, dgamma, dbeta


def _check_gate(name: str, a: Optional[torch.Tensor], g: torch.Tensor,
                activation: str, *more: torch.Tensor) -> Tuple:
    if activation not in ACTIVATIONS:
        raise ValueError(f"{name}: activation must be one of {ACTIVATIONS}, "
                         f"got {activation!r}")
    if activation == "gelu":
        a = None
    elif a is None:
        raise ValueError(f"{name}: swiglu needs both halves, a and g")
    for t in (a, *more):
        if t is not None and (t.shape != g.shape or t.dtype != g.dtype):
            raise ValueError(f"{name}: operands of one shape and dtype, got "
                             f"{tuple(g.shape)} {g.dtype} and "
                             f"{tuple(t.shape)} {t.dtype}")
    if not g.dtype.is_floating_point:
        raise ValueError(f"{name} takes floating operands, got {g.dtype}")
    _check_device(name, *(t for t in (a, g, *more) if t is not None))
    return a


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def swiglu(a, g, activation: str = "swiglu"):
    """K19. The MLP gate over any shape: ``round_dt(a * round_dt(silu(g)))``
    or, ``activation="gelu"``, ``round_dt(gelu(g))`` (``a`` unused), in g's
    dtype (bf16 or f32 on the card); :func:`swiglu_plain` bit for bit."""
    a = _check_gate("swiglu", a, g, activation)
    if g.device.type == "cpu":
        return swiglu_plain(a, g, activation)
    _check_kernel_dtype("K19", g)
    a = None if a is None else a.contiguous()
    g = g.contiguous()
    y = torch.empty_like(g)
    if g.numel():
        _launch("swiglu", "bsr_swiglu", g, _ptr(a), g.data_ptr(), y.data_ptr(),
                g.numel(), _DTYPE_CODES[g.dtype], _ACT_CODES[activation])
    return y


def swiglu_bwd(dy, a, g, activation: str = "swiglu"):
    """K19b. ``(da, dg)`` for :func:`swiglu` (``da`` None for gelu):
    :func:`swiglu_bwd_plain` bit for bit."""
    a = _check_gate("swiglu_bwd", a, g, activation, dy)
    if g.device.type == "cpu":
        return swiglu_bwd_plain(dy, a, g, activation)
    _check_kernel_dtype("K19b", g)
    dy, g = dy.contiguous(), g.contiguous()
    a = None if a is None else a.contiguous()
    da = None if a is None else torch.empty_like(g)
    dg = torch.empty_like(g)
    if g.numel():
        _launch("swiglu_bwd", "bsr_swiglu_bwd", g, dy.data_ptr(), _ptr(a),
                g.data_ptr(), _ptr(da), dg.data_ptr(), g.numel(),
                _DTYPE_CODES[g.dtype], _ACT_CODES[activation])
    return da, dg


class AddLayerNorm(torch.autograd.Function):
    """``round_dt(LN(round_dt(x + r)))`` over the last dim of ``x, r [...,
    D]``: K18 forward, K18b backward (``ds`` to both ``x`` and ``r``). Saves
    x and r, not the statistics: K18b recomputes them in K18's order."""

    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps: float):
        ctx.save_for_backward(x, r, gamma)
        ctx.eps = eps
        d = x.shape[-1]
        return add_layer_norm(x.reshape(-1, d), r.reshape(-1, d), gamma, beta,
                              eps).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, r, gamma = ctx.saved_tensors
        d = x.shape[-1]
        ds, dgamma, dbeta = add_layer_norm_bwd(
            dy.reshape(-1, d), x.reshape(-1, d), r.reshape(-1, d), gamma,
            ctx.eps)
        ds = ds.view(x.shape)
        return ds, ds, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


class SwiGlu(torch.autograd.Function):
    """The MLP gate, ``a * silu(g)`` (``activation="gelu"``: ``gelu(g)``,
    ``a`` None): K19 forward, K19b backward. Saves a and g; the backward
    recomputes ``silu(g)``."""

    @staticmethod
    def forward(ctx, a, g, activation: str = "swiglu"):
        ctx.save_for_backward(a, g)
        ctx.activation = activation
        return swiglu(a, g, activation)

    @staticmethod
    def backward(ctx, dy):
        a, g = ctx.saved_tensors
        da, dg = swiglu_bwd(dy, a, g, ctx.activation)
        return da, dg, None
