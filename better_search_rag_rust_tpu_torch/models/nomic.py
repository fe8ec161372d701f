"""NomicBERT (``nomic-embed-text-v1.5``) as PyTorch modules.

Counterpart of ``better_search_rag_rust_tpu/models/nomic.py``. The modules
keep HF's layout and names (``embeddings.word_embeddings``, ``emb_ln``,
``encoder.layers.{i}.attn.Wqkv`` / ``out_proj``, ``mlp.fc11`` / ``fc12`` /
``fc2``, ``norm1`` / ``norm2``), so an HF state dict loads with no transposes
(:func:`convert_hf_state`); :func:`params_from_flax` carries the JAX
package's parameter tree across. Numerics follow the reference: Linear and
Embedding products in the compute dtype ``dtype`` (bf16 by default), every
LayerNorm, the softmax, the pooling and the final normalization in f32.
Linear and Embedding weights are held in ``param_dtype`` and cast to
``dtype`` in the forward, as Flax's ``nn.Dense(dtype=...)`` does with its f32
``param_dtype``: the trainer holds them in f32, the serving encoder in the
compute dtype (the same rounding, done once at load). Each residual add
with its LayerNorm runs on K18 (K18b backward) and the MLP gate on K19
(K19b backward), one pass each (:mod:`..ops.encoder_kernels`): flax's
LayerNorm formula, torch's silu and gelu.

Attention implementations (:func:`_resolve_attention_impl`): ``fused`` runs
the hand-written K8 kernel (:mod:`..ops.attention_kernels`), differentiable
with the hand-written K9 kernel as its backward, ``xla`` the
plain f32-logit chain, ``xla_bf16`` the plain bf16-logit chain; ``auto`` is
``fused``, which falls to ``xla_bf16`` for a sequence length or head width
not divisible by 8. ``flash`` (the reference's library Pallas flash kernel,
for contexts past K8's 1,024 tokens) runs the hand-written K14 forward and
K15 + K16 backward (:mod:`..ops.flash_kernels`) on rotated ``[B, H, S, hd]``
q, k and v, the key padding as segment ids: pad tokens form their own
segment, so a real query never sees a pad key and a pad query attends only
among pads. Like the library, it takes ``max_tokens`` a multiple of 128; the
model makes the kernels' tile plan from the segment ids once a forward and
hands it to every layer. On the card K8 and K9 take sequences up to
``KERNEL_MAX_SEQ`` (1,024) tokens, so an encoder or trainer built there
with ``max_tokens`` above it and an attention that resolves to ``fused``
raises at construction (:func:`refuse_fused_past_kernel`), naming
``flash``; the resolution itself stays the JAX package's. The
encoder meta records the port's names (``torch-fused``, ``torch-flash``,
...), so a store mixing the two packages warns at query time.

Tensor parallelism (:class:`TensorParallel`, one rank of a mesh's model
axis; the JAX package's ``param_specs`` and its head-sharded ``shard_map``
of the fused kernel): ``Wqkv`` and the MLP's input products are split by
output features (``Wqkv`` by heads, so each rank's ``qkv`` is K8's layout
for its ``H/tp`` heads), ``out_proj`` and ``fc2`` by input features, their
partial products reduced over the model group in f32 and rounded once
after the bias, which is added once. Attention whose heads do not split
(:func:`mesh_attention_impl`) runs whole on every rank and only the MLP
is split. With sequence parallelism the embeddings, residual adds and
LayerNorms run on the rank's ``S/tp`` rows of the sequence, gathered
before each split product and reduce-scattered after it
(:mod:`..parallel.collectives`).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig, torch_dtype
from ..ops.attention_kernels import (
    KERNEL_MAX_SEQ,
    fused_attention_qkv,
    rotary_roll_tables,
)
from ..ops.encoder_kernels import AddLayerNorm, SwiGlu
from ..ops.flash_kernels import SegmentIds, flash_attention, segment_tile_plan
from ..parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from ..parallel.collectives import (
    copy_to_group,
    gather_for_product,
    gather_rows,
    own_rows,
    reduce_from_group,
    reduce_scatter_to_rows,
)
from ..utils.device import resolve_device


@dataclass(frozen=True)
class NomicBertConfig:
    """Architecture hyperparameters (defaults = nomic-embed-text-v1.5)."""

    vocab_size: int = 30528
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_tokens: int = 512
    type_vocab_size: int = 2
    rotary_base: float = 1000.0
    layer_norm_eps: float = 1e-12
    activation: str = "swiglu"  # "swiglu" | "gelu"
    qkv_bias: bool = False
    mlp_bias: bool = False
    dtype: torch.dtype = torch.bfloat16
    #: "auto" | "fused" | "xla" | "xla_bf16" | "flash" (see
    #: _resolve_attention_impl)
    attention_impl: str = "auto"
    #: dtype of the Linear and Embedding weights; None: ``dtype``
    param_dtype: Optional[torch.dtype] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @staticmethod
    def from_encoder_config(cfg: EncoderConfig) -> "NomicBertConfig":
        if cfg.dim % cfg.num_heads:
            raise ValueError(
                f"hidden dim {cfg.dim} is not divisible by num_heads "
                f"{cfg.num_heads}; pass a matching --dim/num_heads pair")
        return NomicBertConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            mlp_dim=cfg.mlp_dim, max_tokens=cfg.max_tokens,
            type_vocab_size=cfg.type_vocab_size, rotary_base=cfg.rotary_base,
            layer_norm_eps=cfg.layer_norm_eps, activation=cfg.activation,
            dtype=torch_dtype(cfg.dtype), attention_impl=cfg.attention_impl,
        )


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rotary_tables(seq_len: int, head_dim: int, base: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(cos [S, hd/2], sin [S, hd/2])`` f32, computed in f64 on the host —
    the reference's tables bit for bit."""
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64)
                               / head_dim))
    freqs = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """NeoX-style (rotate-halves) rotary on ``[B, S, H, hd]`` in x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _resolve_attention_impl(impl: str, seq_len: Optional[int] = None,
                            head_dim: Optional[int] = None) -> str:
    """The attention implementation that actually runs: ``auto`` ->
    ``fused`` (K8); ``fused`` -> ``xla_bf16`` when seq_len or head_dim is
    not divisible by 8 (the reference's rule, recorded in the encoder meta);
    ``xla``, ``xla_bf16`` and ``flash`` (K14-K16) as asked."""
    if impl == "auto":
        impl = "fused"
    if impl not in ("fused", "xla", "xla_bf16", "flash"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    if impl == "fused" and ((seq_len is not None and seq_len % 8)
                            or (head_dim is not None and head_dim % 8)):
        return "xla_bf16"
    return impl


def refuse_fused_past_kernel(impl: str, max_tokens: int, head_dim: int,
                             device_type: str) -> None:
    """On the card, ``fused`` runs K8 (and K9 in training), which take
    sequences up to :data:`KERNEL_MAX_SEQ` tokens: an encoder or trainer
    whose ``max_tokens`` is above it and whose attention resolves to
    ``fused`` (``auto`` included) would fail at its first long batch, so it
    raises when it is built. Elsewhere, and for any other attention,
    nothing changes."""
    if (device_type == "cuda" and max_tokens > KERNEL_MAX_SEQ
            and _resolve_attention_impl(impl, max_tokens, head_dim) == "fused"):
        raise ValueError(
            f"attention_impl={impl!r} runs the fused K8/K9 kernels, which on "
            f"the card take sequences up to {KERNEL_MAX_SEQ} tokens, and "
            f"max_tokens is {max_tokens}: use attention_impl='flash' (its "
            f"max_tokens a multiple of 128) for longer contexts")


def mesh_attention_impl(impl: str, config: "NomicBertConfig", data: int,
                        model: int) -> str:
    """The attention a ``(data, model)`` mesh runs, by the JAX trainer's
    rule (its ``models/train.py:139-190``): on a mesh of several shards
    ``auto``/``fused`` is ``fused``, and with ``model`` above 1 only where
    the heads split over it and the kernel's tiles hold (``H % model``,
    ``hd % 8`` and ``max_tokens % 8`` all 0), else ``xla_bf16``; any
    other impl, and one shard, as asked. The heads split over the model
    axis exactly when this is ``fused``. ``flash`` on several shards
    raises, as the JAX trainer's step does: its library kernel is a bare
    ``pallas_call``, which the mesh's partitioner does not split."""
    refuse_flash_on_mesh(impl, data * model)
    if impl not in ("auto", "fused") or data * model == 1:
        return impl
    if model == 1 or (config.num_heads % model == 0
                      and config.head_dim % 8 == 0
                      and config.max_tokens % 8 == 0):
        return "fused"
    return "xla_bf16"


def refuse_flash_on_mesh(impl: str, shards: int) -> None:
    """``flash`` runs on one device: the JAX trainer and encoder fail on a
    mesh of several (the partitioner cannot split the library's
    ``pallas_call``; on the CPU its first step raises), and the port adds
    no mesh feature the JAX package lacks."""
    if impl == "flash" and shards > 1:
        raise NotImplementedError(
            f"attention_impl='flash' runs on one device, not on a mesh of "
            f"{shards} shards (the JAX package's flash step does not "
            f"partition either); use 'fused' or 'xla_bf16' on a mesh")


def tensor_parallel(mesh, config: "NomicBertConfig", heads: bool,
                    sequence: bool) -> Optional["TensorParallel"]:
    """This rank's :class:`TensorParallel` on ``mesh``'s model axis (one
    shard a rank), ``None`` where that axis has one shard. ``heads`` splits
    the attention heads too; ``sequence`` asks for sequence parallelism,
    which needs ``max_tokens`` to split as well (the JAX trainer's
    condition)."""
    size = axis_size(mesh, MODEL_AXIS)
    if size == 1:
        return None
    return TensorParallel(axis_group(mesh, MODEL_AXIS), size,
                          axis_index(mesh, MODEL_AXIS), heads=heads,
                          sequence=sequence and config.max_tokens % size == 0)


@dataclass(frozen=True)
class TensorParallel:
    """This rank's place on a mesh's model axis: the axis's process group,
    its size and the rank's index on it; whether the attention heads split
    over it (else attention runs whole on every rank) and whether the
    sequence does (sequence parallelism)."""

    group: object
    size: int
    rank: int
    heads: bool
    sequence: bool


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


def upload_tokens(x, device: torch.device) -> torch.Tensor:
    """``[B, S]`` token ids or mask (numpy or tensor) -> int64 on
    ``device``; a host array goes through pinned memory without waiting."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.to(torch.int64).pin_memory().to(device, non_blocking=True)
    return t.to(device, torch.int64)


class _Linear(nn.Linear):
    """``nn.Linear`` holding its weights in ``cfg.weight_dtype`` and
    computing in ``cfg.dtype`` (the input and the weights cast first)."""

    def __init__(self, cfg: NomicBertConfig, d_in: int, d_out: int,
                 bias: bool, device=None):
        super().__init__(d_in, d_out, bias=bias, dtype=cfg.weight_dtype,
                         device=device)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class _PartialProduct(torch.autograd.Function):
    """``x @ w.T`` of compute-dtype operands with an f32 result: on CUDA one
    tensor-core GEMM that accumulates in f32 and leaves its output
    unrounded, elsewhere the f32 product of the operands (every product
    exact). Its gradients are compute-dtype GEMMs, as the one-device
    product's are: the output's gradient is a compute-dtype value cast to
    f32 (the rounding after the bias), so casting it back is exact."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            out = torch.mm(x2.float(), w.float().t())
        return out.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        return g @ w, gw


class _RowLinear(_Linear):
    """The row-parallel half of a split product: the rank's input features
    (``d_in`` of them) times its columns of the weight, an f32 partial
    product of compute-dtype operands (:class:`_PartialProduct`), reduced
    over the model group in f32 (all-reduced, or reduce-scattered onto the
    rank's rows under sequence parallelism), the bias added once, then one
    rounding to the compute dtype."""

    def __init__(self, cfg: NomicBertConfig, d_in: int, d_out: int,
                 tp: TensorParallel, device=None):
        super().__init__(cfg, d_in, d_out, True, device)
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, tp = self.compute_dtype, self.tp
        partial = _PartialProduct.apply(x.to(dt), self.weight.to(dt))
        if tp.sequence:
            y = reduce_scatter_to_rows(partial, tp.group)
        else:
            y = reduce_from_group(partial, tp.group)
        return (y + self.bias.to(dt).float()).to(dt)


def _enter_split(x: torch.Tensor, tp: Optional[TensorParallel]
                 ) -> torch.Tensor:
    """The input of a split product: the sequence gathered from the ranks'
    rows under sequence parallelism, else the whole input, its gradient
    summed over the group."""
    if tp is None:
        return x
    if tp.sequence:
        return gather_for_product(x, tp.group)
    return copy_to_group(x, tp.group)


class _Embedding(nn.Embedding):
    """``nn.Embedding`` holding its table in ``cfg.weight_dtype``; the rows
    it gathers are cast to ``cfg.dtype``."""

    def __init__(self, cfg: NomicBertConfig, rows: int, device=None):
        super().__init__(rows, cfg.hidden_size, dtype=cfg.weight_dtype,
                         device=device)
        self.compute_dtype = cfg.dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


class _AttentionInputs:
    """Per-forward attention inputs shared by every layer."""

    def __init__(self, cos, sin, cos2, s2, mask_bias, bias2, seg, plan):
        self.cos, self.sin = cos, sin            # [S, hd/2] f32
        self.cos2, self.s2 = cos2, s2            # [S, hd] f32 (K8)
        self.mask_bias = mask_bias               # [B, 1, 1, S] f32
        self.bias2 = bias2                       # [B, S] f32 (K8)
        self.seg = seg                           # [B, S] int32 (flash)
        self.plan = plan                         # flash's tile plan, or None


class NomicAttention(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.tp = tp
        split = tp is not None and tp.heads
        self.heads = cfg.num_heads // tp.size if split else cfg.num_heads
        d_local = self.heads * cfg.head_dim
        self.Wqkv = _Linear(cfg, d, 3 * d_local, cfg.qkv_bias, device)
        self.out_proj = (_RowLinear(cfg, d_local, d, tp, device) if split
                         else _Linear(cfg, d, d, True, device))

    def forward(self, x: torch.Tensor, rope: _AttentionInputs) -> torch.Tensor:
        cfg, tp = self.cfg, self.tp
        if tp is not None and (tp.heads or tp.sequence):
            # attention that runs whole on every rank needs the whole
            # sequence under sequence parallelism; each rank then keeps its
            # rows of the output (_output), so every rank's copy of the
            # weights gets its rows' share of the gradient
            x = _enter_split(x, tp)
        b, s, _ = x.shape
        h, hd = self.heads, cfg.head_dim
        qkv = self.Wqkv(x)
        impl = _resolve_attention_impl(cfg.attention_impl, s, hd)
        if impl == "fused":
            ctx = fused_attention_qkv(qkv, rope.cos2, rope.s2, rope.bias2, h,
                                      1.0 / math.sqrt(hd))
            return self._output(ctx)
        qkv = qkv.view(b, s, 3, h, hd)
        q = apply_rotary(qkv[:, :, 0], rope.cos, rope.sin)
        k = apply_rotary(qkv[:, :, 1], rope.cos, rope.sin)
        v = qkv[:, :, 2]
        if impl == "flash":
            # K14 (K15 + K16 backward) on [B, H, S, hd]; the key padding
            # rides segment ids, so no [B, H, S, S] logits exist
            ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  SegmentIds(rope.seg, rope.seg),
                                  1.0 / math.sqrt(hd), plan=rope.plan)
            return self._output(ctx.transpose(1, 2).to(cfg.dtype)
                                .reshape(b, s, h * hd))
        # Products of the rounded operands are exact in f32 (TF32 off).
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
        if impl == "xla_bf16":
            # bf16 logits, softmax reduced in f32 (the reference's opt-in
            # chain and the fallback for shapes K8 does not take).
            logits = logits.to(torch.bfloat16) * torch.tensor(
                1.0 / math.sqrt(hd), dtype=torch.bfloat16)
            logits = (logits + rope.mask_bias.to(torch.bfloat16)).float()
        else:
            logits = logits / math.sqrt(hd) + rope.mask_bias
        probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
        ctx = torch.einsum("bhst,bthd->bshd", probs.float(), v.float())
        return self._output(ctx.to(cfg.dtype).reshape(b, s, h * hd))

    def _output(self, ctx: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        out = self.out_proj(ctx)
        if tp is not None and not tp.heads and tp.sequence:
            out = own_rows(out, tp.group)
        return out


class NomicMlp(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        d, inner = cfg.hidden_size, cfg.mlp_dim
        self.tp = tp
        if tp is not None:
            if inner % tp.size:
                raise ValueError(f"mlp_dim {inner} does not split over "
                                 f"{tp.size} model ranks")
            inner //= tp.size
        self.swiglu = cfg.activation == "swiglu"
        if self.swiglu:
            self.fc11 = _Linear(cfg, d, inner, cfg.mlp_bias, device)
            self.fc12 = _Linear(cfg, d, inner, cfg.mlp_bias, device)
        else:
            self.fc1 = _Linear(cfg, d, inner, True, device)
        self.fc2 = (_Linear(cfg, inner, d, True, device) if tp is None
                    else _RowLinear(cfg, inner, d, tp, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _enter_split(x, self.tp)
        # the gate on K19 (K19b backward): y * silu(gate), or gelu(y)
        if self.swiglu:
            y = SwiGlu.apply(self.fc11(x), self.fc12(x), "swiglu")
        else:
            y = SwiGlu.apply(None, self.fc1(x), "gelu")
        return self.fc2(y)


def _layer_norm(cfg: NomicBertConfig, device) -> nn.LayerNorm:
    """The holder of a norm's f32 ``weight`` and ``bias`` (the reference's
    ``scale`` and ``bias``); :func:`add_norm` applies it."""
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


def add_norm(x: torch.Tensor, r: torch.Tensor, norm: nn.LayerNorm
             ) -> torch.Tensor:
    """``norm(round(x + r))`` in x's dtype: the residual add, flax's f32
    LayerNorm with ``norm``'s parameters and the rounding in one pass (K18,
    K18b backward)."""
    return AddLayerNorm.apply(x, r, norm.weight, norm.bias, norm.eps)


class NomicLayer(nn.Module):
    """Post-LN block: x = LN1(x + attn(x)); x = LN2(x + mlp(x)), the norms
    in f32 (:func:`add_norm`)."""

    def __init__(self, cfg: NomicBertConfig, device=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.attn = NomicAttention(cfg, device, tp)
        self.mlp = NomicMlp(cfg, device, tp)
        self.norm1 = _layer_norm(cfg, device)
        self.norm2 = _layer_norm(cfg, device)

    def forward(self, x: torch.Tensor, rope: _AttentionInputs) -> torch.Tensor:
        x = add_norm(x, self.attn(x, rope), self.norm1)
        return add_norm(x, self.mlp(x), self.norm2)


class NomicEmbeddings(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        self.word_embeddings = _Embedding(cfg, cfg.vocab_size, device)
        self.token_type_embeddings = _Embedding(cfg, cfg.type_vocab_size,
                                                device)


class NomicEncoderLayers(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            NomicLayer(cfg, device, tp) for _ in range(cfg.num_layers))


class NomicBertModel(nn.Module):
    """Token ids + mask ``[B, S]`` -> final hidden states ``[B, S, D]``
    (with ``tp``, this rank's shard of the model; every rank of the model
    axis takes the same batch and returns the same hidden states)."""

    def __init__(self, cfg: NomicBertConfig, device=None,
                 tp: Optional[TensorParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        self.embeddings = NomicEmbeddings(cfg, device)
        self.emb_ln = _layer_norm(cfg, device)
        self.encoder = NomicEncoderLayers(cfg, device, tp)
        self._tables: Dict[Tuple[int, torch.device], tuple] = {}

    def _rotary(self, seq_len: int, device: torch.device):
        key = (seq_len, device)
        if key not in self._tables:
            cos, sin = rotary_tables(seq_len, self.cfg.head_dim,
                                     self.cfg.rotary_base)
            cos = torch.from_numpy(cos).to(device)
            sin = torch.from_numpy(sin).to(device)
            self._tables[key] = (cos, sin, *rotary_roll_tables(cos, sin))
        return self._tables[key]

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        cfg, tp = self.cfg, self.tp
        sp = tp is not None and tp.sequence
        # under sequence parallelism the embeddings, and every residual add
        # and norm after them, cover the rank's rows of the sequence
        rows = own_rows(input_ids, tp.group) if sp else input_ids
        tok = self.embeddings.word_embeddings(rows)
        # every real token is type 0 for retrieval encoding
        typ = self.embeddings.token_type_embeddings(torch.zeros_like(rows))
        x = add_norm(tok, typ, self.emb_ln)
        # additive key-padding bias: 0 where attendable, -1e9 where padded
        bias2 = torch.where(attention_mask > 0, 0.0, -1e9).to(torch.float32)
        seg = attention_mask.to(torch.int32)
        # flash's tile plan, once a batch for every layer (self-attention:
        # the ids alone decide it)
        plan = (segment_tile_plan(seg, seg)
                if _resolve_attention_impl(cfg.attention_impl) == "flash"
                else None)
        rope = _AttentionInputs(*self._rotary(input_ids.shape[1], input_ids.device),
                     mask_bias=bias2[:, None, None, :],
                     bias2=bias2.contiguous(), seg=seg, plan=plan)
        for layer in self.encoder.layers:
            x = layer(x, rope)
        return gather_rows(x, tp.group, dim=1) if sp else x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
              ) -> torch.Tensor:
    """Masked mean over the sequence in f32. ``[B, S, D] -> [B, D]``."""
    m = attention_mask.to(torch.float32)[:, :, None]
    summed = (hidden.to(torch.float32) * m).sum(dim=1)
    return summed / m.sum(dim=1).clamp_min(1.0)


def finalize_embeddings(pooled: torch.Tensor,
                        matryoshka_dim: Optional[int] = None) -> torch.Tensor:
    """v1.5 post-processing in f32: affine-free layer norm, optional
    Matryoshka slice, L2 normalization."""
    x = pooled.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + 1e-12)
    if matryoshka_dim is not None and matryoshka_dim < x.shape[-1]:
        x = x[:, :matryoshka_dim]
    norms = x.norm(dim=-1, keepdim=True)
    return x / torch.where(norms == 0.0, 1.0, norms)


@torch.no_grad()
def init_random(model: NomicBertModel, seed: int) -> None:
    """Random weights from ``seed`` through an explicit generator on the
    model's device: LeCun-normal Linear weights, unit-normal embeddings,
    zero biases, unit LayerNorm scales."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    norms = {id(m.weight) for m in model.modules()
             if isinstance(m, nn.LayerNorm)}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif id(p) in norms:
            p.fill_(1.0)
        else:
            std = 1.0 if "embeddings" in name else 1.0 / math.sqrt(p.shape[1])
            w = torch.randn(p.shape, generator=gen, device=device,
                            dtype=torch.float32)
            p.copy_(w.mul_(std))


# ---------------------------------------------------------------------------
# Tensor-parallel layout of the parameters
# ---------------------------------------------------------------------------

#: modules split by output features (column-parallel) and by input
#: features (row-parallel): the JAX package's ``_spec_for_path`` names
COLUMN_PARALLEL = ("Wqkv", "fc11", "fc12", "fc1")
ROW_PARALLEL = ("out_proj", "fc2")


def param_spec(name: str, heads: bool = True) -> tuple:
    """How the parameter ``name`` splits over the model axis, as a spec
    over its torch dims — the JAX ``param_specs`` spec of its flax kernel,
    transposed: ``("model", None)`` for a column-parallel weight ``[out,
    in]``, ``(None, "model")`` for a row-parallel one, ``()`` for what
    every rank holds whole (embeddings, norms, row-parallel biases, and the
    attention's parameters where its heads do not split, ``heads=False``).
    A column-parallel bias is ``("model",)``, split with its rows: JAX
    replicates it and lets XLA slice it."""
    *_, module, kind = name.split(".")
    if module in ("Wqkv", "out_proj") and not heads:
        return ()
    if module in COLUMN_PARALLEL:
        return (MODEL_AXIS, None) if kind == "weight" else (MODEL_AXIS,)
    if module in ROW_PARALLEL and kind == "weight":
        return (None, MODEL_AXIS)
    return ()


def param_specs(params, heads: bool = True) -> Dict[str, tuple]:
    """:func:`param_spec` of every name of a state dict."""
    return {name: param_spec(name, heads) for name in params}


def _pieces(name: str, t: torch.Tensor, spec: tuple, size: int) -> list:
    """``t``'s ``size`` shards in rank order. ``Wqkv``'s rows are q, k, v,
    each head-major, so a rank takes its heads' rows from each third: its
    ``qkv`` is then K8's layout for ``H/size`` heads (a cut of the flat
    rows would give rank 0 all of q)."""
    dim = spec.index(MODEL_AXIS)
    qkv = name.split(".")[-2] == "Wqkv"
    rows = t.shape[dim] // 3 if qkv else t.shape[dim]
    if rows % size:
        raise ValueError(f"{name} {tuple(t.shape)} does not split over "
                         f"{size} model ranks")
    if qkv:
        thirds = [c.chunk(size, 0) for c in t.chunk(3, 0)]
        return [torch.cat([third[r] for third in thirds])
                for r in range(size)]
    return list(t.chunk(size, dim))


def shard_params(params: Dict[str, torch.Tensor], size: int, rank: int,
                 heads: bool = True) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a whole state dict over ``size`` model
    ranks (:func:`param_spec`); the state dict of the model built with a
    :class:`TensorParallel` of that rank."""
    out = {}
    for name, t in params.items():
        spec = param_spec(name, heads)
        out[name] = (_pieces(name, t, spec, size)[rank].contiguous()
                     if MODEL_AXIS in spec else t)
    return out


def merge_shards(shards: Sequence[Dict[str, torch.Tensor]],
                 heads: bool = True) -> Dict[str, torch.Tensor]:
    """Every rank's shard, in rank order, back into the whole state dict:
    :func:`shard_params` undone, bit for bit."""
    out = {}
    for name, t in shards[0].items():
        spec = param_spec(name, heads)
        if MODEL_AXIS not in spec:
            out[name] = t
            continue
        parts = [s[name] for s in shards]
        if name.split(".")[-2] == "Wqkv":
            thirds = [p.chunk(3, 0) for p in parts]
            out[name] = torch.cat([th[k] for k in range(3) for th in thirds])
        else:
            out[name] = torch.cat(parts, dim=spec.index(MODEL_AXIS))
    return out


def gather_params(params: Dict[str, torch.Tensor], group,
                  heads: bool = True) -> Dict[str, torch.Tensor]:
    """The whole state dict from this rank's shard and its model group's
    (an ``all_gather`` per split tensor; every rank of the group calls
    it); ``group=None``: ``params`` as they are."""
    if group is None:
        return dict(params)
    import torch.distributed as dist

    n = dist.get_world_size(group)
    shards = [dict(params) for _ in range(n)]
    for name, t in params.items():
        if MODEL_AXIS in param_spec(name, heads):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            for shard, part in zip(shards, parts):
                shard[name] = part
    return merge_shards(shards, heads)


def build_model(config: NomicBertConfig, device: torch.device, seed: int = 0,
                state_dict: Optional[Dict[str, torch.Tensor]] = None,
                tp: Optional[TensorParallel] = None) -> NomicBertModel:
    """The model on ``device`` with the weights ``state_dict``, or random
    ones from ``seed`` (:func:`init_random`); with ``tp``, this rank's shard
    of them. Random weights are drawn for the whole model, as one device
    draws them, and then cut, so every mesh starts from the same weights."""
    if state_dict is None:
        full = NomicBertModel(config, device=device)
        init_random(full, seed)
        if tp is None:
            return full
        state_dict = full.state_dict()
    model = NomicBertModel(config, device=device, tp=tp)
    if tp is not None:
        state_dict = shard_params(state_dict, tp.size, tp.rank, tp.heads)
    model.load_state_dict(state_dict)
    return model


class NomicEncoder:
    """Text-encoder head around :class:`NomicBertModel`: ``[B, S]`` ids and
    mask -> ``[B, dim]`` f32 embeddings, one row per text.

    Without ``mesh`` it runs on ``device`` (``None``: the CUDA card, raising
    without one). With one (the JAX encoder's ``mesh``), this process's
    shards of it split every batch into equal blocks, in shard order (the
    JAX encoder's data parallelism; a device named twice takes two blocks,
    and each distinct device holds one copy of the weights), and a model
    axis above 1 splits the model over the ranks of that axis
    (:class:`TensorParallel`, one shard a rank; every rank of the axis is
    given the same batch and returns the same embeddings). As in the JAX
    encoder, the attention heads split too where their number divides
    over the axis and the attention is ``auto``/``fused``; else the
    attention runs whole on every rank."""

    def __init__(self, config: NomicBertConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 matryoshka_dim: Optional[int] = None, seed: int = 0,
                 device: Optional[torch.device | str] = None, mesh=None):
        _resolve_attention_impl(config.attention_impl)  # refuse a bad name early
        tp = None
        if mesh is None:
            self.devices = [resolve_device(device)]
        else:
            refuse_flash_on_mesh(config.attention_impl, mesh.size)
            self.devices = [s.device for _i, s in mesh.local_shards()]
            heads = (config.attention_impl in ("auto", "fused")
                     and config.num_heads % axis_size(mesh, MODEL_AXIS) == 0)
            tp = tensor_parallel(mesh, config, heads, sequence=False)
        for d in self.devices:
            refuse_fused_past_kernel(config.attention_impl, config.max_tokens,
                                     config.head_dim, torch.device(d).type)
        self.config = config
        self.device = self.devices[0]
        self.model = build_model(config, self.device, seed, state_dict, tp)
        self._models = {self.device: self.model}
        for d in self.devices[1:]:
            if d not in self._models:
                copy = NomicBertModel(config, device=d)
                copy.load_state_dict(self.model.state_dict())
                self._models[d] = copy
        for model in self._models.values():
            model.eval().requires_grad_(False)
        self.matryoshka_dim = matryoshka_dim

    @property
    def dim(self) -> int:
        return self.matryoshka_dim or self.config.hidden_size

    def encode_tokens_device(self, input_ids, attention_mask) -> torch.Tensor:
        """``[B, S]`` ids + mask -> ``[B, dim]`` f32 embeddings, left on the
        (first) device, queued, not waited for. Over several local shards
        ``B`` must split into equal blocks."""
        n = len(self.devices)
        b = input_ids.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{n} local shards")
        out = []
        for i, device in enumerate(self.devices):
            rows = slice(i * b // n, (i + 1) * b // n)
            ids = upload_tokens(input_ids[rows], device)
            mask = upload_tokens(attention_mask[rows], device)
            with torch.no_grad():
                hidden = self._models[device](ids, mask)
                out.append(finalize_embeddings(mean_pool(hidden, mask),
                                               self.matryoshka_dim))
        if n == 1:
            return out[0]
        return torch.cat([o.to(self.device) for o in out])

    def encode_tokens(self, input_ids, attention_mask) -> np.ndarray:
        out = self.encode_tokens_device(input_ids, attention_mask)
        return out.cpu().numpy().astype(np.float32, copy=False)


# ---------------------------------------------------------------------------
# Weights: HF state dicts and the JAX package's parameter tree
# ---------------------------------------------------------------------------


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().contiguous()
    return torch.tensor(np.asarray(t, np.float32))


def _strip_prefixes(state: Dict) -> Dict:
    out = {}
    for k, v in state.items():
        for pre in ("model.", "bert.", "nomic_bert."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def convert_hf_state(state: Dict, config: NomicBertConfig
                     ) -> Dict[str, torch.Tensor]:
    """HF ``nomic-bert`` tensors -> this module's ``state_dict`` (f32; load
    casts to the compute dtype). Linear weights stay ``[out, in]``; a fused
    ``mlp.fc1`` splits as (y, gate) into fc11 / fc12; absent output biases
    are zero."""
    state = _strip_prefixes(state)
    d = config.hidden_size

    def get(*names):
        for n in names:
            if n in state:
                return _f32(state[n])
        raise KeyError(f"none of {names} in checkpoint ({len(state)} tensors)")

    def get_or_zeros(name, n):
        return _f32(state[name]) if name in state else torch.zeros(n)

    sd = {
        "embeddings.word_embeddings.weight": get(
            "embeddings.word_embeddings.weight", "emb.word_embeddings.weight"),
        "embeddings.token_type_embeddings.weight": get(
            "embeddings.token_type_embeddings.weight",
            "emb.token_type_embeddings.weight"),
        "emb_ln.weight": get("emb_ln.weight", "embeddings.LayerNorm.weight"),
        "emb_ln.bias": get("emb_ln.bias", "embeddings.LayerNorm.bias"),
    }
    for i in range(config.num_layers):
        pre = f"encoder.layers.{i}"
        sd[f"{pre}.attn.Wqkv.weight"] = get(f"{pre}.attn.Wqkv.weight")
        if config.qkv_bias:
            sd[f"{pre}.attn.Wqkv.bias"] = get(f"{pre}.attn.Wqkv.bias")
        sd[f"{pre}.attn.out_proj.weight"] = get(f"{pre}.attn.out_proj.weight")
        sd[f"{pre}.attn.out_proj.bias"] = get_or_zeros(
            f"{pre}.attn.out_proj.bias", d)
        params = ("weight", "bias") if config.mlp_bias else ("weight",)
        if f"{pre}.mlp.fc11.weight" in state:
            for name in ("fc11", "fc12"):
                for p in params:
                    sd[f"{pre}.mlp.{name}.{p}"] = get(f"{pre}.mlp.{name}.{p}")
        elif config.activation == "swiglu":
            for p in params:  # fused [2*inner, ...]: fc1 splits as (y, gate)
                fused = get(f"{pre}.mlp.fc1.{p}")
                inner = fused.shape[0] // 2
                sd[f"{pre}.mlp.fc11.{p}"] = fused[:inner].contiguous()
                sd[f"{pre}.mlp.fc12.{p}"] = fused[inner:].contiguous()
        else:
            sd[f"{pre}.mlp.fc1.weight"] = get(f"{pre}.mlp.fc1.weight")
            sd[f"{pre}.mlp.fc1.bias"] = get_or_zeros(f"{pre}.mlp.fc1.bias",
                                                     config.mlp_dim)
        sd[f"{pre}.mlp.fc2.weight"] = get(f"{pre}.mlp.fc2.weight")
        sd[f"{pre}.mlp.fc2.bias"] = get_or_zeros(f"{pre}.mlp.fc2.bias", d)
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = get(f"{pre}.{norm}.weight")
            sd[f"{pre}.{norm}.bias"] = get(f"{pre}.{norm}.bias")
    return sd


def params_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``NomicEncoder.params`` tree (arrays; flax kernels
    are ``[in, out]``) -> this module's ``state_dict`` in f32."""

    def linear(node, name, sd):
        sd[f"{name}.weight"] = _f32(np.asarray(node["kernel"]).T)
        if "bias" in node:
            sd[f"{name}.bias"] = _f32(node["bias"])

    def norm(node, name, sd):
        sd[f"{name}.weight"] = _f32(node["scale"])
        sd[f"{name}.bias"] = _f32(node["bias"])

    sd: Dict[str, torch.Tensor] = {
        "embeddings.word_embeddings.weight":
            _f32(params["word_embeddings"]["embedding"]),
        "embeddings.token_type_embeddings.weight":
            _f32(params["token_type_embeddings"]["embedding"]),
    }
    norm(params["emb_norm"], "emb_ln", sd)
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        layer, pre = params[f"layer_{i}"], f"encoder.layers.{i}"
        linear(layer["attn"]["Wqkv"], f"{pre}.attn.Wqkv", sd)
        linear(layer["attn"]["out_proj"], f"{pre}.attn.out_proj", sd)
        for name, node in layer["mlp"].items():
            linear(node, f"{pre}.mlp.{name}", sd)
        norm(layer["norm1"], f"{pre}.norm1", sd)
        norm(layer["norm2"], f"{pre}.norm2", sd)
    return sd


def _load_raw_state(checkpoint_dir: Path) -> Dict[str, torch.Tensor]:
    """Every tensor from the safetensors / torch ``.bin`` files in the dir."""
    st_files = sorted(checkpoint_dir.glob("*.safetensors"))
    state: Dict[str, torch.Tensor] = {}
    if st_files:
        from safetensors.torch import load_file

        for f in st_files:
            state.update(load_file(str(f)))
        return state
    bin_files = sorted(checkpoint_dir.glob("*.bin"))
    if bin_files:
        for f in bin_files:
            state.update(torch.load(str(f), map_location="cpu",
                                    weights_only=True))
        return state
    raise FileNotFoundError(
        f"no *.safetensors or *.bin weights under {checkpoint_dir}")


def load_hf_checkpoint(checkpoint_dir: str,
                       config: Optional[NomicBertConfig] = None
                       ) -> Tuple[NomicBertConfig, Dict[str, torch.Tensor]]:
    """A local HF export of nomic-embed-text-v1.5 -> (config, state_dict),
    with ``config.json``'s architecture overrides when present."""
    ckpt = Path(checkpoint_dir)
    config = config or NomicBertConfig()
    cfg_file = ckpt / "config.json"
    if cfg_file.exists():
        hf = json.loads(cfg_file.read_text())
        config = NomicBertConfig(
            vocab_size=hf.get("vocab_size", config.vocab_size),
            hidden_size=hf.get("n_embd", hf.get("hidden_size",
                                                config.hidden_size)),
            num_layers=hf.get("n_layer", hf.get("num_hidden_layers",
                                                config.num_layers)),
            num_heads=hf.get("n_head", hf.get("num_attention_heads",
                                              config.num_heads)),
            mlp_dim=hf.get("n_inner", hf.get("intermediate_size",
                                             config.mlp_dim)),
            max_tokens=config.max_tokens,
            type_vocab_size=hf.get("type_vocab_size", config.type_vocab_size),
            rotary_base=hf.get("rotary_emb_base", config.rotary_base),
            layer_norm_eps=hf.get("layer_norm_epsilon", config.layer_norm_eps),
            activation="swiglu" if hf.get("activation_function", "swiglu")
            in ("swiglu", "silu") else "gelu",
            qkv_bias=hf.get("qkv_proj_bias", config.qkv_bias),
            mlp_bias=hf.get("mlp_fc1_bias", config.mlp_bias),
            dtype=config.dtype, attention_impl=config.attention_impl,
            param_dtype=config.param_dtype,
        )
    return config, convert_hf_state(_load_raw_state(ckpt), config)
