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
compute dtype (the same rounding, done once at load).

Attention implementations (:func:`_resolve_attention_impl`): ``fused`` runs
the hand-written K8 kernel (:mod:`..ops.attention_kernels`), differentiable
with the hand-written K9 kernel as its backward, ``xla`` the
plain f32-logit chain, ``xla_bf16`` the plain bf16-logit chain; ``auto`` is
``fused``, which falls to ``xla_bf16`` for a sequence length or head width
not divisible by 8. ``flash`` (the reference's library kernel) is not
ported. The encoder meta records the port's names (``torch-fused``, ...), so
a store mixing the two packages warns at query time.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import EncoderConfig, torch_dtype
from ..ops.attention_kernels import fused_attention_qkv, rotary_roll_tables


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
    #: "auto" | "fused" | "xla" | "xla_bf16" (see _resolve_attention_impl)
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
    ``xla`` and ``xla_bf16`` as asked."""
    if impl == "auto":
        impl = "fused"
    if impl == "flash":
        raise NotImplementedError(
            "attention_impl='flash' (the reference's library Pallas flash "
            "kernel) is not ported to the PyTorch package; see ROADMAP.md. "
            "Use 'fused' (K8), 'xla' or 'xla_bf16'.")
    if impl not in ("fused", "xla", "xla_bf16"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    if impl == "fused" and ((seq_len is not None and seq_len % 8)
                            or (head_dim is not None and head_dim % 8)):
        return "xla_bf16"
    return impl


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

    def __init__(self, cos, sin, cos2, s2, mask_bias, bias2):
        self.cos, self.sin = cos, sin            # [S, hd/2] f32
        self.cos2, self.s2 = cos2, s2            # [S, hd] f32 (K8)
        self.mask_bias = mask_bias               # [B, 1, 1, S] f32
        self.bias2 = bias2                       # [B, S] f32 (K8)


class NomicAttention(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.Wqkv = _Linear(cfg, d, 3 * d, cfg.qkv_bias, device)
        self.out_proj = _Linear(cfg, d, d, True, device)

    def forward(self, x: torch.Tensor, rope: _AttentionInputs) -> torch.Tensor:
        cfg = self.cfg
        b, s, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = self.Wqkv(x)
        impl = _resolve_attention_impl(cfg.attention_impl, s, hd)
        if impl == "fused":
            ctx = fused_attention_qkv(qkv, rope.cos2, rope.s2, rope.bias2, h,
                                      1.0 / math.sqrt(hd))
            return self.out_proj(ctx)
        qkv = qkv.view(b, s, 3, h, hd)
        q = apply_rotary(qkv[:, :, 0], rope.cos, rope.sin)
        k = apply_rotary(qkv[:, :, 1], rope.cos, rope.sin)
        v = qkv[:, :, 2]
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
        return self.out_proj(ctx.to(cfg.dtype).reshape(b, s, d))


class NomicMlp(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        d, inner = cfg.hidden_size, cfg.mlp_dim
        self.swiglu = cfg.activation == "swiglu"
        if self.swiglu:
            self.fc11 = _Linear(cfg, d, inner, cfg.mlp_bias, device)
            self.fc12 = _Linear(cfg, d, inner, cfg.mlp_bias, device)
        else:
            self.fc1 = _Linear(cfg, d, inner, True, device)
        self.fc2 = _Linear(cfg, inner, d, True, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.swiglu:
            y = self.fc11(x) * F.silu(self.fc12(x))
        else:
            y = F.gelu(self.fc1(x), approximate="none")
        return self.fc2(y)


def _layer_norm(cfg: NomicBertConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


class NomicLayer(nn.Module):
    """Post-LN block: x = LN1(x + attn(x)); x = LN2(x + mlp(x)), the norms
    in f32."""

    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        self.attn = NomicAttention(cfg, device)
        self.mlp = NomicMlp(cfg, device)
        self.norm1 = _layer_norm(cfg, device)
        self.norm2 = _layer_norm(cfg, device)

    def forward(self, x: torch.Tensor, rope: _AttentionInputs) -> torch.Tensor:
        dt = x.dtype
        x = self.norm1((x + self.attn(x, rope)).float()).to(dt)
        return self.norm2((x + self.mlp(x)).float()).to(dt)


class NomicEmbeddings(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        self.word_embeddings = _Embedding(cfg, cfg.vocab_size, device)
        self.token_type_embeddings = _Embedding(cfg, cfg.type_vocab_size,
                                                device)


class NomicEncoderLayers(nn.Module):
    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            NomicLayer(cfg, device) for _ in range(cfg.num_layers))


class NomicBertModel(nn.Module):
    """Token ids + mask ``[B, S]`` -> final hidden states ``[B, S, D]``."""

    def __init__(self, cfg: NomicBertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = NomicEmbeddings(cfg, device)
        self.emb_ln = _layer_norm(cfg, device)
        self.encoder = NomicEncoderLayers(cfg, device)
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
        cfg = self.cfg
        tok = self.embeddings.word_embeddings(input_ids)
        # every real token is type 0 for retrieval encoding
        typ = self.embeddings.token_type_embeddings(
            torch.zeros_like(input_ids))
        x = self.emb_ln((tok + typ).float()).to(cfg.dtype)
        # additive key-padding bias: 0 where attendable, -1e9 where padded
        bias2 = torch.where(attention_mask > 0, 0.0, -1e9).to(torch.float32)
        rope = _AttentionInputs(*self._rotary(input_ids.shape[1], input_ids.device),
                     mask_bias=bias2[:, None, None, :],
                     bias2=bias2.contiguous())
        for layer in self.encoder.layers:
            x = layer(x, rope)
        return x


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


class NomicEncoder:
    """Text-encoder head around :class:`NomicBertModel`: ``[B, S]`` ids and
    mask -> ``[B, dim]`` f32 embeddings, one row per text."""

    def __init__(self, config: NomicBertConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 matryoshka_dim: Optional[int] = None, seed: int = 0,
                 device: torch.device | str = "cpu"):
        _resolve_attention_impl(config.attention_impl)  # refuse flash early
        self.config = config
        self.device = torch.device(device)
        self.model = NomicBertModel(config, device=self.device)
        if state_dict is None:
            init_random(self.model, seed)
        else:
            self.model.load_state_dict(state_dict)
        self.model.eval().requires_grad_(False)
        self.matryoshka_dim = matryoshka_dim

    @property
    def dim(self) -> int:
        return self.matryoshka_dim or self.config.hidden_size

    def encode_tokens_device(self, input_ids, attention_mask) -> torch.Tensor:
        """``[B, S]`` ids + mask -> ``[B, dim]`` f32 embeddings, left on the
        device (queued, not waited for)."""
        ids = upload_tokens(input_ids, self.device)
        mask = upload_tokens(attention_mask, self.device)
        with torch.no_grad():
            hidden = self.model(ids, mask)
            return finalize_embeddings(mean_pool(hidden, mask),
                                       self.matryoshka_dim)

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
