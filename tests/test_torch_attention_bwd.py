"""K9 _fused_qkv_bwd: the port's plain backward against the JAX kernel.

The same numpy inputs go through the JAX package's backward kernel
(``_fused_qkv_bwd``, Pallas in interpret mode) and the port's K9 wrapper on
CPU tensors, which runs the plain PyTorch version. Two shapes: odd heads
(B 2, S 16, H 3, hd 16: the JAX kernel takes all heads in one block) and
hd 64 with 4 heads (B 2, S 32: two heads per block, two blocks — the
multi-block index maps). Tolerances:

* f32: atol 1e-5 and rtol 1e-5 (the two sum in different orders; every
  rounding to the working dtype is then the identity; measured <= 8.2e-7);
* bf16, with one key-padded row and one fully padded row: cosine >= 0.9999
  per tensor (dq, dk, dv), and max |diff| <= 1 bf16 ulp at the tensor's
  largest magnitude (an f32 sum summed in another order can land on the
  other side of a bf16 rounding boundary; measured: 1 ulp of a small
  element on 0.008 % of dq, nothing else);
* the autograd backward of :func:`fused_attention_qkv` on the CPU is the
  plain K9 exactly (bitwise), not autograd of the plain forward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops.attention_pallas import (
    _fused_qkv_bwd as jax_fused_qkv_bwd,
    fused_attention_qkv_diff as jax_fused_attention_qkv_diff,
    rotary_roll_tables as jax_rotary_roll_tables,
)
from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

SHAPES = [(2, 16, 3, 16), (2, 32, 4, 64)]     # (B, S, H, hd)
F32_ATOL, F32_RTOL = 1e-5, 1e-5
BF16_COS, BF16_ULPS = 0.9999, 1


def _inputs(b, s, h, hd, seed, pad):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * hd)).astype(np.float32)
    g = rng.standard_normal((b, s, h * hd)).astype(np.float32)
    lens = np.full(b, s)
    if pad:
        lens[0] = s // 2 + 3                   # key padding on row 0
        lens[-1] = 0                           # a fully padded row
    mask = np.arange(s)[None, :] < lens[:, None]
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    cos, sin = rotary_tables(s, hd, 1000.0)
    return qkv, g, bias, cos, sin


def _jax_bwd(qkv, g, bias, cos, sin, h, dtype):
    c2, s2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    scale = 1.0 / math.sqrt(qkv.shape[2] // (3 * h))
    res = (jnp.asarray(qkv, dtype), c2, s2, jnp.asarray(bias))
    dqkv = jax_fused_qkv_bwd(h, scale, True, res, jnp.asarray(g))[0]
    return np.asarray(dqkv.astype(jnp.float32))


def _port_bwd(qkv, g, bias, cos, sin, h, dtype):
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    scale = 1.0 / math.sqrt(qkv.shape[2] // (3 * h))
    before = ak.launch_counts["fused_attention_qkv_bwd"]
    out = ak.fused_attention_qkv_bwd(
        torch.from_numpy(qkv).to(dtype), c2, s2, torch.from_numpy(bias),
        torch.from_numpy(g).to(dtype), h, scale)
    assert ak.launch_counts["fused_attention_qkv_bwd"] == before  # plain
    assert out.dtype == dtype and out.shape == qkv.shape
    return out.float().numpy()


def _split(x, h):
    """[B, S, 3*H*hd] -> dq, dk, dv [B, S, H*hd]."""
    return np.split(x, 3, axis=-1)


@pytest.mark.parametrize("b,s,h,hd", SHAPES)
def test_plain_k9_matches_jax_f32(b, s, h, hd):
    qkv, g, bias, cos, sin = _inputs(b, s, h, hd, seed=11, pad=False)
    want = _jax_bwd(qkv, g, bias, cos, sin, h, jnp.float32)
    got = _port_bwd(qkv, g, bias, cos, sin, h, torch.float32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("b,s,h,hd", SHAPES)
def test_plain_k9_matches_jax_bf16_padded(b, s, h, hd):
    qkv, g, bias, cos, sin = _inputs(b + 1, s, h, hd, seed=12, pad=True)
    want = _jax_bwd(qkv, g, bias, cos, sin, h, jnp.bfloat16)
    got = _port_bwd(qkv, g, bias, cos, sin, h, torch.bfloat16)
    assert np.isfinite(got).all()              # the fully padded row too
    for name, a, r in zip("qkv", _split(got, h), _split(want, h)):
        cos_sim = float((a * r).sum() / (np.linalg.norm(a) * np.linalg.norm(r)))
        assert cos_sim >= BF16_COS, (name, cos_sim)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        assert np.abs(a - r).max() <= BF16_ULPS * ulp, (
            name, np.abs(a - r).max() / ulp)


@pytest.mark.parametrize("b,s,h,hd", SHAPES)
def test_autograd_backward_is_plain_k9(b, s, h, hd):
    """fused_attention_qkv's backward under autograd: the plain K9 bit for
    bit, and JAX's custom VJP to the f32 bound."""
    qkv, g, bias, cos, sin = _inputs(b, s, h, hd, seed=13, pad=True)
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    scale = 1.0 / math.sqrt(hd)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = ak.fused_attention_qkv(x, c2, s2, torch.from_numpy(bias), h, scale)
    assert type(out.grad_fn).__name__ == "FusedAttentionQKVBackward"
    out.backward(torch.from_numpy(g))
    plain = ak.fused_attention_qkv_bwd_plain(
        torch.from_numpy(qkv), c2, s2, torch.from_numpy(bias),
        torch.from_numpy(g), h, scale)
    assert torch.equal(x.grad, plain)
    want = _jax_bwd(qkv, g, bias, cos, sin, h, jnp.float32)
    np.testing.assert_allclose(x.grad.numpy(), want, atol=F32_ATOL,
                               rtol=F32_RTOL)
    # and JAX's own VJP of its forward gives the same dqkv
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    _, vjp = jax.vjp(lambda q: jax_fused_attention_qkv_diff(
        q, jc2, js2, jnp.asarray(bias), h, scale, True), jnp.asarray(qkv))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), want)


def test_bwd_wrapper_guards():
    qkv = torch.zeros((2, 16, 48), dtype=torch.bfloat16)
    c2 = torch.zeros((16, 8))
    bias = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="g must be"):
        ak.fused_attention_qkv_bwd(qkv, c2, c2, bias,
                                   torch.zeros((2, 16, 8), dtype=torch.bfloat16),
                                   2, 1.0)
    with pytest.raises(TypeError, match="dtype"):
        ak.fused_attention_qkv_bwd(qkv, c2, c2, bias, torch.zeros((2, 16, 16)),
                                   2, 1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ak.fused_attention_qkv_bwd(torch.zeros((2, 12, 48)), torch.zeros(
            (12, 8)), torch.zeros((12, 8)), torch.zeros((2, 12)),
            torch.zeros((2, 12, 16)), 2, 1.0)
