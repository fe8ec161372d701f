"""K8 fused_attention_qkv: the port's plain version against the JAX kernel.

The same numpy inputs go through the JAX package's Pallas kernel in
interpret mode and the port's wrapper on CPU tensors (which runs the plain
PyTorch version). Bound: the JAX package's own kernel-vs-einsum bound,
max |diff| < 0.02 and cosine > 0.999 on valid query rows (bf16 outputs;
``tests/test_models.py``). Fully padded query rows must stay finite.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.models.nomic import (
    apply_rotary as jax_apply_rotary,
    rotary_tables as jax_rotary_tables,
)
from better_search_rag_rust_tpu.ops.attention_pallas import (
    fused_attention_qkv as jax_fused_attention_qkv,
    rotary_roll_tables as jax_rotary_roll_tables,
)
from better_search_rag_rust_tpu_torch.models.nomic import (
    apply_rotary,
    rotary_tables,
)
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

MAX_DIFF, MIN_COS = 0.02, 0.999


def _inputs(b, h, s, hd, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, 3 * h * hd)).astype(np.float32)
    lens = rng.integers(1, s + 1, size=b)
    lens[-1] = 0                               # one fully padded row
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    cos, sin = rotary_tables(s, hd, 1000.0)
    return qkv, mask, bias, cos, sin


def _torch_tables(cos, sin):
    return ak.rotary_roll_tables(torch.from_numpy(cos), torch.from_numpy(sin))


def _cos(a, b):
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_rotary_tables_equal_reference():
    s, hd = 40, 16
    cos, sin = rotary_tables(s, hd, 1000.0)
    jcos, jsin = jax_rotary_tables(s, hd, 1000.0)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    c2, s2 = _torch_tables(cos, sin)
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(jcos), jnp.asarray(jsin))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))


@pytest.mark.parametrize("b,h,s,hd", [(3, 4, 64, 16), (2, 2, 32, 64)])
def test_plain_k8_matches_jax_kernel(b, h, s, hd):
    qkv, mask, bias, cos, sin = _inputs(b, h, s, hd)
    scale = 1.0 / math.sqrt(hd)
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    ref = np.asarray(jax_fused_attention_qkv(
        jnp.asarray(qkv, jnp.bfloat16), jc2, js2, jnp.asarray(bias), h, scale,
        interpret=True), np.float32)
    c2, s2 = _torch_tables(cos, sin)
    before = ak.launch_counts["fused_attention_qkv"]
    out = ak.fused_attention_qkv(torch.from_numpy(qkv).to(torch.bfloat16),
                                 c2, s2, torch.from_numpy(bias), h, scale)
    assert ak.launch_counts["fused_attention_qkv"] == before  # plain on CPU
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, h * hd)
    got = out.float().numpy()
    assert np.isfinite(got).all()              # the fully padded row too
    valid = mask.astype(bool)
    a, r = got[valid], ref[valid]
    assert np.abs(a - r).max() < MAX_DIFF, np.abs(a - r).max()
    assert _cos(a, r) > MIN_COS


def test_plain_k8_matches_apply_rotary_chain():
    """The roll form with the port's tables is NeoX rotate-halves: the plain
    K8 equals rotary by ``apply_rotary`` followed by an f32-logit softmax
    chain (the reference's einsum chain, rotated in f32 like the kernel)."""
    b, h, s, hd = 2, 3, 48, 16
    qkv, mask, bias, cos, sin = _inputs(b, h, s, hd, seed=3)
    scale = 1.0 / math.sqrt(hd)
    qkv_b = torch.from_numpy(qkv).to(torch.bfloat16)
    x = qkv_b.view(b, s, 3, h, hd)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    q = apply_rotary(x[:, :, 0].float(), tc, ts).to(torch.bfloat16).float()
    k = apply_rotary(x[:, :, 1].float(), tc, ts).to(torch.bfloat16).float()
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    logits = logits + torch.from_numpy(bias)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    ref = torch.einsum("bhst,bthd->bshd", probs, x[:, :, 2].float())
    c2, s2 = _torch_tables(cos, sin)
    out = ak.fused_attention_qkv(qkv_b, c2, s2, torch.from_numpy(bias), h,
                                 scale).float().view(b, s, h, hd)
    valid = torch.from_numpy(mask.astype(bool))
    a, r = out[valid].numpy(), ref[valid].numpy()
    assert np.abs(a - r).max() < MAX_DIFF
    assert _cos(a, r) > MIN_COS
    # and the port's apply_rotary is the reference's
    jq = np.asarray(jax_apply_rotary(jnp.asarray(qkv.reshape(b, s, 3, h, hd)
                                                 [:, :, 0]),
                                     jnp.asarray(cos), jnp.asarray(sin)))
    tq = apply_rotary(torch.from_numpy(qkv).view(b, s, 3, h, hd)[:, :, 0],
                      tc, ts).numpy()
    np.testing.assert_allclose(tq, jq, atol=1e-6)


@pytest.mark.parametrize("shape,heads,match", [
    ((2, 12, 48), 4, "multiple of 8"),     # S = 12
    ((2, 16, 45), 5, "even"),              # hd = 3
    ((2, 16, 50), 4, "qkv shape"),         # 50 % 12 != 0
])
def test_wrapper_shape_guards(shape, heads, match):
    b, s, width = shape
    hd = max(width // (3 * heads), 1)
    qkv = torch.zeros(shape, dtype=torch.bfloat16)
    c2 = torch.zeros((s, hd))
    bias = torch.zeros((b, s))
    with pytest.raises(ValueError, match=match):
        ak.fused_attention_qkv(qkv, c2, c2, bias, heads, 1.0)


def test_wrapper_refuses_mismatched_operands():
    qkv = torch.zeros((2, 16, 48), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rotary tables"):
        ak.fused_attention_qkv(qkv, torch.zeros((16, 8)), torch.zeros((16, 4)),
                               torch.zeros((2, 16)), 2, 1.0)
    with pytest.raises(TypeError, match="float32"):
        ak.fused_attention_qkv(qkv, torch.zeros((16, 8)), torch.zeros((16, 8)),
                               torch.zeros((2, 16), dtype=torch.float64), 2,
                               1.0)
