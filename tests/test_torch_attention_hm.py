"""K7 fused_attention (head-major): the port's plain version against the JAX
kernel, and against plain K8 on the same heads.

The JAX kernel runs in interpret mode on the CPU at B 2, H 2, S 16, hd 16,
with a key bias that pads a tail of each row's keys (one row fully padded);
the port's wrapper takes its plain PyTorch version on CPU tensors. Bound: the
JAX package's own kernel-vs-einsum bound, max |diff| < 0.02 and cosine >
0.999 on valid query rows (bf16 outputs). On the transposed Wqkv layout,
plain K7 equals plain K8 bit for bit: per head they are one function.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops.attention_pallas import (
    fused_attention as jax_fused_attention,
    rotary_roll_tables as jax_rotary_roll_tables,
)
from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

MAX_DIFF, MIN_COS = 0.02, 0.999


def _inputs(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((3, b, h, s, hd)).astype(np.float32)
    lens = rng.integers(1, s + 1, size=b)
    lens[-1] = 0                                   # one fully padded row
    valid = np.arange(s)[None, :] < lens[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)
    cos, sin = rotary_tables(s, hd, 1000.0)
    return qkv, valid, bias, cos, sin


@pytest.mark.parametrize("b,h,s,hd,seed", [(2, 2, 16, 16, 0),
                                           (2, 2, 16, 16, 1),
                                           (2, 3, 24, 32, 2)])
def test_plain_k7_matches_jax_kernel(b, h, s, hd, seed):
    qkv, valid, bias, cos, sin = _inputs(b, h, s, hd, seed)
    scale = 1.0 / math.sqrt(hd)
    jc2, js2 = jax_rotary_roll_tables(jnp.asarray(cos), jnp.asarray(sin))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in qkv)
    want = np.asarray(jax_fused_attention(jq, jk, jv, jc2, js2,
                                          jnp.asarray(bias), scale,
                                          interpret=True), np.float32)
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv)
    before = ak.launch_counts["fused_attention"]
    out = ak.fused_attention(q, k, v, c2, s2, torch.from_numpy(bias), scale)
    assert ak.launch_counts["fused_attention"] == before  # plain on the CPU
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, s, hd)
    got = out.float().numpy()
    assert np.isfinite(got).all()                  # the fully padded row too
    rows = np.broadcast_to(valid[:, None, :], (b, h, s))
    a, r = got[rows], want[rows]
    assert np.abs(a - r).max() < MAX_DIFF, np.abs(a - r).max()
    assert float((a * r).sum() / (np.linalg.norm(a) * np.linalg.norm(r))) \
        > MIN_COS


def test_plain_k7_on_transposed_qkv_is_plain_k8():
    b, h, s, hd = 2, 3, 32, 16
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * hd)).astype(
        np.float32)).to(torch.bfloat16)
    lens = torch.tensor([20, 32])
    bias = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                       -1e9).to(torch.float32)
    cos, sin = rotary_tables(s, hd, 1000.0)
    c2, s2 = ak.rotary_roll_tables(torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    scale = 1.0 / math.sqrt(hd)
    x = qkv.view(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.contiguous() for t in x)
    hm = ak.fused_attention(q, k, v, c2, s2, bias, scale)
    k8 = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    assert torch.equal(hm.permute(0, 2, 1, 3).reshape(b, s, h * hd), k8)


@pytest.mark.parametrize("shapes,err,match", [
    (((2, 2, 12, 16),) * 3, ValueError, "multiple of 8"),
    (((2, 2, 16, 15),) * 3, ValueError, "even"),
    (((2, 2, 16, 16), (2, 2, 16, 16), (2, 3, 16, 16)), ValueError,
     "one \\[B, H, S, hd\\] shape"),
])
def test_k7_wrapper_guards(shapes, err, match):
    q, k, v = (torch.zeros(sh, dtype=torch.bfloat16) for sh in shapes)
    s, hd = shapes[0][2], shapes[0][3]
    tab = torch.zeros((s, hd))
    with pytest.raises(err, match=match):
        ak.fused_attention(q, k, v, tab, tab, torch.zeros((2, s)), 1.0)


def test_k7_wrapper_refuses_mixed_dtypes_and_tables():
    q = torch.zeros((2, 2, 16, 16), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="share a dtype"):
        ak.fused_attention(q, q.float(), q, torch.zeros((16, 16)),
                           torch.zeros((16, 16)), torch.zeros((2, 16)), 1.0)
    with pytest.raises(ValueError, match="rotary tables"):
        ak.fused_attention(q, q, q, torch.zeros((16, 8)),
                           torch.zeros((16, 16)), torch.zeros((2, 16)), 1.0)
