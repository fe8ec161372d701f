"""K5 matmul_blockmax_only: the port's plain version against the JAX kernel.

The JAX kernel runs in interpret mode on the CPU; the port's wrapper takes
its plain PyTorch version because the tensors lie on the CPU. The same numpy
inputs go to both, at R 2048 x D 64 and R 1024 x D 128, T 16, with
``valid_rows`` at R and below it (rows past it score ``PAD_SIM``).

* Dyadic rows (16 entries of +-1/4) and the int8 lattice: every product and
  sum is exact in f32, so the block maxima match bit for bit.
* Random normal rows, normalized: within rtol 1e-5 with an absolute floor
  of 1e-6 (the packages sum in different orders).
* Plain K5 equals plain K3's ``bm_t`` bit for bit, also when it scores the
  store in row chunks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import quantize as jq
from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from test_torch_topk_kernels import dyadic

T = 16
SHAPES = [(2048, 64), (1024, 128)]


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind, dtype, rows, dim, seed):
    """(numpy store, numpy queries, jax dtype) with the same bits for both
    packages."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        mat = jq.quantize_unit_host(_unit(rng.standard_normal((rows, dim))))
        qs = mat[rng.integers(0, rows, T)]
        return mat, qs, jnp.int8
    if kind == "dyadic":
        mat = dyadic(rng, rows, dim)
        mat[40:48] = mat[3]          # duplicate rows inside one block
        qs = np.concatenate([mat[[3, 9]], dyadic(rng, T - 2, dim)])
    else:
        mat = _unit(rng.standard_normal((rows, dim)))
        qs = _unit(rng.standard_normal((T, dim)))
    if dtype == "bfloat16":
        mat = torch.from_numpy(mat).bfloat16().float().numpy()
        qs = torch.from_numpy(qs).bfloat16().float().numpy()
    return mat, qs, getattr(jnp, dtype)


def _torch(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


@pytest.mark.parametrize("rows,dim", SHAPES)
@pytest.mark.parametrize("valid_cut", [0, 300])
@pytest.mark.parametrize("kind,dtype", [
    ("dyadic", "float32"), ("dyadic", "bfloat16"), ("lattice", "int8"),
    ("normal", "float32"), ("normal", "bfloat16"),
])
def test_plain_k5_matches_pallas(rows, dim, valid_cut, kind, dtype):
    mat, qs, jdt = _inputs(kind, dtype, rows, dim, seed=rows + dim)
    valid = rows - valid_cut
    want = np.asarray(ref.matmul_blockmax_only(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.int32(valid),
        interpret=True))
    before = port.launch_counts["matmul_blockmax_only"]
    got = port.matmul_blockmax_only(_torch(qs, dtype), _torch(mat, dtype),
                                    valid)
    assert port.launch_counts["matmul_blockmax_only"] == before  # plain
    assert got.dtype == torch.float32 and got.shape == (rows // 128, T)
    if valid_cut:
        assert (got[valid // 128 + 1:] == port.PAD_SIM).all()
    if kind == "normal":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_plain_k5_is_plain_k3_bm(dtype, monkeypatch):
    mat, qs, _ = _inputs("normal" if dtype != "int8" else "lattice", dtype,
                         2048, 64, seed=7)
    q, s = _torch(qs, dtype), _torch(mat, dtype)
    _, bm_t = port.matmul_blockmax(q, s, 1900)
    assert torch.equal(port.matmul_blockmax_only(q, s, 1900), bm_t)
    # scored in 512-row chunks: each chunk masks its own tail of the store
    monkeypatch.setattr(port, "_PLAIN_SCORES", 512 * T)
    chunked = port.matmul_blockmax_only_plain(q, s, 1900)
    if dtype == "int8":
        assert torch.equal(chunked, bm_t)
    else:
        torch.testing.assert_close(chunked, bm_t, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block", [64, 32])
def test_plain_k5_block_widths(block):
    mat, qs, jdt = _inputs("dyadic", "float32", 1024, 64, seed=3)
    want = np.asarray(ref.matmul_blockmax_only(
        jnp.asarray(qs), jnp.asarray(mat), jnp.int32(1000), interpret=True,
        block=block))
    got = port.matmul_blockmax_only(_torch(qs, "float32"),
                                    _torch(mat, "float32"), 1000, block=block)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k5_wrapper_guards():
    q = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="multiple of 128"):
        port.matmul_blockmax_only(q, torch.zeros((100, 64)), 100)
    with pytest.raises(ValueError, match="divide"):
        port.matmul_blockmax_only(q, torch.zeros((256, 64)), 256, block=96)
    with pytest.raises(TypeError, match="share a dtype"):
        port.matmul_blockmax_only(q.bfloat16(), torch.zeros((256, 64)), 256)
    assert port.matmul_blockmax_only(torch.zeros((0, 64)),
                                     torch.zeros((256, 64)), 256).shape == (2, 0)
