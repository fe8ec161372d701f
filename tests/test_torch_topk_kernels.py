"""Plain versions of K1/K2/K3 against the reference Pallas kernels.

The JAX kernels run in interpret mode on the CPU (as tests/test_search.py
runs them); the port's wrappers take their plain PyTorch versions because
the tensors lie on the CPU. Inputs come from numpy seeds and go to both.

* Dyadic inputs — rows with 16 non-zero entries of +-1/4, exactly unit
  norm: every product and sum is exact in f32, so every output, the packed
  key included, must match bit for bit; ties and duplicate rows are common.
* Random normal inputs, rows and queries normalized as the store holds
  them: float outputs within rtol 1e-5 (the two packages sum in different
  orders), with an absolute floor of 1e-6 for scores near zero, where the
  f32 sum's error (~D * 2^-24) is not relative to the result; argmaxes
  equal wherever a unit's top two scores differ by more than 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port

R, D, T = 1024, 64, 16


def dyadic(rng, n, d, nnz=16):
    """Rows with ``nnz`` entries of +-1/4 (unit norm when nnz == 16)."""
    out = np.zeros((n, d), dtype=np.float32)
    for i in range(n):
        cols = rng.choice(d, size=nnz, replace=False)
        out[i, cols] = rng.choice([-0.25, 0.25], size=nnz)
    return out


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind, dtype, seed=0, rows=R, dim=D):
    rng = np.random.default_rng(seed)
    if kind == "dyadic":
        mat = dyadic(rng, rows, dim)
        mat[40:48] = mat[3]          # cross-unit duplicates
        mat[100] = mat[101]          # in-unit duplicate pair
        qs = np.concatenate([mat[[3, 100, 7]], dyadic(rng, T - 3, dim)])
    else:
        mat = _unit(rng.standard_normal((rows, dim)))
        qs = _unit(rng.standard_normal((T, dim)))
    if dtype == "bfloat16":  # both packages see the same bf16 bits
        mat = torch.from_numpy(mat).bfloat16().float().numpy()
        qs = torch.from_numpy(qs).bfloat16().float().numpy()
    tdt = getattr(torch, dtype)
    return (mat, qs, torch.from_numpy(mat).to(tdt).contiguous(),
            torch.from_numpy(qs).to(tdt).contiguous(), getattr(jnp, dtype))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub,block,emit_width", [
    (16, 128, 0), (64, 128, 0), (16, 256, 128), (64, 256, 128),
])
def test_k1_plain_matches_pallas(kind, dtype, sub, block, emit_width):
    mat, qs, tmat, tqs, jdt = _inputs(kind, dtype, seed=sub + block)
    valid = 1000  # a padded tail, with a partially padded unit
    bms, key, bm = ref.matmul_blockmax2_only(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.int32(valid),
        interpret=True, sub=sub, block=block, emit_block=True,
        emit_argmax=True, emit_width=emit_width,
    )
    pbms, pkey, pbm = port.matmul_blockmax2_only(
        tqs, tmat, valid, sub=sub, block=block, emit_block=True,
        emit_argmax=True, emit_width=emit_width,
    )
    assert pbms.shape == bms.shape and pbm.shape == bm.shape
    assert pkey.dtype == torch.int32 and pkey.shape == key.shape
    if kind == "dyadic":
        np.testing.assert_array_equal(pbms.numpy(), _np(bms))
        np.testing.assert_array_equal(pkey.numpy(), _np(key))
        np.testing.assert_array_equal(pbm.numpy(), _np(bm))
        return
    np.testing.assert_allclose(pbms.numpy(), _np(bms), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pbm.numpy(), _np(bm), rtol=1e-5, atol=1e-6)
    sims = qs.astype(np.float64) @ mat.astype(np.float64).T
    sims[:, valid:] = port.PAD_SIM
    top2 = np.sort(sims.T.reshape(R // sub, sub, T), axis=1)[:, -2:, :]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal((pkey.numpy() & 0x7F)[clear],
                                  (_np(key) & 0x7F)[clear])


@pytest.mark.parametrize("emit_block,emit_argmax", [
    (False, False), (True, False), (False, True),
])
def test_k1_output_forms(emit_block, emit_argmax):
    """Output order (bm_sub, [key,] [bm]); a lone bm_sub comes back bare."""
    mat, qs, tmat, tqs, jdt = _inputs("dyadic", "float32", seed=5)
    ref_out = ref.matmul_blockmax2_only(
        jnp.asarray(qs), jnp.asarray(mat), jnp.int32(R), interpret=True,
        sub=16, block=128, emit_block=emit_block, emit_argmax=emit_argmax)
    out = port.matmul_blockmax2_only(
        tqs, tmat, R, sub=16, block=128, emit_block=emit_block,
        emit_argmax=emit_argmax)
    if not (emit_block or emit_argmax):
        np.testing.assert_array_equal(out.numpy(), _np(ref_out))
        return
    assert len(out) == len(ref_out) == 2
    for a, b in zip(out, ref_out):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("unit", [16, 64])
def test_k2_plain_matches_pallas(kind, dtype, unit):
    mat, qs, tmat, tqs, jdt = _inputs(kind, dtype, seed=unit, rows=2048)
    rng = np.random.default_rng(unit + 1)
    ks = 8
    ids = np.sort(rng.integers(0, 2048 // unit, size=(T, ks)), axis=1
                  ).astype(np.int32)
    out = ref.gather_rescore(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.asarray(ids),
        unit=unit, cpg=128 // unit, interpret=True)
    pout = port.gather_rescore(tqs, tmat, torch.from_numpy(ids), unit=unit)
    assert pout.shape == (T, ks * unit) and pout.dtype == torch.float32
    if kind == "dyadic":
        np.testing.assert_array_equal(pout.numpy(), _np(out))
    else:
        np.testing.assert_allclose(pout.numpy(), _np(out), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [R, 1000])
def test_k3_plain_matches_pallas(kind, dtype, valid):
    mat, qs, tmat, tqs, jdt = _inputs(kind, dtype, seed=valid)
    sims, bm_t = ref.matmul_blockmax(
        jnp.asarray(qs, jdt), jnp.asarray(mat, jdt), jnp.int32(valid),
        interpret=True, block=128)
    psims, pbm = port.matmul_blockmax(tqs, tmat, valid, block=128)
    assert psims.shape == sims.shape and pbm.shape == bm_t.shape
    if kind == "dyadic":
        np.testing.assert_array_equal(psims.numpy(), _np(sims))
        np.testing.assert_array_equal(pbm.numpy(), _np(bm_t))
    else:
        np.testing.assert_allclose(psims.numpy(), _np(sims), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(pbm.numpy(), _np(bm_t), rtol=1e-5,
                                   atol=1e-6)


def test_plain_kernels_agree_with_each_other():
    """On the CPU the plain K2 rescore of each unit's argmax row equals the
    plain K1 unit max, and plain K3's scores at those rows, bit for bit."""
    _, _, tmat, tqs, _ = _inputs("normal", "bfloat16", seed=11)
    sub = 64
    bms, key = port.matmul_blockmax2_only(tqs, tmat, R, sub=sub, block=128,
                                          emit_argmax=True)
    arg = (key & 0x7F).to(torch.int64).T                  # [T, units]
    units = torch.arange(R // sub).expand(T, -1)
    resc = port.gather_rescore(tqs, tmat, units.to(torch.int32).contiguous(),
                               unit=sub).view(T, R // sub, sub)
    at_arg = torch.gather(resc, 2, arg[:, :, None])[:, :, 0]
    assert torch.equal(at_arg, bms.T)
    sims, _ = port.matmul_blockmax(tqs, tmat, R)
    assert torch.equal(torch.gather(sims, 1, units * sub + arg), bms.T)


SPECIAL = np.array(
    [0.0, -0.0, port.PAD_SIM, 1.0, -1.0, np.nextafter(1, 2),
     np.nextafter(1, 0), np.nextafter(-1, 0), np.nextafter(-1, -2), 1e-30,
     -1e-30, 0.5, -0.5],
    dtype=np.float32,
)
# (No denormals: XLA's CPU backend flushes them to zero, torch does not; a
# denormal cosine score does not occur on normalized rows.)


def _key_inputs(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        SPECIAL, rng.standard_normal(4000).astype(np.float32),
        (1.0 + rng.standard_normal(1000) * 1e-6).astype(np.float32),
        (-1.0 + rng.standard_normal(1000) * 1e-6).astype(np.float32),
    ])
    arg = rng.integers(0, 128, size=x.shape).astype(np.int32)
    return x, arg


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_keys_match_reference_bitwise(seed):
    x, arg = _key_inputs(seed)
    np.testing.assert_array_equal(
        port.m2_sort_key(torch.from_numpy(x)).numpy(),
        _np(ref.m2_sort_key(jnp.asarray(x))))
    np.testing.assert_array_equal(
        port.pack_m2_argmax_key(torch.from_numpy(x),
                                torch.from_numpy(arg)).numpy(),
        _np(ref.pack_m2_argmax_key(jnp.asarray(x), jnp.asarray(arg))))


def test_sort_key_orders_like_floats():
    x, _ = _key_inputs(2)
    k = port.m2_sort_key(torch.from_numpy(x)).numpy().astype(np.int64)
    o = np.argsort(x, kind="stable")
    assert np.all(np.diff(k[o]) >= 0)
    assert k[0] == k[1]  # -0.0 folds into +0.0


@pytest.mark.parametrize("call", ["k1", "k2", "k3"])
def test_wrappers_refuse_bad_operands(call):
    """No silent fallback: a device the kernels do not serve, a dtype they
    do not take, or a geometry outside the tile raise."""
    q = torch.zeros((8, 64))
    s = torch.zeros((256, 64))
    ids = torch.zeros((8, 2), dtype=torch.int32)
    fn = {
        "k1": lambda q, s: port.matmul_blockmax2_only(q, s, 256, sub=16),
        "k2": lambda q, s: port.gather_rescore(q, s, ids, unit=16),
        "k3": lambda q, s: port.matmul_blockmax(q, s, 256),
    }[call]
    with pytest.raises(ValueError):
        fn(q.to("meta"), s.to("meta"))            # neither cpu nor cuda
    with pytest.raises(TypeError):
        fn(q.to(torch.float16), s.to(torch.float16))
    with pytest.raises(ValueError):
        fn(q, torch.zeros((200, 64)))             # rows not a tile multiple
    with pytest.raises(ValueError):
        fn(q, torch.zeros((256, 32)))             # dim mismatch
    with pytest.raises(ValueError):
        fn(q, s.T.contiguous().T)                 # not contiguous
