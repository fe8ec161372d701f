"""The port's flash attention (``ops/flash_kernels.py``: K14-K16's plain
versions, the autograd function, the encoder and the trainer with
``attention_impl="flash"``) against the library kernel the JAX package
calls, ``jax.experimental.pallas.ops.tpu.flash_attention``, run in
interpret mode on the CPU (``pltpu.force_tpu_interpret_mode()``, as
``tests/test_models.py`` runs it), on the same inputs from numpy seeds.
Interpret mode is slow (one ``jax.vjp`` is 5-8 s here), so each library
case runs once and its forward and gradients are reused.

Tolerances and why:
* forward ``o`` on every row, pad rows included: f32 max |diff| 1e-5 (the
  plain forward walks the library's 128-key blocks with its online
  softmax; sums in other orders, measured <= 6e-7); bf16 max |diff| 0.02
  and cosine 0.999 (K8's bound, ``tests/test_models.py:369-373``; the
  rounding points are the library's, measured <= 1e-3);
* gradients dq, dk, dv (the port's backward from the saved ``l``, ``m``
  against ``jax.vjp`` of the library): f32 max |diff| 1e-4 of the largest
  entry (measured <= 5e-7 of it), bf16 cosine 0.999;
* the encoder: per-row cosine of the embeddings above 0.99999 in f32 and
  0.999 in bf16 (the JAX test's own bar, ``test_models.py:277-302``);
  against the port's ``xla`` path, pooled embeddings (pad rows are
  discarded by the pooling; only there do the two differ) at 0.999;
* one trainer step in f32 against the JAX trainer's loss function: loss
  1e-4, every parameter's gradient at cosine 0.999999 (as
  ``tests/test_torch_train.py`` holds ``fused``).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxConfig,
    NomicBertModel as JaxModel,
    NomicEncoder as JaxEncoder,
    finalize_embeddings as jax_finalize,
    mean_pool as jax_mean_pool,
)
from better_search_rag_rust_tpu.models.train import (
    ContrastiveTrainer as JaxTrainer,
    info_nce_loss as jax_info_nce_loss,
)
from better_search_rag_rust_tpu.parallel import create_mesh as jax_mesh
from better_search_rag_rust_tpu_torch.models.nomic import (
    NomicBertConfig,
    NomicEncoder,
    mesh_attention_impl,
    params_from_flax,
)
from better_search_rag_rust_tpu_torch.models.train import ContrastiveTrainer
from better_search_rag_rust_tpu_torch.ops import _build
from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk
from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh

#: name -> (dtype, [B, H, S, hd], real tokens of each batch row or None)
CASES = {
    "f32_s128_hd16": ("float32", (2, 2, 128, 16), None),
    "f32_s256_hd64_padded": ("float32", (2, 4, 256, 64), (70, 200)),
    "bf16_s128_hd16_padded": ("bfloat16", (2, 4, 128, 16), (70, 128)),
    "bf16_s256_hd64": ("bfloat16", (2, 2, 256, 64), None),
    "bf16_s256_hd64_padded": ("bfloat16", (2, 2, 256, 64), (70, 200)),
}
#: the encoder's and the trainer's small model (S a multiple of the
#: library's 128-token blocks)
SMALL = dict(vocab_size=211, hidden_size=64, num_layers=2, num_heads=4,
             mlp_dim=128, max_tokens=128)


def _mask(b, s, lens):
    """``[B, S]`` int32: 1 on each row's first ``lens[i]`` tokens."""
    mask = np.ones((b, s), np.int32)
    for i, n in enumerate(lens or ()):
        mask[i, n:] = 0
    return mask


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs of a case (numpy, rounded to its dtype) and the library's
    ``o`` and ``(dq, dk, dv)`` from one ``jax.vjp`` in interpret mode."""
    dtype, (b, h, s, hd), lens = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    jd = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(rng.standard_normal((b, h, s, hd)),
                               jnp.float32).astype(jd) for _ in range(4))
    seg = _mask(b, s, lens)
    ids = lib.SegmentIds(jnp.asarray(seg), jnp.asarray(seg))
    scale = 1.0 / math.sqrt(hd)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, c, e: lib.flash_attention(
            a, c, e, segment_ids=ids, sm_scale=scale), q, k, v)
        grads = vjp(do)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return dict(dtype=getattr(torch, dtype), inputs=[f32(x) for x in
                                                    (q, k, v, do)],
                seg=seg, scale=scale, o=f32(o), grads=[f32(x) for x in grads])


def _torch(case, requires_grad=False):
    q, k, v, do = (torch.from_numpy(np.array(x)).to(case["dtype"])
                   for x in case["inputs"])
    for t in (q, k, v):
        t.requires_grad_(requires_grad)
    seg = torch.from_numpy(case["seg"])
    return q, k, v, do, fk.SegmentIds(seg, seg)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_library(name):
    """Plain K14 and the public function against the library's ``o`` on
    every row (a pad query attends among pads only, in both)."""
    case = _case(name)
    q, k, v, _do, ids = _torch(case)
    o, l, m = fk.flash_attention_fwd_plain(q, k, v, ids.q, ids.kv,
                                           case["scale"])
    for got in (o, fk.flash_attention(q, k, v, ids, case["scale"])):
        got = got.float().numpy()
        assert np.isfinite(got).all()
        err = np.abs(got - case["o"]).max()
        if case["dtype"] == torch.float32:
            assert err <= 1e-5, err
        else:
            assert err < 0.02 and _cos(got, case["o"]) > 0.999, err
    b, h, s, _ = q.shape
    assert l.shape == m.shape == (b, h, s) and l.dtype == torch.float32
    assert bool((l >= 1.0).all())     # the max's own key adds exp(0) = 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_library(name):
    """:class:`FlashAttention`'s backward on the CPU (di in torch, then
    plain K15 and plain K16 from the saved ``l`` and ``m``) against
    ``jax.vjp`` of the library on the same upstream gradient."""
    case = _case(name)
    q, k, v, do, ids = _torch(case, requires_grad=True)
    fk.flash_attention(q, k, v, ids, case["scale"]).backward(do)
    for got, want in zip((q.grad, k.grad, v.grad), case["grads"]):
        assert got.dtype == case["dtype"]
        got = got.float().numpy()
        assert np.isfinite(got).all()
        if case["dtype"] == torch.float32:
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        else:
            assert _cos(got, want) > 0.999


def test_backward_is_the_plain_backward_on_the_saved_residuals():
    """The autograd function's backward is ``flash_attention_bwd_plain``
    on the forward's ``o, l, m`` bit for bit (no autograd of the plain
    forward on the CPU), and K15 / K16's plain versions are its parts."""
    case = _case("bf16_s256_hd64_padded")
    q, k, v, do, ids = _torch(case, requires_grad=True)
    fk.flash_attention(q, k, v, ids, case["scale"]).backward(do)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, l, m = fk.flash_attention_fwd_plain(qd, kd, vd, ids.q, ids.kv,
                                           case["scale"])
    want = fk.flash_attention_bwd_plain(qd, kd, vd, ids, o, l, m, do,
                                        case["scale"])
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert torch.equal(got, w)
    di = (o.float() * do.float()).sum(-1)
    dk, dv = fk.flash_attention_bwd_dkv(qd, kd, vd, ids.q, ids.kv, l, m, do,
                                        di, case["scale"])
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax_flash_encoder(dtype):
    """``NomicEncoder`` with ``attention_impl="flash"`` on the JAX flash
    encoder's weights (``params_from_flax``) against it in interpret mode,
    padded rows included; and against the port's own ``xla`` path on the
    same weights, whose pad queries attend to real keys: pooled embeddings
    only."""
    jd = jnp.dtype(dtype)
    jx = JaxEncoder(JaxConfig(dtype=jd, attention_impl="xla", **SMALL), seed=3)
    jf = JaxEncoder(JaxConfig(dtype=jd, attention_impl="flash", **SMALL),
                    params=jx.params)
    s = SMALL["max_tokens"]
    rng = np.random.default_rng(5)
    ids = rng.integers(3, SMALL["vocab_size"], size=(4, s)).astype(np.int32)
    mask = _mask(4, s, (s, 70, 5, 100))
    with pltpu.force_tpu_interpret_mode():
        want = jf.encode_tokens(ids, mask)
    sd = params_from_flax(jax.tree.map(np.asarray, jx.params))
    cfg = NomicBertConfig(dtype=getattr(torch, dtype), attention_impl="flash",
                          **SMALL)
    enc = NomicEncoder(cfg, state_dict=sd, device="cpu")
    got = enc.encode_tokens(ids, mask)
    assert got.shape == want.shape and np.isfinite(got).all()
    rows = np.sum(got * want, axis=1)
    assert rows.min() > (0.99999 if dtype == "float32" else 0.999), rows
    xla = NomicEncoder(dataclasses.replace(cfg, attention_impl="xla"),
                       state_dict=sd, device="cpu").encode_tokens(ids, mask)
    assert np.sum(got * xla, axis=1).min() > 0.999


def test_trainer_step_matches_jax_flash_step():
    """One ``ContrastiveTrainer`` step with flash (K14 forward, plain K15 +
    K16 backward on the CPU) in f32: the first loss and every parameter's
    gradient against the JAX trainer's loss function through the library
    kernel's custom VJP in interpret mode, the same weights and pairs."""
    small = dict(SMALL, num_layers=1)
    jcfg = JaxConfig(dtype=jnp.float32, attention_impl="flash", **small)
    s = small["max_tokens"]
    params = JaxModel(dataclasses.replace(jcfg, attention_impl="xla")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
        jnp.ones((1, s), jnp.int32))["params"]
    rng = np.random.default_rng(11)
    a, p = (rng.integers(1, small["vocab_size"], size=(4, s)).astype(np.int32)
            for _ in range(2))
    am, pm = _mask(4, s, (s, 90)), _mask(4, s, (s, s, 20))
    model = JaxModel(jcfg)

    def loss_fn(prm):
        towers = []
        for ids, mask in ((a, am), (p, pm)):
            hidden = model.apply({"params": prm}, jnp.asarray(ids),
                                 jnp.asarray(mask))
            towers.append(jax_finalize(jax_mean_pool(hidden,
                                                     jnp.asarray(mask))))
        return jax_info_nce_loss(*towers, 0.05)

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_flax(jax.tree.map(np.asarray, want))
    tr = ContrastiveTrainer(
        NomicBertConfig(dtype=torch.float32, attention_impl="flash", **small),
        params=params_from_flax(jax.tree.map(np.asarray, params)),
        device="cpu")
    loss = float(tr.backward(a, am, p, pm))
    assert abs(loss - float(want_loss)) <= 1e-4, (loss, float(want_loss))
    checked = 0
    for name, prm in tr.model.named_parameters():
        x, y = prm.grad.double().ravel(), want[name].double().ravel()
        if float(y.norm()) == 0.0:           # the unused token-type row
            assert float(x.norm()) == 0.0, name
            continue
        assert float(x @ y / (x.norm() * y.norm())) > 0.999999, name
        checked += 1
    assert checked > 10


@pytest.mark.parametrize("q_shape,kv_shape,seg_shapes", [
    ((2, 2, 200, 16), (2, 2, 200, 16), None),       # kv not in 128 blocks
    ((2, 2, 64, 16), (2, 2, 64, 16), None),         # q under one block
    ((2, 2, 128, 16), (2, 2, 128, 32), None),       # q and k widths differ
    ((2, 2, 128, 16), (3, 2, 128, 16), None),       # batch mismatch
    ((2, 2, 128, 16), (2, 2, 128, 16), ((2, 64), (2, 128))),
    ((1, 1, 256, 192), (1, 1, 256, 192), None),     # wide head, not x128
])
def test_refuses_what_the_library_refuses(q_shape, kv_shape, seg_shapes):
    """Shapes the library refuses raise the same exception type and
    message here (its checks run while it traces, before any kernel)."""
    q = np.zeros(q_shape, np.float32)
    kv = np.zeros(kv_shape, np.float32)
    segs = None
    if seg_shapes:
        segs = [np.zeros(sh, np.int32) for sh in seg_shapes]
    with pytest.raises((ValueError, NotImplementedError)) as want:
        with pltpu.force_tpu_interpret_mode():
            lib.flash_attention(
                jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                segment_ids=None if segs is None else lib.SegmentIds(
                    *map(jnp.asarray, segs)))
    tsegs = None if segs is None else fk.SegmentIds(
        *map(torch.from_numpy, segs))
    with pytest.raises(want.type) as got:
        fk.flash_attention(torch.from_numpy(q), torch.from_numpy(kv),
                           torch.from_numpy(kv), tsegs)
    assert str(got.value) == str(want.value)


def test_backward_refuses_ragged_queries_as_the_library_does():
    """Sq 200 against Sk 256 runs forward in both; the backward's query
    blocks of 128 refuse it, with the library's message."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 1, 200, 16)).astype(np.float32)
    kv = rng.standard_normal((1, 1, 256, 16)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda a, b, c: lib.flash_attention(a, b, c),
                         jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
        with pytest.raises(ValueError) as want:
            vjp(jnp.ones_like(o))
    tq = torch.from_numpy(q).requires_grad_()
    out = fk.flash_attention(tq, torch.from_numpy(kv), torch.from_numpy(kv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError) as got:
        out.sum().backward()
    assert str(got.value) == str(want.value)


def test_wrapper_guards(monkeypatch):
    """CPU tensors take the plain versions and never reach the kernel
    library (any head width, f32 too); the kernels' own guards refuse a
    dtype, a head width and a layout they do not take."""
    def no_library(*_a, **_k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 128, 48)).astype(
        np.float32)).requires_grad_()
    fk.reset_launch_counts()
    out = fk.flash_attention(q, q, q, sm_scale=0.5)
    out.sum().backward()
    assert torch.isfinite(q.grad).all()
    assert fk.launch_counts == dict.fromkeys(fk.launch_counts, 0)
    bf = torch.zeros((1, 2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        fk._check_kernel("K14", bf.float(), bf.float(), bf.float())
    with pytest.raises(ValueError, match="head dims"):
        wide = torch.zeros((1, 2, 128, 48), dtype=torch.bfloat16)
        fk._check_kernel("K14", wide, wide, wide)
    with pytest.raises(ValueError, match="contiguous"):
        fk._check_kernel("K15", bf, bf.transpose(1, 2).contiguous()
                         .transpose(1, 2), bf, bf)
    fk._check_kernel("K16", bf, bf, bf, bf)


def test_flash_refuses_a_mesh_as_the_jax_package_does():
    """The JAX trainer's flash step fails on a 2 x 1 and a 1 x 2 mesh (the
    partitioner cannot split the library's ``pallas_call``; in interpret
    mode it raises at the first step), and so does the JAX encoder over a
    data mesh of 2; the port refuses both meshes when it builds the
    trainer or the encoder, and one device takes flash."""
    small = dict(SMALL, num_layers=1)
    jcfg = JaxConfig(dtype=jnp.float32, attention_impl="flash", **small)
    s = small["max_tokens"]
    params = JaxModel(dataclasses.replace(jcfg, attention_impl="xla")).init(
        jax.random.PRNGKey(0), jnp.zeros((1, s), jnp.int32),
        jnp.ones((1, s), jnp.int32))["params"]
    ids = np.ones((4, s), np.int32)
    mask = _mask(4, s, (s, 40))
    cfg = NomicBertConfig(dtype=torch.float32, attention_impl="flash", **small)
    for shape in ((2, 1), (1, 2)):
        mesh = jax_mesh(shape=shape, axis_names=("data", "model"),
                        devices=jax.devices()[:2])
        jt = JaxTrainer(jcfg, mesh, params=jax.tree.map(np.array, params))
        assert jt.config.attention_impl == "flash"
        with pytest.raises(jax.errors.JaxRuntimeError, match="sharding"):
            with pltpu.force_tpu_interpret_mode():
                jt.train_step(ids, mask, ids, mask)
        with pytest.raises(NotImplementedError, match="flash"):
            mesh_attention_impl("flash", cfg, *shape)
        with pytest.raises(NotImplementedError, match="flash"):
            ContrastiveTrainer(cfg, mesh=create_mesh(
                shape, ("data", "model"), devices=["cpu", "cpu"]))
    jenc = JaxEncoder(jcfg, params=params, mesh=jax_mesh(
        shape=(2,), axis_names=("data",), devices=jax.devices()[:2]))
    with pytest.raises(jax.errors.JaxRuntimeError, match="sharding"):
        with pltpu.force_tpu_interpret_mode():
            jenc.encode_tokens(ids, mask)
    with pytest.raises(NotImplementedError, match="flash"):
        NomicEncoder(cfg, mesh=create_mesh(devices=["cpu", "cpu"]))
    assert mesh_attention_impl("flash", cfg, 1, 1) == "flash"
    tr = ContrastiveTrainer(cfg, device="cpu", mesh=create_mesh(
        (1, 1), ("data", "model"), devices=["cpu"]))
    assert tr.config.attention_impl == "flash"
    assert math.isfinite(float(tr.backward(ids, mask, ids, mask)))
