"""K18/K18b (residual add + LayerNorm) and K19/K19b (the MLP gate) on the
CPU: the plain versions against the JAX package's flax LayerNorm and
``y * jax.nn.silu(gate)`` / ``jax.nn.gelu(approximate=False)``, forward and
``jax.grad``, on the same inputs (numpy seeds); the plain versions' sum
order against a numpy emulation of the kernels'; ``gradcheck`` in float64;
the model's every norm and gate through the autograd Functions, none of
them counted as a kernel launch on the CPU; a checkpoint of the eager glue.

Tolerances and why (measured values in brackets):
* K18 forward against flax on ``(x + r).astype(f32)``: bf16 within one
  bf16 ulp, ``|d| <= 2^-7 |y|`` (the two f32 results differ in the last
  bits, from other sum orders) [<= 0.0057 |y|]; f32 ``|d| <= 2^-20 (|y| +
  1)`` [<= 2.3e-7 (|y| + 1)]; a constant row is beta in both, bit for bit;
  a row with a NaN, an inf or inf - inf is NaN throughout in both;
* rows of mean >> std: flax's fast variance ``E[s^2] - E[s]^2`` cancels,
  losing about ``2 log2(mean / std)`` bits of the f32 sums, which the two
  packages take in other orders. A row of mean/std = 32 (10 bits lost) is
  held to ``2^-7 (|y| + 1)`` in bf16 [<= 0.0038 (|y| + 1)] and ``2^-11
  (|y| + 1)`` in f32 [<= 1.2e-4 (|y| + 1)]; past mean/std ~ 2^8 the two
  disagree by any amount (v may clip to 0 in one and not the other: the
  formula's, not a fault of either), so such rows are held to a numpy
  emulation of the kernels' order, bit for bit, and not to JAX;
* K18 gradients against ``jax.grad``: ``ds`` (the gradient of x and of r,
  equal in both packages) bf16 ``|d| <= 2^-7 |g| + 2^-12 max |g|`` [one
  ulp plus <= 1.8e-7 of the max], f32 ``2^-11 max |g|`` [<= 7.8e-5, from
  the mean/std = 32 row]; the constant row's (``rstd = 1/sqrt(eps)``)
  within one bf16 ulp [0] or ``2^-20`` of its max in f32 [<= 1.8e-7];
  ``dgamma`` ``2^-12`` of its max [<= 3.5e-5], ``dbeta`` (sums of the same
  ``dy`` in other orders) ``2^-20`` of its max [<= 2.3e-7];
* K19 forward against ``y * jax.nn.silu(gate)``: bf16 ``|d| <= 2^-6 |y|``
  (two bf16 ulps: JAX rounds silu's product to bf16, torch its f32 value
  once) [<= 1.9 ulps], f32 ``2^-21 |y|`` [<= 1.9 ulps of f32]; gelu:
  ``2^-7 |y| + 2^-8 max |y|`` in bf16 (JAX's bf16 erf) [<= 0.016 at max
  ~12], f32 ``2^-20 max |y|``;
* K19 gradients: ``da`` as the forward; ``dg`` ``2^-6 max |dg|`` in bf16
  (silu's derivative is rounded at each step in JAX, once in torch; it
  cancels near g ~ -1.28, so no relative bound holds) [<= 0.0102], f32
  ``2^-20 max |dg|`` [<= 1.3e-7];
* ``gradcheck`` in float64: torch's defaults (eps 1e-6, atol 1e-5, rtol
  1e-3);
* the plain versions' order against numpy: bit for bit;
* a checkpoint saved by the parent's eager glue (torch's LayerNorm, silu
  and multiply) and loaded into the port: f32 embeddings within 1e-5 of
  the eager glue's [the two LayerNorm formulas differ in the last bits],
  bf16 at cosine >= 0.999 per row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

import chip_smoke
from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxConfig,
    NomicEncoder as JaxEncoder,
)
from better_search_rag_rust_tpu_torch.models import nomic
from better_search_rag_rust_tpu_torch.models.checkpoint import (
    load_params,
    save_params,
)
from better_search_rag_rust_tpu_torch.models.nomic import (
    NomicBertConfig,
    NomicEncoder,
    params_from_flax,
)
from better_search_rag_rust_tpu_torch.models.train import ContrastiveTrainer
from better_search_rag_rust_tpu_torch.ops import encoder_kernels as ek

EPS = 1e-12
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}
DIMS = [768, 100, 33, 300, 1024]


def _to_torch(a, tdt):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t).astype(jnp.float32))


def _norm_operands(d, n=64, seed=0, edges=True):
    """x, r [n, d] f32 (row 0 constant, row 1 of mean/std = 32, rows 2-4
    with NaN, +inf and inf - inf entries), gamma, beta [d], dy [n, d]."""
    rng = np.random.default_rng(seed + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    r = rng.standard_normal((n, d)).astype(np.float32)
    if edges:
        x[0], r[0] = 3.0, 0.0
        x[1], r[1] = 64.0 + 2.0 * rng.standard_normal(d), 0.0
        x[2, ::7] = np.nan
        x[3, d // 2] = np.inf
        x[4, 0], r[4, 0] = np.inf, -np.inf
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    return x, r, gamma, beta, dy


def _flax_norm(gamma, beta, jdt):
    """flax's LayerNorm on ``(x + r).astype(f32)``, rounded to ``jdt``: the
    JAX package's ``norm1``/``norm2``/``emb_norm`` (``models/nomic.py``)."""
    ln = fnn.LayerNorm(epsilon=EPS, dtype=jnp.float32)
    params = {"params": {"scale": jnp.asarray(gamma),
                         "bias": jnp.asarray(beta)}}

    def f(p, x, r):
        return ln.apply(p, (x + r).astype(jnp.float32)).astype(jdt)

    return f, params


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_add_layer_norm_plain_matches_flax(dtype, d):
    jdt, tdt = DTYPES[dtype]
    x, r, gamma, beta, _dy = _norm_operands(d)
    xj, rj = jnp.asarray(x).astype(jdt), jnp.asarray(r).astype(jdt)
    f, params = _flax_norm(gamma, beta, jdt)
    want = _np(f(params, xj, rj))
    got = _np(ek.add_layer_norm_plain(_to_torch(xj, tdt), _to_torch(rj, tdt),
                                      torch.from_numpy(gamma),
                                      torch.from_numpy(beta), EPS))
    diff = np.abs(got - want)
    if dtype == "bfloat16":
        ok = diff <= 2**-7 * np.abs(want)
        ok_row1 = diff <= 2**-7 * (np.abs(want) + 1)
    else:
        ok = diff <= 2**-20 * (np.abs(want) + 1)
        ok_row1 = diff <= 2**-11 * (np.abs(want) + 1)
    np.testing.assert_array_equal(got[0], beta.astype(jdt).astype(np.float32))
    np.testing.assert_array_equal(want[0], got[0])   # a constant row: beta
    assert ok_row1[1].all()
    for row in (2, 3, 4):                            # NaN / inf rows: all NaN
        assert np.isnan(got[row]).all() and np.isnan(want[row]).all()
    assert ok[5:].all(), diff[5:].max()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
def test_add_layer_norm_grads_match_jax(dtype, d):
    """ds (x's and r's), dgamma and dbeta of the plain backward against
    ``jax.grad`` of the flax chain, on finite rows with a constant row and
    a row of mean/std = 32."""
    jdt, tdt = DTYPES[dtype]
    x, r, gamma, beta, dy = _norm_operands(d, edges=False)
    x[0], r[0] = 3.0, 0.0
    x[1], r[1] = 64.0 + 2.0 * np.random.default_rng(d).standard_normal(d), 0
    xj, rj, dyj = (jnp.asarray(t).astype(jdt) for t in (x, r, dy))
    f, params = _flax_norm(gamma, beta, jdt)

    def loss(p, a, b):
        return jnp.sum(f(p, a, b).astype(jnp.float32) * dyj.astype(jnp.float32))

    gp, gx, gr = jax.grad(loss, argnums=(0, 1, 2))(params, xj, rj)
    ds, dgamma, dbeta = ek.add_layer_norm_bwd_plain(
        _to_torch(dyj, tdt), _to_torch(xj, tdt), _to_torch(rj, tdt),
        torch.from_numpy(gamma), EPS)
    want = _np(gx)
    np.testing.assert_array_equal(want, _np(gr))
    assert ds.dtype == tdt and dgamma.dtype == dbeta.dtype == torch.float32
    got, diff = _np(ds), np.abs(_np(ds) - want)
    top = np.abs(want[1:]).max()
    if dtype == "bfloat16":
        bound = 2**-7 * np.abs(want[1:]) + 2**-12 * top
        bound0 = 2**-7 * np.abs(want[0])
    else:
        bound = 2**-11 * top
        bound0 = 2**-20 * np.abs(want[0]).max()
    assert (diff[1:] <= bound).all(), diff[1:].max() / top
    # the constant row: ds = rstd * (g - mean(g)) with rstd = 1/sqrt(eps)
    assert (diff[0] <= bound0).all()
    for g_, w_, frac in ((dgamma, gp["params"]["scale"], 2**-12),
                         (dbeta, gp["params"]["bias"], 2**-20)):
        w_ = np.asarray(w_)
        assert np.abs(g_.numpy() - w_).max() <= frac * np.abs(w_).max()


def test_var_factor_is_jax_max_derivative():
    """K18b's ``vfac`` (d var / d v of flax's ``max(0, v)``) is jax's own:
    0 where v < 0, 1/2 at v == 0, 1 where v > 0."""
    grad = jax.grad(lambda v: jnp.maximum(0.0, v))
    assert [float(grad(v)) for v in (-1.0, 0.0, 1.0)] == [0.0, 0.5, 1.0]
    # rows whose v is < 0, == 0 and > 0 in the kernels' order (found below)
    rows = torch.from_numpy(_clip_rows())
    _, _, _, vfac = ek._row_stats(rows, torch.zeros_like(rows), EPS)
    assert vfac.ravel().tolist() == [0.0, 0.5, 1.0]


def _np_lane_sums(v):
    """THE LANE ORDER in numpy f32, lane by lane: the reference the plain
    version is held to."""
    n, d = v.shape
    out = np.zeros(n, np.float32)
    for i in range(n):
        lanes = np.zeros(32, np.float32)
        for lane in range(32):
            acc = np.float32(0)
            for c0 in range(0, d, 256):
                for j in range(8):
                    f = c0 + 8 * lane + j
                    if f < d:
                        acc = np.float32(acc + v[i, f])
            lanes[lane] = acc
        h = 16
        while h:
            lanes[:h] = (lanes[:h] + lanes[h:2 * h]).astype(np.float32)
            h //= 2
        out[i] = lanes[0]
    return out


def _np_row_stats(s, eps):
    d = np.float32(s.shape[1])
    mean = np.float32(_np_lane_sums(s) / d)
    v = (_np_lane_sums((s * s).astype(np.float32)) / d
         - (mean * mean).astype(np.float32)).astype(np.float32)
    var = np.where(v < 0, np.float32(0), v).astype(np.float32)
    root = np.sqrt((var + np.float32(eps)).astype(np.float64)).astype(np.float32)
    return mean, v, (np.float32(1) / root).astype(np.float32)


def _clip_rows():
    """Three f32 rows of 768 whose v in the kernels' order is < 0, == 0 and
    > 0 (found with the numpy emulation among rows of mean >> std: ``c (1 +
    1e-6 z)``), as ``[3, 768]`` f32."""
    rng = np.random.default_rng(11)
    found = {}
    while len(found) < 3:
        c = np.float32(rng.uniform(100, 10000))
        row = (c + c * np.float32(1e-6) * rng.standard_normal(768)
               ).astype(np.float32)
        _mean, v, _rstd = _np_row_stats(row[None], EPS)
        found.setdefault(int(np.sign(v[0])), row)
    return np.stack([found[-1], found[0], found[1]])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [768, 100, 33, 1024])
def test_plain_norm_sums_in_the_kernels_order(d, dtype):
    """The plain K18 output and K18b's ds are bit for bit a numpy f32
    emulation of the kernels' order (lane by lane, then the halving), on
    finite rows and (f32, D 768) on rows of mean >> std whose fast variance
    cancels to v < 0 (clipped), v == 0 and v > 0."""
    tdt = DTYPES[dtype][1]
    x, r, gamma, beta, dy = _norm_operands(d, n=6, edges=False)
    if d == 768 and dtype == "float32":
        x[:3], r[:3] = _clip_rows(), 0.0
    xt, rt, dyt = (torch.from_numpy(t).to(tdt) for t in (x, r, dy))
    s = (xt + rt).float().numpy()
    mean, v, rstd = _np_row_stats(s, EPS)
    if d == 768 and dtype == "float32":
        assert np.sign(v[:3]).tolist() == [-1, 0, 1]
    y = ((s - mean[:, None]) * (rstd[:, None] * gamma) + beta).astype(np.float32)
    got = ek.add_layer_norm_plain(xt, rt, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), EPS)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(y).to(tdt).float().numpy())
    dyf = dyt.float().numpy()
    xh = ((s - mean[:, None]) * rstd[:, None]).astype(np.float32)
    g = (dyf * gamma).astype(np.float32)
    vfac = np.where(v > 0, 1.0, np.where(v == 0, 0.5, 0.0)).astype(np.float32)
    mg = (_np_lane_sums(g) / np.float32(d)).astype(np.float32)
    mgx = ((_np_lane_sums((g * xh).astype(np.float32)) / np.float32(d))
           .astype(np.float32) * vfac).astype(np.float32)
    want = (rstd[:, None] * ((g - mg[:, None]).astype(np.float32)
                             - (xh * mgx[:, None]).astype(np.float32))
            ).astype(np.float32)
    ds, _dg, _db = ek.add_layer_norm_bwd_plain(dyt, xt, rt,
                                               torch.from_numpy(gamma), EPS)
    np.testing.assert_array_equal(
        ds.float().numpy(), torch.from_numpy(want).to(tdt).float().numpy())


@pytest.mark.parametrize("n", [1, 9, 64, 2111, 2113, 5000])
def test_column_sums_follow_the_block_order(n):
    """``dgamma``/``dbeta``'s order: warp w of 8 G adds rows w, w + 8 G, ...;
    a block's partial is warp 0 plus warps 1-7 in turn; the total +0.0 plus
    the partials — bit for bit a numpy f32 emulation, and no atomics to
    make two runs differ."""
    rng = np.random.default_rng(n)
    t = rng.standard_normal((n, 5)).astype(np.float32) * np.float32(1e3)
    blocks = ek.k18b_blocks(n)
    assert blocks == min(-(-n // 8), 264)
    w = 8 * blocks
    warps = np.zeros((w, 5), np.float32)
    for row in range(n):
        warps[row % w] = (warps[row % w] + t[row]).astype(np.float32)
    total = np.zeros(5, np.float32)
    for b in range(blocks):
        part = warps[8 * b].copy()
        for k in range(1, 8):
            part = (part + warps[8 * b + k]).astype(np.float32)
        total = (total + part).astype(np.float32)
    got = ek.column_sums(torch.from_numpy(t))
    np.testing.assert_array_equal(got.numpy(), total)
    assert torch.equal(got, ek.column_sums(torch.from_numpy(t)))


SILU_OR_GELU = {"swiglu": lambda a, g: a * jax.nn.silu(g),
                "gelu": lambda a, g: jax.nn.gelu(g, approximate=False)}


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_plain_and_grads_match_jax(dtype, activation):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    a, g = (3.0 * rng.standard_normal((2, 64, 200))).astype(np.float32)
    dy = rng.standard_normal((64, 200)).astype(np.float32)
    aj, gj, dyj = (jnp.asarray(t).astype(jdt) for t in (a, g, dy))
    at, gt, dyt = (_to_torch(t, tdt) for t in (aj, gj, dyj))
    fj = SILU_OR_GELU[activation]
    want, got = _np(fj(aj, gj)), _np(ek.swiglu_plain(at, gt, activation))
    bf16 = dtype == "bfloat16"
    if activation == "swiglu":
        bound = (2**-6 if bf16 else 2**-21) * np.abs(want)
    else:
        top = np.abs(want).max()
        bound = 2**-7 * np.abs(want) + 2**-8 * top if bf16 else 2**-20 * top
    assert (np.abs(got - want) <= bound).all()

    def loss(a_, g_):
        return jnp.sum(fj(a_, g_).astype(jnp.float32) * dyj.astype(jnp.float32))

    ja, jg = jax.grad(loss, argnums=(0, 1))(aj, gj)
    da, dg = ek.swiglu_bwd_plain(dyt, at, gt, activation)
    assert (da is None) == (activation == "gelu")
    if da is not None:
        w = _np(ja)
        assert (np.abs(_np(da) - w) <= (2**-6 if bf16 else 2**-21) * np.abs(w)
                ).all()
    w = _np(jg)
    frac = 2**-6 if bf16 else 2**-20
    assert np.abs(_np(dg) - w).max() <= frac * np.abs(w).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_plain_is_the_eager_chain_and_its_autograd(dtype):
    """Plain K19/K19b are torch's own ops: ``a * F.silu(g)`` and autograd's
    gradients of it, bit for bit (NaN and inf gates included)."""
    tdt = DTYPES[dtype][1]
    gen = torch.Generator().manual_seed(0)
    a = (3 * torch.randn(50, 70, generator=gen)).to(tdt).requires_grad_()
    g = (3 * torch.randn(50, 70, generator=gen)).to(tdt)
    g[0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0])
    g.requires_grad_()
    dy = torch.randn(50, 70, generator=gen).to(tdt)
    y = a * F.silu(g)
    ga, gg = torch.autograd.grad(y, (a, g), dy)
    assert torch.equal(ek.swiglu_plain(a, g).view(-1).float().nan_to_num(),
                       y.view(-1).float().nan_to_num())
    da, dg = ek.swiglu_bwd_plain(dy, a.detach(), g.detach())
    for u, v in ((da, ga), (dg, gg)):
        assert torch.equal(u.float().nan_to_num(), v.float().nan_to_num())
        assert torch.equal(u.isnan(), v.isnan())


@pytest.mark.parametrize("rows,d", [(15, 19), (2, 260)])  # 260: two chunks
def test_add_layer_norm_gradcheck(rows, d):
    gen = torch.Generator().manual_seed(d)
    args = [torch.randn(shape, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for shape in ((1, rows, d), (1, rows, d), (d,), (d,))]
    assert torch.autograd.gradcheck(
        lambda x, r, g, b: ek.AddLayerNorm.apply(x, r, g, b, 1e-5), args)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_swiglu_gradcheck(activation):
    gen = torch.Generator().manual_seed(1)
    a, g = (torch.randn((4, 7, 9), generator=gen, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    if activation == "gelu":
        assert torch.autograd.gradcheck(
            lambda g_: ek.SwiGlu.apply(None, g_, "gelu"), (g,))
    else:
        assert torch.autograd.gradcheck(
            lambda a_, g_: ek.SwiGlu.apply(a_, g_, "swiglu"), (a, g))


TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
            mlp_dim=64, max_tokens=16)


def _batch(seed=0, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, TINY["vocab_size"], size=(b, TINY["max_tokens"]))
    mask = (np.arange(TINY["max_tokens"])[None, :]
            < rng.integers(4, TINY["max_tokens"] + 1, size=b)[:, None])
    return ids, mask.astype(np.int64)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_model_runs_every_norm_and_gate_through_the_functions(monkeypatch,
                                                              activation):
    """On the CPU a training loss's forward and backward call the plain
    versions through the Functions once per norm (2 a layer and emb_ln)
    and per gate, both towers, and count no kernel launch."""
    calls = dict.fromkeys(("norm", "norm_bwd", "gate", "gate_bwd"), 0)
    for key, name in (("norm", "add_layer_norm_plain"),
                      ("norm_bwd", "add_layer_norm_bwd_plain"),
                      ("gate", "swiglu_plain"), ("gate_bwd", "swiglu_bwd_plain")):
        fn = getattr(ek, name)

        def spy(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ek, name, spy)
    ek.reset_launch_counts()
    tr = ContrastiveTrainer(NomicBertConfig(activation=activation, **TINY),
                            seed=0, device="cpu")
    ids, mask = _batch()
    tr.backward(ids, mask, ids[::-1].copy(), mask[::-1].copy())
    layers = TINY["num_layers"]
    assert calls == {"norm": 2 * (2 * layers + 1),
                     "norm_bwd": 2 * (2 * layers + 1),
                     "gate": 2 * layers, "gate_bwd": 2 * layers}
    assert not any(ek.launch_counts.values())


def test_gelu_model_matches_jax():
    """The slice as a whole with ``activation="gelu"`` (the JAX package's
    other MLP): the port's encoder on JAX's weights, f32 ``xla``, within the
    f32 parity bound of ``tests/test_torch_nomic.py`` (atol 5e-4)."""
    cfg = dict(TINY, max_tokens=16)
    jenc = JaxEncoder(JaxConfig(dtype=jnp.float32, attention_impl="xla",
                                activation="gelu", **cfg), seed=2)
    sd = params_from_flax(jax.tree.map(np.asarray, jenc.params))
    penc = NomicEncoder(NomicBertConfig(dtype=torch.float32,
                                        attention_impl="xla",
                                        activation="gelu", **cfg),
                        state_dict=sd, device="cpu")
    ids, mask = _batch(seed=4)
    want = np.asarray(jenc.encode_tokens(ids.astype(np.int32),
                                         mask.astype(np.int32)))
    got = penc.encode_tokens(ids, mask)
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoint_of_the_eager_glue_loads_and_embeds_alike(tmp_path, dtype):
    """Parameter names and layout are unchanged: a checkpoint that a
    trainer on the eager glue saved (two steps taken) loads into the port's
    encoder, whose embeddings agree with the eager glue's on the same
    weights."""
    tdt = DTYPES[dtype][1]
    cfg = NomicBertConfig(dtype=tdt, attention_impl="xla", **TINY)
    ids, mask = _batch(seed=1, b=4)
    with chip_smoke.parents_glue():
        tr = ContrastiveTrainer(cfg, seed=3, device="cpu")
        for _ in range(2):
            tr.train_step(ids, mask, ids[::-1].copy(), mask[::-1].copy())
        save_params(tmp_path / "ckpt", tr.state.params)
        params = load_params(tmp_path / "ckpt")
        eager_enc = NomicEncoder(cfg, state_dict=params, device="cpu")
        want = eager_enc.encode_tokens(ids, mask)
    assert list(params) == list(nomic.NomicBertModel(cfg).state_dict())
    got = NomicEncoder(cfg, state_dict=params, device="cpu").encode_tokens(
        ids, mask)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        assert (np.sum(got * want, axis=1) >= 0.999).all()


@pytest.mark.parametrize("case", ["shape", "dtype", "gamma", "activation",
                                  "no_a", "rows_1d", "device"])
def test_wrappers_refuse_bad_operands(case):
    x = torch.randn(4, 8)
    g = torch.ones(8)
    with pytest.raises(ValueError):
        if case == "shape":
            ek.add_layer_norm(x, torch.randn(4, 9), g, g, EPS)
        elif case == "dtype":
            ek.add_layer_norm(x, x.bfloat16(), g, g, EPS)
        elif case == "gamma":
            ek.add_layer_norm_bwd(x, x, x, torch.ones(7), EPS)
        elif case == "activation":
            ek.swiglu(x, x, "relu")
        elif case == "no_a":
            ek.swiglu(None, x, "swiglu")
        elif case == "rows_1d":
            ek.add_layer_norm(x[0], x[0], g, g, EPS)
        else:
            ek.swiglu(x, x.to("meta"))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_parents_glue_runs_the_eager_chain_and_restores_the_functions(
        monkeypatch, activation):
    """``chip_smoke.parents_glue`` (the yardstick of phases 7 and 10) runs
    the model's every norm and gate on torch's own ops, through neither
    Function, and puts the Functions back when it exits, after an error
    too; the model's output moves by no more than the two LayerNorm
    formulas' last bits (f32, atol 1e-5)."""
    applied = []
    for fn in (ek.AddLayerNorm, ek.SwiGlu):
        monkeypatch.setattr(fn, "apply", classmethod(
            lambda cls, *a, _apply=fn.apply: applied.append(cls)
            or _apply(*a)))
    saved = nomic.add_norm, nomic.SwiGlu
    cfg = NomicBertConfig(dtype=torch.float32, attention_impl="xla",
                          activation=activation, **TINY)
    enc = NomicEncoder(cfg, seed=5, device="cpu")
    ids, mask = _batch(seed=6)
    want = enc.encode_tokens(ids, mask)
    assert len(applied) == 2 * TINY["num_layers"] + 1 + TINY["num_layers"]
    applied.clear()
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.parents_glue():
            got = enc.encode_tokens(ids, mask)
            assert (nomic.add_norm, nomic.SwiGlu) != saved
            raise RuntimeError("inside")
    assert not applied
    assert (nomic.add_norm, nomic.SwiGlu) == saved
    np.testing.assert_allclose(got, want, atol=1e-5)
