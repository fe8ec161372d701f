"""The block-max prototypes P1-P16 of ``scripts/proto_*.py`` against the
port's counterparts (``bench/proto_blockmax.py``), K1 at emit widths above
128 rows, and plain K10 against plain K1 and K3.

The scripts call ``pl.pallas_call`` without ``interpret`` (``proto_emit_var``
reaches the production K1 with ``interpret=False``): the ``interpret``
fixture forces interpret mode for each test, so the scripts' kernels run on
the CPU. The scripts are loaded from their files (``proto_emit_var`` parses
``sys.argv`` at import; its geometry lives in module globals, set here to a
4096 x 64 int8 store). Inputs come from numpy seeds and go to both.

Tolerances: bit for bit on dyadic rows (16 entries of +-1/4, with duplicate
rows inside a unit and across units: every product and sum is exact in f32)
in f32 and bf16, and on int8; rtol 1e-5, atol 1e-6 on normalized random
rows, whose f32 sums the two packages take in different orders. Integer
outputs (``arg``, the raw int8 key, the packed key) are compared only where
the sums are exact: on dyadic and int8 rows.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.bench import proto_blockmax as pb
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port
from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit_host

REPO = Path(__file__).resolve().parents[1]
T = 16
#: proto_emit_var's globals, cut to a 4096 x 64 store: R, VALID, D, Q, RT,
#: RT_T and EW = bm2_emit_width(4096, 2048, 128, 1024).
EMIT_VAR = dict(R=4096, VALID=4000, D=64, Q=T, RT=2048, RT_T=1024, EW=256)
_SCRIPTS = {}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


@pytest.fixture
def script(monkeypatch):
    def load(name):
        if name not in _SCRIPTS:
            path = REPO / "scripts" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            monkeypatch.setattr(sys, "argv", [str(path)])
            spec.loader.exec_module(mod)
            if name == "proto_emit_var":
                assert ref.bm2_emit_width(4096, 2048, 128, 1024) == 256
                for key, value in EMIT_VAR.items():
                    setattr(mod, key, value)
            _SCRIPTS[name] = mod
        return _SCRIPTS[name]
    return load


def dyadic(rng, n, d, nnz=16):
    """Rows with ``nnz`` entries of +-1/4 (unit norm when nnz == 16)."""
    out = np.zeros((n, d), dtype=np.float32)
    for i in range(n):
        cols = rng.choice(d, size=nnz, replace=False)
        out[i, cols] = rng.choice([-0.25, 0.25], size=nnz)
    return out


def _unit(x):
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x / np.where(n == 0.0, 1.0, n)).astype(np.float32)


def _inputs(kind, dtype, rows, dim, seed):
    """(jax queries, jax store, torch queries, torch store)."""
    rng = np.random.default_rng(seed)
    if kind in ("dyadic", "lattice"):
        mat = dyadic(rng, rows, dim) if kind == "dyadic" else \
            _unit(rng.standard_normal((rows, dim)))
        mat[40:48] = mat[3]          # cross-unit duplicates
        mat[100] = mat[101]          # in-unit duplicate pair
        fill = dyadic(rng, T - 3, dim) if kind == "dyadic" else \
            _unit(rng.standard_normal((T - 3, dim)))
        qs = np.concatenate([mat[[3, 100, 7]], fill])
        if kind == "lattice":
            mat, qs = quantize_unit_host(mat), quantize_unit_host(qs)
    elif kind == "raw8":
        mat = rng.integers(-127, 128, size=(rows, dim), dtype=np.int8)
        qs = rng.integers(-127, 128, size=(T, dim), dtype=np.int8)
    else:
        mat = _unit(rng.standard_normal((rows, dim)))
        qs = _unit(rng.standard_normal((T, dim)))
    if dtype == "bfloat16":  # both packages see the same bf16 bits
        mat = torch.from_numpy(mat).bfloat16().float().numpy()
        qs = torch.from_numpy(qs).bfloat16().float().numpy()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (jnp.asarray(qs, jdt), jnp.asarray(mat, jdt),
            torch.from_numpy(qs).to(tdt).contiguous(),
            torch.from_numpy(mat).to(tdt).contiguous())


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _check(got, want, exact):
    """Outputs in the JAX order, shapes and dtypes; values bit for bit
    where ``exact``, else floats within rtol 1e-5 / atol 1e-6 and integer
    outputs not compared."""
    got, want = _tuple(got), _tuple(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if exact:
            np.testing.assert_array_equal(a.numpy(), b)
        elif a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


#: (P, script, its function, the port's, keyword arguments, rows, dim)
FLOAT_CASES = [
    ("P1", "proto_bm3", "bm2_v1", pb.proto_bm3_bm2_v1, {"S": 16}, 2048, 64),
    ("P2", "proto_bm3", "bm2_v2", pb.proto_bm3_bm2_v2, {"S": 32}, 2048, 64),
    ("P3", "proto_bm3", "bm2_v3", pb.proto_bm3_bm2_v3, {"S": 16}, 2048, 64),
    ("P4", "proto_bm3", "bm2_v4", pb.proto_bm3_bm2_v4, {"S": 16}, 2048, 128),
    ("P5", "proto_bm2", "bm2_a", pb.proto_bm2_bm2_a, {"S": 16}, 2048, 64),
    ("P6", "proto_bm2", "bm2_b", pb.proto_bm2_bm2_b, {"S": 16}, 2048, 64),
    ("P7", "proto_bmt", "bm2t_pass", pb.proto_bmt_bm2t_pass, {}, 2048, 64),
    ("P8", "proto_bmt", "bm2t_only", pb.proto_bmt_bm2t_only, {}, 2048, 64),
    ("P9", "proto_768", "bm2_pass", pb.proto_768_bm2_pass, {}, 2048, 128),
    ("P10", "proto_fused", "bm2", pb.proto_fused_bm2, {"S": 16}, 2048, 64),
    ("P10-S128", "proto_fused", "bm2", pb.proto_fused_bm2, {"S": 128}, 2048,
     64),
    ("P11-mode0", "proto_argmax", "bm2x", pb.proto_argmax_bm2x, {"mode": 0},
     4096, 64),
    ("P11-mode1", "proto_argmax", "bm2x", pb.proto_argmax_bm2x, {"mode": 1},
     4096, 64),
    ("P11-mode2", "proto_argmax", "bm2x", pb.proto_argmax_bm2x, {"mode": 2},
     4096, 64),
    ("P15", "proto_hier", "mm_bmsub", pb.proto_hier_mm_bmsub, {"sub": 32},
     2048, 64),
    ("P16", "proto_rescore", "bm_only", pb.proto_rescore_bm_only,
     {"rt": 2048}, 4096, 64),
]


#: The prototypes on K10, which takes the scripts' bf16 (and int8) only.
K10_CASES = {"P3", "P6", "P7", "P11-mode1", "P11-mode2"}


@pytest.mark.parametrize("kind,dtype,cut", [
    ("dyadic", "bfloat16", 96), ("dyadic", "float32", 0),
    ("normal", "float32", 200), ("normal", "bfloat16", 200),
], ids=["dyadic-bf16-padded", "dyadic-f32", "normal-f32-padded",
        "normal-bf16-padded"])
@pytest.mark.parametrize("case", FLOAT_CASES, ids=[c[0] for c in FLOAT_CASES])
def test_float_prototype_matches_script(script, case, kind, dtype, cut):
    """The script's outputs; on f32 operands the K10 prototypes raise."""
    p, name, fn, port_fn, kw, rows, dim = case
    jq, js, tq, ts = _inputs(kind, dtype, rows, dim, seed=rows + dim + cut)
    valid = rows - cut
    if p in K10_CASES and dtype == "float32":
        with pytest.raises(TypeError, match="K10 takes bf16 or int8"):
            port_fn(tq, ts, valid, **kw)
        return
    want = getattr(script(name), fn)(jq, js, jnp.int32(valid), **kw)
    got = port_fn(tq, ts, valid, **kw)
    _check(got, want, exact=kind == "dyadic")


@pytest.mark.parametrize("variant,mode", [
    ("run_variant", "masked"), ("run_variant", "twolevel"),
    ("run_variant", "k1only"), ("run_tvariant", "masked"),
    ("run_tvariant", "k1only"),
])
def test_emit_var_matches_script(script, variant, mode):
    """P12 (``run_tvariant``) and P13 (``run_variant``) on the int8
    lattice, 4000 of 4096 rows valid: (key, bms, bmi) bit for bit."""
    mod = script("proto_emit_var")
    jq, js, tq, ts = _inputs("lattice", "int8", 4096, 64, seed=12)
    want = getattr(mod, variant)(mode)(jq, js)
    got = getattr(pb, f"proto_emit_var_{variant}")(
        mode, valid_rows=EMIT_VAR["VALID"])(tq, ts)
    assert [tuple(x.shape) for x in got] == [(32, T), (32, T), (16, T)]
    _check(got, want, exact=True)


@pytest.mark.parametrize("cut", [0, 300])
@pytest.mark.parametrize("sub", [64, 32])
def test_int8_bm2t_matches_script(script, sub, cut):
    """P14: raw int8 in [-127, 127], scores scaled by 1/700^2."""
    jq, js, tq, ts = _inputs("raw8", "int8", 4096, 128, seed=sub + cut)
    c = pb.INV_SCALE2_700
    assert c == float(np.float32(1.0) / (np.float32(700.0) * np.float32(700.0)))
    want = script("proto_int8").bm2t_i8(jq, js, 4096 - cut, rt=2048, sub=sub,
                                         inv_scale2=c)
    got = pb.proto_int8_bm2t_i8(tq, ts, 4096 - cut, rt=2048, sub=sub,
                                inv_scale2=c)
    _check(got, want, exact=True)


# -- K1 at emit widths above 128 rows (the repaired fault) --------------------


@pytest.mark.parametrize("argmax", [True, False])
def test_k1_int8_emit_width_256_matches_pallas(argmax):
    """The fault: the port raised ``ValueError: K1 emit width 256 must be a
    multiple of sub 128 dividing block 1024 and 128`` where the JAX K1
    answers (ROADMAP Queue 3)."""
    jq, js, tq, ts = _inputs("lattice", "int8", 4096, 64, seed=7)
    kw = dict(sub=128, block=1024, emit_block=True, emit_argmax=argmax,
              emit_width=256)
    want = ref.matmul_blockmax2_only(jq, js, jnp.int32(4000), interpret=True,
                                     **kw)
    got = port.matmul_blockmax2_only(tq, ts, 4000, **kw)
    shapes = [(32, T), (32, T), (16, T)] if argmax else [(32, T), (16, T)]
    assert [tuple(x.shape) for x in got] == shapes
    _check(got, want, exact=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sub,block,ew", [(64, 512, 256), (16, 1024, 512),
                                          (128, 1024, 1024)])
def test_k1_wide_emit_matches_pallas(dtype, sub, block, ew):
    """2048 rows: the reference's one row tile spans the store, so its
    Mosaic sublane rule admits every width."""
    jq, js, tq, ts = _inputs("dyadic", dtype, 2048, 64, seed=ew + sub)
    kw = dict(sub=sub, block=block, emit_block=True, emit_argmax=True,
              emit_width=ew)
    want = ref.matmul_blockmax2_only(jq, js, jnp.int32(1900), interpret=True,
                                     **kw)
    _check(port.matmul_blockmax2_only(tq, ts, 1900, **kw), want, exact=True)


def test_k1_emit_width_guards():
    q, s = torch.zeros((4, 32)), torch.zeros((2048, 32))
    with pytest.raises(ValueError, match="emit width"):
        port.matmul_blockmax2_only(q, s, 2048, sub=64, block=1024,
                                   emit_block=True, emit_width=192)
    with pytest.raises(ValueError, match="emit width"):
        port.matmul_blockmax2_only(q, s, 2048, sub=64, block=256,
                                   emit_block=True, emit_width=512)


# -- plain K10 against plain K1 and K3 ----------------------------------------


def _torch_inputs(dtype, rows=2048, dim=64, seed=0, kind=None):
    kind = kind or ("lattice" if dtype == "int8" else "normal")
    return _inputs(kind, dtype, rows, dim, seed)[2:]


K10_GEOMETRIES = [(8, 128), (16, 128), (32, 64), (64, 256), (128, 512)]


def _k10_against_k1(dtype, sub, ew, kind=None):
    """On every shared output, bit for bit: unit maxima, coarse maxima, and
    (arg, m2) packed into K1's key."""
    tq, ts = _torch_inputs(dtype, seed=sub, kind=kind)
    bms, key, bm = port.matmul_blockmax2_only(
        tq, ts, 1900, sub=sub, block=ew, emit_block=True, emit_argmax=True,
        emit_width=ew)
    k_bms, arg, m2, k_bm = port.matmul_blockmax2x(
        tq, ts, 1900, sub=sub, emit_arg=True, emit_m2=True, emit_width=ew)
    assert torch.equal(k_bms, bms) and torch.equal(k_bm, bm)
    assert arg.dtype == torch.int32
    assert torch.equal(port.pack_m2_argmax_key(m2, arg), key)
    assert torch.equal(arg, key & 0x7F)
    (t_bms,) = port.matmul_blockmax2x(tq, ts, 1900, sub=sub, t_major=True)
    assert torch.equal(t_bms, bms.T)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("sub,ew", K10_GEOMETRIES)
def test_plain_k10_is_plain_k1(dtype, sub, ew):
    _k10_against_k1(dtype, sub, ew)


@pytest.mark.parametrize("sub,ew", K10_GEOMETRIES)
def test_plain_k10_is_plain_k1_dyadic(sub, ew):
    """Dyadic bf16 rows, whose duplicates tie inside a unit."""
    _k10_against_k1("bfloat16", sub, ew, kind="dyadic")


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_plain_k10_sims_are_k3_scores(dtype):
    tq, ts = _torch_inputs(dtype, seed=3)
    sims, _ = port.matmul_blockmax(tq, ts, 2000)
    k_sims, bms = port.matmul_blockmax2x(tq, ts, 2000, sub=8, emit_sims=True)
    assert torch.equal(k_sims, sims.T)
    assert torch.equal(bms, sims.T.reshape(-1, 8, T).amax(dim=1))


@pytest.mark.parametrize("sub", [16, 128])
def test_plain_k10_raw_key(sub):
    """The raw key holds the exact dot and the lowest attaining row."""
    tq, ts = _torch_inputs("int8", seed=sub)
    bms, key = port.matmul_blockmax2x(tq, ts, 2000, sub=sub,
                                      emit_raw_key=True)
    acc = (tq.float() @ ts.float().T).long().T
    acc[2000:] = port._PAD_ACC
    units = acc.reshape(-1, sub, T)
    assert torch.equal((key >> 7).long(), units.amax(dim=1))
    lowest = (units == units.amax(dim=1, keepdim=True)).int().argmax(dim=1)
    assert torch.equal(127 - (key & 0x7F).long(), lowest)
    scaled = (key >> 7).float() * port.INT8_INV_SCALE2
    assert torch.equal(torch.where((key >> 7) == port._PAD_ACC,
                                   torch.full_like(scaled, port.PAD_SIM),
                                   scaled), bms)


def test_k10_wrapper_guards():
    q, s = torch.zeros((4, 32)), torch.zeros((1024, 32))
    with pytest.raises(TypeError, match="bf16 or int8"):
        port.matmul_blockmax2x(q, s, 1024)
    q, s = q.bfloat16(), s.bfloat16()
    with pytest.raises(TypeError, match="int8"):
        port.matmul_blockmax2x(q, s, 1024, emit_raw_key=True)
    with pytest.raises(ValueError, match="sub"):
        port.matmul_blockmax2x(q, s, 1024, sub=24)
    with pytest.raises(ValueError, match="emit width"):
        port.matmul_blockmax2x(q, s, 1024, sub=64, emit_width=96)


def test_measurement_runs_on_the_cpu(capsys):
    """``main`` at a small size on the plain versions: every case of the
    ten scripts, each agreeing with itself, then the launches line."""
    assert pb.main(["--device", "cpu", "--rows-divisor", "4096"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "launches {}"
    scripts = {c[0] for c in pb.CASES}
    assert len(scripts) == 10
    assert sum(ln.endswith(": ok") for ln in lines) == len(pb.CASES)
