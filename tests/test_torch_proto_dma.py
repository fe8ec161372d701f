"""The DMA gather-and-rescore prototypes P18-P21 of
``scripts/proto_dma_rescore.py``, ``proto_dma2.py`` and ``proto_dma3.py``
against the port's counterparts (``bench/proto_dma.py``) on the CPU, where
the port runs the plain versions of K2, K11 and K12; and plain K2 across
its row chunks.

The scripts call ``pl.pallas_call`` without ``interpret``: the
``interpret`` fixture forces interpret mode for each test, so their kernels
run on the CPU. The scripts are loaded from their files. Inputs come from
numpy seeds and go to both: 16 queries, a 4096-row store of 128-d rows (V0
keeps 128 columns), 8 units per query.

Tolerances: bit for bit on dyadic rows (16 entries of +-1/4: every product
and sum is exact in f32, so any summation order gives the same bits); rtol
1e-5, atol 1e-6 on normalized random rows, whose f32 sums the two packages
take in different orders. V0 copies values, so it is compared bit for bit on
any rows. P21's ``mmo`` is not returned by the script: it is compared with a
numpy block max of the f64 product (bit for bit on dyadic rows, rtol 1e-5 /
atol 1e-6 on random rows).
"""

import importlib.util
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu.ops import topk_pallas as ref
from better_search_rag_rust_tpu_torch.bench import proto_calib
from better_search_rag_rust_tpu_torch.bench import proto_dma as pd
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port

REPO = Path(__file__).resolve().parents[1]
T, D, ROWS, KS = 16, 128, 4096, 8
_SCRIPTS = {}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def script(name):
    if name not in _SCRIPTS:
        path = REPO / "scripts" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS[name] = mod
    return _SCRIPTS[name]


def _rows(rng, n, kind):
    if kind == "dyadic":
        out = np.zeros((n, D), dtype=np.float32)
        for i in range(n):
            cols = rng.choice(D, size=16, replace=False)
            out[i, cols] = rng.choice([-0.25, 0.25], size=16)
        return out
    x = rng.standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind, unit, seed, t=T, ks=KS):
    """(numpy queries, store, ids) as bf16-exact f32 and sorted int32
    unit ids, and the same as (jax bf16, torch bf16) pairs."""
    rng = np.random.default_rng(seed)
    mat = _rows(rng, ROWS, kind)
    mat[40:48] = mat[3]  # duplicate rows across units
    qs = _rows(rng, t, kind)
    mat = torch.from_numpy(mat).bfloat16().float().numpy()
    qs = torch.from_numpy(qs).bfloat16().float().numpy()
    ids = np.sort(rng.integers(0, ROWS // unit, size=(t, ks),
                               dtype=np.int32), axis=1)
    ids[0, :2] = [0, 0]  # a unit selected twice
    return ((jnp.asarray(qs, jnp.bfloat16), jnp.asarray(mat, jnp.bfloat16),
             jnp.asarray(ids)),
            (torch.from_numpy(qs).bfloat16(), torch.from_numpy(mat).bfloat16(),
             torch.from_numpy(ids)))


def _check(got, want, exact):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


KINDS = ["dyadic", "normal"]


@pytest.mark.parametrize("kind", KINDS)
def test_p18_gather_rescore128_matches_script(kind):
    (jq, js, jids), (tq, ts, tids) = _inputs(kind, 128, seed=18)
    want = script("proto_dma_rescore").gather_rescore128(jq, js, jids,
                                                         interpret=True)
    got = pd.gather_rescore128(tq, ts, tids, interpret=True)
    _check(got, want, exact=kind == "dyadic")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", ["v0", "v1"])
def test_p19_make_v01_matches_script(variant, kind):
    """V0 copies row 0's first 128 values (bit for bit on any rows); V1
    scores 128-row units."""
    mod = script("proto_dma2")
    (jq, js, jids), (tq, ts, tids) = _inputs(kind, 128, seed=19)
    kernel = {"v0": mod._v0_kernel, "v1": mod._v1_kernel}[variant]
    want = mod.make_v01(kernel, T, D, KS)(jids, jq, js)
    got = pd.make_v01(variant, T, D, KS)(tids, tq, ts)
    _check(got, want, exact=variant == "v0" or kind == "dyadic")


@pytest.mark.parametrize("kind", KINDS)
def test_p19_v0_at_unit_16_matches_script(kind):
    """V0 at 16-row units: each unit's row 0 is store row ``id * 16``."""
    mod = script("proto_dma2")
    (jq, js, jids), (tq, ts, tids) = _inputs(kind, 16, seed=16)
    want = mod.make_v01(mod._v0_kernel, T, D, KS, unit=16)(jids, jq, js)
    got = pd.make_v01("v0", T, D, KS, unit=16)(tids, tq, ts)
    _check(got, want, exact=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("unit,cpg", [(16, 8), (32, 4)])
def test_p20_make_v3_matches_script(unit, cpg, kind):
    (jq, js, jids), (tq, ts, tids) = _inputs(kind, unit, seed=unit + cpg)
    want = script("proto_dma2").make_v3(T, D, KS, unit, cpg)(jids, jq, js)
    got = pd.make_v3(T, D, KS, unit, cpg)(tids, tq, ts)
    _check(got, want, exact=kind == "dyadic")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mm_n", [0, 256])
def test_p21_make_fused_matches_script(mm_n, kind):
    """The scores against the script's ``run``; ``mmo`` (not returned by the
    script) against a numpy block max, NaN for ``mm_n`` 0."""
    unit, cpg, tq = 16, 4, T
    (jq, js, jids), (tq_, ts, tids) = _inputs(kind, unit, seed=21 + mm_n)
    n = max(mm_n, 128)
    mms = _rows(np.random.default_rng(mm_n), n, kind)
    mms = torch.from_numpy(mms).bfloat16()
    want = script("proto_dma3").make_fused(T, D, KS, unit, cpg, mm_n, tq)(
        jids, jq, jq, jnp.asarray(mms.float().numpy(), jnp.bfloat16), js)
    run = pd.make_fused(T, D, KS, unit, cpg, mm_n, tq)
    assert run.copies == ((T // 8) * (KS // cpg) if mm_n else 0)
    got = run(tids, tq_, tq_, mms, ts)
    _check(got, want, exact=kind == "dyadic")
    mmo, scores = run.outs(tids, tq_, tq_, mms, ts)
    assert torch.equal(scores, got)
    assert tuple(mmo.shape) == (tq, n // 128)
    if not mm_n:
        assert bool(mmo.isnan().all())
        return
    prod = tq_.double().numpy() @ mms.double().numpy().T
    block_max = prod.reshape(tq, n // 128, 128).max(axis=2).astype(np.float32)
    _check(mmo, block_max, exact=kind == "dyadic")


def test_grid_rules_raise():
    """The scripts' grids (T/8, KS/cpg) drop a ragged tail silently; the
    port raises instead."""
    with pytest.raises(ValueError, match="multiple of cpg"):
        pd.make_v3(16, D, 10, 16, 4)
    with pytest.raises(ValueError, match="multiple of cpg"):
        pd.make_fused(16, D, 10, 16, 4, 256, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        pd.make_v3(12, D, 8, 16, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        pd.gather_rescore128(torch.zeros((12, D)), torch.zeros((ROWS, D)),
                             torch.zeros((12, KS), dtype=torch.int32))
    with pytest.raises(ValueError, match="unit must be 128"):
        pd.make_v01("v1", 16, D, 8, unit=16)
    with pytest.raises(ValueError, match="128"):
        pd.make_fused(16, D, 8, 16, 4, 200, 16)
    with pytest.raises(ValueError, match="'v0'"):
        pd.make_v01("v2", 16, D, 8)
    run = pd.make_v3(16, D, 8, 16, 4)
    with pytest.raises(ValueError, match="run was made for"):
        run(torch.zeros((16, 4), dtype=torch.int32), torch.zeros((16, D)),
            torch.zeros((ROWS, D)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("unit", [128, 16])
def test_plain_k2_across_row_chunks(monkeypatch, kind, unit):
    """Plain K2 scores the store in row chunks of at most ``_PLAIN_SCORES``
    scores; at a cap of 3 units of rows per chunk the answer equals the
    one-chunk answer bit for bit and the JAX K2's (bit for bit on dyadic
    rows, within rtol 1e-5 on random rows). An id outside [0, R/unit)
    scores NaN, as in the kernel."""
    (jq, js, jids), (tq, ts, tids) = _inputs(kind, unit, seed=unit)
    whole = port.gather_rescore(tq, ts, tids, unit=unit)
    monkeypatch.setattr(port, "_PLAIN_SCORES", T * unit * 3)
    assert len(port._row_chunks(T, ROWS, unit)) == -(-ROWS // (3 * unit))
    chunked = port.gather_rescore(tq, ts, tids, unit=unit)
    assert torch.equal(chunked, whole)
    want = ref.gather_rescore(jq, js, jids, unit=unit, cpg=128 // unit,
                              interpret=True)
    _check(chunked, want, exact=kind == "dyadic")
    bad = tids.clone()
    bad[2, 3] = ROWS // unit
    got = port.gather_rescore(tq, ts, bad, unit=unit).view(T, KS, unit)
    assert bool(got[2, 3].isnan().all())
    got[2, 3] = whole.view(T, KS, unit)[2, 3]
    assert torch.equal(got.view(T, KS * unit), whole)


def test_plain_k11_k12():
    """Plain K11 is the store's values bit for bit; plain K12 is plain K2's
    scores and plain K5's block maxima transposed, NaN without copies."""
    _, (tq, ts, tids) = _inputs("normal", 16, seed=3)
    out = port.gather_copy(ts, tids, unit=16).view(T, KS, 128)
    assert torch.equal(out, ts[tids.long() * 16].float())
    mms = ts[:256].contiguous()
    mmo, scores = port.gather_rescore_mm(tq, ts, tids, tq, mms, unit=16,
                                         copies=3)
    assert torch.equal(scores, port.gather_rescore(tq, ts, tids, unit=16))
    assert torch.equal(mmo, port.matmul_blockmax_only(tq, mms, 256).T)
    mmo0, _ = port.gather_rescore_mm(tq, ts, tids, tq, mms, unit=16,
                                     copies=0)
    assert mmo0.shape == (T, 2) and bool(mmo0.isnan().all())


def test_measurement_runs_on_the_cpu(capsys):
    """``main`` at a small size on the plain versions: every case of the
    three scripts agrees with itself, then the launches line."""
    assert pd.main(["--device", "cpu", "--rows-divisor", "1024"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "launches {}"
    results = [ln for ln in lines if " on {}: kernel " in ln]
    assert len(results) == 14 and all(ln.endswith(": ok") for ln in results)
    assert {ln.split()[0] for ln in results} == {
        "proto_dma_rescore", "proto_dma2", "proto_dma3"}


def test_calibration_runs_its_gathers_on_the_cpu(capsys):
    """``proto_calib`` runs its ``make_v3`` lines (none is left waiting)."""
    assert proto_calib.main(["--device", "cpu", "--rows-divisor",
                             "4096"]) == 0
    out = capsys.readouterr().out
    assert sum("DMA gather" in ln and ln.endswith(": ok")
               for ln in out.splitlines()) == len(proto_calib.GATHERS) == 5
    assert "not run" not in out
