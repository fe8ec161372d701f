"""The certified f32 prototypes P22 and P23 of
``scripts/proto_f32_rescore.py`` and ``proto_f32_rescore2.py`` against the
port's counterparts (``bench/proto_f32.py``) on the CPU, where the port runs
the plain versions of K1, K2, K3, K4 and K6.

The scripts call ``pl.pallas_call`` without ``interpret`` (their pipelines
reach the production K1 with ``interpret=False``): the ``interpret``
fixture forces interpret mode for each test. The scripts are loaded from
their files with ``sys.argv`` patched (both parse it at import, and
``proto_f32_rescore2`` imports ``scripts.proto_f32_rescore`` as a second
module object, which parses it too); their pipelines read module globals
at trace time, set here (monkeypatch) to a small geometry: 131,072 x 32 f32
rows (130,000 valid: 512 groups of 32 units, so ``select_units`` keeps 256
of them), 16 queries in tiles of 8, K 10, KS 16, KG 64, C2 16. The port gets
the same geometry as a :class:`Geometry`. Inputs come from numpy seeds and
go to both.

Tolerances: bit for bit on dyadic rows (16 entries of +-1/4 with duplicate
rows: every product and sum is exact in f32, so any summation order gives
the same bits); rtol 1e-5, atol 1e-6 on normalized random rows, whose f32
sums the two packages take in different orders. The K4 copies are compared
bit for bit on any rows; ids, unit ids and certificate flags must be equal.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu_torch.bench import proto_f32 as pf

REPO = Path(__file__).resolve().parents[1]
GEOM = dataclasses.replace(pf.SCRIPTS, R=131_072, VALID=130_000, D=32, Q=16,
                           T=8, K=10, KS=16, KG=64, C2=16)
#: the scripts' globals that GEOM changes, per script
GLOBALS = {"proto_f32_rescore": ("R", "VALID", "D", "Q", "T", "K", "KS",
                                 "KG"),
           "proto_f32_rescore2": ("R", "VALID", "D", "Q", "T", "K", "C2")}
KINDS = ["dyadic", "normal"]
_SCRIPTS = {}
_INPUTS = {}


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
            with monkeypatch.context() as m:
                m.setattr(sys, "argv", [str(path)])
                spec.loader.exec_module(mod)
            _SCRIPTS[name] = mod
        mod = _SCRIPTS[name]
        for key in GLOBALS[name]:
            monkeypatch.setattr(mod, key, getattr(GEOM, key))
        return mod
    return load


def _rows(rng, n, kind):
    d = GEOM.D
    if kind == "dyadic":
        out = np.zeros((n, d), dtype=np.float32)
        for i in range(n):
            cols = rng.choice(d, size=16, replace=False)
            out[i, cols] = rng.choice([-0.25, 0.25], size=16)
        return out
    x = rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind):
    """(numpy store, queries): the geometry's f32 store, rows past VALID
    zero, duplicate rows across units; queries the rows at linspace(0,
    VALID - 1, Q), as the scripts pick them."""
    if kind not in _INPUTS:
        rng = np.random.default_rng(23)
        mat = _rows(rng, GEOM.R, kind)
        mat[40:48] = mat[3]
        mat[GEOM.VALID:] = 0
        sel = np.linspace(0, GEOM.VALID - 1, GEOM.Q).astype(np.int32)
        _INPUTS[kind] = mat, np.ascontiguousarray(mat[sel])
    return _INPUTS[kind]


def _both(kind):
    mat, qs = _inputs(kind)
    return ((jnp.asarray(qs), jnp.asarray(mat)),
            (torch.from_numpy(qs), torch.from_numpy(mat)))


def _check(got, want, exact):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype)
    if exact or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _unit_ids(seed, ks):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, GEOM.R // 8, size=(GEOM.T, ks),
                               dtype=np.int32), axis=1)
    ids[0, :2] = [5, 5]  # a unit selected twice
    return ids


def test_p22_gather_rows_matches_script(script):
    """K4 copies bytes: bit for bit on random rows."""
    (_, js), (_, ts) = _both("normal")
    ids = _unit_ids(22, GEOM.KS)
    want = script("proto_f32_rescore").gather_rows(js, jnp.asarray(ids),
                                                   interpret=True)
    got = pf.gather_rows(ts, torch.from_numpy(ids))
    _check(got, want, exact=True)


@pytest.mark.parametrize("kind", KINDS)
def test_p23_gather_rescore_hi_matches_script(script, kind):
    (jq, js), (tq, ts) = _both(kind)
    ids = _unit_ids(23, GEOM.KS)
    want = script("proto_f32_rescore2").gather_rescore_hi(
        jq[:GEOM.T], js, jnp.asarray(ids), interpret=True)
    got = pf.gather_rescore_hi(tq[:GEOM.T].contiguous(), ts,
                               torch.from_numpy(ids))
    _check(got, want, exact=kind == "dyadic")


def test_grid_rules_raise():
    """The scripts' grids (T/8, KS/cpg) drop a ragged tail silently, and
    P23's output block is 128 lanes: the port raises instead."""
    _, (tq, ts) = _both("normal")
    ids = torch.from_numpy(_unit_ids(1, 32))
    with pytest.raises(ValueError, match="multiple of cpg"):
        pf.gather_rows(ts, ids[:, :12].contiguous())
    with pytest.raises(ValueError, match="multiple of 8"):
        pf.gather_rows(ts, ids[:6].contiguous())
    with pytest.raises(ValueError, match="multiple of cpg"):
        pf.gather_rescore_hi(tq[:8].contiguous(), ts, ids[:, :24].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        pf.gather_rescore_hi(tq[:8].contiguous(), ts, ids, cpg=8)
    with pytest.raises(ValueError, match="unknown stage"):
        pf.build_p2(32, "gather", GEOM)


@pytest.mark.parametrize("kind", KINDS)
def test_select_units_matches_script(script, kind):
    (jq, js), (tq, ts) = _both(kind)
    vals, uids = script("proto_f32_rescore2").select_units(jq[:GEOM.T], js,
                                                           GEOM.KS)
    got_vals, got_uids = pf.select_units(tq[:GEOM.T].contiguous(), ts,
                                         GEOM.KS, GEOM)
    _check(got_uids, uids, exact=True)
    _check(got_vals, vals, exact=kind == "dyadic")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("stage", ["sel", "grows", "dot", "full"])
def test_build_p2_matches_script(script, kind, stage):
    (jq, js), (tq, ts) = _both(kind)
    want = script("proto_f32_rescore2").build_p2(GEOM.KS, stage)(jq, js)
    got = pf.build_p2(GEOM.KS, stage, GEOM)(tq, ts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _check(g, w, exact=kind == "dyadic" or stage == "grows")


@pytest.mark.parametrize("kind", KINDS)
def test_build_fast_matches_script(script, kind):
    (jq, js), (tq, ts) = _both(kind)
    vals, ids, cert = script("proto_f32_rescore").build_fast()(jq, js)
    got_vals, got_ids, got_cert = pf.build_fast(GEOM)(tq, ts)
    _check(got_ids, ids, exact=True)
    _check(got_vals, vals, exact=kind == "dyadic")
    assert bool(got_cert) == bool(cert)


@pytest.mark.parametrize("kind", KINDS)
def test_build_p3_matches_script(script, kind):
    (jq, js), (tq, ts) = _both(kind)
    vals, ids, certs = script("proto_f32_rescore2").build_p3(GEOM.KS)(jq, js)
    got_vals, got_ids, got_certs = pf.build_p3(GEOM.KS, GEOM)(tq, ts)
    _check(got_ids, ids, exact=True)
    _check(got_certs, certs, exact=True)
    _check(got_vals, vals, exact=kind == "dyadic")


def test_certified_queries_equal_the_oracle():
    """The gate of the measurement: on random rows every cell certifies
    and answers with the oracle's ids; a query whose certificate fails may
    differ, and ``sound`` counts only certified ones."""
    _, (tq, ts) = _both("normal")
    _, o_ids = pf.oracle(tq, ts, GEOM)
    for run in (pf.build_fast(GEOM), pf.build_p2(GEOM.KS, "full", GEOM),
                pf.build_p3(GEOM.KS, GEOM)):
        _, ids, certs = run(tq, ts)
        res = pf.certified_exact(ids, certs, o_ids)
        assert res["sound"] and res["ids_eq"] and res["cert_rate"] == 1.0
    wrong = o_ids.clone()
    wrong[3, 0] += 1
    res = pf.certified_exact(o_ids, torch.ones(GEOM.Q, dtype=torch.bool),
                             wrong)
    assert not res["sound"] and res["certified_differ"] == 1
    certs = torch.ones(GEOM.Q, dtype=torch.bool)
    certs[3] = False
    assert pf.certified_exact(o_ids, certs, wrong)["sound"]


def test_measurement_runs_on_the_cpu(capsys):
    """``main`` at a small size on the plain versions: Q1, Q2, the EPS2
    check, every cell certified equal to the oracle, the timed cells and
    both kernels' lines, then the launches line."""
    assert pf.main(["--device", "cpu", "--rows-divisor", "64", "--reps", "1",
                    "--rounds", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "launches {}"
    assert sum("certified queries equal to the oracle: True" in ln
               for ln in lines) == 6
    assert any(ln.startswith("Q2 ") and "zero=True" in ln for ln in lines)
    assert sum(ln.startswith(("P22 ", "P23 ")) and ln.endswith(": ok")
               for ln in lines) == 3
    assert any(ln.startswith("p3_320: ") and "q/s" in ln for ln in lines)


@pytest.mark.parametrize("kg,ks", [(30, 192), (15, 16)])
def test_geometry_refuses_fewer_groups_than_units(kg, ks):
    """P22's certificate is sound only when KG >= KS; a geometry below that
    raises instead of certifying wrong ids."""
    with pytest.raises(ValueError, match="KG >= KS"):
        pf.Geometry(KG=kg, KS=ks)
    with pytest.raises(ValueError, match="KG >= KS"):
        dataclasses.replace(GEOM, KG=GEOM.KS - 1)
    assert dataclasses.replace(GEOM, KG=GEOM.KS).KG == GEOM.KS
