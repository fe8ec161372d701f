"""The fused two-level prototype P17 of ``scripts/proto_fused.py`` against
the port's counterparts (``bench/proto_fused.py``) on the CPU, where the
port runs the plain versions of K1 and K13.

The script calls ``pl.pallas_call`` without ``interpret``: the
``interpret`` fixture forces interpret mode for each test, so its kernels
run on the CPU. The script is loaded from its file. Its end-to-end pipeline
is a closure inside ``main``; :func:`_script_e2e` is its body (:300-312)
over the script's own functions. Inputs come from numpy seeds and go to
both: 16 queries, bf16 stores of 4,096-16,384 rows of 128 features, 8
sub-blocks per query.

Tolerances: bit for bit on dyadic rows (16 entries of +-1/4 with duplicate
rows: every product and sum is exact in f32, so any summation order gives
the same bits); rtol 1e-5, atol 1e-6 on normalized random rows, whose f32
sums the two packages take in different orders. ``extract_diag`` and the
selection move values: bit for bit on any rows; ids must be equal.
"""

import importlib.util
from pathlib import Path

import jax
import jax.experimental.pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from better_search_rag_rust_tpu_torch.bench import proto_fused as pf
from better_search_rag_rust_tpu_torch.ops import topk_kernels as port

REPO = Path(__file__).resolve().parents[1]
T, D, K = 16, 128, 8
KINDS = ["dyadic", "normal"]
_SCRIPTS = {}


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    orig = jax.experimental.pallas.pallas_call
    monkeypatch.setattr(jax.experimental.pallas, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def script():
    if "proto_fused" not in _SCRIPTS:
        path = REPO / "scripts" / "proto_fused.py"
        spec = importlib.util.spec_from_file_location("_proto_fused", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _SCRIPTS["proto_fused"] = mod
    return _SCRIPTS["proto_fused"]


def _rows(rng, n, kind):
    if kind == "dyadic":
        out = np.zeros((n, D), dtype=np.float32)
        for i in range(n):
            cols = rng.choice(D, size=16, replace=False)
            out[i, cols] = rng.choice([-0.25, 0.25], size=16)
        return out
    x = rng.standard_normal((n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _inputs(kind, rows, seed, valid=None):
    """(jax qf32, jax bf16 store, torch qf32, torch bf16 store): bf16-exact
    values, duplicate rows across sub-blocks, rows past ``valid`` zero."""
    rng = np.random.default_rng(seed)
    mat = _rows(rng, rows, kind)
    mat[40:48] = mat[3]
    mat[valid or rows:] = 0
    qs = np.concatenate([mat[[3, 7]], _rows(rng, T - 2, kind)])
    mat = torch.from_numpy(mat).bfloat16()
    qs = torch.from_numpy(qs).bfloat16().float()
    return (jnp.asarray(qs.numpy()), jnp.asarray(mat.float().numpy(),
                                                 jnp.bfloat16), qs, mat)


def _ids(seed, n_units, k=K):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n_units, size=(T, k), dtype=np.int32),
                  axis=1)
    ids[0, :2] = [4, 4]  # a sub-block selected twice
    return ids


def _check(got, want, exact):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    if exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_fused_scores_matches_script(kind, S, G):
    """The raw cross ``[k/G, T, 8*G*S]`` of each 8-query group."""
    jq, js, tq, ts = _inputs(kind, 4096, seed=S + G)
    ids = _ids(S * G, 4096 // S)
    want = script().fused_scores(jq, js, jnp.asarray(ids), S=S, G=G)
    got = pf.fused_scores(tq, ts, torch.from_numpy(ids), S=S, G=G)
    _check(got, want, exact=kind == "dyadic")


@pytest.mark.parametrize("S,G", [(16, 1), (16, 4), (32, 2)])
def test_extract_diag_matches_script(S, G):
    """Indexing only: bit for bit on any values; each query's own scores
    are plain K2's at unit S."""
    rng = np.random.default_rng(S * G)
    cross = rng.standard_normal((K // G, T, 8 * G * S)).astype(np.float32)
    want = script().extract_diag(jnp.asarray(cross), S=S, G=G)
    _check(pf.extract_diag(torch.from_numpy(cross), S=S, G=G), want,
           exact=True)
    _, _, tq, ts = _inputs("dyadic", 4096, seed=3)
    ids = torch.from_numpy(_ids(5, 4096 // S))
    diag = pf.extract_diag(pf.fused_scores(tq, ts, ids, S=S, G=G), S=S, G=G)
    assert torch.equal(diag, port.gather_rescore(tq.bfloat16(), ts, ids,
                                                 unit=S))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [4, 100])
def test_select_subblocks_matches_script(kind, k):
    """k 4 on 128 blocks takes the super-block branch (nb >= 4 * 8 * k), k
    100 the single-level one; both on one store's two-level maxima (plain
    K1), ties and PAD_SIM rows included."""
    S = 16
    _, _, tq, ts = _inputs(kind, 16384, seed=k, valid=16000)
    bms, bm = port.matmul_blockmax2_only(tq.bfloat16(), ts, 16000, sub=S,
                                         block=128, emit_block=True)
    want = script().select_subblocks(jnp.asarray(bms.numpy()),
                                     jnp.asarray(bm.numpy()), k, S=S)
    got = pf.select_subblocks(bms, bm, k, S=S)
    _check(got, want, exact=True)


def _script_e2e(qq32, dd, valid, k, S):
    """``main``'s ``e2e`` / ``e2e_small`` (:300-312, :345-357) over the
    script's functions, ``rt`` 1024 and ``G`` 2."""
    mod, G = script(), 2
    t = qq32.shape[0]
    qq = qq32.astype(jnp.bfloat16)
    bms_, bmt_ = mod.bm2(qq, dd, valid, rt=1024, S=S)
    ids_ = mod.select_subblocks(bms_, bmt_, k, S=S)
    cand = mod.extract_diag(mod.fused_scores(qq32, dd, ids_, S=S, G=G),
                            S=S, G=G)
    rows = (ids_[:, :, None] * S
            + jnp.arange(S, dtype=jnp.int32)[None, None, :]).reshape(t, k * S)
    cand = jnp.where(rows < valid, cand, mod.PAD_SIM)
    cid = jnp.where(rows < valid, rows, jnp.iinfo(jnp.int32).max)
    tv, tp = jax.lax.top_k(cand, k)
    return tv, jnp.take_along_axis(cid, tp, axis=1)


@pytest.mark.parametrize("kind,S", [("dyadic", 16), ("normal", 16),
                                    ("normal", 32)])
def test_e2e_matches_script(kind, S):
    """T 16 on an 8,192-row store with 8,000 valid rows: ids equal, values
    bit for bit on dyadic rows."""
    k = 16
    jq, js, tq, ts = _inputs(kind, 8192, seed=S, valid=8000)
    tv, ti = _script_e2e(jq, js, 8000, k, S)
    got_v, got_i = pf.e2e(tq, ts, 8000, k=k, S=S)
    _check(got_i, ti, exact=True)
    _check(got_v, tv, exact=kind == "dyadic")


def test_gather_cross_refuses_what_the_script_drops():
    """The script's grid (T/8, k/G) drops a ragged tail silently; K13
    raises instead, and takes bf16 operands only."""
    _, _, tq, ts = _inputs("normal", 4096, seed=1)
    q = tq.bfloat16()
    ids = torch.from_numpy(_ids(1, 256))
    with pytest.raises(ValueError, match="multiple of 8"):
        port.gather_cross(q[:12].contiguous(), ts, ids[:12].contiguous(),
                          unit=16, G=1)
    with pytest.raises(ValueError, match="multiple of G"):
        port.gather_cross(q, ts, ids, unit=16, G=3)
    with pytest.raises(TypeError, match="bf16"):
        port.gather_cross(tq, ts.float(), ids, unit=16, G=1)
    out = port.gather_cross(q, ts, ids[:, :0].contiguous(), unit=16, G=2)
    assert out.shape == (0, T, 256)


def test_measurement_runs_on_the_cpu(capsys):
    """``main`` at a small size on the plain versions: every case of both
    configurations agrees with itself and the oracle, then the launches
    line."""
    assert pf.main(["--device", "cpu", "--rows-divisor", "256"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "launches {}"
    cases = [ln for ln in lines if "fused_scores" in ln and " on {}: " in ln]
    assert len(cases) == 12 and all("): ok;" in ln for ln in cases)
    e2e = [ln for ln in lines if "E2E two-level fused" in ln]
    assert len(e2e) == 4 and all(ln.endswith(": 1.0") and ": OK (" in ln
                                 for ln in e2e)
