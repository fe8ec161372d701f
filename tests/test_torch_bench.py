"""The port's measurement layer against the JAX package's: suite names, the
compact battery line, the analytic FLOP count and the result keys; and the
entry points (``bench`` on the CLI, ``--profile-dir``, ``bench_torch.py``)
on the CPU at small sizes.

Timings taken here are the CPU's; what is compared is structure and
exactness: every key the JAX search suite reports, and ``oracle_overlap``
1.0 on the timed queries.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from better_search_rag_rust_tpu.bench import suite as jax_suite
from better_search_rag_rust_tpu.models.nomic import (
    NomicBertConfig as JaxNomicConfig,
)
from better_search_rag_rust_tpu_torch.bench import suite
from better_search_rag_rust_tpu_torch.models.nomic import NomicBertConfig

REPO = Path(__file__).resolve().parents[1]
SMALL = suite.SearchSuite(rows=4096, dim=64, queries=16, top_k=10, iters=2,
                          baseline_rows=4096)


def _sub(value, **extra):
    return {"value": value, "unit": "queries/sec", "vs_baseline": 1.5,
            "recall_at_10": 1.0, "mfu": 0.123456, "spread_pct": 2.5,
            "oracle_overlap": 1.0, "wall_s": 12.3, **extra}


def _battery(n_subs, with_error=False):
    rng = np.random.default_rng(n_subs)
    full = {"metric": "search_1m_qps", "value": 18934.5, "unit": "queries/sec",
            "vs_baseline": 31.2, "recall_at_10": 1.0, "mfu": 0.0294,
            "qps_repeats": [18934.5, 18800.1, 18700.9], "spread_pct": 1.24,
            "kernel": "rescore", "devices": 1, "platform": "gpu",
            "e2e_qps": 17000.0, "rows": 1_000_000}
    full["battery"] = {
        f"suite_{i}": _sub(float(rng.uniform(1, 1e5)),
                           coalescing=float(rng.uniform(1, 300)),
                           outstanding=8, speedup_vs_serial=12.5)
        for i in range(n_subs)}
    if with_error:
        full["battery"]["suite_0"] = {"error": "RuntimeError: " + "x" * 280,
                                      "wall_s": 1.0}
    full["battery_wall_s"] = 1234.5
    full["battery_skipped"] = ["search_10m_int8"]
    return full


@pytest.mark.parametrize("n_subs,with_error,cap", [
    (3, False, 1500), (10, False, 1500), (10, True, 1500), (40, False, 1500),
    (10, False, 400), (10, False, 150),
])
def test_compact_battery_summary_matches_jax(n_subs, with_error, cap):
    """Pure Python: equal to the JAX function on the same dict, including
    the cap-driven shedding of sub-suite keys and of whole sub-suites."""
    full = _battery(n_subs, with_error)
    want = jax_suite.compact_battery_summary(full, cap_bytes=cap)
    assert suite.compact_battery_summary(full, cap_bytes=cap) == want


def test_compact_battery_summary_keeps_the_mfu_denominator():
    full = _battery(3)
    full["mfu_peak_tflops"] = 989.0
    for sub in full["battery"].values():
        sub["mfu_peak_tflops"] = 989.0
    out = suite.compact_battery_summary(full)
    assert out["mfu_peak_tflops"] == 989.0
    assert all(s["mfu_peak_tflops"] == 989.0 for s in out["battery"].values())
    assert len(json.dumps(out)) <= 1500


@pytest.mark.parametrize("kw", [
    {}, {"num_layers": 2, "hidden_size": 128, "mlp_dim": 256},
    {"num_layers": 4, "hidden_size": 256, "mlp_dim": 1024, "num_heads": 4},
])
@pytest.mark.parametrize("batch,seq", [(256, 512), (3, 40)])
def test_encoder_forward_flops_matches_jax(kw, batch, seq):
    assert (suite.encoder_forward_flops(NomicBertConfig(**kw), batch, seq)
            == jax_suite.encoder_forward_flops(JaxNomicConfig(**kw), batch,
                                               seq))


def test_suite_names_match_jax():
    assert suite.SUITES == {n: suite.SearchSuite(**vars(s))
                            for n, s in jax_suite.SUITES.items()}
    with pytest.raises(ValueError) as ours:
        suite.run_suite("nope", device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_suite.run_suite("nope")
    assert str(ours.value) == str(theirs.value)


def test_peak_table_names_a_denominator_or_none(monkeypatch):
    """No card, or a card the table does not name: no peak, no mfu."""
    import torch

    assert suite.device_peak_flops("bfloat16", "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "X")
    assert suite.device_peak_flops("bfloat16", "cuda") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert suite.device_peak_flops("int8", "cuda") == 1979e12
    assert suite._mfu(98.9e12, "bfloat16", torch.device("cuda")) == {
        "mfu": 0.1, "mfu_peak_tflops": 989.0}


@pytest.fixture(scope="module")
def jax_small_result():
    return jax_suite.run_search_suite("small", jax_suite.SearchSuite(
        **vars(SMALL)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_search_suite_keys_and_gate(jax_small_result, dtype):
    import dataclasses

    res = suite.run_search_suite(
        "small", dataclasses.replace(SMALL, store_dtype=dtype), device="cpu")
    assert set(jax_small_result) <= set(res)
    assert res["oracle_overlap"] == 1.0 and res["recall_at_10"] == 1.0
    assert res["kernel"] == "global" and res["platform"] == "cpu"
    assert res["mfu"] is None and res["mfu_peak_tflops"] is None
    assert len(res["qps_repeats"]) == suite.REPEATS
    assert res["value"] == max(res["qps_repeats"]) > 0
    assert 0 <= res["spread_pct"] < 100
    assert res["metric"] == jax_small_result["metric"] == "small_qps"


def test_search_suite_fails_below_full_overlap(monkeypatch):
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine

    real = SearchEngine.oracle_topk

    def shifted(self, queries, k=None, upload="f32"):
        ids, d = real(self, queries, k, upload)
        return ids + 1, d

    monkeypatch.setattr(SearchEngine, "oracle_topk", shifted)
    with pytest.raises(RuntimeError, match="oracle overlap"):
        suite.run_search_suite("small", SMALL, device="cpu")


def test_pipeline_suite_runs():
    res = suite.run_pipeline_suite(files=16, dim=64, device="cpu")
    want = jax_suite.run_pipeline_suite(files=16, dim=64)
    assert set(want) <= set(res) and res["metric"] == want["metric"]
    assert res["metric"] == "ingest_hash_files_per_sec"
    assert res["files"] == 16 and len(res["files_per_sec_repeats"]) == 3
    assert res["value"] == max(res["files_per_sec_repeats"])


def test_encode_suite_runs_small():
    res = suite.run_encode_suite(batch=2, iters=1, max_tokens=16,
                                 device="cpu")
    assert res["metric"] == "encode_files_per_sec" and res["finite"]
    assert res["attention_impl"] == "fused" and res["mfu"] is None


def test_jabref_suite_runs_small(tmp_path):
    from better_search_rag_rust_tpu.bench.jabref import (
        run_jabref_suite as jax_run_jabref,
        synthesize_jabref_corpus as jax_corpus,
    )
    from better_search_rag_rust_tpu_torch.bench.jabref import (
        run_jabref_suite,
        synthesize_jabref_corpus,
    )

    ours = synthesize_jabref_corpus(tmp_path / "ours", files=12, seed=3)
    theirs = jax_corpus(tmp_path / "theirs", files=12, seed=3)
    files = sorted(p.relative_to(ours) for p in ours.rglob("*.java"))
    assert files == sorted(p.relative_to(theirs)
                           for p in theirs.rglob("*.java"))
    assert all((ours / f).read_text() == (theirs / f).read_text()
               for f in files)
    res = run_jabref_suite(corpus_dir=str(ours), queries_n=8, top_k=5,
                           device="cpu")
    want = jax_run_jabref(corpus_dir=str(theirs), queries_n=8, top_k=5)
    assert set(want) <= set(res) and want["files"] == res["files"]
    assert res["files"] == res["rows"] == 12 and res["encoder"] == "hash"
    assert res["recall_at_10"] == res["oracle_overlap"] == 1.0
    assert res["report_has_speedup"] and res["serial_threads"] == 1


def test_battery_records_errors_and_keeps_going(monkeypatch):
    calls = []

    def fake_search(name, s, device=None, seed=0):
        calls.append(name)
        if name == "search_1m_f32":
            raise RuntimeError("broken")
        return {"metric": f"{name}_qps", "value": 1.0}

    monkeypatch.setattr(suite, "run_search_suite", fake_search)
    for fn in ("_run_jabref", "_run_serve", "_run_finetune"):
        monkeypatch.setattr(suite, fn, lambda *a, **k: {"value": 2.0})
    monkeypatch.setattr(suite, "run_encode_suite", lambda **k: {"value": 3.0})
    res = suite.run_battery_suite(device="cpu")
    assert set(res["battery"]) == {
        "jabref", "serve_100k", "search_1m_f32", "search_10m_mat256",
        "finetune", "serve_open", "encode", "search_1m_int8",
        "search_10m_int8_mat256", "search_10m_int8"}
    assert res["battery"]["search_1m_f32"]["error"] == "RuntimeError: broken"
    assert all("wall_s" in r for r in res["battery"].values())
    assert suite.battery_errors(res) == {
        "search_1m_f32": "RuntimeError: broken"}
    assert calls[0] == "search_1m" and res["metric"] == "search_1m_qps"


def test_cli_bench_json_and_profile(monkeypatch, tmp_path, capsys):
    from better_search_rag_rust_tpu_torch import cli

    monkeypatch.setitem(suite.SUITES, "search_small", SMALL)
    trace = tmp_path / "trace"
    assert cli.main(["bench", "--suite", "search_small", "--json", "--device",
                     "cpu", "--profile-dir", str(trace)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "search_small_qps"
    assert line["oracle_overlap"] == 1.0
    (written,) = trace.glob("trace_*.json")
    assert "traceEvents" in json.loads(written.read_text())


def test_bench_torch_prints_one_line(monkeypatch, tmp_path, capsys):
    monkeypatch.syspath_prepend(str(REPO))
    import bench_torch

    monkeypatch.setitem(suite.SUITES, "search_small", SMALL)
    monkeypatch.setenv("BENCH_SUITE", "search_small")
    assert bench_torch.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert json.loads(out[0])["recall_at_10"] == 1.0

    monkeypatch.setattr(suite, "run_battery_suite", lambda device=None: {
        **json.loads(out[0]), "battery": {"encode": {"error": "X: y"}}})
    detail = tmp_path / "detail.json"
    monkeypatch.setenv("BENCH_SUITE", "battery")
    monkeypatch.setenv("BSR_BENCH_DETAIL", str(detail))
    assert bench_torch.main(["--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["battery"] == {"encode": {"error": "X: y"}}
    assert json.loads(detail.read_text())["battery"]["encode"]["error"]


def test_bench_torch_refuses_without_a_card(tmp_path):
    """No card and no ``--device``: the default device raises, nothing is
    printed on stdout."""
    import subprocess

    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy, sys; sys.argv = ['bench_torch.py']; "
            "runpy.run_path('bench_torch.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   BENCH_SUITE="search_100k"))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_profiling_trace_annotations_and_memory(tmp_path):
    """``device_trace`` writes one Chrome trace holding the ``annotate``d
    span; ``memory_stats`` reports nothing without a card, as the JAX
    function does where its backend reports nothing."""
    import torch

    from better_search_rag_rust_tpu_torch.utils import profiling

    with profiling.device_trace(str(tmp_path / "t")):
        with profiling.annotate("bsr-probe-span"):
            torch.ones(64).sum()
    (trace,) = (tmp_path / "t").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "bsr-probe-span" in names
    if not torch.cuda.is_available():
        assert profiling.memory_stats() == {}
