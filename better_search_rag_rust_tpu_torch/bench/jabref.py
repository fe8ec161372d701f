"""JabRef-corpus benchmark: the reference's own experiment, end to end.

Counterpart of ``better_search_rag_rust_tpu/bench/jabref.py``. The reference
embeds JabRef's ~2,305 Java files with nomic-embed-text-v1.5 and runs a
self-retrieval top-k search (reference: README.md:155-166,
src/main.rs:38-39). The corpus is a deterministic synthetic Java tree of the
same shape (:func:`synthesize_jabref_corpus`, generated in place, nothing
downloaded); the encoder is the hash backend unless ``BSR_CHECKPOINT_DIR``
names a real export (the result's ``encoder`` says which). Measured:

1. ``serial`` — the sequential NumPy scan over the built store, the
   reference's one-rank anchor, with the product pinned to
   :data:`SERIAL_THREADS` host thread (a BLAS pool that takes every core of a
   shared host made this anchor drift between runs);
2. ``search_only`` — device-resident search over the persisted store,
   :data:`.suite.REPEATS` timed repeats (``qps_repeats``, ``spread_pct``);
3. ``pipeline`` — ingest -> merge -> search with the serial scan fed to the
   report's speedup hook.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .suite import (
    REPEATS,
    SERIAL_SCALE_RANKS,
    _device_seconds,
    _platform,
    _spread_pct,
)

JABREF_FILES = 2305  # reference: README.md:159
#: Host threads of the serial anchor's product: one rank.
SERIAL_THREADS = 1

_WORDS = (
    "entry database citation bib field author title year journal editor "
    "crossref groups preferences importer exporter fetcher layout cleanup "
    "formatter util logic model gui action dialog table view preview "
    "undo redo event listener optional string integer boolean list map"
).split()


def synthesize_jabref_corpus(
    root: str | os.PathLike, files: int = JABREF_FILES, seed: int = 0
) -> Path:
    """Deterministic Java tree of ``files`` files with a JabRef-like layout
    (nested org/jabref packages) and size profile (lognormal around ~4 KB,
    capped at 64 KB) — the reference's generator, draw for draw, so both
    packages write the same tree. Idempotent: reuses a complete tree."""
    root = Path(root)
    marker = root / ".complete"
    if marker.exists() and marker.read_text() == f"{files}:{seed}":
        return root
    rng = np.random.default_rng(seed)
    packages = [
        "org/jabref/model/entry", "org/jabref/model/database",
        "org/jabref/logic/importer", "org/jabref/logic/exporter",
        "org/jabref/logic/citation", "org/jabref/logic/util",
        "org/jabref/gui/maintable", "org/jabref/gui/preferences",
        "org/jabref/gui/edit", "org/jabref/preferences",
    ]
    for i in range(files):
        pkg = packages[int(rng.integers(0, len(packages)))]
        d = root / pkg
        d.mkdir(parents=True, exist_ok=True)
        size = int(min(np.exp(rng.normal(8.2, 0.8)), 65536))
        name = f"Class{i:04d}"
        body = []
        while sum(len(b) for b in body) < size:
            method = rng.choice(_WORDS) + rng.choice(_WORDS).capitalize()
            words = " ".join(
                rng.choice(_WORDS) for _ in range(int(rng.integers(4, 14)))
            )
            body.append(
                f"    public void {method}{len(body)}() {{\n"
                f"        // {words}\n"
                f"        this.{rng.choice(_WORDS)} = \"{words}\";\n    }}\n"
            )
        (d / f"{name}.java").write_text(
            f"package {pkg.replace('/', '.')};\n\n"
            f"public class {name} {{\n" + "".join(body) + "}\n"
        )
    marker.write_text(f"{files}:{seed}")
    return root


@contextmanager
def _host_threads(n: int):
    """PyTorch's CPU thread pool pinned to ``n`` threads inside the block."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _serial_scan_qps(store_mat: np.ndarray, queries: np.ndarray,
                     k: int) -> tuple[float, float]:
    """(queries/sec, elapsed_s) of the sequential scan over the real store
    (src/mpi_helpers/metrics.rs:16-53, strengthened to argpartition): the
    f32 product on :data:`SERIAL_THREADS` host thread, then the selection."""
    t0 = time.perf_counter()
    with _host_threads(SERIAL_THREADS):
        sims = (torch.from_numpy(queries) @ torch.from_numpy(store_mat).T
                ).numpy()
    kk = min(k, store_mat.shape[0])
    part = np.argpartition(-sims, kk - 1, axis=1)[:, :kk]
    part_sims = np.take_along_axis(sims, part, axis=1)
    order = np.argsort(-part_sims, axis=1, kind="stable")
    np.take_along_axis(part, order, axis=1).copy()
    dt = time.perf_counter() - t0
    return queries.shape[0] / dt, dt


def run_jabref_suite(
    corpus_dir: Optional[str] = None,
    work_dir: Optional[str] = None,
    queries_n: int = 256,
    top_k: int = 50,  # reference: src/main.rs:110
    *,
    device: Optional[torch.device | str] = None,
) -> dict:
    """The three configurations on the (synthetic) JabRef corpus; ``value``
    is the best device-resident search q/s. Gated like the search suites:
    an oracle overlap below 1.0 raises."""
    from ..config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from ..metrics.quality import top_k_overlap
    from ..pipeline import Pipeline

    device = resolve_device(device)
    tmp = work_dir or tempfile.mkdtemp(prefix="bsr_jabref_")
    try:
        corpus = corpus_dir or os.path.join(tmp, "jabref")
        # an existing corpus (a real JabRef checkout) is used as it is
        if not (Path(corpus).exists() and any(Path(corpus).rglob("*.java"))):
            synthesize_jabref_corpus(corpus)

        cfg = PipelineConfig(
            corpus=CorpusConfig(root=str(corpus), extensions=("java",),
                                files_per_batch=32),  # reference chunk=32
            encoder=EncoderConfig(
                backend="auto",
                checkpoint_dir=os.environ.get("BSR_CHECKPOINT_DIR"),
            ),
            store=StoreConfig(dir=os.path.join(tmp, "vstore")),
            search=SearchConfig(top_k=top_k),
        )
        p = Pipeline(cfg, device=device)
        p.encoder.get_embeddings(["warm up"])
        encoder_kind = p.encoder.backend_label

        # config 3: the full pipeline (ingest -> merge -> search -> report)
        t0 = time.perf_counter()
        stats = p.ingest_shard()
        p.merge()
        ingest_s = time.perf_counter() - t0
        engine = p.engine()

        # self-retrieval queries: evenly spaced stored rows
        n = engine.store.num_rows
        qn = min(queries_n, n)
        q_rows = np.linspace(0, n - 1, qn, dtype=np.int64)
        store_mat = engine.effective_store()
        queries = np.ascontiguousarray(store_mat[q_rows])

        # config 1: the serial scan over the real store
        _serial_scan_qps(store_mat, queries[:8], top_k)  # warm-up
        serial_qps, serial_s = _serial_scan_qps(store_mat, queries, top_k)

        # config 2: search-only serving, end to end and device-resident
        timer = p.bench.start("similarity_search")
        t0 = time.perf_counter()
        ids, _ = engine.search(queries, k=top_k)
        e2e_elapsed = time.perf_counter() - t0
        p.bench.record(timer.stop(n * qn, device))

        qdev = engine.prepare_device_queries(queries)
        engine.search_device(qdev, top_k)  # warm-up

        iters = 16

        def batches():
            for _ in range(iters):
                engine.search_device(qdev, top_k)

        repeats = [qn * iters / _device_seconds(device, batches)
                   for _ in range(REPEATS)]
        qps = max(repeats)

        o_ids, _ = engine.oracle_topk(queries, k=top_k)
        overlap = top_k_overlap(o_ids.tolist(), ids.tolist(), top_k)
        if overlap != 1.0:
            raise RuntimeError(f"jabref: oracle overlap {overlap} != 1.0")
        k_r = min(10, top_k)
        recall_at_10 = float(np.mean([q_rows[i] in ids[i, :k_r]
                                      for i in range(qn)]))
        report = p.bench.generate_report(
            sequential_times={"similarity_search": serial_s})
        return {
            "metric": "jabref_search_qps",
            "value": qps,
            "unit": "queries/sec",
            "vs_baseline": qps / (serial_qps * SERIAL_SCALE_RANKS),
            "recall_at_10": recall_at_10,
            "oracle_overlap": overlap,
            "qps_repeats": repeats,
            "spread_pct": _spread_pct(repeats),
            "files": stats.embeddings,
            "rows": n,
            "top_k": top_k,
            "queries": qn,
            "encoder": encoder_kind,
            "serial_qps": serial_qps,
            "serial_threads": SERIAL_THREADS,
            "speedup_vs_serial": qps / serial_qps,
            "e2e_qps": qn / e2e_elapsed,
            "ingest_files_per_sec": stats.embeddings / ingest_s,
            "ingest_s": ingest_s,
            "report_has_speedup": "speedup" in report,
            "kernel": engine.kernel_name(top_k),
            **_platform(device),
        }
    finally:
        if work_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
