"""Serve-mode pipeline: persisted store -> device store -> search -> report.

Counterpart of the ``skip_process`` half of
``better_search_rag_rust_tpu/pipeline.py`` (``:546-657``, ``:1377-1482``):
load the merged Parquet store onto one device, build the engine, run the
self-retrieval search and its accuracy report, or the batch ``evaluate``.
Ingest, merge, text queries, serving and incremental update are later
slices of the port (ROADMAP.md) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .bench import BenchmarkManager
from .config import PipelineConfig
from .metrics import (
    accuracy_metrics_for_query,
    mean_reciprocal_rank,
    recall_at_k,
    top_k_overlap,
)
from .ops.engine import SearchEngine
from .store.device_store import DeviceStore
from .utils.logging import host_log


@dataclass
class PipelineResult:
    """What the reference's ``main()`` prints, as data."""

    top_k: List[Tuple[int, float]]
    mrr: float
    recall: float
    overlap: float
    num_vectors: int
    report: str
    ingest: Optional[object] = None  #: always None: serve mode never ingests


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; see ROADMAP.md "
        "(Queue 1). Use better_search_rag_rust_tpu for it."
    )


class Pipeline:
    """The serve-mode pipeline on one device. ``device=None`` picks the CUDA
    card when there is one, else the CPU, when the store is first loaded."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 device: Optional[torch.device | str] = None):
        self.config = config or PipelineConfig.from_env()
        self.bench = BenchmarkManager()
        self._device = device
        self._engine: Optional[SearchEngine] = None

    @property
    def device(self) -> torch.device:
        if self._engine is not None:
            return self._engine.device
        if self._device is not None:
            return torch.device(self._device)
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")

    # -- device store + engine ---------------------------------------------------

    def load_device_store(self) -> DeviceStore:
        """``global.parquet`` -> normalized store on the device. Refuses a
        store published by a partial merge unless ``allow_partial_merge``."""
        from .store.vectorstore import (
            global_store_path,
            parquet_row_count,
            partial_merge_marker,
        )

        cfg = self.config
        if cfg.store.use_snapshot:
            raise _not_ported("the device-store snapshot (store.use_snapshot)")
        path = global_store_path(cfg.store.dir)
        marker = partial_merge_marker(cfg.store.dir)
        if marker.exists():
            if not cfg.allow_partial_merge:
                raise RuntimeError(
                    f"global store at {cfg.store.dir} was published by a "
                    f"partial merge ({marker.read_text()}); re-run the "
                    "missing shards' ingest and merge again, or set "
                    "allow_partial_merge to serve it anyway"
                )
            host_log(f"WARNING: serving a PARTIAL store ({marker.read_text()})")
        if parquet_row_count(path) == 0:
            raise RuntimeError(
                f"global store at {cfg.store.dir} is empty — "
                "run ingest first or unset skip_process"
            )
        device = self.device
        timer = self.bench.start("device_store_loading")
        store = DeviceStore.from_parquet(path, cfg.search.store_dtype,
                                         device=device)
        self.bench.record(timer.stop(store.num_rows, device))
        return store

    def engine(self, store: Optional[DeviceStore] = None) -> SearchEngine:
        if self._engine is None:
            self._engine = SearchEngine(store or self.load_device_store(),
                                        self.config.search)
        return self._engine

    # -- later slices --------------------------------------------------------------

    def ingest_shard(self, *args, **kwargs):
        raise _not_ported("ingest (Pipeline.ingest_shard)")

    def merge(self, *args, **kwargs):
        raise _not_ported("the shard merge (Pipeline.merge)")

    def query(self, *args, **kwargs):
        raise _not_ported("text queries (Pipeline.query, needs the encoder)")

    def serve(self, *args, **kwargs):
        raise _not_ported("the JSONL server (Pipeline.serve)")

    def update(self, *args, **kwargs):
        raise _not_ported("incremental update (Pipeline.update)")

    # -- evaluation ----------------------------------------------------------------

    def evaluate(self, num_queries: int = 64, k: Optional[int] = None
                 ) -> Dict[str, float]:
        """Batch self-retrieval report: ``num_queries`` evenly spaced store
        rows as queries; MRR and recall@k (each row must retrieve itself)
        and the top-k overlap between the engine and the oracle (must be
        1.0)."""
        k = self.config.search.top_k if k is None else k
        engine = self.engine()
        n = engine.store.num_rows
        num_queries = min(num_queries, n)
        q_rows = np.linspace(0, n - 1, num_queries, dtype=np.int64)
        queries = engine.store.data[torch.from_numpy(q_rows).to(engine.device)]
        queries = queries.to(torch.float32).cpu().numpy()

        timer = self.bench.start("similarity_search")
        ids, _dists = engine.search(queries, k)
        self.bench.record(timer.stop(n * num_queries, engine.device))

        timer = self.bench.start("metrics_calculation")
        o_ids, _ = engine.oracle_topk(queries, k)
        results = ids.tolist()
        report = {
            "num_queries": float(num_queries),
            "k": float(min(k, n)),
            "mrr": mean_reciprocal_rank(q_rows.tolist(), results),
            "recall_at_k": recall_at_k(q_rows.tolist(), results, k),
            "oracle_overlap": top_k_overlap(o_ids.tolist(), results, k),
        }
        self.bench.record(timer.stop(device=engine.device))
        return report

    # -- full run --------------------------------------------------------------------

    def run(self) -> PipelineResult:
        """The reference ``main()`` in serve mode: self-retrieval search of
        stored row ``query_idx``, its accuracy metrics and the report."""
        cfg = self.config
        if not cfg.skip_process:
            raise _not_ported("the build mode of run() (ingest + merge)")
        total = self.bench.start("total_execution")
        engine = self.engine()
        store = engine.store

        from .store.vectorstore import global_store_path, read_matrix_slice

        query = read_matrix_slice(
            global_store_path(cfg.store.dir), cfg.search.query_idx, 1
        )[0]

        timer = self.bench.start("similarity_search")
        top_k = engine.search_single(query, cfg.search.top_k)
        self.bench.record(timer.stop(store.num_rows, engine.device))

        timer = self.bench.start("metrics_calculation")
        mrr, recall, overlap = accuracy_metrics_for_query(
            top_k, cfg.search.query_idx, cfg.search.top_k
        )
        self.bench.record(timer.stop())
        self.bench.record(total.stop(device=engine.device))

        sequential_times = None
        if cfg.measure_serial_baseline:
            import time

            from .ops.topk import serial_topk

            eff = engine.effective_store()
            qv = np.asarray(query, dtype=np.float32)[: eff.shape[1]]
            t0 = time.perf_counter()
            serial_topk(eff, qv, cfg.search.top_k)
            sequential_times = {"similarity_search": time.perf_counter() - t0}
        return PipelineResult(
            top_k=top_k, mrr=mrr, recall=recall, overlap=overlap,
            num_vectors=store.num_rows,
            report=self.bench.generate_report(sequential_times),
        )
