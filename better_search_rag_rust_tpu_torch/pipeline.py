"""End-to-end pipeline on one device: ingest -> embed -> store -> search.

Counterpart of ``better_search_rag_rust_tpu/pipeline.py`` for one process
on one card:

* build mode (``skip_process=False``): walk the corpus, read and tokenize
  each batch on a background thread, run the encoder forward on the device,
  write the shard (``rank_0.parquet`` with its ``.paths.json``,
  ``.attrs.json`` and ``.progress`` sidecars), merge into
  ``global.parquet`` with ``manifest.json`` and the encoder meta;
* serve mode: load the merged store onto the device, build the engine, run
  the self-retrieval search and its accuracy report, the batch
  ``evaluate``, or text queries (``query``).

One process is shard 0 of 1, so the reference's host barriers have nothing
to wait for. Per-batch failures are logged and skipped; ``resume`` continues
from the shard's ``.progress`` commit marker. Serving (``serve``) and
incremental ``update`` are later slices of the port (ROADMAP.md) and raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bench import BenchmarkManager
from .config import PipelineConfig
from .corpus import file_attr, file_stat, find_files_by_extensions, read_files
from .metrics import (
    accuracy_metrics_for_query,
    mean_reciprocal_rank,
    recall_at_k,
    top_k_overlap,
)
from .ops.engine import SearchEngine
from .parallel.partition import slice_for_shard
from .store import vectorstore as vs
from .store.device_store import DeviceStore
from .utils.device import resolve_device
from .utils.logging import host_log


@dataclass
class IngestStats:
    """One shard's ingest outcome (the reference's ``IngestStats``)."""

    files_found: int = 0
    files_assigned: int = 0
    files_read: int = 0
    files_skipped: int = 0
    embeddings: int = 0
    failed_batches: int = 0


@dataclass
class PipelineResult:
    """What the reference's ``main()`` prints, as data."""

    top_k: List[Tuple[int, float]]
    mrr: float
    recall: float
    overlap: float
    num_vectors: int
    report: str
    ingest: Optional[IngestStats] = None  #: None in serve mode


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; see ROADMAP.md "
        "(Queue 1). Use better_search_rag_rust_tpu for it."
    )


class Pipeline:
    """The full pipeline on one device (``device=None``: the CUDA card)."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 device: Optional[torch.device | str] = None,
                 seed: int = 0):
        self.config = config or PipelineConfig.from_env()
        self.device = resolve_device(device)
        self.bench = BenchmarkManager()
        self._encoder = None
        self._seed = seed  #: random encoder weights when no checkpoint
        self._engine: Optional[SearchEngine] = None
        self._manifest = None
        self._manifest_loaded = False
        self._drift_warned: set = set()

    @property
    def encoder(self):
        """The encoder service, built on the pipeline's device at first use."""
        if self._encoder is None:
            from .models.encoder import create_encoder

            timer = self.bench.start("llm_service_loading")
            self._encoder = create_encoder(self.config.encoder,
                                           device=self.device, seed=self._seed)
            self.bench.record(timer.stop(device=self.device))
        return self._encoder

    # -- phase 1: ingest + embed ---------------------------------------------------

    def ingest_shard(self, shard: int = 0, num_shards: int = 1) -> IngestStats:
        """Embed this shard's block of the corpus into ``rank_{shard}``.
        Per-batch failures are logged and skipped, never fatal."""
        cfg = self.config
        stats = IngestStats()
        files = find_files_by_extensions(cfg.corpus.root, cfg.corpus.extensions)
        stats.files_found = len(files)
        if shard == 0:
            host_log(f"found {len(files)} files under {cfg.corpus.root}")
        mine = slice_for_shard(shard, num_shards, files)
        stats.files_assigned = len(mine)

        # The .progress marker is the commit point: (files consumed, rows
        # committed), written atomically after the store and its sidecars.
        # Resume truncates whatever a crashed run persisted past it.
        shard_path = vs.local_store_path(cfg.store.dir, shard)
        progress_path = shard_path.with_suffix(".progress")
        paths_file = shard_path.with_suffix(".paths.json")
        attrs_file = shard_path.with_suffix(".attrs.json")
        done_files, committed_rows = 0, 0
        if cfg.resume and progress_path.exists():
            try:
                marker = json.loads(progress_path.read_text())
                done_files = min(int(marker["files"]), len(mine))
                committed_rows = int(marker["rows"])
            except (ValueError, KeyError, TypeError):
                done_files = 0

        row_paths: List[str] = []
        row_attrs: List = []
        store = None
        if done_files > 0:
            try:
                store = vs.local_store(cfg.store.dir, shard, empty=False)
                if store.count < committed_rows or not paths_file.exists():
                    raise ValueError("shard behind its commit marker")
                store.truncate(committed_rows)
                row_paths = json.loads(paths_file.read_text())[:committed_rows]
                if len(row_paths) != committed_rows:
                    raise ValueError("manifest shorter than committed rows")
                row_attrs = [None] * committed_rows
                if attrs_file.exists():
                    loaded = json.loads(attrs_file.read_text())[:committed_rows]
                    row_attrs[: len(loaded)] = loaded
            except Exception as exc:
                host_log(f"shard {shard}: resume state unusable ({exc}); "
                         "restarting the shard from scratch")
                store, row_paths, row_attrs, done_files = None, [], [], 0
        if store is None:
            store = vs.local_store(cfg.store.dir, shard, empty=True)
        else:
            stats.embeddings = store.count
            host_log(f"shard {shard}: resuming after {done_files} files "
                     f"({store.count} embeddings already persisted)")

        def checkpoint(files_done: int) -> None:
            store.persist()
            vs.atomic_write_text(paths_file, json.dumps(row_paths))
            vs.atomic_write_text(attrs_file, json.dumps(row_attrs))
            vs.atomic_write_text(progress_path, json.dumps(
                {"files": files_done, "rows": store.count}))  # commits

        if self.encoder.numerics:
            vs.write_encoder_meta(cfg.store.dir, self.encoder.numerics)

        timer = self.bench.start("embedding_generation")
        ckpt_every = cfg.checkpoint_every_batches

        def on_batch(batch_idx, files_through, kept, emb) -> None:
            if emb is not None and kept:
                store.append_many(emb)
                row_paths.extend(str(p) for p, _c, _a in kept)
                row_attrs.extend(a for _p, _c, a in kept)
                stats.embeddings += emb.shape[0]
            if ckpt_every and (batch_idx + 1) % ckpt_every == 0:
                checkpoint(files_through)

        self._embed_paths_pipelined(mine[done_files:], stats, on_batch,
                                    file_offset=done_files)
        checkpoint(len(mine))
        self.bench.record(timer.stop(items_processed=stats.embeddings))
        host_log(f"shard {shard}: {stats.embeddings} embeddings "
                 f"({stats.files_skipped} files skipped)")
        return stats

    def _embed_paths_pipelined(self, paths, stats: IngestStats, on_batch,
                               file_offset: int = 0) -> None:
        """Three stages over ``paths``: a background thread reads and
        tokenizes batch i+1 while the device runs batch i's forward and the
        main thread appends batch i-1 (``cfg.corpus.inflight_batches``
        forwards in flight). ``on_batch(batch_idx, files_through, kept,
        emb)`` runs once per batch, in order; ``kept`` is ``[(path, content,
        attr)]`` of the files read, ``emb`` their ``[len(kept), D]`` rows or
        None when the batch failed (logged and counted)."""
        cfg = self.config
        enc = self.encoder
        bsz = cfg.corpus.files_per_batch
        starts = list(range(0, len(paths), bsz))
        prefetcher = ThreadPoolExecutor(max_workers=1)
        futures = {}

        def read_and_tokenize(batch_paths):
            # stat before the read: a rewrite in between then misses the
            # next update's stat fast path instead of hiding the edit
            stats_pre = [file_stat(p) for p in batch_paths]
            contents = read_files(batch_paths, cfg.corpus.max_file_bytes)
            kept = [(p, c, file_attr(st, c))
                    for (p, c), st in zip(contents, stats_pre) if c]
            return kept, enc.tokenize([c for _p, c, _a in kept])

        def submit(idx):
            if 0 <= idx < len(starts) and idx not in futures:
                s = starts[idx]
                futures[idx] = prefetcher.submit(read_and_tokenize,
                                                 paths[s: s + bsz])

        def collect(inflight) -> None:
            batch_idx, files_through, kept, pending = inflight
            emb = None
            if pending is not None:
                try:
                    emb = enc.collect(pending)
                except Exception as exc:  # log and continue
                    host_log(f"batch {batch_idx} failed ({len(kept)} files): "
                             f"{exc}")
                    stats.failed_batches += 1
            on_batch(batch_idx, files_through, kept, emb)

        depth = max(int(cfg.corpus.inflight_batches), 1)
        inflight: deque = deque()
        submit(0)
        try:
            for batch_idx, start in enumerate(starts):
                submit(batch_idx + 1)
                batch_paths = paths[start: start + bsz]
                pending, kept = None, []
                try:
                    kept, tb = futures.pop(batch_idx).result()
                    stats.files_skipped += len(batch_paths) - len(kept)
                    stats.files_read += len(kept)
                    if kept:
                        pending = enc.dispatch(tb)
                except Exception as exc:  # log and continue
                    host_log(f"batch {batch_idx} failed "
                             f"({len(batch_paths)} files): {exc}")
                    stats.failed_batches += 1
                inflight.append((batch_idx,
                                 file_offset + start + len(batch_paths),
                                 kept, pending))
                while len(inflight) >= depth:
                    collect(inflight.popleft())
            while inflight:
                collect(inflight.popleft())
        finally:
            prefetcher.shutdown(wait=False, cancel_futures=True)

    def merge(self, num_shards: int = 1) -> int:
        """Merge the shard stores into ``global.parquet`` in shard order,
        with the row manifest, its identity sidecar and the update-commit
        marker. Returns the merged row count."""
        store_dir = self.config.store.dir
        timer = self.bench.start("vector_store_merge")
        merged = vs.merge_vector_stores(
            num_shards, store_dir,
            allow_partial=self.config.allow_partial_merge,
            force=self.config.force_merge)
        merged.persist()
        count = merged.count
        all_paths: List[str] = []
        all_attrs: List = []
        have_all = True
        for s_idx in range(num_shards):
            shard_path = vs.local_store_path(store_dir, s_idx)
            pf = shard_path.with_suffix(".paths.json")
            af = shard_path.with_suffix(".attrs.json")
            if not pf.exists():
                have_all = False
                continue
            shard_paths = json.loads(pf.read_text())
            all_paths.extend(shard_paths)
            shard_attrs = json.loads(af.read_text()) if af.exists() else []
            shard_attrs = shard_attrs[: len(shard_paths)]
            all_attrs.extend(
                shard_attrs + [None] * (len(shard_paths) - len(shard_attrs)))
        if have_all and len(all_paths) == count:
            vs.manifest_path(store_dir).write_text(json.dumps(all_paths))
            vs.attrs_path(store_dir).write_text(json.dumps(all_attrs))
            # a full merge is a fresh consistent (store, manifest, attrs)
            vs.write_update_commit(store_dir)
        else:
            vs.update_commit_path(store_dir).unlink(missing_ok=True)
        self._manifest_loaded = False
        self.bench.record(timer.stop(items_processed=count))
        host_log(f"merged {num_shards} shards -> {count} vectors")
        return count

    # -- device store + engine -------------------------------------------------------

    def load_device_store(self) -> DeviceStore:
        """``global.parquet`` -> normalized store on the device. Refuses a
        store published by a partial merge unless ``allow_partial_merge``."""
        cfg = self.config
        if cfg.store.use_snapshot:
            raise _not_ported("the device-store snapshot (store.use_snapshot)")
        path = vs.global_store_path(cfg.store.dir)
        marker = vs.partial_merge_marker(cfg.store.dir)
        if marker.exists():
            if not cfg.allow_partial_merge:
                raise RuntimeError(
                    f"global store at {cfg.store.dir} was published by a "
                    f"partial merge ({marker.read_text()}); re-run the "
                    "missing shards' ingest and merge again, or set "
                    "allow_partial_merge to serve it anyway"
                )
            host_log(f"WARNING: serving a PARTIAL store ({marker.read_text()})")
        if vs.parquet_row_count(path) == 0:
            raise RuntimeError(
                f"global store at {cfg.store.dir} is empty — "
                "run ingest first or unset skip_process"
            )
        timer = self.bench.start("device_store_loading")
        store = DeviceStore.from_parquet(path, cfg.search.store_dtype,
                                         device=self.device)
        self.bench.record(timer.stop(store.num_rows, self.device))
        return store

    def engine(self, store: Optional[DeviceStore] = None) -> SearchEngine:
        if self._engine is None:
            self._engine = SearchEngine(store or self.load_device_store(),
                                        self.config.search)
        return self._engine

    # -- text retrieval -----------------------------------------------------------------

    def query(self, texts: Sequence[str], k: Optional[int] = None
              ) -> List[List[Tuple[str, int, float]]]:
        """Top-k corpus files for text queries: per query a ranked
        ``[(source path, store row, cosine distance)]`` list. A row the
        manifest does not cover reads ``"row:{idx}"``."""
        k = self.config.search.top_k if k is None else k
        self._warn_encoder_drift("query")
        engine = self.engine()
        emb = self.encoder.get_embeddings_device(list(texts))
        if emb is None:
            emb = self.encoder.get_embeddings(list(texts))
        ids, dists = engine.search(emb, k)
        manifest = self._validated_manifest(int(engine.store.num_rows))
        out = []
        for row_ids, row_dists in zip(ids, dists):
            out.append([
                (manifest[idx] if manifest is not None
                 and 0 <= idx < len(manifest) else f"row:{idx}",
                 int(idx), float(dist))
                for idx, dist in zip(row_ids.tolist(), row_dists.tolist())
            ])
        return out

    def _validated_manifest(self, num_rows: int):
        """The row -> path manifest, read once per pipeline, refusing a torn
        (store, manifest) pair or one whose length is not the store's."""
        if not self._manifest_loaded:
            store_dir = self.config.store.dir
            torn = vs.validate_update_commit(store_dir)
            if torn:
                raise RuntimeError(f"refusing to serve a torn store: {torn}")
            self._manifest = vs.load_manifest(store_dir)
            self._manifest_loaded = True
        if self._manifest is not None and len(self._manifest) != num_rows:
            raise RuntimeError(
                f"row manifest ({len(self._manifest)} paths) does not match "
                f"the store ({num_rows} rows) — an update() may be writing "
                "concurrently; retry once it completes")
        return self._manifest

    def _warn_encoder_drift(self, where: str) -> None:
        """Warn once per call site when the encoder's numerics differ from
        the store's ``encoder.json`` (e.g. a store the other package built):
        embeddings drift at bf16-noise level across implementations."""
        if where in self._drift_warned:
            return
        self._drift_warned.add(where)
        recorded = vs.load_encoder_meta(self.config.store.dir)
        current = self.encoder.numerics
        if recorded and current and recorded != current:
            diff = {key: (recorded.get(key), current.get(key))
                    for key in sorted(set(recorded) | set(current))
                    if recorded.get(key) != current.get(key)}
            host_log(
                f"WARNING ({where}): encoder numerics differ from the ones "
                f"that built this store (recorded vs current): {diff}. "
                "Query/stored embeddings may drift at bf16-noise level; "
                "re-ingest to realign.")

    # -- later slices ----------------------------------------------------------------

    def serve(self, *args, **kwargs):
        raise _not_ported("the JSONL server (Pipeline.serve)")

    def update(self, *args, **kwargs):
        raise _not_ported("incremental update (Pipeline.update)")

    # -- evaluation --------------------------------------------------------------------

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

    # -- full run ------------------------------------------------------------------------

    def run(self) -> PipelineResult:
        """The reference ``main()``: ingest and merge unless
        ``skip_process``, then the self-retrieval search of stored row
        ``query_idx``, its accuracy metrics and the report."""
        cfg = self.config
        total = self.bench.start("total_execution")
        ingest_stats = None
        if not cfg.skip_process:
            ingest_stats = self.ingest_shard()
            self.merge()
        engine = self.engine()
        store = engine.store
        query = vs.read_matrix_slice(vs.global_store_path(cfg.store.dir),
                                     cfg.search.query_idx, 1)[0]

        timer = self.bench.start("similarity_search")
        top_k = engine.search_single(query, cfg.search.top_k)
        self.bench.record(timer.stop(store.num_rows, engine.device))

        timer = self.bench.start("metrics_calculation")
        mrr, recall, overlap = accuracy_metrics_for_query(
            top_k, cfg.search.query_idx, cfg.search.top_k)
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
            ingest=ingest_stats,
        )
