"""End-to-end pipeline: ingest -> embed -> store -> search.

Counterpart of ``better_search_rag_rust_tpu/pipeline.py``, in one process or
in several (:func:`.launch.maybe_init_distributed`):

* build mode (``skip_process=False``): walk the corpus, read and tokenize
  each batch on a background thread, run the encoder forward on the device,
  write the shard (``rank_0.parquet`` with its ``.paths.json``,
  ``.attrs.json`` and ``.progress`` sidecars), merge into
  ``global.parquet`` with ``manifest.json`` and the encoder meta;
* serve mode: load the merged store onto the device (or restore its
  snapshot), build the engine, run the self-retrieval search and its
  accuracy report, the batch ``evaluate``, or text queries (``query``);
* the JSONL server (``serve``: pipelined, optionally through the
  micro-batcher, with hot ``reload``) and the incremental ``update`` that
  reconciles the store with an edited tree.

Across processes each rank ingests its block of the corpus into its own
``rank_{r}.parquet``; the reference's host barriers (:func:`_host_barrier`)
order the filesystem phases, rank 0 alone merges, and the device store is
sharded over :attr:`Pipeline.mesh`, each rank reading only its own row
blocks. One process is shard 0 of 1 and its barriers have nothing to wait
for. Per-batch failures are logged and skipped; ``resume`` continues from
the shard's ``.progress`` commit marker.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bench import BenchmarkManager
from .config import PipelineConfig
from .corpus import (
    content_fingerprint,
    file_attr,
    file_stat,
    find_files_by_extensions,
    read_file,
    read_files,
)
from .metrics import (
    accuracy_metrics_for_query,
    mean_reciprocal_rank,
    recall_at_k,
    top_k_overlap,
)
from .ops.engine import SearchEngine
from .ops.quantize import store_dtype
# the reference's _process_info / _host_barrier (its pipeline.py:54-69):
# (rank, world size), and a wait between filesystem phases; (0, 1) and a
# no-op without a process group
from .parallel.mesh import barrier as _host_barrier
from .parallel.mesh import create_mesh, gather_objects
from .parallel.mesh import process_info as _process_info
from .parallel.partition import slice_for_shard
from .store import device_cache as dc
from .store import vectorstore as vs
from .store.device_store import DeviceStore
from .utils.device import resolve_device
from .utils.logging import host_log


def _source_identity(path: Path) -> dict:
    """What a snapshot records of the Parquet file it was built from."""
    st = path.stat()
    return {"rows": vs.parquet_row_count(path), "bytes": st.st_size,
            "mtime_ns": st.st_mtime_ns}


@dataclass
class IngestStats:
    """One shard's ingest outcome (the reference's ``IngestStats``)."""

    files_found: int = 0
    files_assigned: int = 0
    files_read: int = 0
    files_skipped: int = 0
    embeddings: int = 0
    failed_batches: int = 0
    #: update() only: rows re-embedded in place (edited files) and rows
    #: compacted away (deleted or now unreadable files).
    rows_reembedded: int = 0
    rows_deleted: int = 0


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


class MalformedRequest:
    """What the serve reader hands :meth:`Pipeline.serve` for an input line
    that was not valid JSON: a wrapper type, so no well-formed request can
    collide with it."""

    def __init__(self, error: str):
        self.error = error


def _serve_batch_shape(nq: int) -> int:
    """The reference's serve batch shapes: powers of two up to 1024, then
    multiples of 1024. The port compiles nothing per shape; it keeps the
    padding so both packages dispatch the same batches."""
    if nq <= 1024:
        return max(1, 1 << (nq - 1).bit_length())
    return nq + (-nq) % 1024


_UNSET = object()


class Pipeline:
    """The full pipeline (``device=None``: the CUDA card; the store shards
    over :attr:`mesh`)."""

    def __init__(self, config: Optional[PipelineConfig] = None,
                 device: Optional[torch.device | str] = None,
                 seed: int = 0, mesh=None):
        self.config = config or PipelineConfig.from_env()
        self.device = resolve_device(device)
        self._mesh = mesh
        self.bench = BenchmarkManager()
        self._encoder = None
        self._seed = seed  #: random encoder weights when no checkpoint
        self._engine: Optional[SearchEngine] = None
        self._manifest_cache = _UNSET
        self._drift_warned: set = set()
        # Serializes engine builds and the manifest cache: one Pipeline is
        # shared by the TCP server's connection threads, and a reload's
        # clear-then-rebuild racing another connection's engine() would
        # build (and hold) a second store on the card.
        self._build_lock = threading.RLock()

    @property
    def mesh(self):
        """The mesh the device store shards over: the one given to the
        constructor (the reference's ``Pipeline(mesh=...)``), else
        ``config.mesh``'s shape and axes over the pipeline's device — one
        card in a one-process run, the rank's own card under a process
        group — so a shape must cover one shard a rank. One process runs
        its local shards one after another (each shard's route reads the
        host once a query tile), so a mesh over several of its cards is
        asked for by name (``mesh=create_mesh()``), never the default.
        Built at first use — a collective across processes."""
        if self._mesh is None:
            mc = self.config.mesh
            device = self.device
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self._mesh = create_mesh(mc.shape, mc.axis_names,
                                     devices=[device])
        return self._mesh

    @property
    def encoder(self):
        """The encoder service, built on the pipeline's device at first use
        (once, when the server's connections reach it together)."""
        with self._build_lock:
            if self._encoder is None:
                from .models.encoder import create_encoder

                timer = self.bench.start("llm_service_loading")
                self._encoder = create_encoder(
                    self.config.encoder, device=self.device, seed=self._seed,
                    mesh=self._local_encode_mesh())
                self.bench.record(timer.stop(device=self.device))
            return self._encoder

    def _local_encode_mesh(self):
        """The mesh the nomic forward splits each batch over (the reference's
        ``_local_encode_mesh``): the pipeline's mesh where this process owns
        several of its shards (a device named twice counts twice), and the
        batch size divides them; else ``None``, one device. The hash
        backend runs no model and takes none."""
        enc = self.config.encoder
        if enc.backend == "hash" or (
                enc.backend == "auto" and not (
                    enc.checkpoint_dir and os.path.isdir(enc.checkpoint_dir))):
            return None
        # the default mesh is this process's one device; a mesh handed to
        # the constructor is the only one with several local shards
        local = [] if self._mesh is None else self._mesh.local_shards()
        if len(local) <= 1:
            return None
        if enc.batch_size % len(local):
            host_log(f"encode batch_size {enc.batch_size} does not divide "
                     f"{len(local)} local devices; encoding on one")
            return None
        return self._mesh

    # -- phase 1: ingest + embed ---------------------------------------------------

    def ingest_shard(self, shard: Optional[int] = None,
                     num_shards: Optional[int] = None) -> IngestStats:
        """Embed this shard's block of the corpus into ``rank_{shard}``;
        by default the shard is this process's rank of the world.
        Per-batch failures are logged and skipped, never fatal."""
        cfg = self.config
        proc, nprocs = _process_info()
        shard = proc if shard is None else shard
        num_shards = nprocs if num_shards is None else num_shards
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

    def merge(self, num_shards: Optional[int] = None) -> int:
        """Merge the shard stores into ``global.parquet`` in shard order,
        with the row manifest, its identity sidecar and the update-commit
        marker — rank 0 alone, once every rank has persisted its shard (the
        reference's barriers, ``pipeline.py:455-475``). Returns the merged
        row count (0 on the other ranks)."""
        proc, nprocs = _process_info()
        num_shards = nprocs if num_shards is None else num_shards
        _host_barrier("pre-merge")
        count = 0
        try:
            if proc == 0:
                count = self._merge_rank0(num_shards)
        finally:
            # rank 0 reaches this barrier even when its merge fails, or
            # every other rank would wait out the timeout
            _host_barrier("merge")
        self._manifest_cache = _UNSET
        return count

    def _merge_rank0(self, num_shards: int) -> int:
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
        self.bench.record(timer.stop(items_processed=count))
        host_log(f"merged {num_shards} shards -> {count} vectors")
        return count

    # -- device store + engine -------------------------------------------------------

    def load_device_store(self) -> DeviceStore:
        """``global.parquet`` -> normalized store sharded over :attr:`mesh`
        (each rank reads its own row blocks; one shard on one device is the
        plain store). Refuses a store published by a partial merge unless
        ``allow_partial_merge``. With ``store.use_snapshot`` a snapshot of
        the built store (:mod:`.store.device_cache`) restores straight onto
        the devices when its dtype and shard count are the requested ones
        and its recorded source is the Parquet file on disk; otherwise
        (logged) the store loads from Parquet and the snapshot is
        rewritten. Across processes every rank takes the same branch."""
        cfg = self.config
        # the mesh first: building it is a collective, which every rank
        # must reach before its own filesystem checks can part the ranks
        mesh = self.mesh
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
        snap_dir = dc.snapshot_dir(cfg.store.dir)
        if cfg.store.use_snapshot:
            store = self._restore_snapshot(snap_dir, path, mesh)
            if store is not None:
                return store
        if vs.parquet_row_count(path) == 0:
            raise RuntimeError(
                f"global store at {cfg.store.dir} is empty — "
                "run ingest first or unset skip_process"
            )
        timer = self.bench.start("device_store_loading")
        store = DeviceStore.from_parquet_sharded(
            path, mesh, cfg.search.store_dtype,
            chunk_rows=cfg.search.chunk_rows)
        self.bench.record(timer.stop(store.num_rows, store.device))
        if cfg.store.use_snapshot:
            dc.save_device_store(snap_dir, store, source=_source_identity(path))
            host_log(f"device store snapshot written to {snap_dir}")
        return store

    def _restore_snapshot(self, snap_dir: Path, path: Path, mesh
                          ) -> Optional[DeviceStore]:
        """The snapshot as a device store, or None (logged) when it is
        missing, older than the Parquet file, of another dtype or shard
        count, built from another source, or unreadable
        (``pipeline.py:574-623`` of the reference). Across processes a
        snapshot any rank cannot use is used by none."""
        store = self._restore_local_snapshot(snap_dir, path, mesh)
        if not all(gather_objects(store is not None)):
            return None
        return store

    def _restore_local_snapshot(self, snap_dir: Path, path: Path, mesh
                                ) -> Optional[DeviceStore]:
        """This rank's snapshot shards, or None (logged); makes no
        collective call, so a rank that returns early parts from none."""
        if not (dc.snapshot_exists(snap_dir) and path.exists()
                and dc.meta_path(snap_dir).stat().st_mtime
                >= path.stat().st_mtime):
            return None
        try:
            meta = dc.read_meta(snap_dir)
            # dtype changes the scores (exactness is per dtype)
            want = dc.DTYPE_NAMES[store_dtype(self.config.search.store_dtype)]
            if meta.get("dtype") != want:
                raise ValueError(
                    f"snapshot dtype {meta.get('dtype')} != requested {want}")
            # mtimes can lie (a Parquet restored from a backup keeps an old
            # one), and an update's in-place rewrite keeps rows and bytes:
            # the recorded identity must match all three
            src, now = meta.get("source") or {}, _source_identity(path)
            if src != now:
                raise ValueError(
                    f"snapshot source {src} != parquet on disk {now}")
            timer = self.bench.start("device_store_loading")
            store = dc.load_device_store(snap_dir, mesh=mesh)
            self.bench.record(timer.stop(store.num_rows, store.device))
        except Exception as exc:  # noqa: BLE001 — Parquet is the fallback
            host_log(f"snapshot unusable ({exc}); falling back to Parquet")
            return None
        host_log(f"device store restored from snapshot {snap_dir}")
        return store

    def engine(self, store: Optional[DeviceStore] = None) -> SearchEngine:
        with self._build_lock:
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
        manifest = self._serve_manifest(int(engine.store.num_rows))
        out = []
        for row_ids, row_dists in zip(ids, dists):
            out.append([
                (manifest[idx] if manifest is not None
                 and 0 <= idx < len(manifest) else f"row:{idx}",
                 int(idx), float(dist))
                for idx, dist in zip(row_ids.tolist(), row_dists.tolist())
            ])
        return out

    def _serve_manifest(self, num_rows: Optional[int] = None):
        """The row -> path manifest, read and validated once per engine
        (every TCP connection runs its own :meth:`serve`; re-parsing a
        multi-million-row manifest per connection is waste). The cache is
        dropped whenever the engine is (reload, update, merge)."""
        with self._build_lock:
            if self._manifest_cache is _UNSET:
                self._manifest_cache = self._validated_manifest(num_rows)
            return self._manifest_cache

    def _validated_manifest(self, num_rows: Optional[int]):
        """Load the manifest, refusing a torn (store, manifest) pair — an
        update that crashed between its renames (the commit marker) or a
        reload landing mid-update (the row-count cross-check) — with a
        loud, retryable error instead of row-shifted paths."""
        store_dir = self.config.store.dir
        torn = vs.validate_update_commit(store_dir)
        if torn:
            raise RuntimeError(f"refusing to serve a torn store: {torn}")
        manifest = vs.load_manifest(store_dir)
        if (manifest is not None and num_rows is not None
                and len(manifest) != num_rows):
            raise RuntimeError(
                f"row manifest ({len(manifest)} paths) does not match the "
                f"store ({num_rows} rows) — an update() may be writing "
                "concurrently; retry once it completes")
        return manifest

    def _drop_engine(self) -> None:
        """Forget the engine and its manifest (the next use rebuilds)."""
        with self._build_lock:
            self._engine = None
            self._manifest_cache = _UNSET

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

    # -- serving -----------------------------------------------------------------------

    def serve(self, requests, k: Optional[int] = None, depth: int = 1,
              batcher=None):
        """Pipelined request/response serving: yields exactly one response
        dict per request, in request order (the reference's
        ``Pipeline.serve``, ``pipeline.py:724-1077``, and its JSONL
        protocol).

        Requests carry exactly one of ``query`` (a text), ``queries`` (a
        batch of texts), ``vector`` or ``vectors`` (raw embeddings), plus an
        optional ``id`` (echoed) and ``k`` (trimmed from the serve-wide
        ``k``, never above it). Responses: ``{"id", "results": [[{path,
        row, distance}, ...] per query]}`` or ``{"id", "error"}``; a bad
        request never ends the stream. Up to ``depth`` searches stay in
        flight while earlier results copy back. A ``None`` item is a flush
        token: every in-flight response is emitted first. ``{"cmd":
        "reload"}`` drains, then rebuilds the engine and manifest from disk
        (answer ``{"id", "reloaded": true, "rows"}``): without a batcher the
        old store is dropped BEFORE the new one loads (both would not fit
        the card at the largest stores); through a shared ``batcher`` the
        new engine is built first and hot-swapped under it
        (``swap_engine``), and each response formats with the manifest of
        the generation that served it. A reload that fails (an update
        mid-rewrite) answers a retryable error and the next request
        rebuilds.

        Text requests keep their embeddings on the device (no readback and
        re-upload), except through a batcher, which coalesces host rows.
        Batches pad to :func:`_serve_batch_shape` by repeating the last
        query (``torch.cat`` on the device); the padding is trimmed from
        the response."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        k_serve = self.config.search.top_k if k is None else k
        self._warn_encoder_drift("serve")
        engine = self.engine()
        if batcher is not None and batcher.k < min(k_serve,
                                                   engine.store.num_rows):
            raise ValueError(
                f"batcher was built for k={batcher.k} < serve-wide "
                f"top_k={k_serve}; build it with k >= the serve k")
        manifest = self._serve_manifest(int(engine.store.num_rows))
        if batcher is not None:
            # file this store's manifest for the batcher's generation only
            # if the batcher serves this very engine (else: row:N)
            batcher.register_manifest(engine, manifest)
        meta: deque = deque()  # ("error", resp) | ("ok", id, k_req, nq)
        bufs: deque = deque()  # search handles, aligned with the "ok" metas

        def _parse(req):
            """-> (embeddings [Q, dim], req_id, k_req); raises ValueError."""
            if isinstance(req, MalformedRequest):
                raise ValueError(f"malformed JSON: {req.error}")
            if not isinstance(req, dict):
                raise ValueError(
                    f"request must be a JSON object, got {type(req).__name__}")
            req_id = req.get("id")
            k_req = req.get("k", k_serve)
            if isinstance(k_req, bool) or not isinstance(k_req, int) \
                    or k_req <= 0:
                raise ValueError(f"k must be a positive integer, got {k_req!r}")
            if k_req > k_serve:
                raise ValueError(
                    f"k={k_req} exceeds the serve-wide top_k={k_serve} the "
                    "engine was started with; restart serve with a larger "
                    "--top-k")
            kinds = [key for key in ("query", "queries", "vector", "vectors")
                     if key in req]
            if len(kinds) != 1:
                raise ValueError(
                    "request needs exactly one of query/queries/vector/vectors"
                    f" (got {kinds or 'none'})")
            kind = kinds[0]
            if kind in ("query", "queries"):
                texts = ([req["query"]] if kind == "query"
                         else list(req["queries"]))
                if not texts:
                    raise ValueError("queries must be non-empty")
                if not all(isinstance(t, str) for t in texts):
                    raise ValueError("query texts must be strings")
                emb = (None if batcher is not None
                       else self.encoder.get_embeddings_device(texts))
                if emb is None:
                    emb = self.encoder.get_embeddings(texts)
            else:
                vecs = ([req["vector"]] if kind == "vector"
                        else list(req["vectors"]))
                if not vecs:
                    raise ValueError("vectors must be non-empty")
                emb = np.asarray(vecs, dtype=np.float32)
                if emb.ndim != 2:
                    raise ValueError(
                        f"vectors must be rank-2, got shape {emb.shape}")
            # validate against the store that will serve: through a batcher
            # that is the batcher's current engine (another connection may
            # have swapped it)
            store = (batcher.engine if batcher is not None else engine).store
            if emb.shape[1] != store.dim and not (
                    store.matryoshka_from is not None
                    and emb.shape[1] == store.matryoshka_from):
                raise ValueError(
                    f"query dim {emb.shape[1]} != store dim {store.dim}")
            return emb, req_id, k_req

        def _path(idx: int, m) -> str:
            if m is not None and 0 <= idx < len(m):
                return m[idx]
            return f"row:{idx}"

        def _drain(target: int):
            """Emit responses until at most ``target`` searches stay in
            flight; errors at the head of the queue are always emittable."""
            while meta and meta[0][0] == "error":
                yield meta.popleft()[1]
            while len(bufs) > target:
                handle = bufs.popleft()
                _, req_id, k_req, nq = meta.popleft()
                m = manifest
                if batcher is not None:
                    try:
                        ids, dists = handle.result()
                    except Exception as exc:  # noqa: BLE001 — one batch
                        yield {"id": req_id, "error": f"search failed: {exc}"}
                        while meta and meta[0][0] == "error":
                            yield meta.popleft()[1]
                        continue
                    # the manifest of the generation that served this
                    # future; a generation pruned from the window gives
                    # row:N, never a stale manifest's wrong path
                    fut_gen = getattr(handle, "generation", None)
                    if fut_gen is not None:
                        m = batcher.manifest_by_gen.get(fut_gen, None)
                else:
                    ids, dists = engine.collect(handle)
                results = [
                    [{"path": _path(int(i), m), "row": int(i),
                      "distance": float(d)}
                     for i, d in zip(row_ids[:k_req], row_dists[:k_req])]
                    for row_ids, row_dists in zip(ids[:nq].tolist(),
                                                  dists[:nq].tolist())
                ]
                yield {"id": req_id, "results": results}
                while meta and meta[0][0] == "error":
                    yield meta.popleft()[1]

        def _rebuild():
            """A fresh engine and its manifest, atomically against the
            other connections' engine() calls."""
            with self._build_lock:
                self._drop_engine()
                new = self.engine()
                return new, self._serve_manifest(int(new.store.num_rows))

        for req in requests:
            if req is None:  # flush token: answer everything in flight
                yield from _drain(0)
                continue
            if isinstance(req, dict) and req.get("cmd") == "reload":
                rid = req.get("id")
                yield from _drain(0)  # old-engine handles finish first
                if batcher is None:
                    # drop every reference to the old store before the new
                    # one loads
                    engine = manifest = None
                try:
                    new_engine, new_manifest = _rebuild()
                    if batcher is not None:
                        batcher.swap_engine(new_engine, new_manifest)
                except Exception as exc:  # noqa: BLE001 — reload mid-update
                    # never serve a misaligned (store, manifest) pair: a
                    # retryable error, and the next request rebuilds
                    self._drop_engine()
                    yield {"id": rid,
                           "error": f"reload failed: {exc}; retry reload"}
                    continue
                engine, manifest = new_engine, new_manifest
                self._warn_encoder_drift("serve")
                yield {"id": rid, "reloaded": True,
                       "rows": int(engine.store.num_rows)}
                continue
            if engine is None and batcher is None:
                # a previous reload failed: rebuild per request, answering
                # retryable errors until the update commits (before _parse,
                # whose dim check reads the store)
                try:
                    engine, manifest = _rebuild()
                except Exception as exc:  # noqa: BLE001
                    self._drop_engine()
                    rid = req.get("id") if isinstance(req, dict) else None
                    meta.append(("error", {
                        "id": rid, "error": f"store unavailable: {exc}; retry",
                    }))
                    yield from _drain(depth)
                    continue
            try:
                emb, req_id, k_req = _parse(req)
            except Exception as exc:  # noqa: BLE001 — bad request != dead server
                rid = req.get("id") if isinstance(req, dict) else None
                meta.append(("error", {"id": rid, "error": str(exc)}))
                yield from _drain(depth)
                continue
            nq = emb.shape[0]
            if batcher is not None:
                # the batcher pads and coalesces itself; submit before the
                # meta entry, so a refusal leaves nothing orphaned
                try:
                    handle = batcher.submit(emb)
                except Exception as exc:  # noqa: BLE001
                    meta.append(("error", {"id": req_id, "error": str(exc)}))
                    yield from _drain(depth)
                    continue
                meta.append(("ok", req_id, k_req, nq))
                bufs.append(handle)
                yield from _drain(depth)
                continue
            padded = _serve_batch_shape(nq)
            if padded != nq:
                if isinstance(emb, torch.Tensor):  # stays on the device
                    emb = torch.cat([emb, emb[-1:].expand(padded - nq, -1)])
                else:
                    emb = np.concatenate(
                        [emb, np.repeat(emb[-1:], padded - nq, axis=0)])
            meta.append(("ok", req_id, k_req, nq))
            bufs.append(engine.search_async(
                emb, k_serve, upload=self.config.search.query_upload))
            yield from _drain(depth)
        yield from _drain(0)

    # -- incremental update ----------------------------------------------------------

    def update(self) -> IngestStats:
        """Reconcile the global store with the corpus (the reference's
        ``Pipeline.update``, ``pipeline.py:1114-1376``, on one host):

        * new files (not in the manifest) are embedded and appended;
        * edited files — per-row identity ``[size, mtime_ns, fingerprint]``:
          size and mtime as the no-read fast path, the fingerprint as the
          truth — are re-embedded IN PLACE (their row ids stay);
        * deleted (or now unreadable, oversized or empty) files' rows are
          compacted away; later rows shift down and the rewritten manifest
          is the authority.

        Rows with no recorded identity are kept as they are. The store,
        manifest and attrs are three atomic renames; the update-commit
        marker written last binds them (a crash in between is detected and
        refused by loaders), and ``global.parquet.ahead`` makes a later
        merge refuse to drop the new rows. The engine and manifest cache
        are dropped: the next search (or a server's ``reload``) loads the
        reconciled store. Across processes rank 0 updates and the other
        ranks wait at a barrier, then drop their engines too."""
        cfg = self.config
        stats = IngestStats()
        proc, _ = _process_info()
        try:
            if proc == 0:
                return self._update(cfg, stats)
            return stats
        finally:
            try:
                _host_barrier("update")
            finally:
                self._drop_engine()

    def _update(self, cfg, stats: IngestStats) -> IngestStats:
        files = find_files_by_extensions(cfg.corpus.root, cfg.corpus.extensions)
        stats.files_found = len(files)
        manifest = vs.load_manifest(cfg.store.dir) or []
        attrs = vs.load_attrs(cfg.store.dir) or []
        attrs = (attrs + [None] * len(manifest))[: len(manifest)]
        if not files and manifest:
            # an empty walk against a populated store is far more likely a
            # bad root than a mass deletion: never compact everything away
            raise RuntimeError(
                f"update: no files found under {cfg.corpus.root} "
                f"(extensions {cfg.corpus.extensions}) but the store holds "
                f"{len(manifest)} rows — refusing to compact everything "
                "away; check the corpus root, or run a full ingest to "
                "rebuild intentionally")
        known = set(manifest)
        fset = {str(f) for f in files}
        new_files = [f for f in files if str(f) not in known]
        stats.files_assigned = len(new_files)
        store_rows = vs.parquet_row_count(vs.global_store_path(cfg.store.dir))
        if store_rows != len(manifest):
            raise RuntimeError(
                f"manifest ({len(manifest)} paths) out of sync with store "
                f"({store_rows} rows) — rebuild with a full ingest")
        torn = vs.validate_update_commit(cfg.store.dir)
        if torn:
            raise RuntimeError(f"update: torn store detected: {torn}")

        # classify every row: deleted / edited / identity refresh (touched,
        # same content) / unchanged
        deleted: List[int] = []
        edited_rows: Dict[str, int] = {}   # path -> row
        edited_attr: Dict[str, list] = {}  # path -> classification identity
        refresh: Dict[int, Optional[list]] = {}  # row -> new identity
        pre_attrs_rows = 0
        for i, (p, a) in enumerate(zip(manifest, attrs)):
            if p not in fset:
                deleted.append(i)
                continue
            if a is None:
                pre_attrs_rows += 1
                continue
            try:
                st = os.stat(p)
            except OSError:
                deleted.append(i)
                continue
            if st.st_size == a[0] and st.st_mtime_ns == a[1]:
                continue
            content = read_file(p, cfg.corpus.max_file_bytes)
            if not content:
                # ingest never stores empty or unreadable files: the row goes
                deleted.append(i)
                continue
            fp = content_fingerprint(content)
            if fp == a[2]:
                refresh[i] = [st.st_size, st.st_mtime_ns, a[2]]
            else:
                edited_rows[p] = i
                # the fallback identity if the re-embed pass's own stat fails
                edited_attr[p] = [st.st_size, st.st_mtime_ns, fp]
        if pre_attrs_rows:
            host_log(f"update: {pre_attrs_rows} rows have no recorded file "
                     "identity (pre-attrs store) — edits to those files are "
                     "undetectable; run a full ingest to record identities")
        if not (new_files or edited_rows or deleted or refresh):
            host_log("update: store already covers the corpus")
            return stats

        self._warn_encoder_drift("update")
        timer = self.bench.start("embedding_generation")
        replacements: Dict[int, np.ndarray] = {}
        appended: List[np.ndarray] = []
        new_paths: List[str] = []
        new_attrs: List = []
        to_embed = [Path(p) for p in edited_rows] + list(new_files)

        def on_batch(batch_idx, files_through, kept, emb) -> None:
            if emb is None or not kept:
                return
            for (p, _c, a), vec in zip(kept, emb):
                sp = str(p)
                row = edited_rows.get(sp)
                if row is not None:
                    replacements[row] = np.asarray(vec, dtype=np.float32)
                    refresh[row] = a if a is not None else edited_attr.get(sp)
                else:
                    appended.append(np.asarray(vec, dtype=np.float32))
                    new_paths.append(sp)
                    new_attrs.append(a)

        if to_embed:
            self._embed_paths_pipelined(to_embed, stats, on_batch)
        stats.rows_reembedded = len(replacements)
        stats.rows_deleted = len(deleted)
        stats.embeddings = len(appended)

        store_changed = bool(replacements or deleted or appended)
        if store_changed:
            # rows are materialized only here; take_matrix hands over the
            # store's own buffer, edited in place (one copy at most)
            gstore = vs.global_store(cfg.store.dir, empty=False)
            mat = gstore.take_matrix()
            for i, vec in replacements.items():
                mat[i] = vec
            for i, a in refresh.items():
                attrs[i] = a
            if deleted:
                keep = np.ones(len(manifest), dtype=bool)
                keep[deleted] = False
                if mat.size:
                    # blocked in-place compaction: no second full matrix
                    write, blk = 0, 65536
                    for start in range(0, len(manifest), blk):
                        sel = keep[start:start + blk]
                        n = int(sel.sum())
                        if n:
                            mat[write:write + n] = mat[start:start + blk][sel]
                            write += n
                    mat = mat[:write]
                manifest = [p for j, p in enumerate(manifest) if keep[j]]
                attrs = [a for j, a in enumerate(attrs) if keep[j]]
            if mat.size:
                gstore.append_many(mat)
            if appended:
                gstore.append_many(np.stack(appended))
                manifest.extend(new_paths)
                attrs.extend(new_attrs)
            gstore.persist()
        else:
            for i, a in refresh.items():
                attrs[i] = a
        vs.atomic_write_text(vs.manifest_path(cfg.store.dir),
                             json.dumps(manifest))
        vs.atomic_write_text(vs.attrs_path(cfg.store.dir), json.dumps(attrs))
        # COMMIT POINT: binds the renamed (store, manifest, attrs) triple
        vs.write_update_commit(cfg.store.dir)
        if store_changed:
            # global.parquet now holds rows no shard has: a merge must refuse
            vs.global_ahead_marker(cfg.store.dir).write_text(json.dumps({
                "rows": gstore.count,
                "appended": stats.embeddings,
                "reembedded": stats.rows_reembedded,
                "deleted": stats.rows_deleted,
            }))
        self.bench.record(timer.stop(
            items_processed=stats.embeddings + stats.rows_reembedded))
        host_log(f"update: appended {stats.embeddings} embeddings, "
                 f"re-embedded {stats.rows_reembedded} rows, deleted "
                 f"{stats.rows_deleted} rows ({stats.files_skipped} skipped)")
        return stats

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
        queries = engine.store.take_rows(q_rows).to(torch.float32).cpu().numpy()

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
