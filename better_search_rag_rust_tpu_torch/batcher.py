"""Dynamic cross-request micro-batching for the serving path.

Counterpart of ``better_search_rag_rust_tpu/batcher.py`` with its surface and
semantics (``:76-357``): ``submit`` returns a future resolving to exactly
what ``engine.search`` of the submitted rows returns; requests landing
within ``window_ms`` (or until ``max_batch`` rows wait) coalesce into one
dispatch, padded to the serve batch shapes
(:func:`..pipeline._serve_batch_shape`); a former thread dispatches
asynchronously (``engine.search_async``) and a collector thread resolves
the futures, so batch i+1 accumulates while batch i runs on the card; a
queue of ``depth`` dispatched-but-uncollected batches applies
backpressure. ``swap_engine`` hot-swaps the engine behind the batcher and
tags every future with the generation that served it, so a serve loop
formats each response with the manifest of the store that produced its
row ids (``manifest_by_gen``, ``register_manifest``).

The port's own module: the reference's imports its JAX pipeline, and its
memory check reads JAX device stats. Here the swap refusal reads the card's
memory (:func:`_device_bytes_limit`); it is skipped only for stores on the
CPU.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["DynamicBatcher", "BatcherStats"]


def _device_bytes_limit(tensors) -> int:
    """Total memory of the CUDA devices holding ``tensors``; 0 when they all
    lie on the CPU, whose only bound is host RAM. Module-level so a test can
    inject a limit."""
    devices = {t.device for t in tensors}
    return sum(torch.cuda.get_device_properties(d).total_memory
               for d in devices if d.type == "cuda")


@dataclass
class BatcherStats:
    """Counters (updated under the batcher lock)."""

    requests: int = 0  #: submit() calls accepted
    queries: int = 0  #: query rows submitted
    batches: int = 0  #: dispatches issued
    batched_queries: int = 0  #: rows dispatched (== queries once drained)

    def coalescing(self) -> float:
        """Mean queries per dispatch (1.0 = no coalescing happened)."""
        return self.batched_queries / self.batches if self.batches else 0.0


@dataclass
class _Pending:
    emb: np.ndarray
    nq: int
    future: "Future[Tuple[np.ndarray, np.ndarray]]" = field(
        default_factory=Future)


class DynamicBatcher:
    """Coalesce concurrent search requests into shared dispatches."""

    def __init__(self, engine, k: Optional[int] = None, max_batch: int = 1024,
                 window_ms: float = 2.0, depth: int = 2, upload: str = "f32"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if window_ms < 0:
            raise ValueError(f"window_ms must be >= 0, got {window_ms}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.engine = engine
        self.k = engine._resolve_k(k)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.upload = upload
        self.stats = BatcherStats()
        #: Bumped by :meth:`swap_engine`; resolved futures carry the
        #: ``generation`` that served them, and :attr:`manifest_by_gen`
        #: maps generations to row -> path manifests.
        self.generation = 0
        self.manifest_by_gen: dict = {}
        self._requested_k = k
        self._dim = engine.store.dim
        self._mat_from = engine.store.matryoshka_from

        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending: List[_Pending] = []
        self._pending_rows = 0
        self._closed = False
        self._inflight: "queue.Queue" = queue.Queue(maxsize=depth)
        self._former = threading.Thread(
            target=self._form_loop, name="bsr-batch-former", daemon=True)
        self._collector = threading.Thread(
            target=self._collect_loop, name="bsr-batch-collector", daemon=True)
        self._former.start()
        self._collector.start()

    # -- client side ---------------------------------------------------------

    def submit(self, embeddings) -> "Future[Tuple[np.ndarray, np.ndarray]]":
        """Queue ``[Q, dim]`` f32 embeddings (``[dim]`` is promoted) for the
        next coalesced dispatch. A dim mismatch raises here: the caller's
        request is bad, the shared batch must not die for it."""
        emb = np.atleast_2d(np.asarray(embeddings, dtype=np.float32))
        if emb.shape[1] != self._dim and not (
                self._mat_from is not None and emb.shape[1] == self._mat_from):
            raise ValueError(
                f"query dim {emb.shape[1]} != store dim {self._dim}")
        if self._mat_from is not None and emb.shape[1] == self._mat_from:
            emb = np.ascontiguousarray(emb[:, : self._dim])
        item = _Pending(emb=emb, nq=emb.shape[0])
        with self._nonempty:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._pending.append(item)
            self._pending_rows += item.nq
            self.stats.requests += 1
            self.stats.queries += item.nq
            self._nonempty.notify_all()
        return item.future

    def register_manifest(self, engine, manifest) -> bool:
        """File ``manifest`` under the CURRENT generation iff the batcher
        still serves ``engine`` (the engine the manifest describes); the
        first registration of a generation wins. On False callers format
        ``row:N`` (fail safe, never another store's paths)."""
        with self._lock:
            if self.engine is not engine:
                return False
            self.manifest_by_gen.setdefault(self.generation, manifest)
            return True

    def _check_swap_memory(self, engine, force: bool) -> None:
        """Refuse a swap whose transient double residency (old and new
        store, both live until in-flight handles drop) would pass 90 % of
        the card's memory."""
        if force:
            return
        old_bytes = self.engine.store.data.nbytes
        new_bytes = engine.store.data.nbytes
        limit = _device_bytes_limit((self.engine.store.data,
                                     engine.store.data))
        if limit and old_bytes + new_bytes > 0.9 * limit:
            raise RuntimeError(
                f"swap_engine: old ({old_bytes / 1e9:.2f} GB) + new "
                f"({new_bytes / 1e9:.2f} GB) device stores exceed 90% of "
                f"device memory ({limit / 1e9:.2f} GB); the transient "
                "double-residency would OOM mid-serve. Use the batcher-less "
                "drain-then-rebuild reload (drops the old store first), or "
                "pass force=True if the headroom is real.")

    def swap_engine(self, engine, manifest=None, force: bool = False) -> int:
        """Hot-swap the engine: batches formed after the swap run on the new
        one, batches in flight finish on the old one (their futures carry
        the old generation). The dim must match; ``k`` re-resolves against
        the new store. ``manifest`` is registered with the generation bump,
        atomically. Returns the new generation."""
        self._check_swap_memory(engine, force)
        if engine.store.dim != self._dim:
            raise ValueError(
                f"swap_engine: store dim {engine.store.dim} != the dim this "
                f"batcher was built for ({self._dim})")
        k_new = engine._resolve_k(self._requested_k)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self.engine = engine
            self.k = k_new
            self._mat_from = engine.store.matryoshka_from
            self.generation += 1
            self.manifest_by_gen[self.generation] = manifest
            # futures are at most a few dispatches old (depth-bounded): a
            # window of 8 generations back is all a caller can still need
            for g in [g for g in self.manifest_by_gen
                      if g < self.generation - 8]:
                del self.manifest_by_gen[g]
            return self.generation

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain everything in flight, join threads."""
        with self._nonempty:
            if self._closed:
                return
            self._closed = True
            self._nonempty.notify_all()
        self._former.join(timeout=timeout)
        self._inflight.put(None)  # collector stop token, after the former
        self._collector.join(timeout=timeout)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- former thread: accumulate -> dispatch --------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a batch is ready (window elapsed or max_batch rows),
        or None once closed with nothing pending."""
        with self._nonempty:
            while not self._pending and not self._closed:
                self._nonempty.wait()
            if not self._pending:
                return None
            deadline = time.monotonic() + self.window_s
            while self._pending_rows < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(timeout=remaining)
            batch = self._pending
            self._pending = []
            self._pending_rows = 0
            return batch

    def _form_loop(self) -> None:
        from .pipeline import _serve_batch_shape

        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                total = sum(p.nq for p in batch)
                emb = (batch[0].emb if len(batch) == 1
                       else np.concatenate([p.emb for p in batch], axis=0))
                padded = _serve_batch_shape(total)
                if padded != total:
                    emb = np.concatenate(
                        [emb, np.repeat(emb[-1:], padded - total, axis=0)])
                with self._lock:  # engine, k and generation as one snapshot
                    eng, kk, gen = self.engine, self.k, self.generation
                handle = eng.search_async(emb, kk, upload=self.upload)
                with self._lock:
                    self.stats.batches += 1
                    self.stats.batched_queries += total
            except Exception as exc:  # noqa: BLE001 — fail THIS batch only
                for p in batch:
                    if not p.future.cancelled():
                        p.future.set_exception(exc)
                continue
            self._inflight.put((handle, eng, gen, batch))

    # -- collector thread: collect -> resolve ----------------------------------

    def _collect_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            handle, eng, gen, batch = got  # collect on the dispatching engine
            try:
                ids, dists = eng.collect(handle)
            except Exception as exc:  # noqa: BLE001
                for p in batch:
                    if not p.future.cancelled():
                        p.future.generation = gen
                        p.future.set_exception(exc)
                continue
            off = 0
            for p in batch:
                if not p.future.cancelled():
                    # tag before resolving: no reader sees a resolved future
                    # without its generation
                    p.future.generation = gen
                    p.future.set_result((ids[off:off + p.nq],
                                         dists[off:off + p.nq]))
                off += p.nq
