"""The ``serve`` measurement: many concurrent clients through the micro-batcher.

Counterpart of ``run_serve_suite`` (``better_search_rag_rust_tpu/bench/
suite.py:406-560``) with its parameters and output keys: ``clients`` threads
each issue ``requests_per_client`` single-query requests, ``outstanding`` in
flight per client, through one :class:`..batcher.DynamicBatcher`
(``window_ms``, ``depth``); the baseline is the same queries one dispatch
each, serially (``single_request_qps``). The store configurations are the
reference's ``SUITES`` (its module imports no jax); the store is generated
on the card from ``seed``.

Timing is wall clock around the futures (a request's latency runs from its
submit to its result). Nothing compiles per batch shape here, so there is no
warm-up ladder; one warm-up round of every client runs before the timed one.
Every answered request is also held against ``engine.search`` of the same
query (``mismatched`` counts the responses whose ids or distances differ).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from better_search_rag_rust_tpu.bench.suite import SUITES, SearchSuite

from ..batcher import DynamicBatcher
from ..config import SearchConfig
from ..ops.engine import SearchEngine
from ..pipeline import _serve_batch_shape
from ..store.device_store import DeviceStore
from ..utils.device import resolve_device

__all__ = ["SUITES", "SearchSuite", "run_serve_suite"]


def run_serve_suite(base: str = "search_1m", clients: int = 64,
                    requests_per_client: int = 24, window_ms: float = 2.0,
                    depth: int = 2, warm_requests: int = 4,
                    outstanding: int = 1, upload: str = "f32",
                    suite: Optional[SearchSuite] = None, *, seed: int = 0,
                    store: Optional[DeviceStore] = None,
                    device: Optional[torch.device | str] = None) -> dict:
    """Serve q/s, p50/p99 latency, coalescing and recall@10 of ``clients``
    concurrent clients on the ``base`` suite's store (or ``store``, already
    built at that configuration)."""
    suite = suite or SUITES[base]
    if store is None:
        store = DeviceStore.synthetic(suite.rows, suite.dim, suite.store_dtype,
                                      seed, device=resolve_device(device))
    engine = SearchEngine(store, SearchConfig(
        top_k=suite.top_k, chunk_rows=suite.chunk_rows,
        store_dtype=suite.store_dtype))
    q_idx = np.linspace(0, store.num_rows - 1, clients, dtype=np.int64)
    queries = store.data[torch.from_numpy(q_idx).to(store.device)].to(
        torch.float32).cpu().numpy()
    if upload == "store" and not engine.supports_store_upload():
        upload = "f32"
    want_ids, want_d = engine.search(queries, suite.top_k)

    # baseline: one dispatch per request, serially
    n_single = min(32, clients * requests_per_client)
    engine.search(queries[:1], k=suite.top_k)
    t0 = time.perf_counter()
    for i in range(n_single):
        engine.search(queries[i % clients][None], k=suite.top_k)
    single_qps = n_single / max(time.perf_counter() - t0, 1e-9)

    lock = threading.Lock()
    latencies: list = []
    hits: list = []
    errors: list = []
    mismatched = [0]

    def client_loop(ci: int, n: int, record: bool) -> None:
        inflight: deque = deque()
        issued = 0
        while issued < n or inflight:
            while issued < n and len(inflight) < outstanding:
                inflight.append((time.perf_counter(),
                                 batcher.submit(queries[ci])))
                issued += 1
            t_req, fut = inflight.popleft()
            try:
                ids, dists = fut.result()
            except Exception as exc:  # noqa: BLE001 — count, keep serving
                with lock:
                    errors.append(f"client {ci}: {exc!r}")
                continue
            dt = time.perf_counter() - t_req
            same = (np.array_equal(ids[0], want_ids[ci])
                    and np.array_equal(dists[0], want_d[ci]))
            with lock:
                mismatched[0] += not same
                if record:
                    latencies.append(dt)
                    hits.append(int(q_idx[ci]) in ids[0, :min(10, suite.top_k)])

    def run_clients(n: int, record: bool) -> float:
        start = threading.Barrier(clients + 1)
        threads = [threading.Thread(
            target=lambda c=ci: (start.wait(), client_loop(c, n, record)),
            daemon=True) for ci in range(clients)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    with DynamicBatcher(engine, k=suite.top_k,
                        max_batch=_serve_batch_shape(clients * outstanding),
                        window_ms=window_ms, depth=depth,
                        upload=upload) as batcher:
        run_clients(warm_requests, record=False)
        warm_batches = batcher.stats.batches
        warm_rows = batcher.stats.batched_queries
        errors.clear()
        wall = run_clients(requests_per_client, record=True)
        timed_batches = batcher.stats.batches - warm_batches
        timed_rows = batcher.stats.batched_queries - warm_rows

    n_req = clients * requests_per_client
    answered = len(latencies)
    if answered == 0:
        raise RuntimeError(f"serve suite: every request failed: {errors[:3]}")
    serve_qps = answered / max(wall, 1e-9)
    lat = np.sort(np.asarray(latencies))
    return {
        "metric": "serve_qps",
        "value": serve_qps,
        "unit": "queries/sec",
        "vs_baseline": serve_qps / max(single_qps, 1e-9),
        "recall_at_10": float(np.mean(hits)),
        "single_request_qps": single_qps,
        "coalescing": timed_rows / timed_batches if timed_batches else 0.0,
        "answered": answered,
        "failed": len(errors),
        "mismatched": mismatched[0],
        "p50_latency_ms": float(lat[len(lat) // 2]) * 1e3,
        "p99_latency_ms": float(lat[min(int(len(lat) * 0.99),
                                        len(lat) - 1)]) * 1e3,
        "clients": clients,
        "outstanding": outstanding,
        "upload": upload,
        "requests": n_req,
        "window_ms": window_ms,
        "depth": depth,
        "rows": store.num_rows,
        "dim": store.dim,
        "top_k": suite.top_k,
        "store_dtype": suite.store_dtype,
        "kernel": engine.kernel_name(suite.top_k),
        "devices": 1,
        "platform": store.device.type,
    }
