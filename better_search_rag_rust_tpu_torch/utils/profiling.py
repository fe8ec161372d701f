"""Device profiling on ``torch.profiler``.

Counterpart of ``better_search_rag_rust_tpu/utils/profiling.py`` (:33-64):
``device_trace`` captures a trace of the enclosed block (host ops and, on a
CUDA card, every kernel with its device time) and writes it into
``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto);
``annotate`` names a span inside it, also as an NVTX range on the card;
``memory_stats`` reports each card's bytes in use and its capacity under the
JAX package's keys.

Usage::

    with device_trace("/tmp/bsr-trace"):
        with annotate("search"):
            engine.search(queries)
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from .logging import host_log


@contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed block and write ``trace_<pid>_<ms>.json`` into
    ``log_dir`` (created if missing). CUDA activity is recorded when a card
    is present; a CPU run records the host ops only."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(path))
        host_log(f"device trace written to {path}")


@contextmanager
def annotate(name: str):
    """Named span inside a trace: a ``record_function`` range and, on a
    CUDA card, an NVTX range of the same name."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def memory_stats() -> dict:
    """Per-card memory: ``{device: {"bytes_in_use", "bytes_limit"}}`` —
    the caching allocator's allocated bytes and the card's capacity. Empty
    without a CUDA card, as the JAX function is where its backend reports
    nothing."""
    stats = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        _free, total = torch.cuda.mem_get_info(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_stats(i).get(
                "allocated_bytes.all.current", 0),
            "bytes_limit": total,
        }
    return stats
