"""Benchmark harness: phase timers and the report, for one process.

Counterpart of ``better_search_rag_rust_tpu/bench/harness.py`` with the same
report shape (per-op min / max / avg, items/s, optional speedup against a
sequential baseline). The port runs one process, so there is no cross-host
gather: every op's min, max and avg are over this process's recordings.

Device work runs asynchronously; a timer stopped with the device it timed
calls ``torch.cuda.synchronize`` first, so it measures execution, not
dispatch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch


def format_time(seconds: float) -> str:
    """Humanize a duration."""
    if seconds < 1e-6:
        return f"{seconds * 1e9:.2f} ns"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.2f} µs"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    if seconds < 60.0:
        return f"{seconds:.2f} s"
    mins, secs = divmod(seconds, 60.0)
    return f"{int(mins)}m {secs:.1f}s"


@dataclass
class BenchmarkTiming:
    """One timed operation."""

    name: str
    duration: float  #: seconds
    items_processed: Optional[int] = None


class BenchmarkTimer:
    def __init__(self, name: str):
        self.name = name
        self._t0 = time.perf_counter()

    def stop(self, items_processed: Optional[int] = None,
             device: Optional[torch.device] = None) -> BenchmarkTiming:
        """End the timing; with a CUDA ``device``, wait for its work first."""
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return BenchmarkTiming(self.name, time.perf_counter() - self._t0,
                               items_processed)


class BenchmarkManager:
    """Records timings by op name and prints the reference's report."""

    def __init__(self):
        self._timings: Dict[str, List[BenchmarkTiming]] = {}

    def start(self, name: str) -> BenchmarkTimer:
        return BenchmarkTimer(name)

    def record(self, timing: BenchmarkTiming) -> None:
        self._timings.setdefault(timing.name, []).append(timing)

    def generate_report(
        self, sequential_times: Optional[Dict[str, float]] = None
    ) -> str:
        """Printable per-op report: min / max / avg, items/s over the total
        time, and the speedup against ``sequential_times`` where given."""
        lines = ["", "=" * 72, "BENCHMARK REPORT", "=" * 72]
        lines.append(f"{'operation':<28}{'min':>10}{'max':>10}{'avg':>10}  notes")
        lines.append("-" * 72)
        for name in sorted(self._timings):
            durs = [t.duration for t in self._timings[name]]
            items = [t.items_processed for t in self._timings[name]
                     if t.items_processed is not None]
            total = sum(durs)
            notes = []
            if items and total > 0:
                notes.append(f"{sum(items) / total:,.1f} items/s")
            if sequential_times and name in sequential_times and max(durs) > 0:
                notes.append(f"speedup {sequential_times[name] / max(durs):.2f}x")
            lines.append(
                f"{name:<28}{format_time(min(durs)):>10}"
                f"{format_time(max(durs)):>10}"
                f"{format_time(total / len(durs)):>10}  {' '.join(notes)}"
            )
        lines.append("=" * 72)
        return "\n".join(lines)
