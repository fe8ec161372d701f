"""Store configurations of the search measurements.

The port's copy of ``SearchSuite`` and ``SUITES`` of
``better_search_rag_rust_tpu/bench/suite.py`` (:64-118), with the same
names, shapes and dtypes, so a suite name means one store in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class SearchSuite:
    rows: int
    dim: int
    queries: int
    top_k: int
    store_dtype: str = "bfloat16"
    matryoshka_dim: Optional[int] = None
    iters: int = 8
    chunk_rows: int = 16384
    baseline_rows: int = 100_000
    baseline_queries: int = 8


SUITES: Dict[str, SearchSuite] = {
    # BASELINE.json config 4: "1M synthetic 768-d vectors, 1024-query batch,
    # top-100, bf16 scoring with f32 accumulation"
    "search_1m": SearchSuite(rows=1_000_000, dim=768, queries=1024, top_k=100),
    "search_100k": SearchSuite(
        rows=100_000, dim=768, queries=256, top_k=100, iters=16
    ),
    # BASELINE.json config 5: "10M vectors ... Matryoshka 256-d truncation
    # at equal memory"
    "search_10m_mat256": SearchSuite(
        rows=10_000_000, dim=256, queries=1024, top_k=100,
        matryoshka_dim=256, iters=4, chunk_rows=65536,
    ),
    # The reference's own store dtype (src/vectorstore/polars.rs:35-37).
    "search_1m_f32": SearchSuite(
        rows=1_000_000, dim=768, queries=1024, top_k=100,
        store_dtype="float32", iters=4,
    ),
    # int8 lattice stores (exact vs the integer oracle — ops/quantize.py),
    # half of bf16's device bytes.
    "search_1m_int8": SearchSuite(
        rows=1_000_000, dim=768, queries=1024, top_k=100,
        store_dtype="int8",
    ),
    "search_10m_int8_mat256": SearchSuite(
        rows=10_000_000, dim=256, queries=1024, top_k=100,
        matryoshka_dim=256, iters=4, chunk_rows=65536, store_dtype="int8",
    ),
    # 10M x full 768-d: 7.7 GB resident as int8.
    "search_10m_int8": SearchSuite(
        rows=10_000_000, dim=768, queries=1024, top_k=100,
        iters=4, chunk_rows=65536, store_dtype="int8",
    ),
}
