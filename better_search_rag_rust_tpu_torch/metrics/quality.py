"""Distance + IR-quality metrics: the port's copy of
``better_search_rag_rust_tpu/metrics/quality.py`` (numpy only), kept line
for line so both packages score results alike.

Capability parity with the reference's metric kernels
(reference: src/metrics.rs:1-165 and src/mpi_helpers/metrics.rs:217-249):

* ``cosine_distance`` — the scalar distance oracle, edge cases included.
* ``mean_reciprocal_rank`` / ``recall_at_k`` / ``top_k_overlap`` — batch IR
  metrics. The primary API here is **index-based** (queries and results are
  identified by store row ids), which is cleaner and O(1) per comparison; the
  reference matches result *vectors* element-wise within 1e-10
  (src/metrics.rs:7-19 ``vectors_are_identical``), so ``*_by_vectors``
  variants with identical semantics are provided for parity.
* ``accuracy_metrics_for_query`` — the driver's single-query self-retrieval
  report (src/mpi_helpers/metrics.rs:217-249).

``top_k_overlap`` is the reference's parallel-vs-sequential exactness oracle
(SURVEY.md §4); the search test-harness asserts it equals 1.0 between the
engine and the serial scan.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: Element-wise identity tolerance (reference: src/metrics.rs:14).
IDENTITY_ATOL = 1e-10


def vectors_are_identical(a: np.ndarray, b: np.ndarray) -> bool:
    """Element-wise identity within 1e-10 (reference: src/metrics.rs:7-19)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return False
    return bool(np.all(np.abs(a - b) <= IDENTITY_ATOL))


def cosine_distance(a: Sequence[float], b: Sequence[float]) -> float:
    """Scalar cosine distance oracle (reference: src/metrics.rs:143-165).

    Semantics preserved exactly:

    * length mismatch or empty input  -> 1.0   (src/metrics.rs:144-146)
    * element-wise identical vectors  -> 0.0   (src/metrics.rs:148-151)
    * zero-magnitude side             -> 1.0   (src/metrics.rs:157-159)
    * otherwise ``1 - clip(cos_sim, -1, 1)``   (src/metrics.rs:161-164)
    """
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape or a.size == 0:
        return 1.0
    if vectors_are_identical(a, b):
        return 0.0
    dot = float(np.dot(a, b))
    mag_a = float(np.sqrt(np.dot(a, a)))
    mag_b = float(np.sqrt(np.dot(b, b)))
    if mag_a == 0.0 or mag_b == 0.0:
        return 1.0
    sim = max(-1.0, min(1.0, dot / (mag_a * mag_b)))
    return 1.0 - sim


# ---------------------------------------------------------------------------
# Index-based batch metrics (primary API)
# ---------------------------------------------------------------------------


def mean_reciprocal_rank(
    relevant: Sequence[int], results: Sequence[Sequence[int]]
) -> float:
    """MRR over queries given, per query, the relevant store row id and the
    ranked list of retrieved row ids.

    A missing relevant id counts as rank ``len(results)+1``
    (reference: src/metrics.rs:50-53).
    """
    if len(relevant) == 0 or len(results) == 0 or len(relevant) != len(results):
        return 0.0
    total = 0.0
    for rel, res in zip(relevant, results):
        rank = 0
        for i, idx in enumerate(res):
            if idx == rel:
                rank = i + 1
                break
        if rank == 0:
            rank = len(res) + 1
        total += 1.0 / rank
    return total / len(relevant)


def recall_at_k(
    relevant: Sequence[int], results: Sequence[Sequence[int]], k: int
) -> float:
    """Fraction of queries whose relevant id appears in the top
    ``min(k, len(results))`` (reference: src/metrics.rs:60-96)."""
    if len(relevant) == 0 or len(results) == 0 or len(relevant) != len(results):
        return 0.0
    hits = 0
    for rel, res in zip(relevant, results):
        if rel in list(res)[: min(k, len(res))]:
            hits += 1
    return hits / len(relevant)


def top_k_overlap(
    sequential: Sequence[Sequence[int]],
    parallel: Sequence[Sequence[int]],
    k: int,
) -> float:
    """Mean pairwise set overlap / k between two result lists
    (reference: src/metrics.rs:98-141). 1.0 means the parallel engine is
    exact w.r.t. the sequential oracle."""
    if (
        len(sequential) == 0
        or len(parallel) == 0
        or len(sequential) != len(parallel)
    ):
        return 0.0
    total = 0.0
    for seq, par in zip(sequential, parallel):
        actual_k = min(k, len(seq), len(par))
        if actual_k == 0:
            # reference skips the query but still divides by total queries
            # (src/metrics.rs:115-117,140)
            continue
        overlap = len(set(list(seq)[:actual_k]) & set(list(par)[:actual_k]))
        total += overlap / actual_k
    return total / len(sequential)


# ---------------------------------------------------------------------------
# Vector-identity batch metrics (reference-parity API)
# ---------------------------------------------------------------------------


def _find_identical(query: np.ndarray, results: Sequence[np.ndarray]) -> int:
    """1-based rank of the first result identical to ``query``, else 0."""
    for i, r in enumerate(results):
        if vectors_are_identical(query, r):
            return i + 1
    return 0


def mean_reciprocal_rank_by_vectors(
    queries: Sequence[np.ndarray],
    results: Sequence[Sequence[np.ndarray]],
    ids_map: Optional[Dict[int, int]] = None,
) -> float:
    """Reference-exact MRR matching result *vectors* element-wise
    (reference: src/metrics.rs:21-58). ``ids_map`` is accepted for signature
    parity; like the reference, it does not affect the result."""
    del ids_map
    if len(queries) == 0 or len(results) == 0 or len(queries) != len(results):
        return 0.0
    total = 0.0
    for q, res in zip(queries, results):
        rank = _find_identical(np.asarray(q), res)
        if rank == 0:
            rank = len(res) + 1
        total += 1.0 / rank
    return total / len(queries)


def recall_at_k_by_vectors(
    queries: Sequence[np.ndarray],
    results: Sequence[Sequence[np.ndarray]],
    k: int,
    ids_map: Optional[Dict[int, int]] = None,
) -> float:
    """Reference-exact recall@k by vector identity
    (reference: src/metrics.rs:60-96)."""
    del ids_map
    if len(queries) == 0 or len(results) == 0 or len(queries) != len(results):
        return 0.0
    hits = 0
    for q, res in zip(queries, results):
        actual_k = min(k, len(res))
        if _find_identical(np.asarray(q), list(res)[:actual_k]) > 0:
            hits += 1
    return hits / len(queries)


def top_k_overlap_by_vectors(
    sequential: Sequence[Sequence[np.ndarray]],
    parallel: Sequence[Sequence[np.ndarray]],
    k: int,
) -> float:
    """Reference-exact top-k overlap by vector identity
    (reference: src/metrics.rs:98-141)."""
    if (
        len(sequential) == 0
        or len(parallel) == 0
        or len(sequential) != len(parallel)
    ):
        return 0.0
    total = 0.0
    for seq, par in zip(sequential, parallel):
        actual_k = min(k, len(seq), len(par))
        if actual_k == 0:
            continue
        count = 0
        for i in range(actual_k):
            for j in range(actual_k):
                if vectors_are_identical(np.asarray(seq[i]), np.asarray(par[j])):
                    count += 1
                    break
        total += count / actual_k
    return total / len(sequential)


# ---------------------------------------------------------------------------
# Driver-path single-query accuracy report
# ---------------------------------------------------------------------------


def accuracy_metrics_for_query(
    top_k_results: Sequence[Tuple[int, float]],
    query_idx: int,
    top_k: int,
) -> Tuple[float, float, float]:
    """Self-retrieval (MRR, recall@k, overlap) for one query
    (reference: src/mpi_helpers/metrics.rs:217-249).

    ``top_k_results`` is the ranked list of (store row id, distance).
    """
    position = 0
    for i, (idx, _dist) in enumerate(top_k_results):
        if idx == query_idx:
            position = i + 1
            break
    mrr = 1.0 / position if position > 0 else 0.0
    recall = 1.0 if 0 < position <= top_k else 0.0
    overlap = 1.0 if position > 0 else 0.0
    return mrr, recall, overlap
