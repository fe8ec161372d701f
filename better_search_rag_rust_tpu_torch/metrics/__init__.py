"""Retrieval-quality metrics (:mod:`.quality`, numpy only)."""

from .quality import (  # noqa: F401
    accuracy_metrics_for_query,
    mean_reciprocal_rank,
    recall_at_k,
    top_k_overlap,
)
