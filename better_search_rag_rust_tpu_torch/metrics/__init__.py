"""Retrieval-quality metrics: the reference's framework-free module, shared.

``better_search_rag_rust_tpu.metrics.quality`` imports only numpy, so both
packages score results with one implementation.
"""

from better_search_rag_rust_tpu.metrics.quality import (  # noqa: F401
    accuracy_metrics_for_query,
    mean_reciprocal_rank,
    recall_at_k,
    top_k_overlap,
)
