"""Row normalization with the reference's zero-magnitude guard.

Counterpart of ``better_search_rag_rust_tpu/ops/distance.py`` and of the
device store's ``_normalize_cast`` (``store/device_store.py:62-71``): rows
are L2-normalized in float32, and a zero row stays the zero vector, so its
similarity is 0 and its cosine distance exactly 1.0.
"""

from __future__ import annotations

import torch


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalization in float32 with the zero-magnitude guard."""
    x = x.to(torch.float32)
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.where(norms == 0.0, torch.ones_like(norms), norms)


def distances_from_sims(sims: torch.Tensor) -> torch.Tensor:
    """Cosine distance ``1 - clamp(sim, -1, 1)``, the reference's metric."""
    return 1.0 - torch.clamp(sims, -1.0, 1.0)
