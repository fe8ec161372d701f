"""Row normalization with the reference's zero-magnitude guard, and
cosine scores of small matrices.

Counterpart of ``better_search_rag_rust_tpu/ops/distance.py``: rows are
L2-normalized in float32, and a zero row stays the zero vector, so its
similarity is 0 and its cosine distance exactly 1.0; similarities are
clamped to [-1, 1] before ``1 - sim``. The store's and the engine's rows
take K17 instead (:func:`.topk_kernels.normalize_cast`: the same guard, the
norm in one stated order, the cast in the same pass).
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


def similarity_matrix(queries_norm: torch.Tensor,
                      store_norm: torch.Tensor) -> torch.Tensor:
    """``[Q, N]`` cosine similarities of normalized operands, accumulated in
    float32 whatever their dtype (bf16 widens exactly, int8 lattice rows
    give their integer dot)."""
    return queries_norm.to(torch.float32) @ store_norm.to(torch.float32).T


def cosine_distance_matrix(queries: torch.Tensor,
                           store: torch.Tensor) -> torch.Tensor:
    """``[Q, N]`` cosine distances with the reference's edge cases. For small
    stores and tests; the engine never forms ``[Q, N]``."""
    return distances_from_sims(
        similarity_matrix(normalize_rows(queries), normalize_rows(store)))
