"""Deterministic hash encoder — the hermetic embedding backend.

Counterpart of ``better_search_rag_rust_tpu/models/hash_encoder.py``: the
same numpy-seeded unit-normal ``[vocab, dim]`` table (cast to the compute
dtype), then a gather of the token rows, their masked mean in f32 and an L2
normalization. A random-projection bag of words: files that share tokens
land near each other, so self-retrieval behaves sensibly with no model
artifact. Plain PyTorch: the reference has no Pallas kernel here either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import torch_dtype
from .nomic import upload_tokens
from .tokenizer import HashingTokenizer


class HashEncoder:
    """Token ids + mask -> deterministic ``[B, dim]`` f32 embeddings."""

    def __init__(self, dim: int = 768, max_tokens: int = 512,
                 vocab_size: int = 30528, seed: int = 0,
                 dtype: str = "bfloat16",
                 device: torch.device | str = "cpu"):
        self.dim = dim
        self.max_tokens = max_tokens
        self.device = torch.device(device)
        self.tokenizer = HashingTokenizer(vocab_size, max_tokens)
        # numpy is stable across devices and versions: both packages hold the
        # same table
        table = np.random.default_rng(seed).standard_normal(
            (vocab_size, dim), dtype=np.float32)
        self.table = torch.from_numpy(table).to(self.device, torch_dtype(dtype))

    def encode_tokens_device(self, input_ids, attention_mask) -> torch.Tensor:
        """``[B, S]`` ids + mask -> ``[B, dim]`` f32 on the device, queued."""
        ids = upload_tokens(input_ids, self.device)
        m = upload_tokens(attention_mask, self.device).to(
            torch.float32)[:, :, None]
        emb = self.table[ids]                                  # [B, S, D]
        pooled = (emb.to(torch.float32) * m).sum(dim=1)
        pooled = pooled / m.sum(dim=1).clamp_min(1.0)
        norms = pooled.norm(dim=-1, keepdim=True)
        return pooled / torch.where(norms == 0.0, 1.0, norms)

    def encode_tokens(self, input_ids, attention_mask) -> np.ndarray:
        out = self.encode_tokens_device(input_ids, attention_mask)
        return out.cpu().numpy().astype(np.float32, copy=False)
