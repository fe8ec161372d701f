"""Contrastive fine-tuning of the embedding model on one device.

Counterpart of ``better_search_rag_rust_tpu/models/train.py:95-285``: InfoNCE
over in-batch negatives, both towers (anchor and positive) encoded by one
:class:`~.nomic.NomicBertModel` with mean pooling and the v1.5
normalization, AdamW with optax's defaults. Parameters and the optimizer
state are f32 while the forward computes in the config's dtype (bf16 by
default), as the JAX trainer's Flax modules do. With ``attention_impl``
``fused`` (the default) every attention layer runs the hand-written K8
kernel forward and the K9 kernel backward
(:class:`~..ops.attention_kernels.FusedAttentionQKV`).

One device only: the JAX trainer's ``(data, model)`` mesh, its tensor
parallel parameter specs, sequence parallelism and the sharded attention
arms belong to the multi-GPU slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .nomic import (
    NomicBertConfig,
    NomicBertModel,
    finalize_embeddings,
    init_random,
    mean_pool,
    upload_tokens,
)

#: optax.adamw's defaults (optax 0.2.6), set explicitly: torch's AdamW
#: decays weights by 1e-2 by default. Bias correction and the decoupled
#: decay are the same algebra in both.
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def info_nce_loss(anchor: torch.Tensor, positive: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with in-batch negatives, ``[B, D] x [B, D] ->``
    scalar: f32 logits ``anchor @ positive^T / temperature``, cross-entropy
    against the diagonal in both directions, the mean of the two."""
    logits = torch.matmul(anchor.to(torch.float32),
                          positive.to(torch.float32).T) / temperature
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: int


class ContrastiveTrainer:
    """Contrastive training of NomicBERT on one device (``device=None``: the
    CUDA card, raising without one)."""

    def __init__(self, config: NomicBertConfig, learning_rate: float = 2e-5,
                 temperature: float = 0.05, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: Optional[torch.device | str] = None):
        self.device = resolve_device(device)
        self.config = dataclasses.replace(config, param_dtype=torch.float32)
        self.temperature = temperature
        self.model = NomicBertModel(self.config, device=self.device)
        if params is None:
            init_random(self.model, seed)
        else:
            self.model.load_state_dict(params)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
            eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
        self.step = 0

    @property
    def state(self) -> TrainState:
        """The parameters (detached, on the device), the optimizer state and
        the number of steps taken."""
        params = {k: v.detach() for k, v in self.model.state_dict().items()}
        return TrainState(params, self.optimizer.state_dict(), self.step)

    def loss(self, a_ids, a_mask, p_ids, p_mask) -> torch.Tensor:
        """InfoNCE of one batch of ``[B, S]`` (anchor, positive) pairs, each
        tower encoded to ``[B, D]`` f32 embeddings; differentiable."""
        towers = []
        for ids, mask in ((a_ids, a_mask), (p_ids, p_mask)):
            mask = upload_tokens(mask, self.device)
            hidden = self.model(upload_tokens(ids, self.device), mask)
            towers.append(finalize_embeddings(mean_pool(hidden, mask)))
        return info_nce_loss(*towers, self.temperature)

    def train_step_device(self, a_ids, a_mask, p_ids, p_mask) -> torch.Tensor:
        """One optimizer step; returns the loss still on the device, so
        steps queue without a host sync."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(a_ids, a_mask, p_ids, p_mask)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return loss.detach()

    def train_step(self, a_ids, a_mask, p_ids, p_mask) -> float:
        """One optimizer step; returns the loss (synchronous)."""
        return float(self.train_step_device(a_ids, a_mask, p_ids, p_mask))
