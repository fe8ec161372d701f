"""Contrastive fine-tuning of the embedding model over a ``(data, model)``
mesh.

Counterpart of ``better_search_rag_rust_tpu/models/train.py``: InfoNCE
over in-batch negatives, both towers (anchor and positive) encoded by one
:class:`~.nomic.NomicBertModel` with mean pooling and the v1.5
normalization, AdamW with optax's defaults. Parameters and the optimizer
state are f32 while the forward computes in the config's dtype (bf16 by
default), as the JAX trainer's Flax modules do. With ``attention_impl``
``fused`` (the default) every attention layer runs the hand-written K8
kernel forward and the K9 kernel backward
(:class:`~..ops.attention_kernels.FusedAttentionQKV`), on each rank's batch
block and heads; with ``flash`` the K14 kernel forward and the K15 + K16
kernels backward (:class:`~..ops.flash_kernels.FlashAttention`), on one
device only, as in the JAX package.

The mesh (:func:`..parallel.mesh.create_mesh` under the ``BSR_*`` launch)
has one shard a rank, where the JAX trainer has one device a shard; one
shard is the one-device trainer. Over it:

* **DP**: every rank is given the global batch and keeps its data block.
  Both towers' embeddings are gathered over the data group with the
  rank's own slice as the gradient, so every rank computes the JAX loss on
  the global batch (the in-batch negatives of every block), and each
  parameter gradient is **summed** over the data group (a mean, as DDP
  takes, would scale it by ``1/dp``).
* **TP**: :func:`param_specs` / :func:`shard_params` split the products
  over the model group (:class:`~.nomic.TensorParallel`); the attention
  rule is the JAX trainer's (:func:`~.nomic.mesh_attention_impl`, recorded
  on ``config.attention_impl``).
* **SP** (``sequence_parallel``, the default where ``max_tokens`` splits
  over the model axis): the embeddings, residual adds and norms run on the
  rank's rows of the sequence, so every parameter the model ranks hold
  whole gets its rows' share of the gradient, summed over the model group
  as well.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import gather_rows
from ..parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    barrier,
    own_shard,
    process_info,
)
from ..utils.device import resolve_device
from .nomic import (  # noqa: F401  (param_specs .. gather_params: the API)
    NomicBertConfig,
    build_model,
    finalize_embeddings,
    gather_params,
    mean_pool,
    mesh_attention_impl,
    merge_shards,
    param_spec,
    param_specs,
    refuse_fused_past_kernel,
    shard_params,
    tensor_parallel,
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
    CUDA card, raising without one) or over a ``(data, model)`` ``mesh`` of
    one shard a rank, each rank on its shard's device (every rank of the
    world constructs the trainer and takes every step)."""

    def __init__(self, config: NomicBertConfig, learning_rate: float = 2e-5,
                 temperature: float = 0.05, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device: Optional[torch.device | str] = None,
                 mesh=None, sequence_parallel: bool = True):
        if mesh is None or mesh.size == 1:
            self.device = (resolve_device(device) if mesh is None
                           else mesh.shards[0].device)
            self.dp, self.tp, self.data_rank = 1, 1, 0
            self.data_group = self.model_group = None
        else:
            if set(mesh.axis_names) - {DATA_AXIS, MODEL_AXIS}:
                raise ValueError(f"a training mesh has the axes "
                                 f"{(DATA_AXIS, MODEL_AXIS)}, got "
                                 f"{mesh.axis_names}")
            self.dp = axis_size(mesh, DATA_AXIS)
            self.tp = axis_size(mesh, MODEL_AXIS)
            config = dataclasses.replace(config, attention_impl=(
                mesh_attention_impl(config.attention_impl, config, self.dp,
                                    self.tp)))
            self.device = mesh.shards[own_shard(mesh, "training")].device
            self.data_rank = axis_index(mesh, DATA_AXIS)
            self.data_group = axis_group(mesh, DATA_AXIS)
            self.model_group = axis_group(mesh, MODEL_AXIS)
        refuse_fused_past_kernel(config.attention_impl, config.max_tokens,
                                 config.head_dim, torch.device(self.device).type)
        self.mesh = mesh
        self.config = dataclasses.replace(config, param_dtype=torch.float32)
        self.temperature = temperature
        self.parallel = (None if self.tp == 1 else tensor_parallel(
            mesh, self.config, heads=self.config.attention_impl == "fused",
            sequence=sequence_parallel))
        self.sequence_parallel = bool(self.parallel
                                      and self.parallel.sequence)
        self.heads_split = bool(self.parallel and self.parallel.heads)
        self.model = build_model(self.config, self.device, seed, params,
                                 self.parallel)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
            eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
        self.step = 0

    @property
    def state(self) -> TrainState:
        """The whole parameters (detached, on the device; gathered over the
        model group, so every rank calls it), this rank's optimizer state
        and the number of steps taken."""
        local = {k: v.detach() for k, v in self.model.state_dict().items()}
        params = gather_params(local, self.model_group, self.heads_split)
        return TrainState(params, self.optimizer.state_dict(), self.step)

    def gradients(self) -> Dict[str, torch.Tensor]:
        """The whole parameter gradients of the last :meth:`backward`,
        gathered over the model group as :attr:`state` gathers the
        parameters (every rank calls it)."""
        local = {n: p.grad.detach() for n, p in self.model.named_parameters()}
        return gather_params(local, self.model_group, self.heads_split)

    def save(self, path: str | os.PathLike) -> None:
        """Write the whole parameters in the one-device format
        (:func:`.checkpoint.save_params`): every rank gathers, rank 0 alone
        writes once every rank has arrived, and every rank returns once it
        has."""
        from .checkpoint import save_params

        params = self.state.params
        barrier("checkpoint gathered")
        if process_info()[0] == 0:
            save_params(path, params)
        barrier("checkpoint written")

    def _data_block(self, x):
        """This rank's data block of a global batch's rows."""
        b = x.shape[0]
        if b % self.dp:
            raise ValueError(f"a batch of {b} pairs does not split over "
                             f"{self.dp} data ranks")
        per = b // self.dp
        return x[self.data_rank * per: (self.data_rank + 1) * per]

    def loss(self, a_ids, a_mask, p_ids, p_mask) -> torch.Tensor:
        """InfoNCE of one global batch of ``[B, S]`` (anchor, positive)
        pairs, each tower encoded to ``[B, D]`` f32 embeddings;
        differentiable. Over a mesh every rank is given the whole batch,
        encodes its data block and returns the same loss."""
        towers = []
        for ids, mask in ((a_ids, a_mask), (p_ids, p_mask)):
            mask = upload_tokens(self._data_block(mask), self.device)
            hidden = self.model(upload_tokens(self._data_block(ids),
                                              self.device), mask)
            emb = finalize_embeddings(mean_pool(hidden, mask))
            towers.append(gather_rows(emb, self.data_group, dim=0))
        return info_nce_loss(*towers, self.temperature)

    def backward(self, a_ids, a_mask, p_ids, p_mask) -> torch.Tensor:
        """The loss of one global batch, with every parameter's gradient
        left in ``.grad``: this rank's share of it summed over the data
        group, and, under sequence parallelism, a parameter the model ranks
        hold whole summed over the model group too (its rows' share)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(a_ids, a_mask, p_ids, p_mask)
        loss.backward()
        self._sum_gradients()
        return loss.detach()

    def _sum_gradients(self) -> None:
        import torch.distributed as dist
        from torch._utils import (
            _flatten_dense_tensors,
            _unflatten_dense_tensors,
        )

        split, whole = [], []
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            (split if MODEL_AXIS in param_spec(name, self.heads_split)
             else whole).append(p.grad)
        # a parameter the model ranks hold whole sums over the whole mesh
        # under sequence parallelism (each rank computed its rows' share),
        # else over the data group as the split ones do
        buckets = [(split, self.data_group, self.dp > 1),
                   (whole, None if self.sequence_parallel else
                    self.data_group, self.dp > 1 or self.sequence_parallel)]
        for grads, group, reduce in buckets:
            if not grads or not reduce:
                continue
            flat = _flatten_dense_tensors(grads)
            dist.all_reduce(flat, group=group)
            for g, summed in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(summed)

    def train_step_device(self, a_ids, a_mask, p_ids, p_mask) -> torch.Tensor:
        """One optimizer step; returns the loss still on the device, so
        steps queue without a host sync."""
        loss = self.backward(a_ids, a_mask, p_ids, p_mask)
        self.optimizer.step()
        self.step += 1
        return loss

    def train_step(self, a_ids, a_mask, p_ids, p_mask) -> float:
        """One optimizer step; returns the loss (synchronous)."""
        return float(self.train_step_device(a_ids, a_mask, p_ids, p_mask))
