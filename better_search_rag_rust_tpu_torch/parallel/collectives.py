"""Collectives inside autograd, over one axis group of a training mesh.

The JAX trainer lets XLA place its collectives from sharding annotations
(``better_search_rag_rust_tpu/models/train.py``, ``models/nomic.py``
``_sp_constrain``); here each one is written out, with the backward that
makes the gradient exact. ``group`` is a process group from
:func:`.mesh.axis_group`; ``None`` (an axis of one shard) makes every
operator the identity. ``dim`` is the dimension the group splits.

* :func:`copy_to_group`: identity forward, all-reduce backward. It enters
  a column-parallel product from an input every rank holds whole: each
  rank's product sees its own output columns only, so the input's
  gradient is the sum over the group.
* :func:`reduce_from_group`: all-reduce forward, identity backward. It
  leaves a row-parallel product; every rank then holds the whole sum and
  the gradient of each partial is the sum's own. (``torch.distributed.nn.
  functional.all_reduce`` all-reduces the gradient too, which would scale
  it by the group's size here.)
* :func:`gather_for_product`: all-gather forward, reduce-scatter backward.
  It enters a column-parallel product from the rank's rows of the sequence
  (sequence parallelism): every rank's product contributes to every row's
  gradient.
* :func:`reduce_scatter_to_rows`: reduce-scatter forward, all-gather
  backward. It leaves a row-parallel product onto the rank's rows.
* :func:`gather_rows`: all-gather forward, the rank's own slice backward,
  with no reduce. Every rank holds the whole, and what follows is the same
  replicated function on every rank, so the gradient a rank receives for
  its own slice is already the whole gradient of that slice. It joins the
  sequence after the last layer, and the data blocks' embeddings for the
  loss over the global batch.

The reduce-scatter is ``torch.distributed.reduce_scatter`` over the
rank's chunks on every backend: gloo takes CUDA tensors for it as NCCL
does (measured with torch 2.11 on the H100).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: the collective that leaves a row-parallel product under sequence
#: parallelism (phase 26 of chip_smoke.py prints it)
REDUCE_SCATTER = "reduce_scatter"


def _chunks(x: torch.Tensor, group, dim: int):
    """``x``'s equal chunks along ``dim``, one a rank of ``group``."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    return x.chunk(n, dim)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    chunks = [c.contiguous() for c in _chunks(x, group, dim)]
    out = torch.empty_like(chunks[dist.get_rank(group)])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _own(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _chunks(x, group, dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherForProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.group, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Reduce.apply(x, group)


def gather_for_product(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if group is None else _GatherForProduct.apply(x, group, dim)


def reduce_scatter_to_rows(x: torch.Tensor, group, dim: int = 1
                           ) -> torch.Tensor:
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherRows.apply(x, group, dim)


def own_rows(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The rank's chunk of ``x`` along ``dim``, as plain autograd slicing
    (its backward puts the gradient back in the rank's chunk, zeros
    elsewhere): where every rank computes ``x`` whole but uses only its own
    rows, each rank's parameters get that share of the gradient, which the
    trainer sums over the group."""
    if group is None:
        return x
    return _chunks(x, group, dim)[dist.get_rank(group)]
