"""The mesh: the ordered shards of the whole world, on ``torch.distributed``.

Counterpart of ``better_search_rag_rust_tpu/parallel/mesh.py``. There a mesh
is a ``jax.sharding.Mesh`` over every device of every host; here it is the
ordered list of shards across the whole world, each a ``(rank, device)``
pair, with the reference's ``shape`` / ``axis_names`` over it:

* one process with several local devices is the JAX single-host mesh: the
  shards sit on ``cuda:0..n-1``, or on several ``"cpu"`` shards (the CPU
  tests' analogue of ``--xla_force_host_platform_device_count``), or on one
  card more than once; no process group is needed;
* several processes (:func:`..launch.maybe_init_distributed`) are JAX's
  multi-host run: every rank owns the same number of local shards, and the
  world order is rank-major, so shard ``s`` of rank ``r`` with ``L`` local
  shards is world shard ``r * L + s``.

The collectives the sharded store and engine need (:func:`gather_ranks`,
:func:`gather_objects`, :func:`barrier`) run on the default process group;
gloo's ``all_gather`` takes CUDA tensors as NCCL's does (measured with
torch 2.11 on the H100), so no caller stages through host memory.

Training takes a ``(data, model)`` mesh of one shard a rank (the JAX
trainer's mesh, with ``create_mesh``'s rank-major order): the rank's
coordinate on each axis is :func:`axis_index`, and :func:`axis_group` is
the process group of the ranks it shares an axis line with — the ranks
with its model index form its data group, those with its data index its
model group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch


#: the axis names of a training mesh (the JAX trainer's DATA_AXIS and
#: MODEL_AXIS)
DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Shard:
    """One shard of a mesh: the rank that owns it and its device there."""

    rank: int
    device: torch.device


@dataclass(frozen=True)
class Mesh:
    """Shards of the whole world in mesh order, with the reference's axes."""

    shards: Tuple[Shard, ...]
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int = 0
    world_size: int = 1
    #: the process group of each axis, built at first use (axis_group)
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.shards)

    def local_shards(self) -> List[Tuple[int, Shard]]:
        """``(world shard index, shard)`` of every shard this rank owns."""
        return [(i, s) for i, s in enumerate(self.shards) if s.rank == self.rank]


def process_info() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_devices() -> List[torch.device]:
    """This process's devices when none are named: its own card when a
    process group of several ranks is up (``rank % cards``, as
    :mod:`..launch` sets it; ranks may share a card), else every card.
    Raises without a card: the CPU runs only when asked for by name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: name the devices (devices=['cpu', ...]; CLI: "
            "--device cpu) to run on the CPU")
    n = torch.cuda.device_count()
    rank, world = process_info()
    if world > 1:
        return [torch.device("cuda", rank % n)]
    return [torch.device("cuda", i) for i in range(n)]


def create_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over this process's ``devices`` (default
    :func:`default_devices`) and, under a process group, every other rank's.
    A device may be named more than once (several shards on one card or on
    the CPU). ``shape=None`` puts every shard on the first axis (the
    reference's pure data parallelism). The shape and axis checks are the
    reference's. Under a process group this is a collective: every rank
    calls it, and every rank must bring the same number of devices."""
    local = [torch.device(d) for d in
             (devices if devices is not None else default_devices())]
    if not local:
        raise ValueError("a mesh needs at least one device")
    rank, world = process_info()
    if world > 1:
        per_rank = gather_objects([str(d) for d in local])
        counts = {len(devs) for devs in per_rank}
        if len(counts) != 1:
            raise ValueError(
                f"every rank must bring the same number of devices, got "
                f"{[len(devs) for devs in per_rank]}")
        shards = tuple(Shard(r, torch.device(d))
                       for r, devs in enumerate(per_rank) for d in devs)
    else:
        shards = tuple(Shard(0, d) for d in local)
    n = len(shards)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} vs axis names {axis_names}")
    return Mesh(shards, shape, tuple(axis_names), rank, world)


def data_axis_size(mesh: Mesh, axis: str = "data") -> int:
    return mesh.shape[axis]


def axis_size(mesh: Mesh, name: str) -> int:
    """Shards along axis ``name``; 1 for an axis the mesh does not have."""
    return mesh.shape.get(name, 1)


def own_shard(mesh: Mesh, what: str) -> int:
    """The world index of this rank's shard. Raises ``ValueError`` when
    the rank owns more than one: ``what`` (training, a tensor-parallel
    encoder) runs one process a shard, each driving its own device."""
    local = mesh.local_shards()
    if len(local) != 1:
        raise ValueError(
            f"{what} runs one process a shard, and this process owns "
            f"{len(local)} shards of the mesh; launch one process a shard "
            "through the BSR_* env (BSR_COORDINATOR, BSR_NUM_PROCESSES, "
            "BSR_PROCESS_ID; see launch.py) with one device each")
    return local[0][0]


def axis_index(mesh: Mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 on an absent axis)."""
    if name not in mesh.axis_names:
        return 0
    ax = mesh.axis_names.index(name)
    stride = math.prod(mesh.axis_sizes[ax + 1:])
    return own_shard(mesh, "an axis coordinate") // stride % mesh.axis_sizes[ax]


def axis_group(mesh: Mesh, name: str):
    """The process group of the ranks whose shards differ from this rank's
    on axis ``name`` alone, in axis order; ``None`` where the axis has one
    shard (nothing to communicate). Built at first use and kept on the
    mesh: every rank builds every group of the axis in the same order
    (``new_group`` is collective over the world), each with the world's
    timeout (:func:`..launch.dist_timeout`)."""
    size = axis_size(mesh, name)
    if size == 1:
        return None
    if name not in mesh.groups:
        import torch.distributed as dist

        from ..launch import dist_timeout

        me = own_shard(mesh, "an axis group")
        ax = mesh.axis_names.index(name)
        stride = math.prod(mesh.axis_sizes[ax + 1:])
        own = None
        for base in range(mesh.size):
            if base // stride % size:
                continue            # each line once, from its index-0 shard
            line = [base + j * stride for j in range(size)]
            group = dist.new_group([mesh.shards[i].rank for i in line],
                                   timeout=dist_timeout())
            if me in line:
                own = group
        mesh.groups[name] = own
    return mesh.groups[name]


# ---------------------------------------------------------------------------
# Collectives on the default process group
# ---------------------------------------------------------------------------


def gather_ranks(t: torch.Tensor) -> torch.Tensor:
    """``[world, *t.shape]``: every rank's ``t`` in rank order, on ``t``'s
    device (an ``all_gather``; every rank passes the same shape and
    dtype)."""
    import torch.distributed as dist

    _rank, world = process_info()
    if world == 1:
        return t.unsqueeze(0)
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(out, src)
    return torch.stack(out)


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj`` in rank order (``[obj]`` without a
    process group)."""
    import torch.distributed as dist

    _rank, world = process_info()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def barrier(name: str = "") -> None:
    """Wait for every rank (no-op without a process group); raises, naming
    the wait, when the group's timeout ends first."""
    import torch.distributed as dist

    _rank, world = process_info()
    if world == 1:
        return
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier()  # names the rank that did not arrive
        else:
            dist.barrier()
    except RuntimeError as exc:
        raise RuntimeError(f"barrier {name!r}: {exc}") from exc
