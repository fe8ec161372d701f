"""Joining a multi-process run: the port's ``maybe_init_distributed``.

Counterpart of ``better_search_rag_rust_tpu/launch.py``. Every process runs
the same program and joins the world through the reference's env contract:

    BSR_COORDINATOR=host0:29500  BSR_NUM_PROCESSES=2  BSR_PROCESS_ID=0..1

which becomes ``torch.distributed.init_process_group`` over
``tcp://host0:29500``. The backend is NCCL where every rank has a card of
its own (this host has at least as many cards as the world has ranks;
rank ``r`` takes card ``r % cards``), and gloo otherwise: on the CPU, and
where ranks share a card (NCCL refuses two ranks on one card).
``BSR_DIST_TIMEOUT_S`` (default 300) bounds the rendezvous and every
collective, so a rank that never arrives or dies fails the others instead
of hanging them.

Launch two ranks on the CPU (two shells, or ``&``)::

    BSR_COORDINATOR=127.0.0.1:29500 BSR_NUM_PROCESSES=2 BSR_PROCESS_ID=0 \\
        python -m better_search_rag_rust_tpu_torch run --device cpu ...
    BSR_COORDINATOR=127.0.0.1:29500 BSR_NUM_PROCESSES=2 BSR_PROCESS_ID=1 \\
        python -m better_search_rag_rust_tpu_torch run --device cpu ...
"""

from __future__ import annotations

import datetime
import os

import torch

from .utils.logging import host_log

#: Seconds the rendezvous and each collective may wait by default.
DEFAULT_TIMEOUT_S = 300.0


def _backend(nproc: int) -> str:
    if torch.cuda.is_available() and torch.cuda.device_count() >= nproc:
        return "nccl"
    return "gloo"


def dist_timeout() -> datetime.timedelta:
    """How long the rendezvous and each collective may wait:
    ``BSR_DIST_TIMEOUT_S`` seconds (default :data:`DEFAULT_TIMEOUT_S`); the
    default group and every sub-group of a mesh take it."""
    return datetime.timedelta(seconds=float(
        os.environ.get("BSR_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S)))


def maybe_init_distributed() -> bool:
    """Join the world the ``BSR_*`` env asks for; ``False`` (nothing done)
    without that env. Safe to call again once joined (``True``). Raises
    when the env is incomplete or malformed, or when the world does not
    form within the timeout — it never carries on as one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coord = os.environ.get("BSR_COORDINATOR")
    nproc = os.environ.get("BSR_NUM_PROCESSES")
    if not coord and not nproc:
        return False
    if not coord or not nproc:
        raise ValueError(
            "BSR_COORDINATOR and BSR_NUM_PROCESSES must be set together "
            f"(got BSR_COORDINATOR={coord!r}, BSR_NUM_PROCESSES={nproc!r})")
    world = int(nproc)
    rank = int(os.environ.get("BSR_PROCESS_ID", "0"))
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"BSR_PROCESS_ID {rank} is outside a world of {world}")
    timeout = dist_timeout()
    backend = _backend(world)
    if backend == "nccl":
        # one card per rank; NCCL's collectives run on the current device
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coord}", world_size=world,
        rank=rank, timeout=timeout)
    host_log(f"joined {coord} as process {rank}/{world} ({backend}, "
             f"timeout {timeout.total_seconds():g}s)")
    return True
