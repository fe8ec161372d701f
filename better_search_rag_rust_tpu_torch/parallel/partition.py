"""Static block (contiguous) partitioning of a row range across shards.

Counterpart of ``better_search_rag_rust_tpu/parallel/partition.py``, which
cannot be imported from here: its package ``__init__`` pulls in the JAX mesh
module. Shard ``s`` of ``S`` owns rows ``[s*ceil(N/S), min((s+1)*ceil(N/S),
N))``; every (shard, N) combination yields a valid, possibly empty, interval
and the intervals always tile ``[0, N)`` exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class BlockInterval:
    """Half-open row interval owned by one shard."""

    start: int
    end: int

    @property
    def count(self) -> int:
        return self.end - self.start


def block_interval(shard: int, num_shards: int, count: int) -> BlockInterval:
    """The rows shard ``shard`` of ``num_shards`` owns out of ``count``."""
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards} shards")
    if count < 0:
        raise ValueError(f"count must be non-negative, got {count}")
    per_shard = -(-count // num_shards) if count else 0  # ceil div
    start = min(shard * per_shard, count)
    end = count if shard == num_shards - 1 else min(start + per_shard, count)
    return BlockInterval(start, end)


def slice_for_shard(shard: int, num_shards: int, items: Sequence[T]) -> List[T]:
    """The contiguous sub-list shard ``shard`` owns."""
    iv = block_interval(shard, num_shards, len(items))
    return list(items[iv.start : iv.end])


def shard_sizes(num_shards: int, count: int) -> List[int]:
    """Row count per shard; sums to ``count`` for every combination."""
    return [block_interval(s, num_shards, count).count for s in range(num_shards)]


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest m >= n with m % multiple == 0 (and m >= multiple, so a store
    always holds at least one kernel tile of rows)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return max(multiple, -(-n // multiple) * multiple)
