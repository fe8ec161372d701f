from .partition import (  # noqa: F401
    BlockInterval,
    block_interval,
    pad_to_multiple,
    shard_sizes,
    slice_for_shard,
)
