from .device_store import DeviceStore, check_row_capacity  # noqa: F401
from .vectorstore import (  # noqa: F401
    global_store_path,
    load_manifest,
    parquet_row_count,
    partial_merge_marker,
    read_matrix_slice,
)
