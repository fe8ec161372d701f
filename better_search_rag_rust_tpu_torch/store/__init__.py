from .device_store import DeviceStore, check_row_capacity  # noqa: F401
from .vectorstore import (  # noqa: F401
    ParquetVectorStore,
    global_store,
    global_store_path,
    load_encoder_meta,
    load_manifest,
    local_store,
    local_store_path,
    merge_vector_stores,
    parquet_row_count,
    partial_merge_marker,
    read_matrix_slice,
    write_encoder_meta,
)
