"""Read side of the Parquet store format written by the reference package.

Counterpart of the read half of ``better_search_rag_rust_tpu/store/
vectorstore.py``, which cannot be imported from here: its package
``__init__`` pulls in the JAX device store. The on-disk format is the
reference's: one column ``embeddings`` of ``FixedSizeList<f32>`` (or, in
foreign files, ``List<f32>``) rows; the merged store is ``global.parquet``
beside an optional ``manifest.json`` and a ``global.parquet.partial`` marker
left by a merge that skipped shards. The readers here return the same bits
as the reference's on every store it wrote.

``pyarrow`` is imported inside the functions, so importing this module
costs nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

EMBEDDINGS_COLUMN = "embeddings"
GLOBAL_STORE_NAME = "global.parquet"


def global_store_path(store_dir: str | os.PathLike) -> Path:
    """Merged store path ``<store_dir>/global.parquet``."""
    return Path(store_dir) / GLOBAL_STORE_NAME


def manifest_path(store_dir: str | os.PathLike) -> Path:
    """Row -> source-file manifest written at merge (JSON list)."""
    return Path(store_dir) / "manifest.json"


def load_manifest(store_dir: str | os.PathLike) -> Optional[List[str]]:
    """The merged row -> path manifest, or None when none was written."""
    p = manifest_path(store_dir)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def partial_merge_marker(store_dir: str | os.PathLike) -> Path:
    """Marker beside global.parquet when a merge skipped shards."""
    return Path(store_dir) / "global.parquet.partial"


def parquet_row_count(path: str | os.PathLike) -> int:
    """Row count from Parquet metadata only — no data read. A missing or
    zero-byte file counts as empty."""
    import pyarrow.parquet as pq

    path = Path(path)
    if not path.exists() or path.stat().st_size == 0:
        return 0
    return pq.ParquetFile(path).metadata.num_rows


def _column_matrix(col) -> np.ndarray:
    """One row group's ``embeddings`` column as a ``[rows, D]`` f32 matrix."""
    import pyarrow as pa

    mats = []
    for chunk in col.chunks:
        if pa.types.is_fixed_size_list(chunk.type):
            dim = chunk.type.list_size
            mats.append(
                np.asarray(chunk.values, dtype=np.float32).reshape(-1, dim)
            )
        else:
            mats.append(
                np.asarray(
                    [np.asarray(v, dtype=np.float32) for v in chunk.to_pylist()]
                )
            )
    return np.concatenate(mats) if len(mats) > 1 else mats[0]


def read_matrix_slice(
    path: str | os.PathLike, offset: int, length: int
) -> np.ndarray:
    """Rows ``[offset, offset + length)`` as an ``[length, D]`` f32 matrix,
    reading only the row groups that overlap the slice."""
    import pyarrow.parquet as pq

    if length <= 0:
        return np.zeros((0, 0), dtype=np.float32)
    pf = pq.ParquetFile(path, memory_map=True)
    end = offset + length
    picked = []
    row_start = 0
    for rg in range(pf.num_row_groups):
        row_end = row_start + pf.metadata.row_group(rg).num_rows
        if row_end > offset and row_start < end:
            picked.append((rg, row_start))
        row_start = row_end
    if not picked:
        raise IndexError(
            f"slice ({offset}, {length}) out of range for {row_start} rows"
        )
    chunks = []
    for rg, rg_start in picked:
        table = pf.read_row_group(rg, columns=[EMBEDDINGS_COLUMN])
        mat = _column_matrix(table.column(EMBEDDINGS_COLUMN))
        lo = max(0, offset - rg_start)
        hi = min(mat.shape[0], end - rg_start)
        chunks.append(mat[lo:hi])
    out = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    if out.shape[0] != length:
        raise IndexError(
            f"slice ({offset}, {length}) out of range ({out.shape[0]} read)"
        )
    return np.ascontiguousarray(out)
