"""Device-store snapshots: the fast serve-startup path.

Counterpart of ``better_search_rag_rust_tpu/store/device_cache.py``. Parquet
stays the interchange format; a snapshot is the already normalized, padded
store tensor, written with ``torch.save`` and read back with ``torch.load(
weights_only=True, map_location=device)`` straight onto the card — no
Parquet parse, normalization or cast on a restart.

Layout: ``<store_dir>/device_cache_torch/`` holds ``data.pt`` and
``device_store.json``, the metadata in the reference's layout (dtype by its
JAX name, ``source`` as ``{rows, bytes, mtime_ns}`` of the Parquet file the
snapshot was built from), written atomically AFTER the tensor, so a
snapshot whose metadata exists is whole. The directory is a sibling of the
reference's ``device_cache/``: neither package overwrites the other's
snapshot (Orbax there, ``torch.save`` here).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch

from .device_store import DeviceStore

SNAPSHOT_DIR = "device_cache_torch"
_META = "device_store.json"
_DATA = "data.pt"
#: torch dtype -> the name the reference's metadata records (jnp.dtype str)
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
               torch.int8: "int8"}


def snapshot_dir(store_dir: str | os.PathLike) -> Path:
    return Path(store_dir) / SNAPSHOT_DIR


def meta_path(cache_dir: str | os.PathLike) -> Path:
    return Path(cache_dir) / _META


def snapshot_exists(cache_dir: str | os.PathLike) -> bool:
    return meta_path(cache_dir).exists()


def read_meta(cache_dir: str | os.PathLike) -> dict:
    return json.loads(meta_path(cache_dir).read_text())


def save_device_store(cache_dir: str | os.PathLike, store: DeviceStore,
                      source: Optional[dict] = None) -> None:
    """Snapshot ``store`` (tensor, then metadata). ``source`` is the
    identity of the Parquet file it was built from, which loaders check
    against the file on disk instead of trusting mtimes."""
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    data = cache_dir / _DATA
    tmp = data.with_suffix(f".{os.getpid()}.tmp")
    torch.save(store.data, tmp)
    os.replace(tmp, data)
    rows = store.padded_rows
    meta = {
        "num_rows": store.num_rows,
        "dim": store.dim,
        "per_device_rows": rows,   # one device: the whole padded store
        "chunk": rows,
        "matryoshka_from": store.matryoshka_from,
        "dtype": DTYPE_NAMES[store.dtype],
        "shape": list(store.data.shape),
        "data_shards": 1,
        "source": source,
    }
    tmp = cache_dir / f"{_META}.{os.getpid()}.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, cache_dir / _META)


def load_device_store(cache_dir: str | os.PathLike, device) -> DeviceStore:
    """Restore a snapshot onto ``device``; raises if the tensor does not
    match its metadata."""
    cache_dir = Path(cache_dir)
    meta = read_meta(cache_dir)
    data = torch.load(cache_dir / _DATA, weights_only=True,
                      map_location=device)
    if (list(data.shape) != meta["shape"]
            or DTYPE_NAMES.get(data.dtype) != meta["dtype"]):
        raise ValueError(
            f"snapshot tensor {data.dtype} {tuple(data.shape)} does not "
            f"match its metadata ({meta['dtype']} {meta['shape']})")
    return DeviceStore(data.contiguous(), int(meta["num_rows"]),
                       int(meta["dim"]), meta["matryoshka_from"])
