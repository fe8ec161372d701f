"""The Parquet store format of the reference package: shards, merge, sidecars.

Counterpart of ``better_search_rag_rust_tpu/store/vectorstore.py``, which
cannot be imported from here: its package ``__init__`` pulls in the JAX
device store. The files are the reference's, byte for byte in layout, so a
store built by either package is served by the other:

* one column ``embeddings`` of ``FixedSizeList<f32>`` rows (``List<f32>``
  in foreign files is read too), PLAIN encoding, no compression;
* per-shard ``rank_{r}.parquet`` with ``.paths.json`` / ``.attrs.json`` /
  ``.progress`` sidecars, merged in shard order into ``global.parquet`` with
  ``manifest.json``, ``manifest.attrs.json``, ``update_commit.json`` and
  ``encoder.json``;
* ``global.parquet.partial`` marks a merge that skipped shards,
  ``global.parquet.ahead`` a global store an update appended to.

The readers return the same bits as the reference's on every store it
wrote. ``pyarrow`` is imported inside the functions, so importing this
module costs nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import host_log

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


def _arrow():
    """``pyarrow``, with Arrow's default memory pool (process-wide) set to
    the system allocator. With torch in the process, Arrow's bundled
    allocator (mimalloc, pyarrow 25) now and then segfaults in the first
    Parquet read that follows a write: on the CPU, 6 of 150 CLI ``ingest``
    runs crashed in the merge's read with the bundled pool, none of 246
    with the system one (8 at a time on 8 cores). The pool decides where
    Arrow's buffers live, never what they hold."""
    import pyarrow as pa

    pa.set_memory_pool(pa.system_memory_pool())
    return pa


def _parquet():
    """``pyarrow.parquet``, after :func:`_arrow`."""
    _arrow()
    import pyarrow.parquet as pq

    return pq


def partial_merge_marker(store_dir: str | os.PathLike) -> Path:
    """Marker beside global.parquet when a merge skipped shards."""
    return Path(store_dir) / "global.parquet.partial"


def parquet_row_count(path: str | os.PathLike) -> int:
    """Row count from Parquet metadata only — no data read. A missing or
    zero-byte file counts as empty."""
    pq = _parquet()

    path = Path(path)
    if not path.exists() or path.stat().st_size == 0:
        return 0
    return pq.ParquetFile(path).metadata.num_rows


def _column_matrix(col) -> np.ndarray:
    """One row group's ``embeddings`` column as a ``[rows, D]`` f32 matrix."""
    pa = _arrow()

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
    pq = _parquet()

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


# ---------------------------------------------------------------------------
# Write side: shard stores, merge, sidecars
# ---------------------------------------------------------------------------


def local_store_path(store_dir: str | os.PathLike, shard: int) -> Path:
    """Per-shard file ``<store_dir>/rank_{shard}.parquet``."""
    return Path(store_dir) / f"rank_{shard}.parquet"


_warmed = False


def _warm_parquet_writer() -> None:
    """Start Arrow's Parquet writer on a daemon thread: the first
    ``write_table`` of a process pays about a second of lazy C++ set-up,
    which would otherwise land on ingest's final persist (the reference
    does the same, ``_warm_parquet_writer``)."""
    global _warmed
    if _warmed:
        return
    _warmed = True

    def _go() -> None:
        try:
            pa = _arrow()
            pq = _parquet()

            pq.write_table(pa.table({EMBEDDINGS_COLUMN: pa.array(
                [1.0], pa.float32())}), pa.BufferOutputStream(),
                compression="none")
        except Exception:  # a warm-up never fails the store
            pass

    import threading

    threading.Thread(target=_go, name="parquet-warmup", daemon=True).start()


def atomic_write_text(path: Path, text: str) -> None:
    """Write ``text`` to ``path`` through a rename: readers never see half."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class ParquetVectorStore:
    """Append-only embedding store persisted as Parquet (the reference's
    ``ParquetVectorStore``, :87): rows held as f32 numpy chunks, written
    atomically as one FixedSizeList column."""

    def __init__(self, path: str | os.PathLike, empty: bool = True):
        """``empty=True`` starts fresh in memory; ``empty=False`` loads the
        file, creating it (and its directory) empty when it is missing."""
        self.path = Path(path)
        self._chunks: List[np.ndarray] = []
        self._count = 0
        _warm_parquet_writer()
        if not empty:
            self._read_parquet(create_if_missing=True)

    def _read_parquet(self, create_if_missing: bool) -> None:
        if not self.path.exists():
            if not create_if_missing:
                raise FileNotFoundError(self.path)
            self._write_table(self._empty_table())
            self._chunks, self._count = [], 0
            return
        if self.path.stat().st_size == 0:  # foreign zero-byte file: empty
            self._chunks, self._count = [], 0
            return
        pq = _parquet()

        table = pq.read_table(self.path, columns=[EMBEDDINGS_COLUMN],
                              memory_map=True)
        mat = _column_matrix(table.column(EMBEDDINGS_COLUMN)) \
            if table.num_rows else np.zeros((0, 0), np.float32)
        self._chunks = [mat] if mat.size else []
        self._count = mat.shape[0] if mat.size else 0

    @staticmethod
    def _empty_table():
        pa = _arrow()

        return pa.table({EMBEDDINGS_COLUMN: pa.array(
            [], type=pa.list_(pa.float32()))})

    def _write_table(self, table) -> None:
        """Atomic write: a reader or a resume never sees a torn file. No
        compression, no dictionary, no statistics (near-incompressible
        float rows; PLAIN pages map straight into memory)."""
        pq = _parquet()

        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        pq.write_table(table, tmp, compression="none", use_dictionary=False,
                       write_statistics=False)
        os.replace(tmp, self.path)

    def append(self, vector: Sequence[float]) -> None:
        """Append one embedding row."""
        self._chunks.append(np.asarray(vector, dtype=np.float32).reshape(1, -1))
        self._count += 1

    def append_many(self, vectors) -> None:
        """Append ``[B, D]`` rows (an array or a list of vectors)."""
        mat = np.asarray(vectors, dtype=np.float32)
        if mat.size == 0:
            return
        if mat.ndim != 2:
            raise ValueError(f"expected [B, D], got shape {mat.shape}")
        self._chunks.append(np.ascontiguousarray(mat))
        self._count += mat.shape[0]

    def take_matrix(self) -> np.ndarray:
        """Detach all rows as ONE writable ``[N, D]`` matrix and leave the
        store empty — what ``Pipeline.update`` edits in place (rewritten
        rows, compaction). At most one materialized copy exists: the
        store's reference goes before a read-only (memory-mapped) matrix is
        copied."""
        mat = self.matrix()
        self._chunks, self._count = [], 0
        if mat.size and not mat.flags.writeable:
            mat = np.array(mat)
        return mat

    def reset(self) -> None:
        """Drop every row held in memory (the file is untouched)."""
        self._chunks = []
        self._count = 0

    def truncate(self, n: int) -> None:
        """Keep the first ``n`` rows (resume drops rows persisted past the
        last commit marker)."""
        if n < 0:
            raise ValueError(f"truncate to negative length {n}")
        if n >= self._count:
            return
        mat = self.matrix()
        self._chunks = [np.ascontiguousarray(mat[:n])] if n else []
        self._count = n

    @property
    def count(self) -> int:
        return self._count

    def get_count(self) -> int:
        return self._count

    def matrix(self) -> np.ndarray:
        """All rows as one ``[N, D]`` f32 matrix; ``[0, 0]`` when empty."""
        if not self._chunks:
            return np.zeros((0, 0), dtype=np.float32)
        if len(self._chunks) > 1:
            dims = {c.shape[1] for c in self._chunks}
            if len(dims) != 1:
                raise ValueError(f"store holds mixed dims {sorted(dims)}")
            self._chunks = [np.concatenate(self._chunks, axis=0)]
        return self._chunks[0]

    def get(self, index: int) -> np.ndarray:
        """A copy of row ``index``."""
        if not 0 <= index < self._count:
            raise IndexError(f"row {index} out of range for {self._count} rows")
        return self.matrix()[index].copy()

    def get_many(self, slice_args: Optional[Tuple[int, int]] = None
                 ) -> np.ndarray:
        """Rows ``[offset, offset + length)`` for ``slice_args = (offset,
        length)``, or every row when None."""
        mat = self.matrix()
        if slice_args is None:
            return mat
        offset, length = slice_args
        if offset < 0 or length < 0 or offset + length > self._count:
            raise IndexError(
                f"slice ({offset}, {length}) out of range for {self._count} rows"
            )
        return mat[offset: offset + length]

    def persist(self) -> None:
        """Write every row to the Parquet file, atomically."""
        pa = _arrow()

        mat = self.matrix()
        if mat.size == 0:
            table = self._empty_table()
        else:
            col = pa.FixedSizeListArray.from_arrays(
                pa.array(mat.reshape(-1), type=pa.float32()), mat.shape[1])
            table = pa.table({EMBEDDINGS_COLUMN: col})
        self._write_table(table)
        if not self.path.exists():
            raise IOError(f"persist failed: {self.path} missing after write")

    def reload(self, force: bool = False) -> None:
        """Re-read the rows from the file. A missing or empty file raises
        unless ``force``, which then leaves the store empty."""
        exists = self.path.exists() and self.path.stat().st_size > 0
        if not exists and not force:
            raise IOError(f"reload: {self.path} is missing or empty")
        self._chunks, self._count = [], 0
        if self.path.exists():
            self._read_parquet(create_if_missing=force)


def local_store(store_dir: str | os.PathLike, shard: int,
                empty: bool = True) -> ParquetVectorStore:
    return ParquetVectorStore(local_store_path(store_dir, shard), empty=empty)


def global_store(store_dir: str | os.PathLike,
                 empty: bool = True) -> ParquetVectorStore:
    return ParquetVectorStore(global_store_path(store_dir), empty=empty)


def attrs_path(store_dir: str | os.PathLike) -> Path:
    """Row -> file-identity sidecar of the merged store, parallel to
    ``manifest.json``: ``[size, mtime_ns, fingerprint]`` or null per row."""
    return Path(store_dir) / "manifest.attrs.json"


def load_attrs(store_dir: str | os.PathLike) -> Optional[List]:
    """The row -> identity list, or None when never written or unreadable."""
    p = attrs_path(store_dir)
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text())
    except ValueError:
        return None


def global_ahead_marker(store_dir: str | os.PathLike) -> Path:
    """Marker of an update that appended rows straight to global.parquet:
    a merge from the shards would discard them."""
    return Path(store_dir) / "global.parquet.ahead"


def update_commit_path(store_dir: str | os.PathLike) -> Path:
    """Commit marker binding global.parquet's identity to fingerprints of
    the manifest and attrs sidecars (written last)."""
    return Path(store_dir) / "update_commit.json"


def _file_sha(path: Path) -> Optional[str]:
    import hashlib

    if not path.exists():
        return None
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _store_sample_sha(path: Path, blocks: int = 32,
                      block_bytes: int = 16384) -> str:
    """sha256 over the file size and ``blocks`` evenly spaced reads (the
    whole file up to ``blocks * block_bytes``) — the reference's sampled
    fingerprint, so either package validates the other's marker."""
    import hashlib

    h = hashlib.sha256()
    size = path.stat().st_size
    h.update(str(size).encode())
    with open(path, "rb") as f:
        if size <= blocks * block_bytes:
            h.update(f.read())
        else:
            step = (size - block_bytes) / (blocks - 1)
            for i in range(blocks):
                f.seek(int(i * step))
                h.update(f.read(block_bytes))
    return h.hexdigest()


def write_update_commit(store_dir: str | os.PathLike) -> None:
    """Record the committed (store, manifest, attrs) triple; call strictly
    after all three files are in place."""
    store_dir = Path(store_dir)
    gpath = global_store_path(store_dir)
    st = gpath.stat()
    payload = {
        "store_size": st.st_size,
        "store_mtime_ns": st.st_mtime_ns,
        "store_sample_sha": _store_sample_sha(gpath),
        "rows": parquet_row_count(gpath),
        "manifest_sha": _file_sha(manifest_path(store_dir)),
        "attrs_sha": _file_sha(attrs_path(store_dir)),
    }
    marker = update_commit_path(store_dir)
    tmp = marker.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(payload))
    os.replace(tmp, marker)


def validate_update_commit(store_dir: str | os.PathLike) -> Optional[str]:
    """A description of a torn (store, manifest, attrs) triple against the
    commit marker, or None when consistent or never committed."""
    store_dir = Path(store_dir)
    marker = update_commit_path(store_dir)
    if not marker.exists():
        return None
    try:
        rec = json.loads(marker.read_text())
    except ValueError:
        return f"unreadable update-commit marker {marker}"
    gpath = global_store_path(store_dir)
    if not gpath.exists():
        return f"update marker exists but {gpath} is missing"
    st = gpath.stat()
    problems = []
    if (st.st_size, st.st_mtime_ns) != (rec.get("store_size"),
                                        rec.get("store_mtime_ns")):
        # a copy moves the mtime; the sampled content tells a copy apart
        # from another store
        sample = rec.get("store_sample_sha")
        if sample is None or _store_sample_sha(gpath) != sample:
            problems.append("global.parquet differs from the last "
                            "committed update (content mismatch)")
    for path, key in ((manifest_path(store_dir), "manifest_sha"),
                      (attrs_path(store_dir), "attrs_sha")):
        sha = _file_sha(path)
        if sha is not None and rec.get(key) is not None and sha != rec[key]:
            problems.append(f"{path.name} differs from the last committed "
                            "update")
    if not problems:
        return None
    return ("; ".join(problems)
            + " — an update() likely crashed between its atomic renames; "
              "run a full ingest to rebuild (row->path alignment cannot be "
              "trusted)")


def encoder_meta_path(store_dir: str | os.PathLike) -> Path:
    """Which encoder numerics (backend, attention implementation, dtype)
    produced the stored embeddings."""
    return Path(store_dir) / "encoder.json"


def write_encoder_meta(store_dir: str | os.PathLike, meta: dict) -> None:
    atomic_write_text(encoder_meta_path(store_dir),
                       json.dumps(meta, sort_keys=True))


def load_encoder_meta(store_dir: str | os.PathLike) -> Optional[dict]:
    path = encoder_meta_path(store_dir)
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except ValueError:
        return None


def merge_vector_stores(num_shards: int, store_dir: str | os.PathLike,
                        allow_partial: bool = False,
                        force: bool = False) -> ParquetVectorStore:
    """Merge the shard stores into the global store in shard order (the
    order keeps local -> global row indices valid). A missing or unreadable
    shard is an error unless ``allow_partial``, which records the skipped
    shards in ``global.parquet.partial``; an empty shard merges as zero
    rows. Refused while ``global.parquet.ahead`` exists unless ``force``
    (which clears it). The caller persists."""
    ahead = global_ahead_marker(store_dir)
    if ahead.exists() and not force:
        raise RuntimeError(
            f"merge: global store at {store_dir} is AHEAD of its shards "
            f"({ahead.read_text()}); merging would discard the appended "
            "rows. Re-run a full ingest of every shard and merge with "
            "force=True (--force-merge), or delete the marker if you "
            "accept losing the appended rows.")
    merged = global_store(store_dir, empty=True)
    skipped: list = []
    for shard in range(num_shards):
        path = local_store_path(store_dir, shard)
        if not path.exists():
            if not allow_partial:
                raise FileNotFoundError(
                    f"merge: shard {shard} missing ({path}); re-run its "
                    "ingest or pass allow_partial=True to publish an "
                    "explicitly partial store")
            host_log(f"merge: shard {shard} MISSING ({path}), skipping")
            skipped.append(shard)
            continue
        try:
            shard_store = ParquetVectorStore(path, empty=False)
        except Exception as exc:
            if not allow_partial:
                raise RuntimeError(
                    f"merge: shard {shard} unreadable ({path}): {exc}"
                ) from exc
            host_log(f"merge: skipping unreadable shard {shard} ({path}): "
                     f"{exc}")
            skipped.append(shard)
            continue
        if shard_store.count == 0:
            host_log(f"merge: shard {shard} is empty, skipping")
            continue
        merged.append_many(shard_store.matrix())
    marker = partial_merge_marker(store_dir)
    if skipped:
        atomic_write_text(marker, json.dumps({"skipped_shards": skipped}))
    elif marker.exists():
        marker.unlink()
    if ahead.exists():
        ahead.unlink()
    return merged
