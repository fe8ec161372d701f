"""Corpus ingestion: recursive file discovery + capped reads.

The port's copy of ``better_search_rag_rust_tpu/corpus/walker.py``, with the
same semantics; its C++ reader is the port's own :mod:`..native`.

Capability parity with the reference's L0 corpus layer
(reference: src/source.rs:8-49):

* ``find_files_by_extensions(dir, exts)`` — recursive walk filtered by an
  extension set (src/source.rs:8-21).
* ``read_file(path)`` — UTF-8 read with a 10 MB cap; oversized or unreadable
  files yield ``None`` (src/source.rs:23-49).

Differences by design:

* Results are **sorted** so every host computes the identical file order
  without communication — the reference relies on ``walkdir``'s traversal
  order being identical across ranks, which is fragile; a canonical sort makes
  the SPMD block split (see :mod:`..parallel.partition`) deterministic.
* A multi-threaded C++ walker/reader (:mod:`..native`) is used when its
  shared library is available; this pure-Python path is the fallback and the
  semantic definition.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from ..config import DEFAULT_MAX_FILE_BYTES


def _normalize_extensions(extensions: Sequence[str]) -> Tuple[str, ...]:
    """Accept both "java" and ".java" spellings."""
    out = []
    for ext in extensions:
        ext = ext.lower()
        out.append(ext if ext.startswith(".") else "." + ext)
    return tuple(out)


def find_files_by_extensions(
    root: str | os.PathLike, extensions: Sequence[str]
) -> List[Path]:
    """Recursively collect files under ``root`` whose suffix is in
    ``extensions`` (reference: src/source.rs:8-21). Deterministically sorted.

    An empty extension list matches nothing (the reference's filter likewise
    never matches when the set is empty — src/source.rs tests :204-230).
    """
    exts = _normalize_extensions(extensions)
    if not exts:
        return []
    root = Path(root)
    if not root.exists():
        return []
    found: List[Path] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in filenames:
            if Path(fname).suffix.lower() in exts:
                found.append(Path(dirpath) / fname)
    found.sort()
    return found


def read_file(
    path: str | os.PathLike, max_bytes: int = DEFAULT_MAX_FILE_BYTES
) -> Optional[str]:
    """Read a text file, returning ``None`` for missing, oversized (> 10 MB by
    default) or undecodable files (reference: src/source.rs:23-49).

    Decoding errors are replaced rather than fatal so a single binary-ish file
    cannot kill an ingest shard (the reference logs-and-skips the same way,
    src/mpi_helpers/tasks.rs:95-116).
    """
    path = Path(path)
    try:
        size = path.stat().st_size
    except OSError:
        return None
    if size > max_bytes:
        return None
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return f.read()
    except OSError:
        return None


def read_files(
    paths: Sequence[str | os.PathLike],
    max_bytes: int = DEFAULT_MAX_FILE_BYTES,
) -> List[Tuple[Path, Optional[str]]]:
    """Batch read; keeps (path, content-or-None) pairing so callers can log
    skips per file (reference: src/mpi_helpers/tasks.rs:95-116)."""
    native = _native_reader()
    if native is not None:
        return native(paths, max_bytes)
    return [(Path(p), read_file(p, max_bytes)) for p in paths]


def content_fingerprint(content: str) -> str:
    """Stable identity of the text that was actually embedded (post-read,
    post-decode) — what incremental ``update()`` compares to decide whether a
    file's stored embedding is stale. blake2b-128 of the UTF-8 bytes."""
    import hashlib

    return hashlib.blake2b(
        content.encode("utf-8", errors="surrogatepass"), digest_size=16
    ).hexdigest()


def file_stat(path: str | os.PathLike) -> Optional[Tuple[int, int]]:
    """``(size, mtime_ns)`` or None when unstattable. Taken BEFORE the read:
    if the file is rewritten between stat and read, the recorded identity
    carries the OLD stat with the NEW content's fingerprint, so the next
    update()'s stat fast path MISSES and re-checks the fingerprint —
    self-healing in the safe direction. (Stat-after-read heals the wrong
    way: new stat + old content's hash makes the edit permanently
    undetectable.)"""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_size, st.st_mtime_ns


def file_attr(
    stat: Optional[Tuple[int, int]], content: str
) -> Optional[list]:
    """``[size, mtime_ns, fingerprint]`` identity triple recorded per stored
    row from a PRE-READ :func:`file_stat` plus the content actually read.
    size+mtime are the cheap staleness precheck (no read needed when they
    match); the fingerprint is the truth when they differ. ``None`` when the
    stat failed — the row then simply has no recorded identity and is never
    edit-detected (same as pre-attrs stores)."""
    if stat is None:
        return None
    return [stat[0], stat[1], content_fingerprint(content)]


def _native_reader():
    """Hook for the C++ multi-threaded reader; None when unavailable."""
    try:
        from ..native import corpus as native_corpus

        if native_corpus.available():
            return native_corpus.read_files
    except Exception:
        pass
    return None
