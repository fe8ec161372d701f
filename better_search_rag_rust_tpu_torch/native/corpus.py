"""ctypes bindings for the native corpus loader (see ``bsr_corpus.cpp``).

Drop-in accelerations of :mod:`..corpus.walker`'s pure-Python definitions:
same signatures, same semantics (sorted walk, 10 MB cap -> None,
decode-with-replacement; reference: src/source.rs:8-49).
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from . import load


def available() -> bool:
    return load() is not None


def find_files_by_extensions(
    root: str | os.PathLike, extensions: Sequence[str]
) -> Optional[List[Path]]:
    """Native recursive walk; None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    csv = ",".join(extensions).encode()
    ptr = lib.bsr_walk(str(root).encode(), csv)
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.bsr_free(ptr)
    # Canonical order is Python's Path ordering (component-wise), which
    # differs from the C++ std::string sort for names like "a-b" vs "a/x"
    # ('-' < '/' as bytes). Re-sorting here keeps the SPMD block split
    # identical whichever walker a host used.
    return sorted(Path(line) for line in raw.splitlines() if line)


def read_files(
    paths: Sequence[str | os.PathLike], max_bytes: int
) -> List[Tuple[Path, Optional[str]]]:
    """Threaded batch read; (path, content-or-None) pairs in input order."""
    lib = load()
    if lib is None:
        raise RuntimeError("native corpus library unavailable")
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(
        *[str(p).encode("utf-8") for p in paths]
    )
    outs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_int64 * n)()
    rcs = (ctypes.c_int32 * n)()
    lib.bsr_read_files(c_paths, n, max_bytes, outs, lens, rcs, 0)
    results: List[Tuple[Path, Optional[str]]] = []
    for i, p in enumerate(paths):
        if rcs[i] != 0 or not outs[i]:
            results.append((Path(p), None))
            continue
        try:
            data = ctypes.string_at(outs[i], lens[i])
        finally:
            lib.bsr_free(outs[i])
        results.append((Path(p), data.decode("utf-8", errors="replace")))
    return results
