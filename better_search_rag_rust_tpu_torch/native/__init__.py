"""Native (C++) host components of the port, loaded over ctypes.

The port's copies of ``better_search_rag_rust_tpu/native/``:

* ``bsr_corpus.cpp`` — multithreaded corpus walker + capped file reader
  (reference: src/source.rs:8-49, where ingest spends its host time).
* ``bsr_tokenize.cpp`` — the hashing tokenizer's hot loop (blake2b + word
  split, bitwise the ids of models/tokenizer.py for ASCII inputs),
  GIL-free on a thread pool.

The shared library is built with g++ at first use (never at import) into
``build/native/`` beside the package (listed in ``.gitignore``), named by a
hash of the sources and flags. Every consumer falls back to the pure-Python
implementation when the toolchain or the build is unavailable: host code
with the same output, so the package never needs a compiler.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
_SRCS = [_DIR / "bsr_corpus.cpp", _DIR / "bsr_tokenize.cpp"]
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    """Where the library lives, tagged by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbsr_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile to a process-unique temp file and atomically rename into
    place, so concurrent processes never dlopen a half-written library."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", *_FLAGS, *[str(s) for s in _SRCS], "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def load():
    """The loaded ctypes library, or None when unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            _build_failed = True
            return None
        try:
            import ctypes

            lib = ctypes.CDLL(str(out))
            lib.bsr_walk.restype = ctypes.c_void_p
            lib.bsr_walk.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.bsr_free.argtypes = [ctypes.c_void_p]
            lib.bsr_read_files.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int32,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            lib.bsr_tokenize.restype = ctypes.c_int32
            lib.bsr_tokenize.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
            _lib = lib
            return _lib
        except Exception:
            _build_failed = True
            return None
