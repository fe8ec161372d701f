"""ctypes binding for the native hashing tokenizer (``bsr_tokenize.cpp``).

Bitwise-compatible with :class:`..models.tokenizer.HashingTokenizer` for
ASCII inputs (same blake2b ids, same word split, same CLS/SEP/PAD layout);
the caller routes any batch containing non-ASCII text to the pure-Python
path so Unicode lowering/whitespace semantics never diverge.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from . import load


def available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "bsr_tokenize")


def encode_batch_native(
    texts: Sequence[str], max_tokens: int, vocab_size: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native tokenize of an all-ASCII batch; None when unavailable or any
    text is non-ASCII (caller falls back to Python)."""
    lib = load()
    if lib is None or not hasattr(lib, "bsr_tokenize"):
        return None
    # NUL would truncate the C string (Python tokenizes it as a regular
    # non-space char), so NUL-bearing texts take the Python path too.
    if not all(t.isascii() and "\x00" not in t for t in texts):
        return None
    n = len(texts)
    ids = np.empty((n, max_tokens), dtype=np.int32)
    mask = np.empty((n, max_tokens), dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[t.encode("ascii") for t in texts])
    rc = lib.bsr_tokenize(
        arr, n, max_tokens, vocab_size,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        0,
    )
    if rc != 0:
        return None
    return ids, mask
