"""Tokenization with the reference's fixed-shape contract.

Counterpart of ``better_search_rag_rust_tpu/models/tokenizer.py``, whose
package ``__init__`` imports jax, so the module is carried over rather than
imported. The ids are the reference's bit for bit:

* :class:`HashingTokenizer` (:119) — word-level blake2b hashing into the
  vocab, CLS/SEP around the words, right-padded with PAD_ID to
  ``max_tokens``; all-ASCII batches go through the reference's own native
  tokenizer (``better_search_rag_rust_tpu.native.tokenize``, jax-free).
* :class:`FixedLengthTokenizer` (:42) — a real HF ``tokenizers.Tokenizer``
  with truncation and fixed padding, ``add_special_tokens=False`` (the
  reference encodes the bare token stream).
* :func:`load_tokenizer` (:216) — the checkpoint's ``tokenizer.json`` when
  present, else the hashing tokenizer.

An empty string in a batch raises "Invalid inputs: has empty values"; an
empty batch gives ``[0, max_tokens]`` arrays.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
_WORD_RE = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")


class TokenizerError(ValueError):
    pass


def _check_batch(texts: Sequence[str]) -> None:
    if any(len(t) == 0 for t in texts):
        raise TokenizerError("Invalid inputs: has empty values")


def _empty(max_tokens: int) -> Tuple[np.ndarray, np.ndarray]:
    z = np.zeros((0, max_tokens), dtype=np.int32)
    return z, z.copy()


class FixedLengthTokenizer:
    """HF tokenizer with truncation + fixed right-padding to ``max_tokens``."""

    def __init__(self, tokenizer, max_tokens: int = 512,
                 add_special_tokens: bool = False):
        self.max_tokens = max_tokens
        self.add_special_tokens = add_special_tokens
        self._tok = tokenizer
        self._tok.enable_truncation(max_length=max_tokens)
        self._tok.enable_padding(length=max_tokens, pad_id=PAD_ID,
                                 pad_token="[PAD]")

    @staticmethod
    def from_file(path: str | Path, max_tokens: int = 512,
                  add_special_tokens: bool = False) -> "FixedLengthTokenizer":
        from tokenizers import Tokenizer

        return FixedLengthTokenizer(Tokenizer.from_file(str(path)), max_tokens,
                                    add_special_tokens)

    def encode_batch(self, texts: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if len(texts) == 0:
            return _empty(self.max_tokens)
        _check_batch(texts)
        encs = self._tok.encode_batch(
            list(texts), add_special_tokens=self.add_special_tokens)
        ids = np.asarray([e.ids for e in encs], dtype=np.int32)
        mask = np.asarray([e.attention_mask for e in encs], dtype=np.int32)
        return ids, mask

    def encode_batch_windows(self, texts: Sequence[str]
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every text becomes >= 1 fixed-shape window covering all its
        tokens (the head window plus the overflow encodings); ``group[w]`` is
        window w's text index."""
        if len(texts) == 0:
            ids, mask = _empty(self.max_tokens)
            return ids, mask, np.zeros((0,), dtype=np.int64)
        _check_batch(texts)
        ids_rows, mask_rows, groups = [], [], []
        encs = self._tok.encode_batch(
            list(texts), add_special_tokens=self.add_special_tokens)
        for i, enc in enumerate(encs):
            for window in [enc, *enc.overflowing]:
                ids_rows.append(window.ids)
                mask_rows.append(window.attention_mask)
                groups.append(i)
        return (np.asarray(ids_rows, dtype=np.int32),
                np.asarray(mask_rows, dtype=np.int32),
                np.asarray(groups, dtype=np.int64))


class HashingTokenizer:
    """Deterministic, artifact-free tokenizer: words/punctuation hashed
    into ``[NUM_SPECIAL, vocab_size)`` with blake2b; ids 0..9 reserved
    (0 = PAD, 1 = CLS, 2 = SEP)."""

    NUM_SPECIAL = 10
    CLS_ID = 1
    SEP_ID = 2
    #: token -> id memo cap (bounded so unique-token streams cannot grow it
    #: without limit).
    MAX_CACHE = 1 << 20

    def __init__(self, vocab_size: int = 30528, max_tokens: int = 512):
        self.vocab_size = vocab_size
        self.max_tokens = max_tokens
        self._id_cache: dict = {}

    def _token_id(self, token: str) -> int:
        tid = self._id_cache.get(token)
        if tid is None:
            digest = hashlib.blake2b(token.encode("utf-8"),
                                     digest_size=8).digest()
            span = self.vocab_size - self.NUM_SPECIAL
            tid = self.NUM_SPECIAL + int.from_bytes(digest, "little") % span
            if len(self._id_cache) >= self.MAX_CACHE:
                self._id_cache.clear()
            self._id_cache[token] = tid
        return tid

    def _row(self, words: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        s = self.max_tokens
        row = np.full((s,), PAD_ID, dtype=np.int32)
        m = np.zeros((s,), dtype=np.int32)
        seq = [self.CLS_ID, *(self._token_id(w) for w in words), self.SEP_ID]
        row[: len(seq)] = seq
        m[: len(seq)] = 1
        return row, m

    def encode_batch(self, texts: Sequence[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if len(texts) == 0:
            return _empty(self.max_tokens)
        _check_batch(texts)
        s = self.max_tokens
        # The reference's GIL-free C++ path for all-ASCII batches (bitwise the
        # same ids); non-ASCII or NUL-bearing batches take the Python path.
        from better_search_rag_rust_tpu.native.tokenize import (
            encode_batch_native,
        )

        native = encode_batch_native(texts, s, self.vocab_size)
        if native is not None:
            return native
        rows = [self._row(_WORD_RE.findall(t.lower())[: s - 2]) for t in texts]
        return (np.stack([r for r, _ in rows]),
                np.stack([m for _, m in rows]))

    def encode_batch_windows(self, texts: Sequence[str]
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The word stream split into consecutive ``max_tokens - 2``
        windows, CLS/SEP re-added to each."""
        if len(texts) == 0:
            ids, mask = _empty(self.max_tokens)
            return ids, mask, np.zeros((0,), dtype=np.int64)
        _check_batch(texts)
        body = self.max_tokens - 2
        rows: List[Tuple[np.ndarray, np.ndarray]] = []
        groups = []
        for i, text in enumerate(texts):
            words = _WORD_RE.findall(text.lower())
            for start in range(0, max(len(words), 1), body):
                rows.append(self._row(words[start: start + body]))
                groups.append(i)
        return (np.stack([r for r, _ in rows]),
                np.stack([m for _, m in rows]),
                np.asarray(groups, dtype=np.int64))


def load_tokenizer(checkpoint_dir: Optional[str], max_tokens: int = 512,
                   vocab_size: int = 30528, add_special_tokens: bool = False):
    """``tokenizer.json`` under the checkpoint dir when available, else the
    hermetic hashing tokenizer."""
    if checkpoint_dir:
        tok_file = Path(checkpoint_dir) / "tokenizer.json"
        if tok_file.exists():
            return FixedLengthTokenizer.from_file(tok_file, max_tokens,
                                                  add_special_tokens)
    return HashingTokenizer(vocab_size=vocab_size, max_tokens=max_tokens)
