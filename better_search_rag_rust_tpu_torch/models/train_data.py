"""Contrastive training pairs from a source corpus.

Counterpart of ``better_search_rag_rust_tpu/models/train_data.py`` (whose
package imports jax): (anchor, positive) token batches from the corpus the
retriever indexes. Each file's token stream is windowed; a file with two or
more windows gives a pair of two of them, a single-window file an identity
pair. Batches are fixed-shape ``[B, S]`` int32 and, given the seed, the JAX
package's arrays bit for bit (the same walker, a tokenizer with the same
ids, the same numpy generator draws).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..corpus import find_files_by_extensions, read_files


def pairs_from_texts(
    texts: Sequence[str], tokenizer, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(anchor_ids, anchor_mask, positive_ids, positive_mask)``: one pair
    per text, built from that text's windows."""
    ids, mask, groups = tokenizer.encode_batch_windows(texts)
    rng = np.random.default_rng(seed)
    n = len(texts)
    a_rows = np.empty(n, dtype=np.int64)
    p_rows = np.empty(n, dtype=np.int64)
    for doc in range(n):
        windows = np.flatnonzero(groups == doc)
        if len(windows) >= 2:
            a, p = rng.choice(windows, size=2, replace=False)
        else:
            a = p = windows[0]
        a_rows[doc], p_rows[doc] = a, p
    return ids[a_rows], mask[a_rows], ids[p_rows], mask[p_rows]


def corpus_pair_batches(
    root: str,
    extensions: Sequence[str],
    tokenizer,
    batch_size: int,
    max_file_bytes: int = 10 * 1024 * 1024,
    seed: int = 0,
    epochs: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Deterministic shuffled epochs of fixed-size contrastive batches.
    Short tails are dropped; files that fail to read are skipped, as ingest
    skips them."""
    files = find_files_by_extensions(root, extensions)
    texts: List[str] = [c for _p, c in read_files(files, max_file_bytes) if c]
    if len(texts) < batch_size:
        raise ValueError(
            f"corpus has {len(texts)} readable files < batch_size {batch_size}")
    rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = rng.permutation(len(texts))
        for start in range(0, len(texts) - batch_size + 1, batch_size):
            batch = [texts[i] for i in order[start:start + batch_size]]
            yield pairs_from_texts(batch, tokenizer, seed=seed + epoch)
