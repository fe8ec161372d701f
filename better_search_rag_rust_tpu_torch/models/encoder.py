"""Encoder service: tokenizer + forward with the reference's contract.

Counterpart of ``better_search_rag_rust_tpu/models/encoder.py``
(``EncoderService`` :61, ``create_encoder`` :268):

* an empty batch gives ``[0, dim]``;
* an empty string in the batch raises "Invalid inputs: has empty values";
* every device batch has the fixed ``batch_size`` rows (the ragged tail is
  padded with zero-mask rows, dropped after the forward);
* ``long_doc="mean"`` windows the whole token stream, encodes every window
  and mean-pools per document, then re-normalizes;
* one f32 embedding row per input text.

The three stages (``tokenize`` on the host, ``dispatch`` queues the forward
on the device and the copy back into pinned host memory, ``collect`` waits
for the copy) let ingest overlap batch i+1's tokenize and batch i's forward
with batch i-1's store append.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Protocol, Sequence

import numpy as np
import torch

from ..config import EncoderConfig, torch_dtype
from ..utils.device import resolve_device
from ..utils.logging import host_log
from .hash_encoder import HashEncoder
from .nomic import (
    NomicBertConfig,
    NomicEncoder,
    _resolve_attention_impl,
    load_hf_checkpoint,
)
from .tokenizer import load_tokenizer


class TokenEncoder(Protocol):
    """What :class:`EncoderService` asks of a forward (the hash and NomicBERT
    encoders): token rows to embeddings on the device, or on the host."""

    def encode_tokens_device(self, input_ids: np.ndarray,
                             attention_mask: np.ndarray) -> torch.Tensor: ...

    def encode_tokens(self, input_ids: np.ndarray,
                      attention_mask: np.ndarray) -> np.ndarray: ...


class TokenBatch(NamedTuple):
    """Tokenized texts; ``groups`` maps token rows to documents when
    ``long_doc="mean"`` expanded documents into several windows."""

    ids: np.ndarray
    mask: np.ndarray
    groups: Optional[np.ndarray]
    n_docs: int


class _Buffer(NamedTuple):
    """One fixed-size sub-batch in flight: its device result, the pinned
    host tensor it is being copied into, and the event marking the copy."""

    device: torch.Tensor
    host: Optional[torch.Tensor]
    event: Optional["torch.cuda.Event"]


class PendingEmbeddings(NamedTuple):
    """An in-flight forward; collect with :meth:`EncoderService.collect`."""

    buffers: list
    tb: TokenBatch
    n_rows: int


class EncoderService:
    """Batch text embedding with fixed-shape device batches."""

    def __init__(self, tokenizer, encoder: TokenEncoder, dim: int,
                 batch_size: int = 32,
                 long_doc: str = "truncate"):
        self.tokenizer = tokenizer
        self.encoder = encoder
        self.dim = dim
        self.batch_size = batch_size
        self.long_doc = long_doc
        #: "hash", "nomic-random-init", "nomic-checkpoint"
        self.backend_label = type(encoder).__name__
        #: Numerics fingerprint written to the store's encoder.json at ingest
        #: and compared at query time.
        self.numerics: dict = {}

    def _windowed(self) -> bool:
        return self.long_doc == "mean" and hasattr(self.tokenizer,
                                                    "encode_batch_windows")

    def tokenize(self, texts: Sequence[str]) -> TokenBatch:
        """Stage 1 (host, thread-safe): texts -> token rows. Raises on an
        empty string."""
        n = len(texts)
        if n == 0:
            empty = np.zeros((0, 0), dtype=np.int32)
            return TokenBatch(empty, empty, None, 0)
        if self._windowed():
            ids, mask, groups = self.tokenizer.encode_batch_windows(texts)
            return TokenBatch(ids, mask, groups, n)
        ids, mask = self.tokenizer.encode_batch(texts)
        return TokenBatch(ids, mask, None, n)

    def dispatch(self, tb: TokenBatch, host_copy: bool = True
                 ) -> PendingEmbeddings:
        """Stage 2: queue the forward of every fixed-``batch_size``
        sub-batch (zero-mask rows pad the tail) without waiting; with
        ``host_copy`` also queue each result's copy into pinned host
        memory."""
        n = tb.ids.shape[0]
        if n == 0:
            return PendingEmbeddings([], tb, 0)
        ids, mask = tb.ids, tb.mask
        bs = self.batch_size
        padded_n = -(-n // bs) * bs
        if padded_n != n:
            pad = np.zeros((padded_n - n, ids.shape[1]), dtype=ids.dtype)
            ids = np.concatenate([ids, pad])
            mask = np.concatenate([mask, pad.astype(mask.dtype)])
        buffers = []
        for s in range(0, padded_n, bs):
            out = self.encoder.encode_tokens_device(ids[s: s + bs],
                                                    mask[s: s + bs])
            host, event = None, None
            if host_copy and out.device.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            buffers.append(_Buffer(out, host, event))
        return PendingEmbeddings(buffers, tb, n)

    def collect(self, pending: PendingEmbeddings) -> np.ndarray:
        """Stage 3: wait for the results on the host and reduce windows.
        ``-> [n_docs, dim]`` f32."""
        tb = pending.tb
        if pending.n_rows == 0:
            return np.zeros((tb.n_docs, self.dim), dtype=np.float32)
        parts = []
        for buf in pending.buffers:
            if buf.event is not None:
                buf.event.synchronize()
                parts.append(buf.host.numpy())
            else:
                parts.append(buf.device.cpu().numpy())
        out = np.concatenate(parts).astype(np.float32, copy=False)
        return self._reduce_rows(tb, out[: pending.n_rows])

    def collect_many(self, pendings: Sequence[PendingEmbeddings]) -> list:
        """Stage 3 for a window of dispatches: their device results joined
        and read to the host in ONE copy, then split and reduced per
        dispatch — the same values as ``[collect(p) for p in pendings]``.
        With one buffer or none it is exactly that."""
        bufs = [b.device for p in pendings for b in p.buffers]
        if len(bufs) <= 1:
            return [self.collect(p) for p in pendings]
        packed = torch.cat(bufs).to(torch.float32).cpu().numpy()
        out, off = [], 0
        for p in pendings:
            rows = packed[off: off + p.n_rows]
            off += len(p.buffers) * self.batch_size
            out.append(self._reduce_rows(p.tb, rows) if p.n_rows else
                       np.zeros((p.tb.n_docs, self.dim), dtype=np.float32))
        return out

    def _reduce_rows(self, tb: TokenBatch, rows: np.ndarray) -> np.ndarray:
        if tb.groups is None:
            return rows
        agg = np.zeros((tb.n_docs, self.dim), dtype=np.float32)
        np.add.at(agg, tb.groups, rows)
        counts = np.bincount(tb.groups, minlength=tb.n_docs).reshape(-1, 1)
        agg /= np.maximum(counts, 1)
        norms = np.linalg.norm(agg, axis=1, keepdims=True)
        return agg / np.where(norms == 0.0, 1.0, norms)

    def get_embeddings_device(self, texts: Sequence[str]
                              ) -> Optional[torch.Tensor]:
        """``[len(texts), dim]`` f32 left on the device, or None where the
        result needs the host (window pooling, empty input)."""
        if self._windowed():
            return None
        tb = self.tokenize(texts)
        if tb.n_docs == 0:
            return None
        pending = self.dispatch(tb, host_copy=False)
        bufs = [b.device for b in pending.buffers]
        cat = bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=0)
        return cat[: pending.n_rows].to(torch.float32)

    def get_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        """``texts -> [len(texts), dim]`` f32: the three stages in a row."""
        return self.collect(self.dispatch(self.tokenize(texts)))


def create_encoder(cfg: Optional[EncoderConfig] = None,
                   device: Optional[torch.device | str] = None,
                   seed: int = 0, mesh=None) -> EncoderService:
    """Backend by ``cfg.backend``: ``nomic`` (the HF checkpoint under
    ``cfg.checkpoint_dir`` when there is one, else random weights from
    ``seed``), ``hash``, or ``auto`` (nomic when a checkpoint dir exists,
    else hash). Every tensor lives on ``device`` (``None``: the CUDA card,
    raising without one).

    ``mesh``: the nomic forward's mesh (:class:`.nomic.NomicEncoder`): each
    ``batch_size`` batch splits over this process's shards of it, which
    must divide it (the numerics record ``dp_devices``), and a model axis
    splits the model over ranks. The hash backend, which runs no model,
    ignores it."""
    cfg = cfg or EncoderConfig()
    backend = cfg.backend
    if backend == "auto":
        backend = ("nomic" if cfg.checkpoint_dir
                   and os.path.isdir(cfg.checkpoint_dir) else "hash")

    if backend == "hash":
        device = resolve_device(device)
        enc = HashEncoder(dim=cfg.matryoshka_dim or cfg.dim,
                          max_tokens=cfg.max_tokens,
                          vocab_size=cfg.vocab_size, dtype=cfg.dtype,
                          device=device)
        svc = EncoderService(enc.tokenizer, enc, enc.dim,
                             batch_size=cfg.batch_size, long_doc=cfg.long_doc)
        svc.backend_label = "hash"
        # The same gather + f32 mean as the reference's: equal numerics.
        svc.numerics = {"backend": "hash", "dtype": str(cfg.dtype),
                        "dim": enc.dim, "max_tokens": cfg.max_tokens,
                        "long_doc": cfg.long_doc}
        return svc

    if backend == "nomic":
        n_local = 1 if mesh is None else len(mesh.local_shards())
        if cfg.batch_size % n_local:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide "
                             f"over the {n_local}-device mesh")
        if mesh is None:
            device = resolve_device(device)
        model_cfg = NomicBertConfig.from_encoder_config(cfg)
        state = None
        if cfg.checkpoint_dir:
            try:
                model_cfg, state = load_hf_checkpoint(cfg.checkpoint_dir,
                                                      model_cfg)
                host_log(f"loaded nomic checkpoint from {cfg.checkpoint_dir}")
            except FileNotFoundError as exc:
                host_log(f"checkpoint missing ({exc}); using random init")
        enc = NomicEncoder(model_cfg, state_dict=state,
                           matryoshka_dim=cfg.matryoshka_dim, seed=seed,
                           device=device, mesh=mesh)
        tokenizer = load_tokenizer(cfg.checkpoint_dir, cfg.max_tokens,
                                   cfg.vocab_size)
        svc = EncoderService(tokenizer, enc, enc.dim,
                             batch_size=cfg.batch_size, long_doc=cfg.long_doc)
        svc.backend_label = ("nomic-checkpoint" if state is not None
                             else "nomic-random-init")
        impl = _resolve_attention_impl(
            cfg.attention_impl, seq_len=cfg.max_tokens,
            head_dim=cfg.dim // max(1, cfg.num_heads))
        svc.numerics = {
            "backend": svc.backend_label,
            "model": cfg.name,
            # the port's own name: a store mixing the packages warns
            "attention_impl": f"torch-{impl}",
            "dtype": str(torch_dtype(cfg.dtype)).removeprefix("torch."),
            "dim": enc.dim,
            "max_tokens": cfg.max_tokens,
            "long_doc": cfg.long_doc,
            "matryoshka_dim": cfg.matryoshka_dim,
        }
        if n_local > 1:
            # a batch split over shards computes its blocks apart: record
            # it, so a shard-count change between ingest and serve warns
            svc.numerics["dp_devices"] = n_local
        return svc

    raise ValueError(f"unknown encoder backend {backend!r}")
