"""Exact top-k search engine over a one-device store.

Counterpart of ``better_search_rag_rust_tpu/ops/engine.py`` with its public
surface (``:131-427``): ``search``, ``search_async``/``collect``,
``search_stream``, ``search_device``, ``search_single``, ``oracle_topk``,
``effective_store``/``effective_queries``, ``prepare_upload_queries``,
``supports_store_upload`` and ``kernel_name``.

Routes. ``"rescore"`` is the sims-free route (K1 + K2, ``ops/topk.py``
:func:`..topk.rescore_topk`); ``"global"`` is the dense route (K3,
:func:`..topk.global_topk`), which also answers to the reference's
``"pallas"`` name — in the port the dense route always scores through its
kernel. ``"auto"`` keeps the reference's rule: rescore for shards of at
least 2^19 rows whose rescore traffic undercuts the dense route's, dense
below. Where K1/K2 cannot take the geometry, the route is dense before
dispatch, and :meth:`SearchEngine.kernel_name` reports the route that runs.

Results: ids are int64 (the reference packed them into f32 for its relay;
nothing here needs that), distances ``1 - clamp(sim, -1, 1)``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SearchConfig
from ..store.device_store import DeviceStore
from .distance import distances_from_sims, normalize_rows
from .quantize import cast_rows_to, cast_rows_to_host
from .topk import global_topk, rescore_feasible, rescore_topk, serial_topk
from .topk_kernels import kernel_scoring_exact_for, matmul_blockmax

#: Routes of the reference that the port does not have yet (ROADMAP.md).
_NOT_PORTED = {
    "scan": "the chunked-scan comparison route",
    "blockmax": "the chunked-scan comparison route",
    "f32cert": "the f32 certified route (kernel K4, gather_rows)",
}
#: f32 score-buffer budget of the dense route per query tile, in bytes.
_SIMS_BUDGET = 2 << 30
#: Queries per oracle score tile, and the most scores one tile may hold
#: (its [tile, rows] f32 buffer and the sort's keys and indices beside it:
#: 256 queries at 1M rows, 26 at 10M).
_ORACLE_TILE = 256
_ORACLE_SCORES = 1 << 28


class SearchHandle:
    """An in-flight :meth:`SearchEngine.search_async` result: host buffers
    the device-to-host copy lands in, and the event that marks it done."""

    def __init__(self, vals: torch.Tensor, ids: torch.Tensor,
                 event: Optional["torch.cuda.Event"]):
        self.vals = vals
        self.ids = ids
        self.event = event


class SearchEngine:
    """Exact batched cosine top-k over a :class:`DeviceStore`."""

    def __init__(self, store: DeviceStore,
                 config: Optional[SearchConfig] = None):
        self.store = store
        self.config = config or SearchConfig()

    @property
    def device(self) -> torch.device:
        return self.store.device

    # -- query preparation ----------------------------------------------------

    def _prepare_queries(self, queries) -> np.ndarray:
        """2-D f32 host queries, Matryoshka-truncated to the store dim when
        the store was truncated. Always a writable copy (torch refuses to
        wrap read-only arrays, e.g. rows mapped from Parquet)."""
        queries = np.atleast_2d(np.array(queries, dtype=np.float32))
        if (self.store.matryoshka_from is not None
                and queries.shape[1] == self.store.matryoshka_from):
            queries = np.ascontiguousarray(queries[:, : self.store.dim])
        if queries.shape[1] != self.store.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != store dim {self.store.dim}"
            )
        return queries

    def _resolve_k(self, k: Optional[int]) -> int:
        k = self.config.top_k if k is None else k
        if k <= 0:
            raise ValueError(f"top_k must be positive, got {k}")
        return min(k, self.store.num_rows)

    def _cast_queries(self, queries: torch.Tensor) -> torch.Tensor:
        """Device f32 queries -> normalized, store-dtype, contiguous."""
        return cast_rows_to(normalize_rows(queries),
                            self.store.dtype).contiguous()

    def prepare_device_queries(self, queries) -> torch.Tensor:
        """Host ``[Q, D]`` queries -> f32 device tensor, the input
        :meth:`search_device` takes."""
        return torch.from_numpy(self._prepare_queries(queries)).to(self.device)

    def supports_store_upload(self) -> bool:
        """Whether ``upload="store"`` shrinks the query upload (sub-f32
        store dtypes)."""
        return self.store.dtype.itemsize < 4

    def prepare_upload_queries(self, queries) -> torch.Tensor:
        """Host-side query prep for the smaller upload (half the f32 bytes
        on bf16 stores, a quarter on int8): the normalization in host f32,
        then ONE rounding to the store dtype. Returns a CPU tensor in the
        store dtype — the exact bits the precast search scores; feed the
        same queries to :meth:`oracle_topk` with ``upload="store"``."""
        queries = self._prepare_queries(queries)
        norms = np.sqrt(
            np.sum(queries * queries, axis=-1, keepdims=True, dtype=np.float32)
        )
        qn = queries / np.where(norms == 0.0, 1.0, norms)
        return cast_rows_to_host(qn, self.store.dtype)

    def _resolve_upload(self, upload: str) -> bool:
        if upload not in ("f32", "store"):
            raise ValueError(f"upload must be 'f32' or 'store', got {upload!r}")
        return upload == "store" and self.supports_store_upload()

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host.to(self.device)

    # -- search ---------------------------------------------------------------

    def _run(self, queries_cast: torch.Tensor, k_eff: int) -> Tuple[
            torch.Tensor, torch.Tensor]:
        """The resolved route on store-dtype queries: ``(sims [Q, k] f32,
        ids [Q, k] int64)`` on the device."""
        store = self.store
        if self._resolve_kernel(k_eff) == "rescore":
            sub, block = self._rescore_geometry(k_eff)
            return rescore_topk(
                store.data, queries_cast, k_eff, store.num_rows,
                q_tile=512, block=block, sub_block=sub,
                argmax_fast=self._argmax_enabled(),
                danger_units=self.config.danger_units,
                sup_w=self.config.rescore_sup_w,
            )
        q_tile = max(1, min(queries_cast.shape[0], 256))
        return global_topk(
            store.data, queries_cast, k_eff, store.num_rows, q_tile,
            block=self.config.row_block,
            macro_rows=max(1024, _SIMS_BUDGET // (q_tile * 4)),
        )

    def search_device(self, queries: torch.Tensor, k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident search: f32 queries already on the store's device
        (e.g. from :meth:`prepare_device_queries`); results stay there as
        ``(similarities [Q, k] f32, ids [Q, k] int64)``."""
        k_eff = self._resolve_k(k)
        if queries.dim() != 2 or queries.shape[1] != self.store.dim:
            raise ValueError(
                f"device queries must be [Q, {self.store.dim}], got "
                f"{tuple(queries.shape)}"
            )
        if queries.device != self.device:
            raise ValueError(
                f"queries on {queries.device}, store on {self.device}")
        return self._run(self._cast_queries(queries), k_eff)

    def search_async(self, queries, k: Optional[int] = None,
                     upload: str = "f32") -> SearchHandle:
        """Launch a search without waiting for it: the route runs on the
        current stream and its results start copying into pinned host
        buffers. ``queries`` may be host (numpy) or a device tensor.
        ``upload="store"`` rounds queries to the store dtype on the host and
        uploads those bits (half the bytes on bf16 stores)."""
        k_eff = self._resolve_k(k)
        if isinstance(queries, torch.Tensor) and queries.device == self.device:
            q = queries.to(torch.float32)
            if (self.store.matryoshka_from is not None
                    and q.shape[-1] == self.store.matryoshka_from):
                q = q[:, : self.store.dim]
            vals, ids = self.search_device(q, k_eff)
        elif self._resolve_upload(upload):
            qc = self._upload(self.prepare_upload_queries(queries))
            vals, ids = self._run(qc.contiguous(), k_eff)
        else:
            q = self._upload(torch.from_numpy(self._prepare_queries(queries)))
            vals, ids = self._run(self._cast_queries(q), k_eff)
        if self.device.type != "cuda":
            return SearchHandle(vals, ids, None)
        host_v = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        host_i = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        host_v.copy_(vals, non_blocking=True)
        host_i.copy_(ids, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return SearchHandle(host_v, host_i, event)

    def collect(self, handle: SearchHandle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`search_async` handle; ``(indices [Q, k'] int64,
        distances [Q, k'] f32)`` on the host."""
        if handle.event is not None:
            handle.event.synchronize()
        dists = distances_from_sims(handle.vals).cpu().numpy()
        return handle.ids.cpu().numpy().astype(np.int64), dists

    def search(self, queries, k: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows for a batch of queries: ``(indices [Q, k'],
        distances [Q, k'])``, ``k' = min(k, num_rows)``, distances
        ascending, ties by lowest store row."""
        return self.collect(self.search_async(queries, k))

    def search_stream(self, batches, k: Optional[int] = None, depth: int = 1,
                      upload: str = "f32"):
        """Pipelined streaming search: yields ``(indices, distances)`` per
        query batch, keeping up to ``depth`` batches in flight before the
        oldest is collected."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        k_eff = self._resolve_k(k)
        pending = deque()
        for q in batches:
            pending.append(self.search_async(q, k_eff, upload=upload))
            if len(pending) > depth:
                yield self.collect(pending.popleft())
        while pending:
            yield self.collect(pending.popleft())

    def search_single(self, query, k: Optional[int] = None
                      ) -> list[tuple[int, float]]:
        """One query as a ranked ``[(store row id, distance)]`` list."""
        ids, dists = self.search(np.asarray(query).reshape(1, -1), k)
        return list(zip(ids[0].tolist(), dists[0].tolist()))

    def kernel_name(self, k: Optional[int] = None) -> str:
        """The route the engine runs for this ``k``."""
        return self._resolve_kernel(self._resolve_k(k))

    # -- oracle ---------------------------------------------------------------

    def oracle_topk(self, queries, k: Optional[int] = None,
                    upload: str = "f32") -> Tuple[np.ndarray, np.ndarray]:
        """Serial-scan oracle over the engine's own scoring arithmetic: the
        full score matrix from K3 (on the CPU its plain version), selected
        by a stable sort — descending score, ties by lowest row. ``upload``
        pins the same query bits as the search it checks."""
        queries = self._prepare_queries(queries)
        k_eff = min(self.config.top_k if k is None else k, self.store.num_rows)
        if self._resolve_upload(upload):
            qc = self.prepare_upload_queries(queries).to(self.device)
        else:
            qc = self._cast_queries(torch.from_numpy(queries).to(self.device))
        n = self.store.num_rows
        if self.device.type != "cuda":
            sims, _ = matmul_blockmax(qc, self.store.data, n)
            return serial_topk(self.effective_store(), queries, k_eff,
                               sims=sims[:, :n].numpy())
        ids, vals = [], []
        tile = max(1, min(_ORACLE_TILE, _ORACLE_SCORES // n))
        for t0 in range(0, qc.shape[0], tile):
            sims, _ = matmul_blockmax(
                qc[t0:t0 + tile].contiguous(), self.store.data, n)
            order = torch.sort(-(sims[:, :n] + 0.0), dim=1, stable=True
                               ).indices[:, :k_eff]
            ids.append(order.cpu())
            vals.append(torch.gather(sims, 1, order).cpu())
        return (torch.cat(ids).numpy().astype(np.int64),
                distances_from_sims(torch.cat(vals)).numpy())

    def effective_store(self) -> np.ndarray:
        """What the engine scores against: normalized, dtype-rounded valid
        rows as host f32."""
        return self.store.effective_matrix()

    def effective_queries(self, queries) -> np.ndarray:
        """Queries after the engine's normalize + store-dtype cast, as f32."""
        q = torch.from_numpy(self._prepare_queries(queries))
        return self._cast_queries(q).to(torch.float32).numpy()

    # -- routing --------------------------------------------------------------

    def _argmax_enabled(self) -> bool:
        """Whether the rescore argmax fast path runs: the reference's rule
        (``ops/engine.py:490-513``) — off with ``rescore_argmax="off"``,
        and under ``"auto"`` off for low-dim int8 stores (``dim * 2 <
        1024``, e.g. ``search_10m_int8_mat256``), which take the full
        gather geometry. Exactness never depends on the choice."""
        mode = self.config.rescore_argmax
        if mode == "off":
            return False
        return not (mode == "auto" and self.store.dtype == torch.int8
                    and self.store.dim * 2 < 1024)

    def _rescore_geometry(self, k_eff: int) -> Tuple[int, int]:
        """``(sub, block)`` of the rescore route: the reference's choice
        (``ops/engine.py:515-543``) — 64-row units in 128-row blocks for
        high-dim stores under the argmax fast path, 16-row units for the
        full gather, 128-row units in 1024-row blocks for low-dim stores.
        The reference tuned these on a TPU; re-deriving them on the H100 is
        later work (ROADMAP.md)."""
        dim_bytes = self.store.dim * max(self.store.dtype.itemsize, 2)
        if dim_bytes >= 1024:
            return (64, 128) if self._argmax_enabled() else (16, 128)
        return 128, 1024

    def _rescore_wins(self, k_eff: int) -> bool:
        """The reference's traffic rule (``ops/engine.py:545-583``): rescore
        when its per-query traffic undercuts the dense route's score write
        and re-read (8 bytes per row), for shards of at least 2^19 rows."""
        rows = self.store.padded_rows
        dim = self.store.dim
        itemsize = self.store.dtype.itemsize
        sub, _block = self._rescore_geometry(k_eff)
        units = (max(1, self.config.danger_units) if self._argmax_enabled()
                 else k_eff)
        traffic = 8 * rows // sub + 5 * units * sub * dim * itemsize // 2
        return (rows >= 1 << 19 and traffic < 8 * rows
                and kernel_scoring_exact_for(self.store.dtype))

    def _resolve_kernel(self, k_eff: int) -> str:
        kernel = self.config.kernel
        if kernel in _NOT_PORTED:
            raise NotImplementedError(
                f"search kernel {kernel!r} ({_NOT_PORTED[kernel]}) is not "
                "ported; see ROADMAP.md"
            )
        if kernel == "auto":
            kernel = "rescore" if self._rescore_wins(k_eff) else "global"
        if kernel == "rescore":
            sub, block = self._rescore_geometry(k_eff)
            feasible = rescore_feasible(self.store.padded_rows, k_eff, sub,
                                        block, self.config.rescore_sup_w)
            return "rescore" if feasible else "global"
        if kernel in ("global", "pallas"):
            return "global"
        raise ValueError(f"unknown search kernel {kernel!r}")
