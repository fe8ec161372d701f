"""Exact top-k search engine over a store in one shard or many.

Counterpart of ``better_search_rag_rust_tpu/ops/engine.py`` with its public
surface (``:131-427``): ``search``, ``search_async``/``collect``,
``search_stream``, ``search_device``, ``search_single``, ``oracle_topk``,
``effective_store``/``effective_queries``, ``prepare_upload_queries``,
``supports_store_upload`` and ``kernel_name``.

Routes. ``"rescore"`` is the sims-free route (K1 + K2, ``ops/topk.py``
:func:`..topk.rescore_topk`); ``"global"`` is the dense route (K3,
:func:`..topk.global_topk`), which also answers to the reference's
``"pallas"`` name — in the port the dense route always scores through its
kernel; ``"f32cert"`` is the certified f32 route (K1 + K4 + K6 with a dense
fallback, :func:`..topk.rescore_f32_certified`). ``"auto"`` keeps the
reference's rule: the certified route where ``f32_certified`` asks for it
(:meth:`SearchEngine._f32_cert_wins`), else rescore for shards of at least
2^19 rows whose rescore traffic undercuts the dense route's, dense below.
Where K1/K2 cannot take the geometry, the route is dense before dispatch,
and :meth:`SearchEngine.kernel_name` reports the route that runs.

Shards (``ops/engine.py:727-810`` of the reference). A store sharded over a
mesh (:mod:`..store.device_store`) runs the resolved route on each local
shard with that shard's valid rows, adds the shard's base to its real ids
(``INT32_MAX`` sentinels stay sentinels) and emits one fixed ``[Q, k]``
block per shard. The blocks of every rank come together in shard order (an
``all_gather`` across processes) and merge by (value desc, id asc) with
:func:`..topk.topk_exact` — never ``torch.topk`` on raw values, whose tie
order on the card is unspecified — after each block is cut to the shard's
``min(k, valid rows)`` real candidates, so no padding ever competes. One
shard skips the merge. The route is resolved once, on ``per_device_rows``
(the reference's rule), and ``_store_finite`` is store-wide, so every shard
runs the same route. Every rank returns the merged answer.

Results: ids are int64 (the reference packed them into f32 for its relay;
nothing here needs that), distances ``1 - clamp(sim, -1, 1)``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SearchConfig
from ..parallel.mesh import gather_ranks
from ..store.device_store import DeviceStore
from .distance import distances_from_sims, normalize_rows
from .quantize import cast_rows_to, cast_rows_to_host
from .topk import (
    global_topk,
    rescore_f32_certified,
    rescore_feasible,
    rescore_topk,
    serial_topk,
    topk_exact,
)
from .topk_kernels import (
    INT32_MAX,
    PAD_SIM,
    kernel_scoring_exact_for,
    matmul_blockmax,
)

#: Routes of the reference that the port does not have yet (ROADMAP.md).
_NOT_PORTED = {
    "scan": "the chunked-scan comparison route",
    "blockmax": "the chunked-scan comparison route",
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
        self._finite: Optional[bool] = None  # see _store_finite
        if store.multi_process:
            # a collective: taken here, where every rank builds its engine,
            # not at a first use that one rank may reach alone
            self._store_finite()

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
        ids [Q, k] int64)`` on the device; over every shard, merged."""
        store = self.store
        route = self._resolve_kernel(k_eff)
        if store.n_shards == 1:
            return self._run_shard(route, store.data, queries_cast, k_eff,
                                   store.num_rows)
        q = queries_cast.shape[0]
        if not q:
            return (torch.empty((0, k_eff), device=self.device),
                    torch.empty((0, k_eff), dtype=torch.int64,
                                device=self.device))
        vals, ids = [], []
        for _s, shard, base, valid in store.local():
            if valid:
                v, i = self._run_shard(route, shard,
                                       queries_cast.to(shard.device), k_eff,
                                       valid)
                i = torch.where(i < INT32_MAX, i + base, i)
            else:  # an empty shard: a block that is cut away in the merge
                v = torch.full((q, k_eff), PAD_SIM, device=shard.device)
                i = torch.full((q, k_eff), INT32_MAX, dtype=torch.int64,
                               device=shard.device)
            vals.append(v.to(self.device))
            ids.append(i.to(self.device))
        return self._merge_blocks(torch.stack(vals), torch.stack(ids), k_eff)

    def _run_shard(self, route: str, shard: torch.Tensor,
                   queries_cast: torch.Tensor, k_eff: int, valid: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``route`` on one shard tensor with ``valid`` rows: shard-local
        ids."""
        if route == "f32cert":
            return rescore_f32_certified(
                shard, queries_cast, k_eff, valid,
                q_tile=max(8, min(queries_cast.shape[0], 512)),
                dense_macro_rows=_SIMS_BUDGET // (256 * 4),
            )
        if route == "rescore":
            sub, block = self._rescore_geometry(k_eff)
            return rescore_topk(
                shard, queries_cast, k_eff, valid,
                q_tile=512, block=block, sub_block=sub,
                argmax_fast=self._argmax_enabled(),
                danger_units=self.config.danger_units,
                sup_w=self.config.rescore_sup_w,
            )
        q_tile = max(1, min(queries_cast.shape[0], 256))
        return global_topk(
            shard, queries_cast, k_eff, valid, q_tile,
            block=self.config.row_block,
            macro_rows=max(1024, _SIMS_BUDGET // (q_tile * 4)),
        )

    def _merge_blocks(self, vals: torch.Tensor, ids: torch.Tensor,
                      k_eff: int, exact_key: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Merge this rank's ``[L, Q, k]`` shard blocks with every other
        rank's (an ``all_gather`` across processes, then shard order): each
        block is cut to its shard's ``min(k, valid rows)`` real candidates,
        then one selection by (value desc, id asc) — :func:`topk_exact`, or
        with ``exact_key=False`` the oracle's stable sort of ``-(value +
        0.0)``, whose ties also fall to the lowest id because the
        candidates stand in id order."""
        store = self.store
        if store.multi_process:
            vals = gather_ranks(vals).flatten(0, 1)
            ids = gather_ranks(ids).flatten(0, 1)
        cuts = [min(k_eff, store.shard_valid(s)) for s in range(vals.shape[0])]
        cand_v = torch.cat([vals[s, :, :c] for s, c in enumerate(cuts)], dim=1)
        cand_i = torch.cat([ids[s, :, :c] for s, c in enumerate(cuts)], dim=1)
        if exact_key:
            top, pos = topk_exact(cand_v, k_eff, cand_i)
        else:
            pos = torch.sort(-(cand_v + 0.0), dim=1, stable=True
                             ).indices[:, :k_eff]
            top = torch.gather(cand_v, 1, pos)
        return top, torch.gather(cand_i, 1, pos)

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
        """The route the engine runs for this ``k`` (on every shard)."""
        return self._resolve_kernel(self._resolve_k(k))

    def shard_routes(self, k: Optional[int] = None) -> list[str]:
        """Per world shard, the route it runs for this ``k``, or
        ``"empty"`` for a shard without valid rows."""
        route = self.kernel_name(k)
        return [route if self.store.shard_valid(s) else "empty"
                for s in range(self.store.n_shards)]

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
        if not qc.shape[0]:
            return (np.empty((0, k_eff), np.int64),
                    np.empty((0, k_eff), np.float32))
        if self.store.n_shards == 1 and self.device.type != "cuda":
            n = self.store.num_rows
            sims, _ = matmul_blockmax(qc, self.store.data, n)
            return serial_topk(self.effective_store(), queries, k_eff,
                               sims=sims[:, :n].numpy())
        return self._oracle_sharded(qc, k_eff)

    def _oracle_sharded(self, qc: torch.Tensor, k_eff: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """The oracle on the card, and over a sharded store: per query
        tile, each shard's full score matrix from K3 and its stable sort
        give its top ``min(k, valid rows)``; several shards' blocks merge
        (across ranks too) by the same stable sort, in shard order — the
        one-shard oracle's order, NaN scores last included. One shard skips
        the merge."""
        store = self.store
        tile = max(1, min(_ORACLE_TILE, _ORACLE_SCORES // store.shard_rows))
        ids, vals = [], []
        for t0 in range(0, qc.shape[0], tile):
            qt = qc[t0:t0 + tile].contiguous()
            bv = torch.zeros((len(store.shards), qt.shape[0], k_eff),
                             device=self.device)
            bi = torch.zeros(bv.shape, dtype=torch.int64, device=self.device)
            for j, (_s, shard, base, valid) in enumerate(store.local()):
                cut = min(k_eff, valid)
                if not cut:
                    continue
                sims, _ = matmul_blockmax(qt.to(shard.device), shard, valid)
                order = torch.sort(-(sims[:, :valid] + 0.0), dim=1,
                                   stable=True).indices[:, :cut]
                bv[j, :, :cut] = torch.gather(sims, 1, order).to(self.device)
                bi[j, :, :cut] = (order + base).to(self.device)
            if store.n_shards == 1:
                v, i = bv[0], bi[0]
            else:
                v, i = self._merge_blocks(bv, bi, k_eff, exact_key=False)
            ids.append(i.cpu())
            vals.append(v.cpu())
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
        gather geometry — and off, whatever the mode, for a store that
        holds a NaN or an infinity (:meth:`_store_finite`): the fast path's
        masks and argmax rows assume ordered, finite scores, and a unit
        whose maximum is NaN names no argmax row (K1 emits ``sub``). Such a
        store answers as under ``"off"``. Exactness never depends on the
        choice."""
        mode = self.config.rescore_argmax
        if mode == "off":
            return False
        if (mode == "auto" and self.store.dtype == torch.int8
                and self.store.dim * 2 < 1024):
            return False
        return self._store_finite()

    def _store_finite(self) -> bool:
        """Whether every value of the store is finite (int8 always is): one
        pass over each local shard in row chunks, on its device, read to
        the host once and kept for the engine's life (stores are not
        written in place); across processes every rank's answer is
        gathered, so the decision is store-wide."""
        if self._finite is None:
            finite = True
            for shard in self.store.shards:
                if shard.dtype == torch.int8:
                    continue
                step = max(1, (1 << 26) // max(1, shard.shape[1]))
                flags = [torch.isfinite(shard[r:r + step]).all()
                         for r in range(0, shard.shape[0], step)]
                finite = finite and bool(torch.stack(flags).all())
            if self.store.multi_process and self.store.dtype != torch.int8:
                flag = torch.tensor([finite], device=self.device)
                finite = bool(gather_ranks(flag).all())
            self._finite = finite
        return self._finite

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
        and re-read (8 bytes per row), for shards of at least 2^19 rows —
        ``per_device_rows``, as the reference reads it."""
        rows = self.store.per_device_rows
        dim = self.store.dim
        itemsize = self.store.dtype.itemsize
        sub, _block = self._rescore_geometry(k_eff)
        units = (max(1, self.config.danger_units) if self._argmax_enabled()
                 else k_eff)
        traffic = 8 * rows // sub + 5 * units * sub * dim * itemsize // 2
        return (rows >= 1 << 19 and traffic < 8 * rows
                and kernel_scoring_exact_for(self.store.dtype))

    def _f32_cert_wins(self, k_eff: int) -> bool:
        """Whether ``"auto"`` takes the certified f32 route: the
        reference's rule (``ops/engine.py:431-465``). ``f32_certified="off"``
        or a store that is not f32 never does; nor does ``k_eff > 128``
        (the fixed 256-unit candidate budget); ``"on"`` does. Under
        ``"auto"`` the reference takes it only on a TPU, whose f32 dots the
        route was built around; this backend is not one, and K1/K2 already
        score f32 stores exactly on the rescore route."""
        mode = getattr(self.config, "f32_certified", "auto")
        if mode == "off" or self.store.dtype != torch.float32:
            return False
        if k_eff > 128:
            return False
        return mode == "on"

    def _resolve_kernel(self, k_eff: int) -> str:
        kernel = self.config.kernel
        if kernel in _NOT_PORTED:
            raise NotImplementedError(
                f"search kernel {kernel!r} ({_NOT_PORTED[kernel]}) is not "
                "ported; see ROADMAP.md"
            )
        if kernel == "auto":
            if self._f32_cert_wins(k_eff):
                return "f32cert"
            kernel = "rescore" if self._rescore_wins(k_eff) else "global"
        if kernel == "f32cert":
            return kernel  # the route raises on a store that is not f32
        if kernel == "rescore":
            sub, block = self._rescore_geometry(k_eff)
            feasible = rescore_feasible(self.store.shard_rows, k_eff, sub,
                                        block, self.config.rescore_sup_w)
            return "rescore" if feasible else "global"
        if kernel in ("global", "pallas"):
            return "global"
        raise ValueError(f"unknown search kernel {kernel!r}")
