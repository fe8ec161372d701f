"""Exact top-k selection around the scoring kernels.

Counterpart of ``better_search_rag_rust_tpu/ops/topk.py``: the serial NumPy
oracle, the running merge, the dense route (:func:`global_topk`, fused
scoring through K3) and the sims-free rescore route (:func:`rescore_topk`,
K1 + K2). Everything between the kernels is plain torch on the store's
device.

Ordering contract (the oracle's): candidates sort by descending similarity,
ties broken by the LOWEST row id. ``torch.topk`` promises no order among
equal values, so every selection here goes through :func:`topk_exact`,
which selects on a unique int64 key built from the value's order-preserving
int32 image and the row id. Padded candidates carry ``PAD_SIM`` and id
``INT32_MAX``.

Row ids are shard-local: the port serves one store on one device, so there
is no global base offset.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .topk_kernels import (
    BLOCK,
    INT32_MAX,
    PAD_SIM,
    TILE_ROWS,
    gather_rescore,
    m2_sort_key,
    matmul_blockmax,
    matmul_blockmax2_only,
)

Pair = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Serial oracle (NumPy)
# ---------------------------------------------------------------------------


def serial_topk(
    store: np.ndarray, queries: np.ndarray, k: int,
    sims: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact serial scan: ``(indices [Q, k'], distances [Q, k'])`` with
    ``k' = min(k, N)``, distances ascending, ties by lowest index — the
    reference's ``serial_topk`` (``ops/topk.py:72-110``). Zero rows sit at
    distance 1.0; ``sims`` optionally supplies precomputed ``[Q, N]``
    similarities, so the oracle selects independently over the scores the
    engine computes. Selection orders by the raw f32 similarity, not by the
    reported distance (``1 - sim`` can merge distinct sims)."""
    store = np.asarray(store, dtype=np.float32)
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    k_eff = min(k, store.shape[0])
    if sims is None:

        def _norm(x):
            norms = np.sqrt(np.sum(x * x, axis=-1, keepdims=True))
            return x / np.where(norms == 0.0, 1.0, norms)

        sims = _norm(queries) @ _norm(store).T
    sims = np.asarray(sims, dtype=np.float32)
    order = np.argsort(-sims, axis=1, kind="stable")[:, :k_eff]
    dist = 1.0 - np.clip(sims, -1.0, 1.0)
    return order.astype(np.int64), np.take_along_axis(dist, order, axis=1)


# ---------------------------------------------------------------------------
# Exact selection
# ---------------------------------------------------------------------------


def topk_exact(vals: torch.Tensor, k: int,
               ids: Optional[torch.Tensor] = None) -> Pair:
    """``(values, positions)`` of the top ``k`` of each row of ``vals [T,
    N]`` by (value desc, id asc), with ``ids`` the row ids of the
    candidates (default: their positions). The key ``m2_sort_key(v) * 2^32
    + (INT32_MAX - id)`` is unique per (value, id), so ``torch.topk``'s
    order is fully determined; -0.0 and +0.0 tie, as in the oracle."""
    t, n = vals.shape
    if ids is None:
        ids = torch.arange(n, device=vals.device).expand(t, n)
    key = (m2_sort_key(vals).to(torch.int64) * 2**32
           + (INT32_MAX - ids.to(torch.int64)))
    _, pos = torch.topk(key, k, dim=1, largest=True, sorted=True)
    return torch.gather(vals, 1, pos), pos


def merge_topk(carry_vals, carry_ids, new_vals, new_ids, k: int) -> Pair:
    """Merge ``[Q, M]`` candidates into a ``[Q, k]`` running top-k."""
    vals = torch.cat([carry_vals, new_vals], dim=1)
    ids = torch.cat([carry_ids, new_ids], dim=1)
    top, pos = topk_exact(vals, k, ids)
    return top, torch.gather(ids, 1, pos)


def _pad_candidates(vals, ids, k: int) -> Pair:
    """Pad candidate rows narrower than ``k`` with (PAD_SIM, INT32_MAX)."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, ids
    t = vals.shape[0]
    pv = torch.full((t, short), PAD_SIM, dtype=vals.dtype, device=vals.device)
    pi = torch.full((t, short), INT32_MAX, dtype=ids.dtype, device=ids.device)
    return torch.cat([vals, pv], dim=1), torch.cat([ids, pi], dim=1)


def _finalize(cand_vals, cand_ids, k: int) -> Pair:
    cand_vals, cand_ids = _pad_candidates(cand_vals, cand_ids, k)
    top, pos = topk_exact(cand_vals, k, cand_ids)
    return top, torch.gather(cand_ids, 1, pos)


def _unit_rows(uids: torch.Tensor, unit: int) -> torch.Tensor:
    """Row ids ``[T, U*unit]`` of ``unit``-row units ``uids [T, U]``."""
    t, u = uids.shape
    offs = torch.arange(unit, device=uids.device)
    return (uids[:, :, None] * unit + offs).reshape(t, u * unit)


def _query_tiles(queries: torch.Tensor, q_tile: int):
    for t0 in range(0, queries.shape[0], q_tile):
        yield queries[t0:t0 + q_tile]


# ---------------------------------------------------------------------------
# Dense route: fused scores + block maxima (K3)
# ---------------------------------------------------------------------------


def _dense_chunk_topk(chunk, q_block, k: int, base: int, valid: int,
                      block: int) -> Pair:
    """Exact top-k of ``q_block`` against one row chunk: K3 scores + block
    maxima, top ``min(k, nb)`` blocks, their scores, one final selection.
    Exact by the block-max containment argument (``ops/topk.py:134-155``
    of the reference)."""
    t = q_block.shape[0]
    nb = chunk.shape[0] // block
    kb = min(k, nb)
    sims, bm_t = matmul_blockmax(q_block, chunk, valid, block=block)
    _, bpos = topk_exact(bm_t.T, kb)
    bids = torch.sort(bpos, dim=1).values  # ascending: oracle tie order
    cand_vals = torch.gather(
        sims.view(t, nb, block), 1, bids[:, :, None].expand(t, kb, block)
    ).reshape(t, kb * block)
    local = _unit_rows(bids, block)
    cand_ids = torch.where(local < valid, local + base, INT32_MAX)
    return _finalize(cand_vals, cand_ids, k)


def global_topk(
    shard: torch.Tensor,
    queries_cast: torch.Tensor,
    k: int,
    num_rows: int,
    q_tile: int = 256,
    block: int = BLOCK,
    macro_rows: int = 4 * 1024 * 1024,
) -> Pair:
    """Exact top-k by dense two-stage block selection, the reference's
    ``global_topk`` (``ops/topk.py:316``). Each query tile scores the shard
    in macro chunks of at most ``macro_rows`` rows (bounding the f32 score
    buffer at ``q_tile * macro_rows * 4`` bytes) with a running merge.
    ``shard`` rows must be a multiple of :data:`TILE_ROWS`; rows at or past
    ``num_rows`` are padding. Returns ``(vals [Q, k] f32, ids [Q, k]
    int64)``."""
    rows = shard.shape[0]
    q_tile = max(1, min(q_tile, queries_cast.shape[0]))
    macro = max(TILE_ROWS, macro_rows - macro_rows % TILE_ROWS)
    macro -= macro % block
    out_v, out_i = [], []
    for q_block in _query_tiles(queries_cast, q_tile):
        vals = ids = None
        for off in range(0, min(rows, num_rows), macro):
            chunk = shard[off:off + macro]
            valid = min(chunk.shape[0], num_rows - off)
            v, i = _dense_chunk_topk(chunk, q_block, k, off, valid, block)
            vals, ids = (v, i) if vals is None else merge_topk(
                vals, ids, v, i, k)
        out_v.append(vals)
        out_i.append(ids)
    return torch.cat(out_v), torch.cat(out_i)


# ---------------------------------------------------------------------------
# Sims-free rescore route (K1 + K2)
# ---------------------------------------------------------------------------


def rescore_groups(rows: int, k: int, sub: int, block: int,
                   sup_w: int = 8) -> Tuple[int, int]:
    """``(n_groups, units per group)`` of the rescore route's selection:
    8-block superblocks for large stores, blocks for small ones (the
    reference's rule, ``ops/topk.py:717-720``)."""
    nb = rows // block
    spb = block // sub
    if nb >= 4 * sup_w * min(k, nb) and nb % sup_w == 0:
        return nb // sup_w, sup_w * spb
    return nb, spb


def rescore_feasible(rows: int, k: int, sub: int, block: int,
                     sup_w: int = 8) -> bool:
    """Whether K1/K2 take this geometry and the refine pool holds at least
    ``k`` units. Where it does not (tiny stores), the engine routes dense
    before dispatch; :func:`rescore_topk` itself never switches route."""
    if sub > TILE_ROWS or TILE_ROWS % sub or block % sub or rows % block:
        return False
    ng, gw = rescore_groups(rows, k, sub, block, sup_w)
    return min(k, ng) * gw >= k


def rescore_topk(
    shard: torch.Tensor,
    queries_cast: torch.Tensor,
    k: int,
    num_rows: int,
    q_tile: int = 512,
    block: int = BLOCK,
    sub_block: int = 64,
    argmax_fast: bool = False,
    danger_units: int = 4,
    sup_w: int = 8,
) -> Pair:
    """Exact top-k WITHOUT materializing the similarity matrix — the
    reference's ``rescore_topk`` (``ops/topk.py:471``):

    1. K1 streams the shard once per query tile and emits per-``sub``-row
       unit maxima, coarse maxima and (``argmax_fast``) each unit's packed
       (second max, argmax) key.
    2. Group selection: the top ``min(k, n_groups)`` groups by (max desc,
       idx asc), then their units refine to the top ``k`` units. By the
       containment argument every true top-k row lies in a selected unit.
    3. Full gather: K2 rescores all selected units' rows and one exact
       selection finishes. Argmax fast path: the selected units' argmax rows
       are candidates with their K1 maxima as scores; only "danger" units
       (packed key >= the k-th selected max's key: a second row of the unit
       may be top-k) are rescored by K2, up to ``danger_units`` per query,
       and one (value desc, id asc) selection over both finishes. A query
       tile with a query over capacity takes the full gather instead. The
       mix of K1 and K2 scores in one selection is exact because the two
       kernels score a pair bit for bit alike (see the CUDA source note).

    ``shard`` rows must be a multiple of ``block``; see
    :func:`rescore_feasible` for the geometry. Returns ``(vals [Q, k] f32,
    ids [Q, k] int64)``."""
    rows, _d = shard.shape
    sub = sub_block
    if not rescore_feasible(rows, k, sub, block, sup_w):
        raise ValueError(
            f"rescore geometry infeasible: rows {rows}, k {k}, sub {sub}, "
            f"block {block}; route dense"
        )
    ng, gw = rescore_groups(rows, k, sub, block, sup_w)
    kg = min(k, ng)
    pool = kg * gw
    gd = max(1, min(danger_units, k))
    ew = min(block, TILE_ROWS)
    upg = gw * sub // ew  # emitted coarse maxima per group
    valid = min(rows, num_rows)
    out_v, out_i = [], []
    for q_block in _query_tiles(queries_cast, q_tile):
        t = q_block.shape[0]
        outs = matmul_blockmax2_only(
            q_block, shard, valid, sub=sub, block=block, emit_block=True,
            emit_argmax=argmax_fast, emit_width=ew,
        )
        bms3 = outs[0].T.reshape(t, ng, gw)
        gmax = outs[-1].T.reshape(t, ng, upg).amax(dim=2)
        _, gids = topk_exact(gmax, kg)
        gids = torch.sort(gids, dim=1).values  # ascending: oracle tie order
        cand_bm = torch.gather(
            bms3, 1, gids[:, :, None].expand(t, kg, gw)).reshape(t, pool)
        vals, pos = topk_exact(cand_bm, k)
        uids = torch.gather(gids, 1, pos // gw) * gw + pos % gw

        result = None
        if argmax_fast:
            result = _argmax_fast(q_block, shard, outs[1], vals, uids, k, sub,
                                  gd, valid)
        if result is None:
            result = _full_gather(q_block, shard, uids, k, sub, valid)
        out_v.append(result[0])
        out_i.append(result[1])
    return torch.cat(out_v), torch.cat(out_i)


def _full_gather(q_block, shard, uids, k: int, sub: int, valid: int) -> Pair:
    """Rescore every selected unit's rows with K2 and select."""
    uids_s = torch.sort(uids, dim=1).values  # ascending: tie order
    cand = gather_rescore(q_block, shard, uids_s.to(torch.int32), unit=sub)
    rows = _unit_rows(uids_s, sub)
    ok = rows < valid
    return _finalize(torch.where(ok, cand, PAD_SIM),
                     torch.where(ok, rows, INT32_MAX), k)


def _argmax_fast(q_block, shard, key_t, vals, uids, k: int, sub: int,
                 gd: int, valid: int) -> Optional[Pair]:
    """The argmax fast path of :func:`rescore_topk`, or None when a query
    of the tile has more danger units than the capacity ``gd`` (the caller
    then takes the full gather). The packed key is conservative (>= the
    exact second-max key), so the danger test can only over-count."""
    key_sel = torch.gather(key_t.T, 1, uids)                  # [T, k]
    arg_sel = (key_sel & 0x7F).to(torch.int64)
    w_key = m2_sort_key(vals[:, k - 1:k])
    danger = (key_sel >= w_key).sum(dim=1)
    if bool((danger > gd).any()):  # one host read per query tile
        return None
    a_ids = torch.where(vals > PAD_SIM, uids * sub + arg_sel, INT32_MAX)
    # top-gd units by key: a count within capacity covers every danger unit
    _, dpos = torch.topk(key_sel, gd, dim=1)
    d_uids = torch.gather(uids, 1, dpos)
    d_args = torch.gather(arg_sel, 1, dpos)
    d_uids, perm = torch.sort(d_uids, dim=1)
    d_args = torch.gather(d_args, 1, perm)
    d_sims = gather_rescore(q_block, shard, d_uids.to(torch.int32), unit=sub)
    d_rows = _unit_rows(d_uids, sub)
    is_arg = (torch.arange(sub, device=uids.device)
              == d_args[:, :, None]).reshape(d_rows.shape)
    ok = (d_rows < valid) & ~is_arg  # argmax rows are already candidates
    c_vals = torch.cat([vals, torch.where(ok, d_sims, PAD_SIM)], dim=1)
    c_ids = torch.cat([a_ids, torch.where(ok, d_rows, INT32_MAX)], dim=1)
    return _finalize(c_vals, c_ids, k)
