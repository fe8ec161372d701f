"""Exact top-k selection around the scoring kernels.

Counterpart of ``better_search_rag_rust_tpu/ops/topk.py``: the serial NumPy
oracle, the running merge, the dense route (:func:`global_topk`, fused
scoring through K3), the sims-free rescore route (:func:`rescore_topk`,
K1 + K2) and the certified f32 route (:func:`rescore_f32_certified`, K1 +
K4 + K6, falling back to the dense route). Everything between the kernels
is plain torch on the store's device.

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

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .topk_kernels import (
    BLOCK,
    INT32_MAX,
    PAD_SIM,
    TILE_ROWS,
    block_scores,
    gather_rescore,
    gather_rows,
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


def _empty_result(queries: torch.Tensor, k: int) -> Pair:
    """The ``[0, k]`` answer to an empty query batch, in every route's
    dtypes (f32 scores, int64 ids)."""
    return (torch.empty((0, k), dtype=torch.float32, device=queries.device),
            torch.empty((0, k), dtype=torch.int64, device=queries.device))


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
    int64)``; an empty batch gives ``[0, k]``."""
    if not queries_cast.shape[0]:
        return _empty_result(queries_cast, k)
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
       kernels score a pair bit for bit alike, and alike the oracle's K3:
       one rule per dtype (see the CUDA source note) — on bf16 one
       tensor-core ``mma.sync`` per 16 features, added to the score in one
       k order, on f32 one FMA chain, on int8 an exact integer dot.

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
    if not queries_cast.shape[0]:
        return _empty_result(queries_cast, k)
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
    """The argmax fast path of :func:`rescore_topk`, or None when the
    caller must take the full gather instead: a query of the tile has more
    danger units than the capacity ``gd``, or a selected unit maximum or a
    danger score is not finite (a NaN or infinite query, or a NaN row: the
    fast path's masks and its argmax rows assume ordered, finite scores,
    and the full gather is what ``rescore_argmax="off"`` answers). Both
    tests are read to the host together, once per query tile. The packed
    key is conservative (>= the exact second-max key), so the danger test
    can only over-count."""
    key_sel = torch.gather(key_t.T, 1, uids)                  # [T, k]
    arg_sel = (key_sel & 0x7F).to(torch.int64)
    w_key = m2_sort_key(vals[:, k - 1:k])
    danger = (key_sel >= w_key).sum(dim=1)
    # top-gd units by key: a count within capacity covers every danger unit
    _, dpos = torch.topk(key_sel, gd, dim=1)
    d_uids = torch.gather(uids, 1, dpos)
    d_args = torch.gather(arg_sel, 1, dpos)
    d_uids, perm = torch.sort(d_uids, dim=1)
    d_args = torch.gather(d_args, 1, perm)
    d_sims = gather_rescore(q_block, shard, d_uids.to(torch.int32), unit=sub)
    full = ((danger > gd).any() | ~torch.isfinite(vals).all()
            | ~torch.isfinite(d_sims).all())
    if bool(full):  # one host read per query tile
        return None
    a_ids = torch.where(vals > PAD_SIM, uids * sub + arg_sel, INT32_MAX)
    d_rows = _unit_rows(d_uids, sub)
    is_arg = (torch.arange(sub, device=uids.device)
              == d_args[:, :, None]).reshape(d_rows.shape)
    ok = (d_rows < valid) & ~is_arg  # argmax rows are already candidates
    c_vals = torch.cat([vals, torch.where(ok, d_sims, PAD_SIM)], dim=1)
    c_ids = torch.cat([a_ids, torch.where(ok, d_rows, INT32_MAX)], dim=1)
    return _finalize(c_vals, c_ids, k)


# ---------------------------------------------------------------------------
# Certified f32 route (K1 + K4 + K6, dense fallback on K3)
# ---------------------------------------------------------------------------

#: Error bound of the selection pass for NORMALIZED operands, the
#: reference's constant (``ops/topk.py:906-912``): there the pass scored in
#: one bf16 product (|s^ - s| <= 2^-8 * 1.25). The port's K1 scores f32
#: exactly, so the certificate keeps this margin as slack it does not need;
#: it is kept so both packages certify the same tiles' worth of margin.
F32_CERT_EPS0 = float(2.0 ** -8 * 1.25)

#: Rows per selection unit of the certified route (the reference's ``sub``).
CERT_UNIT = 8

#: Query tiles of :func:`rescore_f32_certified` since the last
#: :func:`reset_cert_counts`: ``certified`` kept the fast answer, ``dense``
#: failed the certificate and was recomputed on the dense route.
cert_counts: Dict[str, int] = {"certified": 0, "dense": 0}


def reset_cert_counts() -> None:
    for name in cert_counts:
        cert_counts[name] = 0


def rescore_f32_certified(
    shard: torch.Tensor,
    queries_cast: torch.Tensor,
    k: int,
    num_rows: int,
    q_tile: int = 512,
    ks: int = 256,
    kg: int = 512,
    dense_macro_rows: int = 4 * 1024 * 1024,
) -> Pair:
    """Certified two-stage exact top-k for f32 stores — the reference's
    ``rescore_f32_certified`` (``ops/topk.py:915-1131``):

    1. Selection: K1 over the shard at 8-row units (no scores written)
       gives unit maxima and, at the emit width (:data:`TILE_ROWS`, so a
       group is 16 units), group maxima. The top ``kg`` groups, then the
       top ``ks`` units of their pool; ``gexcl``/``uexcl`` are the best
       EXCLUDED group and unit maxima.
    2. K4 copies the selected units' rows (unit ids ascending: the
       oracle's tie order) into one ``[T, ks*8, D]`` buffer, and K6 scores
       them with the oracle's own arithmetic (K6 stages and sums as K2, and K2,
       K1 and K3 share one FMA chain), so candidate scores are the
       oracle's bits. Rows past ``num_rows`` score ``PAD_SIM``, id
       ``INT32_MAX``; one exact (value desc, id asc) selection.
    3. The certificate: every row outside the candidates scores at most
       ``max(uexcl, gexcl)``, so a query whose k-th fast score exceeds
       ``thresh = max(uexcl, gexcl) + eps1`` (``eps1 = F32_CERT_EPS0 + D *
       2^-24``) has its exact top-k. A query tile is certified when all of
       its queries are. Flags stay on the device and are read ONCE per
       call; the failing tiles are recomputed together on the dense route
       (:func:`global_topk`, K3), the bits of the reference's dense branch.
       Exactness never depends on the bound being tight.

    :data:`cert_counts` counts certified and dense tiles. One tile's K4
    buffer lives at a time (``q_tile * ks * 8 * D * 4`` bytes). Returns
    ``(vals [Q, k] f32, ids [Q, k] int64)``."""
    rows, d = shard.shape
    if shard.dtype != torch.float32:
        raise ValueError(f"certified path is f32-only, got {shard.dtype}")
    ks = min(ks, rows // CERT_UNIT)
    if k > ks:
        raise ValueError(f"need k <= ks ({k} > {ks})")
    if not queries_cast.shape[0]:
        return _empty_result(queries_cast, k)
    valid = min(rows, num_rows)
    eps1 = F32_CERT_EPS0 + d * 2.0 ** -24
    q_tile = max(8, min(q_tile, queries_cast.shape[0]))
    tiles = list(_query_tiles(queries_cast, q_tile))
    vals, ids, flags = zip(*(_cert_tile(q_block, shard, k, valid, ks, kg,
                                        eps1) for q_block in tiles))
    vals, ids = list(vals), list(ids)
    certified = torch.stack(flags).cpu().tolist()  # the one host read
    failing = [i for i, ok in enumerate(certified) if not ok]
    cert_counts["certified"] += len(tiles) - len(failing)
    cert_counts["dense"] += len(failing)
    if failing:
        dv, di = global_topk(
            shard, torch.cat([tiles[i] for i in failing]), k, num_rows,
            macro_rows=dense_macro_rows)
        at = 0
        for i in failing:
            n = tiles[i].shape[0]
            vals[i], ids[i] = dv[at:at + n], di[at:at + n]
            at += n
    return torch.cat(vals), torch.cat(ids)


def _cert_tile(q_block, shard, k: int, valid: int, ks: int, kg: int,
               eps1: float):
    """One query tile of :func:`rescore_f32_certified`: ``(fast vals, fast
    ids, certified)`` with ``certified`` a 0-d bool tensor on the device."""
    sub = CERT_UNIT
    t = q_block.shape[0]
    rows = shard.shape[0]
    gw = TILE_ROWS // sub
    bm_sub, bm = matmul_blockmax2_only(
        q_block, shard, valid, sub=sub, block=TILE_ROWS, emit_block=True,
        emit_argmax=False, emit_width=TILE_ROWS)
    ng = rows // TILE_ROWS
    kg_t = min(kg, ng - 1)
    gvals, gids = topk_exact(bm.T, kg_t + 1)
    gexcl = gvals[:, kg_t]                       # best EXCLUDED group
    gids = torch.sort(gids[:, :kg_t], dim=1).values
    pool = torch.gather(bm_sub.T.reshape(t, ng, gw), 1,
                        gids[:, :, None].expand(t, kg_t, gw)
                        ).reshape(t, kg_t * gw)
    ks_t = min(ks, pool.shape[1] - 1)
    if ks_t < k:
        raise ValueError(
            f"certified pool too small: ks_t={ks_t} < k={k} (pool "
            f"{pool.shape[1]}) — store too small for this path")
    vals, pos = topk_exact(pool, ks_t + 1)
    uexcl = vals[:, ks_t]                        # best EXCLUDED pool unit
    g_of = torch.gather(gids, 1, pos[:, :ks_t] // gw)
    uids = torch.sort(g_of * gw + pos[:, :ks_t] % gw, dim=1).values
    sims = block_scores(q_block, gather_rows(shard, uids.to(torch.int32),
                                             unit=sub))
    rid = _unit_rows(uids, sub)
    ok = rid < valid
    fast_vals, fast_ids = _finalize(torch.where(ok, sims, PAD_SIM),
                                    torch.where(ok, rid, INT32_MAX), k)
    thresh = torch.maximum(uexcl, gexcl) + eps1
    return fast_vals, fast_ids, (fast_vals[:, k - 1] > thresh).all()
