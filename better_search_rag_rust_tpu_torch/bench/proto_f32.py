"""The certified f32 prototypes of the TPU measurement record on the card:
``gather_rows`` of ``scripts/proto_f32_rescore.py`` (P22, its
``pallas_call`` at :124) on K4 and ``gather_rescore_hi`` of
``scripts/proto_f32_rescore2.py`` (P23, :111) on K2's f32 body, each with the
whole measured function of its script, as functions of the scripts' names.

    python -m better_search_rag_rust_tpu_torch.bench.proto_f32
    python -m better_search_rag_rust_tpu_torch.bench.proto_f32 \\
        --device cpu --rows-divisor 64 --reps 1 --rounds 1   # plain, small

The scripts' design, "certified two-stage f32": a bounded-error selection
pass (K1 f32 at 8-row units, no scores written), the top groups of 32 units
and the top ``ks`` units of their pool, the selected units' rows rescored
with the oracle's arithmetic, and a certificate — the k-th exact score above
the best excluded unit's maximum plus ``EPS1`` — under which no unselected
row can reach the top ``k``. On the TPU the selection's Mosaic f32 dot was
one bf16 pass (error up to ``EPS1``) and the exact stage XLA's HIGHEST dot in
the "keep-row-r" arrangement (:func:`keep_row_r`), whose shape independence
stage Q1 asked. On the card every kernel scores with the one f32 FMA chain
of ``ops/csrc/topk_kernels.cu`` (K1, K2, K3, K6), so the oracle's arithmetic
is the chain: :func:`hi_dot` is K3's scores and :func:`keep_row_r` K6's,
Q2's error is 0 and P23's in-kernel dot needs no ``EPS2``.

* P22 :func:`gather_rows` is K4 (unit 8; ``cpg`` only grouped the TPU's
  DMAs): :func:`stage_q1`, :func:`stage_q2` and :func:`build_fast` (the
  whole pipeline, one ``[T, KS*8, D]`` row buffer per tile) around it;
* P23 :func:`gather_rescore_hi` is K2 on the f32 store (unit 8, cpg 16):
  :func:`select_units`, :func:`build_p2` (P22's gather and K6, by stage and
  KS) and :func:`build_p3` (K2, the top ``C2 + 1`` rows, K4 of their units,
  K6, a second certificate) around it, and the ``EPS2`` check
  (:func:`eps2_check`).

The scripts' module constants are the fields of :class:`Geometry`, whose
defaults are the scripts' values; every function takes one as ``geom``.
Arguments that only sized the TPU's DMAs (``cpg``) are checked as the
scripts' grids need them — ``T % 8``, ``KS % cpg``, and for P23 ``(cpg *
unit) % 128`` — and are otherwise unused. ``plain=True`` runs the plain
PyTorch versions.

:func:`main` builds one 1,015,808 x 768 f32 store from ``--seed`` as the
scripts build theirs (raw normal draws rounded to bf16, widened, normalized,
the rows past 1,000,000 zeroed; queries are the store rows at
``linspace(0, VALID - 1, Q)``) and runs both scripts' checks and cells on
it: Q1 (bitwise on the chain; the same three arms on ``torch.matmul``, cuBLAS
SGEMM with TF32 off, printed as a library line and not gated), Q2 (``err <=
EPS1``), the EPS2 check, each cell's ids against the oracle (K3's scores of
the first 64 queries, top ``K`` by value desc, id asc) — gated on the
certificate's soundness: every query whose certificate holds must have the
oracle's ids — and the cert rate; then the cells' times, best of ``--rounds``
rounds of ``--reps`` calls (CUDA events; the scripts' defaults 4 x 8 for P22,
3 x 8 for P23), the engine's own f32 search (``search_device``, its route
printed) beside P22's pipeline, and K4 at P22's geometry and K2 f32 at P23's
(KS 192 and 320) against their plain versions (bit for bit for K4, within
:data:`TOL` for K2, and K2 bit for bit K6 on K4's rows), with the bound —
the bytes of the distinct units selected, read once, and of the queries, ids
and output, over 3.35 TB/s, or K2's ``2 T KS 8 D`` operations over the fp32
SIMT peak (67 TFLOP/s; H100 SXM data sheet) — and the library call (an index
gather for K4; none for K2). ``--rows-divisor N`` cuts the store's rows and
the queries by ``N`` (keeping whole 1024-row blocks and 32-unit groups).
The last line is ``launches {...}``: every kernel launch of the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import sys

import numpy as np
import torch

from ..ops import topk_kernels as tk
from ..ops.topk import _finalize, _unit_rows, topk_exact
from .proto_blockmax import compare
from .proto_calib import _time_ms
from .proto_dma import gather_bound

TOL = 1e-5
#: Q1's prefix rows and strided subset (``scripts/proto_f32_rescore.py``).
PREFIX_ROWS, SUBSET_ROWS = 131_072, 1_536
#: Queries of the exactness checks against the oracle.
ORACLE_QUERIES = 64


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The scripts' module constants (``proto_f32_rescore.py:61-68``,
    ``proto_f32_rescore2.py:48-55``), with their values as defaults."""

    K: int = 100
    Q: int = 1024
    T: int = 512
    R: int = 1_015_808
    VALID: int = 1_000_000
    D: int = 768
    SUB: int = 8          #: rows per unit
    BLOCK: int = 1024     #: K1's block
    SUPW: int = 32        #: units per selection group
    KG: int = 256         #: groups selected per query (P22)
    KS: int = 192         #: units selected per query (P22)
    C2: int = 128         #: exact-stage rows per query (P23's P3)
    EPS1: float = float(np.float32(2.0 ** -8 * 1.25 + 768 * 2.0 ** -24))
    EPS2: float = float(np.float32(2e-4))


SCRIPTS = Geometry()


def _grid(t: int, ks: int, cpg: int) -> None:
    if t % 8:
        raise ValueError(f"T {t} must be a multiple of 8: the script's grid "
                         "(T/8, KS/cpg) would drop the ragged tail")
    if cpg <= 0 or ks % cpg:
        raise ValueError(f"KS {ks} must be a multiple of cpg {cpg}: the "
                         "script's grid (T/8, KS/cpg) would drop the ragged "
                         "tail")


# -- the oracle's contraction -------------------------------------------------


def hi_dot(a, b, *, plain=False):
    """``hi_dot`` (``scripts/proto_f32_rescore.py:73``), the oracle
    contraction ``[n, D] x [m, D] -> [n, m]`` f32: K3's scores (``m`` a
    multiple of 128)."""
    fn = tk.matmul_blockmax_plain if plain else tk.matmul_blockmax
    return fn(a.contiguous(), b.contiguous(), b.shape[0])[0]


def keep_row_r(queries, rows, *, plain=False):
    """The scripts' keep-row-r stage (``group_fn``): each query of
    ``queries [T, D]`` against its own rows ``rows [T, C, D]`` -> ``[T, C]``
    f32: K6, bit for bit K3's scores of the same pairs on the card."""
    fn = tk.block_scores_plain if plain else tk.block_scores
    return fn(queries, rows)


# -- P22: scripts/proto_f32_rescore.py ---------------------------------------


def gather_rows(shard, ids, *, unit=8, cpg=8, interpret=False, plain=False):
    """P22, ``gather_rows`` (``scripts/proto_f32_rescore.py:100``): each
    query's ``KS`` selected ``unit``-row units, ``[T, KS*unit, D]`` in the
    store's dtype, bit for bit. K4; ``cpg`` and ``interpret`` are the
    TPU's."""
    del interpret
    _grid(ids.shape[0], ids.shape[1], cpg)
    if shard.shape[0] % unit:
        raise ValueError(f"rows {shard.shape[0]} must be a multiple of unit "
                         f"{unit}")
    fn = tk.gather_rows_plain if plain else tk.gather_rows
    return fn(shard, ids, unit=unit)


def stage_q1(shard, queries, *, plain=False) -> dict:
    """``stage_q1`` (:141): is the oracle's arithmetic shape-independent?
    The scores of the first 8 queries on the rows ``0, 85, 170, ...`` of the
    first :data:`PREFIX_ROWS` (1,536 of them): ``full`` (K3 over the prefix),
    ``subset`` (K3 over an index copy of those rows) and ``group8`` (K4 at
    unit 1, each query's own copy, then K6: the keep-row-r arrangement),
    ``ok`` when they agree bit for bit (on the CPU, within :data:`TOL`). The
    same three on ``torch.matmul`` are the ``library`` entry (not gated)."""
    rs = min(PREFIX_ROWS, shard.shape[0])
    stride = rs // SUBSET_ROWS
    sub_idx = torch.arange(0, stride * SUBSET_ROWS, stride,
                           device=shard.device)
    q8 = queries[:8].contiguous()
    rows = shard[sub_idx].contiguous()
    full = hi_dot(q8, shard[:rs], plain=plain)[:, sub_idx]
    subset = hi_dot(q8, rows, plain=plain)
    own = sub_idx.to(torch.int32).expand(8, -1).contiguous()
    group8 = keep_row_r(q8, gather_rows(shard, own, unit=1, cpg=1,
                                        plain=plain), plain=plain)
    lib_full = (q8 @ shard[:rs].T)[:, sub_idx]
    lib_subset = q8 @ rows.T
    c = SUBSET_ROWS
    lib_group8 = (q8 @ rows.repeat(8, 1).T).view(8, 8, c)[
        torch.arange(8), torch.arange(8)]

    def arms(a, b, g):
        return {"subset_bitwise": torch.equal(a, b),
                "subset_err": float((a - b).abs().max()),
                "group8_bitwise": torch.equal(a, g),
                "group8_err": float((a - g).abs().max())}

    out = arms(full, subset, group8)
    # bit for bit on the card (one chain); the CPU's plain versions (one
    # matrix product, one batched product) sum in their own orders
    out["ok"] = ((out["subset_bitwise"] and out["group8_bitwise"])
                 if shard.device.type == "cuda" else
                 max(out["subset_err"], out["group8_err"]) <= TOL)
    out["library"] = arms(lib_full, lib_subset, lib_group8)
    return out


def stage_q2(shard, queries, geom=SCRIPTS, *, plain=False) -> dict:
    """``stage_q2`` (:184): K1 f32 at ``SUB``-row units and ``BLOCK`` on the
    first 64 queries against the exact unit maxima of K3's scores over the
    first :data:`PREFIX_ROWS` rows (all valid): ``err <= EPS1`` (0 on the
    card, where K1 and K3 share one chain)."""
    q64 = queries[:ORACLE_QUERIES].contiguous()
    rs = min(PREFIX_ROWS, geom.VALID // 128 * 128)
    fn = tk.matmul_blockmax2_only_plain if plain else tk.matmul_blockmax2_only
    got = fn(q64, shard, geom.VALID, sub=geom.SUB, block=geom.BLOCK)
    got = got.T[:, :rs // geom.SUB]
    want = hi_dot(q64, shard[:rs], plain=plain)
    want = want.view(q64.shape[0], rs // geom.SUB, geom.SUB).amax(dim=2)
    err = float((got - want).abs().max())
    return {"err": err, "eps1": geom.EPS1, "zero": err == 0.0,
            "ok": err <= geom.EPS1}


def _two_key_top(sims, rid, ok, k):
    """The scripts' masked two-key sort, top ``k``: ``(vals, ids int32)`` by
    value desc, id asc; masked rows score ``PAD_SIM`` with id
    ``INT32_MAX``."""
    vals, ids = _finalize(torch.where(ok, sims, tk.PAD_SIM),
                          torch.where(ok, rid, tk.INT32_MAX), k)
    return vals, ids.to(torch.int32)


def _tiles(queries, geom, tile):
    """The scripts' ``lax.map`` over ``Q // T`` query tiles, in turn."""
    outs = [tile(queries[i:i + geom.T].contiguous())
            for i in range(0, geom.Q, geom.T)]
    return [torch.stack(col) for col in zip(*outs)]


def build_fast(geom=SCRIPTS, *, plain=False):
    """``build_fast`` (:218): ``run(queries [Q, D], sh) -> (vals [Q, K],
    ids [Q, K] int32, cert)``, ``cert`` one 0-d bool for the batch. Per
    tile: K1 f32, the top ``KG`` groups of ``SUPW`` units and the top ``KS``
    units of their pool, P22 (K4), K6, the mask of rows past ``VALID``, the
    two-key sort and the certificate ``vals[:, K-1] > bm^[:, KS-1] +
    EPS1``. One tile's row buffer lives at a time."""
    g = geom
    nunits = g.R // g.SUB
    nsup = nunits // g.SUPW
    k1 = tk.matmul_blockmax2_only_plain if plain else tk.matmul_blockmax2_only

    def tile(qq, sh):
        t = qq.shape[0]
        bm = k1(qq, sh, g.VALID, sub=g.SUB, block=g.BLOCK).T
        grouped = bm.reshape(t, nsup, g.SUPW)
        _, gids = topk_exact(grouped.amax(dim=2), g.KG)
        gids = torch.sort(gids, dim=1).values
        pool = torch.gather(grouped, 1, gids[:, :, None].expand(
            t, g.KG, g.SUPW)).reshape(t, g.KG * g.SUPW)
        vals, pos = topk_exact(pool, g.KS)
        g_of = torch.gather(gids, 1, pos // g.SUPW)
        uids = torch.sort(g_of * g.SUPW + pos % g.SUPW, dim=1).values
        rows = gather_rows(sh, uids.to(torch.int32), unit=g.SUB, plain=plain)
        sims = keep_row_r(qq, rows, plain=plain)
        del rows
        rid = _unit_rows(uids, g.SUB)
        top_vals, top_ids = _two_key_top(sims, rid, rid < g.VALID, g.K)
        cert = (top_vals[:, g.K - 1] > vals[:, g.KS - 1] + g.EPS1).all()
        return top_vals, top_ids, cert

    def run(queries, sh):
        vals, ids, certs = _tiles(queries, g, lambda qq: tile(qq, sh))
        return (vals.reshape(g.Q, g.K), ids.reshape(g.Q, g.K), certs.all())

    return run


# -- P23: scripts/proto_f32_rescore2.py --------------------------------------


def gather_rescore_hi(queries, shard, ids, *, unit=8, cpg=16,
                      interpret=False, plain=False):
    """P23, ``gather_rescore_hi`` (``scripts/proto_f32_rescore2.py:83``):
    ``[T, KS*unit]`` f32 scores of each query against its own ``KS`` units.
    K2 on the f32 store: the oracle's own chain (the TPU's in-kernel
    HIGHEST dot was not); ``cpg`` and ``interpret`` are the TPU's."""
    del interpret
    _grid(queries.shape[0], ids.shape[1], cpg)
    if (cpg * unit) % 128:
        raise ValueError(f"cpg * unit = {cpg * unit} must be a multiple of "
                         "128: the script's output block is 128 lanes wide")
    fn = tk.gather_rescore_plain if plain else tk.gather_rescore
    return fn(queries, shard, ids, unit=unit)


def select_units(qq, sh, ks, geom=SCRIPTS, *, plain=False):
    """``select_units`` (:126): K1 f32 and the two-level selection ->
    ``(vals [T, ks+1] bm^, uids [T, ks] int32 ascending)``; ``kg =
    min(max(256, 3 ks / 2), groups)``, and ``vals[:, ks]`` is the first
    excluded unit's maximum, for the certificate."""
    g = geom
    t = qq.shape[0]
    nsup = g.R // g.SUB // g.SUPW
    k1 = tk.matmul_blockmax2_only_plain if plain else tk.matmul_blockmax2_only
    bm = k1(qq, sh, g.VALID, sub=g.SUB, block=g.BLOCK).T
    grouped = bm.reshape(t, nsup, g.SUPW)
    kg = min(max(256, (ks * 3) // 2), nsup)
    _, gids = topk_exact(grouped.amax(dim=2), kg)
    gids = torch.sort(gids, dim=1).values
    pool = torch.gather(grouped, 1, gids[:, :, None].expand(t, kg, g.SUPW)
                        ).reshape(t, kg * g.SUPW)
    vals, pos = topk_exact(pool, ks + 1)
    g_of = torch.gather(gids, 1, pos[:, :ks] // g.SUPW)
    uids = torch.sort(g_of * g.SUPW + pos[:, :ks] % g.SUPW, dim=1).values
    return vals, uids.to(torch.int32)


def build_p2(ks, stage="full", geom=SCRIPTS, *, plain=False):
    """``build_p2`` (:156): ``run(queries, sh)``; ``stage`` ``"sel"``
    (``(uids,)``), ``"grows"`` (``(rows[:, :1, :8],)``), ``"dot"``
    (``(sims[:, :8],)``), each stacked over the tiles, or ``"full"``: ``(vals
    [Q, K], ids [Q, K] int32, certs [Q] bool)`` — :func:`select_units`,
    P22's gather (K4), K6, the mask, the two-key sort and the per-query
    certificate ``vals[:, K-1] > bm^[:, ks] + EPS1``."""
    if stage not in ("sel", "grows", "dot", "full"):
        raise ValueError(f"unknown stage {stage!r}")
    g = geom

    def tile(qq, sh):
        vals, uids = select_units(qq, sh, ks, g, plain=plain)
        if stage == "sel":
            return (uids,)
        rows = gather_rows(sh, uids, unit=g.SUB, cpg=8, plain=plain)
        if stage == "grows":
            return (rows[:, :1, :8].contiguous(),)
        sims = keep_row_r(qq, rows, plain=plain)
        del rows
        if stage == "dot":
            return (sims[:, :8].contiguous(),)
        rid = _unit_rows(uids, g.SUB)
        top_vals, top_ids = _two_key_top(sims, rid, rid < g.VALID, g.K)
        return top_vals, top_ids, top_vals[:, g.K - 1] > vals[:, ks] + g.EPS1

    def run(queries, sh):
        out = _tiles(queries, g, lambda qq: tile(qq, sh))
        if stage == "full":
            v, i, c = out
            return v.reshape(g.Q, g.K), i.reshape(g.Q, g.K), c.reshape(g.Q)
        return tuple(out)

    return run


def build_p3(ks, geom=SCRIPTS, *, plain=False):
    """``build_p3`` (:207): ``run(queries, sh) -> (vals [Q, K], ids [Q, K]
    int32, certs [Q] bool)`` — :func:`select_units`, P23 (K2 f32), the top
    ``C2 + 1`` rows, K4 of the ``C2`` rows' units (sorted, duplicates
    included), K6, the mask of duplicate units and rows past ``VALID``, the
    two-key sort and ``cert1 & cert2``: ``vals[:, K-1]`` above ``bm^[:, ks]
    + EPS1`` and above the ``C2 + 1``-th K2 score ``+ EPS2``."""
    g = geom

    def tile(qq, sh):
        t = qq.shape[0]
        vals, uids = select_units(qq, sh, ks, g, plain=plain)
        s2 = gather_rescore_hi(qq, sh, uids, unit=g.SUB, cpg=16, plain=plain)
        rid = _unit_rows(uids, g.SUB)
        s2 = torch.where(rid < g.VALID, s2, tk.PAD_SIM)
        s2v, p2 = topk_exact(s2, g.C2 + 1)
        usel = torch.gather(rid, 1, p2[:, :g.C2]) // g.SUB
        usort = torch.sort(usel, dim=1).values.to(torch.int32)
        rows = gather_rows(sh, usort, unit=g.SUB, cpg=8, plain=plain)
        sims = keep_row_r(qq, rows, plain=plain)
        del rows
        rid2 = _unit_rows(usort, g.SUB)
        dup = torch.cat([torch.zeros((t, 1), dtype=torch.bool,
                                     device=qq.device),
                         usort[:, 1:] == usort[:, :-1]], dim=1)
        dup = dup.repeat_interleave(g.SUB, dim=1)
        top_vals, top_ids = _two_key_top(sims, rid2,
                                         (rid2 < g.VALID) & ~dup, g.K)
        cert1 = top_vals[:, g.K - 1] > vals[:, ks] + g.EPS1
        cert2 = top_vals[:, g.K - 1] > s2v[:, g.C2] + g.EPS2
        return top_vals, top_ids, cert1 & cert2

    def run(queries, sh):
        v, i, c = _tiles(queries, g, lambda qq: tile(qq, sh))
        return v.reshape(g.Q, g.K), i.reshape(g.Q, g.K), c.reshape(g.Q)

    return run


def eps2_check(shard, queries, geom=SCRIPTS, *, plain=False) -> dict:
    """The EPS2 spot check (``proto_f32_rescore2.py:264``): P23 on the first
    8 queries and units 0-63 against K3's scores of the first ``64 * SUB``
    rows; ``err <= EPS2`` (0 on the card: one chain)."""
    uids = torch.arange(64, dtype=torch.int32, device=shard.device)
    uids = uids.expand(8, -1).contiguous()
    q8 = queries[:8].contiguous()
    got = gather_rescore_hi(q8, shard, uids, unit=geom.SUB, cpg=16,
                            plain=plain)
    want = hi_dot(q8, shard[:64 * geom.SUB], plain=plain)
    err = float((got - want).abs().max())
    return {"err": err, "eps2": geom.EPS2, "zero": err == 0.0,
            "ok": err <= geom.EPS2}


def oracle(queries, shard, geom=SCRIPTS, *, plain=False):
    """The scripts' serial oracle: K3's scores over the whole store, rows
    past ``VALID`` at ``PAD_SIM``, top ``K`` by value desc, id asc."""
    sims = hi_dot(queries, shard, plain=plain)
    sims[:, geom.VALID:] = tk.PAD_SIM
    vals, ids = topk_exact(sims, geom.K)
    return vals, ids.to(torch.int32)


# -- the measurement ---------------------------------------------------------


def make_store(geom, seed, device):
    """``(shard [R, D] f32, queries [Q, D])`` as the scripts build them:
    raw normal draws rounded to bf16 and widened, normalized, the rows past
    ``VALID`` zeroed; queries the rows at ``linspace(0, VALID - 1, Q)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shard = torch.empty((geom.R, geom.D), dtype=torch.float32, device=device)
    step = 1 << 17
    for r0 in range(0, geom.R, step):
        x = torch.randn((min(step, geom.R - r0), geom.D), generator=gen,
                        device=device).bfloat16().float()
        shard[r0:r0 + x.shape[0]] = x / torch.linalg.norm(x, dim=1,
                                                          keepdim=True)
    shard[geom.VALID:] = 0
    sel = torch.linspace(0, geom.VALID - 1, geom.Q, device=device).long()
    return shard, shard[sel].contiguous()


def cut_geometry(rows_divisor: int) -> Geometry:
    """The scripts' geometry with the store's rows (whole 1024-row blocks,
    at least 65,536: 256 groups, so that ``KG`` stays at least ``KS``, which
    the certificate needs) and the queries (a multiple of 8, two tiles) cut
    by ``rows_divisor``."""
    g = SCRIPTS
    if rows_divisor == 1:
        return g
    rows = max(1 << 16, g.R // rows_divisor // g.BLOCK * g.BLOCK)
    t = max(8, g.T // rows_divisor // 8 * 8)
    return dataclasses.replace(
        g, R=rows, VALID=rows - (g.R - g.VALID) // rows_divisor, T=t, Q=2 * t,
        KG=min(g.KG, rows // g.SUB // g.SUPW))


def certified_exact(ids, certs, o_ids) -> dict:
    """A cell's first :data:`ORACLE_QUERIES` answers against the oracle's:
    ``ids_eq`` (all equal), ``cert_rate`` and ``sound`` (every query whose
    certificate holds has the oracle's ids)."""
    n = o_ids.shape[0]
    same = (ids[:n] == o_ids).all(dim=1)
    certs = certs.reshape(-1).expand(ids.shape[0])[:n]
    return {"ids_eq": bool(same.all()), "cert_rate": float(
                certs.float().mean()),
            "sound": bool((same | ~certs).all()),
            "certified_differ": int((certs & ~same).sum())}


def cells(geom, *, plain=False):
    """Both scripts' timed cells, in their order: ``[(name, run)]``."""
    out = [("fast", build_fast(geom, plain=plain))]
    out += [(f"p2_192_{st}", build_p2(192, st, geom, plain=plain))
            for st in ("sel", "grows", "dot", "full")]
    out += [(f"p2_{ks}", build_p2(ks, "full", geom, plain=plain))
            for ks in (256, 320)]
    out += [(f"p3_{ks}", build_p3(ks, geom, plain=plain)) for ks in (192, 320)]
    return out


def run_checks(shard, queries, geom, device, lines) -> dict:
    """Q1, Q2, the EPS2 check and every full cell against the oracle;
    ``{check: result}``, each with ``ok``."""
    checks = {"q1": stage_q1(shard, queries), "q2": stage_q2(shard, queries,
                                                             geom),
              "eps2": eps2_check(shard, queries, geom)}
    q1, q2, e2 = checks["q1"], checks["q2"], checks["eps2"]
    lib = q1["library"]
    lines.append(f"Q1 chain subset bitwise={q1['subset_bitwise']} max|d|="
                 f"{q1['subset_err']:.3e}  group8 bitwise="
                 f"{q1['group8_bitwise']} max|d|={q1['group8_err']:.3e}; "
                 f"library (torch.matmul, not gated): subset bitwise="
                 f"{lib['subset_bitwise']} max|d|={lib['subset_err']:.3e} "
                 f"group8 bitwise={lib['group8_bitwise']} max|d|="
                 f"{lib['group8_err']:.3e}")
    lines.append(f"Q2 K1 f32 bm err max={q2['err']:.3e} (EPS1="
                 f"{q2['eps1']:.3e}) sound={q2['ok']} zero={q2['zero']}")
    lines.append(f"EPS2 measured {e2['err']:.3e} (bound {e2['eps2']:.1e}) "
                 f"sound={e2['ok']} zero={e2['zero']}")
    o_vals, o_ids = oracle(queries[:ORACLE_QUERIES], shard, geom)
    for name, fn in cells(geom):
        if name.startswith("p2_192_") and not name.endswith("full"):
            continue
        vals, ids, certs = fn(queries, shard)
        res = certified_exact(ids, certs, o_ids)
        n = o_ids.shape[0]
        res["vals_bitwise"] = torch.equal(vals[:n], o_vals)
        res["ok"] = res["sound"]
        checks[name] = res
        lines.append(f"{name}: ids==oracle[{n}q]={res['ids_eq']} vals "
                     f"bitwise={res['vals_bitwise']} cert_rate="
                     f"{res['cert_rate']:.3f}; certified queries equal to "
                     f"the oracle: {res['sound']}")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return checks


def _mean_ms(fn, reps, device) -> float:
    """Mean ms of ``reps`` calls, one round (the scripts' inner loop)."""
    from .suite import _device_seconds

    def run():
        for _ in range(reps):
            fn()

    return 1e3 * _device_seconds(device, run) / reps


def time_cells(queries, shard, geom, device, args, lines) -> dict:
    """The scripts' timing: best of ``rounds`` rounds of ``reps`` calls per
    cell, the P22 cells (the engine's ``dense`` f32 search and ``fast``)
    apart from the P23 cells; ``{cell: ms}``."""
    from ..config import SearchConfig
    from ..ops.engine import SearchEngine
    from ..store.device_store import DeviceStore

    host = shard[:geom.VALID].cpu().numpy()
    eng = SearchEngine(DeviceStore.from_host(host, "float32", device=device),
                       SearchConfig())
    del host
    qdev = eng.prepare_device_queries(queries.cpu().numpy())
    lines.append(f"engine f32 baseline: route {eng.kernel_name(geom.K)}")
    all_cells = cells(geom)
    dense = functools.partial(eng.search_device, qdev, geom.K)
    groups = [([("dense", dense),
                ("fast", functools.partial(all_cells[0][1], queries, shard))],
               args.rounds or 4),
              ([(n, functools.partial(f, queries, shard))
                for n, f in all_cells[1:]], args.rounds or 3)]
    best = {}
    for group, rounds in groups:
        for name, fn in group:
            best[name] = math.inf
            fn()
        for rnd in range(rounds):
            for name, fn in group:
                best[name] = min(best[name], _mean_ms(fn, args.reps, device))
            lines.append(f"round {rnd} " + " ".join(
                f"{n}={best[n]:.2f}ms" for n, _ in group))
    for name, ms in best.items():
        lines.append(f"{name}: {ms:.2f} ms -> {geom.Q / (ms / 1e3):.0f} q/s")
    del eng
    return best


def measure_kernels(queries, shard, geom, device, args, lines) -> list:
    """K4 at P22's geometry (the first tile's ``KS`` selected units) and K2
    f32 at P23's (KS 192 and 320) against their plain versions, with the
    bound and the library call."""
    g = geom
    qq = queries[:g.T].contiguous()
    d = g.D
    out = []
    _, uids = select_units(qq, shard, g.KS, g)
    k4 = gather_rows(shard, uids, unit=g.SUB)
    k4_plain = gather_rows(shard, uids, unit=g.SUB, plain=True)
    same = torch.equal(k4.view(torch.int32), k4_plain.view(torch.int32))
    del k4_plain
    flat = shard.view(-1, g.SUB * d)
    rec = {"case": f"P22 gather_rows unit={g.SUB} cpg=8 KS={g.KS} (K4)",
           "ms": _time_ms(lambda: gather_rows(shard, uids, unit=g.SUB),
                          args.reps, device),
           "plain_ms": _time_ms(lambda: gather_rows(shard, uids, unit=g.SUB,
                                                    plain=True), 1, device),
           "library_ms": _time_ms(lambda: flat[uids.long()], args.reps,
                                  device),
           "max_abs_err": 0.0 if same else math.inf, "ok": same}
    rec["bound_ms"], rec["bound_by"] = gather_bound(uids, g.SUB * d * 4, k4,
                                                    dtype=torch.float32)
    out.append(rec)
    del k4
    for ks in (192, 320):
        _, uids = select_units(qq, shard, ks, g)
        got = gather_rescore_hi(qq, shard, uids)
        plain = gather_rescore_hi(qq, shard, uids, plain=True)
        err, _ = compare(got, plain)
        k6 = keep_row_r(qq, gather_rows(shard, uids, unit=g.SUB))
        on_k6 = torch.equal(got, k6)
        del plain, k6
        cuda = device.type == "cuda"
        rec = {"case": f"P23 gather_rescore_hi unit={g.SUB} cpg=16 KS={ks} "
                       "(K2 f32)",
               "ms": _time_ms(lambda: gather_rescore_hi(qq, shard, uids),
                              args.reps, device),
               "plain_ms": _time_ms(lambda: gather_rescore_hi(
                   qq, shard, uids, plain=True), 1, device),
               "library_ms": None, "max_abs_err": err, "equals_k6": on_k6,
               "ok": err <= TOL and (on_k6 or not cuda)}
        rec["bound_ms"], rec["bound_by"] = gather_bound(
            uids, g.SUB * d * 4, qq, got, ops=2 * qq.shape[0] * ks * g.SUB * d,
            dtype=torch.float32)
        out.append(rec)
        del got
    for rec in out:
        lib = rec["library_ms"]
        lines.append(
            f"{rec['case']}: kernel {rec['ms']:.3f} ms, plain "
            f"{rec['plain_ms']:.3f} ms, library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}, bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}); max|kernel - "
            f"plain| {rec['max_abs_err']:.3g}"
            + (f"; bit for bit K6 on K4's rows: {rec['equals_k6']}"
               if "equals_k6" in rec else "")
            + f": {'ok' if rec['ok'] else 'FAILED'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows-divisor", type=int, default=1,
                    help="divide the store's rows and the queries by this "
                         "(small runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=8,
                    help="timed calls per round (the scripts' REPS)")
    ap.add_argument("--rounds", type=int, default=0,
                    help="rounds (default: the scripts' 4 for P22, 3 for "
                         "P23)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(f"device {torch.cuda.get_device_name(device)}", flush=True)
    geom = cut_geometry(args.rows_divisor)
    tk.reset_launch_counts()
    shard, queries = make_store(geom, args.seed, device)
    lines = [f"store {geom.R} x {geom.D} f32, {geom.VALID} valid; Q={geom.Q} "
             f"T={geom.T} K={geom.K}"]
    checks = run_checks(shard, queries, geom, device, lines)
    times = time_cells(queries, shard, geom, device, args, lines)
    kernels = measure_kernels(queries, shard, geom, device, args, lines)
    for line in lines:
        print(line, flush=True)
    print(json.dumps({"checks": checks, "cells_ms": times,
                      "kernels": kernels}), flush=True)
    print("launches " + json.dumps({k: v for k, v in tk.launch_counts.items()
                                    if v}), flush=True)
    ok = (all(c["ok"] for c in checks.values())
          and all(r["ok"] for r in kernels)
          and not any(math.isnan(ms) for ms in times.values()))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
