"""The fused two-level prototype of the TPU measurement record on the card:
``fused_scores`` of ``scripts/proto_fused.py`` (P17, its ``pallas_call`` at
:168) on K13, with the selection and the end-to-end pipeline of the script
around it, each as a function of the script's name and signature.

    python -m better_search_rag_rust_tpu_torch.bench.proto_fused
    python -m better_search_rag_rust_tpu_torch.bench.proto_fused \\
        --device cpu --rows-divisor 256          # plain versions, small

The script's pipeline on one query tile (:e2e, :300-312):

* ``bm2``: sub-block maxima ``[R/S, T]`` and 128-row block maxima ``[R/128,
  T]`` in one pass — P10, K1 at sub ``S``
  (:func:`.proto_blockmax.proto_fused_bm2`);
* :func:`select_subblocks`: the top ``k`` 128-row blocks (through the top
  1024-row super-blocks on large stores), then the top ``k`` S-row
  sub-blocks inside them, ascending;
* :func:`fused_scores`: each group of 8 queries against every sub-block its
  queries selected, ``[k/G, T, 8*G*S]`` — K13
  :func:`~..ops.topk_kernels.gather_cross`, each candidate row read once per
  group;
* :func:`extract_diag`: each query's own scores ``[T, k*S]``, bit for bit
  K2's at unit ``S`` on the card;
* :func:`e2e`: the whole pipeline, rows at or past ``valid_rows`` masked to
  ``PAD_SIM``, the top ``k`` by (value desc, position asc) — ``lax.top_k``'s
  rule; positions ascend with row ids, so it is the oracle's.

``T % 8`` and ``k % G`` must be 0 (K13 raises where the script's grid drops
a ragged tail). ``plain=True`` runs the plain PyTorch versions.

:func:`main` runs both of the script's configurations at its shapes —
``1m``: 1,000,448 valid rows of 1,001,472 x 768, S 16 and 32; ``10m``:
10,027,008 x 256, S 32 and 128; bf16, T 512, k 100 — on
:func:`.proto_blockmax.make_store`'s stores ``fused1m`` and ``10m``
(normalized random rows from ``--seed``; the script's were raw normal draws)
and random normal bf16 queries, as the script draws them. ``--rows-divisor
N`` cuts the stores' rows and the queries by ``N`` (to a multiple of 8), for
a run on the CPU. Per S it prints: ``select_subblocks``' time; per G, K13's
time (CUDA events, best of three rounds after a warm-up), GiB/s as the
script counts them (``T * k * S * D * 2`` bytes over that time), the bound —
the larger of the bytes it must move (the distinct sub-blocks selected, read
once, the queries, ids and the output) over 3.35 TB/s and its ``2 * 8 * T *
k * S * D`` operations over the bf16 tensor peak (989 TFLOP/s; H100 SXM data
sheet) — the plain version's time and max |kernel - plain| (bound
:data:`TOL`), whether the diagonal is K2's (bit for bit on the card, within
:data:`TOL` on the CPU, where the plain products sum in their own orders),
and K13 + :func:`extract_diag`'s time; then :func:`e2e`'s time and
queries/s, its values against K3's scores of the first 8 queries on the
first 8,192 rows (bit for bit on the card), and its exact-index match against
the oracle (K3's scores, top ``k`` by value desc, id asc) on a store of the
first 131,072 rows. The script's ``bm-only single-level`` and ``bm2
two-level`` lines are timed by :mod:`.proto_calib` and
:mod:`.proto_blockmax` and not again here. The last line is ``launches
{...}``: every kernel launch of the run, per kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..ops import topk_kernels as tk
from ..ops.topk import topk_exact
from . import proto_blockmax as pb
from . import proto_dma as pd
from .proto_calib import _time_ms

TOL = 1e-5
T, K = 512, 100
GS = (1, 2, 4)
#: config -> (``proto_blockmax`` store, sub-block widths S)
CONFIGS = {"1m": ("fused1m", (16, 32)), "10m": ("10m", (32, 128))}
#: Rows of the script's bitwise check and of its oracle's prefix store.
BITWISE_ROWS, ORACLE_ROWS = 8_192, 131_072
NQ = tk.CROSS_GROUP


# -- the prototype -----------------------------------------------------------


def fused_scores(queries_f32, shard, ids, S=16, G=1, *, plain=False):
    """``fused_scores`` (``scripts/proto_fused.py:139``): ``queries_f32 [T,
    D]`` (f32 storage of bf16 values), ``shard [R, D]`` bf16, ``ids [T, k]``
    int32 global sub-block ids -> the raw cross ``[k/G, T, 8*G*S]`` f32. K13
    on the queries cast to bf16 (exact)."""
    q = queries_f32.to(torch.bfloat16).contiguous()
    fn = tk.gather_cross_plain if plain else tk.gather_cross
    return fn(q, shard, ids, unit=S, G=G)


def extract_diag(cross, S=16, G=1):
    """``extract_diag`` (``scripts/proto_fused.py:182``): ``[k/G, T,
    8*G*S]`` cross -> ``[T, k*S]`` per-query candidate scores (each query's
    own sub-blocks): indexing, no arithmetic."""
    kg, t, _ = cross.shape
    c6 = cross.view(kg, t // NQ, NQ, G, NQ, S)
    diag = torch.diagonal(c6, dim1=2, dim2=4)  # [k/G, T/8, G, S, 8]
    return diag.permute(1, 4, 0, 2, 3).reshape(t, kg * G * S)


def select_subblocks(bms_t, bm_t, k, S=16, sup_w=8):
    """``select_subblocks`` (``scripts/proto_fused.py:197``): ``bms_t [NSB,
    T]``, ``bm_t [NB, T]`` -> sorted global sub-block ids ``[T, min(k, kb *
    128/S)]`` int32. Every top-k is :func:`~..ops.topk.topk_exact` (value
    desc, position asc: ``lax.top_k``'s rule)."""
    bms, bm = bms_t.T, bm_t.T
    t, nb = bm.shape
    kb = min(k, nb)
    if nb >= 4 * sup_w * kb and nb % sup_w == 0:
        nsup = nb // sup_w
        grouped = bm.reshape(t, nsup, sup_w)
        ks = min(kb, nsup)
        _, sup = topk_exact(grouped.amax(dim=2), ks)
        sup = torch.sort(sup, dim=1).values
        cand_bm = torch.gather(grouped, 1, sup[:, :, None].expand(t, ks, sup_w)
                               ).reshape(t, ks * sup_w)
        cand_bids = (sup[:, :, None] * sup_w
                     + torch.arange(sup_w, device=bm.device)).reshape(t, -1)
        _, pos = topk_exact(cand_bm, kb)
        bids = torch.gather(cand_bids, 1, pos)
    else:
        _, bids = topk_exact(bm, kb)
    bids = torch.sort(bids, dim=1).values  # [T, kb] 128-row blocks, ascending
    spb = 128 // S
    sub = torch.gather(bms.reshape(t, -1, spb), 1,
                       bids[:, :, None].expand(t, kb, spb))
    _, pos = topk_exact(sub.reshape(t, kb * spb), min(k, kb * spb))
    gsub = torch.gather(bids, 1, pos // spb) * spb + pos % spb
    return torch.sort(gsub, dim=1).values.to(torch.int32)


def e2e(queries_f32, data, valid_rows, *, k=K, S=16, plain=False):
    """``main``'s ``e2e`` and ``e2e_small`` (``scripts/proto_fused.py:300``,
    :345) with ``valid_rows`` as an argument: ``(vals [T, k] f32, ids [T,
    k] int32)`` through ``bm2`` (K1), :func:`select_subblocks`, K13 at the
    script's ``G`` (2 for even ``k``), :func:`extract_diag`, the mask of rows
    at or past ``valid_rows`` (``PAD_SIM``, id ``INT32_MAX``) and the top
    ``k``."""
    G = 2 if k % 2 == 0 else 1
    qq = queries_f32.to(torch.bfloat16).contiguous()
    bms, bm = pb.proto_fused_bm2(qq, data, valid_rows, S=S, plain=plain)
    ids = select_subblocks(bms, bm, k, S=S)
    cand = extract_diag(fused_scores(queries_f32, data, ids, S=S, G=G,
                                     plain=plain), S=S, G=G)
    rows = (ids.long()[:, :, None] * S
            + torch.arange(S, device=ids.device)).reshape(qq.shape[0], -1)
    ok = rows < valid_rows
    cand = torch.where(ok, cand, tk.PAD_SIM)
    cid = torch.where(ok, rows, tk.INT32_MAX)
    tv, tp = topk_exact(cand, k)
    return tv, torch.gather(cid, 1, tp).to(torch.int32)


# -- the measurement ---------------------------------------------------------


def bitwise_check(tv, ti, q, data, device) -> dict:
    """The script's check: each returned value of the first 8 queries whose
    row lies in the first :data:`BITWISE_ROWS` rows against K3's score of
    that pair — bit for bit on the card (one mma.sync k16 order per bf16
    score), within :data:`TOL` on the CPU."""
    head = min(BITWISE_ROWS, data.shape[0])
    direct, _ = tk.matmul_blockmax(q[:8].contiguous(), data[:head], head)
    rows = ti[:8].long()
    inside = rows < head
    want = torch.gather(direct, 1, rows.clamp(max=head - 1))
    err = float((tv[:8] - want).abs()[inside].max()) if inside.any() else 0.0
    return {"pairs": int(inside.sum()), "max_abs_err": err,
            "ok": err == 0.0 if device.type == "cuda" else err <= TOL}


def prefix_match(qf32, q, data, k, S) -> float:
    """The script's exact-index match of :func:`e2e` on the first
    :data:`ORACLE_ROWS` rows (all valid) against the oracle there: K3's
    scores, top ``k`` by value desc, id asc."""
    rows = min(ORACLE_ROWS, data.shape[0])
    dsm = data[:rows]
    _, ti = e2e(qf32, dsm, rows, k=k, S=S)
    sims, _ = tk.matmul_blockmax(q, dsm, rows)
    _, order = topk_exact(sims, k)
    return float((ti.long() == order).float().mean())


def run_config(name, args, gen, device, results, lines) -> None:
    """One configuration of the script (``1m`` or ``10m``) on its store."""
    store, s_list = CONFIGS[name]
    data, valid = pb.make_store(store, args.rows_divisor, args.seed, device)
    r, d = data.shape
    t = pd._cut(T, args.rows_divisor)
    q = torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)
    qf32 = q.float()
    lines.append(f"proto_fused {name}: R={valid} Rpad={r} D={d} T={t} k={K}; "
                 "bm-only single-level and bm2 two-level: timed by "
                 "bench/proto_calib.py and bench/proto_blockmax.py, not again "
                 "here")
    for S in s_list:
        bms, bm = pb.proto_fused_bm2(q, data, valid, S=S)
        sel_ms = _time_ms(lambda: select_subblocks(bms, bm, K, S=S), 2, device)
        ids = select_subblocks(bms, bm, K, S=S)
        del bms, bm
        lines.append(f"proto_fused {name} select_subblocks S={S}: "
                     f"{sel_ms:.3f} ms")
        k2 = tk.gather_rescore(q, data, ids, unit=S)
        for G in GS:
            if K % G:
                continue
            out = torch.empty((K // G, t, NQ * G * S), device="meta")
            res = pd.measure(
                "proto_fused", f"fused_scores {name} S={S} G={G} (K13)",
                lambda: fused_scores(qf32, data, ids, S=S, G=G),
                lambda: fused_scores(qf32, data, ids, S=S, G=G, plain=True),
                device, bound=pd.gather_bound(ids, S * d * 2, q, out,
                                              ops=2 * NQ * t * K * S * d),
                gathered=t * K * S * d * 2)
            diag = extract_diag(fused_scores(qf32, data, ids, S=S, G=G),
                                S=S, G=G)
            res["diag_k2_err"], _ = pb.compare(diag, k2)
            res["ok"] &= res["diag_k2_err"] <= (
                0.0 if device.type == "cuda" else TOL)
            del diag
            res["extract_ms"] = _time_ms(lambda: extract_diag(
                fused_scores(qf32, data, ids, S=S, G=G), S=S, G=G), 2, device)
            results.append(res)
        del k2
        e2e_ms = _time_ms(lambda: e2e(qf32, data, valid, S=S), 1, device)
        tv, ti = e2e(qf32, data, valid, S=S)
        check = bitwise_check(tv, ti, q, data, device)
        match = prefix_match(qf32, q, data, K, S)
        results.append({"script": "proto_fused", "case": f"E2E {name} S={S}",
                        "ms": e2e_ms, "qps": t / (e2e_ms / 1e3),
                        "bitwise": check, "prefix_match": match,
                        "ok": check["ok"] and match == 1.0})
        lines.append(
            f"proto_fused {name} E2E two-level fused S={S}: {e2e_ms:.3f} ms "
            f"-> {t / (e2e_ms / 1e3):,.0f} q/s per tile pipeline; values vs "
            f"K3's scores on the first {min(BITWISE_ROWS, r)} rows: "
            f"{'OK' if check['ok'] else 'BAD'} ({check['pairs']} pairs, "
            f"max|d| {check['max_abs_err']:.3g}); exact-index match vs the "
            f"oracle ({min(ORACLE_ROWS, r)} rows): {match}")


def result_line(res) -> str:
    if "fused_scores" not in res["case"]:
        return (f"{res['script']} {res['case']}: "
                f"{'ok' if res['ok'] else 'FAILED'}")
    return (pd.result_line(res) + f"; diagonal vs K2 at unit S "
            f"max|d| {res['diag_k2_err']:.3g}; K13 + extract_diag "
            f"{res['extract_ms']:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows-divisor", type=int, default=1,
                    help="divide every store's rows and the queries by this "
                         "(small runs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(f"device {torch.cuda.get_device_name(device)}", flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 1)
    tk.reset_launch_counts()
    results, lines = [], []
    for name in CONFIGS:
        run_config(name, args, gen, device, results, lines)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for res in results:
        print(result_line(res), flush=True)
    for line in lines:
        print(line, flush=True)
    print(json.dumps({"results": results}), flush=True)
    print("launches " + json.dumps({k: v for k, v in tk.launch_counts.items()
                                    if v}), flush=True)
    ok = all(r["ok"] and not math.isnan(r["ms"]) for r in results)
    return 0 if ok and results else 1


if __name__ == "__main__":
    sys.exit(main())
