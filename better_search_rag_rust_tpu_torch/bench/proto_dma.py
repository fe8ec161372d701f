"""The DMA gather-and-rescore prototypes of the TPU measurement record on
the card: the four ``pallas_call``s of ``scripts/proto_dma_rescore.py``,
``proto_dma2.py`` and ``proto_dma3.py`` (P18-P21), each as a function of
the script's name and signature on K2, K11 or K12.

    python -m better_search_rag_rust_tpu_torch.bench.proto_dma
    python -m better_search_rag_rust_tpu_torch.bench.proto_dma \\
        --device cpu --rows-divisor 1024        # plain versions, small

Each prototype takes ``ids [T, KS]`` int32, the units each query selected
(a unit is ``unit`` consecutive store rows), and gathers them:

* P18 ``gather_rescore128`` and P19 V1 (``make_v01("v1", ...)``): each
  query's scores against its own KS 128-row units, ``[T, KS*128]`` f32 —
  K2 :func:`~..ops.topk_kernels.gather_rescore` at unit 128;
* P19 V0 (``make_v01("v0", ...)``): the first 128 values of each unit's
  row 0 as f32, ``[T, KS*128]``, every unit moved whole — K11
  :func:`~..ops.topk_kernels.gather_copy`;
* P20 ``make_v3``: K2 at any unit (``cpg`` only grouped the TPU's DMAs);
* P21 ``make_fused``: P20's scores and, beside them in the same launch,
  one copy per TPU grid step ((T/8) * (KS/cpg) copies) of a resident
  product ``mmq . mms^T`` whose 128-column maxima go to ``mmo`` — K12
  :func:`~..ops.topk_kernels.gather_rescore_mm`.

The functions return the JAX function's outputs in its order, shapes and
dtypes; each ``make_*`` returns a ``run`` with the script's argument order
(``make_fused``'s also has ``run.outs``, both outputs of its
``pallas_call``: ``(mmo, scores)``). Arguments that only sized the TPU's
DMA grouping are checked as the script's grid needs them — ``T % 8 == 0``
and ``KS % cpg == 0``, where the script's grid silently drops a ragged
tail — and are otherwise unused. ``plain=True`` runs the plain PyTorch
versions.

:func:`main` runs every timed case of the three scripts at their own
shapes (``--rows-divisor N`` cuts every store's rows and every batch's
queries by ``N``, for a run on the CPU) and prints, per case: the kernel's
time (CUDA events, best of three rounds of ``iters`` calls after a
warm-up), the effective GiB/s as the scripts print it (the gathered bytes
``T * KS * unit * D * 2`` over that time), the bound — the larger of the
bytes it must move (the distinct selected units, read once, and the
queries, ids and outputs) over 3.35 TB/s and its operations over the bf16
tensor peak (989 TFLOP/s; H100 SXM data sheet) — the plain version's time
and max |kernel - plain| (bound :data:`TOL`; 0 for the copies). Beside
them, as the scripts have them: the exactness checks against the dense
scores of K3 on the first 131,072 (65,536) rows, the ``XLA take +
block_scores`` baseline (an index gather, then K6), K4
:func:`~..ops.topk_kernels.gather_rows` moving V0's units with a full
write, and for P21 the gather alone (K12 without the product), the
product alone (K5 on ``mmq``/``mms`` launched once per copy, and K12
without the gather) and their sum. On the card a V0 time below its bytes
bound fails the run: it would mean the copies were not made. Stores are
normalized random bf16 rows from ``--seed`` (the scripts' were raw normal
draws; neither version's time depends on the values), ids sorted random
draws, as in the scripts. The last line is ``launches {...}``: every
kernel launch of the run, per kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ..ops import topk_kernels as tk
from ..store.device_store import DeviceStore
from .proto_blockmax import compare
from .proto_calib import HBM_BYTES_PER_S, PEAK_OPS, _time_ms

TOL = 1e-5
#: store -> (rows, dim) of the scripts' stores, bf16.
STORES = {"10m": (10_027_008, 256), "1m": (1_048_576, 768)}
#: ``proto_dma2``'s 10M store holds one 128-row unit fewer than
#: ``proto_dma_rescore``'s: a view of its first rows.
DMA2_CUT = 128
#: Rows of the scripts' exactness checks, by unit.
EXACT_ROWS = {128: 131_072, 16: 65_536}
#: ``proto_dma3``'s resident product widths.
MM_NS = (0, 512, 1280)


# -- the prototypes ----------------------------------------------------------


def _groups(t: int, ks: int, cpg: int) -> None:
    if t % 8:
        raise ValueError(f"T {t} must be a multiple of 8: the script's grid "
                         "(T/8, ...) would drop the ragged tail")
    if cpg <= 0 or ks % cpg:
        raise ValueError(f"KS {ks} must be a multiple of cpg {cpg}: the "
                         "script's grid (T/8, KS/cpg) would drop the ragged "
                         "tail")


def _check_run(ids, queries, store, t, d, ks) -> None:
    if (tuple(ids.shape) != (t, ks) or tuple(queries.shape) != (t, d)
            or store.dim() != 2 or store.shape[1] != d):
        raise ValueError(
            f"run was made for ids [{t}, {ks}], queries [{t}, {d}] and a "
            f"store [R, {d}]; got {tuple(ids.shape)}, "
            f"{tuple(queries.shape)} and {tuple(store.shape)}")


def _k2(plain, queries, store, ids, unit):
    fn = tk.gather_rescore_plain if plain else tk.gather_rescore
    return fn(queries, store, ids, unit=unit)


def gather_rescore128(queries, store, ids, *, interpret=False, plain=False):
    """P18, ``gather_rescore128`` (``scripts/proto_dma_rescore.py:78``):
    ``scores [T, KS*128]`` f32 of each query against its own KS 128-row
    units. K2 at unit 128; ``interpret`` is the TPU's."""
    del interpret
    _groups(queries.shape[0], ids.shape[1], 1)
    return _k2(plain, queries, store, ids, 128)


def make_v01(kernel, t, d, k, unit=128, *, plain=False):
    """P19, ``make_v01`` (``scripts/proto_dma2.py:72``) with ``kernel``
    ``"v0"`` (``_v0_kernel``, copy only: K11) or ``"v1"`` (``_v1_kernel``,
    8 small dots: K2): ``run(ids, queries, store) -> [t, k*128]`` f32. V1
    needs unit 128 (it writes a unit's scores into a 128-wide block), V0
    rows of at least 128 values."""
    if kernel not in ("v0", "v1"):
        raise ValueError(f"kernel must be 'v0' (copy) or 'v1' (dots), got "
                         f"{kernel!r}")
    _groups(t, k, 1)
    if kernel == "v1" and unit != 128:
        raise ValueError(f"V1 writes a unit's scores into a 128-wide output "
                         f"block: unit must be 128, got {unit}")
    if kernel == "v0" and d < tk.V0_COLS:
        raise ValueError(f"V0 keeps {tk.V0_COLS} values of a row: dim {d} is "
                         "narrower")

    def run(ids, queries, store):
        _check_run(ids, queries, store, t, d, k)
        if kernel == "v1":
            return _k2(plain, queries, store, ids, 128)
        fn = tk.gather_copy_plain if plain else tk.gather_copy
        return fn(store, ids, unit=unit)

    return run


def make_v3(t, d, ks, unit, cpg, *, plain=False):
    """P20, ``make_v3`` (``scripts/proto_dma2.py:129``): ``run(ids,
    queries, store) -> [t, ks*unit]`` f32, each query's ``cpg`` units per
    TPU step concatenated into one dot: K2 at ``unit``."""
    _groups(t, ks, cpg)

    def run(ids, queries, store):
        _check_run(ids, queries, store, t, d, ks)
        return _k2(plain, queries, store, ids, unit)

    return run


def make_fused(t, d, ks, unit, cpg, mm_n, tq, *, plain=False):
    """P21, ``make_fused`` (``scripts/proto_dma3.py:80``): ``run(ids,
    queries, mmq [tq, d], mms [max(mm_n, 128), d], store) -> [t, ks*unit]``
    f32, P20's scores; ``run.outs`` returns ``(mmo [tq, max(mm_n, 128) /
    128], scores)``, ``mmo`` the 128-column maxima of ``mmq . mms^T``
    (NaN for ``mm_n`` 0, where the script never writes it). K12 with
    ``run.copies`` = (t/8) * (ks/cpg) copies of the product, one per TPU
    grid step, or none for ``mm_n`` 0."""
    _groups(t, ks, cpg)
    if mm_n < 0 or mm_n % 128:
        raise ValueError(f"mm_n {mm_n} must be a multiple of 128: the script "
                         "takes the product's maxima over 128-column groups")
    copies = (t // 8) * (ks // cpg) if mm_n else 0
    n = max(mm_n, 128)

    def outs(ids, queries, mmq, mms, store):
        _check_run(ids, queries, store, t, d, ks)
        if tuple(mmq.shape) != (tq, d) or tuple(mms.shape) != (n, d):
            raise ValueError(f"run was made for mmq [{tq}, {d}] and mms [{n}, "
                             f"{d}]; got {tuple(mmq.shape)} and "
                             f"{tuple(mms.shape)}")
        fn = tk.gather_rescore_mm_plain if plain else tk.gather_rescore_mm
        return fn(queries, store, ids, mmq, mms, unit=unit, copies=copies)

    def run(ids, queries, mmq, mms, store):
        return outs(ids, queries, mmq, mms, store)[1]

    run.outs = outs
    run.copies = copies
    return run


# -- the measurement ---------------------------------------------------------


def sorted_ids(rng: np.random.Generator, n_units: int, t: int, ks: int,
               device) -> torch.Tensor:
    """``[t, ks]`` int32 unit ids, sorted per query: the scripts' draws."""
    ids = np.sort(rng.integers(0, n_units, size=(t, ks), dtype=np.int32),
                  axis=1)
    return torch.from_numpy(ids).to(device)


def gather_bound(ids, unit_bytes, *tensors, ops=0, dtype=torch.bfloat16
                 ) -> tuple:
    """(ms, "bytes" | "operations"): the least time for work that reads the
    distinct units ``ids`` selects (``unit_bytes`` each) and ``ids`` once,
    reads or writes each of ``tensors`` once, and does ``ops`` operations:
    bytes over :data:`HBM_BYTES_PER_S`, operations over the operand
    ``dtype``'s peak (the bf16 tensor peak by default)."""
    moved = (int(torch.unique(ids).numel()) * unit_bytes
             + sum(x.numel() * x.element_size() for x in (ids, *tensors)))
    t_bytes = 1e3 * moved / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def measure(script, label, call, plain_call, device, *, bound, gathered,
            exact=False, iters=2) -> dict:
    """One case: ``call()`` (the kernel) against ``plain_call()``; ``bound``
    is ``gather_bound``'s pair for the outputs ``call`` returns,
    ``gathered`` the bytes the scripts' GiB/s counts, ``exact`` whether the
    outputs must agree bit for bit."""
    before = dict(tk.launch_counts)
    err, differ = compare(call(), plain_call())
    ms = _time_ms(call, iters, device)
    kernels = {k: v - before[k] for k, v in tk.launch_counts.items()
               if v != before[k]}
    plain_ms = _time_ms(plain_call, 1, device)
    b_ms, b_by = bound
    ok = err <= (0.0 if exact else TOL) and not differ
    return {"script": script, "case": label, "kernels": kernels, "ms": ms,
            "gib_s": gathered / 2**30 / (ms / 1e3), "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "exact": exact, "ok": ok}


def _dense_check(out, q, data, ids, unit, device) -> dict:
    """The scripts' exactness check: the scores of the first 8 queries on
    the units inside the first ``EXACT_ROWS[unit]`` rows against K3's dense
    scores there — bit for bit on the card (one mma.sync k16 order per bf16
    score), within :data:`TOL` on the CPU, where the plain products take
    their own orders."""
    head = min(EXACT_ROWS[unit], data.shape[0])
    dense, _ = tk.matmul_blockmax(q[:8].contiguous(), data[:head], head)
    ks = ids.shape[1]
    inside = (ids[:8].long() + 1) * unit <= head
    local = ids[:8].long().clamp(max=head // unit - 1)
    want = dense.view(8, head // unit, unit).gather(
        1, local[:, :, None].expand(8, ks, unit))
    got = out[:8].view(8, ks, unit)
    err = float((got - want).abs()[inside].max()) if inside.any() else 0.0
    cuda = device.type == "cuda"
    return {"pairs": int(inside.sum()) * unit, "max_abs_err": err,
            "ok": err == 0.0 if cuda else err <= TOL}


def _store(name, rows_divisor, seed, device) -> torch.Tensor:
    rows, dim = STORES[name]
    rows = max(2048, rows // rows_divisor // 1024 * 1024)
    return DeviceStore.synthetic(rows, dim, "bfloat16", seed,
                                 device=device).data[:rows]


def _queries(data, t, gen):
    rows = torch.randint(0, data.shape[0], (t,), generator=gen,
                         device=data.device)
    return data[rows].contiguous()


def _cut(t, rows_divisor):
    return max(8, t // rows_divisor // 8 * 8)


def _like(*shape, dtype=torch.float32):
    """A shape-only tensor, for :func:`gather_bound`'s byte count."""
    return torch.empty(shape, dtype=dtype, device="meta")


def run_dma_rescore(data, args, gen, device, results, lines) -> None:
    """``proto_dma_rescore.main`` (:123): P18 at T 256 and 512, KS 100, with
    its exactness check and its ``XLA take + block_scores`` baseline."""
    r, d = data.shape
    nb, k = r // 128, 100
    rng = np.random.default_rng(args.seed + 2)
    for t in (256, 512):
        t = _cut(t, args.rows_divisor)
        q = _queries(data, t, gen)
        ids = sorted_ids(rng, nb, t, k, device)
        gathered = t * k * 128 * d * 2
        bound = gather_bound(ids, 128 * d * 2, q, _like(t, k * 128),
                             ops=2 * t * k * 128 * d)
        res = measure("proto_dma_rescore",
                      f"fused DMA gather+rescore T={t} (K2)",
                      lambda: gather_rescore128(q, data, ids),
                      lambda: gather_rescore128(q, data, ids, plain=True),
                      device, bound=bound, gathered=gathered)
        out = gather_rescore128(q, data, ids)
        res["dense"] = _dense_check(out, q, data, ids, 128, device)
        res["ok"] &= res["dense"]["ok"]
        results.append(res)

        flat = data.view(nb, 128 * d)

        def take(fn):
            g = flat[ids.reshape(-1).long()].view(t, k * 128, d)
            return fn(q, g)

        base = measure("proto_dma_rescore",
                       f"XLA take + block_scores T={t} (index gather + K6)",
                       lambda: take(tk.block_scores),
                       lambda: take(tk.block_scores_plain), device,
                       bound=bound, gathered=gathered)
        # one scoring body on the card: K6 == K2 bit for bit; the plain
        # versions sum in other orders
        base["k2_diff"], _ = compare(take(tk.block_scores), out)
        base["ok"] &= base["k2_diff"] <= (0.0 if device.type == "cuda"
                                          else TOL)
        results.append(base)
        del out
        lines.append(f"proto_dma_rescore T={t}: bit for bit K3's dense scores "
                     f"on the first {min(EXACT_ROWS[128], r)} rows: "
                     f"{res['dense']['ok']} ({res['dense']['pairs']} pairs); "
                     f"max|index gather + K6 - K2| {base['k2_diff']:.3g}")


def run_dma2(data10, data1m, args, gen, device, results, lines) -> None:
    """``proto_dma2.main`` (:168): V0 (beside K4) and V1 at 10M x 256, V3
    at cpg 2 and 4, V16 at 1M x 768 at cpg 8 and 4, and its V16 exactness
    check."""
    rng = np.random.default_rng(args.seed + 2)
    data = data10[:data10.shape[0] - DMA2_CUT]
    r, d = data.shape
    t, k = _cut(512, args.rows_divisor), 100
    q = _queries(data, t, gen)
    ids = sorted_ids(rng, r // 128, t, k, device)
    gathered = t * k * 128 * d * 2
    unit_bytes = 128 * d * 2
    v0, v0_plain = make_v01("v0", t, d, k), make_v01("v0", t, d, k, plain=True)
    res = measure("proto_dma2", "V0 DMA-only (K11)",
                  lambda: v0(ids, q, data), lambda: v0_plain(ids, q, data),
                  device, bound=gather_bound(ids, unit_bytes,
                                             _like(t, k * 128)),
                  gathered=gathered, exact=True)
    res["at_or_above_bound"] = res["ms"] >= res["bound_ms"]
    res["ok"] &= res["at_or_above_bound"] or device.type != "cuda"
    k4 = tk.gather_rows(data, ids, unit=128).view(t, k, 128, d)
    res["equals_k4_row0"] = torch.equal(
        v0(ids, q, data).view(t, k, 128), k4[:, :, 0, :tk.V0_COLS].float())
    res["ok"] &= res["equals_k4_row0"]
    del k4
    results.append(res)
    results.append(measure(
        "proto_dma2", "K4 gather_rows unit=128 (V0's units, full write)",
        lambda: tk.gather_rows(data, ids, unit=128).view(torch.int16),
        lambda: tk.gather_rows_plain(data, ids, unit=128).view(torch.int16),
        device, bound=gather_bound(ids, unit_bytes,
                                   _like(t, k * 128, d, dtype=torch.bfloat16)),
        gathered=gathered, exact=True))
    score_bound = gather_bound(ids, unit_bytes, q, _like(t, k * 128),
                               ops=2 * t * k * 128 * d)
    runs = [("V1 8 small dots (K2)", make_v01("v1", t, d, k),
             make_v01("v1", t, d, k, plain=True))]
    runs += [(f"V3 concat cpg={cpg} (K2)", make_v3(t, d, k, 128, cpg),
              make_v3(t, d, k, 128, cpg, plain=True)) for cpg in (2, 4)]
    for label, fn, plain in runs:
        results.append(measure("proto_dma2", label,
                               lambda: fn(ids, q, data),
                               lambda: plain(ids, q, data), device,
                               bound=score_bound, gathered=gathered))

    r2, d2 = data1m.shape
    ks = 104
    q2 = _queries(data1m, t, gen)
    ids2 = sorted_ids(rng, r2 // 16, t, ks, device)
    gathered = t * ks * 16 * d2 * 2
    bound = gather_bound(ids2, 16 * d2 * 2, q2, _like(t, ks * 16),
                         ops=2 * t * ks * 16 * d2)
    for cpg in (8, 4):
        fn, plain = make_v3(t, d2, ks, 16, cpg), make_v3(t, d2, ks, 16, cpg,
                                                         plain=True)
        res = measure("proto_dma2", f"V16 concat cpg={cpg} (K2 unit 16)",
                      lambda: fn(ids2, q2, data1m),
                      lambda: plain(ids2, q2, data1m), device, bound=bound,
                      gathered=gathered)
        if cpg == 8:
            res["dense"] = _dense_check(fn(ids2, q2, data1m), q2, data1m,
                                        ids2, 16, device)
            res["ok"] &= res["dense"]["ok"]
            lines.append(f"proto_dma2 V16: bit for bit K3's dense scores on "
                         f"the first {min(EXACT_ROWS[16], r2)} rows: "
                         f"{res['dense']['ok']} ({res['dense']['pairs']} "
                         "pairs)")
        results.append(res)


def run_dma3(data, args, gen, device, results, lines) -> None:
    """``proto_dma3.main`` (:130): K12 at unit 16, cpg 8, KS 104, ``mm_n``
    0, 512 and 1280 (tq = T, ``mmq`` the queries, as the script has them),
    beside the gather alone, the product alone and their sum."""
    rng = np.random.default_rng(args.seed + 2)
    r, d = data.shape
    t, ks, unit, cpg = _cut(512, args.rows_divisor), 104, 16, 8
    q = _queries(data, t, gen)
    ids = sorted_ids(rng, r // unit, t, ks, device)
    gathered = t * ks * unit * d * 2
    gather_ms = None
    for mm_n in MM_NS:
        n = max(mm_n, 128)
        mms = torch.randn((n, d), generator=gen, device=device).bfloat16()
        fn = make_fused(t, d, ks, unit, cpg, mm_n, t)
        plain = make_fused(t, d, ks, unit, cpg, mm_n, t, plain=True)
        copies = fn.copies
        ops = 2 * t * ks * unit * d + copies * 2 * t * mm_n * d
        bound = gather_bound(ids, unit * d * 2, q, mms, _like(t, ks * unit),
                             _like(t, n // 128), ops=ops)
        res = measure("proto_dma3", f"gather + resident product mm_n={mm_n} "
                      f"({copies} copies; K12)",
                      lambda: fn.outs(ids, q, q, mms, data),
                      lambda: plain.outs(ids, q, q, mms, data), device,
                      bound=bound, gathered=gathered, iters=1)
        mmo, scores = fn.outs(ids, q, q, mms, data)
        res["scores_equal_k2"] = torch.equal(
            scores, tk.gather_rescore(q, data, ids, unit=unit))
        res["mmo_equals_k5"] = (not mm_n) or torch.equal(
            mmo, tk.matmul_blockmax_only(q, mms, n).T)
        res["ok"] &= res["scores_equal_k2"] and res["mmo_equals_k5"]
        del mmo, scores
        results.append(res)
        if not mm_n:
            gather_ms = res["ms"]
            continue
        k5_ms = _time_ms(lambda: [tk.matmul_blockmax_only(q, mms, n)
                                  for _ in range(copies)], 1, device)
        no_ids = ids[:, :0].contiguous()
        alone_ms = _time_ms(lambda: tk.gather_rescore_mm(
            q, data, no_ids, q, mms, unit=unit, copies=copies), 1, device)
        res["overlap"] = {"gather_ms": gather_ms, "k5_x_copies_ms": k5_ms,
                          "sum_ms": gather_ms + k5_ms,
                          "k12_product_alone_ms": alone_ms}
        lines.append(
            f"proto_dma3 mm_n={mm_n}: K12 {res['ms']:.3f} ms against gather "
            f"alone (K12, mm_n=0) {gather_ms:.3f} + product alone (K5 x "
            f"{copies} launches) {k5_ms:.3f} = {gather_ms + k5_ms:.3f} ms; "
            f"K12 without the gather {alone_ms:.3f} ms, so the gather adds "
            f"{res['ms'] - alone_ms:.3f} of its {gather_ms:.3f} ms alone; "
            f"scores bit for bit K2's: {res['scores_equal_k2']}, mmo bit for "
            f"bit K5's maxima transposed: {res['mmo_equals_k5']}")


def run_all(data10, data1m, args, gen, device) -> tuple:
    """The three scripts' cases on ``data10`` (10,027,008 x 256 bf16, or a
    cut of it) and ``data1m`` (1,048,576 x 768): ``(results, lines)``."""
    results, lines = [], []
    run_dma_rescore(data10, args, gen, device, results, lines)
    run_dma2(data10, data1m, args, gen, device, results, lines)
    run_dma3(data1m, args, gen, device, results, lines)
    return results, lines


def result_line(res) -> str:
    return (f"{res['script']} {res['case']} on {res['kernels']}: kernel "
            f"{res['ms']:.3f} ms ({res['gib_s']:.1f} GiB/s gathered), plain "
            f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
            f"({res['bound_by']}); max|kernel - plain| "
            f"{res['max_abs_err']:.3g} (bound {0.0 if res['exact'] else TOL})"
            f": {'ok' if res['ok'] else 'FAILED'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows-divisor", type=int, default=1,
                    help="divide every store's rows and every batch's "
                         "queries by this (small runs)")
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
    data10 = _store("10m", args.rows_divisor, args.seed, device)
    data1m = _store("1m", args.rows_divisor, args.seed + 3, device)
    results, lines = run_all(data10, data1m, args, gen, device)
    del data10, data1m
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
