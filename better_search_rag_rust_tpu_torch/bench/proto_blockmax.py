"""The block-max prototypes of the TPU measurement record on the card:
sixteen ``pallas_call``s of ``scripts/proto_*.py`` (P1-P16), each as a
function of the script's name and signature on K1, K3, K5 or K10.

    python -m better_search_rag_rust_tpu_torch.bench.proto_blockmax
    python -m better_search_rag_rust_tpu_torch.bench.proto_blockmax \\
        --device cpu --rows-divisor 1024        # plain versions, small stores

Each prototype scores a store tile ``shard [R, D]`` against ``queries [T,
D]``, masks rows at or past ``valid_rows`` to ``PAD_SIM`` and reduces the
scores to unit maxima and/or coarse maxima, some with extra outputs. The
functions below return the JAX function's outputs in its order, shapes and
dtypes. Arguments that only sized the TPU's tiles (``rt``, ``CH``) are
accepted and ignored. ``plain=True`` runs the kernel's plain PyTorch
version instead, with the same arguments.

:func:`main` runs every timed case of the ten scripts at the script's
shapes (:data:`CASES`) and prints, per case: the kernel's time (CUDA
events, best of three rounds of ``iters`` calls after a warm-up),
the plain version's, the bound — the larger of the bytes it must move
(queries and store read once, every output written once, the score matrix
of ``bm2_v3``/``bm2t_pass``/``mm_bmsub`` included) over 3.35 TB/s and its
``2 T R D`` operations over the dtype's tensor peak (989 TFLOP/s bf16,
1,979 TOP/s int8; H100 SXM data sheet) — the library product's time
(``torch.matmul``, ``torch._int_mm`` on int8; none where the product alone
would exceed :data:`LIBRARY_MAX_BYTES`), and max |kernel - plain| over the
float outputs (bound :data:`TOL`, 0 on int8) with the share of integer
outputs that differ (0 on int8; on bf16 an argmax may differ only on a
near tie, the two versions summing in different orders). Stores are
generated on the device from ``--seed``: normalized random rows (bf16, the
int8 lattice), raw int8 in [-127, 127] for ``proto_int8``. The scripts' own
timing (relay calibration, N-fits) is not carried over: CUDA events time
the device alone. The last line is ``launches {...}``: every kernel launch
of the run, per kernel.
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
from .proto_calib import _time_ms, bound

#: ``proto_int8.py``'s score scale: f32(1) / (f32(700) * f32(700)).
INV_SCALE2_700 = float(np.float32(1.0) / (np.float32(700.0) * np.float32(700.0)))
#: ``proto_argmax.py``'s unit and block widths.
ARGMAX_SUB, ARGMAX_BLOCK = 16, 128
#: ``proto_emit_var.py``'s geometry: 10,158,080 rows (10M valid) x 256
#: int8, 512 queries, 128-row units, 1024-row blocks, and the emit width
#: ``bm2_emit_width`` picks there (256).
EMIT_VAR_R, EMIT_VAR_VALID, EMIT_VAR_D, EMIT_VAR_Q = 10_158_080, 10_000_000, 256, 512
EMIT_VAR_SUB, EMIT_VAR_BLOCK, EMIT_VAR_EW = 128, 1024, 256

TOL = 1e-5
#: The library product is timed only where its output fits in this.
LIBRARY_MAX_BYTES = 8 << 30


def _k1(plain, *args, **kw):
    fn = tk.matmul_blockmax2_only_plain if plain else tk.matmul_blockmax2_only
    return fn(*args, **kw)


def _k10(plain, *args, **kw):
    fn = tk.matmul_blockmax2x_plain if plain else tk.matmul_blockmax2x
    return fn(*args, **kw)


def _two_level(plain, queries, shard, valid_rows, sub):
    """``(bms [R/sub, T], bm [R/128, T])`` on K1."""
    return _k1(plain, queries, shard, valid_rows, sub=sub, block=128,
               emit_block=True)


# -- P1-P4: scripts/proto_bm3.py ---------------------------------------------


def proto_bm3_bm2_v1(queries, shard, valid_rows, rt=1024, S=16, *,
                     plain=False):
    """``bm2_v1`` (``scripts/proto_bm3.py:72``, swapped dot): ``(bms [R/S,
    T], bm [R/128, T])``. K1 at sub ``S``, 128-row coarse maxima."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, S)


def proto_bm3_bm2_v2(queries, shard, valid_rows, rt=1024, S=16, *,
                     plain=False):
    """``bm2_v2`` (``scripts/proto_bm3.py:123``, scores through a VMEM
    scratch): ``bm2_v1``'s outputs. K1; the scratch is the TPU's."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, S)


def proto_bm3_bm2_v3(queries, shard, valid_rows, rt=1024, S=16, *,
                     plain=False):
    """``bm2_v3`` (``scripts/proto_bm3.py:176``): ``(sims [R, T], bms [R/S,
    T], bm [R/128, T])``, the masked scores written too. K10 with
    ``emit_sims``."""
    del rt
    return _k10(plain, queries, shard, valid_rows, sub=S, emit_sims=True,
                emit_width=128)


def proto_bm3_bm2_v4(queries, shard, valid_rows, rt=2048, S=16, CH=512, *,
                     plain=False):
    """``bm2_v4`` (``scripts/proto_bm3.py:236``, the dot in ``CH``-row
    chunks): ``bm2_v1``'s outputs. K1; ``CH`` and ``rt`` are the TPU's."""
    del rt, CH
    return _two_level(plain, queries, shard, valid_rows, S)


# -- P5, P6: scripts/proto_bm2.py --------------------------------------------


def proto_bm2_bm2_a(queries, shard, valid_rows, rt=1024, S=16, *,
                    plain=False):
    """``bm2_a`` (``scripts/proto_bm2.py:62``): ``(bms [R/S, T], bm [R/128,
    T])``. K1."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, S)


def proto_bm2_bm2_b(queries, shard, valid_rows, rt=2048, S=16, *,
                    plain=False):
    """``bm2_b`` (``scripts/proto_bm2.py:111``, lane-group reduce):
    ``bms [T, R/S]`` alone, query-major. K10 with ``t_major``."""
    del rt
    (bms,) = _k10(plain, queries, shard, valid_rows, sub=S, t_major=True)
    return bms


# -- P7, P8: scripts/proto_bmt.py --------------------------------------------


def proto_bmt_bm2t_pass(queries, shard, valid_rows, rt=1024, emit_sims=True,
                        *, plain=False):
    """``bm2t_pass`` (``scripts/proto_bmt.py:65``): ``(sims [R, T], bm8
    [R/8, T], bm128 [R/128, T])``; like the script, it writes the scores
    whatever ``emit_sims`` says. K10 with ``emit_sims`` at sub 8."""
    del rt, emit_sims
    return _k10(plain, queries, shard, valid_rows, sub=8, emit_sims=True,
                emit_width=128)


def proto_bmt_bm2t_only(queries, shard, valid_rows, rt=1024, *, plain=False):
    """``bm2t_only`` (``scripts/proto_bmt.py:117``): ``(bm8 [R/8, T], bm128
    [R/128, T])``. K1 at sub 8."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, 8)


# -- P9: scripts/proto_768.py ------------------------------------------------


def proto_768_bm2_pass(queries, shard, valid_rows, rt=1024, *, plain=False):
    """``bm2_pass`` (``scripts/proto_768.py:69``, the ``q . s^T``
    orientation): ``(bm8 [R/8, T], bm128 [R/128, T])``. K1 at sub 8."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, 8)


# -- P10: scripts/proto_fused.py ---------------------------------------------


def proto_fused_bm2(queries, shard, valid_rows, rt=2048, S=16, *,
                    plain=False):
    """``bm2`` (``scripts/proto_fused.py:83``): ``(bms [R/S, T], bm [R/128,
    T])``. K1 at sub ``S``."""
    del rt
    return _two_level(plain, queries, shard, valid_rows, S)


# -- P11: scripts/proto_argmax.py --------------------------------------------


def proto_argmax_bm2x(queries, shard, valid_rows, *, mode=0, plain=False):
    """``bm2x`` (``scripts/proto_argmax.py:72``), 16-row units and 128-row
    blocks: mode 0 ``(bms, bm)`` on K1; mode 1 ``(bms, arg, bm)`` and mode 2
    ``(bms, arg, m2, bm)`` on K10, ``arg`` int32 (lowest attaining row of
    the unit) and ``m2`` f32 (the max with that row replaced by
    ``PAD_SIM``) unpacked."""
    if mode == 0:
        return _k1(plain, queries, shard, valid_rows, sub=ARGMAX_SUB,
                   block=ARGMAX_BLOCK, emit_block=True)
    return _k10(plain, queries, shard, valid_rows, sub=ARGMAX_SUB,
                emit_arg=True, emit_m2=mode >= 2, emit_width=ARGMAX_BLOCK)


# -- P12, P13: scripts/proto_emit_var.py -------------------------------------


def _emit_var(plain, mode, qq, sh, valid_rows, emit_width):
    """``(key, bms, bmi)`` at 128-row units: the packed (m2, argmax) key on
    K1 (``masked``, ``twolevel``: one function), or the raw integer key on
    K10 (``k1only``)."""
    if mode == "k1only":
        bms, key, bmi = _k10(plain, qq, sh, valid_rows, sub=EMIT_VAR_SUB,
                             emit_raw_key=True, emit_width=emit_width)
        return key, bms, bmi
    if mode not in ("masked", "twolevel"):
        raise ValueError(f"unknown emission mode {mode!r}")
    bms, key, bmi = _k1(plain, qq, sh, valid_rows, sub=EMIT_VAR_SUB,
                        block=EMIT_VAR_BLOCK, emit_block=True,
                        emit_argmax=True, emit_width=emit_width)
    return key, bms, bmi


def proto_emit_var_run_tvariant(mode, *, valid_rows=EMIT_VAR_VALID,
                                emit_width=EMIT_VAR_EW, plain=False):
    """``run_tvariant`` (``scripts/proto_emit_var.py:167``, the ``q . s^T``
    int8 pass, its ``bmi`` reduced after the call): ``fn(qq, sh) -> (key,
    bms, bmi)``. ``k1only``: the raw key on K10; ``masked``: K1's packed
    key, ``bmi`` emitted by the kernel at ``emit_width``."""
    def fn(qq, sh):
        return _emit_var(plain, mode, qq, sh, valid_rows, emit_width)
    return fn


def proto_emit_var_run_variant(mode, *, valid_rows=EMIT_VAR_VALID,
                               emit_width=EMIT_VAR_EW, plain=False):
    """``run_variant`` (``scripts/proto_emit_var.py:208``, the int8 pass at
    emit width 256): ``fn(qq, sh) -> (key, bms, bmi)``. ``masked`` and
    ``twolevel`` compute one function, on K1 at emit width 256; ``k1only``
    on K10."""
    def fn(qq, sh):
        return _emit_var(plain, mode, qq, sh, valid_rows, emit_width)
    return fn


# -- P14: scripts/proto_int8.py ----------------------------------------------


def proto_int8_bm2t_i8(queries, shard, valid_rows, rt=2048, sub=64,
                       inv_scale2=1.0, *, plain=False):
    """``bm2t_i8`` (``scripts/proto_int8.py:78``): ``bms [R/sub, T]`` of the
    int8 dot times ``inv_scale2`` (the script passes 1/700^2). K10 on int8
    with a runtime scale."""
    del rt
    (bms,) = _k10(plain, queries, shard, valid_rows, sub=sub,
                  inv_scale2=inv_scale2)
    return bms


# -- P15: scripts/proto_hier.py ----------------------------------------------


def proto_hier_mm_bmsub(queries, shard, valid_rows, sub=32, rt=1024, *,
                        plain=False):
    """``mm_bmsub`` (``scripts/proto_hier.py:67``): ``(sims [T, R], bm
    [R/sub, T])``. K3 at block ``sub``."""
    del rt
    fn = tk.matmul_blockmax_plain if plain else tk.matmul_blockmax
    return fn(queries, shard, valid_rows, block=sub)


# -- P16: scripts/proto_rescore.py -------------------------------------------


def proto_rescore_bm_only(queries, shard, valid_rows, rt=8192, *,
                          plain=False):
    """``bm_only`` (``scripts/proto_rescore.py:63``): ``bm [R/128, T]``.
    K5."""
    del rt
    fn = tk.matmul_blockmax_only_plain if plain else tk.matmul_blockmax_only
    return fn(queries, shard, valid_rows)


# -- the measurement ---------------------------------------------------------

#: store -> (rows, dim, kind, valid rows): ``kind`` "bfloat16" or "int8"
#: (normalized random rows, the int8 as the lattice) or "raw8" (raw int8 in
#: [-127, 127]); rows at or past ``valid`` are zero.
STORES = {
    "bm3": (1_001_472, 768, "bfloat16", 1_001_472),
    "bmt16k": (16_384, 768, "bfloat16", 16_384),
    "1m": (1_048_576, 768, "bfloat16", 1_048_576),
    "fused1m": (1_001_472, 768, "bfloat16", 1_000_448),
    "argmax": (1_000_448, 768, "bfloat16", 1_000_000),
    "hier": (1_015_808, 768, "bfloat16", 1_000_000),
    "int8_4k": (4_096, 768, "raw8", 4_096),
    "int8_1m": (1_048_576, 768, "raw8", 1_048_576),
    "10m": (10_027_008, 256, "bfloat16", 10_027_008),
    "emit_var": (EMIT_VAR_R, EMIT_VAR_D, "int8", EMIT_VAR_VALID),
}


def _emit_var_case(fn):
    return lambda q, s, v, p: fn(valid_rows=v, plain=p)(q, s)


#: (script, case, store, queries, call(q, s, valid, plain)): each script's
#: timed cases at its own shapes, in the script's order; stores in use order.
#: ``bm2t_pass`` runs at 1Mx768 too, beside the 16,384-row store on which
#: ``proto_bmt.py`` checks it, so its score-matrix write is timed at the size
#: of its two-level twin ``bm2t-only`` (which ``proto_calib`` also runs).
CASES = [
    ("proto_bm3", "V1 swapped two-level S=16", "bm3", 512,
     lambda q, s, v, p: proto_bm3_bm2_v1(q, s, v, S=16, plain=p)),
    ("proto_bm3", "V2 scratch-sims", "bm3", 512,
     lambda q, s, v, p: proto_bm3_bm2_v2(q, s, v, S=16, plain=p)),
    ("proto_bm3", "V3 sims->HBM + two-level", "bm3", 512,
     lambda q, s, v, p: proto_bm3_bm2_v3(q, s, v, S=16, plain=p)),
    ("proto_bm3", "V4 chunked-dot", "bm3", 512,
     lambda q, s, v, p: proto_bm3_bm2_v4(q, s, v, S=16, plain=p)),
    ("proto_bm2", "A swapped-dot two-out S=16", "bm3", 512,
     lambda q, s, v, p: proto_bm2_bm2_a(q, s, v, S=16, plain=p)),
    ("proto_bm2", "B lane-reduce single-out S=16", "bm3", 512,
     lambda q, s, v, p: proto_bm2_bm2_b(q, s, v, S=16, plain=p)),
    ("proto_bmt", "bm2t_pass 16384x768", "bmt16k", 512,
     lambda q, s, v, p: proto_bmt_bm2t_pass(q, s, v, plain=p)),
    ("proto_bmt", "bm2t_pass 1Mx768", "1m", 512,
     lambda q, s, v, p: proto_bmt_bm2t_pass(q, s, v, plain=p)),
    ("proto_bmt", "bm2t-only 1Mx768", "1m", 512,
     lambda q, s, v, p: proto_bmt_bm2t_only(q, s, v, plain=p)),
    ("proto_768", "bm2 pass T=512", "1m", 512,
     lambda q, s, v, p: proto_768_bm2_pass(q, s, v, plain=p)),
    ("proto_fused", "bm2 two-level S=16 (1m)", "fused1m", 512,
     lambda q, s, v, p: proto_fused_bm2(q, s, v, S=16, plain=p)),
    ("proto_fused", "bm2 two-level S=32 (1m)", "fused1m", 512,
     lambda q, s, v, p: proto_fused_bm2(q, s, v, S=32, plain=p)),
    ("proto_argmax", "current (bms+bm)", "argmax", 512,
     lambda q, s, v, p: proto_argmax_bm2x(q, s, v, mode=0, plain=p)),
    ("proto_argmax", "+argmax", "argmax", 512,
     lambda q, s, v, p: proto_argmax_bm2x(q, s, v, mode=1, plain=p)),
    ("proto_argmax", "+argmax+max2", "argmax", 512,
     lambda q, s, v, p: proto_argmax_bm2x(q, s, v, mode=2, plain=p)),
    ("proto_hier", "kernel mm+bm32", "hier", 512,
     lambda q, s, v, p: proto_hier_mm_bmsub(q, s, v, sub=32, plain=p)),
    ("proto_int8", "int8 bm2t sub=64 (4096x768)", "int8_4k", 512,
     lambda q, s, v, p: proto_int8_bm2t_i8(q, s, v, sub=64,
                                           inv_scale2=INV_SCALE2_700, plain=p)),
    ("proto_int8", "int8 bm2t sub=64 (1Mx768)", "int8_1m", 512,
     lambda q, s, v, p: proto_int8_bm2t_i8(q, s, v, sub=64,
                                           inv_scale2=INV_SCALE2_700, plain=p)),
    ("proto_fused", "bm2 two-level S=32 (10m)", "10m", 512,
     lambda q, s, v, p: proto_fused_bm2(q, s, v, S=32, plain=p)),
    ("proto_fused", "bm2 two-level S=128 (10m)", "10m", 512,
     lambda q, s, v, p: proto_fused_bm2(q, s, v, S=128, plain=p)),
    ("proto_rescore", "bm-only kernel T=512", "10m", 512,
     lambda q, s, v, p: proto_rescore_bm_only(q, s, v, plain=p)),
    ("proto_rescore", "bm-only kernel T=1024", "10m", 1024,
     lambda q, s, v, p: proto_rescore_bm_only(q, s, v, plain=p)),
    ("proto_emit_var", "v0_noarg (K1 at emit width 256)", "emit_var",
     EMIT_VAR_Q,
     lambda q, s, v, p: _k1(p, q, s, v, sub=EMIT_VAR_SUB,
                            block=EMIT_VAR_BLOCK, emit_block=True,
                            emit_width=EMIT_VAR_EW)),
    ("proto_emit_var", "v2_masked", "emit_var", EMIT_VAR_Q,
     _emit_var_case(lambda **kw: proto_emit_var_run_variant("masked", **kw))),
    ("proto_emit_var", "twolevel", "emit_var", EMIT_VAR_Q,
     _emit_var_case(lambda **kw: proto_emit_var_run_variant("twolevel", **kw))),
    ("proto_emit_var", "k1only", "emit_var", EMIT_VAR_Q,
     _emit_var_case(lambda **kw: proto_emit_var_run_variant("k1only", **kw))),
    ("proto_emit_var", "v4t_k1only", "emit_var", EMIT_VAR_Q,
     _emit_var_case(lambda **kw: proto_emit_var_run_tvariant("k1only", **kw))),
    ("proto_emit_var", "v4t_masked", "emit_var", EMIT_VAR_Q,
     _emit_var_case(lambda **kw: proto_emit_var_run_tvariant("masked", **kw))),
]


def make_store(name: str, rows_divisor: int, seed: int,
               device: torch.device):
    """``(data [R, D], valid rows)`` of store ``name``, cut by
    ``rows_divisor`` (to whole 1024-row blocks; a padded tail stays
    padded)."""
    rows, dim, kind, valid = STORES[name]
    cut = rows - valid
    rows = max(1024, rows // rows_divisor // 1024 * 1024)
    valid = max(0, rows - (cut and max(1, cut // rows_divisor)))
    if kind == "raw8":
        data = _raw_int8((rows, dim), seed, device)
    else:
        data = DeviceStore.synthetic(rows, dim, kind, seed, device=device).data
    data[valid:] = 0
    return data, valid


def _raw_int8(shape, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=gen, device=device,
                         dtype=torch.int8)


def make_queries(name: str, data: torch.Tensor, valid: int, t: int,
                 seed: int) -> torch.Tensor:
    """``t`` queries: raw int8 draws for a raw int8 store (as
    ``proto_int8`` draws them), else store rows evenly spaced over the
    valid rows (as ``proto_emit_var`` picks them)."""
    if STORES[name][2] == "raw8":
        return _raw_int8((t, data.shape[1]), seed, data.device)
    rows = torch.linspace(0, max(0, valid - 1), t, device=data.device).long()
    return data[rows].contiguous()


def as_tuple(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def compare(got, want) -> tuple:
    """(max |diff| over float outputs, share of integer outputs that
    differ); shapes and dtypes must agree. NaN on both sides counts as
    equal, NaN on one side as an infinite difference."""
    err, differ, n_int = 0.0, 0, 0
    for a, b in zip(as_tuple(got), as_tuple(want), strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output {tuple(a.shape)} {a.dtype} against "
                                 f"plain {tuple(b.shape)} {b.dtype}")
        if a.dtype.is_floating_point:
            nan = a.isnan()
            if not torch.equal(nan, b.isnan()):
                err = math.inf
            elif not bool(nan.all()):
                err = max(err, float((a - b).abs()[~nan].max()))
        else:
            differ += int((a != b).sum())
            n_int += a.numel()
    return err, differ / max(1, n_int)


def library_ms(q, data, device, iters):
    """The product alone (``torch.matmul``; ``torch._int_mm`` on int8) or
    None where its output would exceed :data:`LIBRARY_MAX_BYTES`."""
    out_bytes = q.shape[0] * data.shape[0] * (2 if q.dtype == torch.bfloat16
                                              else 4)
    if out_bytes > LIBRARY_MAX_BYTES:
        return None
    if q.dtype == torch.int8:
        return _time_ms(lambda: torch._int_mm(q, data.T), iters, device)
    return _time_ms(lambda: torch.matmul(q, data.T), iters, device)


def measure(script, label, q, data, valid, call, device, iters=2) -> dict:
    """One case: kernel, plain version and library product on queries
    ``q`` against ``data``."""
    t = q.shape[0]
    before = dict(tk.launch_counts)
    got = as_tuple(call(q, data, valid, False))
    want = as_tuple(call(q, data, valid, True))
    err, differ = compare(got, want)
    finite = all(bool(torch.isfinite(x).all()) for x in got
                 if x.dtype.is_floating_point)
    b_ms, b_by = bound(q, data, got)
    del got, want
    ms = _time_ms(lambda: call(q, data, valid, False), iters, device)
    kernels = {k: v - before[k] for k, v in tk.launch_counts.items()
               if v != before[k]}
    plain_ms = _time_ms(lambda: call(q, data, valid, True), 1, device)
    lib = library_ms(q, data, device, iters)
    r, d = data.shape
    int8 = data.dtype == torch.int8
    ok = (finite and err <= (0.0 if int8 else TOL)
          and differ <= (0.0 if int8 else 1e-3))
    return {"script": script, "case": label, "rows": r, "dim": d,
            "valid": valid, "queries": t,
            "dtype": str(data.dtype).removeprefix("torch."),
            "kernels": kernels, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "max_abs_err": err, "int_differ": differ, "finite": finite,
            "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rows-divisor", type=int, default=1,
                    help="divide every store's rows by this (small runs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="run only the cases of scripts whose name contains "
                         "this")
    args = ap.parse_args(argv)
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(f"device {torch.cuda.get_device_name(device)}", flush=True)
    tk.reset_launch_counts()
    stores, results, stores_seen = {}, [], []
    for script, label, name, t, call in CASES:
        if args.only not in script:
            continue
        if name not in stores:
            stores.clear()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            stores[name] = make_store(name, args.rows_divisor,
                                      args.seed + len(stores_seen), device)
            stores_seen.append(name)
        data, valid = stores[name]
        q = make_queries(name, data, valid, t, args.seed + 1)
        res = measure(script, label, q, data, valid, call, device)
        results.append(res)
        lib = res["library_ms"]
        print(f"{script} {label} [{t} x {res['rows']} x {res['dim']} "
              f"{res['dtype']}, {valid} valid] on {res['kernels']}: kernel "
              f"{res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
              f"{res['bound_ms']:.3f} ms ({res['bound_by']}), library "
              f"{'none' if lib is None else f'{lib:.3f} ms'}, "
              f"{2e-9 * t * res['rows'] * res['dim'] / res['ms']:.2f} TFLOP/s"
              f"; max|kernel - plain| {res['max_abs_err']:.3g}, integer "
              f"outputs differing {res['int_differ']:.3g}: "
              f"{'ok' if res['ok'] else 'FAILED'}", flush=True)
    stores.clear()
    print(json.dumps({"results": results}), flush=True)
    print("launches " + json.dumps({k: v for k, v in tk.launch_counts.items()
                                    if v}), flush=True)
    ok = all(r["ok"] and not math.isnan(r["ms"]) for r in results)
    return 0 if ok and results else 1


if __name__ == "__main__":
    sys.exit(main())
