"""A/B of builds of the flash kernels' source on the card, in one process.

    python -m better_search_rag_rust_tpu_torch.bench.ab_flash OLD.cu NEW.cu [...]

Each argument is a copy of ``ops/csrc/flash_kernels.cu``: the parent
commit's (unpack it with ``git archive`` into a git-ignored directory) or
the tree's, or the name of a variant that this module writes from the
tree's source into ``build/ab_flash/`` (:data:`VARIANTS`; ``@a+b`` applies
both edits): ``@noew``, the three kernels without their elementwise work
(K14: p = s and alpha = 1, no logit, mask, maximum or exponential; K15/K16:
p = s, ds = dp; wrong answers: what the per-logit chain costs); ``@expf``,
``__expf`` in place of ``ex2.approx.ftz`` (its denormal fix-up). A build
whose entry points take the tile plan (recognised by its source: the
entry point's parameters name ``plan``; the forward's since the plan comes
from the ids, the backward's since the backward took one) gets the plan of
:func:`..ops.flash_kernels.segment_tile_plan` (and, backward, ``1 / l``),
and is timed twice: with the plan and with none (``plan off``: every tile
computed), so that the gain of the mainloop and the gain of the skip are
each measured on their own. An older entry point gets ``l`` (backward) and
computes every tile. Every build uses the package's nvcc flags, all
started together.

Timed with CUDA events (:data:`ITERS` launches after a warm-up), every
build in turn and then in reverse order, so that a drift of the card shows
as a spread between the two passes rather than as a difference between
builds: K14 at the encoder's [32, 12, 2048, 64] (``chip_smoke.py`` phase
27's forward), K15 ``bwd_dkv`` and K16 ``bwd_dq`` at the finetune step's
[8, 12, 2048, 64], each on two sets of operands, ``padded`` (phase 27's
segment ids: each row's length uniform in [S/8, S], row 0 whole, pad tokens
their own segment) and ``unpadded`` (no segment ids: nothing can be
skipped). Beside them, per operand set: the plain versions, SDPA (the
forward, and its whole backward; the boolean segment mask where padded;
the yardstick only), the plan's own cost (backward: with the reciprocal),
each kernel's bound (its operations on the pairs the segment rule leaves
at the bf16 tensor rate, or its bytes, whichever is larger) and the plan's
skipped and computed tile pairs. Then per build and mode: max |kernel -
plain| against the largest entry and the cosine on every cell, the error
against a float64 evaluation on batch rows 0-1 x heads 0-1 beside the
plain version's, whether two launches agree bit for bit and (forward)
whether the plan on and off agree bit for bit; the ptxas report of the
K14, K15 and K16 bodies; the card's name and power limit. ``--out`` writes
the numbers as JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import flash_kernels as fk
from .ab_topk import _edit, _entry_name, device_ms

OUT = _build.BUILD_DIR.parent / "ab_flash"
TREE_SOURCE = _build.SOURCES["flash"][0]
ITERS = 20
B, H, S, HD = 8, 12, 2048, 64
#: K14's batch: the encoder's in phase 27
B_FWD = 32
#: H100 SXM data sheet: the bf16 dense tensor rate and the HBM rate.
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of the entry points before they took the tile plan.
OLD_SIGNATURES = {
    "bsr_flash_attention_fwd": (_I, [_P] * 5 + [_I] * 5 + [_F] + [_P] * 4),
    "bsr_flash_attention_bwd_dkv": (_I, [_P] * 9 + [_I] * 5 + [_F] + [_P] * 3),
    "bsr_flash_attention_bwd_dq": (_I, [_P] * 9 + [_I] * 5 + [_F] + [_P] * 2),
}
#: K14's online softmax, which ``@noew`` replaces by packing the dots.
_K14_SOFTMAX = """float (&alpha)[2], uint32_t (&pa)[4][4]) {
  const int t = threadIdx.x & 3;"""


def takes_plan(src: str, entry: str) -> bool:
    """Whether the source's entry point ``entry`` takes a tile plan."""
    params = src[src.index(f'extern "C" int {entry}('):]
    return "plan" in params[:params.index(")")]


def _noew(src: str) -> str:
    src = _edit(src, _K14_SOFTMAX, _K14_SOFTMAX.replace(
        "{", "{\n  alpha[0] = alpha[1] = 1.f;\n#pragma unroll\n  for (int j = 0; "
        "j < 8; ++j) pack_a(pa, j, s[4 * j], s[4 * j + 1], s[4 * j + 2], "
        "s[4 * j + 3]);\n  return;", 1))
    for old, new in (
            ("return __fmul_rn(exp_ftz(__fsub_rn(logit(dot, scale, sa, sb), m)), il);",
             "return dot;"),
            ("return __fmul_rn(exp_ftz(__fsub_rn(__fmul_rn(dot, scale), m)), il);",
             "return dot;"),
            ("return __fmul_rn(__fmul_rn(__fsub_rn(dpv, di), p), scale);",
             "return dpv;")):
        src = _edit(src, old, new)
    return src


#: Variant name -> its source from the tree's source text (module
#: docstring).
VARIANTS = {
    "noew": _noew,
    "expf": lambda src: _edit(
        src, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
        '"f"(__fmul_rn(x, 1.4426950408889634f)));', "y = __expf(x);"),
}


def source_path(arg: str) -> Path:
    """A source argument as a file: ``@a+b`` writes the tree's source with
    variants ``a`` and ``b`` applied into :data:`OUT`."""
    if not arg.startswith("@"):
        return Path(arg)
    OUT.mkdir(parents=True, exist_ok=True)
    src = TREE_SOURCE.read_text()
    for name in arg[1:].split("+"):
        src = VARIANTS[name](src)
    path = OUT / f"{arg[1:].replace('+', '_')}.cu"
    path.write_text(src)
    return path


def build(paths):
    """``{name: (ctypes library, {entry point: takes the plan}, ptxas lines
    of the K14, K15 and K16 bodies)}``, one nvcc per source, all started
    together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, path in enumerate(paths):
        name = f"{i}:{Path(path).name}"
        lib_path = OUT / f"ab{i}_{Path(path).stem}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib_path,
            {fn: takes_plan(Path(path).read_text(), fn) for fn in ENTRY.values()})
    libs = {}
    for name, (proc, lib_path, new) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
        lines = err.splitlines()
        report = [f"{_entry_name(ln)}: "
                  + "; ".join(x.split(":", 1)[-1].strip()[:60]
                              for x in lines[i + 2:i + 4])
                  for i, ln in enumerate(lines)
                  if "Compiling entry" in ln
                  and any(k in ln for k in ("k14_", "k15_", "k16_"))
                  and "ILi64E" in ln]
        lib = ctypes.CDLL(str(lib_path))
        sigs = dict(_build.SOURCES["flash"][1])
        sigs.update({fn: sig for fn, sig in OLD_SIGNATURES.items()
                     if not new[fn]})
        for fn, (restype, argtypes) in sigs.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, new, report)
    return libs


def forward_operands(padded: bool, seed: int, b: int = B_FWD) -> dict:
    """q, k, v [b, H, S, HD] bf16, segment ids (padded: phase 27's rule,
    each row's length uniform in [S/8, S], row 0 whole; else None), the
    kernels' int32 ids and the tile plan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn((b, H, S, HD), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    seg = None
    if padded:
        lens = torch.randint(S // 8, S + 1, (b,), generator=gen, device=dev)
        lens[0] = S
        seg = (torch.arange(S, device=dev)[None, :]
               < lens[:, None]).to(torch.int32)
    ids = torch.zeros((b, S), dtype=torch.int32, device=dev) if seg is None else seg
    return dict(q=q, k=k, v=v, seg=seg, ids=ids, scale=1.0 / math.sqrt(HD),
                plan=fk.segment_tile_plan(seg, seg))


def operands(padded: bool, seed: int) -> dict:
    """The backward's operands at [B, H, S, HD]: :func:`forward_operands`,
    do, the forward's o, l, m (K14 of the tree), di and 1 / l."""
    ops = forward_operands(padded, seed, B)
    q, k, v, seg, scale = (ops[n] for n in ("q", "k", "v", "seg", "scale"))
    gen = torch.Generator(device=q.device)
    gen.manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(torch.bfloat16)
    o, l, m = fk.flash_attention_fwd(q, k, v, seg, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    return dict(ops, do=do, o=o, l=l, m=m, di=di, inv_l=torch.reciprocal(l))


#: Entry point of each kernel.
ENTRY = {"K14": "bsr_flash_attention_fwd", "K15": "bsr_flash_attention_bwd_dkv",
         "K16": "bsr_flash_attention_bwd_dq"}


def launcher(lib, new: bool, kernel: str, ops: dict, plan: bool):
    """A closure that launches K14, K15 or K16 (``kernel``) of one build
    into preallocated outputs and returns the entry point's error code;
    ``new``: the entry point takes the plan."""
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, ENTRY[kernel])
    head = [ops[n].data_ptr() for n in ("q", "k", "v", "ids", "ids")]
    pl = ops["plan"] if plan and ops["plan"] is not None else None
    if kernel == "K14":
        outs = (torch.empty_like(ops["q"]),) + tuple(
            torch.empty(ops["q"].shape[:3], dtype=torch.float32,
                        device=ops["q"].device) for _ in range(2))
        mid = [None if pl is None else pl.data_ptr()] if new else []
        bq = ops["q"].shape[0]
        args = head + mid + [bq, H, S, S, HD, ops["scale"]] + [
            t.data_ptr() for t in outs]

        def run():
            return fn(*args, stream)

        run.outs = outs
        return run
    outs = ((torch.empty_like(ops["k"]), torch.empty_like(ops["v"]))
            if kernel == "K15" else (torch.empty_like(ops["q"]),))
    if new:
        mid = [ops["inv_l"].data_ptr(), ops["m"].data_ptr(), ops["do"].data_ptr(),
               ops["di"].data_ptr(), None if pl is None else pl.data_ptr()]
    else:
        mid = [ops["l"].data_ptr(), ops["m"].data_ptr(), ops["do"].data_ptr(),
               ops["di"].data_ptr()]
    args = head + mid + [B, H, S, S, HD, ops["scale"]] + [t.data_ptr() for t in outs]

    def run():
        return fn(*args, stream)

    run.outs = outs
    return run


def pairs(ops) -> int:
    """The query-key pairs the segment rule leaves (every pair unpadded)."""
    seg = ops["seg"]
    if seg is None:
        return ops["q"].shape[0] * S * S
    return sum(int(((seg == v).sum(1).long() ** 2).sum())
               for v in torch.unique(seg))


def bound_ms(ops, kernel: str) -> float:
    if kernel == "K14":  # q, k, v in; o, l, m out
        flops = 4 * H * HD * pairs(ops)
        moved = 4 * ops["q"].numel() * 2 + 2 * ops["q"][..., 0].numel() * 4
    else:
        flops = (8 if kernel == "K15" else 6) * H * HD * pairs(ops)
        moved = sum(t.numel() * t.element_size() for t in (
            ops["q"], ops["k"], ops["v"], ops["do"], ops["l"], ops["m"],
            ops["di"]))
        moved += (2 if kernel == "K15" else 1) * ops["q"].numel() * 2
    return 1e3 * max(flops / PEAK_BF16, moved / PEAK_BYTES)


def forward64(ops, rows=2, heads=2):
    """Softmax attention in float64 of the same bf16 operands under the
    segment rule, on batch rows and heads [:rows, :heads]."""
    q, k, v = (ops[n][:rows, :heads].double() for n in ("q", "k", "v"))
    s = torch.matmul(q, k.transpose(-1, -2)) * ops["scale"]
    if ops["seg"] is not None:
        seg = ops["seg"][:rows]
        s = s.masked_fill(~(seg[:, None, :, None] == seg[:, None, None, :]),
                          -math.inf)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def modes_of(libs, kernel: str):
    """``[(build, plan)]``: each build as it is, and a build whose entry
    point takes the plan also with it off."""
    return [(name, plan) for name, (_lib, new, _r) in libs.items()
            for plan in ((True, False) if new[ENTRY[kernel]] else (True,))]


def label(mode) -> str:
    return mode[0] + ("" if mode[1] else " plan off")


def timed(runs) -> dict:
    """Each run's ms in two passes, in turn and in reverse order."""
    times = {key: [] for key in runs}
    for order in (list(runs), list(runs)[::-1]):
        for key in order:
            times[key].append(device_ms(runs[key], ITERS))
    return times


def forward_case(libs, padded: bool, seed: int) -> dict:
    """K14 of every build at [B_FWD, H, S, HD] (see the module docstring)."""
    ops = forward_operands(padded, seed)
    modes = modes_of(libs, "K14")
    runs = {mode: launcher(libs[mode[0]][0], libs[mode[0]][1][ENTRY["K14"]],
                           "K14", ops, mode[1]) for mode in modes}
    times = timed(runs)
    args = tuple(ops[n] for n in ("q", "k", "v", "seg", "seg", "scale"))
    po, pl, _pm = fk.flash_attention_fwd_plain(*args)
    plain_ms = device_ms(lambda: fk.flash_attention_fwd_plain(*args) and 0, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None
    if ops["seg"] is not None:
        mask = ops["seg"][:, None, :, None] == ops["seg"][:, None, None, :]
    sdpa_ms = device_ms(lambda: sdpa(ops["q"], ops["k"], ops["v"], attn_mask=mask,
                                     scale=ops["scale"]) is None, ITERS)
    del mask
    plan_ms = device_ms(lambda: fk.segment_tile_plan(ops["seg"], ops["seg"])
                        is None and 0, ITERS)
    ref = forward64(ops)
    plan = ops["plan"]
    skipped = 0 if plan is None else int(plan.sum())
    rec = {"sdpa_ms": sdpa_ms, "plain_ms": plain_ms, "plan_ms": plan_ms,
           "tile_pairs": {"skipped": skipped,
                          "computed": B_FWD * (S // 64) ** 2 - skipped},
           "bound_ms": bound_ms(ops, "K14"),
           "plain_vs_float64": float((po[:2, :2].double() - ref).abs().max()),
           "builds": {}}
    first = {}
    for mode in modes:
        run = runs[mode]
        if run():
            raise RuntimeError(f"{label(mode)} K14 failed")
        once = [t.clone() for t in run.outs]
        if run():
            raise RuntimeError(f"{label(mode)} K14 failed")
        torch.cuda.synchronize()
        first[mode] = once
        o, l = once[0], once[1]
        row = {"ms": min(times[mode]), "ms_passes": times[mode],
               "bitwise_across_runs": all(torch.equal(a, b)
                                          for a, b in zip(once, run.outs)),
               "vs_plain": agreement(o, po),
               "l_max_rel": float(((l - pl).abs() / pl).max()),
               "vs_float64": float((o[:2, :2].double() - ref).abs().max())}
        on = first.get((mode[0], True))
        if not mode[1] and on is not None:
            row["bitwise_plan_on_off"] = all(torch.equal(a, b)
                                             for a, b in zip(on, once))
        rec["builds"][label(mode)] = row
    print(f"K14 {'padded' if padded else 'unpadded'} [{B_FWD}, {H}, {S}, {HD}]: "
          f"bound {rec['bound_ms']:.4f} ms; SDPA {sdpa_ms:.4f} ms; plain "
          f"{plain_ms:.3f} ms; plan {plan_ms:.4f} ms; tile pairs skipped "
          f"{skipped} of {B_FWD * (S // 64) ** 2}", flush=True)
    for name, row in rec["builds"].items():
        vp = row["vs_plain"]
        print(f"  {name}: K14 " + " / ".join(f"{ms:.4f}" for ms in row["ms_passes"])
              + f" ms ({100 * rec['bound_ms'] / row['ms']:.1f} % of bound); vs "
              f"plain {vp['max_abs']:.3g} cos {vp['cosine']:.6f}, l rel "
              f"{row['l_max_rel']:.3g}; vs float64 {row['vs_float64']:.3g} "
              f"(plain {rec['plain_vs_float64']:.3g}); bitwise across runs "
              f"{row['bitwise_across_runs']}"
              + (f", plan on/off {row['bitwise_plan_on_off']}"
                 if "bitwise_plan_on_off" in row else ""), flush=True)
    del ops, runs, first, po, pl, ref
    torch.cuda.empty_cache()
    return rec


def reference64(ops, rows=2, heads=2):
    """The exact gradient (dq, dk, dv) in float64 of softmax attention under
    the segment rule, on batch rows and heads [:rows, :heads]."""
    q, k, v, do = (ops[n][:rows, :heads].double() for n in ("q", "k", "v", "do"))
    s = torch.matmul(q, k.transpose(-1, -2)) * ops["scale"]
    if ops["seg"] is not None:
        seg = ops["seg"][:rows]
        same = seg[:, None, :, None] == seg[:, None, None, :]
        s = s.masked_fill(~same, -math.inf)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * ops["scale"]
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def agreement(got, want) -> dict:
    a, r = got.double(), want.double()
    return {"max_abs": float((a - r).abs().max()), "max_ref": float(r.abs().max()),
            "cosine": float((a * r).sum() / (a.norm() * r.norm()))}


def sdpa_backward_ms(ops) -> float:
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [ops[n].clone().requires_grad_() for n in ("q", "k", "v")]
    mask = None
    if ops["seg"] is not None:
        seg = ops["seg"]
        mask = seg[:, None, :, None] == seg[:, None, None, :]
    out = sdpa(*leaves, attn_mask=mask, scale=ops["scale"])
    return device_ms(lambda: torch.autograd.grad(out, leaves, ops["do"],
                                                 retain_graph=True) and 0, ITERS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+",
                    help="copies of flash_kernels.cu, or @variant names")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None, help="JSON of the numbers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build([source_path(a) for a in args.sources])
    modes = modes_of(libs, "K15")
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(),
        "shape": [B, H, S, HD], "forward_batch": B_FWD, "iters": ITERS,
        "forward": {}, "cases": {}}
    for padded in (True, False):
        result["forward"]["padded" if padded else "unpadded"] = forward_case(
            libs, padded, args.seed)
    for padded in (True, False):
        case = "padded" if padded else "unpadded"
        ops = operands(padded, args.seed)
        runs = {(mode, kern): launcher(libs[mode[0]][0],
                                       libs[mode[0]][1][ENTRY[kern]], kern,
                                       ops, mode[1])
                for mode in modes for kern in ("K15", "K16")}
        times = timed(runs)
        plain = {
            "K15": device_ms(lambda: fk.flash_attention_bwd_dkv_plain(
                *(ops[n] for n in ("q", "k", "v", "seg", "seg", "l", "m", "do",
                                   "di")), ops["scale"]) and 0, 3),
            "K16": device_ms(lambda: fk.flash_attention_bwd_dq_plain(
                *(ops[n] for n in ("q", "k", "v", "seg", "seg", "l", "m", "do",
                                   "di")), ops["scale"]) is None, 3)}
        plan_ms = device_ms(lambda: (fk.segment_tile_plan(
            ops["seg"], ops["seg"]), torch.reciprocal(ops["l"])) and 0, ITERS)
        plan = ops["plan"]
        skipped = 0 if plan is None else int(plan.sum())
        rec = {"sdpa_backward_ms": sdpa_backward_ms(ops), "plain_ms": plain,
               "plan_and_reciprocal_ms": plan_ms,
               "tile_pairs": {"skipped": skipped,
                              "computed": B * (S // 64) ** 2 - skipped},
               "bound_ms": {kern: bound_ms(ops, kern) for kern in ("K15", "K16")},
               "builds": {}}
        args_plain = tuple(ops[n] for n in ("q", "k", "v", "seg", "seg", "l", "m",
                                            "do", "di")) + (ops["scale"],)
        pdk, pdv = fk.flash_attention_bwd_dkv_plain(*args_plain)
        pdq = fk.flash_attention_bwd_dq_plain(*args_plain)
        ref = reference64(ops)
        want = {"dq": pdq, "dk": pdk, "dv": pdv}
        rec["plain_vs_float64"] = {
            n: float((want[n][:2, :2].double() - r).abs().max())
            for n, r in zip(("dq", "dk", "dv"), ref)}
        for mode in modes:
            row = {"ms": {k: min(times[(mode, k)]) for k in ("K15", "K16")},
                   "ms_passes": {k: times[(mode, k)] for k in ("K15", "K16")}}
            got = {}
            for kern in ("K15", "K16"):
                run = runs[(mode, kern)]
                if run():
                    raise RuntimeError(f"{label(mode)} {kern} failed")
                first = [t.clone() for t in run.outs]
                if run():
                    raise RuntimeError(f"{label(mode)} {kern} failed")
                torch.cuda.synchronize()
                row[f"{kern}_bitwise_across_runs"] = all(
                    torch.equal(a, b) for a, b in zip(first, run.outs))
                got.update(zip(("dk", "dv") if kern == "K15" else ("dq",), first))
            row["vs_plain"] = {n: agreement(got[n], want[n]) for n in want}
            row["vs_float64"] = {
                n: float((got[n][:2, :2].double() - r).abs().max())
                for n, r in zip(("dq", "dk", "dv"), ref)}
            rec["builds"][label(mode)] = row
        result["cases"][case] = rec
        print(f"{case}: bound K15 {rec['bound_ms']['K15']:.4f} ms, K16 "
              f"{rec['bound_ms']['K16']:.4f} ms; SDPA backward "
              f"{rec['sdpa_backward_ms']:.4f} ms; plain K15 {plain['K15']:.3f}, "
              f"K16 {plain['K16']:.3f} ms; plan + 1/l {plan_ms:.4f} ms; tile "
              f"pairs skipped {skipped} of {B * (S // 64) ** 2}", flush=True)
        for name, row in rec["builds"].items():
            fmt = {k: " / ".join(f"{ms:.4f}" for ms in v)
                   for k, v in row["ms_passes"].items()}
            vp = row["vs_plain"]
            print(f"  {name}: K15 {fmt['K15']} ms, K16 {fmt['K16']} ms, K15 + "
                  f"K16 {row['ms']['K15'] + row['ms']['K16']:.4f} ms; vs plain "
                  + ", ".join(f"{n} {v['max_abs']:.3g}/{v['max_ref']:.3g} cos "
                              f"{v['cosine']:.6f}" for n, v in vp.items())
                  + "; vs float64 " + ", ".join(
                      f"{n} {e:.3g}" for n, e in row["vs_float64"].items())
                  + " (plain " + ", ".join(
                      f"{e:.3g}" for e in rec["plain_vs_float64"].values()) + ")"
                  + f"; bitwise K15 {row['K15_bitwise_across_runs']}, K16 "
                  f"{row['K16_bitwise_across_runs']}", flush=True)
        del ops, runs, pdk, pdv, pdq, ref, want
        torch.cuda.empty_cache()
    for name, (_lib, _new, report) in libs.items():
        print(f"ptxas {name}: " + " | ".join(report))
    print(f"card: {result['card']}")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
