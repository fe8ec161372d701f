"""A/B of builds of the search kernels' source on the card, in one process.

    python -m better_search_rag_rust_tpu_torch.bench.ab_topk OLD.cu NEW.cu [...]

Each argument is a copy of ``ops/csrc/topk_kernels.cu`` — the parent
commit's (unpack it with ``git archive`` into a git-ignored directory), the
tree's, or a copy with one edit (a tile constant, a launch bound, the grid
order) — built with the package's nvcc flags (:data:`.._build.NVCC_FLAGS`)
into ``build/ab/`` (all builds started together) and bound with the
package's C signatures, so every build must keep the entry points of the
tree. The search kernels are then timed at the search path's shapes with
CUDA events (:data:`ITERS` launches after a warm-up), every build in turn,
then in reverse order, so that a drift of the card shows as a spread
between the two passes rather than as a difference between builds:

* K1 ``matmul_blockmax2_only`` at 512 x 1,000,448 x 768, sub 64, argmax and
  block maxima (``search_1m``'s pass), on bf16, f32 and the int8 lattice;
* K3 ``matmul_blockmax`` at 256 x 100,352 x 768 (``search_100k``'s tile),
  bf16 and int8; K5 at K1's shape, bf16;
* K2 ``gather_rescore`` at 512 queries x KS 100 units of 64 rows of the 1M
  store (the full gather), bf16, f32 and int8; bf16 at KS 4 (the argmax
  fast path's danger gather) and at 104 units of 16 rows (P20's V16);
* K6 ``block_scores`` on 512 x 2,048 gathered bf16 rows; K12
  ``gather_rescore_mm`` at V16 without a product and with 8 copies of a
  512 x 1,280 product; K13 ``gather_cross`` at P17's 1m S 16 G 2.

Stores are normalized random rows from ``--seed``; ids are random and
sorted per query, as the prototypes draw them. Each line prints one kernel
with every build's two times. Then, for each build, the error of K3's bf16
scores (256 x 100,352 x 768) against the float64 product of the same
operands, on unit queries (the search path's) and on raw normal queries
(the prototypes' data, whose scores run to ~5): max and mean, and the max
difference from the plain version's f32 product, whose own error is
printed beside it — what decides an arithmetic change, where the times
decide a geometry. The last lines are the ptxas report of each build's
bf16 bodies (registers, spills) and the card's name and power limit. Needs
a CUDA card; ``chip_smoke.py`` holds each kernel to its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build

OUT = _build.BUILD_DIR.parent / "ab"
ITERS = 5
R1, N1, D1 = 1_000_448, 1_000_000, 768
R3 = 100_352
T = 512
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def build(paths):
    """``{name: (ctypes library, ptxas lines of the bf16 bodies)}``, one
    nvcc per source, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, path in enumerate(paths):
        name = f"{i}:{Path(path).name}"
        lib_path = OUT / f"ab{i}_{Path(path).stem}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib_path)
    libs = {}
    for name, (proc, lib_path) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
        lines = err.splitlines()
        # after each entry: "Function properties", the spill line, "Used N
        # registers"
        report = [f"{ln.split(chr(39))[1].split('I13__nv')[0][-20:]}: "
                  + "; ".join(x.split(":", 1)[-1].strip()[:60] for x in lines[i + 2:i + 4])
                  for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and "bfloat16" in ln]
        lib = ctypes.CDLL(str(lib_path))
        for fn, (restype, argtypes) in _build.SOURCES["topk"][1].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, report)
    return libs


def _unit(rows, dim, gen, dev):
    m = torch.randn((rows, dim), generator=gen, device=dev)
    return m / m.norm(dim=1, keepdim=True)


def _ids(gen, dev, n_units, ks):
    ids = torch.randint(0, n_units, (T, ks), generator=gen, device=dev)
    return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()


def cases(seed):
    """``{label: (fn(lib) -> err, launches)}`` at the module docstring's
    shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mf = _unit(R1, D1, gen, dev)
    qf = mf[torch.randint(0, N1, (T,), generator=gen, device=dev)].contiguous()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}
    for dt in (torch.bfloat16, torch.float32, torch.int8):
        if dt == torch.int8:
            q, m = (qf * 127).round().to(dt), (mf * 127).round().to(dt)
        else:
            q, m = qf.to(dt), mf.to(dt)
        code, tag = CODES[dt], str(dt)[6:]
        bms = torch.empty((R1 // 64, T), device=dev)
        key = torch.empty((R1 // 64, T), dtype=torch.int32, device=dev)
        bm = torch.empty((R1 // 128, T), device=dev)
        out[f"K1 {tag}"] = (lambda lib, q=q, m=m, code=code, bms=bms, key=key, bm=bm:
                            lib.bsr_matmul_blockmax2(
            q.data_ptr(), m.data_ptr(), code, T, R1, D1, N1, 64, 128, bms.data_ptr(),
            key.data_ptr(), bm.data_ptr(), stream()), 3)
        ids = _ids(gen, dev, R1 // 64, 100)
        sc = torch.empty((T, 100 * 64), device=dev)
        out[f"K2 {tag} KS 100"] = (lambda lib, q=q, m=m, code=code, ids=ids, sc=sc:
                                   lib.bsr_gather_rescore(
            q.data_ptr(), m.data_ptr(), ids.data_ptr(), code, T, R1, D1, 100, 64,
            sc.data_ptr(), stream()), ITERS)
        if dt != torch.float32:
            q3, m3 = q[:256].contiguous(), m[:R3].contiguous()
            sims = torch.empty((256, R3), device=dev)
            bm3 = torch.empty((R3 // 128, 256), device=dev)
            out[f"K3 {tag}"] = (lambda lib, q3=q3, m3=m3, code=code, sims=sims, bm3=bm3:
                                lib.bsr_matmul_blockmax(
                q3.data_ptr(), m3.data_ptr(), code, 256, R3, D1, 100_000, 128,
                sims.data_ptr(), bm3.data_ptr(), stream()), 2 * ITERS)
        if dt != torch.bfloat16:
            continue
        qb, mb = q, m
        bm5 = torch.empty((R1 // 128, T), device=dev)
        out["K5 bf16"] = (lambda lib: lib.bsr_matmul_blockmax_only(
            qb.data_ptr(), mb.data_ptr(), 1, T, R1, D1, N1, 128, bm5.data_ptr(), stream()), 3)
        ids4 = ids[:, :4].contiguous()
        sc4 = torch.empty((T, 4 * 64), device=dev)
        out["K2 bf16 KS 4"] = (lambda lib: lib.bsr_gather_rescore(
            qb.data_ptr(), mb.data_ptr(), ids4.data_ptr(), 1, T, R1, D1, 4, 64,
            sc4.data_ptr(), stream()), 2 * ITERS)
        ids16 = _ids(gen, dev, R1 // 16, 104)
        sc16 = torch.empty((T, 104 * 16), device=dev)
        out["K2 bf16 unit 16 KS 104"] = (lambda lib: lib.bsr_gather_rescore(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), 1, T, R1, D1, 104, 16,
            sc16.data_ptr(), stream()), ITERS)
        ids8 = _ids(gen, dev, R1 // 8, 256).long()
        gathered = mb[(ids8[:, :, None] * 8 + torch.arange(8, device=dev))
                      .reshape(T, -1)].contiguous()
        sc6 = torch.empty((T, 2048), device=dev)
        out["K6 bf16 C 2048"] = (lambda lib: lib.bsr_block_scores(
            qb.data_ptr(), gathered.data_ptr(), 1, T, 2048, D1, sc6.data_ptr(), stream()),
            ITERS)
        mmo0 = torch.empty((T, 1), device=dev)
        out["K12 V16, no product"] = (lambda lib: lib.bsr_gather_rescore_mm(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), T, R1, D1, 104, 16,
            qb.data_ptr(), mb.data_ptr(), T, 128, 0, sc16.data_ptr(), mmo0.data_ptr(),
            stream()), ITERS)
        mmo = torch.empty((T, 10), device=dev)
        out["K12 V16, 8 copies of 512 x 1280"] = (lambda lib: lib.bsr_gather_rescore_mm(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), T, R1, D1, 104, 16,
            qb.data_ptr(), mb.data_ptr(), T, 1280, 8, sc16.data_ptr(), mmo.data_ptr(),
            stream()), ITERS)
        idsx = _ids(gen, dev, R1 // 16, 100)
        scx = torch.empty((50, T, 256), device=dev)
        out["K13 S 16 G 2"] = (lambda lib: lib.bsr_gather_cross(
            qb.data_ptr(), mb.data_ptr(), idsx.data_ptr(), T, R1, D1, 100, 16, 2,
            scx.data_ptr(), stream()), ITERS)
    return out


def score_errors(libs, seed):
    """One line per (queries, build): K3's bf16 score error against float64
    (module docstring)."""
    from ..ops import topk_kernels as tk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    rows = _unit(R3, D1, gen, dev).to(torch.bfloat16).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    unit_q = rows[torch.randint(0, R3, (256,), generator=gen, device=dev)]
    raw_q = torch.randn((256, D1), generator=gen, device=dev).to(torch.bfloat16)
    lines = []
    for label, q in (("unit queries", unit_q.contiguous()), ("raw normal queries", raw_q)):
        exact, _bound = tk.score_bound(q, rows)
        plain = q.float() @ rows.float().T
        p_err = float((plain.double() - exact).abs().max())
        for name, (lib, _report) in libs.items():
            sims = torch.empty((256, R3), device=dev)
            bm = torch.empty((R3 // 128, 256), device=dev)
            if lib.bsr_matmul_blockmax(q.data_ptr(), rows.data_ptr(), 1, 256, R3, D1, R3,
                                       128, sims.data_ptr(), bm.data_ptr(), stream):
                raise RuntimeError("a kernel launch failed")
            err = (sims.double() - exact).abs()
            lines.append(f"K3 bf16 error, {label}, {name}: max|k - f64| "
                         f"{float(err.max()):.3g}, mean {float(err.mean()):.3g}; "
                         f"max|k - plain| {float((sims - plain).abs().max()):.3g} "
                         f"(plain's own max|p - f64| {p_err:.3g})")
    return lines


def device_ms(fn, iters):
    if fn():
        raise RuntimeError("a kernel launch failed")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="copies of topk_kernels.cu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_topk: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(args.sources)
    work = cases(args.seed)
    times = {label: {name: [] for name in libs} for label in work}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        for label, (fn, iters) in work.items():
            times[label][name].append(device_ms(lambda: fn(lib), iters))
    for label, by_build in times.items():
        print(f"{label}: " + "; ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms in v)} ms"
            for name, v in by_build.items()), flush=True)
    for line in score_errors(libs, args.seed):
        print(line, flush=True)
    for name, (_lib, report) in libs.items():
        print(f"ptxas {name}: " + " | ".join(report))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
