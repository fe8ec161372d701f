"""A/B of builds of the search kernels' source on the card, in one process.

    python -m better_search_rag_rust_tpu_torch.bench.ab_topk OLD.cu NEW.cu [...]

Each argument is a copy of ``ops/csrc/topk_kernels.cu`` — the parent
commit's (unpack it with ``git archive`` into a git-ignored directory), the
tree's, or a copy with one edit (a tile constant, a launch bound, the grid
order) — or the name of a variant that this module writes from the tree's
source into ``build/ab/`` (:data:`VARIANTS`: ``@mma_sync``, the int8 tile on
``mma.sync`` m16n8k32 (``i8_tile_mma_sync.cuh`` spliced in place of the
shipped int8 block); ``@bf16_mma_sync``, the bf16 tile on ``mma.sync``
m16n8k16 fed by ``ldmatrix`` from a ``cp.async`` ring, as shipped before the
``wgmma`` tile (``bf16_tile_mma_sync.cuh`` in place of the shipped bf16
block); ``@bf16_n64``, the bf16 wgmma tile on m64n64k16, two wgmmas a k16
step; ``@bf16_n64_p4``, the same with four product fragments (three
wgmmas running while one product is added); ``@bf16_one_product``, the
bf16 wgmma tile with one product fragment, each product's adds after its
wgmma instead of under the next;
``@bf16_noadd``, the bf16 wgmma tile adding one element of each product
instead of 64 — wrong scores: what the tile's time owes to the rule's adds;
``@bf16_nomma``, the bf16 tile with no wgmma and no add (the ring, the
barriers and the epilogue alone; scores 0); ``@bf16_phases``, the tree's
bf16 tile timing its own prologue, k loop and drain with ``clock64``
(printed after the bit-for-bit lines, :func:`phase_lines`);
``@noepi``, K1 and K10 without their int8 unit pass, which with the tree's
build gives the epilogue's share of K1 int8; ``@scalar_st``, the wgmma tile
(int8 and bf16) writing st at K3's odd leading dimension, one 4-byte store
at a time; ``@nosplit``, every int8 pass one lane per column;
``@stages4``, the wgmma tile's 4-slab ring (int8: one block per SM);
``@noqload`` and ``@nosload``, the wgmma tile loading only the store's or
only the queries' half of each slab (TMA) — wrong scores, half the operand
traffic: what the tile's time owes to its loads; the f32 tile's levers:
``@f32_nt256``, 256 threads of 8 x 8 accumulators (16 FMAs per 16-byte shared load, 128
registers a thread) instead of 128 threads of 8 x 16 (21 FMAs a load);
``@f32_nt256_one_block``, the same at one block per SM and up to 255
registers; ``@f32_stages3``, a 3-slab ring; ``@f32_slab_branch``, every
slab through the ragged slab's body (a branch before each fragment, which
keeps the compiler from hoisting the next fragment's loads);
``@f32_sk48``, slabs of 48 features (16 barriers at D 768, not 24);
``@f32_noqload``, the query fragments taken from the rows' registers
instead of shared memory (wrong scores, 8 of 24 loads: what the tile owes
to its shared loads); ``@f32_qg2`` and ``@f32_qg8``, the queries'
fragments loaded 2 or 8 at a time beside the rows' instead of 4; the
gather mainloop's (K2, K6): ``@g_stages4``, a 4-slab ring at 3 blocks an SM
instead of 6 slabs at 2; ``@g_no_l2``, the 16-byte copies without their
256-byte L2 prefetch; ``@g_tile64``, 64 candidate rows (and threads) a
block at 4 blocks an SM; ``@g_sb256``, slabs of 256 bytes a row, 3 of them
at 2 blocks an SM; ``@g_t32_sb512``, 32 rows a block in slabs of 512 bytes
(one warp's copy is one row's 512 bytes); ``@g_pf4``, each row's 4 slabs
past the coming ones prefetched into L2 by one bulk prefetch every 4
slabs). Every
build uses the package's nvcc
flags (:data:`.._build.NVCC_FLAGS`), all started together, and is bound with
the package's C signatures, so every build must keep the entry points of the
tree. The search kernels are then timed at the search path's shapes with
CUDA events (:data:`ITERS` launches after a warm-up), every build in turn,
then in reverse order, so that a drift of the card shows as a spread
between the two passes rather than as a difference between builds:

* K1 ``matmul_blockmax2_only`` at 512 x 1,000,448 x 768, sub 64, argmax and
  block maxima (``search_1m``'s pass, and ``search_1m_f32``'s under
  ``rescore``), on bf16, f32 and the int8 lattice; f32 also at sub 8 with
  block maxima at emit width 128 (the ``f32cert`` route's pass); bf16 also
  at sub 8 and 16 (P8/P9's and P1's), and K10 bf16 with the scores, unit
  argmax and second max at sub 16 (P3/P11's outputs);
* K3 ``matmul_blockmax`` at 256 x 100,352 x 768 (``search_100k``'s tile),
  bf16, f32 and int8; K5 at K1's shape, bf16 and f32;
* the int8 lattice at 1M x 768: K3 at 256 x 1,000,448 (the oracle's tile),
  K5 at K1's shape, K10 ``matmul_blockmax2x`` with the raw key (P12/P13's
  ``k1only``) at K1's shape, sub 128; and at 10,158,080 x 256 (P12/P13's
  store): K1 at sub 128, block 1024, emit width 256 (K10's row-tile walk),
  K3 at 256 queries, K5 and K10's raw key;
* K2 ``gather_rescore`` at 512 queries x KS 100 units of 64 rows of the 1M
  store (the full gather) and at KS 4 (the argmax fast path's danger
  gather), bf16, f32 and int8; bf16 at 104 units of 16 rows (P20's V16);
  f32 at KS 192 units of 8 rows (P23's);
* K6 ``block_scores`` on 512 x 2,048 gathered rows, bf16 and f32 (the
  ``f32cert`` route's: 256 units of 8 rows), with ``torch.bmm`` of the same
  f32 rows timed as one more case (the same call in every build's turn); K12
  ``gather_rescore_mm`` at V16 without a product and with 8 copies of a
  512 x 1,280 product; K13 ``gather_cross`` at P17's 1m S 16 G 2.

Stores are normalized random rows from ``--seed``; ids are random and
sorted per query, as the prototypes draw them. Each line prints one kernel
with every build's two times (``--only`` keeps the cases whose label holds
one of its values; it may be given more than once). Then each case's
outputs of every build against the first build's, bit for bit (an int8
score is an exact integer dot, an f32 score one FMA chain in a fixed order
and a bf16 score one k16 product per step, ``wgmma`` or ``mma.sync``, added
in a fixed order, so every build that keeps the rules must agree); for each
build, the error of K3's bf16
scores (256 x 100,352 x 768) against the float64 product of the same
operands, on unit queries (the search path's) and on raw normal queries
(the prototypes' data, whose scores run to ~5): max and mean, and the max
difference from the plain version's f32 product, whose own error is
printed beside it — what decides an arithmetic change, where the times
decide a geometry. With ``--routes``, the engine itself on every build in
turn (its library swapped in under :func:`.._build.library`): ``search_device``
queries/sec of the two f32 routes, ``rescore`` and ``f32cert``, on
``search_1m_f32``'s store and of ``rescore`` on ``search_1m``'s bf16 store
and ``search_1m_int8``'s lattice (1M x 768, 1024 queries, k 100), and
whether every build returns the first build's ids and scores bit for bit. The last
lines are the ptxas report of each build's bf16, f32 and int8 kernel bodies
(registers, spills) and the card's name and power limit. Needs a CUDA card; ``chip_smoke.py`` holds each kernel to its
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build

OUT = _build.BUILD_DIR.parent / "ab"
ITERS = 5
R1, N1, D1 = 1_000_448, 1_000_000, 768
R3 = 100_352
R10, N10, D10 = 10_158_080, 10_000_000, 256
T = 512
CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TREE_SOURCE = _build.SOURCES["topk"][0]
HERE = Path(__file__).parent


def _splice(src: str, block: str, dtype: str = "int8") -> str:
    """``src`` with its ``dtype`` (int8 or bf16) score-tile block, between
    its begin and end markers, replaced by ``block``."""
    begin = f"// ==== {dtype} score tile: begin"
    end = f"// ==== {dtype} score tile: end ====\n"
    a = src.index(begin)
    b = src.index(end) + len(end)
    return src[:a] + block + src[b:]


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant edit does not apply once: {old!r}")
    return src.replace(old, new)


#: The wgmma tile's two TMA loads of a slab (the store's, the queries').
_TMA_LOADS = """\
          mbar_expect_tx(&full[stage], WG_STAGE_BYTES);
          tma_load_2d(rs, &maps.shard, s * F, row0, &full[stage]);
          tma_load_2d(qs, &maps.q, s * F, q0, &full[stage]);"""

def _f32_nt256(src: str) -> str:
    """The f32 tile at 256 threads of 8 x 8 accumulators (two warps side by
    side along the queries)."""
    src = _edit(src, "constexpr int F32_NT = 128;", "constexpr int F32_NT = 256;")
    return _edit(src, "constexpr int F32_WQ = 1;", "constexpr int F32_WQ = 2;")



def _g_ring(src: str, stages: int, blocks: int) -> str:
    """The gather mainloop (K2, K6) with a ring of ``stages`` slabs at
    ``blocks`` blocks an SM."""
    src = _edit(src, "constexpr int G_STAGES = 6;", f"constexpr int G_STAGES = {stages};")
    return _edit(src, "constexpr int G_MIN_BLOCKS = 2;",
                 f"constexpr int G_MIN_BLOCKS = {blocks};")


def _g_tile(src: str, rows: int) -> str:
    """The gather mainloop with ``rows`` candidate rows (and threads) a
    block."""
    return _edit(src, "constexpr int G_TILE = 128;", f"constexpr int G_TILE = {rows};")


def _g_sb(src: str, nbytes: int) -> str:
    """The gather mainloop with slabs of ``nbytes`` bytes a row."""
    return _edit(src, "constexpr int G_SB = 128;", f"constexpr int G_SB = {nbytes};")


def _g_bulk_prefetch(src: str, slabs: int) -> str:
    """The gather mainloop with, every ``slabs`` slabs, one bulk L2 prefetch
    a row of its next ``slabs`` slabs past those (16-byte path)."""
    return _edit(src, "    } else if (width == 4) {\n", f"""\
      if (s % {slabs} == 0 && src[tid] != nullptr && b0 + {slabs} * G_SB < row_bytes) {{
        const int n = min({slabs} * G_SB, row_bytes - b0 - {slabs} * G_SB);
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n"
                     ::"l"(src[tid] + b0 + {slabs} * G_SB), "r"(n) : "memory");
      }}
    }} else if (width == 4) {{
""")


#: The gather mainloop's 16-byte copy, which asks L2 for the aligned 256
#: bytes around each piece, and the plain copy.
_G_COPY16_L2 = "cp_async16_l2_or_zero(st + r * G_PITCH + b, in ? p + b0 + b : q_row, in);"
_G_COPY16 = "cp_async16_or_zero(st + r * G_PITCH + b, in ? p + b0 + b : q_row, in);"


#: The f32 tile's query fragment load, and a stand-in that takes the
#: fragment from the rows' registers (wrong scores, a third of the loads).
_F32_QLOAD = """\
        const float4 v =
            *reinterpret_cast<const float4*>(qs + F32_LQ * (F32_QG * h + j) * F32_SLD + 4 * g);"""
_F32_QREG = """\
        const float4 v = make_float4(rv[(F32_QG * h + j) % MR][0], rv[(F32_QG * h + j) % MR][1],
                                     rv[(F32_QG * h + j) % MR][2], rv[j][3]);"""


def _bf16_phases(src: str) -> str:
    """The bf16 tile with each block's consumer thread 0 reading clock64 at
    the tile's start, when its first slab has landed, at the end of its k
    loop and at the tile's end, summed over the blocks into a device array
    that ``bsr_tile_phases`` reads (and zeroes): the tile's prologue, k loop
    and drain in SM cycles (:func:`phase_lines`)."""
    src = _edit(src, "template <typename T, bool RAW, int LD>\n"
                "__device__ __forceinline__ void score_tile_wg(",
                "__device__ unsigned long long g_phase[4];\n\n"
                "template <typename T, bool RAW, int LD>\n"
                "__device__ __forceinline__ void score_tile_wg(")
    src = _edit(src, "  const int tid = threadIdx.x, warp = warp_index(), lane = tid & 31;\n",
                "  const int tid = threadIdx.x, warp = warp_index(), lane = tid & 31;\n"
                "  long long ph0 = clock64(), ph1 = 0, ph2 = 0;\n")
    src = _edit(src, "      mbar_wait(&full[stage], (s / WG_STAGES) & 1);\n",
                "      mbar_wait(&full[stage], (s / WG_STAGES) & 1);\n"
                "      if (s == 0) ph1 = clock64();\n")
    src = _edit(src, '    asm volatile("bar.sync 1, %0;\\n" ::"n"(WG_CONSUMERS) : "memory");\n',
                '    ph2 = clock64();\n'
                '    asm volatile("bar.sync 1, %0;\\n" ::"n"(WG_CONSUMERS) : "memory");\n')
    src = _edit(src, "    if constexpr (BF) setmaxnreg_dec<BF16_LAUNCH_REGS>();  // the scores are in st\n"
                "  }\n  __syncthreads();\n}\n",
                "    if constexpr (BF) setmaxnreg_dec<BF16_LAUNCH_REGS>();  // the scores are in st\n"
                "  }\n  __syncthreads();\n"
                "  if (BF && tid == 0) {\n"
                "    const long long ph3 = clock64();\n"
                "    atomicAdd(&g_phase[0], (unsigned long long)(ph1 - ph0));\n"
                "    atomicAdd(&g_phase[1], (unsigned long long)(ph2 - ph1));\n"
                "    atomicAdd(&g_phase[2], (unsigned long long)(ph3 - ph2));\n"
                "    atomicAdd(&g_phase[3], 1ull);\n"
                "  }\n}\n")
    return _edit(src, "const char* bsr_error_string(int err) {",
                 "int bsr_tile_phases(unsigned long long* out) {\n"
                 "  cudaMemcpyFromSymbol(out, g_phase, sizeof g_phase);\n"
                 "  const unsigned long long zero[4] = {0, 0, 0, 0};\n"
                 "  cudaMemcpyToSymbol(g_phase, zero, sizeof zero);\n"
                 "  return (int)cudaGetLastError();\n"
                 "}\n\n"
                 "const char* bsr_error_string(int err) {")


#: Variant name -> its source from the tree's source text (module
#: docstring).
VARIANTS = {
    "mma_sync": lambda src: _splice(src, (HERE / "i8_tile_mma_sync.cuh").read_text()),
    "bf16_mma_sync": lambda src: _splice(
        src, (HERE / "bf16_tile_mma_sync.cuh").read_text(), "bf16"),
    "bf16_n64": lambda src: _edit(src, "constexpr int BF16_N = 128;",
                                  "constexpr int BF16_N = 64;"),
    "bf16_n64_p4": lambda src: _edit(_edit(src, "constexpr int BF16_N = 128;",
                                           "constexpr int BF16_N = 64;"),
                                     "constexpr int BF16_PRODUCTS = 2;",
                                     "constexpr int BF16_PRODUCTS = 4;"),
    "bf16_one_product": lambda src: _edit(src, "constexpr int BF16_PRODUCTS = 2;",
                                          "constexpr int BF16_PRODUCTS = 1;"),
    "bf16_phases": _bf16_phases,
    "bf16_nomma": lambda src: _edit(
        src, "for (int i = 0; i < LIVE + PROD - 1; ++i) {", "for (int i = 0; i < 0; ++i) {"),
    "bf16_noadd": lambda src: _edit(
        src, "      for (int e = 0; e < W; ++e)\n        acc[(j % NS) * W + e]",
        "      for (int e = 0; e < 1; ++e)\n        acc[(j % NS) * W + e]"),
    "noepi": lambda src: _edit(
        src, "  const int n = ((TR / sub) * TQ) << LG;\n", "  const int n = 0;\n"),
    "scalar_st": lambda src: _edit(src, "constexpr int WG_LD = LDO_I8;",
                                   "constexpr int WG_LD = LDO;"),
    "nosplit": lambda src: _edit(
        src, "  return columns * 2 <= NTH;", "  return false;"),
    "stages4": lambda src: _edit(src, "constexpr int WG_STAGES = 3;",
                                 "constexpr int WG_STAGES = 4;"),
    "noqload": lambda src: _edit(src, _TMA_LOADS, """\
          mbar_expect_tx(&full[stage], TR * SLAB_BYTES);
          tma_load_2d(rs, &maps.shard, s * F, row0, &full[stage]);"""),
    "nosload": lambda src: _edit(src, _TMA_LOADS, """\
          mbar_expect_tx(&full[stage], TQ * SLAB_BYTES);
          tma_load_2d(qs, &maps.q, s * F, q0, &full[stage]);"""),
    "f32_nt256": lambda src: _f32_nt256(src),
    "f32_nt256_one_block": lambda src: _edit(
        _f32_nt256(src), "constexpr int F32_MIN_BLOCKS = 2;",
        "constexpr int F32_MIN_BLOCKS = 1;"),
    "f32_stages3": lambda src: _edit(src, "constexpr int F32_STAGES = 2;",
                                     "constexpr int F32_STAGES = 3;"),
    "f32_slab_branch": lambda src: _edit(src, "    if ((s + 1) * F32_SK <= dpad)\n",
                                         "    if (false)\n"),
    "f32_sk48": lambda src: _edit(src, "constexpr int F32_SK = 32;",
                                  "constexpr int F32_SK = 48;"),
    "f32_noqload": lambda src: _edit(src, _F32_QLOAD, _F32_QREG),
    "f32_qg2": lambda src: _edit(src, "constexpr int F32_QG = 4;",
                                 "constexpr int F32_QG = 2;"),
    "f32_qg8": lambda src: _edit(src, "constexpr int F32_QG = 4;",
                                 "constexpr int F32_QG = 8;"),
    "g_stages4": lambda src: _g_ring(src, 4, 3),
    "g_no_l2": lambda src: _edit(src, _G_COPY16_L2, _G_COPY16),
    "g_tile64": lambda src: _g_ring(_g_tile(src, 64), 6, 4),
    "g_sb256": lambda src: _g_ring(_g_sb(src, 256), 3, 2),
    "g_t32_sb512": lambda src: _g_ring(_g_sb(_g_tile(src, 32), 512), 6, 2),
    "g_pf4": lambda src: _g_bulk_prefetch(src, 4),
}


def source_path(arg: str) -> Path:
    """A source argument as a file: ``@name`` writes variant ``name`` of the
    tree's source into :data:`OUT`."""
    if not arg.startswith("@"):
        return Path(arg)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{arg[1:]}.cu"
    path.write_text(VARIANTS[arg[1:]](TREE_SOURCE.read_text()))
    return path


def _score_tile_entry(line: str) -> bool:
    """bf16, int8 (``IaE``) and f32 (``IfE``) kernel bodies."""
    return "bfloat16" in line or "IaE" in line or "IfE" in line


def _entry_name(line: str) -> str:
    """A ptxas "Compiling entry" line's mangled kernel name, its anonymous
    namespace prefix (``_ZN<n>_GLOBAL__N__<file hash>``) dropped so that
    the kernel's name and template arguments fit in 40 characters."""
    name = line.split(chr(39))[1]
    name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", name)
    return name[:40]


def build(paths, library="topk", out=OUT, entry=_score_tile_entry):
    """``{name: (ctypes library, ptxas lines of the entries for which
    ``entry`` holds: the score-tile bodies, then the names of those whose
    wgmmas ptxas serialized)}``, one nvcc per source, all started together
    into ``out``, bound with the C signatures of the package's library
    ``library`` (an entry point an older source lacks is left unbound). A
    source that ``out`` already holds a build of, by the hash of its text
    and the nvcc flags, is loaded from there with its ptxas report."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, path in enumerate(paths):
        name = f"{i}:{Path(path).name}"
        key = hashlib.sha1(Path(path).read_bytes()
                           + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = out / f"ab_{Path(path).stem}_{key}.so"
        proc = None
        if not lib_path.with_suffix(".ptxas").exists():
            proc = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(path)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs[name] = (proc, lib_path)
    libs = {}
    for name, (proc, lib_path) in procs.items():
        log = lib_path.with_suffix(".ptxas")
        if proc is None:
            err = log.read_text()
        else:
            _out, err = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {name}:\n{err[-4000:]}")
            log.write_text(err)
        lines = err.splitlines()
        # after each entry: "Function properties", the spill line, "Used N
        # registers"
        report = [f"{_entry_name(ln)}: "
                  + "; ".join(x.split(":", 1)[-1].strip()[:60] for x in lines[i + 2:i + 4])
                  for i, ln in enumerate(lines)
                  if "Compiling entry" in ln and entry(ln)]
        serialized = sorted({_entry_name(f" '{ln.split(chr(39))[-2]}'")
                             for ln in lines if "serialized" in ln and chr(39) in ln})
        report.append("wgmma serialized in: " + (", ".join(serialized) or "none"))
        lib = ctypes.CDLL(str(lib_path))
        for fn, (restype, argtypes) in _build.SOURCES[library][1].items():
            if not hasattr(lib, fn):
                continue
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = (lib, report)
    return libs


def _unit(rows, dim, gen, dev):
    m = torch.randn((rows, dim), generator=gen, device=dev)
    return m / m.norm(dim=1, keepdim=True)


def _lattice(rows, dim, gen, dev, chunk=1 << 20):
    """Lattice rows (``round(127 x)`` of unit rows), made a chunk at a time."""
    out = torch.empty((rows, dim), dtype=torch.int8, device=dev)
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        out[r0:r0 + n] = (_unit(n, dim, gen, dev) * 127).round().to(torch.int8)
    return out


def _ids(gen, dev, n_units, ks):
    ids = torch.randint(0, n_units, (T, ks), generator=gen, device=dev)
    return torch.sort(ids, dim=1).values.to(torch.int32).contiguous()


def cases(seed):
    """``{label: (fn(lib) -> err, launches, outputs)}`` at the module
    docstring's shapes; ``outputs`` are the tensors a launch writes (int8
    cases only: checked across builds)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    mf = _unit(R1, D1, gen, dev)
    qf = mf[torch.randint(0, N1, (T,), generator=gen, device=dev)].contiguous()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    def k1(q, m, r, valid, sub, block, ew, iters, argmax=True):
        bms, bm = empty(r // sub, q.shape[0]), empty(r // ew, q.shape[0])
        key = empty(r // sub, q.shape[0], dtype=torch.int32) if argmax else None
        return (lambda lib: lib.bsr_matmul_blockmax2(
            q.data_ptr(), m.data_ptr(), CODES[m.dtype], q.shape[0], r, m.shape[1], valid,
            sub, ew, bms.data_ptr(), None if key is None else key.data_ptr(),
            bm.data_ptr(), stream()), iters, (bms, key, bm) if argmax else (bms, bm))

    def k3(q, m, valid, iters):
        r = m.shape[0]
        sims, bm = empty(q.shape[0], r), empty(r // 128, q.shape[0])
        return (lambda lib: lib.bsr_matmul_blockmax(
            q.data_ptr(), m.data_ptr(), CODES[m.dtype], q.shape[0], r, m.shape[1], valid,
            128, sims.data_ptr(), bm.data_ptr(), stream()), iters, (sims, bm))

    def k5(q, m, valid, iters):
        r = m.shape[0]
        bm = empty(r // 128, q.shape[0])
        return (lambda lib: lib.bsr_matmul_blockmax_only(
            q.data_ptr(), m.data_ptr(), CODES[m.dtype], q.shape[0], r, m.shape[1], valid,
            128, bm.data_ptr(), stream()), iters, (bm,))

    def k10_raw_key(q, m, valid, sub, iters):
        r = m.shape[0]
        bms = empty(r // sub, q.shape[0])
        raw = empty(r // sub, q.shape[0], dtype=torch.int32)
        scale = 1.0 / (127.0 * 127.0)
        return (lambda lib: lib.bsr_matmul_blockmax2x(
            q.data_ptr(), m.data_ptr(), 2, q.shape[0], r, m.shape[1], valid, sub, 0, 0,
            scale, None, bms.data_ptr(), None, None, raw.data_ptr(), None, stream()),
            iters, (bms, raw))

    def k10_bf16(q, m, valid, sub, iters):
        r = m.shape[0]
        sims = empty(r, q.shape[0])
        bms, m2 = empty(r // sub, q.shape[0]), empty(r // sub, q.shape[0])
        arg = empty(r // sub, q.shape[0], dtype=torch.int32)
        return (lambda lib: lib.bsr_matmul_blockmax2x(
            q.data_ptr(), m.data_ptr(), 1, q.shape[0], r, m.shape[1], valid, sub, 0, 0,
            1.0, sims.data_ptr(), bms.data_ptr(), arg.data_ptr(), m2.data_ptr(), None,
            None, stream()), iters, (sims, bms, arg, m2))

    for dt in (torch.bfloat16, torch.float32, torch.int8):
        if dt == torch.int8:
            q, m = (qf * 127).round().to(dt), (mf * 127).round().to(dt)
        else:
            q, m = qf.to(dt), mf.to(dt)
        code, tag = CODES[dt], str(dt)[6:]
        out[f"K1 {tag}"] = k1(q, m, R1, N1, 64, 128, 128, 3)
        if dt == torch.float32:
            out["K1 float32 sub 8, ew 128"] = k1(q, m, R1, N1, 8, 128, 128, 3,
                                                 argmax=False)
        if dt == torch.bfloat16:
            for sub in (8, 16):
                out[f"K1 bfloat16 sub {sub}"] = k1(q, m, R1, N1, sub, 128, 128, 3)
            out["K10 bfloat16 sims + arg + m2, sub 16"] = k10_bf16(q, m, N1, 16, 2)
        ids = _ids(gen, dev, R1 // 64, 100)
        for ks in (100, 4):
            k2_ids = ids[:, :ks].contiguous()
            sc = empty(T, ks * 64)
            out[f"K2 {tag} KS {ks}"] = (
                lambda lib, q=q, m=m, code=code, ids=k2_ids, ks=ks, sc=sc:
                lib.bsr_gather_rescore(q.data_ptr(), m.data_ptr(), ids.data_ptr(), code, T,
                                       R1, D1, ks, 64, sc.data_ptr(), stream()),
                ITERS if ks == 100 else 2 * ITERS, (sc,))
        q3, m3 = q[:256].contiguous(), m[:R3].contiguous()
        out[f"K3 {tag}"] = k3(q3, m3, 100_000, 2 * ITERS)
        if dt == torch.int8:
            out["K3 int8 1M"] = k3(q3, m, N1, 2)
            out["K5 int8"] = k5(q, m, N1, 3)
            out["K10 int8 raw key, sub 128"] = k10_raw_key(q, m, N1, 128, 3)
            continue
        out[f"K5 {tag}"] = k5(q, m, N1, 3)
        # K6 over 256 gathered 8-row units a query (the f32cert route's)
        ids8 = _ids(gen, dev, R1 // 8, 256).long()
        gathered = m[(ids8[:, :, None] * 8 + torch.arange(8, device=dev))
                     .reshape(T, -1)].contiguous()
        sc6 = empty(T, 2048)
        out[f"K6 {tag} C 2048"] = (
            lambda lib, q=q, g=gathered, code=code, sc=sc6: lib.bsr_block_scores(
                q.data_ptr(), g.data_ptr(), code, T, 2048, D1, sc.data_ptr(), stream()),
            ITERS, (sc6,))
        if dt == torch.float32:
            bmm = empty(T, 2048, 1)
            out["K6 float32 C 2048: torch.bmm (library)"] = (
                lambda lib, g=gathered, qc=q[:, :, None], o=bmm:
                torch.bmm(g, qc, out=o) is None, ITERS, (bmm,))
            ids_p23 = _ids(gen, dev, R1 // 8, 192)
            sc23 = empty(T, 192 * 8)
            out["K2 float32 KS 192 unit 8 (P23)"] = (
                lambda lib, q=q, m=m, ids=ids_p23, sc=sc23: lib.bsr_gather_rescore(
                    q.data_ptr(), m.data_ptr(), ids.data_ptr(), 0, T, R1, D1, 192, 8,
                    sc.data_ptr(), stream()), ITERS, (sc23,))
        del gathered
        if dt != torch.bfloat16:
            continue
        qb, mb = q, m
        ids16 = _ids(gen, dev, R1 // 16, 104)
        sc16 = empty(T, 104 * 16)
        out["K2 bf16 unit 16 KS 104"] = (lambda lib: lib.bsr_gather_rescore(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), 1, T, R1, D1, 104, 16,
            sc16.data_ptr(), stream()), ITERS, (sc16,))
        mmo0 = empty(T, 1)
        out["K12 V16, no product"] = (lambda lib: lib.bsr_gather_rescore_mm(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), T, R1, D1, 104, 16,
            qb.data_ptr(), mb.data_ptr(), T, 128, 0, sc16.data_ptr(), mmo0.data_ptr(),
            stream()), ITERS, (sc16,))
        mmo = empty(T, 10)
        out["K12 V16, 8 copies of 512 x 1280"] = (lambda lib: lib.bsr_gather_rescore_mm(
            qb.data_ptr(), mb.data_ptr(), ids16.data_ptr(), T, R1, D1, 104, 16,
            qb.data_ptr(), mb.data_ptr(), T, 1280, 8, sc16.data_ptr(), mmo.data_ptr(),
            stream()), ITERS, (sc16, mmo))
        idsx = _ids(gen, dev, R1 // 16, 100)
        scx = empty(50, T, 256)
        out["K13 S 16 G 2"] = (lambda lib: lib.bsr_gather_cross(
            qb.data_ptr(), mb.data_ptr(), idsx.data_ptr(), T, R1, D1, 100, 16, 2,
            scx.data_ptr(), stream()), ITERS, (scx,))
    del mf
    # the 10M x 256 int8 lattice store of P12/P13
    m10 = _lattice(R10, D10, gen, dev)
    q10 = m10[torch.randint(0, N10, (T,), generator=gen, device=dev)].contiguous()
    out["K1 int8 10M x 256, sub 128, ew 256"] = k1(q10, m10, R10, N10, 128, 1024, 256, 2)
    out["K3 int8 10M x 256"] = k3(q10[:256].contiguous(), m10, N10, 1)
    out["K5 int8 10M x 256"] = k5(q10, m10, N10, 2)
    out["K10 int8 raw key 10M x 256, sub 128"] = k10_raw_key(q10, m10, N10, 128, 2)
    return out


def same_outputs(libs, work):
    """One line per case: whether every build's outputs equal the first
    build's bit for bit."""
    lines = []
    names = list(libs)
    for label, (fn, _iters, outs) in work.items():
        if fn(libs[names[0]][0]):
            raise RuntimeError("a kernel launch failed")
        ref = [o.clone() for o in outs if o is not None]
        same = {}
        for name in names[1:]:
            for o in outs:
                if o is not None:
                    o.fill_(0)
            if fn(libs[name][0]):
                raise RuntimeError("a kernel launch failed")
            same[name] = all(torch.equal(a, b) for a, b in
                             zip(ref, (o for o in outs if o is not None)))
        torch.cuda.synchronize()
        lines.append(f"{label}: outputs bit for bit {names[0]}'s: " + "; ".join(
            f"{name} {ok}" for name, ok in same.items()))
    return lines


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


def route_rates(libs, seed, iters=3):
    """One line per route: ``search_device`` queries/sec of each build (two
    passes, in turns) on 1M x 768 stores, 1024 queries, k 100 — the f32
    routes ``rescore`` and ``f32cert`` on ``search_1m_f32``'s store, and
    ``rescore`` on ``search_1m``'s bf16 store and ``search_1m_int8``'s
    lattice — and whether every build's ids and scores equal the first
    build's bit for bit."""
    import time

    from ..config import SearchConfig
    from ..ops.engine import SearchEngine
    from ..store import DeviceStore

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 3)
    engines, queries = {}, {}
    for i, dtype in enumerate(("float32", "bfloat16", "int8")):
        store = DeviceStore.synthetic(N1, D1, dtype, seed + 2 + 3 * i, device="cuda")
        rows = torch.randint(0, N1, (1024,), generator=gen, device="cuda")
        qdev = store.data[rows].float()  # store rows (lattice rows on int8)
        engines[f"{dtype} rescore"] = SearchEngine(store, SearchConfig(top_k=100))
        queries[f"{dtype} rescore"] = qdev
        if dtype == "float32":
            engines["float32 f32cert"] = SearchEngine(store, SearchConfig(
                top_k=100, f32_certified="on"))
            queries["float32 f32cert"] = qdev
    for label, eng in engines.items():
        route = label.split()[1]
        assert eng.kernel_name(100) == route, (label, eng.kernel_name(100))
    names = list(libs)
    rates = {label: {name: [] for name in names} for label in engines}
    first, same = {}, {label: True for label in engines}
    saved = _build._LIBRARIES.get("topk")
    try:
        for name in names + names[::-1]:
            lib = libs[name][0]
            _build._LIBRARIES["topk"] = _build.KernelLibrary(lib, Path(lib._name), 0.0, "")
            for label, eng in engines.items():
                qdev = queries[label]
                out = eng.search_device(qdev, 100)
                torch.cuda.synchronize()
                ref = first.setdefault(label, out)
                same[label] &= all(torch.equal(a, b) for a, b in zip(out, ref))
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.search_device(qdev, 100)
                torch.cuda.synchronize()
                rates[label][name].append(1024 * iters / (time.perf_counter() - t0))
    finally:
        if saved is None:
            _build._LIBRARIES.pop("topk", None)
        else:
            _build._LIBRARIES["topk"] = saved
    return [f"route {label} search_device q/s (1M x 768, 1024 queries, k 100): "
            + "; ".join(f"{name} {' / '.join(f'{r:.1f}' for r in v)}"
                        for name, v in by.items())
            + f"; ids and scores bit for bit {names[0]}'s: {same[label]}"
            for label, by in rates.items()]


def phase_lines(libs, work):
    """For each build with ``bsr_tile_phases`` (``@bf16_phases``): the bf16
    tile's prologue (tile start to the first slab landed), k loop and drain
    (to the tile's end), SM cycles per tile, in one launch of each bf16 K1,
    K3 and K5 case."""
    lines = []
    for name, (lib, _report) in libs.items():
        if not hasattr(lib, "bsr_tile_phases"):
            continue
        lib.bsr_tile_phases.argtypes = [ctypes.c_void_p]
        out = (ctypes.c_ulonglong * 4)()
        for label, (fn, _iters, _outs) in work.items():
            if "bfloat16" not in label or not label.startswith(("K1", "K3", "K5")):
                continue
            torch.cuda.synchronize()
            lib.bsr_tile_phases(ctypes.addressof(out))
            fn(lib)
            torch.cuda.synchronize()
            lib.bsr_tile_phases(ctypes.addressof(out))
            n = max(out[3], 1)
            lines.append(f"tile phases {name} {label}: {out[3]} tiles; cycles a tile: prologue "
                         f"{out[0] / n:.0f}, k loop {out[1] / n:.0f}, drain {out[2] / n:.0f}")
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


def epilogue_share(times):
    """``K1 int8``'s share spent in its unit pass, from the tree's build and
    ``@noepi`` (best of each build's two passes), or None."""
    by = times.get("K1 int8", {})
    full = [v for name, v in by.items() if name.endswith(":topk_kernels.cu")]
    noepi = [v for name, v in by.items() if name.endswith(":noepi.cu")]
    if not (full and noepi):
        return None
    t_full, t_no = min(full[0]), min(noepi[0])
    return t_full, t_no, (t_full - t_no) / t_full


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+",
                    help="copies of topk_kernels.cu, or @variant names")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", action="append", default=[],
                    help="time only the cases whose label contains this "
                         "(repeatable: any of them)")
    ap.add_argument("--routes", action="store_true",
                    help="also time the f32 routes end to end on each build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_topk: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build([source_path(s) for s in args.sources])
    work = {label: case for label, case in cases(args.seed).items()
            if not args.only or any(o in label for o in args.only)}
    times = {label: {name: [] for name in libs} for label in work}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        for label, (fn, iters, _outs) in work.items():
            times[label][name].append(device_ms(lambda: fn(lib), iters))
    for label, by_build in times.items():
        print(f"{label}: " + "; ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms in v)} ms"
            for name, v in by_build.items()), flush=True)
    share = epilogue_share(times)
    if share is not None:
        print(f"K1 int8 epilogue (unit pass) share: {share[2]:.3f} "
              f"({share[0]:.4f} ms with it, {share[1]:.4f} without)", flush=True)
    for line in same_outputs(libs, work):
        print(line, flush=True)
    for line in phase_lines(libs, work):
        print(line, flush=True)
    for line in score_errors(libs, args.seed):
        print(line, flush=True)
    if args.routes:
        del work
        torch.cuda.empty_cache()
        for line in route_rates(libs, args.seed):
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
