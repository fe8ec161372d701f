"""Smoke run of the PyTorch port on one CUDA card: search, build, training
and serving paths.

    python3 chip_smoke.py        # from the repository root; needs one card

Builds the CUDA kernels from ``better_search_rag_rust_tpu_torch/ops/csrc``
(one nvcc per source, started together), then:

1. device: card name and power limit; kernel build times;
2. each search kernel (K1 matmul_blockmax2_only, K2 gather_rescore, K3
   matmul_blockmax; bf16 on the tensor cores) against its plain PyTorch
   version at the search path's shapes (a 1M x 768 store,
   nomic-embed-text-v1.5's width, queried 512 at a time, top-100), max
   |diff| <= 1e-5 (the plain versions sum in cuBLAS's f32 order, not the
   kernels' mma.sync k16 steps);
3. the search kernels against each other, bit for bit (one mma.sync
   instruction and one k16 order per bf16 score); the same identity on
   phase 4's 1M x 768 f32 store at the rescore pass's geometry (K1 sub 64
   with argmax; one exact FMA chain per f32 score), K1's maxima and keys on
   its first 16,384 rows bit for bit ``fma_chain_scores`` (the chain
   computed exactly in float64), and K1 f32's time there beside its bound
   and ``torch.matmul``; K3 f32 at the dense route's tile (256 x 100,352 x
   768) against its plain version, and its time;
4. the search path — Pipeline.engine + evaluate (1024 queries, k=100: MRR,
   recall@k and oracle overlap must be 1.0) + three search_stream batches —
   on a 1M x 768 bf16 store (route rescore: K1 + K2), a 100k x 768 bf16
   store (route global: K3) and a 1M x 768 f32 store (route rescore; its
   ids and distances bit for bit ``oracle_topk``'s), with every kernel's
   launch count over that run;
5. timings: queries/sec of search and search_device on the 1M bf16 store,
   a torch.profiler split of one 512-query tile of search_device (K1, K2,
   glue, device idle), and each search kernel's time beside its plain
   version's;
6. K8 fused_attention_qkv against its plain version at the encoder's shape
   (B=256, S=512, H=12, hd=64, bf16; per-row key padding, one row fully
   padded): max |diff| < 0.02 and cosine > 0.999 on valid query rows, the
   padded row finite; the kernel's and the plain version's error against
   a float64 evaluation of the same function (``bench/ab_attn.py``'s
   ``reference64``: max, mean and the count of cells off its bf16 value,
   on valid rows); kernel and plain times;
7. the NomicBERT encoder at full width (12 layers, 768 hidden, random
   weights from ``--seed``) on 256 x 512 tokens: the K8 forward against the
   plain f32-logit attention forward, per-row cosine >= 0.999; files/s of
   both; K8's share of the forward's device time (torch.profiler);
8. build mode end to end on a seeded 4096-file Java tree: Pipeline.run()
   with the nomic backend (ingest, shard, merge, device store, search),
   then evaluate (oracle overlap 1.0) and query() on 8 files (ids equal the
   oracle's); the same tree with the hash backend (MRR = recall = overlap =
   1.0); ingest files/s, the report's phase times and K8's launch count;
9. K9 fused_attention_qkv_bwd against its plain version at the training
   shape (B=64, S=512, H=12, hd=64, bf16; per-row key padding, one row
   fully padded): cosine >= 0.999 and max |diff| <= 1e-2 x max |plain| for
   each of dq, dk and dv, all finite, two launches bitwise equal; the
   kernel's and the plain version's error against a float64 evaluation
   (``bench/ab_attn.py``'s ``reference64_bwd``); kernel and plain times;
10. the contrastive trainer at full width (12 x 768, random weights from
   ``--seed``): at B=8 x 512 tokens the K8 + K9 parameter gradients against
   the plain f32-logit attention's, per-parameter cosine > 0.99; then the
   ``finetune`` measurement (bench/finetune.py) at B=64 x 512: 3 warm-up
   steps and 3 timed windows of 8, files/s, steps/s, peak memory, a finite
   loss and exactly 24 K9 launches per step (2 towers x 12 layers); a
   torch.profiler split of one step into K8, K9, GEMMs and the rest;
11. ``cli.main(["finetune", ...])`` on phase 8's tree (4 steps of 64 pairs,
   ``--save-dir``): the checkpoint reloads bit for bit equal to the
   trainer's parameters;
12. the int8 bodies of K1 (sub 64, argmax and block emission), K2 (KS 4
   and 100) and K3 (256 queries) against their plain versions on a 1M x 768
   int8 lattice store: max |diff| 0 and equal packed keys (an int8 score is
   an exact integer dot times one constant), the argmax identity bit for
   bit — K1 and K3 on the s8 tensor cores (wgmma fed by TMA), K2 on dp4a,
   so two instructions are held to each other — kernel and plain times;
   then K1 (emit width 128 and 256), K3, K5 and K10 (scores, arg, raw key)
   on int8 operands at the tile's edge cases (D 99 and 100, which the
   producer warp stages itself; 256 and 768 on TMA; D 1040 with rows mostly
   -128; 768-d rows one byte off alignment), 200 queries x 2048 rows with
   the last 37 masked, bit for bit their plain versions;
13. the engine on ``search_1m_int8`` and ``search_10m_int8`` (1M and 10M x
   768 int8, 1024 queries, k=100) as in phase 4: route rescore, MRR, recall
   and oracle overlap 1.0, int8 launch counts over that run, q/s of search
   and search_device;
14. ``bench/serve.py`` at the ``serve_open`` shape (64 clients x 8
   outstanding, 2 ms window, depth 2) on the 1M x 768 bf16 store and, with
   32 requests per client, the 10M x 768 int8 store: every request answered
   and equal to ``engine.search`` of its query; where the time goes in one
   served batch of 512 queries (torch.profiler against wall clock);
15. CLI ``serve --port 0 --serve-window-ms 2 --snapshot`` as a subprocess on
   phase 8's nomic store with two TCP connections; 16 files edited, 8
   deleted and 8 added, CLI ``update`` (nomic on K8), ``reload``: 4096
   rows, every edited and added file at rank 1, no deleted file answered;
   a second start restores from the snapshot and answers identically;
16. the certified f32 route (``SearchConfig(f32_certified="on")``) on a 1M x
   768 f32 store (``search_1m_f32``), 1024 queries, k=100: route
   ``f32cert``, ids equal to ``oracle_topk``'s bit for bit, MRR, recall@k
   and oracle overlap 1.0, the certified share of query tiles; a store of
   one 64-row block repeated, on which the certificate fails and the dense
   branch (K3) answers, equal to the oracle; K4 ``gather_rows`` against its
   plain version bit for bit on f32, bf16 and int8 rows (and its 0xFF fill
   for out-of-range ids); K6 ``block_scores`` over K4's rows bit for bit
   K3's and K2's scores of the same pairs, against its plain version within
   1e-5 (bit for bit on int8); K1 at the route's 8-row units, its maxima
   on the first 16,384 rows bit for bit ``fma_chain_scores``; search and
   search_device q/s of ``f32cert`` beside ``rescore`` on the same store;
   launch counts of K1, K4, K6 and K3 over the phase;
17. K5 ``matmul_blockmax_only`` (block maxima without the score matrix) on
   1M x 768 bf16, f32 and int8 stores at T 512 (1,000,000 valid rows of
   1,000,448, so the PAD_SIM mask bites): bit for bit K3's ``bm_t`` on all
   three, against its plain version within 1e-5 (0 on int8), f32's on the
   first 16,384 rows bit for bit ``fma_chain_scores``; on a
   10,027,008 x 256 bf16 store (10M valid rows) against its plain version
   and, on its first 1,048,576 rows, bit for bit K3's; then ``python -m
   better_search_rag_rust_tpu_torch.bench.proto_calib`` (the K5
   measurements of the TPU record) as a subprocess, rc 0;
18. K7 ``fused_attention`` (head-major) at B 256, H 12, S 512, hd 64 with a
   padded key bias: against its plain version and float64 as K8 in phase 6,
   and on the transposed Wqkv output bit for bit K8's (tolerance 0); then ``python -m
   better_search_rag_rust_tpu_torch.bench.proto_attn`` (chain, K8, K7 with
   its transposes) as a subprocess, rc 0;
19. the measurement path: ``BENCH_SUITE=search_100k python3 bench_torch.py``
   (its line: recall@10 and oracle overlap 1.0, ``mfu_peak_tflops`` set) and
   CLI ``bench --suite search_100k --json --profile-dir`` (the trace names
   K3's kernel) as subprocesses; ``run_suite`` of ``pipeline``, ``encode``
   and ``jabref`` in this process (K3 and K8 launched); an empty query batch
   on the ``global``, ``rescore`` and ``f32cert`` routes through every
   engine entry point. A suite result with an ``error`` fails the run;
20. the block-max prototypes P1-P16 of ``scripts/proto_*.py`` through
   ``bench/proto_blockmax.py``'s functions at each script's own shapes
   (stores of 16,384 to 10,158,080 rows from ``--seed``; raw int8 in
   [-127, 127] for ``proto_int8``): each against its plain version within
   1e-5 (0 on int8, integer outputs equal), K10 ``matmul_blockmax2x``
   among them; kernel against kernel bit for bit — K10's unit and coarse
   maxima K1's, its scores K3's transposed, its ``arg`` K1's ``key &
   0x7F`` and ``(arg, m2)`` K1's packed key, its raw int8 key K1's argmax;
   K1 at (sub 128, block 1024, emit width 256) on the 10,158,080 x 256
   int8 store equal to its plain version; K10's time at ``bm2_v3``'s shape;
   then ``python -m better_search_rag_rust_tpu_torch.bench.proto_blockmax``
   (every timed case of the ten scripts) as a subprocess, each kernel
   launched;
21. the DMA gather prototypes P18-P21 of ``scripts/proto_dma_rescore.py``,
   ``proto_dma2.py`` and ``proto_dma3.py`` through ``bench/proto_dma.py``'s
   functions at the scripts' shapes, on phase 20's 10,027,008 x 256 and
   1,048,576 x 768 bf16 stores (P19 on a view of the first 10,026,880 rows):
   each against its plain version (1e-5 on scores; K11 ``gather_copy`` bit
   for bit), K11 at or above its bytes bound and bit for bit K4's row 0,
   K12 ``gather_rescore_mm`` at ``mm_n`` 0, 512 and 1280 with its scores bit
   for bit K2's and its ``mmo`` K5's block maxima transposed, P18 and P20
   bit for bit K3's dense scores on the first 131,072 (65,536) rows, the
   index gather + K6 bit for bit K2; K12's time beside the gather alone
   (K12 at ``mm_n`` 0), the product alone (K5 once per copy; K12 without
   the gather) and their sum; then ``python -m
   better_search_rag_rust_tpu_torch.bench.proto_dma`` and ``...proto_calib``
   (its ``make_v3`` lines) as subprocesses, each kernel launched;
22. the fused two-level prototype P17 of ``scripts/proto_fused.py`` through
   ``bench/proto_fused.py``'s functions on phase 20's 1,001,472 x 768
   (1,000,448 valid) and 10,027,008 x 256 bf16 stores at the script's shapes
   (T 512, k 100, S 16/32 and 32/128, G 1/2/4): K13 ``gather_cross`` against
   its plain version within 1e-5 and its diagonal bit for bit K2 at unit S,
   the end-to-end values bit for bit K3's on the first 8,192 rows and the
   exact-index match 1.0 against the oracle on the first 131,072 rows; then
   ``python -m better_search_rag_rust_tpu_torch.bench.proto_fused`` as a
   subprocess, whose 1m S=16 G=2 case gives K13's times;
23. the certified f32 prototypes P22 and P23 of
   ``scripts/proto_f32_rescore.py`` and ``proto_f32_rescore2.py`` through
   ``bench/proto_f32.py``'s functions on one 1,015,808 x 768 f32 store built
   as the scripts build theirs: Q1's three arms bit for bit on the kernels'
   chain (the ``torch.matmul`` arms printed, not gated), Q2's K1 error
   within EPS1, the EPS2 check, every certified query of ``build_fast``,
   ``p2_192/256/320`` and ``p3_192/320`` equal to the oracle (K3) on 64
   queries; then ``python -m
   better_search_rag_rust_tpu_torch.bench.proto_f32`` as a subprocess, each
   kernel launched, which also holds K4 (P22) bit for bit its plain version
   and K2 f32 (P23) at KS 192 and 320 within 1e-5 of its plain version and
   bit for bit K6 on K4's rows;
24. the card exactness sweep of ``scripts/chip_exactness.py`` on bf16, on
   the int8 lattice and on f32: its five stores (``random_20k_768``,
   ``dups_64k_256``, ``all_dup_16k_128``, ``tall_300k_64``,
   ``dups_600k_768``, built from ``--seed`` as the script builds them),
   1024 queries each, k = 10 and 100, through the ``global`` route and
   ``rescore`` with the argmax fast path on and off wherever
   ``rescore_feasible`` allows, and on f32 ``f32cert``: ids and distances
   bit for bit ``oracle_topk``; every returned bf16 score within ``D *
   2^-23 * sum |q_d r_d|`` of the float64 product of the same bf16
   operands (``ops/topk_kernels.py:score_bound``), every returned int8
   score bit for bit the exact integer dot times ``INT8_INV_SCALE2``, every
   returned f32 score bit for bit ``fma_chain_scores``; K1 = K2 = K3 bit
   for bit on each store's (query, unit argmax) pairs. Prints its pass
   counts.

Every kernel's time is printed beside its plain version's, one PyTorch call
computing the same function where there is one (``library``: the product
alone for K1/K3/K5, ``scaled_dot_product_attention`` on rotated q/k/v for
K7/K8/K9, indexing for K4, ``bmm`` for K6; none for K2, K11, K12 and K13), and
its bound: the larger of the bytes it must move (a gather: the distinct
units it selects) over 3.35 TB/s and its operations (K12: every copy of
its product) over the named peak
(H100 SXM data sheet: 67 TFLOP/s fp32 SIMT for f32 stores, whose exact FMA
chain cannot use tensor cores; 989 bf16 and 1,979 int8 tensor).

Prints one line per phase, then the card line, the kernels JSON line and,
last, ``{"ok": true, "device": ...}``. Any failed check raises: the exit
code is non-zero and the last line is not printed. Stores, weights and the
tree are seeded (``--seed``); nothing is downloaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

K = 100
T = 512
SUB, BLOCK = 64, 128
TOL = 1e-5
#: store rows whose f32 kernel outputs are held to the exact chain
#: (fma_chain_scores runs D steps in float64 over T x CHAIN_ROWS pairs)
CHAIN_ROWS = 16_384
CSRC = "better_search_rag_rust_tpu_torch/ops/csrc/"
#: kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "matmul_blockmax2_only": (CSRC + "topk_kernels.cu",
                              "better_search_rag_rust_tpu/ops/topk_pallas.py:527"),
    "gather_rescore": (CSRC + "topk_kernels.cu",
                       "better_search_rag_rust_tpu/ops/topk_pallas.py:656"),
    "matmul_blockmax": (CSRC + "topk_kernels.cu",
                        "better_search_rag_rust_tpu/ops/topk_pallas.py:120"),
    "fused_attention_qkv": (CSRC + "attention_kernels.cu",
                            "better_search_rag_rust_tpu/ops/attention_pallas.py:177"),
    "fused_attention_qkv_bwd": (CSRC + "attention_kernels.cu",
                                "better_search_rag_rust_tpu/ops/attention_pallas.py:290"),
    # the int8 bodies: K1's int8 branch, and K2/K3 traced on int8 operands
    # (their scores through _sims_dot's int8 arm, topk_pallas.py:56)
    "matmul_blockmax2_only_int8": (CSRC + "topk_kernels.cu",
                                   "better_search_rag_rust_tpu/ops/topk_pallas.py:390"),
    "gather_rescore_int8": (CSRC + "topk_kernels.cu",
                            "better_search_rag_rust_tpu/ops/topk_pallas.py:656"),
    "matmul_blockmax_int8": (CSRC + "topk_kernels.cu",
                             "better_search_rag_rust_tpu/ops/topk_pallas.py:120"),
    "gather_rows": (CSRC + "topk_kernels.cu",
                    "better_search_rag_rust_tpu/ops/topk_pallas.py:747"),
    "block_scores": (CSRC + "topk_kernels.cu",
                     "better_search_rag_rust_tpu/ops/topk_pallas.py:846"),
    "matmul_blockmax_only": (CSRC + "topk_kernels.cu",
                             "better_search_rag_rust_tpu/ops/topk_pallas.py:222"),
    "fused_attention": (CSRC + "attention_kernels.cu",
                        "better_search_rag_rust_tpu/ops/attention_pallas.py:95"),
    # the block-max prototypes P3, P6, P7, P11, P12/P13 (k1only) and P14;
    # timed at bm2_v3's shape
    "matmul_blockmax2x": (CSRC + "topk_kernels.cu", "scripts/proto_bm3.py:176"),
    # P19's copy-only V0 and P21's gather beside a resident product
    "gather_copy": (CSRC + "topk_kernels.cu", "scripts/proto_dma2.py:72"),
    "gather_rescore_mm": (CSRC + "topk_kernels.cu", "scripts/proto_dma3.py:80"),
    # P17's fused cross scores; timed at 1m S=16 G=2 by bench/proto_fused.py
    "gather_cross": (CSRC + "topk_kernels.cu", "scripts/proto_fused.py:139"),
}
#: the encoder's shape: batch, sequence, heads, head width
B_ENC, S_ENC, H_ENC, HD_ENC = 256, 512, 12, 64
ATT_TOL, ATT_COS = 0.02, 0.999
TREE_FILES = 4096
#: the finetune shape (the JAX finetune suite's batch) and the smaller batch
#: at which the plain attention's gradients fit beside the kernels'
B_TRAIN, B_GRAD = 64, 8
BWD_REL, BWD_COS, GRAD_COS = 1e-2, 0.999, 0.99
TIMED_STEPS = 8
#: published H100 SXM rates (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"fp32 SIMT": 67e12, "bf16 tensor": 989e12,
            "int8 tensor": 1979e12}
PEAK_FOR = {torch.float32: "fp32 SIMT", torch.bfloat16: "bf16 tensor",
            torch.int8: "int8 tensor"}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timing(ms, plain_ms, lib_ms, moved_bytes, ops, peak):
    """A kernel's times beside its bound: the larger of ``moved_bytes``
    (each input read once, each output written once) over the memory rate
    and ``ops`` over the ``peak``'s rate."""
    t_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS[peak]
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "peak": peak}


def timing_line(name, rec) -> str:
    lib = rec["library_ms"]
    return (f"{name}: kernel {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f}"
            f" ms, library {'none' if lib is None else f'{lib:.3f} ms'}, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}; "
            f"{rec['peak']})")


def product_ms(q, rows):
    """The library yardstick of K1/K3 (one PyTorch call the port never
    makes): the score product alone."""
    if q.dtype == torch.int8:
        return cuda_ms(lambda: torch._int_mm(q, rows.T))
    return cuda_ms(lambda: torch.matmul(q, rows.T))


def phase(msg: str) -> None:
    print(msg, flush=True)


def check_kernels(store, store_100k, gen):
    """Phases 2 and 3: kernels against plain versions and each other."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    data, n = store.data, store.num_rows
    rows = torch.randint(0, n, (T,), generator=gen, device="cuda")
    q = data[rows].contiguous()
    errs, times = {}, {}

    def k1():
        return tk.matmul_blockmax2_only(q, data, n, sub=SUB, block=BLOCK,
                                        emit_block=True, emit_argmax=True)

    def k1_plain():
        return tk.matmul_blockmax2_only_plain(
            q, data, n, sub=SUB, block=BLOCK, emit_block=True,
            emit_argmax=True)

    bms, key, bm = k1()
    p_bms, p_key, p_bm = k1_plain()
    torch.cuda.synchronize()
    top2 = (q.float() @ data.float().T).T.reshape(-1, SUB, T).topk(2, dim=1)
    gap = top2.values[:, 0] - top2.values[:, 1]
    clear = gap > TOL
    arg_ok = torch.equal((key & 0x7F)[clear], (p_key & 0x7F)[clear])
    errs["matmul_blockmax2_only"] = max(max_abs(bms, p_bms), max_abs(bm, p_bm))
    phase(f"phase 2 K1 [{T} x {data.shape[0]} x {data.shape[1]}] sub={SUB}: "
          f"max|bm_sub-plain|={max_abs(bms, p_bms):.3g} "
          f"max|bm-plain|={max_abs(bm, p_bm):.3g} argmax equal on "
          f"{int(clear.sum())}/{clear.numel()} resolved units: {arg_ok}")
    assert errs["matmul_blockmax2_only"] <= TOL and arg_ok
    r, d = data.shape
    peak = PEAK_FOR[data.dtype]
    times["matmul_blockmax2_only"] = timing(
        cuda_ms(k1), cuda_ms(k1_plain), product_ms(q, data),
        nbytes(q, data, bms, key, bm), 2 * T * r * d, peak)
    del top2, gap, clear, p_bms, p_key, p_bm

    n_units = data.shape[0] // SUB
    errs["gather_rescore"] = 0.0
    for ks in (4, 100):
        ids = torch.sort(torch.randint(0, n_units, (T, ks), generator=gen,
                                       device="cuda"), dim=1).values
        ids = ids.to(torch.int32).contiguous()
        out = tk.gather_rescore(q, data, ids, unit=SUB)
        ref = tk.gather_rescore_plain(q, data, ids, unit=SUB)
        err = max_abs(out, ref)
        errs["gather_rescore"] = max(errs["gather_rescore"], err)
        ms = cuda_ms(lambda: tk.gather_rescore(q, data, ids, unit=SUB))
        pms = cuda_ms(lambda: tk.gather_rescore_plain(q, data, ids, unit=SUB))
        moved = nbytes(q, ids, out) + (torch.unique(ids).numel() * SUB * d
                                       * data.element_size())
        times[f"gather_rescore_ks{ks}"] = timing(
            ms, pms, None, moved, 2 * T * ks * SUB * d, peak)
        phase(f"phase 2 K2 KS={ks} unit={SUB}: max|out-plain|={err:.3g}")
        assert err <= TOL
    times["gather_rescore"] = times["gather_rescore_ks100"]

    # the dense route scores 256 queries per K3 launch (ops/engine.py)
    q100 = store_100k.data[rows[:256] % store_100k.num_rows].contiguous()
    sims, bm_t = tk.matmul_blockmax(q100, store_100k.data,
                                    store_100k.num_rows)
    p_sims, p_bm_t = tk.matmul_blockmax_plain(q100, store_100k.data,
                                              store_100k.num_rows)
    errs["matmul_blockmax"] = max(max_abs(sims, p_sims), max_abs(bm_t, p_bm_t))
    phase(f"phase 2 K3 [256 x {store_100k.data.shape[0]} x 768]: "
          f"max|sims-plain|={max_abs(sims, p_sims):.3g} "
          f"max|bm-plain|={max_abs(bm_t, p_bm_t):.3g}")
    assert errs["matmul_blockmax"] <= TOL
    times["matmul_blockmax"] = timing(
        cuda_ms(lambda: tk.matmul_blockmax(q100, store_100k.data,
                                           store_100k.num_rows)),
        cuda_ms(lambda: tk.matmul_blockmax_plain(q100, store_100k.data,
                                                 store_100k.num_rows)),
        product_ms(q100, store_100k.data),
        nbytes(q100, store_100k.data, sims, bm_t),
        2 * 256 * store_100k.data.shape[0] * d, peak)
    del sims, bm_t, p_sims, p_bm_t

    # phase 3: K2 at each unit's argmax row == K1's unit max == K3's score
    same, pairs = unit_identity(tk, q, data, n, bms, key, gen)
    phase(f"phase 3 identity on {pairs} (query, unit argmax) pairs: "
          f"K1 == K2 == K3 bitwise: {same}")
    assert same
    return errs, times


def unit_identity(tk, q, data, n, bms, key, gen=None):
    """K2 at each unit's argmax row == K1's unit max == K3's score, bit for
    bit, on 256 random valid units per query (K1/K3 mask padding rows to
    PAD_SIM, K2 does not mask); returns (same, pairs)."""
    t = q.shape[0]
    units = torch.sort(torch.randint(0, n // SUB, (t, 256), generator=gen,
                                     device="cuda"), dim=1).values
    resc = tk.gather_rescore(q, data, units.to(torch.int32).contiguous(),
                             unit=SUB).view(t, 256, SUB)
    arg = torch.gather((key & 0x7F).T.to(torch.int64), 1, units)
    k2_at_arg = torch.gather(resc, 2, arg[:, :, None])[:, :, 0]
    k1_max = torch.gather(bms.T, 1, units)
    sims, _ = tk.matmul_blockmax(q, data, n)
    k3_at_arg = torch.gather(sims, 1, units * SUB + arg)
    same = torch.equal(k2_at_arg, k1_max) and torch.equal(k3_at_arg, k1_max)
    return same, units.numel()


def chain_units(tk, q, data, sub):
    """K1's unit outputs (maxima, the packed key) that the exact FMA chain
    gives on the first CHAIN_ROWS rows of an f32 store (all valid)."""
    chain = tk.fma_chain_scores(q, data[:CHAIN_ROWS])
    bms, arg, m2 = tk._plain_units(chain.T.reshape(-1, sub, q.shape[0]), True)
    return chain, bms, tk.pack_m2_argmax_key(m2, arg)


def check_f32_rescore_pass(store, gen, card):
    """Phase 3 on phase 4's 1M x 768 f32 store: K1 at the rescore pass's
    geometry against the unit identity and the exact chain; its time."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    data, n = store.data, store.num_rows
    q = data[torch.randint(0, n, (T,), generator=gen, device="cuda")]

    def k1():
        return tk.matmul_blockmax2_only(q, data, n, sub=SUB, block=BLOCK,
                                        emit_block=True, emit_argmax=True)

    bms, key, bm = k1()
    same, pairs = unit_identity(tk, q, data, n, bms, key, gen)
    _, c_bms, c_key = chain_units(tk, q, data, SUB)
    u = CHAIN_ROWS // SUB
    chain_ok = (torch.equal(bms[:u], c_bms) and torch.equal(key[:u], c_key)
                and torch.equal(bm[:CHAIN_ROWS // BLOCK],
                                c_bms.view(-1, BLOCK // SUB, T).amax(dim=1)))
    phase(f"phase 3 f32 identity on {pairs} (query, unit argmax) pairs of "
          f"[{T} x {data.shape[0]} x {data.shape[1]}] f32, K1 sub {SUB} "
          f"argmax: K1 == K2 == K3 bitwise: {same}; K1's maxima, keys and "
          f"block maxima on the first {CHAIN_ROWS} rows bit for bit "
          f"fma_chain_scores: {chain_ok}")
    assert same and chain_ok
    rec = timing(cuda_ms(k1), cuda_ms(lambda: tk.matmul_blockmax2_only_plain(
        q, data, n, sub=SUB, block=BLOCK, emit_block=True, emit_argmax=True)),
        product_ms(q, data), nbytes(q, data, bms, key, bm),
        2 * T * data.shape[0] * data.shape[1], "fp32 SIMT")
    phase(f"phase 3 [{card}] " + timing_line(
        f"matmul_blockmax2_only f32 sub {SUB} argmax", rec))
    # K3 f32 at the dense route's tile (search_100k's geometry, on the
    # store's first 100,352 rows)
    rows, valid = data[:100_352], 100_000
    q3 = q[:256].contiguous()
    sims, bm_t = tk.matmul_blockmax(q3, rows, valid)
    p_sims, p_bm = tk.matmul_blockmax_plain(q3, rows, valid)
    err = max(max_abs(sims, p_sims), max_abs(bm_t, p_bm))
    assert err <= TOL, err
    del p_sims, p_bm
    rec = timing(cuda_ms(lambda: tk.matmul_blockmax(q3, rows, valid)),
                 cuda_ms(lambda: tk.matmul_blockmax_plain(q3, rows, valid)),
                 product_ms(q3, rows), nbytes(q3, rows, sims, bm_t),
                 2 * 256 * rows.shape[0] * rows.shape[1], "fp32 SIMT")
    phase(f"phase 3 [{card}] K3 f32 [256 x {rows.shape[0]} x {rows.shape[1]}]"
          f": max|out-plain|={err:.3g} (bound {TOL}); " + timing_line(
              "matmul_blockmax f32", rec))


def drive_main_path(name, store, cfg, gen, route, label="phase 4",
                    bitwise=False):
    """Phase 4 (or 13) on one store: engine, evaluate, three streamed
    batches; with ``bitwise``, the first batch's ids and distances equal
    ``oracle_topk``'s bit for bit."""
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(cfg, device="cuda")
    engine = pipe.engine(store)
    t0 = time.perf_counter()
    report = pipe.evaluate(num_queries=1024, k=K)
    eval_s = time.perf_counter() - t0
    assert engine.kernel_name(K) == route, engine.kernel_name(K)
    batches, truth = [], []
    for _ in range(3):
        rows = torch.randint(0, store.num_rows, (1024,), generator=gen,
                             device="cuda")
        batches.append(store.data[rows].float().cpu().numpy())
        truth.append(rows.cpu().numpy())
    streamed = list(engine.search_stream(batches, k=K, depth=2))
    self_hits = [float(np.mean(ids[:, 0] == t))
                 for (ids, _), t in zip(streamed, truth)]
    again, dists = engine.search(batches[0], K)
    oracle = ""
    if bitwise:
        o_ids, o_d = engine.oracle_topk(batches[0], K)
        same = np.array_equal(again, o_ids) and np.array_equal(dists, o_d)
        oracle = f"; ids and distances == oracle_topk bitwise: {same}"
        assert same
    phase(f"{label} {name}: route={engine.kernel_name(K)} "
          f"mrr={report['mrr']} recall@{K}={report['recall_at_k']} "
          f"oracle_overlap={report['oracle_overlap']} evaluate "
          f"{eval_s:.2f}s; 3 streamed batches self-hit@1={self_hits}"
          + oracle)
    assert report["mrr"] == report["recall_at_k"] == 1.0
    assert report["oracle_overlap"] == 1.0
    assert self_hits == [1.0, 1.0, 1.0]
    assert np.array_equal(again, streamed[0][0])
    return engine


def f64_error_line(label, out, plain, ref64, valid):
    """The kernel's and the plain version's error against the float64
    evaluation ``ref64`` [B, S, H*hd] on valid query rows."""
    ref = ref64[valid]
    ref_bf16 = ref.to(torch.bfloat16)

    def stats(x):
        got = x[valid]
        err = (got.double() - ref).abs()
        return (f"max {float(err.max()):.4g}, mean {float(err.mean()):.6g}, "
                f"{int((got != ref_bf16).sum())} of {got.numel()} cells off "
                f"its bf16 value")

    return f"{label} vs float64: kernel {stats(out)}; plain {stats(plain)}"


def check_attention(gen):
    """Phase 6: K8 against its plain version at the encoder's shape."""
    from better_search_rag_rust_tpu_torch.bench.ab_attn import reference64
    from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = B_ENC, S_ENC, H_ENC, HD_ENC
    qkv = torch.randn((b, s, 3 * h * hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0                                   # one fully padded row
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32).contiguous()
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_tables(s, hd, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    scale = 1.0 / math.sqrt(hd)

    def kern():
        return ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)

    def plain():
        return ak.fused_attention_qkv_plain(qkv, c2, s2, bias, h, scale)

    out, ref = kern(), plain()
    torch.cuda.synchronize()
    a, r = out.float()[valid], ref.float()[valid]
    err = max_abs(a, r)
    cos_sim = float((a * r).sum() / (a.norm() * r.norm()))
    padded_finite = bool(torch.isfinite(out[-1].float()).all())
    phase(f"phase 6 K8 [{b} x {s} x {h} heads x {hd}] bf16: max|out-plain| "
          f"on valid rows={err:.4g} (bound {ATT_TOL}), cosine={cos_sim:.7f} "
          f"(bound {ATT_COS}), fully padded row finite: {padded_finite}")
    assert err < ATT_TOL and cos_sim > ATT_COS and padded_finite
    phase("phase 6 " + f64_error_line(
        "K8", out, ref, reference64(qkv, c2, s2, bias, h, scale), valid))
    qr, kr, vr, mask = _rotated_qkv(qkv, c2, s2, bias, h)
    times = timing(
        cuda_ms(kern), cuda_ms(plain),
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask, scale=scale)),
        nbytes(qkv, c2, s2, bias, out), 4 * b * h * s * s * hd,
        "bf16 tensor")
    del qkv, out, ref, a, r, qr, kr, vr
    return err, times


def _rotated_qkv(qkv, c2, s2, bias, h):
    """Rotated q, k and v ``[B, H, S, hd]`` in qkv's dtype, and the key
    bias as an additive mask: the operands of the library yardstick of
    K8/K9 (rotary excluded from its time)."""
    b, s, width = qkv.shape
    hd = width // (3 * h)
    x = qkv.view(b, s, 3, h, hd).permute(2, 0, 3, 1, 4)

    def rot(t):
        tf = t.float()
        return (tf * c2 + torch.roll(tf, hd // 2, dims=-1) * s2).to(
            qkv.dtype).contiguous()

    mask = bias[:, None, None, :].to(qkv.dtype)
    return rot(x[0]), rot(x[1]), x[2].contiguous(), mask


def _device_profile(fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    ({"K8": ms, "K9": ms, "GEMMs": ms, "rest": ms}, total ms, [(ms, kernel)]
    longest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            rows.append((us / 1e3, evt.key))
    rows.sort(reverse=True)
    split = {
        "K8": sum(ms for ms, key in rows if "k8_fused_attention_qkv" in key),
        "K9": sum(ms for ms, key in rows
                  if "k9_bwd_" in key or "k9_rotate_k" in key),
        "GEMMs": sum(ms for ms, key in rows
                     if not key.startswith(("k8_", "k9_")) and any(
                         w in key.lower()
                         for w in ("gemm", "nvjet", "xmma", "cutlass"))),
    }
    total = sum(ms for ms, _ in rows)
    split["rest"] = total - sum(split.values())
    return split, total, rows


def check_encoder(seed, card):
    """Phase 7: the full-width encoder, K8 forward vs plain attention."""
    from better_search_rag_rust_tpu_torch.models.nomic import (
        NomicBertConfig,
        NomicEncoder,
    )

    cfg = NomicBertConfig()
    fused = NomicEncoder(cfg, seed=seed, device="cuda")
    plain = NomicEncoder(NomicBertConfig(attention_impl="xla"),
                         state_dict=fused.model.state_dict(), device="cuda")
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size,
                       size=(B_ENC, S_ENC)).astype(np.int32)
    lens = rng.integers(S_ENC // 8, S_ENC + 1, size=B_ENC)
    mask = (np.arange(S_ENC)[None, :] < lens[:, None]).astype(np.int32)
    ids_d = torch.from_numpy(ids).cuda()
    mask_d = torch.from_numpy(mask).cuda()
    a = fused.encode_tokens(ids, mask)
    b = plain.encode_tokens(ids, mask)
    cos = np.sum(a * b, axis=1)
    rates = {}
    for name, enc in (("K8", fused), ("plain", plain)):
        rates[name] = B_ENC / (cuda_ms(
            lambda: enc.encode_tokens_device(ids_d, mask_d)) / 1e3)
    split, total, top = _device_profile(
        lambda: fused.encode_tokens_device(ids_d, mask_d))
    k8, gemm, rest = split["K8"], split["GEMMs"], split["rest"]
    phase(f"phase 7 [{card}] encoder 12 x 768, {B_ENC} x {S_ENC} tokens: "
          f"per-row cosine K8 vs plain attention min={cos.min():.6f} (bound "
          f"{ATT_COS}); forward {rates['K8']:.1f} files/s on K8, "
          f"{rates['plain']:.1f} files/s plain")
    phase(f"phase 7 [{card}] forward device time {total:.2f} ms: K8 "
          f"{k8:.2f} ms ({100 * k8 / total:.1f} %), GEMMs {gemm:.2f} ms "
          f"({100 * gemm / total:.1f} %), rest {rest:.2f} ms "
          f"({100 * rest / total:.1f} %); top kernels: "
          + "; ".join(f"{key[:60]} {ms:.2f}" for ms, key in top[:6]))
    assert np.isfinite(a).all() and a.shape == (B_ENC, 768)
    assert cos.min() >= ATT_COS, cos.min()
    del fused, plain


def drive_build_mode(tmp, src, seed, card):
    """Phase 8: Pipeline.run() in build mode (nomic, then hash) on the tree
    ``src``, evaluate and text queries; returns the K8 launches of the
    nomic run."""
    from better_search_rag_rust_tpu_torch.config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline

    k8_launches = 0
    for backend in ("nomic", "hash"):
        cfg = PipelineConfig(
            corpus=CorpusConfig(root=src, extensions=("java",),
                                files_per_batch=256),
            encoder=EncoderConfig(backend=backend, batch_size=256),
            store=StoreConfig(dir=os.path.join(tmp, backend)),
            search=SearchConfig(top_k=K, store_dtype="bfloat16"),
        )
        pipe = Pipeline(cfg, device="cuda", seed=seed)
        pipe.encoder.get_embeddings(["warm up the forward"])
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        ak.reset_launch_counts()
        t0 = time.perf_counter()
        result = pipe.run()
        run_s = time.perf_counter() - t0
        launches = {**tk.launch_counts, **ak.launch_counts}
        report = pipe.evaluate(num_queries=1024, k=K)
        engine = pipe.engine()
        manifest = json.loads(open(os.path.join(
            tmp, backend, "manifest.json")).read())
        picks = np.linspace(0, TREE_FILES - 1, 8, dtype=np.int64)
        texts = [open(manifest[i]).read() for i in picks]
        ranked = pipe.query(texts, k=K)
        o_ids, _ = engine.oracle_topk(pipe.encoder.get_embeddings(texts),
                                      K)
        q_ids = np.asarray([[r[1] for r in rk] for rk in ranked])
        stats = result.ingest
        phase(f"phase 8 [{card}] build mode {backend}: {stats.embeddings}"
              f" files, run() {run_s:.2f}s = {stats.embeddings / run_s:.1f}"
              f" files/s end to end (route {engine.kernel_name(K)}); run "
              f"MRR={result.mrr} recall={result.recall} overlap="
              f"{result.overlap}; evaluate {report}; query ids == oracle:"
              f" {np.array_equal(q_ids, o_ids)}; launches {launches}")
        for line in result.report.splitlines():
            if line.strip() and not line.startswith(("=", "-")):
                phase(f"phase 8 [{card}] {backend} report | {line}")
        assert stats.embeddings == TREE_FILES and stats.failed_batches == 0
        assert report["oracle_overlap"] == 1.0
        assert np.array_equal(q_ids, o_ids)
        if backend == "nomic":
            k8_launches = launches["fused_attention_qkv"]
            assert k8_launches > 0, launches
        else:
            assert (result.mrr, result.recall, result.overlap) == (
                1.0, 1.0, 1.0)
            assert report["mrr"] == report["recall_at_k"] == 1.0
            assert [rk[0][0] for rk in ranked] == [manifest[i]
                                                   for i in picks]
        del pipe, engine
    return k8_launches


def check_attention_bwd(gen):
    """Phase 9: K9 against its plain version at the training shape, and
    both against the float64 evaluation of the same function."""
    from better_search_rag_rust_tpu_torch.bench.ab_attn import (
        bwd_error,
        reference64_bwd,
    )
    from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = B_TRAIN, S_ENC, H_ENC, HD_ENC
    qkv = torch.randn((b, s, 3 * h * hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    g = torch.randn((b, s, h * hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0                                   # one fully padded row
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32).contiguous()
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_tables(s, hd, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    scale = 1.0 / math.sqrt(hd)

    def kern():
        return ak.fused_attention_qkv_bwd(qkv, c2, s2, bias, g, h, scale)

    def plain():
        return ak.fused_attention_qkv_bwd_plain(qkv, c2, s2, bias, g, h, scale)

    out, again, ref = kern(), kern(), plain()
    torch.cuda.synchronize()
    same = torch.equal(out, again)
    finite = bool(torch.isfinite(out.float()).all())
    parts, err = [], 0.0
    for name, a, r in zip(("dq", "dk", "dv"), out.double().chunk(3, -1),
                          ref.double().chunk(3, -1)):
        diff, top = float((a - r).abs().max()), float(r.abs().max())
        cos_sim = float((a * r).sum() / (a.norm() * r.norm()))
        parts.append((name, diff, top, cos_sim))
        err = max(err, diff)
    phase(f"phase 9 K9 [{b} x {s} x {h} heads x {hd}] bf16: " + "; ".join(
        f"{n} max|diff|={d:.4g} (bound {BWD_REL} x {t:.4g}) cosine="
        f"{c:.7f} (bound {BWD_COS})" for n, d, t, c in parts)
        + f"; all finite (fully padded row too): {finite}; two launches "
        f"bitwise equal: {same}")
    assert finite and same
    for _n, diff, top, cos_sim in parts:
        assert diff <= BWD_REL * top and cos_sim >= BWD_COS
    ref64 = reference64_bwd(qkv, c2, s2, bias, g, h, scale)
    phase(f"phase 9 K9 vs float64 (every cell of dqkv): kernel "
          f"{bwd_error(out, ref64)}; plain {bwd_error(ref, ref64)}")
    del out, again, ref, ref64
    qr, kr, vr, mask = _rotated_qkv(qkv, c2, s2, bias, h)
    for t in (qr, kr, vr):
        t.requires_grad_()
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qr, kr, vr, attn_mask=mask, scale=scale)
    g_heads = g.view(b, s, h, hd).permute(0, 2, 1, 3).contiguous()
    times = timing(
        cuda_ms(kern), cuda_ms(plain),
        cuda_ms(lambda: torch.autograd.grad(sdpa, (qr, kr, vr), g_heads,
                                               retain_graph=True)),
        nbytes(qkv, c2, s2, bias, g) + nbytes(qkv), 10 * b * h * s * s * hd,
        "bf16 tensor")
    del qkv, g, qr, kr, vr, sdpa, g_heads
    torch.cuda.empty_cache()
    return err, times


def _pairs(rng, cfg, b):
    """Seeded token batches of ``b`` pairs, ragged masks."""
    s = cfg.max_tokens
    out = []
    for _ in range(2):
        ids = rng.integers(1, cfg.vocab_size, size=(b, s))
        lens = rng.integers(s // 8, s + 1, size=b)
        mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int64)
        out += [torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()]
    return out


def check_training(seed, card):
    """Phase 10: the trainer at full width. K8 + K9 gradients against the
    plain attention's at B_GRAD; then the finetune measurement at B_TRAIN
    and a device-time split of one step. Returns K9's launches over the
    timed steps."""
    from better_search_rag_rust_tpu_torch.bench.finetune import (
        run_finetune_suite,
    )
    from better_search_rag_rust_tpu_torch.models.nomic import NomicBertConfig
    from better_search_rag_rust_tpu_torch.models.train import (
        ContrastiveTrainer,
    )

    cfg = NomicBertConfig()
    fused = ContrastiveTrainer(cfg, seed=seed, device="cuda")
    plain = ContrastiveTrainer(NomicBertConfig(attention_impl="xla"),
                               params=fused.state.params, device="cuda")
    batch = _pairs(np.random.default_rng(seed), cfg, B_GRAD)
    losses = []
    for tr in (fused, plain):
        loss = tr.loss(*batch)
        loss.backward()
        losses.append(float(loss.detach()))
    worst, checked = (1.0, ""), 0
    for (name, pf), (_, px) in zip(fused.model.named_parameters(),
                                   plain.model.named_parameters()):
        a, b = pf.grad.double().ravel(), px.grad.double().ravel()
        if float(a.norm()) < 1e-12 and float(b.norm()) < 1e-12:
            continue
        cos_sim = float(a @ b / (a.norm() * b.norm()))
        worst = min(worst, (cos_sim, name))
        checked += 1
    phase(f"phase 10 trainer 12 x 768, {B_GRAD} pairs x {S_ENC} tokens: loss "
          f"K8+K9 {losses[0]:.6f}, plain attention {losses[1]:.6f}; "
          f"gradient cosine over {checked} parameters min={worst[0]:.6f} "
          f"({worst[1]}; bound {GRAD_COS})")
    assert worst[0] > GRAD_COS and checked > 100
    assert all(math.isfinite(x) for x in losses)
    del fused, plain, batch
    torch.cuda.empty_cache()

    res = run_finetune_suite(batch=B_TRAIN, steps=TIMED_STEPS, seed=seed,
                             device="cuda")
    k9 = res["launches"]["fused_attention_qkv_bwd"]
    k8 = res["launches"]["fused_attention_qkv"]
    phase(f"phase 10 [{card}] finetune {B_TRAIN} pairs x {S_ENC} tokens, "
          f"3 x {TIMED_STEPS} timed steps after 3 warm-up: {res['value']:.2f} "
          f"files/s, {res['steps_per_sec']:.4f} steps/s ({res['step_ms']:.1f} "
          f"ms/step), peak memory {res['peak_memory_bytes'] / 2**30:.2f} GiB, "
          f"final loss {res['final_loss']:.6f}, attention "
          f"{res['attention_impl']}; launches K8 {k8}, K9 {k9}")
    assert math.isfinite(res["final_loss"])
    assert k9 == k8 == 2 * cfg.num_layers * TIMED_STEPS, res["launches"]
    torch.cuda.empty_cache()

    tr = ContrastiveTrainer(cfg, seed=seed, device="cuda")
    batch = _pairs(np.random.default_rng(seed + 1), cfg, B_TRAIN)
    tr.train_step(*batch)
    split, total, top = _device_profile(lambda: tr.train_step_device(*batch))
    phase(f"phase 10 [{card}] one step's device time {total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f} %)"
                      for k, v in split.items())
          + "; top kernels: "
          + "; ".join(f"{key[:60]} {ms:.2f}" for ms, key in top[:6]))
    del tr, batch
    torch.cuda.empty_cache()
    return k9


def drive_finetune_cli(tmp, src, card):
    """Phase 11: ``finetune`` through the CLI on the phase-8 tree; the saved
    checkpoint reloads bit for bit equal to the trainer's parameters."""
    import contextlib
    import io

    from better_search_rag_rust_tpu_torch import cli
    from better_search_rag_rust_tpu_torch.models import train
    from better_search_rag_rust_tpu_torch.models.checkpoint import load_params
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    made = []

    class Recorded(train.ContrastiveTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    ckpt = os.path.join(tmp, "finetuned")
    argv = ["finetune", "--root", src, "--extensions", "java", "--steps",
            "4", "--train-batch", str(B_TRAIN), "--save-dir", ckpt,
            "--device", "cuda"]
    out = io.StringIO()
    ak.reset_launch_counts()
    t0 = time.perf_counter()
    train.ContrastiveTrainer = Recorded
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        train.ContrastiveTrainer = Recorded.__base__
    run_s = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        phase(f"phase 11 [{card}] cli finetune | {line}")
    (trainer,) = made
    saved = load_params(ckpt)
    params = trainer.state.params
    equal = saved.keys() == params.keys() and all(
        torch.equal(saved[k], v.cpu()) for k, v in params.items())
    final = float(out.getvalue().split("final loss ")[1].split()[0])
    phase(f"phase 11 [{card}] cli finetune: rc {rc}, {run_s:.2f}s for 4 steps "
          f"of {B_TRAIN} pairs (walk, read, tokenize, train, save); "
          f"checkpoint of {len(saved)} tensors equals the trainer's "
          f"parameters bitwise: {equal}; K9 launches "
          f"{ak.launch_counts['fused_attention_qkv_bwd']}")
    assert rc == 0 and equal and math.isfinite(final)
    assert ak.launch_counts["fused_attention_qkv_bwd"] == 4 * 2 * 12


def check_int8_kernels(store, gen):
    """Phase 12: the int8 bodies of K1/K2/K3 against their plain versions on
    a 1M x 768 int8 lattice store, bit for bit, and the argmax identity."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    data, n = store.data, store.num_rows
    rows = torch.randint(0, n, (T,), generator=gen, device="cuda")
    q = data[rows].contiguous()
    errs, times = {}, {}

    def k1():
        return tk.matmul_blockmax2_only(q, data, n, sub=SUB, block=BLOCK,
                                        emit_block=True, emit_argmax=True)

    def k1_plain():
        return tk.matmul_blockmax2_only_plain(
            q, data, n, sub=SUB, block=BLOCK, emit_block=True,
            emit_argmax=True)

    (bms, key, bm), (p_bms, p_key, p_bm) = k1(), k1_plain()
    torch.cuda.synchronize()
    keys_equal = torch.equal(key, p_key)
    errs["matmul_blockmax2_only_int8"] = max(max_abs(bms, p_bms),
                                             max_abs(bm, p_bm))
    phase(f"phase 12 K1 int8 [{T} x {data.shape[0]} x {data.shape[1]}] "
          f"sub={SUB}: max|bm_sub-plain|={max_abs(bms, p_bms)} "
          f"max|bm-plain|={max_abs(bm, p_bm)} packed (m2, argmax) keys "
          f"equal: {keys_equal}")
    assert errs["matmul_blockmax2_only_int8"] == 0 and keys_equal
    r, d = data.shape
    times["matmul_blockmax2_only_int8"] = timing(
        cuda_ms(k1), cuda_ms(k1_plain), product_ms(q, data),
        nbytes(q, data, bms, key, bm), 2 * T * r * d, "int8 tensor")
    del p_bms, p_key, p_bm

    n_units = data.shape[0] // SUB
    errs["gather_rescore_int8"] = 0.0
    for ks in (4, 100):
        ids = torch.sort(torch.randint(0, n_units, (T, ks), generator=gen,
                                       device="cuda"), dim=1).values
        ids = ids.to(torch.int32).contiguous()
        out = tk.gather_rescore(q, data, ids, unit=SUB)
        err = max_abs(out, tk.gather_rescore_plain(q, data, ids, unit=SUB))
        errs["gather_rescore_int8"] = max(errs["gather_rescore_int8"], err)
        times[f"gather_rescore_int8_ks{ks}"] = timing(
            cuda_ms(lambda: tk.gather_rescore(q, data, ids, unit=SUB)),
            cuda_ms(lambda: tk.gather_rescore_plain(q, data, ids, unit=SUB)),
            None,
            nbytes(q, ids, out) + torch.unique(ids).numel() * SUB * d,
            2 * T * ks * SUB * d, "int8 tensor")
        phase(f"phase 12 K2 int8 KS={ks} unit={SUB}: max|out-plain|={err}")
        assert err == 0
    times["gather_rescore_int8"] = times["gather_rescore_int8_ks100"]

    # the oracle scores 256 queries per K3 launch over the whole store
    q256 = q[:256].contiguous()
    sims, bm_t = tk.matmul_blockmax(q256, data, n)
    p_sims, p_bm_t = tk.matmul_blockmax_plain(q256, data, n)
    errs["matmul_blockmax_int8"] = max(max_abs(sims, p_sims),
                                       max_abs(bm_t, p_bm_t))
    phase(f"phase 12 K3 int8 [256 x {data.shape[0]} x {data.shape[1]}]: "
          f"max|sims-plain|={max_abs(sims, p_sims)} "
          f"max|bm-plain|={max_abs(bm_t, p_bm_t)}")
    assert errs["matmul_blockmax_int8"] == 0
    times["matmul_blockmax_int8"] = timing(
        cuda_ms(lambda: tk.matmul_blockmax(q256, data, n)),
        cuda_ms(lambda: tk.matmul_blockmax_plain(q256, data, n)),
        product_ms(q256, data), nbytes(q256, data, sims, bm_t),
        2 * 256 * r * d, "int8 tensor")
    del sims, bm_t, p_sims, p_bm_t

    units = torch.sort(torch.randint(0, n // SUB, (T, 256), generator=gen,
                                     device="cuda"), dim=1).values
    resc = tk.gather_rescore(q, data, units.to(torch.int32).contiguous(),
                             unit=SUB).view(T, 256, SUB)
    arg = torch.gather((key & 0x7F).T.to(torch.int64), 1, units)
    k1_max = torch.gather(bms.T, 1, units)
    k2_at_arg = torch.gather(resc, 2, arg[:, :, None])[:, :, 0]
    sims, _ = tk.matmul_blockmax(q, data, n)
    same = (torch.equal(k2_at_arg, k1_max)
            and torch.equal(torch.gather(sims, 1, units * SUB + arg), k1_max))
    phase(f"phase 12 int8 identity on {units.numel()} (query, unit argmax) "
          f"pairs: K1 == K2 == K3 bitwise: {same}")
    assert same
    for name, rec in times.items():
        phase("phase 12 " + timing_line(name, rec))
    return errs, times


#: Phase 12's edge cases of the int8 score tile: D, and how the operands
#: are made (the lattice; raw rows mostly -128; rows one byte off 16-byte
#: alignment). D 99 and 100 and the offset view take the thread-staged
#: slabs, the others TMA.
TILE_I8_CASES = ((99, "lattice"), (100, "lattice"), (256, "lattice"),
                 (768, "lattice"), (1040, "neg128"), (768, "offset"))


def _tile_i8_operands(dim, kind, seed, rows=2048, t=200):
    rng = np.random.default_rng(seed + dim)
    if kind == "neg128":
        def heavy(n):
            m = rng.integers(-128, 128, size=(n, dim), dtype=np.int64)
            m[rng.random((n, dim)) < 0.7] = -128
            return m.astype(np.int8)
        mat = heavy(rows)
        q = np.concatenate([mat[[3, 100, 7]], np.full((1, dim), -128, np.int8),
                            heavy(t - 4)])
        # the dots stay exact in f32, so plain and kernel can agree bitwise
        mag = np.abs(q.astype(np.int64)) @ np.abs(mat.astype(np.int64)).T
        assert mag.max() < 2 ** 24, mag.max()
    else:
        from better_search_rag_rust_tpu_torch.ops.quantize import (
            quantize_unit_host,
        )

        m = rng.standard_normal((rows, dim)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        mat = quantize_unit_host(m)
        q = np.concatenate([mat[[3, 100, 7]], quantize_unit_host(
            -m[rng.integers(0, rows, t - 3)])])
    q, mat = torch.from_numpy(q).cuda(), torch.from_numpy(mat).cuda()
    if kind == "offset":
        def shifted(x):
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
            view = buf[1:].view(x.shape)
            view.copy_(x)
            return view
        q, mat = shifted(q), shifted(mat)
        assert q.data_ptr() % 16 and mat.data_ptr() % 16
    return q, mat


def check_int8_tile_edges(seed):
    """Phase 12: K1 (emit width 128 and, on K10's walk, 256), K3, K5 and
    K10 (scores, arg and the raw key) on int8 operands at the tile's edge
    cases, bit for bit their plain versions: 200 queries (a ragged query
    tile), 2048 rows of which the last 37 are masked."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    names = ("matmul_blockmax2_only_int8", "matmul_blockmax_int8",
             "matmul_blockmax_only", "matmul_blockmax2x")
    for dim, kind in TILE_I8_CASES:
        q, mat = _tile_i8_operands(dim, kind, seed)
        valid = mat.shape[0] - 37
        before = {n: tk.launch_counts[n] for n in names}
        pairs = []
        for kw in (dict(sub=16, block=128),
                   dict(sub=128, block=1024, emit_width=256)):
            kw.update(emit_block=True, emit_argmax=True)
            pairs.append((tk.matmul_blockmax2_only(q, mat, valid, **kw),
                          tk.matmul_blockmax2_only_plain(q, mat, valid, **kw)))
        pairs.append((tk.matmul_blockmax(q, mat, valid),
                      tk.matmul_blockmax_plain(q, mat, valid)))
        pairs.append((tk.matmul_blockmax_only(q, mat, valid, block=32),
                      tk.matmul_blockmax_only_plain(q, mat, valid, block=32)))
        kw = dict(sub=64, emit_sims=True, emit_arg=True, emit_raw_key=True)
        pairs.append((tk.matmul_blockmax2x(q, mat, valid, **kw),
                      tk.matmul_blockmax2x_plain(q, mat, valid, **kw)))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for got, want in pairs
                   for a, b in zip(got if isinstance(got, tuple) else (got,),
                                   want if isinstance(want, tuple) else (want,)))
        launched = {n: tk.launch_counts[n] - before[n] for n in names}
        phase(f"phase 12 int8 tile, D {dim} {kind}: K1 ew 128 / ew 256, K3, "
              f"K5, K10 bit for bit plain: {same}; launches {launched}")
        assert same and all(launched.values()), launched


def measure_qps(engine, store, gen, iters: int = 5):
    """``search`` (host queries in, host ids out) and ``search_device``
    queries/sec at 1024 queries, k = K."""
    rows = torch.randint(0, store.num_rows, (1024,), generator=gen,
                         device="cuda")
    queries = store.data[rows].float().cpu().numpy()
    engine.search(queries, K)  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search(queries, K)
    host_qps = 1024 * iters / (time.perf_counter() - t0)
    qdev = engine.prepare_device_queries(queries)
    engine.search_device(qdev, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search_device(qdev, K)
    torch.cuda.synchronize()
    return host_qps, 1024 * iters / (time.perf_counter() - t0)


#: the search kernels a route's split names, by their CUDA function names
SPLIT_KERNELS = {"K1": "k1_blockmax2", "K2": "k2_gather_rescore",
                 "K3": "k3_blockmax", "K4": "k4_gather_rows",
                 "K6": "k6_block_scores"}


def search_split(engine, store, gen, card, label="phase 5"):
    """Phase 5 (16 on the f32 routes): where the device time of one
    512-query tile of ``search_device`` goes (torch.profiler): each search
    kernel the route ran, the rest of its kernels (glue) and the device's
    idle share of the wall clock."""
    rows = torch.randint(0, store.num_rows, (T,), generator=gen,
                         device="cuda")
    qdev = store.data[rows].float()
    engine.search_device(qdev, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.search_device(qdev, K)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    _split, total, top = _device_profile(
        lambda: engine.search_device(qdev, K))
    if total <= 0:
        phase(f"{label} [{card}] one {T}-query tile of search_device: "
              f"{wall:.3f} ms wall; the profiler saw no device time: split "
              f"not measured")
        return
    named = {k: sum(ms for ms, key in top if fn in key)
             for k, fn in SPLIT_KERNELS.items()}
    named = {k: v for k, v in named.items() if v > 0}
    glue = total - sum(named.values())
    parts = "".join(f"{k} {v:.3f} ({100 * v / total:.1f} %), "
                    for k, v in named.items())
    phase(f"{label} [{card}] one {T}-query tile of search_device: {wall:.3f}"
          f" ms wall, device {total:.3f} ms: {parts}glue {glue:.3f} "
          f"({100 * glue / total:.1f} %); device idle "
          f"{100 * max(0.0, 1 - total / wall):.1f} % of the wall clock; "
          f"longest kernels {[(round(ms, 3), key[:40]) for ms, key in top[:6]]}")


def serve_split(store, tmp, card):
    """Where the time goes in one served batch of 512 vector queries
    (``Pipeline.serve``, k = K): wall clock of the request against the
    device time of its kernels (torch.profiler). The synthetic store has no
    manifest: its store dir is an empty one, and paths read ``row:N``."""
    from better_search_rag_rust_tpu_torch.config import (
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(PipelineConfig(
        store=StoreConfig(dir=os.path.join(tmp, "synthetic")),
        search=SearchConfig(top_k=K), skip_process=True), device="cuda")
    engine = pipe.engine(store)
    rows = np.linspace(0, store.num_rows - 1, 512, dtype=np.int64)
    req = {"id": 0, "vectors": store.data[torch.from_numpy(rows).cuda()]
           .float().cpu().numpy().tolist()}
    list(pipe.serve([req], k=K))  # warm-up
    t0 = time.perf_counter()
    (resp,) = pipe.serve([req], k=K)
    wall = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    engine.search(np.asarray(req["vectors"], np.float32), K)
    search_ms = 1e3 * (time.perf_counter() - t0)
    split, total, top = _device_profile(lambda: list(pipe.serve([req], k=K)))
    k1 = sum(ms for ms, key in top if "k1_blockmax2" in key)
    k2 = sum(ms for ms, key in top if "k2_gather_rescore" in key)
    phase(f"phase 14 [{card}] one served batch of 512 queries on "
          f"{store.num_rows} x {store.dim} {str(store.dtype)[6:]}, k={K}: "
          f"request {wall:.2f} ms wall (engine.search alone {search_ms:.2f} "
          f"ms; the rest is parsing the JSON vectors and formatting "
          f"{512 * K} results); device {total:.2f} ms, of it K1 {k1:.2f} ms,"
          f" K2 {k2:.2f} ms; top kernels: "
          + "; ".join(f"{key[:40]} {ms:.2f}" for ms, key in top[:6]))
    assert len(resp["results"]) == 512
    assert all(len(r) == K for r in resp["results"])


def drive_serve_bench(store_bf16, store_i8, card):
    """Phase 14: ``bench/serve.py`` at the ``serve_open`` shape (64 clients x
    8 outstanding, 2 ms window, depth 2) on the 1M x 768 bf16 store and,
    with fewer requests per client, the 10M x 768 int8 store. Every answer
    must equal ``engine.search`` of the same query."""
    from better_search_rag_rust_tpu_torch.bench.serve import run_serve_suite
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    launches = {}
    for base, store, per_client, suffix in (
            ("search_1m", store_bf16, 256, ""),
            ("search_10m_int8", store_i8, 32, "_int8")):
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        res = run_serve_suite(base=base, clients=64, outstanding=8,
                              requests_per_client=per_client, window_ms=2.0,
                              depth=2, store=store)
        torch.cuda.synchronize()
        counts = {k: v for k, v in tk.launch_counts.items() if v}
        phase(f"phase 14 [{card}] serve {base} ({res['rows']} x {res['dim']} "
              f"{res['store_dtype']}, route {res['kernel']}), 64 clients x 8 "
              f"outstanding, {res['requests']} requests: "
              f"{res['value']:.1f} q/s, single-request "
              f"{res['single_request_qps']:.1f} q/s, coalescing "
              f"{res['coalescing']:.1f}, p50 "
              f"{res['p50_latency_ms']:.2f} ms, p99 {res['p99_latency_ms']:.2f}"
              f" ms, recall@10 {res['recall_at_10']}, answered "
              f"{res['answered']}, failed {res['failed']}, differing from "
              f"engine.search {res['mismatched']}; launches {counts}")
        assert res["answered"] == res["requests"] and res["failed"] == 0
        assert res["mismatched"] == 0 and res["recall_at_10"] == 1.0
        assert res["kernel"] == "rescore"
        for name in ("matmul_blockmax2_only", "gather_rescore"):
            assert counts.get(name + suffix, 0) > 0, counts
            launches[name + suffix] = counts[name + suffix]
    return launches


def _edit_tree(src, seed, edit=16, delete=8, add=8):
    """Rewrite ``edit`` files, delete ``delete`` and add ``add`` new ones;
    returns (edited paths, deleted paths, added paths)."""
    rng = np.random.default_rng(seed + 7)
    names = sorted(os.listdir(src))
    picks = rng.choice(len(names), edit + delete, replace=False)
    edited = [os.path.join(src, names[i]) for i in picks[:edit]]
    deleted = [os.path.join(src, names[i]) for i in picks[edit:]]
    added = [os.path.join(src, f"G{j}.java") for j in range(add)]
    for path in edited + added:
        body = " ".join(f"tok{w}" for w in rng.integers(0, 5000, 400))
        with open(path, "w") as f:
            f.write(f"class {os.path.basename(path)[:-5]} {{ {body} }}")
    for path in deleted:
        os.remove(path)
    return edited, deleted, added


class _Server:
    """``python -m better_search_rag_rust_tpu_torch serve --port 0 ...`` as a
    subprocess; its log (stdout and stderr) goes to ``log``."""

    def __init__(self, args, log):
        import re
        import sys

        repo = os.path.dirname(os.path.abspath(__file__))
        self.log = log
        with open(log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "better_search_rag_rust_tpu_torch",
                 "serve", *args], cwd=repo, stdout=out,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=repo))
        deadline = time.time() + 300
        while time.time() < deadline:
            text = self.text()
            found = re.search(r"listening on ([\d.]+):(\d+)", text)
            if found:
                self.addr = (found.group(1), int(found.group(2)))
                return
            if self.proc.poll() is not None:
                raise RuntimeError(f"serve exited ({self.proc.returncode}):"
                                   f"\n{text[-3000:]}")
            time.sleep(0.2)
        self.stop()
        raise TimeoutError(f"serve did not listen:\n{self.text()[-3000:]}")

    def text(self) -> str:
        with open(self.log) as f:
            return f.read()

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)


class _Connection:
    """One JSONL-over-TCP client connection."""

    def __init__(self, addr):
        import socket

        self.sock = socket.create_connection(addr, timeout=300)
        self.file = self.sock.makefile("rw", encoding="utf-8")

    def ask(self, requests):
        for req in requests:
            self.file.write(json.dumps(req) + "\n")
        self.file.flush()
        return [json.loads(self.file.readline()) for _ in requests]

    def close(self) -> None:
        self.file.close()
        self.sock.close()


def _ask_both(conns, requests):
    """Half of ``requests`` on each connection, both at once; the answers
    in request order."""
    import threading

    halves = [requests[0::2], requests[1::2]]
    out = [None, None]
    threads = [threading.Thread(
        target=lambda i=i: out.__setitem__(i, conns[i].ask(halves[i])))
        for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert out[0] is not None and out[1] is not None, "a connection hung"
    merged = [None] * len(requests)
    merged[0::2], merged[1::2] = out
    return merged


def drive_cli_serve(tmp, src, seed, card, rows):
    """Phase 15: CLI ``serve --port 0 --serve-window-ms 2 --snapshot`` on
    phase 8's nomic store (a subprocess; two TCP connections), then an
    edited tree (16 files rewritten, 8 deleted, 8 added), CLI ``update``
    (nomic on K8, in this process) and ``reload``; the edited and added
    files must retrieve themselves at rank 1 and no deleted file may be
    answered. A second start restores the store from its snapshot and
    answers the same requests identically. Both the server and ``update``
    build the nomic encoder from the CLI's seed (0), so the rank-1 checks
    hold for any ``--seed``. Returns the K8 launches of ``update``."""
    import contextlib
    import io

    from better_search_rag_rust_tpu_torch import cli
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    store_dir = os.path.join(tmp, "nomic")
    common = ["--root", src, "--extensions", "java", "--store-dir", store_dir,
              "--encoder-backend", "nomic", "--top-k", "10"]
    serve_args = [*common, "--port", "0", "--serve-window-ms", "2",
                  "--snapshot"]
    t0 = time.perf_counter()
    server = _Server(serve_args, os.path.join(tmp, "serve1.log"))
    conns = [_Connection(server.addr), _Connection(server.addr)]
    try:
        start_s = time.perf_counter() - t0
        names = sorted(os.listdir(src))
        before = [{"id": f"b{i}", "query": open(os.path.join(src, n)).read()}
                  for i, n in enumerate(names[:: len(names) // 8][:8])]
        first = _ask_both(conns, before)
        edited, deleted, added = _edit_tree(src, seed)
        out = io.StringIO()
        ak.reset_launch_counts()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["update", *common])
        update_s = time.perf_counter() - t1
        k8 = ak.launch_counts["fused_attention_qkv"]
        (reload,) = conns[0].ask([{"id": "reload", "cmd": "reload"}])
        fresh = edited + added
        requests = [{"id": p, "query": open(p).read()} for p in fresh]
        after = _ask_both(conns, requests)
    finally:
        for conn in conns:
            conn.close()
        server.stop()
    base = os.path.basename
    rank1 = sum(base(r["results"][0][0]["path"]) == base(r["id"])
                for r in after)
    answered = {base(e["path"]) for r in after for q in r["results"]
                for e in q}
    gone = {base(p) for p in deleted}
    stats_line = out.getvalue().strip().splitlines()[-1]
    phase(f"phase 15 [{card}] cli serve (nomic, 2 TCP connections, 2 ms "
          f"window): listening after {start_s:.1f}s; {len(first)} queries "
          f"before the edit answered; cli update rc {rc} in {update_s:.2f}s: "
          f"{stats_line}; K8 launches {k8}; reload {reload}; "
          f"{rank1}/{len(fresh)} edited or added files at rank 1; deleted "
          f"files answered: {len(answered & gone)}")
    assert all("results" in r for r in first), first
    assert rc == 0 and k8 > 0
    assert "appended 8 embeddings, re-embedded 16, deleted 8" in stats_line
    assert reload == {"id": "reload", "reloaded": True, "rows": rows}
    assert rank1 == len(fresh)
    assert not answered & gone

    server = _Server(serve_args, os.path.join(tmp, "serve2.log"))
    conns = [_Connection(server.addr), _Connection(server.addr)]
    try:
        again = _ask_both(conns, requests)
    finally:
        for conn in conns:
            conn.close()
        server.stop()
    restored = "restored from snapshot" in server.text()
    phase(f"phase 15 [{card}] second start with --snapshot: restored from "
          f"the snapshot: {restored}; {len(again)} answers identical to the "
          f"first server's: {again == after}")
    assert restored and again == after
    return k8


def check_gather_and_block_scores(store, gen, card):
    """Phase 16, K4 and K6 at the certified route's shapes (a 512-query
    tile, 256 selected 8-row units each, 1M x 768): K4 against its plain
    version on f32, bf16 and int8 rows and its out-of-range fill; K6 over
    K4's rows against K3, K2 and its plain version; their times."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit

    data, n = store.data, store.num_rows
    unit, ks = 8, 256
    n_units = data.shape[0] // unit
    q = data[torch.randint(0, n, (T,), generator=gen, device="cuda")]
    # valid units only: K3 masks padding rows, K6 scores what it is given
    ids = torch.sort(torch.randint(0, n // unit, (T, ks), generator=gen,
                                   device="cuda"), dim=1).values
    ids = ids.to(torch.int32).contiguous()
    errs, times = {}, {}

    diffs, k6_err = {}, {}  # K4 on each dtype, and K6 over its rows
    for name, cast in (("f32", lambda x: x),
                       ("bf16", lambda x: x.to(torch.bfloat16)),
                       ("int8", quantize_unit)):
        rows_of, q_of = cast(data), cast(q)
        out = tk.gather_rows(rows_of, ids, unit=unit)
        ref = tk.gather_rows_plain(rows_of, ids, unit=unit)
        torch.cuda.synchronize()
        same = torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
        diffs[name] = max_abs(out.float(), ref.float()) if same else math.inf
        k6_err[name] = max_abs(tk.block_scores(q_of, out),
                               tk.block_scores_plain(q_of, out))
        del rows_of, out, ref
    bad = ids[:4, :4].clone()
    bad[0, 1], bad[1, 2], bad[2, 3] = -1, n_units, 2**31 - 1
    filled = tk.gather_rows(data, bad, unit=unit).view(4, 4, unit, -1)
    fill_ok = (bool((filled[[0, 1, 2], [1, 2, 3]].view(torch.uint8) == 0xFF)
                    .all())
               and torch.equal(filled[3, 0], data[int(bad[3, 0]) * unit:
                                                  (int(bad[3, 0]) + 1) * unit]))
    errs["gather_rows"] = max(diffs.values())
    phase(f"phase 16 K4 gather_rows [{T} x {ks} units x {unit} rows x "
          f"{data.shape[1]}] vs plain: max|diff| {diffs}; ids outside "
          f"[0, {n_units}) give 0xFF rows: {fill_ok}")
    assert errs["gather_rows"] == 0 and fill_ok

    rows = tk.gather_rows(data, ids, unit=unit)
    k6 = tk.block_scores(q, rows)
    sims, _ = tk.matmul_blockmax(q, data, n)
    pos = (ids.long()[:, :, None] * unit
           + torch.arange(unit, device="cuda")).reshape(T, -1)
    k3_same = torch.equal(k6, torch.gather(sims, 1, pos))
    del sims
    k2_same = torch.equal(k6, tk.gather_rescore(q, data, ids, unit=unit))
    errs["block_scores"] = k6_err["f32"]
    phase(f"phase 16 K6 block_scores [{T} x {ks * unit} x {data.shape[1]}] "
          f"over K4's rows: bitwise K3's sims at the same pairs: {k3_same};"
          f" bitwise K2's scores of the same units: {k2_same}; max|K6 - "
          f"plain| {k6_err} (bound {TOL}; 0 on int8)")
    assert k3_same and k2_same and k6_err["int8"] == 0
    assert max(k6_err.values()) <= TOL

    view = data.view(-1, unit, data.shape[1])
    ids_long = ids.long()
    uniq = torch.unique(ids).numel() * unit * data.shape[1] * 4
    times["gather_rows"] = timing(
        cuda_ms(lambda: tk.gather_rows(data, ids, unit=unit)),
        cuda_ms(lambda: tk.gather_rows_plain(data, ids, unit=unit)),
        cuda_ms(lambda: view[ids_long]),
        nbytes(ids, rows) + uniq, 0, "fp32 SIMT")
    times["block_scores"] = timing(
        cuda_ms(lambda: tk.block_scores(q, rows)),
        cuda_ms(lambda: tk.block_scores_plain(q, rows)),
        cuda_ms(lambda: torch.bmm(rows, q[:, :, None])),
        nbytes(q, rows, k6), 2 * T * ks * unit * data.shape[1], "fp32 SIMT")
    del rows, k6

    def k1():
        return tk.matmul_blockmax2_only(q, data, n, sub=unit, block=128,
                                        emit_block=True, emit_width=128)

    bms, bm = k1()
    p_bms, p_bm = tk.matmul_blockmax2_only_plain(
        q, data, n, sub=unit, block=128, emit_block=True, emit_width=128)
    k1_err = max(max_abs(bms, p_bms), max_abs(bm, p_bm))
    del p_bms, p_bm
    _, c_bms, _ = chain_units(tk, q, data, unit)
    chain_ok = (torch.equal(bms[:CHAIN_ROWS // unit], c_bms)
                and torch.equal(bm[:CHAIN_ROWS // 128],
                                c_bms.view(-1, 128 // unit, T).amax(dim=1)))
    k1_f32 = timing(
        cuda_ms(k1),
        cuda_ms(lambda: tk.matmul_blockmax2_only_plain(
            q, data, n, sub=unit, block=128, emit_block=True,
            emit_width=128)),
        product_ms(q, data), nbytes(q, data, bms, bm),
        2 * T * data.shape[0] * data.shape[1], "fp32 SIMT")
    phase(f"phase 16 K1 f32 at the route's geometry (sub {unit}, emit 128): "
          f"max|out-plain|={k1_err:.3g} (bound {TOL}); maxima on the first "
          f"{CHAIN_ROWS} rows bit for bit fma_chain_scores: {chain_ok}")
    assert k1_err <= TOL and chain_ok
    for name, rec in (("gather_rows", times["gather_rows"]),
                      ("block_scores", times["block_scores"]),
                      ("matmul_blockmax2_only f32 sub 8", k1_f32)):
        phase(f"phase 16 [{card}] " + timing_line(name, rec))
    return errs, times


def drive_f32cert(seed, gen, card):
    """Phase 16: the certified f32 route on ``search_1m_f32`` and on a
    store where its certificate fails; K4/K6 checks and times; q/s beside
    the rescore route on the same store. Returns (errs, times, launches)."""
    from better_search_rag_rust_tpu_torch.config import (
        PipelineConfig,
        SearchConfig,
    )
    from better_search_rag_rust_tpu_torch.ops import topk as port_topk
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    store = DeviceStore.synthetic(1_000_000, 768, "float32", seed + 2,
                                  device="cuda")
    cfg = PipelineConfig(search=SearchConfig(
        top_k=K, store_dtype="float32", f32_certified="on"),
        skip_process=True)
    dup = DeviceStore(store.data[:64].repeat(store.padded_rows // 64, 1),
                      store.num_rows, store.dim)
    launches = {}
    for name, st in (("1M x 768 f32", store),
                     ("1M x 768 f32, one 64-row block repeated", dup)):
        pipe = Pipeline(cfg, device="cuda")
        engine = pipe.engine(st)
        rows = torch.randint(0, st.num_rows, (1024,), generator=gen,
                             device="cuda")
        queries = st.data[rows].cpu().numpy()
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        port_topk.reset_cert_counts()
        ids, dists = engine.search(queries, K)
        torch.cuda.synchronize()
        counts = {k: v for k, v in tk.launch_counts.items() if v}
        certs = dict(port_topk.cert_counts)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        o_ids, o_d = engine.oracle_topk(queries, K)
        same = np.array_equal(ids, o_ids) and np.array_equal(dists, o_d)
        report = pipe.evaluate(num_queries=1024, k=K)
        phase(f"phase 16 {name}, f32_certified='on', 1024 queries, k={K}: "
              f"route={engine.kernel_name(K)}; ids and distances == "
              f"oracle_topk bitwise: {same}; evaluate mrr={report['mrr']} "
              f"recall@{K}={report['recall_at_k']} oracle_overlap="
              f"{report['oracle_overlap']}; certified tiles "
              f"{certs['certified']}/{sum(certs.values())} (dense "
              f"{certs['dense']}); launches {counts}")
        assert engine.kernel_name(K) == "f32cert" and same
        assert report["oracle_overlap"] == 1.0
        for k in ("matmul_blockmax2_only", "gather_rows", "block_scores"):
            assert counts.get(k, 0) > 0, counts
        if st is dup:
            assert certs["dense"] > 0 and counts["matmul_blockmax"] > 0
            b = rows.cpu().numpy() % 64
            assert np.array_equal(ids, b[:, None] + 64 * np.arange(K))
        else:  # on the repeated block a copy with a lower id ranks first
            assert certs["certified"] > 0
            assert report["mrr"] == report["recall_at_k"] == 1.0
            cert_engine = engine
        del pipe, engine
    del dup
    torch.cuda.empty_cache()

    rescore = SearchEngine(store, SearchConfig(top_k=K))
    assert rescore.kernel_name(K) == "rescore"
    qps = {"f32cert": measure_qps(cert_engine, store, gen, iters=3),
           "rescore": measure_qps(rescore, store, gen, iters=3)}
    phase(f"phase 16 [{card}] 1M x 768 f32, 1024 queries, k={K}: "
          + "; ".join(f"{r}: search {h:.1f} q/s, search_device {d:.1f} q/s"
                      for r, (h, d) in qps.items()))
    for route, eng in (("f32cert", cert_engine), ("rescore", rescore)):
        search_split(eng, store, gen, card, f"phase 16 {route} on 1M x 768 f32")
    del cert_engine, rescore
    errs, times = check_gather_and_block_scores(store, gen, card)
    del store
    torch.cuda.empty_cache()
    return errs, times, launches


def _run_module(label, args, env=None, timeout=900):
    """``python3 <args>`` from the repository root as a subprocess; its
    output lines are printed under ``label``; returns its stdout. A non-zero
    exit fails the run."""
    import sys

    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, *args], cwd=repo, capture_output=True, text=True,
        timeout=timeout,
        env=dict(os.environ, PYTHONPATH=repo, **(env or {})))
    for line in proc.stdout.splitlines():
        if not line.startswith(("{", "launches ")):
            phase(f"{label} | {line}")
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    return proc.stdout


def _launches(stdout) -> dict:
    """The ``launches {...}`` line a measurement module prints last."""
    (line,) = [ln for ln in stdout.splitlines() if ln.startswith("launches ")]
    return json.loads(line[len("launches "):])


def _result_line(stdout) -> dict:
    """The last JSON object line of a command's output (log lines share
    stdout with it)."""
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][-1])


def check_blockmax_only(seed, gen, card):
    """Phase 17: K5 against K3 and its plain version on 1M x 768 (three
    dtypes) and 10M x 256 stores; then the proto_calib measurements as a
    subprocess. Returns (err, timing, launches of the measurement run)."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    errs, times = {}, {}
    for dtype in ("bfloat16", "float32", "int8"):
        store = DeviceStore.synthetic(1_000_000, 768, dtype, seed + 5,
                                      device="cuda")
        data, n = store.data, store.num_rows
        q = data[torch.randint(0, n, (T,), generator=gen, device="cuda")]
        bm = tk.matmul_blockmax_only(q, data, n)
        _, k3_bm = tk.matmul_blockmax(q, data, n)
        plain = tk.matmul_blockmax_only_plain(q, data, n)
        torch.cuda.synchronize()
        same_k3 = torch.equal(bm, k3_bm)
        err = max_abs(bm, plain)
        padded = bool((bm[-((data.shape[0] - n) // BLOCK):] == tk.PAD_SIM)
                      .all())
        bound = 0.0 if dtype == "int8" else TOL
        chain = ""
        if dtype == "float32":
            c = tk.fma_chain_scores(q, data[:CHAIN_ROWS])
            chain_ok = torch.equal(bm[:CHAIN_ROWS // BLOCK],
                                   c.view(T, -1, BLOCK).amax(dim=2).T)
            chain = (f"; bm_t on the first {CHAIN_ROWS} rows bit for bit "
                     f"fma_chain_scores: {chain_ok}")
            assert chain_ok
            del c
        phase(f"phase 17 K5 {dtype} [{T} x {data.shape[0]} x 768, "
              f"{n} valid]: bit for bit K3's bm_t: {same_k3}; max|K5 - "
              f"plain|={err:.3g} (bound {bound}); padded blocks PAD_SIM: "
              f"{padded}" + chain)
        assert same_k3 and err <= bound and padded
        errs[dtype] = err
        times[dtype] = timing(
            cuda_ms(lambda: tk.matmul_blockmax_only(q, data, n)),
            cuda_ms(lambda: tk.matmul_blockmax_only_plain(q, data, n)),
            product_ms(q, data), nbytes(q, data, bm),
            2 * T * data.shape[0] * 768, PEAK_FOR[data.dtype])
        del store, data, q, bm, k3_bm, plain
        torch.cuda.empty_cache()

    store = DeviceStore.synthetic(10_027_008, 256, "bfloat16", seed + 6,
                                  device="cuda")
    data = store.data
    valid = 10_000_000
    q = data[torch.randint(0, valid, (T,), generator=gen, device="cuda")]
    bm = tk.matmul_blockmax_only(q, data, valid)
    err = max_abs(bm, tk.matmul_blockmax_only_plain(q, data, valid))
    head = 1_048_576
    _, k3_bm = tk.matmul_blockmax(q, data[:head], head)
    same_k3 = torch.equal(bm[:head // BLOCK], k3_bm)
    phase(f"phase 17 K5 bf16 [{T} x {data.shape[0]} x 256, {valid} valid]: "
          f"max|K5 - plain|={err:.3g} (bound {TOL}); bit for bit K3's bm_t "
          f"on the first {head} rows: {same_k3}")
    assert err <= TOL and same_k3
    errs["10m"] = err
    times["10m x 256"] = timing(
        cuda_ms(lambda: tk.matmul_blockmax_only(q, data, valid)),
        cuda_ms(lambda: tk.matmul_blockmax_only_plain(q, data, valid)),
        product_ms(q, data), nbytes(q, data, bm), 2 * T * data.shape[0] * 256,
        "bf16 tensor")
    del store, data, q, bm, k3_bm
    torch.cuda.empty_cache()
    for name, rec in times.items():
        phase(f"phase 17 [{card}] " + timing_line(
            f"matmul_blockmax_only {name}", rec))
    out = _run_module("phase 17 proto_calib", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_calib",
        "--seed", str(seed)])
    launches = _launches(out)["matmul_blockmax_only"]
    phase(f"phase 17 proto_calib: rc 0, K5 launches {launches}")
    assert launches > 0
    return max(errs.values()), times["bfloat16"], launches


def check_attention_head_major(gen, card):
    """Phase 18: K7 against its plain version and K8 at the encoder's
    shape; then the proto_attn A/B as a subprocess. Returns (err, timing,
    launches of the measurement run)."""
    from better_search_rag_rust_tpu_torch.bench.ab_attn import reference64
    from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    b, s, h, hd = B_ENC, S_ENC, H_ENC, HD_ENC
    qkv = torch.randn((b, s, 3 * h * hd), generator=gen,
                      device="cuda").to(torch.bfloat16)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lens[-1] = 0                                   # one fully padded row
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(valid, 0.0, -1e9).to(torch.float32).contiguous()
    cos, sin = (torch.from_numpy(t).cuda() for t in rotary_tables(s, hd, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos, sin)
    scale = 1.0 / math.sqrt(hd)
    q, k, v = (t.contiguous() for t in
               qkv.view(b, s, 3, h, hd).permute(2, 0, 3, 1, 4))

    def kern():
        return ak.fused_attention(q, k, v, c2, s2, bias, scale)

    def plain():
        return ak.fused_attention_plain(q, k, v, c2, s2, bias, scale)

    out, ref = kern(), plain()
    k8 = ak.fused_attention_qkv(qkv, c2, s2, bias, h, scale)
    torch.cuda.synchronize()
    rows = valid[:, None, :].expand(b, h, s)
    a, r = out.float()[rows], ref.float()[rows]
    err = max_abs(a, r)
    cos_sim = float((a * r).sum() / (a.norm() * r.norm()))
    finite = bool(torch.isfinite(out.float()).all())
    same_k8 = torch.equal(out.permute(0, 2, 1, 3).reshape(b, s, h * hd), k8)
    phase(f"phase 18 K7 [{b} x {h} heads x {s} x {hd}] bf16, padded keys: "
          f"max|out-plain| on valid rows={err:.4g} (bound {ATT_TOL}), "
          f"cosine={cos_sim:.7f} (bound {ATT_COS}), all finite: {finite}; "
          f"on the transposed Wqkv output bit for bit K8's (tolerance 0): "
          f"{same_k8}")
    assert err < ATT_TOL and cos_sim > ATT_COS and finite and same_k8

    def seq_major(x):
        return x.permute(0, 2, 1, 3).reshape(b, s, h * hd)

    phase("phase 18 " + f64_error_line(
        "K7", seq_major(out), seq_major(ref),
        reference64(qkv, c2, s2, bias, h, scale), valid))
    qr, kr, vr, mask = _rotated_qkv(qkv, c2, s2, bias, h)
    times = timing(
        cuda_ms(kern), cuda_ms(plain),
        cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask, scale=scale)),
        nbytes(q, k, v, c2, s2, bias, out), 4 * b * h * s * s * hd,
        "bf16 tensor")
    phase(f"phase 18 [{card}] " + timing_line("fused_attention", times))
    del qkv, q, k, v, out, ref, k8, a, r, qr, kr, vr
    torch.cuda.empty_cache()
    out = _run_module("phase 18 proto_attn", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_attn"])
    launches = _launches(out)
    phase(f"phase 18 proto_attn: rc 0, launches {launches}")
    assert launches["fused_attention"] > 0
    return err, times, launches["fused_attention"]


def _check_suite(res, name):
    assert "error" not in res, (name, res.get("error"))
    assert math.isfinite(res["value"]) and res["value"] > 0, res


def drive_measurement_path(tmp, card):
    """Phase 19: bench_torch.py and CLI bench (with a trace) as
    subprocesses, the pipeline, encode and jabref suites in this process;
    returns their K3 and K8 launches."""
    from better_search_rag_rust_tpu_torch.bench.suite import run_suite
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    out = _run_module("phase 19 bench_torch.py", ["bench_torch.py"],
                      env={"BENCH_SUITE": "search_100k"})
    line = json.loads(out.strip().splitlines()[-1])  # its last line
    phase(f"phase 19 [{card}] bench_torch.py search_100k: {line}")
    _check_suite(line, "search_100k")
    assert line["recall_at_10"] == 1.0 and line["oracle_overlap"] == 1.0
    assert line["mfu_peak_tflops"] and line["platform"] == "gpu"

    trace_dir = os.path.join(tmp, "trace")
    out = _run_module("phase 19 cli bench", [
        "-m", "better_search_rag_rust_tpu_torch", "bench", "--suite",
        "search_100k", "--json", "--profile-dir", trace_dir])
    _check_suite(_result_line(out), "cli bench")
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        names_k3 = "k3_blockmax" in f.read()
    phase(f"phase 19 cli bench --profile-dir: {traces} written; names K3's "
          f"kernel (k3_blockmax): {names_k3}")
    assert len(traces) == 1 and names_k3

    torch.cuda.synchronize()
    tk.reset_launch_counts()
    ak.reset_launch_counts()
    for name in ("pipeline", "encode", "jabref"):
        t0 = time.perf_counter()
        res = run_suite(name, device="cuda")
        phase(f"phase 19 [{card}] run_suite({name!r}) in "
              f"{time.perf_counter() - t0:.1f}s: " + json.dumps(res))
        _check_suite(res, name)
        if name == "jabref":
            assert res["recall_at_10"] == res["oracle_overlap"] == 1.0
        if name == "encode":
            assert res["finite"] and res["mfu_peak_tflops"]
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = {"matmul_blockmax": tk.launch_counts["matmul_blockmax"],
                "fused_attention_qkv": ak.launch_counts["fused_attention_qkv"]}
    phase(f"phase 19 kernel launches over the in-process suites: {launches}")
    assert all(v > 0 for v in launches.values()), launches
    return launches


def check_empty_batch(seed):
    """Phase 19: an empty query batch on every route and engine entry point
    (the JAX package answers [0, k])."""
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    from better_search_rag_rust_tpu_torch.config import SearchConfig

    empty = np.zeros((0, 64), np.float32)
    seen = {}
    for kernel, dtype in (("global", "bfloat16"), ("rescore", "bfloat16"),
                          ("rescore", "int8"), ("f32cert", "float32")):
        store = DeviceStore.synthetic(4096, 64, dtype, seed, device="cuda")
        engine = SearchEngine(store, SearchConfig(top_k=10, kernel=kernel,
                                                  store_dtype=dtype))
        some = store.data[:5].float().cpu().numpy()
        want = engine.search(some, 10)
        shapes = [engine.search(empty, 10)[0].shape,
                  engine.search_device(engine.prepare_device_queries(empty),
                                       10)[1].shape,
                  engine.oracle_topk(empty, 10)[0].shape]
        stream = list(engine.search_stream([some, empty, some], 10, depth=2))
        torch.cuda.synchronize()
        same = all(np.array_equal(g[0], want[0]) for g in (stream[0], stream[2]))
        seen[f"{kernel}/{dtype}"] = shapes + [stream[1][0].shape]
        assert engine.kernel_name(10) == kernel
        assert all(tuple(sh) == (0, 10) for sh in seen[f"{kernel}/{dtype}"])
        assert same
    phase(f"phase 19 empty batch (search, search_device, oracle_topk, "
          f"search_stream) per route: {seen}")


def _kernel_pairs(tk, q, data, valid, got):
    """Phase 20's kernel-against-kernel checks, by case: {check: passed}."""
    k1 = tk.matmul_blockmax2_only

    def k3_sims():
        return tk.matmul_blockmax(q, data, valid)[0].T

    return {
        "V3 sims->HBM + two-level": lambda: {
            "sims == K3's, transposed": torch.equal(got[0], k3_sims()),
            "bms, bm == K1's": all(map(torch.equal, got[1:], k1(
                q, data, valid, sub=16, block=128, emit_block=True)))},
        "bm2t_pass 1Mx768": lambda: {
            "sims == K3's, transposed": torch.equal(got[0], k3_sims()),
            "bm8, bm128 == K1's": all(map(torch.equal, got[1:], k1(
                q, data, valid, sub=8, block=128, emit_block=True)))},
        "B lane-reduce single-out S=16": lambda: {
            "bms [T, R/16] == K1's transposed": torch.equal(
                got[0], k1(q, data, valid, sub=16).T)},
        "+argmax": lambda: _argmax_pair(tk, got, k1(
            q, data, valid, sub=16, block=128, emit_block=True,
            emit_argmax=True)),
        "+argmax+max2": lambda: _argmax_pair(tk, got, k1(
            q, data, valid, sub=16, block=128, emit_block=True,
            emit_argmax=True)),
        "k1only": lambda: _raw_key_pair(got, k1(
            q, data, valid, sub=128, block=1024, emit_block=True,
            emit_argmax=True, emit_width=256)),
    }


def _argmax_pair(tk, got, k1_out):
    """P11 modes 1 (bms, arg, bm) and 2 (bms, arg, m2, bm) against K1."""
    bms, arg, *m2, bm = got
    k_bms, key, k_bm = k1_out
    pairs = {"bms, bm == K1's": torch.equal(bms, k_bms) and torch.equal(bm, k_bm),
             "arg == K1's key & 0x7F": torch.equal(arg, key & 0x7F)}
    if m2:
        pairs["pack(m2, arg) == K1's key"] = torch.equal(
            tk.pack_m2_argmax_key(m2[0], arg), key)
    return pairs


def _raw_key_pair(got, k1_out):
    raw_key, bms, bmi = got
    k_bms, key, k_bmi = k1_out
    return {"bms, bmi == K1's": torch.equal(bms, k_bms) and torch.equal(bmi, k_bmi),
            "raw key's row == K1's argmax": torch.equal(127 - (raw_key & 0x7F),
                                                        key & 0x7F)}


def check_proto_blockmax(seed, card):
    """Phase 20: P1-P16 at their scripts' shapes against their plain
    versions and each other; K10's time; the proto_blockmax measurement as
    a subprocess. Returns (K10's max error, its timing, the measurement
    run's launches, {name: (data, valid)} of its 10,027,008 x 256,
    1,048,576 x 768 and 1,001,472 x 768 bf16 stores, for phases 21 and
    22)."""
    from better_search_rag_rust_tpu_torch.bench import proto_blockmax as pb
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    stores, kept, k10_err, k10_time = {}, {}, 0.0, None
    for script, label, name, t, call in pb.CASES:
        if name not in stores:
            stores.clear()
            torch.cuda.empty_cache()
            stores[name] = pb.make_store(name, 1, seed + 7,
                                         torch.device("cuda"))
            if name in ("10m", "1m", "fused1m"):
                kept[name] = stores[name]
        data, valid = stores[name]
        q = pb.make_queries(name, data, valid, t, seed + 8)
        before = tk.launch_counts["matmul_blockmax2x"]
        got = pb.as_tuple(call(q, data, valid, False))
        on_k10 = tk.launch_counts["matmul_blockmax2x"] > before
        err, differ = pb.compare(got, pb.as_tuple(call(q, data, valid, True)))
        torch.cuda.synchronize()
        int8 = data.dtype == torch.int8
        bound = 0.0 if int8 else TOL
        pairs = _kernel_pairs(tk, q, data, valid, got).get(label, dict)()
        torch.cuda.synchronize()
        phase(f"phase 20 {script} {label} [{t} x {data.shape[0]} x "
              f"{data.shape[1]} {str(data.dtype)[6:]}, {valid} valid]"
              f"{' on K10' if on_k10 else ''}: max|kernel - plain|={err:.3g} "
              f"(bound {bound}), integer outputs differing {differ:.3g}"
              + "".join(f"; {k}: {v}" for k, v in pairs.items()))
        assert err <= bound and differ <= (0.0 if int8 else 1e-3), label
        assert all(pairs.values()), (label, pairs)
        if on_k10:
            k10_err = max(k10_err, err)
        if label == "V3 sims->HBM + two-level":
            k10_time = timing(
                cuda_ms(lambda: call(q, data, valid, False)),
                cuda_ms(lambda: call(q, data, valid, True)),
                product_ms(q, data), nbytes(q, data, *got),
                2 * t * data.shape[0] * data.shape[1], PEAK_FOR[data.dtype])
            phase(f"phase 20 [{card}] " + timing_line(
                "matmul_blockmax2x (bm2_v3: sims + bms + bm)", k10_time))
        del got
    stores.clear()
    torch.cuda.empty_cache()
    out = _run_module("phase 20 proto_blockmax", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_blockmax",
        "--seed", str(seed)])
    launches = _launches(out)
    phase(f"phase 20 proto_blockmax: rc 0, launches {launches}")
    for name in ("matmul_blockmax2x", "matmul_blockmax2_only",
                 "matmul_blockmax2_only_int8", "matmul_blockmax",
                 "matmul_blockmax_only"):
        assert launches.get(name, 0) > 0, (name, launches)
    return k10_err, k10_time, launches["matmul_blockmax2x"], kept


def _dma_timing(res):
    return {"ms": res["ms"], "plain_ms": res["plain_ms"], "library_ms": None,
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "peak": "bf16 tensor"}


def check_proto_dma(stores, seed, card):
    """Phase 21: P18-P21 at their scripts' shapes on phase 20's stores,
    against their plain versions and K2, K3, K4, K5 and K6; the proto_dma
    and proto_calib measurements as subprocesses. Returns ({kernel: max
    error}, {kernel: timing}, {kernel: launches over the phase's drive})."""
    from better_search_rag_rust_tpu_torch.bench import proto_dma as pd
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    args = argparse.Namespace(seed=seed + 9, rows_divisor=1)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    results, lines = pd.run_all(stores["10m"][0], stores.pop("1m")[0], args,
                                gen, dev)
    torch.cuda.synchronize()
    launches = {name: tk.launch_counts[name] for name in
                ("gather_copy", "gather_rescore_mm", "gather_rescore")}
    torch.cuda.empty_cache()
    for res in results:
        phase("phase 21 " + pd.result_line(res))
    for line in lines:
        phase("phase 21 " + line)
    v0 = next(r for r in results if r["case"].startswith("V0"))
    phase(f"phase 21 K11 gather_copy {v0['ms']:.3f} ms at or above its bytes "
          f"bound {v0['bound_ms']:.3f} ms: {v0['at_or_above_bound']}; bit "
          f"for bit K4's row 0: {v0['equals_k4_row0']}")
    phase(f"phase 21 kernel launches over the prototypes: {launches}")
    failed = [r["case"] for r in results if not r["ok"]]
    assert not failed, failed
    assert all(launches.values()), launches
    fused = [r for r in results if r["script"] == "proto_dma3"]
    errs = {"gather_copy": v0["max_abs_err"],
            "gather_rescore_mm": max(r["max_abs_err"] for r in fused)}
    times = {"gather_copy": _dma_timing(v0),
             "gather_rescore_mm": _dma_timing(next(
                 r for r in fused if "mm_n=1280" in r["case"]))}
    for name, rec in times.items():
        phase(f"phase 21 [{card}] " + timing_line(name, rec))
    out = _run_module("phase 21 proto_dma", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_dma",
        "--seed", str(seed)])
    sub = _launches(out)
    phase(f"phase 21 proto_dma: rc 0, launches {sub}")
    for name in ("gather_copy", "gather_rescore_mm", "gather_rescore",
                 "gather_rows", "block_scores", "matmul_blockmax",
                 "matmul_blockmax_only"):
        assert sub.get(name, 0) > 0, (name, sub)
    out = _run_module("phase 21 proto_calib", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_calib",
        "--seed", str(seed)])
    calib = _launches(out)
    phase(f"phase 21 proto_calib: rc 0, launches {calib}")
    assert calib.get("gather_rescore", 0) > 0, calib
    return errs, times, launches


def check_proto_fused(stores, seed, card):
    """Phase 22: P17 on phase 20's 1,001,472 x 768 (1,000,448 valid) and
    10,027,008 x 256 bf16 stores at the script's shapes (T 512, k 100, S
    16/32 and 32/128, G 1/2/4): K13 against its plain version, its diagonal
    bit for bit K2 at unit S, the end-to-end values bit for bit K3's on the
    first 8,192 rows and the exact-index match 1.0 on the 131,072-row
    prefix; then the proto_fused measurement as a subprocess. Returns (K13's
    max error, its timing at 1m S=16 G=2 from the measurement, its launches
    over the phase's drive)."""
    from better_search_rag_rust_tpu_torch.bench import proto_blockmax as pb
    from better_search_rag_rust_tpu_torch.bench import proto_fused as pf
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    k13_err = 0.0
    for name, (store_name, s_list) in pf.CONFIGS.items():
        data, valid = stores.pop(store_name)
        q = torch.randn((pf.T, data.shape[1]), generator=gen,
                        device=dev).to(torch.bfloat16)
        qf32 = q.float()
        for S in s_list:
            bms, bm = pb.proto_fused_bm2(q, data, valid, S=S)
            ids = pf.select_subblocks(bms, bm, pf.K, S=S)
            del bms, bm
            k2 = tk.gather_rescore(q, data, ids, unit=S)
            for G in pf.GS:
                out = pf.fused_scores(qf32, data, ids, S=S, G=G)
                err = max_abs(out, pf.fused_scores(qf32, data, ids, S=S, G=G,
                                                   plain=True))
                same = torch.equal(pf.extract_diag(out, S=S, G=G), k2)
                torch.cuda.synchronize()
                del out
                phase(f"phase 22 K13 gather_cross {name} [{pf.T} x k {pf.K} "
                      f"x S {S} of {data.shape[0]} x {data.shape[1]}] G={G}: "
                      f"max|kernel - plain|={err:.3g} (bound {TOL}); "
                      f"diagonal bit for bit K2 at unit {S}: {same}")
                assert err <= TOL and same, (name, S, G, err)
                k13_err = max(k13_err, err)
            del k2
            tv, ti = pf.e2e(qf32, data, valid, S=S)
            check = pf.bitwise_check(tv, ti, q, data, dev)
            match = pf.prefix_match(qf32, q, data, pf.K, S)
            phase(f"phase 22 {name} S={S} end to end ({valid} valid): values "
                  f"bit for bit K3's on the first {pf.BITWISE_ROWS} rows: "
                  f"{check['ok']} ({check['pairs']} pairs); exact-index "
                  f"match vs the oracle on the first {pf.ORACLE_ROWS} rows: "
                  f"{match}")
            assert check["ok"] and match == 1.0, (name, S, check, match)
        del data, q, qf32
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = tk.launch_counts["gather_cross"]
    phase(f"phase 22 kernel launches over the prototype: gather_cross "
          f"{launches}, matmul_blockmax2_only "
          f"{tk.launch_counts['matmul_blockmax2_only']}")
    assert launches > 0
    out = _run_module("phase 22 proto_fused", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_fused",
        "--seed", str(seed)])
    sub = _launches(out)
    phase(f"phase 22 proto_fused: rc 0, launches {sub}")
    for name in ("gather_cross", "matmul_blockmax2_only", "gather_rescore",
                 "matmul_blockmax"):
        assert sub.get(name, 0) > 0, (name, sub)
    res = next(r for r in _result_line(out)["results"]
               if r["case"] == "fused_scores 1m S=16 G=2 (K13)")
    timing = _dma_timing(res)
    phase(f"phase 22 [{card}] " + timing_line(
        "gather_cross (1m S=16 G=2, from the measurement)", timing))
    return k13_err, timing, launches


def check_proto_f32(seed, card):
    """Phase 23: P22 and P23 on one 1,015,808 x 768 f32 store built as the
    scripts build theirs: Q1's chain arm bit for bit, Q2 within EPS1, the
    EPS2 check, every certified query of ``build_fast``, ``p2_192/256/320``
    and ``p3_192/320`` equal to the oracle; then the proto_f32 measurement
    as a subprocess, which also holds K4 (P22) bit for bit its plain
    version and K2 f32 (P23) within 1e-5 of its plain version and bit for
    bit K6 on K4's rows."""
    from better_search_rag_rust_tpu_torch.bench import proto_f32 as pf
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    dev = torch.device("cuda")
    shard, queries = pf.make_store(pf.SCRIPTS, seed + 11, dev)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    lines = []
    checks = pf.run_checks(shard, queries, pf.SCRIPTS, dev, lines)
    torch.cuda.synchronize()
    for line in lines:
        phase("phase 23 " + line)
    failed = [name for name, c in checks.items() if not c["ok"]]
    assert not failed, (failed, checks)
    launches = {name: tk.launch_counts[name] for name in (
        "matmul_blockmax2_only", "gather_rows", "block_scores",
        "gather_rescore", "matmul_blockmax")}
    phase(f"phase 23 kernel launches over the prototypes: {launches}")
    assert all(launches.values()), launches
    del shard, queries
    torch.cuda.empty_cache()
    out = _run_module("phase 23 proto_f32", [
        "-m", "better_search_rag_rust_tpu_torch.bench.proto_f32",
        "--seed", str(seed)])
    sub = _launches(out)
    phase(f"phase 23 proto_f32: rc 0, launches {sub}")
    for name in launches:
        assert sub.get(name, 0) > 0, (name, sub)
    kernels = _result_line(out)["kernels"]
    assert all(k["ok"] for k in kernels) and all(
        k["equals_k6"] for k in kernels if "equals_k6" in k), kernels


#: Phase 24: queries per store, the k values, and (route, rescore_argmax);
#: f32 stores also take the certified route.
SWEEP_Q, SWEEP_KS = 1024, (10, 100)
SWEEP_ROUTES = (("global", "auto"), ("rescore", "on"), ("rescore", "off"))
SWEEP_F32_ROUTES = SWEEP_ROUTES + (("f32cert", "auto"),)


def _sweep_stores(seed):
    """The five stores of ``scripts/chip_exactness.py`` (``build_cases``),
    built as the script builds them, from ``seed`` (the script's 0 by
    default): random rows, duplicate clusters, zero rows, one 64-row block
    repeated, a tall low-dim store, and the large store whose clusters
    drive the argmax fast path's danger gather."""
    rng = np.random.default_rng(seed)
    yield "random_20k_768", rng.standard_normal((20000, 768)).astype(np.float32)
    m = rng.standard_normal((65536, 256)).astype(np.float32)
    m[30000:30050] = m[17]
    m[4096] = 0.0
    yield "dups_64k_256", m
    yield "all_dup_16k_128", np.tile(
        rng.standard_normal((64, 128)).astype(np.float32), (256, 1))
    yield "tall_300k_64", rng.standard_normal((300000, 64)).astype(np.float32)
    m = rng.standard_normal((600000, 768)).astype(np.float32)
    m[200000:200003] = m[123]
    m[450000] = m[123]
    m[37] = 0.0
    yield "dups_600k_768", m


def check_exactness_sweep(seed, card, dtype):
    """Phase 24: the exactness sweep on ``dtype`` stores (module docstring,
    item 24)."""
    import hashlib

    from better_search_rag_rust_tpu_torch.config import SearchConfig
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.distance import normalize_rows
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.ops.quantize import (
        INT8_INV_SCALE2,
        cast_rows_to,
    )
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    totals = {"configs": 0, "not_feasible": 0, "bounded_pairs": 0,
              "identity_pairs": 0}
    worst = 0.0  # the largest |score - exact| / bound over every store
    t0 = time.perf_counter()
    for name, mat in _sweep_stores(seed):
        store = DeviceStore.from_host(mat, dtype, device="cuda")
        n, data = store.num_rows, store.data
        qseed = int.from_bytes(hashlib.blake2b(
            name.encode(), digest_size=4).digest(), "little")
        queries = mat[np.random.default_rng(qseed).integers(0, n, SWEEP_Q)]
        q_dev = torch.from_numpy(queries).cuda()
        qc = cast_rows_to(normalize_rows(q_dev), store.dtype).contiguous()
        oracle = SearchEngine(store, SearchConfig(kernel="global"))
        configs = pairs = 0
        store_worst = 0.0
        f32 = store.dtype == torch.float32
        for k in SWEEP_KS:
            o_ids, o_d = oracle.oracle_topk(queries, k)
            for route, argmax in SWEEP_F32_ROUTES if f32 else SWEEP_ROUTES:
                eng = SearchEngine(store, SearchConfig(
                    kernel=route, rescore_argmax=argmax))
                if eng.kernel_name(k) != route:
                    totals["not_feasible"] += 1
                    continue
                tag = f"{name} {route} argmax={argmax} k={k}"
                ids, dists = eng.search(queries, k)
                bad = np.argwhere((ids != o_ids) | (dists != o_d))
                assert not bad.size, (tag, bad[:3].tolist())
                sims, d_ids = eng.search_device(q_dev, k)
                assert np.array_equal(d_ids.cpu().numpy(), ids), tag
                exact, bound = tk.score_bound(qc, data[d_ids])
                if store.dtype == torch.int8:
                    # the exact dot (below 2^24) in f32, one rounded multiply
                    assert torch.equal(sims, exact.float() * INT8_INV_SCALE2), tag
                else:
                    if f32:  # one exact FMA chain per score, whatever the route
                        assert torch.equal(sims, tk.fma_chain_scores(qc, data[d_ids])), tag
                    err = (sims.double() - exact).abs()
                    assert bool((err <= bound).all()), (
                        tag, float((err - bound).max()))
                    ratio = float((err / bound.clamp_min(1e-300)).max())
                    store_worst = max(store_worst, ratio)
                configs += 1
                pairs += ids.size
        # K2 at each unit's argmax row == K1's unit max == K3's score, as
        # in phase 3, on 256 random valid units per query
        bms, key = tk.matmul_blockmax2_only(qc, data, n, sub=SUB, block=BLOCK,
                                            emit_argmax=True)
        same, identity_pairs = unit_identity(tk, qc, data, n, bms, key)
        assert same, f"{name}: K1 == K2 == K3 fails on the unit argmax pairs"
        totals["configs"] += configs
        totals["bounded_pairs"] += pairs
        totals["identity_pairs"] += identity_pairs
        worst = max(worst, store_worst)
        scores = ("bit for bit the exact dot's" if store.dtype == torch.int8
                  else f"{'bit for bit fma_chain_scores, ' if f32 else ''}within "
                       f"the float64 bound (worst |err|/bound {store_worst:.3g})")
        phase(f"phase 24 {name} ({n} x {mat.shape[1]} {dtype}): {configs} "
              f"route configs equal to oracle_topk bit for bit, {pairs} "
              f"returned pairs {scores}, K1 == K2 == K3 on {identity_pairs} "
              f"unit argmax pairs")
        del store, data, sims, bms, key, q_dev, qc, oracle, eng
        torch.cuda.empty_cache()
    phase(f"phase 24 [{card}] {dtype} exactness sweep: {totals}, worst "
          f"|err|/bound {worst:.3g}, {time.perf_counter() - t0:.1f}s")
    # every store takes the global route (and f32cert) and, at 20k+ rows,
    # rescore
    assert totals["configs"] >= (10 if dtype == "float32" else 5) * len(SWEEP_KS)
    return totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from better_search_rag_rust_tpu_torch.bench.suite import write_java_tree
    from better_search_rag_rust_tpu_torch.config import (
        PipelineConfig,
        SearchConfig,
    )
    from better_search_rag_rust_tpu_torch.ops import _build
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    libs = [_build.library(name) for name in _build.SOURCES]
    build_wall = time.perf_counter() - t0
    for lib in libs:
        regs = [ln.split(":", 1)[1].strip() for ln in lib.log.splitlines()
                if "registers" in ln]
        spills = [ln.strip() for ln in lib.log.splitlines()
                  if "spill" in ln and not ln.strip().startswith(
                      "0 bytes stack frame, 0 bytes spill stores")]
        phase(f"phase 1 device: {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {lib.path.name} built in "
              f"{lib.build_s:.1f}s; ptxas: {' / '.join(regs)}; spills: "
              f"{' / '.join(spills) or 'none'}")
    phase(f"phase 1 kernel builds, in parallel: {build_wall:.1f}s wall")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    store = DeviceStore.synthetic(1_000_000, 768, "bfloat16", args.seed,
                                  device="cuda")
    store_100k = DeviceStore.synthetic(100_000, 768, "bfloat16",
                                       args.seed + 1, device="cuda")
    errs, times = check_kernels(store, store_100k, gen)

    cfg = PipelineConfig(search=SearchConfig(top_k=K), skip_process=True)
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    engine = drive_main_path("1M x 768 bf16", store, cfg, gen, "rescore")
    drive_main_path("100k x 768 bf16", store_100k, cfg, gen, "global")
    store_f32 = DeviceStore.synthetic(1_000_000, 768, "float32",
                                      args.seed + 2, device="cuda")
    drive_main_path("1M x 768 f32", store_f32, cfg, gen, "rescore",
                    bitwise=True)
    torch.cuda.synchronize()
    launches = {name: tk.launch_counts[name] for name in
                ("matmul_blockmax2_only", "gather_rescore", "matmul_blockmax")}
    phase(f"phase 4 kernel launches over the main path: {launches}")
    assert all(v > 0 for v in launches.values()), launches
    check_f32_rescore_pass(store_f32, gen, card)
    del store_f32

    host_qps, dev_qps = measure_qps(engine, store, gen)
    phase(f"phase 5 [{card}] 1M x 768 bf16, 1024 queries, k={K}: "
          f"search {host_qps:.1f} q/s, search_device {dev_qps:.1f} q/s")
    search_split(engine, store, gen, card)
    for name, rec in times.items():
        phase(f"phase 5 [{card}] " + timing_line(name, rec))

    del engine, store, store_100k
    torch.cuda.empty_cache()

    errs["fused_attention_qkv"], times["fused_attention_qkv"] = \
        check_attention(gen)
    phase(f"phase 6 [{card}] " + timing_line(
        "fused_attention_qkv", times["fused_attention_qkv"]))
    check_encoder(args.seed, card)
    tmp = tempfile.mkdtemp(prefix="bsr_smoke_")
    try:
        src = os.path.join(tmp, "src")
        write_java_tree(src, TREE_FILES, args.seed)
        launches["fused_attention_qkv"] = drive_build_mode(tmp, src,
                                                           args.seed, card)
        torch.cuda.empty_cache()
        errs["fused_attention_qkv_bwd"], times["fused_attention_qkv_bwd"] = \
            check_attention_bwd(gen)
        phase(f"phase 9 [{card}] " + timing_line(
            "fused_attention_qkv_bwd", times["fused_attention_qkv_bwd"]))
        launches["fused_attention_qkv_bwd"] = check_training(args.seed, card)
        drive_finetune_cli(tmp, src, card)
        torch.cuda.empty_cache()

        store_i8 = DeviceStore.synthetic(1_000_000, 768, "int8",
                                         args.seed + 3, device="cuda")
        i8_errs, i8_times = check_int8_kernels(store_i8, gen)
        errs.update(i8_errs)
        times.update(i8_times)
        check_int8_tile_edges(args.seed)

        store_i8_10m = DeviceStore.synthetic(10_000_000, 768, "int8",
                                             args.seed + 4, device="cuda")
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        for name, st in (("search_1m_int8 (1M x 768 int8)", store_i8),
                         ("search_10m_int8 (10M x 768 int8)", store_i8_10m)):
            eng = drive_main_path(name, st, cfg, gen, "rescore", "phase 13")
            host_qps, dev_qps = measure_qps(eng, st, gen, iters=3)
            phase(f"phase 13 [{card}] {name}, 1024 queries, k={K}: search "
                  f"{host_qps:.1f} q/s, search_device {dev_qps:.1f} q/s")
        torch.cuda.synchronize()
        for name in ("matmul_blockmax2_only", "gather_rescore",
                     "matmul_blockmax"):
            launches[name + "_int8"] = tk.launch_counts[name + "_int8"]
        phase(f"phase 13 int8 kernel launches over the int8 search path: "
              f"{ {n: v for n, v in launches.items() if 'int8' in n} }")
        assert all(v > 0 for n, v in launches.items() if "int8" in n)
        del store_i8, eng
        torch.cuda.empty_cache()

        store = DeviceStore.synthetic(1_000_000, 768, "bfloat16", args.seed,
                                      device="cuda")
        drive_serve_bench(store, store_i8_10m, card)
        serve_split(store_i8_10m, tmp, card)
        del store, store_i8_10m
        torch.cuda.empty_cache()

        drive_cli_serve(tmp, src, args.seed, card, TREE_FILES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cert_errs, cert_times, cert_launches = drive_f32cert(args.seed, gen, card)
    errs.update(cert_errs)
    times.update(cert_times)
    for name in ("gather_rows", "block_scores"):
        launches[name] = cert_launches[name]
    phase(f"phase 16 kernel launches over the certified route: "
          f"{cert_launches}")

    (errs["matmul_blockmax_only"], times["matmul_blockmax_only"],
     launches["matmul_blockmax_only"]) = check_blockmax_only(args.seed, gen,
                                                             card)
    (errs["fused_attention"], times["fused_attention"],
     launches["fused_attention"]) = check_attention_head_major(gen, card)
    tmp = tempfile.mkdtemp(prefix="bsr_smoke_")
    try:
        drive_measurement_path(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_empty_batch(args.seed)
    (errs["matmul_blockmax2x"], times["matmul_blockmax2x"],
     launches["matmul_blockmax2x"], stores) = check_proto_blockmax(args.seed,
                                                                   card)
    dma_errs, dma_times, dma_launches = check_proto_dma(stores, args.seed,
                                                        card)
    errs.update(dma_errs)
    times.update(dma_times)
    for name in ("gather_copy", "gather_rescore_mm"):
        launches[name] = dma_launches[name]
    (errs["gather_cross"], times["gather_cross"],
     launches["gather_cross"]) = check_proto_fused(stores, args.seed, card)
    check_proto_f32(args.seed, card)
    del stores
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "int8", "float32"):
        check_exactness_sweep(args.seed, card, dtype)

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         "lib_ms": times[name]["library_ms"]}
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
