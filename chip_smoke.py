"""Smoke run of the PyTorch port on one CUDA card: search, build, training
and serving paths.

    python3 chip_smoke.py        # from the repository root; needs one card

Builds the CUDA kernels from ``better_search_rag_rust_tpu_torch/ops/csrc``
(one nvcc per source, started together), then:

1. device: card name and power limit; kernel build times, registers,
   spills and how many functions ptxas serialized wgmmas in;
2. the instruction probe: one bf16 k16 step's f32 sums on wgmma
   (m64n128k16, scale-d = 0: K1/K3's score tile) and on mma.sync (m16n8k16
   from +0.0: K2/K6's gather), bit for bit on unit, normal, cancelling /
   mixed-exponent rows and random bit patterns (subnormals, +-inf, NaN),
   and how often each differs from the float64 sum rounded once; the PV
   probe: a bf16 product's k16 steps accumulated inside wgmma (m64n64k16,
   scale-d = 1: K8's PV) and inside mma.sync (the mma.sync K8's), bit for
   bit over 8 and 32 steps on the same data and on rows of softmax e;
   each search kernel (K1 matmul_blockmax2_only, K2 gather_rescore, K3
   matmul_blockmax; bf16 on the tensor cores) against its plain PyTorch
   version at the search path's shapes (a 1M x 768 store,
   nomic-embed-text-v1.5's width, queried 512 at a time, top-100), max
   |diff| <= 1e-5 (the plain versions sum in cuBLAS's f32 order, not the
   kernels' k16 steps);
   then K2 and K6 on the gather mainloop's staging paths (D 768, 130 and
   99 on f32, bf16 and int8; views off the 16-byte boundary; ids -1 and
   n_units score NaN), bit for bit ``fma_chain_scores`` (f32), the plain
   version (int8) or K3 (bf16), K6 over K4's rows bit for bit K2;
3. the search kernels against each other, bit for bit (one k16 sum, on
   either instruction, and one k16 order per bf16 score); the same identity on
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
   glue, device idle), how many of the tile's queries share each unit K2
   gathers (argmax path and full gather), and each search kernel's time
   beside its plain version's;
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
   counts;
25. sharded search on the card: (a) one process, a mesh of 2 shards on
   cuda:0, bf16 stores of 2,097,152 x 768 (K1 + K2 on each shard) and
   1,000,448 x 768 (507,904 rows a shard, under the rescore floor: K3 on
   each shard), 1024 queries, k = 100: ids and distances bit for bit the
   one-shard engine's on the same rows, oracle overlap 1.0, each shard's
   route, the kernels launched, both engines' q/s; (b) the same on int8
   stores; (c) two processes on the one card (gloo, the ``BSR_*`` env) over
   phase 8's nomic store: rank 0's ids and distances of 1024 queries bit
   for bit one process's, CLI ``search`` on both ranks with rank 0's top
   rows equal to one process's, and whether gloo's ``all_gather`` takes
   CUDA tensors;
26. multi-GPU training on the one card, every world's ranks gloo processes
   sharing cuda:0 (the ``BSR_*`` env): (a) ``bench/train_parallel.py`` at
   12 x 768, random weights from ``--seed``, 8 pairs of 512 tokens, on the
   meshes 2 x 1 (DP) and 1 x 2 (TP) over 2 ranks and 2 x 2 (DP x TP) over
   4, sequence parallelism on: the first step's loss within 5e-3 of the
   one-process trainer's and every parameter's gradient at cosine above
   0.99 and its norm within 5 %, then 3 steps with finite, decreasing
   losses equal on every rank, and exactly 24 K8 and 24 K9 launches a step
   on each rank (2 towers x 12 layers); steps/s of each world; (b) CLI
   ``finetune --tp 2`` on phase 8's tree under 2 ranks: rc 0 on both, rank
   0 alone prints; a one-process trainer takes the same 2 steps from the
   same seed on the same pairs: rank 0's printed losses within 5e-3 of
   its losses, the checkpoint's update of the whole model at cosine above
   0.99 to its update and every parameter's update norm within 5 % of
   its, and the checkpoint reloads into a one-process trainer bit for bit
   (a format check); (c) a ``Pipeline`` over a mesh of 2 shards on cuda:0
   builds phase 8's tree with the nomic backend, every batch split over
   the two: the store's rows within 2e-3 of phase 8's one-shard store
   (``tests/test_torch_encode_mesh.py``'s bf16 bound), ``dp_devices`` 2;
27. ``attention_impl="flash"`` (K14 forward, K15 + K16 backward) past K8's
   1,024 tokens: (a) K14 against its plain version on bf16 [32, 12, 2048,
   64] with random padding per row (every row, pad rows included, within
   K8's bound; both against float64 on a slice), bit for bit across runs
   and with the tile plan (made from the segment ids) on and off, its
   time with the plan and with none beside its bound, plain and SDPA with
   the boolean segment mask, the plan's skipped and computed tile pairs;
   unpadded beside its bound over all S x S and SDPA without a mask; K14
   alone at [2, 12, 8192, 64]; K14 at K8's shape beside K8; (b)
   K15 and K16 against the plain backward at [8, 12, 2048, 64], the
   step's shape (K9's bound), two backward runs bit for bit, their times
   beside bound, plain and SDPA's backward (each bound counts the pairs
   the segment rule leaves, not all S x S); (c) the encoder at 12 x 768 on 32 x 2,048 tokens:
   12 K14 launches a forward, files/s, its device split (with the largest
   torch ops inside "the rest" named), pooled cosine
   0.999 to the ``xla`` path on 4 unpadded rows; (d) build mode on phase
   8's tree at ``max_tokens`` 2,048: the store's meta ``torch-flash``,
   oracle overlap 1.0; (e) one finetune step on 8 pairs x 2,048: a finite
   loss, 24 launches each of K14, K15 and K16, the step's device split
   (the rest's largest torch ops named);
   at 2 pairs every gradient at cosine 0.99 to the ``xla`` path's.
28. non-finite search: (a) the 64 x 32 cases of
   tests/test_torch_nonfinite.py (:func:`nan_case`: a NaN row, NaN
   queries, a +-inf query, each NaN and infinity of either sign), stores
   built by the port on the card, f32/bf16/int8, routes ``rescore``
   (argmax auto/off/on), ``global`` and (f32) ``f32cert``: every route's
   ids are :data:`NAN_PINS`, the CPU tests' pins; (b) 1,000,448 x 768
   bf16, f32 and int8 stores, 1024 queries (a NaN entry of each sign,
   +-inf entries, and, once the rows are NaN, two NaN rows as queries),
   k = 100, first finite (the argmax fast path handing NaN query tiles to
   the full gather), then with NaN rows of either sign at a unit's first
   row, mid-unit and in the last block (int8: the lattice's zero rows):
   every route's ids and distances equal the same route run with the
   plain versions of K1, K2, K3, K4 and K6 (:func:`plain_kernels`; bit
   for bit on int8, else within TOL with ids equal wherever two rows do
   not lie within 2 * TOL), every finite query ranks the NaN rows first,
   the store-finiteness gate turns the argmax fast path off, and the
   route kernels launched;
29. K17 ``normalize_cast`` (the store's and the queries' normalize and
   cast in one pass) on 1024 x 768 queries and on one 131,072 x 768 store
   block (``_BUILD_ROWS``), to bf16, int8 and f32, with NaN rows of each
   sign, +-inf, a zero row and a row whose sum of squares overflows: bit
   for bit its plain version on the card, its finite rows bit for bit the
   CPU plain version's; its device time alone (CUDA events over 200
   launches queued behind a sleep kernel) and the profiler's kernel time,
   its time as called, its bound, the plain version's, the parent's chain
   (``cast_rows_to(normalize_rows(x))``) and, as a yardstick of another
   function, ``F.normalize(x).to(dtype)``; the same kernel with
   normalization off (the bf16 cast alone) on the same rows, bit for bit
   its plain version, beside torch's own cast; then the engine's query
   prep and the store's block fill: one K17 launch a call, no aten op
   dispatched but an allocation or a view (a TorchDispatchMode log), and
   torch.profiler, after a warm-up cycle, records K17 kernels and no other
   kernel or aten op on the card.

The kernels line's ``ms`` is every kernel's time as called (CUDA events
around back-to-back calls, :func:`cuda_ms`); ``device_alone_ms`` is K17's
device time alone (:func:`queued_ms`), null for the others.

Every kernel's time is printed beside its plain version's, one PyTorch call
computing the same function where there is one (``library``: the product
alone for K1/K3/K5, ``scaled_dot_product_attention`` on rotated q/k/v for
K7/K8/K9 and with the boolean segment mask for K14 (its whole backward for
K15/K16), indexing for K4, ``bmm`` for K6; none for K2, K11, K12, K13 and
K17), and
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
import contextlib
import dataclasses
import json
import math
import os
import re
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
LIB_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
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
    # the library's flash attention, which the JAX encoder calls with
    # attention_impl="flash" (jax 0.9.0)
    "flash_attention_fwd": (CSRC + "flash_kernels.cu",
                            LIB_FLASH + ":758"),
    "flash_attention_bwd_dkv": (CSRC + "flash_kernels.cu",
                                LIB_FLASH + ":1121"),
    "flash_attention_bwd_dq": (CSRC + "flash_kernels.cu",
                               LIB_FLASH + ":1456"),
    # no Pallas kernel: the JAX package's XLA fusion that normalizes and
    # casts store rows (and, inside the jitted search, query rows)
    "normalize_cast": (CSRC + "topk_kernels.cu",
                       "better_search_rag_rust_tpu/store/device_store.py:62"),
}
#: the encoder's shape: batch, sequence, heads, head width
B_ENC, S_ENC, H_ENC, HD_ENC = 256, 512, 12, 64
ATT_TOL, ATT_COS = 0.02, 0.999
TREE_FILES = 4096
#: the finetune shape (the JAX finetune suite's batch) and the smaller batch
#: at which the plain attention's gradients fit beside the kernels'
B_TRAIN, B_GRAD = 64, 8
#: phase 26's worlds (ranks, meshes over them) and its bounds: the first
#: step's loss against one process's, a gradient's norm (relative), and the
#: rows of a store built over 2 local shards against one shard's
TRAIN_WORLDS = ((2, "2x1,1x2"), (4, "2x2"))
PAR_LOSS_TOL, PAR_NORM_DEV, SHARD_TOL = 5e-3, 0.05, 2e-3
BWD_REL, BWD_COS, GRAD_COS = 1e-2, 0.999, 0.99
TIMED_STEPS = 8
#: phase 27: the flash path's context (past K8's 1,024 tokens), its
#: encoder batch, the backward's batch and the finetune step's pairs
S_FLASH, B_FLASH, B_FLASH_STEP = 2048, 32, 8
B_FLASH_BWD = B_FLASH_STEP
#: phase 28's pinned ids on the 64 x 32 cases of
#: tests/test_torch_nonfinite.py (a NaN of either sign ranks above +inf; the
#: int8 lattice quantizes a NaN to 0), which the CPU tests hold too
NAN_PINS = {
    "nan_row": {"float32": [[0, 1, 2, 3], [5, 6, 12, 27]],
                "bfloat16": [[0, 1, 2, 3], [5, 6, 12, 27]],
                "int8": [[0, 1, 2, 3], [6, 12, 27, 15]]},
    "nan_query": dict.fromkeys(("float32", "bfloat16", "int8"),
                               [[0, 1, 2], [0, 1, 2]]),
    "inf_query": dict.fromkeys(("float32", "bfloat16", "int8"), [[0, 1, 2]]),
}


def nan_case(case: str, sign: int):
    """``(matrix, queries, k)`` of a pinned case: the 64 x 32 matrices of
    tests/test_torch_nonfinite.py (standard normal, seed 0, row 10 = row 3,
    row 7 = 0), with row 5 NaN (queries: rows 5 and 6), queries 0 and 1
    with a NaN first entry, or query 1 with an infinite one; every NaN and
    infinity takes ``sign``."""
    rng = np.random.default_rng(0)
    mat = rng.standard_normal((64, 32)).astype(np.float32)
    mat[10] = mat[3]
    mat[7] = 0.0
    nan = np.array([0x7FC00000 if sign > 0 else 0xFFC00000],
                   np.uint32).view(np.float32)[0]
    if case == "nan_row":
        mat[5, 0] = nan
        return mat, mat[[5, 6]], 4
    if case == "nan_query":
        q = mat[[0, 1]].copy()
        q[:, 0] = nan
        return mat, q, 3
    q = mat[[1]].copy()
    q[0, 0] = sign * np.inf
    return mat, q, 3


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


#: the instruction probe's kinds of data (probe_operands)
PROBE_KINDS = ("unit", "normal", "cancel_mixed", "special")


def probe_operands(kind: str, seed: int, rows: int = 4096, dim: int = 768,
                   device="cuda"):
    """bf16 ``(rows [rows, dim], queries [128, dim])`` for the instruction
    probe, from numpy's generator: unit rows, the queries among them; raw
    normal rows and queries; rows built for cancellation (the first half:
    odd features the exact negation of the even ones, every 8th feature
    free, against queries whose odd features repeat the even ones) and for
    mixed exponents (the second half: features near 2^-10 with one near
    2^10 in every 16-feature step); random bf16 bit patterns on a quarter
    of the entries (subnormals, +-inf, NaN, the extremes) among normal
    values."""
    rng = np.random.default_rng(seed + 97 * PROBE_KINDS.index(kind))
    m = rng.standard_normal((rows, dim)).astype(np.float32)
    q = rng.standard_normal((128, dim)).astype(np.float32)
    if kind == "unit":
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        q = m[rng.integers(0, rows, 128)]
    elif kind == "cancel_mixed":
        half = rows // 2
        m = torch.from_numpy(m).to(torch.bfloat16).float().numpy()
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
        free = np.zeros(dim, dtype=bool)
        free[1::8] = True
        odd = np.arange(1, dim, 2)
        keep = odd[~free[odd]]
        m[:half, keep] = -m[:half, keep - 1]
        q[:, keep] = q[:, keep - 1]
        m[half:] *= 2.0 ** -10
        big = np.arange(0, dim, 16)[None, :] + rng.integers(
            0, 16, (rows - half, -(-dim // 16)))
        big = np.minimum(big, dim - 1)
        np.put_along_axis(m[half:], big, rng.standard_normal(big.shape)
                          .astype(np.float32) * 2.0 ** 10, axis=1)
    out = []
    for a in (m, q):
        t = torch.from_numpy(a).to(torch.bfloat16)
        if kind == "special":
            bits = t.view(torch.int16).numpy().copy()
            pick = rng.random(bits.shape) < 0.25
            bits[pick] = rng.integers(-32768, 32768, int(pick.sum())).astype(
                np.int16)
            t = torch.from_numpy(bits).view(torch.bfloat16)
        out.append(t.to(device).contiguous())
    return out[0], out[1]


def probe_counts(wg, mma):
    """How the probe's two instructions' sums differ, cell by cell:
    ``cells``; ``differ`` (any bit); ``zero_sign`` (+0.0 against -0.0);
    ``nan_bits`` (NaN on both, other bits); ``nan`` (cells NaN on either)."""
    a, b = wg.view(torch.int32), mma.view(torch.int32)
    differ = a != b
    zero = differ & (wg == 0) & (mma == 0)
    nan_both = differ & torch.isnan(wg) & torch.isnan(mma)
    return {"cells": wg.numel(), "differ": int(differ.sum()),
            "zero_sign": int(zero.sum()), "nan_bits": int(nan_both.sum()),
            "nan": int((torch.isnan(wg) | torch.isnan(mma)).sum())}


def check_probe(seed: int) -> None:
    """Phase 2's instruction probe: a bf16 k16 step's f32 sums on ``wgmma``
    (scale-d = 0, the score tile's) and on ``mma.sync`` from +0.0 (the
    gathers'), bit for bit on every kind of data; fails otherwise."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    for kind in PROBE_KINDS:
        rows, q = probe_operands(kind, seed)
        wg, mma = tk.probe_bf16_k16(rows, q)
        plain, _ = tk.probe_bf16_k16_plain(rows, q)
        torch.cuda.synchronize()
        counts = probe_counts(wg, mma)
        fin = torch.isfinite(wg) & torch.isfinite(plain)
        off = int((wg.view(torch.int32) != plain.view(torch.int32))[fin].sum())
        phase(f"phase 2 bf16 k16 probe, {kind} [{rows.shape[0]} x "
              f"{rows.shape[1]} x 128]: wgmma vs mma.sync {counts}; wgmma vs "
              f"the float64 sum rounded once, on {int(fin.sum())} finite "
              f"cells: {off} differ")
        assert counts["differ"] == 0, (kind, counts)


#: the PV probe's kinds of data: the instruction probe's, and rows of e
PV_PROBE_KINDS = PROBE_KINDS + ("softmax",)
#: k16 steps the PV probe accumulates (a 128-key and a 512-key row)
PV_PROBE_STEPS = (8, 32)


def pv_probe_operands(kind: str, seed: int, steps: int, rows: int = 4096,
                      device="cuda"):
    """bf16 ``(a [rows, 16 steps], b [16 steps, 64])`` for the PV probe:
    :func:`probe_operands`' rows and the first 64 queries (transposed) of
    that kind at width 16 steps; ``softmax``: a's rows e = exp(l - max l)
    of normal logits (what PV takes as A), b normal (V)."""
    if kind == "softmax":
        rng = np.random.default_rng(seed + 1000 + steps)
        lg = 3 * rng.standard_normal((rows, 16 * steps)).astype(np.float32)
        e = np.exp(lg - lg.max(axis=1, keepdims=True))
        v = rng.standard_normal((16 * steps, 64)).astype(np.float32)
        return tuple(torch.from_numpy(x).to(torch.bfloat16).to(device).contiguous()
                     for x in (e, v))
    a, q = probe_operands(kind, seed + steps, rows=rows, dim=16 * steps,
                          device=device)
    return a, q[:64].T.contiguous()


def check_probe_pv(seed: int) -> None:
    """Phase 2's PV probe: a bf16 product's k16 steps accumulated inside
    ``wgmma`` (scale-d = 1 from zero: K8's PV) and inside ``mma.sync`` (from
    +0.0: the mma.sync K8's PV), over 8 and 32 steps on every kind of
    data, bit for bit; and each against the plain version (each step's
    exact sum added with one f32 rounding). Fails if the two instructions
    differ: K8's PV rests on their agreement."""
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak

    for kind in PV_PROBE_KINDS:
        for steps in PV_PROBE_STEPS:
            a, b = pv_probe_operands(kind, seed, steps)
            wg, mma = ak.probe_pv_acc(a, b)
            plain, _ = ak.probe_pv_acc_plain(a, b)
            torch.cuda.synchronize()
            counts = probe_counts(wg, mma)
            fin = torch.isfinite(wg) & torch.isfinite(plain)
            off = int((wg.view(torch.int32) != plain.view(torch.int32))[fin].sum())
            phase(f"phase 2 PV probe, {kind} [{a.shape[0]} x {a.shape[1]} x 64],"
                  f" {steps} k16 steps: wgmma vs mma.sync {counts}; wgmma vs "
                  f"each step's exact sum added with one rounding, on "
                  f"{int(fin.sum())} finite cells: {off} differ")
            assert counts["differ"] == 0, (kind, steps, counts)


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

    check_gather_paths(gen)

    # phase 3: K2 at each unit's argmax row == K1's unit max == K3's score
    same, pairs = unit_identity(tk, q, data, n, bms, key, gen)
    phase(f"phase 3 identity on {pairs} (query, unit argmax) pairs: "
          f"K1 == K2 == K3 bitwise: {same}")
    assert same
    return errs, times


def check_gather_paths(gen):
    """Phase 2, the gather mainloop's staging paths (K2 and K6 on every
    dtype): D 768 (16-byte copies), 130 (4-byte; bytes on int8) and 99
    (4-byte on f32, bytes otherwise), and views one element off their
    buffers' 16-byte boundary; ids -1 and n_units score NaN; K2 bit for bit
    ``fma_chain_scores`` on f32, its plain version on int8, K3's scores on
    bf16, and K6 over K4's rows bit for bit K2."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.quantize import quantize_unit

    ok, cases = True, 0
    for dim in (768, 130, 99):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for offset in (0, 1):
                m = torch.randn((2048 + 24, dim), generator=gen, device="cuda")
                m = m / m.norm(dim=1, keepdim=True)
                m = quantize_unit(m) if dtype == torch.int8 else m.to(dtype)
                buf = torch.zeros(m.numel() + offset, dtype=dtype, device="cuda")
                both = buf[offset:].view(m.shape)
                both.copy_(m)
                q, mat = both[2048:], both[:2048]
                ids = torch.sort(torch.randint(0, 128, (24, 9), generator=gen,
                                               device="cuda"), dim=1).values
                ids = ids.to(torch.int32).contiguous()
                bad = ids.clone()
                bad[0, 0], bad[5, 8] = -1, 128
                out = tk.gather_rescore(q, mat, bad, unit=16)
                cols = (ids.long()[:, :, None] * 16
                        + torch.arange(16, device="cuda")).reshape(24, -1)
                if dtype == torch.float32:
                    want = tk.fma_chain_scores(q, mat[cols])
                elif dtype == torch.int8:
                    want = tk.gather_rescore_plain(q, mat, ids, unit=16)
                else:
                    sims, _ = tk.matmul_blockmax(q.contiguous(), mat.contiguous(),
                                                 2048)
                    want = torch.gather(sims, 1, cols)
                nan = torch.zeros_like(out, dtype=torch.bool)
                nan[0, :16] = nan[5, 128:] = True
                k6 = tk.block_scores(q, tk.gather_rows(mat, ids, unit=16))
                torch.cuda.synchronize()
                ok &= (bool(out[nan].isnan().all())
                       and torch.equal(out[~nan], want[~nan])
                       and torch.equal(k6, tk.gather_rescore(q, mat, ids, unit=16)))
                cases += 1
    phase(f"phase 2 K2/K6 staging paths (D 768/130/99 x f32/bf16/int8 x "
          f"aligned/offset views, ids -1 and n_units): {cases} cases, every "
          f"score bit for bit its reference and NaN for the bad ids: {ok}")
    assert ok


def unit_sharing(engine, store, gen, card):
    """Phase 5: how many queries of one 512-query tile share each unit the
    rescore route gathers (the case for reading each selected unit once for
    all the queries that chose it): K2's ids on the argmax path (the danger
    units) and with ``rescore_argmax="off"`` (the full gather)."""
    from better_search_rag_rust_tpu_torch.ops import engine as engine_mod
    from better_search_rag_rust_tpu_torch.ops import topk as topk_mod

    rows = torch.randint(0, store.num_rows, (T,), generator=gen, device="cuda")
    qdev = store.data[rows].float()
    seen = []
    orig = topk_mod.gather_rescore

    def recording(q, shard, ids, *, unit):
        seen.append((ids.clone(), unit))
        return orig(q, shard, ids, unit=unit)

    topk_mod.gather_rescore = recording
    try:
        parts = []
        for mode in ("auto", "off"):
            seen.clear()
            eng = engine_mod.SearchEngine(store, dataclasses.replace(
                engine.config, rescore_argmax=mode))
            eng.search_device(qdev, K)
            torch.cuda.synchronize()
            if not seen:
                parts.append(f"argmax {mode}: no gather")
                continue
            ids, unit = seen[-1]
            n_sel = ids.numel()
            _, counts = torch.unique(ids, return_counts=True)
            parts.append(
                f"argmax {mode}: {tuple(ids.shape)} ids of {unit}-row units, "
                f"{counts.numel()} distinct ({n_sel / counts.numel():.3f} "
                f"queries a unit, at most {int(counts.max())})")
    finally:
        topk_mod.gather_rescore = orig
    phase(f"phase 5 [{card}] unit sharing in K2's selections, one {T}-query "
          f"tile of the 1M store: " + "; ".join(parts))


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


#: kernel groups of a device-time split: name -> parts of the kernels' names
K8_K9 = {"K8": ("k8_fused_attention_qkv",),
         "K9": ("k9_rotate_qk", "k9_wg_query", "k9_wg_key")}
K14_K16 = {"K14": ("k14_flash_fwd",), "K15": ("k15_flash_bwd_dkv",),
           "K16": ("k16_flash_bwd_dq",)}


def _device_profile(fn, groups=K8_K9):
    """Device time by kernel over one call of ``fn`` (torch.profiler):
    ({group: ms, ..., "GEMMs": ms, "rest": ms}, total ms, [(ms, kernel)]
    longest first), the groups as ``groups`` names them."""
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
    split = {name: sum(ms for ms, key in rows if any(p in key for p in parts))
             for name, parts in groups.items()}
    ours = [p for parts in groups.values() for p in parts]
    split["GEMMs"] = sum(ms for ms, key in rows
                         if not any(p in key for p in ours) and any(
                             w in key.lower()
                             for w in ("gemm", "nvjet", "xmma", "cutlass")))
    total = sum(ms for ms, _ in rows)
    split["rest"] = total - sum(split.values())
    return split, total, rows


#: aten ops whose kernels are the GEMMs of a device split
GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::_scaled_mm")


def glue_ops(fn, n: int = 8) -> str:
    """What makes up the "rest" of a device split, by the torch op that
    launched it: the ``n`` aten ops whose own kernels take the most device
    time over one call of ``fn`` (torch.profiler's self device time; the
    port's kernels are launched by no aten op, the GEMMs' ops are left
    out), as ``op ms (calls)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if evt.key.startswith("aten::") and evt.key not in GEMM_OPS and us > 0:
            rows.append((us / 1e3, evt.key, evt.count))
    rows.sort(reverse=True)
    return "; ".join(f"{key} {ms:.2f} ms ({count})" for ms, key, count in rows[:n])


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
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.ops.quantize import INT8_INV_SCALE2
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
        qc = tk.normalize_cast(q_dev, store.dtype)
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


#: phase 25's stores: (dtype, rows, the route of each of 2 shards, the
#: kernels that route launches); 1,000,448 rows are 507,904 a shard, under
#: the 2^19-row rescore floor, so K3 (the one-shard engine takes K1 + K2)
SHARDED_STORES = (
    ("bfloat16", 2_097_152, "rescore",
     ("matmul_blockmax2_only", "gather_rescore")),
    ("bfloat16", 1_000_448, "global", ("matmul_blockmax",)),
    ("int8", 2_097_152, "rescore",
     ("matmul_blockmax2_only_int8", "gather_rescore_int8")),
    ("int8", 1_000_448, "global", ("matmul_blockmax_int8",)),
)

#: phase 25(c)'s rank: one process of two on the one card (gloo)
SHARDED_WORKER = r"""
import contextlib, io, json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from better_search_rag_rust_tpu_torch import cli
from better_search_rag_rust_tpu_torch.config import (
    PipelineConfig, SearchConfig, StoreConfig)
from better_search_rag_rust_tpu_torch.launch import maybe_init_distributed
from better_search_rag_rust_tpu_torch.pipeline import Pipeline

store_dir, out, k = sys.argv[1], sys.argv[2], int(sys.argv[3])
assert maybe_init_distributed()
rank = dist.get_rank()
# does gloo's all_gather take CUDA tensors on this torch? (the path's
# gather_ranks hands its [Q, k] blocks to all_gather as CUDA tensors)
probe = torch.full((4,), float(rank), device="cuda")
try:
    parts = [torch.empty_like(probe) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, probe)
    gloo_cuda = "works: " + str([p[0].item() for p in parts])
except Exception as exc:
    gloo_cuda = f"raises {type(exc).__name__}: {str(exc)[:160]}"
pipe = Pipeline(PipelineConfig(store=StoreConfig(dir=store_dir),
                               search=SearchConfig(top_k=k),
                               skip_process=True))
engine = pipe.engine()
rows = np.linspace(0, engine.store.num_rows - 1, 1024).astype(np.int64)
queries = engine.store.take_rows(rows).float().cpu().numpy()
ids, dists = engine.search(queries, k)
t0 = time.perf_counter()
for _ in range(3):
    engine.search(queries, k)
qps = 3 * 1024 / (time.perf_counter() - t0)
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    rc = cli.main(["search", "--store-dir", store_dir, "--top-k", str(k)])
if rank == 0:
    np.savez(out, ids=ids, dists=dists, rows=rows)
    with open(out + ".json", "w") as f:
        json.dump({"gloo_cuda": gloo_cuda, "qps": qps, "rc": rc,
                   "routes": engine.shard_routes(k),
                   "mesh": [[s.rank, str(s.device)]
                            for s in engine.store.mesh.shards],
                   "cli": printed.getvalue()}, f)
dist.destroy_process_group()
"""


def engine_qps(engine, queries, iters: int = 3):
    """``search`` and ``search_device`` queries/sec on ``queries``."""
    engine.search(queries, K)  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search(queries, K)
    host = len(queries) * iters / (time.perf_counter() - t0)
    qdev = engine.prepare_device_queries(queries)
    engine.search_device(qdev, K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.search_device(qdev, K)
    torch.cuda.synchronize()
    return host, len(queries) * iters / (time.perf_counter() - t0)


def _top_lines(printed):
    """The ranked ``N. row R  dist D`` lines of a ``search``'s output."""
    return [ln.strip() for ln in printed.splitlines()
            if ln.strip()[:1].isdigit() and ". row " in ln]


def check_sharded(seed, gen, card, store_dir):
    """Phase 25: the store sharded over a mesh of 2 shards on cuda:0 —
    (a) bf16 and (b) int8 at 2,097,152 x 768 (K1 + K2 on each shard) and
    1,000,448 x 768 (K3 on each shard), 1024 queries, k = K: ids and
    distances bit for bit the one-shard engine's on the same rows, oracle
    overlap 1.0, each shard's route and both engines' q/s; (c) two
    processes on the one card (gloo, the ``BSR_*`` env) on phase 8's nomic
    store: rank 0's ``search`` ids and distances bit for bit this
    process's, CLI ``search`` on both ranks printing rank 0's top rows."""
    import sys

    from better_search_rag_rust_tpu_torch.config import (
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu_torch.metrics import top_k_overlap
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    t0 = time.perf_counter()
    mesh = create_mesh(devices=["cuda:0", "cuda:0"])
    cfg = SearchConfig(top_k=K)
    for i, (dtype, rows, route, kernels) in enumerate(SHARDED_STORES):
        one = DeviceStore.synthetic(rows, 768, dtype, seed + 25 + i,
                                    device="cuda")
        two = one.reshard(mesh)
        e1, e2 = SearchEngine(one, cfg), SearchEngine(two, cfg)
        q_rows = torch.randint(0, rows, (1024,), generator=gen, device="cuda")
        queries = one.take_rows(q_rows.cpu().numpy()).float().cpu().numpy()
        torch.cuda.synchronize()
        tk.reset_launch_counts()
        ids2, d2 = e2.search(queries, K)
        torch.cuda.synchronize()
        launches = {n: tk.launch_counts[n] for n in kernels}
        ids1, d1 = e1.search(queries, K)
        same = np.array_equal(ids1, ids2) and np.array_equal(d1, d2)
        o_ids, _ = e2.oracle_topk(queries, K)
        overlap = top_k_overlap(o_ids.tolist(), ids2.tolist(), K)
        host1, dev1 = engine_qps(e1, queries)
        host2, dev2 = engine_qps(e2, queries)
        routes = e2.shard_routes(K)
        phase(f"phase 25 [{card}] {rows} x 768 {dtype} on 2 shards of "
              f"cuda:0 ({two.per_device_rows} rows each, valid "
              f"{[two.shard_valid(s) for s in range(2)]}): routes {routes} "
              f"(one shard: {e1.kernel_name(K)}); ids and distances == the "
              f"one-shard engine's bitwise: {same}; oracle overlap "
              f"{overlap}; launches {launches}; search {host2:.1f} q/s, "
              f"search_device {dev2:.1f} q/s (one shard: {host1:.1f}, "
              f"{dev1:.1f})")
        assert routes == [route, route], routes
        assert same and overlap == 1.0
        assert all(v > 0 for v in launches.values()), launches
        del one, two, e1, e2
        torch.cuda.empty_cache()

    repo = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(os.path.dirname(store_dir), "sharded_rank0.npz")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARDED_WORKER, store_dir, out, str(K)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo,
                 BSR_COORDINATOR=f"127.0.0.1:{port}", BSR_NUM_PROCESSES="2",
                 BSR_PROCESS_ID=str(rank), BSR_DIST_TIMEOUT_S="120"))
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (rank, p.returncode, err[-3000:])
    got = np.load(out)
    info = json.loads(open(out + ".json").read())
    pipe = Pipeline(PipelineConfig(store=StoreConfig(dir=store_dir),
                                   search=SearchConfig(top_k=K),
                                   skip_process=True), device="cuda")
    engine = pipe.engine()
    queries = engine.store.take_rows(got["rows"]).float().cpu().numpy()
    ids, dists = engine.search(queries, K)
    same = (np.array_equal(got["ids"], ids)
            and np.array_equal(got["dists"], dists))
    result = pipe.run()
    want = [f"{r}. row {idx:>8}  dist {d:.6f}"
            for r, (idx, d) in enumerate(result.top_k[:10], 1)]
    printed = _top_lines(info["cli"])
    phase(f"phase 25 [{card}] 2 processes on cuda:0 (gloo) over phase 8's "
          f"{engine.store.num_rows}-row nomic store: mesh {info['mesh']}, "
          f"routes {info['routes']}; rank 0's ids and distances of 1024 "
          f"queries == one process's bitwise: {same}; cli search rc "
          f"{info['rc']}, rank 0's top 10 == one process's: "
          f"{printed == want}; search {info['qps']:.1f} q/s on 2 ranks; "
          f"gloo all_gather of CUDA tensors {info['gloo_cuda']}")
    assert same and info["rc"] == 0 and printed == want, (printed, want)
    assert "MRR=1.0000" in info["cli"]
    assert [r for r, _d in info["mesh"]] == [0, 1]
    phase(f"phase 25 [{card}] sharded search on the card: "
          f"{time.perf_counter() - t0:.1f}s")


def _start_ranks(argv, world):
    """``argv`` on ``world`` gloo ranks sharing cuda:0 (the ``BSR_*`` env),
    started together."""
    import sys

    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, *argv], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=repo,
                 BSR_COORDINATOR=f"127.0.0.1:{port}",
                 BSR_NUM_PROCESSES=str(world), BSR_PROCESS_ID=str(rank),
                 BSR_DIST_TIMEOUT_S="120"))
        for rank in range(world)]


def _finish_ranks(procs, argv, timeout=300):
    """``[stdout]`` of :func:`_start_ranks`' ranks in rank order. A rank
    that fails or passes ``timeout`` fails the phase; every rank is
    stopped."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (argv[:4], rank, p.returncode, err[-3000:])
    return [o for o, _e in outs]


def check_training_parallel(seed, card, tmp, src, store_dir):
    """Phase 26: (a) DP, TP and DP x TP training worlds against one
    process, (b) CLI ``finetune --tp 2`` and its checkpoint against one
    process's 2 steps, (c) the
    pipeline's local encode mesh against phase 8's store."""
    from better_search_rag_rust_tpu_torch.config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu_torch.bench.train_parallel import (
        gradient_agreement,
    )
    from better_search_rag_rust_tpu_torch.models.checkpoint import load_params
    from better_search_rag_rust_tpu_torch.models.nomic import NomicBertConfig
    from better_search_rag_rust_tpu_torch.models.tokenizer import (
        load_tokenizer,
    )
    from better_search_rag_rust_tpu_torch.models.train import (
        ContrastiveTrainer,
    )
    from better_search_rag_rust_tpu_torch.models.train_data import (
        corpus_pair_batches,
    )
    from better_search_rag_rust_tpu_torch.parallel.mesh import create_mesh
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline
    from better_search_rag_rust_tpu_torch.store import vectorstore as pvs

    t0 = time.perf_counter()
    for world, meshes in TRAIN_WORLDS:
        out = os.path.join(tmp, f"train_parallel_{world}.json")
        t_world = time.perf_counter()
        argv = ["-m", "better_search_rag_rust_tpu_torch.bench.train_parallel",
                "--meshes", meshes, "--batch", str(B_GRAD), "--steps", "3",
                "--seed", str(seed), "--out", out]
        _finish_ranks(_start_ranks(argv, world), argv)
        world_s = time.perf_counter() - t_world
        for res in json.loads(open(out).read()):
            c, ranks = res["check"], res["ranks"]
            losses = ranks[0]["losses"]
            shape = "x".join(map(str, res["mesh"]))
            phase(f"phase 26 [{card}] mesh {shape} on {world} gloo ranks "
                  f"sharing cuda:0 (attention {res['attention_impl']}, "
                  f"heads split {res['heads_split']}, sequence parallel "
                  f"{res['sequence_parallel']}, row-parallel output by "
                  f"{res['collective']}), {res['batch']} pairs x {S_ENC} "
                  f"tokens: first step loss {c['loss']:.6f}, one process "
                  f"{c['one_process_loss']:.6f}; gradient cosine over "
                  f"{c['params']} parameters min {c['min_cos']:.6f} "
                  f"({c['min_cos_param']}), norms within "
                  f"{c['max_norm_dev']:.2e}; 3 steps' losses "
                  f"{[round(x, 6) for x in losses]}; launches a step per "
                  f"rank {[r['launches_per_step'] for r in ranks]}; "
                  f"steps/s per rank (ranks sharing one card) "
                  f"{[round(r['steps_per_sec'], 4) for r in ranks]}")
            assert res["backend"] == "gloo"
            assert abs(c["loss"] - c["one_process_loss"]) <= PAR_LOSS_TOL
            assert c["min_cos"] > GRAD_COS and c["params"] > 100
            assert c["max_norm_dev"] <= PAR_NORM_DEV, c
            assert all(math.isfinite(x) for x in losses)
            assert losses[-1] < losses[0], losses
            want = {"fused_attention_qkv": 24, "fused_attention_qkv_bwd": 24}
            for r in ranks:
                assert r["losses"] == losses, (r["rank"], r["losses"])
                assert r["first_step_launches"] == want, r
                assert r["launches_per_step"] == want, r
        phase(f"phase 26 [{card}] world of {world} ranks: {world_s:.1f}s "
              f"(start, build, check, steps)")

    # (b) runs while (c) builds the tree in this process: nothing of either
    # is timed
    ckpt = os.path.join(tmp, "finetuned_tp2")
    cli_argv = ["-m", "better_search_rag_rust_tpu_torch", "finetune",
                "--root", src, "--extensions", "java", "--steps", "2",
                "--train-batch", str(B_GRAD), "--tp", "2", "--save-dir", ckpt]
    cli_ranks = _start_ranks(cli_argv, 2)
    try:
        dp_dir = os.path.join(tmp, "nomic_dp2")
        cfg = PipelineConfig(
            corpus=CorpusConfig(root=src, extensions=("java",),
                                files_per_batch=256),
            encoder=EncoderConfig(backend="nomic", batch_size=256),
            store=StoreConfig(dir=dp_dir),
            search=SearchConfig(top_k=K, store_dtype="bfloat16"))
        pipe = Pipeline(cfg, device="cuda", seed=seed,
                        mesh=create_mesh(devices=["cuda:0", "cuda:0"]))
        result = pipe.run()
        dp = pipe.encoder.numerics.get("dp_devices")
        del pipe
        torch.cuda.empty_cache()
    finally:
        outs = _finish_ranks(cli_ranks, cli_argv)
    got = pvs.global_store(dp_dir, empty=False).matrix()
    want = pvs.global_store(store_dir, empty=False).matrix()
    same_rows = pvs.load_manifest(dp_dir) == pvs.load_manifest(store_dir)
    diff = float(np.abs(got - want).max())
    phase(f"phase 26 [{card}] pipeline over 2 shards of cuda:0, nomic "
          f"backend, batch 256 split in 2: {got.shape[0]} rows, manifest "
          f"== phase 8's: {same_rows}; max |rows - one shard's| {diff:.3g} "
          f"(bound {SHARD_TOL}); dp_devices {dp}; MRR {result.mrr}")
    assert same_rows and got.shape == want.shape and diff <= SHARD_TOL
    assert dp == 2 and result.mrr == 1.0

    for line in outs[0].splitlines():
        if not line.startswith("20"):            # log lines carry a date
            phase(f"phase 26 [{card}] cli finetune --tp 2 rank 0 | {line}")
    # the same 2 steps in one process, from the same seed on the same pairs
    # (the CLI's model and batches): its losses against those rank 0
    # printed, its parameter updates against the checkpoint's. Every
    # parameter's update norm is held (a wrong merge of same-shape shards
    # moves it by the weights' own size) and the whole model's update
    # cosine; one parameter's cosine is printed, not held: AdamW's first
    # steps are near lr * sign(gradient), so a parameter whose gradient
    # elements sit near zero flips signs on bf16 rounding alone
    model_cfg = NomicBertConfig.from_encoder_config(EncoderConfig())
    one = ContrastiveTrainer(model_cfg, device="cuda")
    init = {k: v.clone() for k, v in one.state.params.items()}
    pairs = corpus_pair_batches(
        src, ("java",), load_tokenizer(None, model_cfg.max_tokens,
                                       model_cfg.vocab_size), B_GRAD)
    one_losses = [one.train_step(*next(pairs)) for _ in range(2)]
    step0 = re.search(r"^step +0  loss (\S+)$", outs[0], re.M)
    final = re.search(r"^final loss (\S+) ", outs[0], re.M)
    assert step0 and final, outs[0]
    printed = [float(step0[1]), float(final[1])]
    saved = load_params(ckpt)
    mine = one.state.params
    got = {k: (v.to("cuda") - init[k]).double() for k, v in saved.items()}
    want = {k: (v - init[k]).double() for k, v in mine.items()}
    upd = gradient_agreement(got, want)
    dot, n_got, n_want = (sum(float((a[k] * b[k]).sum()) for k in want)
                          for a, b in ((got, want), (got, got),
                                       (want, want)))
    whole_cos = dot / math.sqrt(n_got * n_want)
    del one, mine, init, got, want
    # a format check: the file loads into a one-process trainer unchanged
    reloaded = ContrastiveTrainer(model_cfg, params=saved, device="cuda")
    equal = all(torch.equal(reloaded.state.params[k].cpu(), v)
                for k, v in saved.items())
    phase(f"phase 26 [{card}] cli finetune --tp 2 on 2 ranks: rc 0 on both;"
          f" rank 1 printed no step; rank 0's losses {printed} (4 places), "
          f"one process's on the same pairs {[round(x, 6) for x in one_losses]}"
          f"; the checkpoint's 2-step updates against one process's: cosine "
          f"{whole_cos:.6f} over the model, per parameter min "
          f"{upd['min_cos']:.6f} ({upd['min_cos_param']}), norms of "
          f"{upd['params']} parameters within {upd['max_norm_dev']:.2e}"
          f"; {len(saved)} tensors reload into one process bitwise: {equal}")
    assert all(abs(a - b) <= PAR_LOSS_TOL + 5e-5
               for a, b in zip(printed, one_losses)), (printed, one_losses)
    assert whole_cos > GRAD_COS and upd["params"] > 100, (whole_cos, upd)
    assert upd["max_norm_dev"] <= PAR_NORM_DEV, upd
    assert equal and f"params saved to {ckpt}" in outs[0]
    assert "final loss" in outs[0] and "loss" not in outs[1]
    del reloaded, saved
    torch.cuda.empty_cache()
    phase(f"phase 26 [{card}] multi-GPU training and encode mesh: "
          f"{time.perf_counter() - t0:.1f}s")


def _flash_operands(gen, b, h, s, hd, lens_lo):
    """Seeded bf16 q, k, v, do ``[B, H, S, hd]`` and segment ids from a
    random attention mask per row (lengths in [lens_lo, S]; row 0 whole):
    pad tokens are their own segment, as the encoder passes them."""
    q, k, v, do = (torch.randn((b, h, s, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.randint(lens_lo, s + 1, (b,), generator=gen, device="cuda")
    lens[0] = s
    seg = (torch.arange(s, device="cuda")[None, :]
           < lens[:, None]).to(torch.int32)
    return q, k, v, do, seg


def segment_pairs(seg) -> int:
    """The query-key pairs the segment rule leaves: per row, the square of
    each segment's length. A query sees its own key, so its row maximum is
    a real logit and a key of another segment adds exactly 0: the least
    work counts these pairs only, not all S x S."""
    return sum(int(((seg == v).sum(1).long() ** 2).sum())
               for v in torch.unique(seg))


def bound_share(rec) -> str:
    return (f", {100 * rec['bound_ms'] / rec['ms']:.1f} % of bound over "
            f"the segments' pairs")


def flash_reference64(q, k, v, seg, scale):
    """Float64 softmax attention of the same bf16 operands under the
    segment rule (a query sees the keys of its own segment only)."""
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    s = s.masked_fill(~same, -math.inf)
    return torch.matmul(torch.softmax(s, dim=-1), v.double())


def _agreement(a, r):
    """max |a - r| and the cosine of the two, over every cell."""
    a, r = a.double(), r.double()
    return (float((a - r).abs().max()),
            float((a * r).sum() / (a.norm() * r.norm())))


def check_flash_kernels(gen, card):
    """Phase 27 (a) and (b): K14 against its plain version at 32 x 2,048
    tokens (and alone at 8,192; at K8's shape beside K8), K15 and K16
    against the plain backward at 8 x 2,048, two backward runs bit for
    bit; each kernel's time beside its bound, its plain version and SDPA
    (timed as the yardstick only)."""
    from better_search_rag_rust_tpu_torch.models.nomic import rotary_tables
    from better_search_rag_rust_tpu_torch.ops import attention_kernels as ak
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    sdpa = torch.nn.functional.scaled_dot_product_attention
    errs, times = {}, {}
    b, h, s, hd = B_FLASH, H_ENC, S_FLASH, HD_ENC
    scale = 1.0 / math.sqrt(hd)
    q, k, v, _do, seg = _flash_operands(gen, b, h, s, hd, s // 8)
    # the plan as the encoder makes it, once a batch (its ms printed apart)
    plan = fk.segment_tile_plan(seg, seg)

    def kern(with_plan=True):
        return fk.flash_attention_fwd(q, k, v, seg, seg, scale,
                                      plan=plan if with_plan else None)

    def plain():
        return fk.flash_attention_fwd_plain(q, k, v, seg, seg, scale)

    (o, l, m), (po, pl, _pm) = kern(), plain()
    again, off = kern(), kern(False)
    torch.cuda.synchronize()
    bitwise_runs = all(torch.equal(x, y) for x, y in zip((o, l, m), again))
    bitwise_plan = all(torch.equal(x, y) for x, y in zip((o, l, m), off))
    del again, off
    err, cos = _agreement(o, po)
    finite = bool(torch.isfinite(o.float()).all())
    pad_rows = seg == 0
    pad_err, _ = _agreement(o.transpose(1, 2)[pad_rows],
                            po.transpose(1, 2)[pad_rows])
    ref = flash_reference64(q[:2, :2], k[:2, :2], v[:2, :2], seg[:2], scale)
    e_k = float((o[:2, :2].double() - ref).abs().max())
    e_p = float((po[:2, :2].double() - ref).abs().max())
    phase(f"phase 27 [{card}] K14 [{b} x {h} x {s} x {hd}] bf16, random "
          f"padding per row ({int(pad_rows.sum())} pad tokens): "
          f"max|o-plain| every row "
          f"{err:.4g} (bound {ATT_TOL}), pad rows {pad_err:.4g}, cosine "
          f"{cos:.7f} (bound {ATT_COS}), all finite {finite}; l max rel "
          f"{float(((l - pl).abs() / pl).max()):.3g}; vs float64 on rows "
          f"0-1 x heads 0-1: kernel max {e_k:.4g}, plain max {e_p:.4g}; "
          f"two runs bit for bit {bitwise_runs}, plan on and off bit for "
          f"bit {bitwise_plan}")
    assert err < ATT_TOL and cos > ATT_COS and finite
    assert bitwise_runs and bitwise_plan
    errs["flash_attention_fwd"] = err
    mask = (seg[:, None, :, None] == seg[:, None, None, :])
    times["flash_attention_fwd"] = timing(
        cuda_ms(kern, 10), cuda_ms(plain),
        cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 10),
        nbytes(q, k, v, o, l, m, seg), 4 * h * hd * segment_pairs(seg),
        "bf16 tensor")
    ms_off = cuda_ms(lambda: kern(False), 10)
    plan_ms = cuda_ms(lambda: fk.segment_tile_plan(seg, seg), 10)
    skipped = int(plan.sum())
    phase(f"phase 27 [{card}] " + timing_line("flash_attention_fwd",
                                              times["flash_attention_fwd"])
          + bound_share(times["flash_attention_fwd"])
          + f"; plan off {ms_off:.3f} ms; tile plan [{b} x {s}]: {skipped} "
          f"of {plan.numel()} pairs of 64 x 64 tiles skipped, "
          f"{plan.numel() - skipped} computed; the plan made in "
          f"{plan_ms:.3f} ms (once a batch, outside the kernel's time)")
    del o, l, m, po, pl, _pm, mask, q, k, v, _do, plan
    torch.cuda.empty_cache()
    q, k, v, _do, _seg = _flash_operands(gen, b, h, s, hd, s)
    ms_un = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v, None, None, scale),
                    10)
    sdpa_un = cuda_ms(lambda: sdpa(q, k, v, scale=scale), 10)
    bound_un = 1e3 * 4 * h * hd * b * s * s / PEAK_OPS["bf16 tensor"]
    phase(f"phase 27 [{card}] K14 unpadded [{b} x {h} x {s} x {hd}] (no "
          f"segment ids, no tile to skip): {ms_un:.3f} ms (bound "
          f"{bound_un:.3f} ms over all S x S pairs, operations; "
          f"{100 * bound_un / ms_un:.1f} % of bound); SDPA, no mask, "
          f"{sdpa_un:.3f} ms")
    del q, k, v, _do, _seg
    torch.cuda.empty_cache()

    # a context K8 cannot take, and K8's own shape
    q, k, v, _do, seg = _flash_operands(gen, 2, h, 8192, hd, 1024)
    plan = fk.segment_tile_plan(seg, seg)
    o, _, _ = fk.flash_attention_fwd(q, k, v, seg, seg, scale, plan=plan)
    po, _, _ = fk.flash_attention_fwd_plain(q, k, v, seg, seg, scale)
    err8k, cos8k = _agreement(o, po)
    ms8k = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v, seg, seg, scale,
                                                  plan=plan))
    bound8k = 1e3 * 4 * h * hd * segment_pairs(seg) / PEAK_OPS["bf16 tensor"]
    phase(f"phase 27 [{card}] K14 [2 x {h} x 8192 x {hd}] (past K8's "
          f"{ak.KERNEL_MAX_SEQ}): {ms8k:.3f} ms, bound {bound8k:.3f} ms "
          f"(operations; {100 * bound8k / ms8k:.1f} % of bound), max|o-plain| {err8k:.4g}, cosine {cos8k:.7f}")
    assert err8k < ATT_TOL and cos8k > ATT_COS
    del q, k, v, _do, o, po, plan
    torch.cuda.empty_cache()
    bk8, sk8 = B_ENC, S_ENC
    q, k, v, _do, seg = _flash_operands(gen, bk8, h, sk8, hd, 1)
    plan = fk.segment_tile_plan(seg, seg)
    ms_k14 = cuda_ms(lambda: fk.flash_attention_fwd(q, k, v, seg, seg, scale,
                                                    plan=plan))
    qkv = torch.cat([t.transpose(1, 2).reshape(bk8, sk8, h * hd)
                     for t in (q, k, v)], dim=-1).contiguous()
    bias = torch.where(seg > 0, 0.0, -1e9).to(torch.float32).contiguous()
    cos_t, sin_t = (torch.from_numpy(t).cuda()
                    for t in rotary_tables(sk8, hd, 1000.0))
    c2, s2 = ak.rotary_roll_tables(cos_t, sin_t)
    ms_k8 = cuda_ms(lambda: ak.fused_attention_qkv(qkv, c2, s2, bias, h,
                                                   scale))
    phase(f"phase 27 [{card}] K14 at K8's shape [{bk8} x {h} x {sk8} x "
          f"{hd}]: {ms_k14:.3f} ms; K8 (rotary + attention off Wqkv) "
          f"{ms_k8:.3f} ms in this run")
    del q, k, v, _do, qkv, bias, plan
    torch.cuda.empty_cache()

    # the backward at the finetune step's shape
    b = B_FLASH_BWD
    q, k, v, do, seg = _flash_operands(gen, b, h, s, hd, s // 8)
    o, l, m = fk.flash_attention_fwd(q, k, v, seg, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg, seg, l, m, do, di, scale)
    dk, dv = fk.flash_attention_bwd_dkv(*args)
    dq = fk.flash_attention_bwd_dq(*args)
    dk2, dv2 = fk.flash_attention_bwd_dkv(*args)
    dq2 = fk.flash_attention_bwd_dq(*args)
    pdk, pdv = fk.flash_attention_bwd_dkv_plain(*args)
    pdq = fk.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    same = (torch.equal(dq, dq2) and torch.equal(dk, dk2)
            and torch.equal(dv, dv2))
    parts = []
    for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        diff, c = _agreement(got, want)
        top = float(want.float().abs().max())
        parts.append((name, diff, top, c))
        assert bool(torch.isfinite(got.float()).all())
        assert diff <= BWD_REL * top and c >= BWD_COS, (name, diff, top, c)
    phase(f"phase 27 [{card}] K15/K16 [{b} x {h} x {s} x {hd}] bf16: "
          + "; ".join(
        f"{n} max|diff|={d:.4g} (bound {BWD_REL} x {t:.4g}) cosine={c:.7f}"
        f" (bound {BWD_COS})" for n, d, t, c in parts)
        + f"; two backward runs bitwise equal: {same}")
    assert same
    errs["flash_attention_bwd_dq"] = parts[0][1]
    errs["flash_attention_bwd_dkv"] = max(parts[1][1], parts[2][1])
    del pdk, pdv, pdq, dk2, dv2, dq2
    torch.cuda.empty_cache()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    mask = (seg[:, None, :, None] == seg[:, None, None, :])
    out = sdpa(*leaves, attn_mask=mask, scale=scale)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True), 10)
    moved = nbytes(q, k, v, do, l, m, di, seg)
    pairs = segment_pairs(seg)
    ms15, ms16, plan_ms = flash_bwd_kernel_ms(fk, args)
    times["flash_attention_bwd_dkv"] = timing(
        ms15, cuda_ms(lambda: fk.flash_attention_bwd_dkv_plain(*args)), sdpa_bwd,
        moved + nbytes(dk, dv), 8 * h * hd * pairs, "bf16 tensor")
    times["flash_attention_bwd_dq"] = timing(
        ms16, cuda_ms(lambda: fk.flash_attention_bwd_dq_plain(*args)), sdpa_bwd,
        moved + nbytes(dq), 6 * h * hd * pairs, "bf16 tensor")
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        phase(f"phase 27 [{card}] " + timing_line(name, times[name])
              + bound_share(times[name])
              + " (library: SDPA's whole backward)")
    phase(f"phase 27 [{card}] K15/K16 tile plan (from the segment ids, "
          f"once a batch) and 1/l (once a backward), outside the kernels' "
          f"times: {plan_ms:.3f} ms")
    plan = fk.segment_tile_plan(seg, seg)
    assert torch.equal(plan, fk.backward_tile_plan(seg, seg, m))
    skipped = int(plan.sum())
    phase(f"phase 27 [{card}] K15/K16 tile plan [{b} x {s}]: {skipped} of "
          f"{plan.numel()} pairs of 64 x 64 tiles skipped (exact zeros), "
          f"{plan.numel() - skipped} computed")
    del q, k, v, do, o, l, m, di, dk, dv, dq, leaves, out, mask, args, plan
    torch.cuda.empty_cache()
    check_flash_backward_cases(gen, card)
    return errs, times


def _plan_and_reciprocal(fk, seg_q, seg_kv, l):
    """What K15 and K16 read beside the operands: the tile plan from the
    segment ids (the encoder makes it once a batch) and ``1 / l``
    (``FlashAttention.backward`` makes it once for both kernels)."""
    return torch.reciprocal(l), fk.segment_tile_plan(seg_q, seg_kv)


def flash_bwd_kernel_ms(fk, args, iters: int = 10):
    """K15's and K16's ms on the wrappers' ``args`` with the tile plan and
    1 / l made once, as the encoder and ``FlashAttention.backward`` make
    them, and the ms of making them: a wrapper call makes them itself, and
    its few small torch ops cost host time that a short timing window would
    count as the kernel's."""
    q, k, v, seg_q, seg_kv, l, m, do, di, scale = args
    inv_l, plan = _plan_and_reciprocal(fk, seg_q, seg_kv, l)
    ms15 = cuda_ms(lambda: fk._bwd_dkv_kernel(q, k, v, seg_q, seg_kv, inv_l,
                                              m, do, di, plan, scale), iters)
    ms16 = cuda_ms(lambda: fk._bwd_dq_kernel(q, k, v, seg_q, seg_kv, inv_l, m,
                                             do, di, plan, scale), iters)
    plan_ms = cuda_ms(lambda: _plan_and_reciprocal(fk, seg_q, seg_kv, l),
                      iters)
    return ms15, ms16, plan_ms


def _flash_bwd_agreement(fk, args):
    """K15/K16 against their plain versions on ``args``: the (name, max
    |diff|, largest entry, cosine) of dq, dk, dv, each asserted within
    BWD_REL of the largest entry and at cosine BWD_COS."""
    dk, dv = fk.flash_attention_bwd_dkv(*args)
    dq = fk.flash_attention_bwd_dq(*args)
    pdk, pdv = fk.flash_attention_bwd_dkv_plain(*args)
    pdq = fk.flash_attention_bwd_dq_plain(*args)
    torch.cuda.synchronize()
    parts = []
    for name, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        diff, c = _agreement(got, want)
        top = float(want.float().abs().max())
        parts.append((name, diff, top, c))
        assert bool(torch.isfinite(got.float()).all())
        assert diff <= BWD_REL * top and c >= BWD_COS, (name, diff, top, c)
    return parts


def check_flash_backward_cases(gen, card):
    """Phase 27 (b), continued: K15/K16 on unpadded operands at the step's
    shape (nothing to skip: each against PR 19's time through the mainloop
    alone), timed beside its bound over all S x S pairs and SDPA's whole
    backward without a mask; and against their plain versions where one
    query row has no key of its own segment (its tile never skipped)."""
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk

    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, s, hd = B_FLASH_BWD, H_ENC, S_FLASH, HD_ENC
    scale = 1.0 / math.sqrt(hd)
    q, k, v, do, seg = _flash_operands(gen, b, h, s, hd, s)  # one segment
    o, l, m = fk.flash_attention_fwd(q, k, v, seg, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg, seg, l, m, do, di, scale)
    parts = _flash_bwd_agreement(fk, args)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, scale=scale)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True), 10)
    ms15, ms16, _plan_ms = flash_bwd_kernel_ms(fk, args)
    pairs = b * s * s
    b15 = 1e3 * 8 * h * hd * pairs / PEAK_OPS["bf16 tensor"]
    b16 = 1e3 * 6 * h * hd * pairs / PEAK_OPS["bf16 tensor"]
    phase(f"phase 27 [{card}] K15/K16 unpadded [{b} x {h} x {s} x {hd}] "
          f"(no tile to skip): K15 {ms15:.3f} ms (bound {b15:.3f} ms over all "
          f"S x S pairs, operations; {100 * b15 / ms15:.1f} % of bound), K16 "
          f"{ms16:.3f} ms (bound {b16:.3f}; {100 * b16 / ms16:.1f} %); SDPA's "
          f"whole backward, no mask, {sdpa_bwd:.3f} ms; " + "; ".join(
              f"{n} max|diff|={d:.4g} (bound {BWD_REL} x {t:.4g}) cosine="
              f"{c:.7f}" for n, d, t, c in parts))
    del q, k, v, do, o, l, m, di, args, leaves, out
    torch.cuda.empty_cache()

    b = 2
    q, k, v, do, seg = _flash_operands(gen, b, h, s, hd, s // 8)
    seg_q = seg.clone()
    seg_q[1, 100] = 5  # no key has segment 5: m of that row is the mask
    o, l, m = fk.flash_attention_fwd(q, k, v, seg_q, seg, scale)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, seg_q, seg, l, m, do, di, scale)
    parts = _flash_bwd_agreement(fk, args)
    plan = fk.segment_tile_plan(seg_q, seg)
    assert torch.equal(plan, fk.backward_tile_plan(seg_q, seg, m))
    lonely = bool((m[1, :, 100] < fk.DEFAULT_MASK_VALUE / 2).all())
    phase(f"phase 27 [{card}] K15/K16 [{b} x {h} x {s} x {hd}] with query "
          f"token 100 of row 1 in a segment no key has (its m the mask value: "
          f"{lonely}; its tile, disjoint by ids from the pad tiles, in a "
          f"skipped pair: {bool(plan[1, 1].any())}; "
          f"{int(plan.sum())} pairs skipped): " + "; ".join(
              f"{n} max|diff|={d:.4g} (bound {BWD_REL} x {t:.4g}) cosine="
              f"{c:.7f}" for n, d, t, c in parts))
    assert lonely and not bool(plan[1, 1].any())
    del q, k, v, do, o, l, m, di, args, plan
    torch.cuda.empty_cache()


def check_flash_paths(seed, card, tmp, src):
    """Phase 27 (c)-(e): the encoder at full width on 32 x 2,048 tokens,
    build mode on phase 8's tree at 2,048 tokens, one finetune step; the
    main path's launches of K14 (build mode) and K15 / K16 (the step)."""
    from better_search_rag_rust_tpu_torch.config import (
        CorpusConfig,
        EncoderConfig,
        PipelineConfig,
        SearchConfig,
        StoreConfig,
    )
    from better_search_rag_rust_tpu_torch.models.nomic import (
        NomicBertConfig,
        NomicEncoder,
    )
    from better_search_rag_rust_tpu_torch.models.train import (
        ContrastiveTrainer,
    )
    from better_search_rag_rust_tpu_torch.ops import flash_kernels as fk
    from better_search_rag_rust_tpu_torch.pipeline import Pipeline
    from better_search_rag_rust_tpu_torch.store import vectorstore as pvs

    cfg = NomicBertConfig(attention_impl="flash", max_tokens=S_FLASH)
    flash = NomicEncoder(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.vocab_size, size=(B_FLASH, S_FLASH))
    lens = rng.integers(S_FLASH // 8, S_FLASH + 1, size=B_FLASH)
    mask = (np.arange(S_FLASH)[None, :] < lens[:, None]).astype(np.int64)
    ids_d, mask_d = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
    flash.encode_tokens_device(ids_d, mask_d)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    emb = flash.encode_tokens_device(ids_d, mask_d)
    torch.cuda.synchronize()
    per_forward = fk.launch_counts["flash_attention_fwd"]
    rate = B_FLASH / (cuda_ms(lambda: flash.encode_tokens_device(
        ids_d, mask_d)) / 1e3)
    split, total, _top = _device_profile(
        lambda: flash.encode_tokens_device(ids_d, mask_d), K14_K16)
    glue = glue_ops(lambda: flash.encode_tokens_device(ids_d, mask_d))
    plain = NomicEncoder(dataclasses.replace(cfg, attention_impl="xla"),
                         state_dict=flash.model.state_dict(), device="cuda")
    a = flash.encode_tokens(ids[:4], np.ones_like(mask[:4]))
    b = plain.encode_tokens(ids[:4], np.ones_like(mask[:4]))
    cos = np.sum(a * b, axis=1)
    phase(f"phase 27 [{card}] encoder 12 x 768 flash, {B_FLASH} x {S_FLASH} "
          f"tokens: {per_forward} K14 launches a forward, {rate:.1f} files/s; "
          f"device time {total:.2f} ms: " + ", ".join(
              f"{k_} {v_:.2f} ms ({100 * v_ / total:.1f} %)"
              for k_, v_ in split.items() if v_)
          + f"; the rest's largest ops: {glue}"
          + f"; pooled cosine vs xla on 4 unpadded rows min {cos.min():.6f} "
          f"(bound {ATT_COS})")
    assert per_forward == cfg.num_layers and cos.min() >= ATT_COS
    assert bool(torch.isfinite(emb).all()) and emb.shape == (B_FLASH, 768)
    del flash, plain, emb, ids_d, mask_d
    torch.cuda.empty_cache()

    store_dir = os.path.join(tmp, "nomic_flash")
    pcfg = PipelineConfig(
        corpus=CorpusConfig(root=src, extensions=("java",),
                            files_per_batch=256),
        encoder=EncoderConfig(backend="nomic", batch_size=B_FLASH,
                              max_tokens=S_FLASH, attention_impl="flash"),
        store=StoreConfig(dir=store_dir),
        search=SearchConfig(top_k=K, store_dtype="bfloat16"),
    )
    pipe = Pipeline(pcfg, device="cuda", seed=seed)
    pipe.encoder.get_embeddings(["warm up the forward"])
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    result = pipe.run()
    run_s = time.perf_counter() - t0
    launches = {"flash_attention_fwd": fk.launch_counts["flash_attention_fwd"]}
    report = pipe.evaluate(num_queries=1024, k=K)
    meta = pvs.load_encoder_meta(store_dir)
    phase(f"phase 27 [{card}] build mode nomic flash, max_tokens "
          f"{S_FLASH}: {result.ingest.embeddings} files, run() {run_s:.2f}s = "
          f"{result.ingest.embeddings / run_s:.1f} files/s; store meta "
          f"attention_impl {meta['attention_impl']}; evaluate {report}; K14 "
          f"launches {launches['flash_attention_fwd']}")
    assert result.ingest.embeddings == TREE_FILES
    assert meta["attention_impl"] == "torch-flash"
    assert report["oracle_overlap"] == 1.0
    assert launches["flash_attention_fwd"] > 0
    del pipe
    torch.cuda.empty_cache()

    tr = ContrastiveTrainer(cfg, seed=seed, device="cuda")
    batch = _pairs(np.random.default_rng(seed + 2), cfg, B_FLASH_STEP)
    tr.train_step(*batch)
    torch.cuda.synchronize()
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    loss = tr.train_step(*batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    step = dict(fk.launch_counts)
    split, total, _top = _device_profile(
        lambda: tr.train_step_device(*batch), K14_K16)
    glue = glue_ops(lambda: tr.train_step_device(*batch))
    phase(f"phase 27 [{card}] finetune step flash, {B_FLASH_STEP} pairs x "
          f"{S_FLASH} tokens: loss {loss:.6f}, {step_s * 1e3:.1f} ms host "
          f"clock, launches {step}; device time {total:.2f} ms: "
          + ", ".join(f"{k_} {v_:.2f} ms ({100 * v_ / total:.1f} %)"
                      for k_, v_ in split.items())
          + f"; the rest's largest ops: {glue}")
    want = 2 * cfg.num_layers
    assert math.isfinite(loss) and step == dict.fromkeys(step, want), step
    launches["flash_attention_bwd_dkv"] = step["flash_attention_bwd_dkv"]
    launches["flash_attention_bwd_dq"] = step["flash_attention_bwd_dq"]
    del tr, batch
    torch.cuda.empty_cache()

    flash_tr = ContrastiveTrainer(cfg, seed=seed, device="cuda")
    xla_tr = ContrastiveTrainer(dataclasses.replace(cfg, attention_impl="xla"),
                                params=flash_tr.state.params, device="cuda")
    batch = _pairs(np.random.default_rng(seed + 3), cfg, 2)
    losses = []
    for t in (flash_tr, xla_tr):
        lo = t.loss(*batch)
        lo.backward()
        losses.append(float(lo.detach()))
    worst, checked = (1.0, ""), 0
    for (name, pf), (_, px) in zip(flash_tr.model.named_parameters(),
                                   xla_tr.model.named_parameters()):
        x, y = pf.grad.double().ravel(), px.grad.double().ravel()
        if float(x.norm()) < 1e-12 and float(y.norm()) < 1e-12:
            continue
        worst = min(worst, (float(x @ y / (x.norm() * y.norm())), name))
        checked += 1
    phase(f"phase 27 [{card}] trainer flash vs xla, 2 pairs x {S_FLASH} "
          f"tokens: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f}; gradient cosine over "
          f"{checked} parameters min {worst[0]:.6f} ({worst[1]}; bound "
          f"{GRAD_COS})")
    assert worst[0] > GRAD_COS and checked > 100
    del flash_tr, xla_tr, batch
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    """A localhost port free now, for a rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_tree_phases(args, gen, card, tmp, cfg, errs, times, launches):
    """Phases 8-27: everything from the seeded tree's build mode on; the
    tree and its stores live in ``tmp`` until phase 27 has used them."""
    from better_search_rag_rust_tpu_torch.bench.suite import write_java_tree
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.store import DeviceStore

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
    bench_tmp = tempfile.mkdtemp(prefix="bsr_smoke_")
    try:
        drive_measurement_path(bench_tmp, card)
    finally:
        shutil.rmtree(bench_tmp, ignore_errors=True)
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

    check_sharded(args.seed, gen, card, os.path.join(tmp, "nomic"))
    check_training_parallel(args.seed, card, tmp, src,
                            os.path.join(tmp, "nomic"))

    flash_errs, flash_times = check_flash_kernels(gen, card)
    errs.update(flash_errs)
    times.update(flash_times)
    launches.update(check_flash_paths(args.seed, card, tmp, src))


# -- phase 28: non-finite search ----------------------------------------------

#: phase 28's routes: (route, rescore_argmax); f32cert on f32 stores only
NAN_ROUTES = (("rescore", "auto"), ("rescore", "off"), ("rescore", "on"),
              ("global", "auto"), ("f32cert", "auto"))
#: phase 28's NaN rows of the 1M-row stores and their signs: a unit's first
#: row, mid-unit (the rescore route's 64-row units) and the last block
NAN_STORE_ROWS = ((64_000, 1), (128_031, -1), (500_017, 1), (999_990, 1),
                  (999_999, -1))
#: the 1,024 queries' non-finite entries: (query, first entry)
NAN_QUERY_ENTRIES = ((17, "nan"), (18, "-nan"), (19, "inf"), (20, "-inf"))


def _route_config(route, argmax):
    from better_search_rag_rust_tpu_torch.config import SearchConfig

    if route == "f32cert":  # the reference's rule: "auto" routes it
        return SearchConfig(kernel="auto", f32_certified="on", top_k=K)
    return SearchConfig(kernel=route, rescore_argmax=argmax, top_k=K)


@contextlib.contextmanager
def plain_kernels():
    """Within the block the search routes call the plain versions of K1,
    K2, K3, K4 and K6 instead of the kernels, on the card: the yardstick a
    route's answer is held to."""
    from better_search_rag_rust_tpu_torch.ops import engine as eng_mod
    from better_search_rag_rust_tpu_torch.ops import topk as topk_mod
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk

    names = ("matmul_blockmax2_only", "gather_rescore", "matmul_blockmax",
             "gather_rows", "block_scores")
    saved = [(mod, name, getattr(mod, name)) for mod in (topk_mod, eng_mod)
             for name in names if hasattr(mod, name)]
    for mod, name, _fn in saved:
        setattr(mod, name, getattr(tk, name + "_plain"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def same_answer(label, got, want, exact):
    """Phase 28's comparison of a route's ``(ids, distances)`` with the
    plain versions' run: NaN distances in the same places; ``exact`` (int8:
    every score an exact integer dot) ids and distances bit for bit; else
    distances within TOL (the plain product sums in another order) and ids
    equal wherever a distance stands more than 2 * TOL from its neighbours
    — two rows nearer than that may trade places on rounding. Returns the
    count of such positions whose ids differ."""
    (ids, d), (p_ids, p_d) = got, want
    nan = np.isnan(d)
    assert np.array_equal(nan, np.isnan(p_d)), label
    if exact:
        assert np.array_equal(ids, p_ids), label
        assert np.array_equal(d.view(np.uint32)[~nan],
                              p_d.view(np.uint32)[~nan]), label
        return 0
    assert np.abs(d[~nan] - p_d[~nan]).max(initial=0.0) <= TOL, label
    gap = np.diff(np.where(nan, -1.0, d), axis=1)
    near = np.zeros(d.shape, dtype=bool)
    near[:, 1:] |= np.abs(gap) <= 2 * TOL
    near[:, :-1] |= np.abs(gap) <= 2 * TOL
    near &= ~nan
    assert np.array_equal(ids[~near], p_ids[~near]), label
    return int(np.sum(ids[near] != p_ids[near]))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _nan_bits(dtype, sign):
    if dtype == torch.bfloat16:
        return torch.int16, 0x7FC0 if sign > 0 else 0xFFC0 - (1 << 16)
    return torch.int32, 0x7FC00000 if sign > 0 else 0xFFC00000 - (1 << 32)


def check_nonfinite_search(seed, gen, card, device="cuda", rows=1_000_000):
    """Phase 28: non-finite search on the card (module docstring, item 28).
    ``device`` and ``rows`` (with :data:`NAN_STORE_ROWS` inside them)
    rehearse it on the CPU, where every wrapper runs its plain version and
    nothing launches (the launch check then fails)."""
    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    t0 = time.perf_counter()
    pinned = 0
    for case, by_dtype in NAN_PINS.items():
        for sign in (1, -1):
            mat, queries, k = nan_case(case, sign)
            for dtype, pin in by_dtype.items():
                store = DeviceStore.from_host(mat, dtype, device=device)
                for route, argmax in NAN_ROUTES:
                    if route == "f32cert" and dtype != "float32":
                        continue
                    eng = SearchEngine(store, _route_config(route, argmax))
                    assert eng.kernel_name(k) == route, (case, dtype, route)
                    ids = eng.search(queries, k)[0]
                    assert np.array_equal(ids, pin), (case, sign, dtype,
                                                      route, argmax, ids)
                    pinned += 1
    phase(f"phase 28 pinned 64 x 32 cases (NaN row, NaN query, +-inf "
          f"query; each sign; f32/bf16/int8 stores built on the card): "
          f"{pinned} route runs, every one the CPU tests' ids "
          f"({time.perf_counter() - t0:.1f}s)")

    launches = dict.fromkeys(("matmul_blockmax2_only", "gather_rescore",
                              "matmul_blockmax", "gather_rows",
                              "block_scores"), 0)
    for dtype in ("bfloat16", "float32", "int8"):
        t1 = time.perf_counter()
        store = DeviceStore.synthetic(rows, 768, dtype, seed + 5,
                                      device=device)
        picks = torch.randint(0, store.num_rows, (1024,), generator=gen,
                              device=device)
        queries = store.data[picks].float().cpu().numpy()
        for q, what in NAN_QUERY_ENTRIES:
            queries[q, 0] = {"nan": np.nan, "-nan": -np.nan, "inf": np.inf,
                             "-inf": -np.inf}[what]
        queries[18].view(np.uint32)[0] |= 0x80000000  # the NaN's sign set
        ties = {}
        for stage in ("finite store", "NaN rows"):
            if stage == "NaN rows":
                for r, sign in NAN_STORE_ROWS:
                    if store.dtype == torch.int8:  # the lattice's NaN row
                        nan_row = torch.full((1, 768), float("nan"),
                                             device=device)
                        store.data[r] = tk.normalize_cast(nan_row,
                                                          torch.int8)[0]
                    else:
                        ints, bits = _nan_bits(store.dtype, sign)
                        store.data[r].view(ints).fill_(bits)
                for j, (r, _sign) in enumerate(NAN_STORE_ROWS[:2]):
                    queries[21 + j] = store.data[r].float().cpu().numpy()
            for route, argmax in NAN_ROUTES:
                if route == "f32cert" and dtype != "float32":
                    continue
                eng = SearchEngine(store, _route_config(route, argmax))
                assert eng.kernel_name(K) == route, (dtype, route)
                finite = dtype == "int8" or stage == "finite store"
                assert eng._store_finite() is finite
                if route == "rescore" and argmax == "on":
                    assert eng._argmax_enabled() is finite
                _sync(device)
                tk.reset_launch_counts()
                got = eng.search(queries, K)
                _sync(device)
                for name in launches:
                    n = (tk.launch_counts[name]
                         + tk.launch_counts.get(name + "_int8", 0))
                    launches[name] += n
                with plain_kernels():
                    want = eng.search(queries, K)
                label = f"{dtype} {stage} {route} {argmax}"
                ties[label] = same_answer(label, got, want,
                                          exact=dtype == "int8")
                nan_q = np.isnan(got[1]).all(axis=1)
                assert nan_q[list(q for q, _ in NAN_QUERY_ENTRIES)].all() \
                    or dtype == "int8", label
                if stage == "NaN rows" and dtype != "int8":
                    # every finite query ranks the NaN rows first
                    first = np.sort(got[0][~nan_q, :len(NAN_STORE_ROWS)],
                                    axis=1)
                    assert (first == sorted(r for r, _ in NAN_STORE_ROWS)
                            ).all(), label
        del store
        if device == "cuda":
            torch.cuda.empty_cache()
        phase(f"phase 28 [{card}] {rows:,} x 768 {dtype}, 1024 queries "
              f"(NaN of each sign, +-inf, NaN rows as queries), k={K}, "
              f"finite store then NaN rows of each sign at rows "
              f"{[r for r, _ in NAN_STORE_ROWS]}: every route's ids and "
              f"distances equal the plain versions' run"
              f"{' bit for bit' if dtype == 'int8' else ''}; ids traded "
              f"between rows within 2e-5: {ties} "
              f"({time.perf_counter() - t1:.1f}s)")
    phase(f"phase 28 kernel launches over the routes: {launches}")
    assert all(launches.values()), launches


#: phase 29: K17's shapes, a query batch and one store block
#: (``store/device_store.py:_BUILD_ROWS``), and its launches per timing
K17_SHAPES = ((1024, 768), (131_072, 768))
K17_QUEUED = 200
K17_DTYPES = (torch.bfloat16, torch.int8, torch.float32)
K17_INTS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}


def queued_ms(fn, n: int = K17_QUEUED) -> float:
    """Device time of one call of ``fn`` alone (CUDA events): ``n`` calls
    queued behind a sleep kernel, so that the card runs them back to back
    whatever the host's pace; the sleep grows until the host has queued all
    ``n`` before the card reaches the start event."""
    fn()
    torch.cuda.synchronize()
    for cycles in (50_000_000, 400_000_000, 3_200_000_000):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / n
    raise AssertionError("the host could not queue the launches ahead")


#: the aten ops a caller of K17 may dispatch on the card: an allocation and
#: a view, no arithmetic
K17_CALLER_OPS = {"aten.empty", "aten.slice"}


def k17_profile(fn, n: int, tries: int = 3):
    """torch.profiler over ``n`` calls of ``fn``, after a warm-up cycle of
    ``n`` calls that it does not record: the mean device ms of the K17
    kernels it recorded, how many it recorded, and every other kernel and
    aten op with device time that it saw. Without the warm-up cycle the
    profiler recorded only some of the kernels, or none, late in a long
    process; the mean is over those it recorded, a run that recorded no K17
    kernel is made again, up to ``tries`` times, and the caller asserts
    that one was recorded before it reads "no other kernel" as evidence."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.key_averages())
                     ) as prof:
            for _step in range(2):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        us = count = 0
        others = []
        for evt in traces[0] if traces else ():
            t = getattr(evt, "self_device_time_total",
                        getattr(evt, "self_cuda_time_total", 0))
            if evt.key.startswith("ProfilerStep"):
                continue  # the schedule's own step marks, on both timelines
            if str(evt.device_type).endswith("CUDA"):
                if "k17_normalize_cast" in evt.key:
                    us, count = us + t, count + evt.count
                else:
                    others.append(evt.key)
            elif evt.key.startswith("aten::") and t:
                others.append(evt.key)
        if count:
            return us / 1e3 / count, count, others
    return None, 0, others


def dispatched_ops(fn) -> set:
    """Every aten op one call of ``fn`` dispatches (a TorchDispatchMode log,
    which sees each op whatever the profiler records)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = set()

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Log():
        fn()
    return ops


def check_normalize_cast(gen, card):
    """Phase 29: K17 (module docstring, item 29). Returns its error against
    its plain version and the timing record of the main path's query batch
    (1024 x 768 to bf16)."""
    import torch.nn.functional as F

    from better_search_rag_rust_tpu_torch.ops import topk_kernels as tk
    from better_search_rag_rust_tpu_torch.ops.distance import normalize_rows
    from better_search_rag_rust_tpu_torch.ops.engine import SearchEngine
    from better_search_rag_rust_tpu_torch.ops.quantize import cast_rows_to
    from better_search_rag_rust_tpu_torch.store import DeviceStore

    err, recs = 0.0, {}
    for rows, d in K17_SHAPES:
        x = torch.randn((rows, d), generator=gen, device="cuda")
        bits = x.view(torch.int32)
        bits[3, ::5], bits[4, ::7] = 0x7FC00000, 0xFFC00000 - (1 << 32)
        bits[5, ::3], bits[6, :2] = 0x7F800001, 0x7F800000
        x[7] = 0.0
        x[8] *= 1e20   # the sum of squares overflows
        finite = x[7:4096].cpu()
        for dtype in K17_DTYPES:
            ints = K17_INTS[dtype]
            got = tk.normalize_cast(x, dtype)
            want = tk.normalize_cast_plain(x, dtype)
            assert torch.equal(got.view(ints), want.view(ints)), (rows, dtype)
            assert torch.equal(got[7:4096].view(ints).cpu(), tk.normalize_cast_plain(
                finite, dtype).view(ints)), (rows, dtype)
            err = max(err, max_abs(got.float().nan_to_num(),
                                   want.float().nan_to_num()))
            # ms: as called, the method of every kernel's ms (cuda_ms)
            rec = timing(cuda_ms(lambda: tk.normalize_cast(x, dtype),
                                 K17_QUEUED),
                         cuda_ms(lambda: tk.normalize_cast_plain(x, dtype), 20),
                         None, x.numel() * (4 + got.element_size()),
                         3 * x.numel(), "fp32 SIMT")
            rec["device_alone_ms"] = queued_ms(
                lambda: tk.normalize_cast(x, dtype))
            rec["profiler_ms"], recorded, _ = k17_profile(
                lambda: tk.normalize_cast(x, dtype), 50)
            rec["chain_ms"] = cuda_ms(
                lambda: cast_rows_to(normalize_rows(x), dtype), 20)
            rec["yardstick_ms"] = cuda_ms(
                lambda: F.normalize(x, dim=-1).to(dtype), 20)
            prof = rec["profiler_ms"]
            phase(f"phase 29 [{card}] K17 {rows} x {d} f32 -> "
                  f"{str(dtype).split('.')[-1]}, bit for bit its plain version "
                  f"(NaN rows of each sign, +-inf, a zero row, an overflowing "
                  f"row; finite rows also the CPU plain version's): device "
                  f"alone {rec['device_alone_ms']:.5f} ms ({K17_QUEUED} "
                  f"queued launches), profiler "
                  f"{'not measured' if prof is None else f'{prof:.5f} ms'} "
                  f"({recorded} of 50 launches recorded), as called "
                  f"{rec['ms']:.5f} ms, bound "
                  f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}), plain "
                  f"{rec['plain_ms']:.5f} ms, the parent's chain "
                  f"cast_rows_to(normalize_rows(x)) {rec['chain_ms']:.5f} ms, "
                  f"yardstick F.normalize(x).to(dtype) (another function: "
                  f"its epsilon, its NaN bits) {rec['yardstick_ms']:.5f} ms")
            recs[(rows, dtype)] = rec
        # the same kernel with normalization off: the bf16 cast alone
        # (cast_rows_to on the card) keeps each NaN's sign and payload rule
        got = tk.normalize_cast(x, torch.bfloat16, normalize=False)
        want = tk.normalize_cast_plain(x, torch.bfloat16, normalize=False)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), rows
        assert torch.equal(got[:4096].view(torch.int16).cpu(),
                           tk.normalize_cast_plain(
                               x[:4096].cpu(), torch.bfloat16,
                               normalize=False).view(torch.int16)), rows
        err = max(err, max_abs(got.float().nan_to_num(),
                               want.float().nan_to_num()))
        cast = timing(cuda_ms(lambda: tk.normalize_cast(
                          x, torch.bfloat16, normalize=False), K17_QUEUED),
                      cuda_ms(lambda: tk.normalize_cast_plain(
                          x, torch.bfloat16, normalize=False), 20),
                      cuda_ms(lambda: x.to(torch.bfloat16), K17_QUEUED),
                      x.numel() * (4 + 2), 0, "fp32 SIMT")
        phase(f"phase 29 [{card}] K17 with normalization off (the bf16 cast "
              f"alone) on {rows} x {d} (NaN of both signs and payloads, "
              f"+-inf), bit for bit its plain version on the card and, on "
              f"4,096 rows, on the CPU: " + timing_line(
                  "normalize_cast(normalize=False)", cast) + " (library: "
              "torch's own cast, which writes other NaN bits)")
        del x, finite, got, want
    # the main path's two callers: one launch, no torch normalization
    for dtype in K17_DTYPES:
        store = DeviceStore.synthetic(4096, 768, dtype, 0, device="cuda")
        eng = SearchEngine(store)
        q = torch.randn((1024, 768), generator=gen, device="cuda")
        block = torch.randn((K17_SHAPES[1][0], 768), generator=gen,
                            device="cuda")
        data = torch.empty((K17_SHAPES[1][0], 768), dtype=dtype, device="cuda")
        for what, fn in (("query prep", lambda: eng._cast_queries(q)),
                         ("store block fill",
                          lambda: DeviceStore._fill(data, 0, block))):
            fn()
            before = tk.launch_counts["normalize_cast"]
            ops = dispatched_ops(fn)
            launched = tk.launch_counts["normalize_cast"] - before
            _ms, recorded, others = k17_profile(fn, 20)
            assert (launched == 1 and ops <= K17_CALLER_OPS and recorded
                    and not others), (what, dtype, launched, ops, recorded,
                                      others)
            phase(f"phase 29 {what} on {str(dtype).split('.')[-1]}: "
                  f"{launched} K17 launch a call, aten ops dispatched "
                  f"{sorted(ops)} (no arithmetic); the profiler over 20 "
                  f"calls after 20 unrecorded: {recorded} K17 kernels "
                  f"recorded, no other kernel and no aten op on the card")
        del store, eng, q, block, data
    torch.cuda.empty_cache()
    return err, recs[(K17_SHAPES[0][0], torch.bfloat16)]


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
        serialized = sum("serialized" in ln for ln in lib.log.splitlines())
        phase(f"phase 1 device: {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {lib.path.name} built in "
              f"{lib.build_s:.1f}s; ptxas: {' / '.join(regs)}; spills: "
              f"{' / '.join(spills) or 'none'}; functions whose wgmmas "
              f"ptxas serialized: {serialized}")
    phase(f"phase 1 kernel builds, in parallel: {build_wall:.1f}s wall")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    store = DeviceStore.synthetic(1_000_000, 768, "bfloat16", args.seed,
                                  device="cuda")
    store_100k = DeviceStore.synthetic(100_000, 768, "bfloat16",
                                       args.seed + 1, device="cuda")
    check_probe(args.seed)
    check_probe_pv(args.seed)
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
                ("matmul_blockmax2_only", "gather_rescore", "matmul_blockmax",
                 "normalize_cast")}
    phase(f"phase 4 kernel launches over the main path: {launches}")
    assert all(v > 0 for v in launches.values()), launches
    check_f32_rescore_pass(store_f32, gen, card)
    del store_f32

    host_qps, dev_qps = measure_qps(engine, store, gen)
    phase(f"phase 5 [{card}] 1M x 768 bf16, 1024 queries, k={K}: "
          f"search {host_qps:.1f} q/s, search_device {dev_qps:.1f} q/s")
    search_split(engine, store, gen, card)
    unit_sharing(engine, store, gen, card)
    for name, rec in times.items():
        phase(f"phase 5 [{card}] " + timing_line(name, rec))

    del engine, store, store_100k
    torch.cuda.empty_cache()

    errs["fused_attention_qkv"], times["fused_attention_qkv"] = \
        check_attention(gen)
    phase(f"phase 6 [{card}] " + timing_line(
        "fused_attention_qkv", times["fused_attention_qkv"]))
    check_encoder(args.seed, card)
    tree = tempfile.mkdtemp(prefix="bsr_smoke_")
    try:
        run_tree_phases(args, gen, card, tree, cfg, errs, times, launches)
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    check_nonfinite_search(args.seed, gen, card)
    errs["normalize_cast"], times["normalize_cast"] = check_normalize_cast(
        gen, card)

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name]["library_ms"],
         "lib_ms": times[name]["library_ms"],
         "device_alone_ms": times[name].get("device_alone_ms")}
        for name, (source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
