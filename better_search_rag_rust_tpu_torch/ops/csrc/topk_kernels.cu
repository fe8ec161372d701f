// Exact top-k scoring kernels for Hopper (sm_90a), plain C interface.
//
// Five kernels carry the exact search routes, K5 and K10 the block-max
// measurements and K11-K13 the gather measurements; each replaces Pallas
// kernels of better_search_rag_rust_tpu/ops/topk_pallas.py (K10-K13: of
// scripts/proto_*.py):
//
//   K1 bsr_matmul_blockmax2     <- matmul_blockmax2_only (:527, body :367)
//   K2 bsr_gather_rescore       <- gather_rescore        (:656, body :631)
//   K3 bsr_matmul_blockmax      <- matmul_blockmax       (:120, body :103)
//   K4 bsr_gather_rows          <- gather_rows           (:747, body :736)
//   K5 bsr_matmul_blockmax_only <- matmul_blockmax_only  (:222, body :178)
//   K6 bsr_block_scores         <- block_scores          (:846, body :828)
//   K10 bsr_matmul_blockmax2x   <- the block-max prototypes of scripts/proto_*.py
//                                  (bm2_v3, bm2_b, bm2t_pass, bm2x, the emit_var
//                                  raw key, bm2t_i8; see k10_blockmax2x)
//   K11 bsr_gather_copy         <- scripts/proto_dma2.py make_v01 with _v0_kernel
//                                  (:72, body :52): the copy-only gather
//   K12 bsr_gather_rescore_mm   <- scripts/proto_dma3.py make_fused (:80, body
//                                  :57): K2's scores plus a resident product
//   K13 bsr_gather_cross        <- scripts/proto_fused.py fused_scores (:139,
//                                  body :119): each 8-query group's full cross
//   K17 bsr_normalize_cast      <- no Pallas kernel: the XLA fusion that
//                                  normalizes and casts the store's and the
//                                  queries' rows (store/device_store.py:62)
//
// K4 and K11 move bytes only. K6 is K2's mainloop (gather_scores) over
// pre-gathered rows, so what is said of K2 below holds for it; K12's gather
// and K13 stage widened chunks and multiply them by mma_staged, in the same
// k16 steps, so their bf16 scores are K2's. K5 is K3 without its score store:
// the same score tile and the same
// block reduction (store_block_max, also K12's; K3's loop is the same code
// written out), so its block maxima are K3's bit for bit on every dtype.
//
// ONE ARITHMETIC RULE PER DTYPE. Every kernel scores a (query, row) pair of a
// given store dtype by the same rule, so the pair scores bit for bit the same
// in K1, K2 and K3 (and K5, K6, K10, K12, K13). The rescore route's argmax
// fast path (ops/topk.py) sorts K1 maxima and K2 rescored scores together and
// is exact only because of this identity; the port's oracle scores through K3.
// The JAX reference gets the same identity from one MXU dot per score
// (topk_pallas.py:47-66, _sims_dot). There is no split-K anywhere.
//
// BF16 STORES: the tensor cores. Every score starts at +0.0 and advances over
// D in 16-feature steps d0 = 0, 16, 32, ... in increasing order: the step's
// sum of 16 products from nothing, then score = __fadd_rn(score, that sum),
// store rows in A, queries in B, feature d0 + j in k slot j; a ragged last
// step is zero-padded in both operands, and no step lies wholly past D. The
// step's sum comes from one of two instructions, which give the same f32
// bits (the probe below, k_probe_bf16_k16: bit for bit on every cell of
// unit, normal, cancelling and mixed-exponent rows and of random bit
// patterns with subnormals, +-inf and NaN; PERF.md):
//     wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16, scale-d = 0
// in K1/K3/K5/K10's score tile and K12's product (score_tile_wg on bf16,
// bf16_slab(): slabs written by TMA in the 128-byte swizzle, operands read
// through shared-memory descriptors), and
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 from +0.0
// (mma_k16()) in K2/K6 (gather_scores: A fragments by ldmatrix from their
// own bf16 row slabs) and K12's gather/K13 (mma_staged(): fragments built
// from their widened staging, exact: the values were bf16). bf16_slab() and
// mma_k16() are the only code that advances a bf16 score. Each element of
// either result depends only on its own row of A and its own column of B,
// so how a kernel tiles rows, queries or D, and what sits in the other rows
// and columns of the instruction, cannot change a pair's bits. The sum of 16
// products inside the instruction is not a chain of rounded FMAs and may
// truncate (it differs from the float64 sum rounded once on 8-24 % of the
// probe's cells); the adds round to nearest. The score's error against the exact product of the same bf16
// operands is at most D * 2^-23 * sum_d |row_d q_d| (twice f32's round-off of
// D terms; ops/topk_kernels.py:score_bound, which chip_smoke.py and the gpu
// tests hold every kernel to).
//
// FLOAT32 STORES: the SIMT FMA chain, exact f32 arithmetic,
//     acc = +0.0f;  for d = 0 .. D-1:  acc = __fmaf_rn(row[d], q[d], acc)
// one rounded FMA per feature, in increasing order: no split-K, no
// reassociation, nothing left to the compiler's contraction of a * b + c.
// fma_features() below is the only code that advances an f32 accumulator:
// the score tile of K1/K3/K5/K10 (score_tile<float>) calls it on 4 features
// at a time (one 16-byte shared load per operand), and so do K2 and K6
// (gather_scores), one row a thread; every kernel calls it over consecutive
// D chunks, so each accumulator sees d in order. ops/topk_kernels.py:fma_chain_scores computes this chain
// exactly (float64, round to odd), and the gpu tests and chip_smoke.py hold
// K1, K3 and K5 to it bit for bit. A ragged D is zero-padded: the score tile
// runs the chain to the next multiple of F32_PAD = 16 features, K2 and K6 to
// the next multiple of the G_SB / 4 = 32 features of their slab. A +0 term leaves every accumulator as it is
// but -0.0, which it turns into +0.0; starting from +0.0 an accumulator holds
// -0.0 only where a negative sum underflows, and -0.0 compares equal to +0.0,
// so no selection sees it. TF32 would not be exact, so f32 stays off the
// tensor cores (the TPU's Mosaic f32 product was not exact either).
//
// THE NORM ORDER (K17, the store's and the queries' normalization). A row's
// sum of squares s is fixed bit for bit, on the card and in the plain version
// (ops/topk_kernels.py:normalize_cast_plain, torch f32 ops on either device):
// each feature squared with one rounded multiply and added with one rounded
// add (__fmul_rn, __fadd_rn: no FMA contraction); D zero-padded to a multiple
// of 128; lane l of 32 starts from +0.0 and adds its features 128c + 4l + j,
// c ascending and, inside each c, j = 0..3 in order; then the lane sums halve,
// v[i] += v[i + h] for h = 16, 8, 4, 2, 1, and s = v[0]. The order is over
// feature indices, not loads, so 16-byte and 4-byte loads give the same bits
// (a +0.0 pad term leaves a sum as it is: every term is +0.0 or more). Then n
// = sqrt_rn(s), n == 0 becomes 1 (the reference's zero guard), and y_d = x_d
// /rn n. Finite rows give the same bits on the CPU and the card; a NaN row
// the plain version's bits on the same device (the card's NaN is canonical).
//
// INT8 STORES (the lattice of ops/quantize.py) take the third rule: one
// exact int32 dot per score, then ONE int8_score(): __fmul_rn(float(acc),
// INT8_INV_SCALE2). Integer sums are exact in any order and any grouping
// (|acc| <= D * 127^2, far inside int32; a ragged tail is zero-padded,
// adding exact zeros), and float(acc) is exact below 2^24 (D <= 1040 on the
// lattice; raw int8 holding -128 needs sum_d |q_d r_d| <= 2^24, which D
// <= 1024 guarantees), so every kernel, every tiling, every instruction and the
// plain versions give the same bits — the argmax fast path's identity (K1
// max == K2 rescore == K3 score) holds by construction, and no order rule is
// needed. Two instructions form the dot: K1/K3/K5/K10's score tile runs on
// the s8 tensor cores (score_tile_i8: wgmma m64n128k32 fed by TMA, the s32
// sum kept in the instruction across all of D), K2 and K6, whose time is
// their gather, on __dp4a over 4-byte packs (gather_scores); so K1 = K2 = K3
// checks two instructions against each other.
// K1's emission runs on these scaled f32 scores exactly as on the float
// path. The reference packs (acc, row) into integer keys instead
// (topk_pallas.py:320, _int8_bm2_emit); both name the same argmax and m2
// unless two DISTINCT dots round to one scaled f32, and that needs |acc| near
// 2^23 (scores above 512), while lattice rows of unit vectors keep
// |acc| <~ 127^2 (scores near [-1, 1]), where adjacent integers stay ~500
// f32 ulps apart after the multiply. This replaces the int8 bodies of K1
// (topk_pallas.py:390-434) and the int8 arm of _sims_dot (:56-61) that K2
// and K3 score through.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrappers raise on
// anything else.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr float PAD_SIM = -3.0f;
// f32(1) / f32(127 * 127), bitwise ops/quantize.py's INT8_INV_SCALE2.
constexpr uint32_t INT8_INV_SCALE2_BITS = 0x38820610u;

// Score tile of K1/K3/K5/K10: TR store rows x TQ queries per block (threads:
// Tile<T>::threads). NT: the candidate slots of one K12 gather item.
constexpr int TR = 128;
constexpr int TQ = 128;
constexpr int NT = 256;
constexpr int LDO = TQ + 1;       // padded leading dim of the score tile
// f32 (score_tile<float>): F32_NT threads, each an MR x MQ micro-tile of
// accumulators, rows rb + F32_RSTEP * i and queries qb + F32_LQ * j (i < MR,
// j < MQ): the F32_NT / 32 warps stand F32_WQ side by side along the
// queries, each a F32_ROWS_W x F32_QUERIES_W tile, its lanes 32 / F32_LQ
// along the rows by F32_LQ along the queries. D goes through shared memory
// in slabs of F32_SK features, row-major as the operands lie in device
// memory, rows padded to F32_SLD floats, in a ring of F32_STAGES slabs filled
// by cp.async (16-byte copies; 4-byte ones where D % 4 != 0 or a base is not
// 16-byte aligned). A thread reads each of its rows' and queries' next 4
// features as one 16-byte shared load and takes them in order
// (fma_features), the queries F32_QG at a time: MR + MQ loads for 4 * MR *
// MQ FMAs. F32_SLD = 4 (mod 8): a warp's load of one row or query index
// touches 32 / F32_LQ (rows) or F32_LQ (queries) adjacent padded rows at one
// feature, whose 16-byte pieces fall on distinct groups of 4 banks, and the
// lanes that share a row broadcast: one shared-memory wavefront per load.
// The chain runs over D rounded up to F32_PAD features, so a ragged D takes
// the same +0 terms as in every earlier build of the tile (see the header).
constexpr int F32_NT = 128;
constexpr int F32_WQ = 1;
constexpr int F32_LQ = 8;
constexpr int F32_RSTEP = 32 / F32_LQ;
constexpr int F32_ROWS_W = TR / (F32_NT / 32 / F32_WQ);
constexpr int F32_QUERIES_W = TQ / F32_WQ;
constexpr int MR = F32_ROWS_W / F32_RSTEP;
constexpr int MQ = F32_QUERIES_W / F32_LQ;
constexpr int F32_SK = 32;
constexpr int F32_SLD = F32_SK + 4;
constexpr int F32_STAGES = 2;
constexpr int F32_QG = 4;
constexpr int F32_PAD = 16;
constexpr int F32_MIN_BLOCKS = 2;  // launch bound: 2 x 128 threads, up to 255 registers each
constexpr int F32_SLAB = TR * F32_SLD;  // floats of one operand's slab
// The f32 score tile st [TR][LDO] and the f32 ring (Tile<float>::smem).
constexpr size_t ST_BYTES = sizeof(float) * (size_t)TR * LDO;
constexpr size_t F32_RING_BYTES = sizeof(float) * (size_t)F32_STAGES * 2 * F32_SLAB;
static_assert(MR * F32_RSTEP == F32_ROWS_W && MQ * F32_LQ == F32_QUERIES_W,
              "the micro-tiles cover each warp's tile");
static_assert(F32_SLD % 8 == 4 && F32_SK % 4 == 0 && F32_PAD % 4 == 0 &&
                  MQ % F32_QG == 0 && F32_STAGES >= 2,
              "f32 slab geometry");
// The wgmma tile's (WG_LD), where the epilogue reads st only along rows
// (K1, K5, K10): LDO_I8 = 8 (mod 32) makes each warp's 8-byte stores of its
// accumulator pairs free of bank conflicts (the odd LDO is 4-way
// conflicted for that layout, and K3's transposed read needs it odd).
constexpr int LDO_I8 = TQ + 8;

// K2/K6 (gather_scores): one query x G_TILE candidate rows per block of
// G_TILE threads; D through a ring of G_STAGES slabs of G_SB bytes of each of
// the rows and of the query (G_ROWS slab rows, each padded to G_PITCH
// bytes); G_MIN_BLOCKS blocks an SM. K12's gather and K13 (GR rows a block)
// stage GDK features at a time, widened and transposed (GLD).
constexpr int G_TILE = 128;
constexpr int G_SB = 128;
constexpr int G_PITCH = G_SB + 16;
constexpr int G_ROWS = G_TILE + 1;
constexpr int G_STAGES = 6;
constexpr int G_MIN_BLOCKS = 2;
constexpr int G_STAGE_BYTES = G_ROWS * G_PITCH;
constexpr int G_WARP_ROWS = 32;  // bf16: each warp's two m16 tiles
static_assert(G_SB % 16 == 0 && G_PITCH % 128 == 16 && G_STAGES >= 2 &&
                  G_TILE % G_WARP_ROWS == 0,
              "gather slab geometry");
constexpr int GR = 128;
constexpr int GDK = 32;
constexpr int GLD = GR + 4;
static_assert(TR == TQ, "score_tile stages rows and queries in one loop");

// K12's gather and K13 stage bf16 rows widened to f32 (exact).
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// THE f32 dot routine (see the header): advance every accumulator acc[i][j]
// by K consecutive features, row i's in r[i][0 .. K-1] and query j's in
// q[j][0 .. K-1], in order, one FMA each. Every f32 score goes through it,
// 4 features (one 16-byte shared load of each operand) at a time: the score
// tile's micro-tiles and the gathers' (K2, K6) one row a thread.
template <int M, int N, int K>
__device__ __forceinline__ void fma_features(float (&acc)[M][N], const float (&r)[M][K],
                                             const float (&q)[N][K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = __fmaf_rn(r[i][k], q[j][k], acc[i][j]);
}

// ---- bf16 on the tensor cores (see the header) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 16 bytes from gmem, or 16 zero bytes when !full (gmem is then not read).
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

// cp_async16_or_zero that also asks L2 to fetch the aligned 256 bytes
// around the piece (the gathers' next slab of the same row).
__device__ __forceinline__ void cp_async16_l2_or_zero(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes from gmem, or 4 zero bytes when !full (gmem is then not read).
__device__ __forceinline__ void cp_async4_or_zero(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i,
// whose row lane/4, elements 2*(lane%4) and +1, land in r[i] (lower column
// in the lower half).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// THE bf16 dot step (see the header): c += A (16 rows x 16 features) * B (16
// features x 8 queries), f32 scores: one mma.sync from a +0.0 accumulator,
// then one rounded add per score. Fragments as the PTX ISA lays out m16n8k16,
// with g = lane / 4 and t = lane % 4:
//   a[0] (row g, k 2t..2t+1)   a[1] (row g+8, k 2t..)   a[2] (row g, k 2t+8..)
//   a[3] (row g+8, k 2t+8..);  b[0] (k 2t..2t+1, query g)  b[1] (k 2t+8.., g);
//   c[0..1] (row g, queries 2t, 2t+1)  c[2..3] (row g+8, queries 2t, 2t+1).
// Accumulating in the instruction (c as its C operand) aligns each product
// to the running score and drops its low bits: against float64 that had 3x
// the largest error and 6x the mean error of this form on raw normal queries
// (bench/ab_topk.py), and K13 left the plain version's 1e-5 on the
// prototype's data (chip_smoke.py phase 22), for 20 % of K1's time.
__device__ __forceinline__ void mma_k16_product(float (&p)[4], const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

__device__ __forceinline__ void mma_k16(float (&c)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  float p[4];
  mma_k16_product(p, a, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], p[e]);
}

// Two staged f32 values (bf16 widened, so exact) as one bf16x2 operand.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The gather kernels' bf16 product: advance a warp's M16 m16 tiles — staged
// rows rb .. rb + 16*M16 - 1 of the transposed f32 staging rs[k * r_ld + r]
// that K12's gather and K13 fill — against B's columns j < nq, query j's staged feature k at
// qs[k * q_ld + j] (columns nq .. 7 zero), by the k16 steps of a chunk of dk
// staged features whose first is feature d0, skipping steps at or past D as
// the score tile does. Staged feature d0 + kk + j sits in k slot j of step
// d0 + kk, as in the score tile's and gather_scores' fragments.
template <int M16>
__device__ __forceinline__ void mma_staged(float (&acc)[M16][4], const float* rs, int r_ld,
                                           int rb, const float* qs, int q_ld, int nq,
                                           int d0, int dk, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < dk && d0 + kk < D; kk += 16) {
    const int k0 = kk + 2 * t;
    uint32_t b[2] = {0u, 0u};
    if (g < nq) {
      b[0] = pack_bf16x2(qs[k0 * q_ld + g], qs[(k0 + 1) * q_ld + g]);
      b[1] = pack_bf16x2(qs[(k0 + 8) * q_ld + g], qs[(k0 + 9) * q_ld + g]);
    }
#pragma unroll
    for (int m = 0; m < M16; ++m) {
      const float* r = rs + rb + m * 16 + g;
      const uint32_t a[4] = {pack_bf16x2(r[k0 * r_ld], r[(k0 + 1) * r_ld]),
                             pack_bf16x2(r[k0 * r_ld + 8], r[(k0 + 1) * r_ld + 8]),
                             pack_bf16x2(r[(k0 + 8) * r_ld], r[(k0 + 9) * r_ld]),
                             pack_bf16x2(r[(k0 + 8) * r_ld + 8], r[(k0 + 9) * r_ld + 8])};
      mma_k16(acc[m], a, b);
    }
  }
}

// Query column j < nq of a warp's mma_staged tiles to out[j * o_ld + r], r the
// staged row.
template <int M16>
__device__ __forceinline__ void store_staged(const float (&acc)[M16][4], int rb, int nq,
                                             float* out, int o_ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < M16; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * t + (e & 1);
      if (j < nq) out[j * o_ld + rb + m * 16 + g + 8 * (e >> 1)] = acc[m][e];
    }
}

// Scores of store rows [row0, row0 + TR) against queries [q0, q0 + TQ) into
// the shared score tile st[r * LDO + c]; rows at or past valid_rows are
// masked to PAD_SIM. Queries past Tn score against zeros and are never
// written out by the callers. Requires R % TR == 0. f32 and bf16 have the
// specialisations below, int8 score_tile_i8.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ q,
                                           const T* __restrict__ shard,
                                           int Tn, int D, int valid_rows,
                                           int row0, int q0, float* smem);

// threadIdx.x, read where it is called: what the f32 tile derives from it
// (its copies' addresses) is then computed in the tile, not hoisted out of
// K10's loop over row tiles, where it spilled at 255 registers.
__device__ __forceinline__ int thread_index() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return tid;
}

// The f32 tile's product over one staged slab (score_tile<float>): the first
// `groups` (<= G) 4-feature fragments of rows rs + F32_RSTEP * i and queries
// qs + F32_LQ * j, each taken in order by fma_features.
template <int G>
__device__ __forceinline__ void fma_slab(float (&acc)[MQ / F32_QG][MR][F32_QG],
                                         const float* rs, const float* qs, int groups = G) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g == groups) break;
    float rv[MR][4];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(rs + F32_RSTEP * i * F32_SLD + 4 * g);
      rv[i][0] = v.x, rv[i][1] = v.y, rv[i][2] = v.z, rv[i][3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < MQ / F32_QG; ++h) {
      float qv[F32_QG][4];
#pragma unroll
      for (int j = 0; j < F32_QG; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(qs + F32_LQ * (F32_QG * h + j) * F32_SLD + 4 * g);
        qv[j][0] = v.x, qv[j][1] = v.y, qv[j][2] = v.z, qv[j][3] = v.w;
      }
      fma_features<MR, F32_QG, 4>(acc[h], rv, qv);
    }
  }
}

// The f32 score tile, on the SIMT FMA pipes (the exact chain; see the header
// and the constants' note). Bound: the 2*TR*TQ*D operations at the f32 rate
// (K1 at 512 queries of 1M x 768: 11.7 ms) against reading the store once
// (0.9 ms), so the tile keeps the FMA pipes fed: the slabs of the next
// F32_STAGES - 1 steps are in flight while the warps multiply this one, one
// barrier per slab (it also frees the slot the next copies fill), and each
// 16-byte fragment load feeds 4 * MR * MQ / (MR + MQ) FMAs: 21 at 8 x 16
// (128 accumulators a thread), 16 at 8 x 8. Hopper issues four warp FMAs
// a cycle an SM against 128 bytes of shared memory, and on the card 8 x 16
// at two blocks of 128 threads beat 8 x 8 at two of 256, which spills at
// 128 registers, and at one (bench/ab_topk.py, PERF.md). The ring
// (F32_STAGES x 36 KB) becomes st once drained.
template <>
__device__ __forceinline__ void score_tile<float>(const float* __restrict__ q,
                                                  const float* __restrict__ shard, int Tn,
                                                  int D, int valid_rows, int row0, int q0,
                                                  float* smem) {
  // F32_STAGES x {rows [TR][F32_SLD], queries [TQ][F32_SLD]}
  const int tid = thread_index(), lane = tid & 31, warp = tid >> 5;
  const int rb = (warp / F32_WQ) * F32_ROWS_W + lane / F32_LQ;
  const int qb = (warp % F32_WQ) * F32_QUERIES_W + lane % F32_LQ;
  const bool vec = (D & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(shard)) & 15) == 0;
  const int slabs = (D + F32_SK - 1) / F32_SK;
  const int dpad = (D + F32_PAD - 1) / F32_PAD * F32_PAD;  // the chain's length

  // Slab s into its slot, zeros past D and past Tn; a copy that reads
  // nothing keeps a source address inside its tensor.
  auto stage = [&](int s) {
    float* rs = smem + (s % F32_STAGES) * 2 * F32_SLAB;
    float* qs = rs + F32_SLAB;
    const int d0 = s * F32_SK;
    if (vec) {
      constexpr int CH = F32_SK / 4;  // 16-byte pieces a slab row
      for (int e = tid; e < TR * CH; e += F32_NT) {
        const int r = e / CH, dd = 4 * (e % CH), gd = d0 + dd, gq = q0 + r;
        const bool in = gd < D, q_in = in && gq < Tn;  // D % 4 == 0: whole pieces
        cp_async16_or_zero(rs + r * F32_SLD + dd,
                           shard + (size_t)(row0 + r) * D + (in ? gd : 0), in);
        cp_async16_or_zero(qs + r * F32_SLD + dd, q + (q_in ? (size_t)gq * D + gd : 0), q_in);
      }
    } else {
      for (int e = tid; e < TR * F32_SK; e += F32_NT) {
        const int r = e / F32_SK, dd = e % F32_SK, gd = d0 + dd, gq = q0 + r;
        const bool in = gd < D, q_in = in && gq < Tn;
        cp_async4_or_zero(rs + r * F32_SLD + dd,
                          shard + (size_t)(row0 + r) * D + (in ? gd : 0), in);
        cp_async4_or_zero(qs + r * F32_SLD + dd, q + (q_in ? (size_t)gq * D + gd : 0), q_in);
      }
    }
  };

  // acc[h][i][j]: row rb + F32_RSTEP * i, query qb + F32_LQ * (F32_QG * h + j)
  float acc[MQ / F32_QG][MR][F32_QG];
#pragma unroll
  for (int h = 0; h < MQ / F32_QG; ++h)
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < F32_QG; ++j) acc[h][i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < F32_STAGES - 1; ++s) {
    if (s < slabs) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<F32_STAGES - 2>();  // this thread's copies of slab s have landed
    __syncthreads();  // ... and every thread's; every warp is done with slab s - 1
    if (s + F32_STAGES - 1 < slabs) stage(s + F32_STAGES - 1);  // into slab s - 1's slot
    cp_async_commit();
    const float* rs = smem + (s % F32_STAGES) * 2 * F32_SLAB + rb * F32_SLD;
    const float* qs = smem + (s % F32_STAGES) * 2 * F32_SLAB + F32_SLAB + qb * F32_SLD;
    // A whole slab of the chain runs without a branch, so the compiler may
    // hoist each fragment's loads above the FMAs of the one before.
    if ((s + 1) * F32_SK <= dpad)
      fma_slab<F32_SK / 4>(acc, rs, qs);
    else
      fma_slab<F32_SK / 4>(acc, rs, qs, (dpad - s * F32_SK) / 4);
  }
  cp_async_wait<0>();  // only empty groups are left
  __syncthreads();     // every warp is done with the ring: it becomes st

  float* st = smem;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = rb + F32_RSTEP * i;
    const bool ok = row0 + r < valid_rows;
#pragma unroll
    for (int h = 0; h < MQ / F32_QG; ++h)
#pragma unroll
      for (int j = 0; j < F32_QG; ++j)
        st[r * LDO + qb + F32_LQ * (F32_QG * h + j)] = ok ? acc[h][i][j] : PAD_SIM;
  }
  __syncthreads();
}

// ---- int8 lattice (see the header) ----

// THE int8 score: one rounded multiply of the exact dot, by the lattice's
// INT8_INV_SCALE2 (or by the scale K10 is given).
__device__ __forceinline__ float int8_score(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

__device__ __forceinline__ float int8_score(int acc) {
  return int8_score(acc, __uint_as_float(INT8_INV_SCALE2_BITS));
}

// K10's raw int8 key pads masked rows with this integer.
constexpr int32_t PAD_ACC = -(1 << 24);  // below any dot at D <= 1040

// ---- int8 and bf16 on the tensor cores: wgmma fed by TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map (x: the inner coordinate, y: the row) into
// shared memory; its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// The wgmma descriptor of a K-major operand whose rows are 128 bytes in the
// 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row atoms of 1024
// bytes (the stride byte offset), layout type 1; p is the first row's k
// byte, within a 1024-byte-aligned atom.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (s32, 64 store rows x 128 queries over one warpgroup) += A (64 rows x 32
// features) * B (32 features x 128 queries), both K-major in shared memory.
// Register d[4j + e] of lane l in warp w of the warpgroup holds row 16w +
// l/4 + 8(e/2), query 8j + 2(l%4) + e%2.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41,"
      " %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The bf16 product of one k16 step (THE bf16 dot step's sum, on wgmma): d
// (f32, 64 store rows x N queries over one warpgroup, the register map of
// wgmma_s8_m64n128k32) = A (64 rows x 16 features) * B (16 features x N
// queries), both K-major in shared memory, with scale-d = 0: d's old values
// are not read, so each product starts from nothing, as mma_k16's from +0.0.
template <int N>
__device__ __forceinline__ void wgmma_bf16_k16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16_k16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_bf16_k16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma that owns them.
template <typename V, int N>
__device__ __forceinline__ void fence_regs(V (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<V, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// Bytes of one slab row of the wgmma tiles: one TMA box's width, the
// 128-byte swizzle's row.
constexpr int SLAB_BYTES = 128;

// Rows [r0, r0 + rows) x features [d0, d0 + 128 / sizeof(T)) of a row-major
// matrix m [n, D] into a slab as a 128-byte-swizzled TMA box lays it out
// (row r's 16-byte chunk c at r * 128 + 16 * (c ^ (r & 7))), zeros at or
// past n and D; thread `lane` of `threads`.
template <typename T>
__device__ __forceinline__ void stage_slab(uint8_t* slab, const T* __restrict__ m, int n, int D,
                                           int r0, int d0, int lane, int threads = 32,
                                           int rows = 128) {
  constexpr int B = (int)sizeof(T), E = 16 / B;  // bytes of an element, elements of a chunk
  using U = typename std::conditional<B == 1, uint8_t, uint16_t>::type;
  const U* bits = reinterpret_cast<const U*>(m);
  for (int e = lane; e < rows * 8; e += threads) {
    const int r = e >> 3, c = e & 7, gr = r0 + r, gd = d0 + E * c;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (gr < n) {
#pragma unroll
      for (int b = 0; b < E; ++b)
        if (gd + b < D) w[b * B / 4] |= (uint32_t)bits[(size_t)gr * D + gd + b] << (8 * ((b * B) & 3));
    }
    *reinterpret_cast<uint4*>(slab + r * SLAB_BYTES + 16 * (c ^ (r & 7))) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// What the wgmma tile's TMA boxes carry: the tensor maps of the queries
// [Tn, D] and the store [R, D] (boxes of 128 rows x SLAB_BYTES bytes, the
// 128-byte swizzle, zero fill past either edge), or tma == 0 where TMA
// cannot read them (a row's bytes not a multiple of 16, or a base that is
// not 16-byte aligned).
struct WgMaps {
  CUtensorMap q, shard;
  int tma;
};
struct NoMaps {};

// THE WGMMA SCORE TILE (int8 and bf16 operands): score_tile's contract (st
// [TR][LD] f32, rows at or past valid_rows PAD_SIM) on the tensor cores,
// for K1/K3/K5/K10 (and K12's product on bf16); LD is LDO or WG_LD (each
// thread's score pairs then go out as 8-byte stores). NT_WG threads: two
// consumer warpgroups, warpgroup w owning store rows 64w .. 64w + 63 against
// all TQ queries (rows in A, queries in B; 64 scores a thread), and one
// producer warp that keeps a ring of WG_STAGES slabs full: D in slabs of
// SLAB_BYTES a row (128 int8 or 64 bf16 features), each the store rows' and
// the queries' 128 bytes, written by TMA (two boxes, the 128-byte swizzle
// wgmma's descriptors read) into 1024-byte-aligned shared memory, guarded by
// mbarriers (full: the box bytes landed; empty: all 256 consumers are done
// with the slot). Each descriptor advances 32 bytes a k step: k32 on int8,
// k16 on bf16, 4 steps a slab, none wholly past D. TMA zero-fills past D and
// past Tn; where TMA cannot read the operands, the producer warp stages the
// same swizzled slabs itself (stage_slab) with the same zero padding, and
// the same wgmma multiply them. After the k loop the ring (96 KB) becomes
// st; with K1's unit maxima a block takes ~97 KB of shared memory.
//  * int8: per slab each warpgroup issues four wgmma m64n128k32 s8 into its
//    s32 scores, which stay in the instruction across all of D, exact in
//    any order, then int8_score (or, RAW, the exact dots, masked rows
//    PAD_ACC, for K10's integer key). 2 blocks an SM (__launch_bounds__(
//    NT_WG, 2), at most 112 registers): one block's epilogue runs under the
//    other's product. Bound: the 2*TR*TQ*D operations at the int8 tensor
//    rate (K1 at 512 queries of 1M x 768: 0.40 ms) against the operand
//    bytes (0.24 ms of reading the store once). On the card
//    (bench/ab_topk.py, PERF.md) 4 stages at one block per SM ran 1.6x
//    slower, and halving the loads moved K1 by under 5 %.
//  * bf16: THE bf16 dot step of the header on wgmma (bf16_slab): each k16
//    step is TQ / BF16_N wgmma m64nBF16_Nk16 with scale-d = 0, each into one
//    of BF16_PRODUCTS product fragments taken in turn, then one __fadd_rn a
//    score, in increasing step order; the adds of one product run while the
//    next is in the tensor cores (wait_group BF16_PRODUCTS - 1). Bound: the
//    2*TR*TQ*D operations at the bf16 tensor rate (K1: 0.80 ms) and, as
//    long, the rule's one f32 add a score a k16 step on the FP32 pipes
//    (K1: 2.46e10 adds, 128 a clock on each of 132 SMs): the two overlap
//    only while the adds leave the issue slots to little else, which the
//    descriptors (no fragment loads) allow. 64 scores and two 64-register
//    products a consumer thread: NT_BF16 threads (the producer a whole
//    warpgroup, warp 8 of it working), one block an SM (BF16_MIN_BLOCKS;
//    168 registers a thread at launch), setmaxnreg giving each consumer
//    BF16_CONSUMER_REGS and the producer warpgroup BF16_PRODUCER_REGS for
//    the k loop, and all threads back to BF16_LAUNCH_REGS for the epilogue
//    (the scores stay in the consumers' branch until they are in st: code
//    shared with the producer's 40 registers cannot hold them). On the card
//    (bench/ab_topk.py, PERF.md) a k16 step of both warpgroups takes ~290
//    cycles against 128 at the tensor rate, the adds a quarter of K1's time
//    and the ring, barriers and epilogue alone ~60 %; m64n64 products (two
//    or four), one product, a 4-slab ring, and a full slab's last wgmma
//    left running into the next slab (ptxas then serializes) time alike or
//    lose.
// The warp index comes through __shfl_sync, so ptxas knows each role's
// branch is uniform in its warp and need not serialize the wgmmas inside
// (it did for the int8 tile before: K1 int8 ~9 % slower).
constexpr int WG_CONSUMERS = 256;
constexpr int NT_WG = WG_CONSUMERS + 32;
constexpr int NT_BF16 = WG_CONSUMERS + 128;
constexpr int WG_STAGES = 3;
constexpr int WG_STAGE_BYTES = (TR + TQ) * SLAB_BYTES;
constexpr size_t WG_RING_BYTES = (size_t)WG_STAGES * WG_STAGE_BYTES;
// The leading dimension of st in K1, K5 and K10 on the wgmma tile.
constexpr int WG_LD = LDO_I8;
// What precedes the ring in a block's dynamic shared memory: the mbarriers
// (64 bytes) and the slack that aligns the ring to 1024 bytes.
constexpr size_t WG_SMEM_PAD = 1024 + 64;
constexpr int BF16_N = 128;
constexpr int BF16_PRODUCTS = 2;
constexpr int BF16_MIN_BLOCKS = 1;
constexpr int BF16_LAUNCH_REGS = 168;  // 65,536 / 384, on the allocation's 8-register grain
constexpr int BF16_PRODUCER_REGS = 40;
constexpr int BF16_CONSUMER_REGS = 232;
static_assert(BF16_PRODUCER_REGS * (NT_BF16 - WG_CONSUMERS) +
                      BF16_CONSUMER_REGS * WG_CONSUMERS <=
                  BF16_LAUNCH_REGS * NT_BF16,
              "setmaxnreg stays inside the block's allocation");
static_assert(TR == 2 * 64 && TQ == 128, "two m64 warpgroups, n128");
static_assert(TQ % BF16_N == 0 && BF16_PRODUCTS >= 1 && BF16_PRODUCTS <= 4,
              "bf16 product fragments");

// The ring's start in a block's dynamic shared memory: 1024-byte aligned,
// with 64 bytes of mbarriers before it.
__device__ __forceinline__ float* wg_tile_base(float4* raw) {
  const uint32_t a = smem_addr(raw);
  return reinterpret_cast<float*>(reinterpret_cast<char*>(raw) +
                                  (((a + 64 + 1023) & ~1023u) - a));
}

// Dynamic shared memory of a block on the wgmma tile: the ring, or st at
// leading dimension ld plus `extra` bytes past it (K1/K10's unit maxima),
// whichever is larger, and the pad.
constexpr size_t wg_smem(int ld, size_t extra) {
  const size_t past_st = sizeof(float) * (size_t)TR * (ld > LDO ? ld : LDO) + extra;
  return WG_SMEM_PAD + (WG_RING_BYTES > past_st ? WG_RING_BYTES : past_st);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// This thread's warp, through a shuffle from lane 0: ptxas then knows it is
// uniform in the warp.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// One staged slab's bf16 k16 steps for a consumer thread (score_tile_wg):
// its first LIVE of 4 * TQ / BF16_N wgmmas (step i / (TQ / BF16_N),
// queries BF16_N * (i % (TQ / BF16_N)) onwards), each product added to its
// scores while the next one runs; every product is added before it
// returns. LIVE is a template argument, so the wgmmas and waits run
// unconditionally.
template <int LIVE>
__device__ __forceinline__ void bf16_slab(float (&acc)[64],
                                          float (&p)[BF16_PRODUCTS][BF16_N / 2],
                                          const uint8_t* rs, const uint8_t* qs) {
  constexpr int NS = TQ / BF16_N, PROD = BF16_PRODUCTS, W = BF16_N / 2;
#pragma unroll
  for (int i = 0; i < LIVE + PROD - 1; ++i) {
    if (i < LIVE) {
      fence_regs(p[i % PROD]);
      wgmma_fence();
      wgmma_bf16_k16<BF16_N>(p[i % PROD], sw128_desc(rs + 32 * (i / NS)),
                             sw128_desc(qs + (i % NS) * BF16_N * SLAB_BYTES + 32 * (i / NS)));
      wgmma_commit();
    }
    const int j = i - (PROD - 1);  // the wgmma whose product is added now
    if (j >= 0) {
      const int later = (i < LIVE ? i : LIVE - 1) - j;  // wgmmas issued after it
      if (later >= 3)
        wgmma_wait<3>();
      else if (later == 2)
        wgmma_wait<2>();
      else if (later == 1)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(p[j % PROD]);
#pragma unroll
      for (int e = 0; e < W; ++e)
        acc[(j % NS) * W + e] = __fadd_rn(acc[(j % NS) * W + e], p[j % PROD][e]);
    }
  }
}

template <typename T, bool RAW, int LD>
__device__ __forceinline__ void score_tile_wg(const T* __restrict__ q,
                                              const T* __restrict__ shard, int Tn, int D,
                                              int valid_rows, int row0, int q0, float* smem,
                                              const WgMaps& maps, float scale) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  static_assert(BF || std::is_same<T, int8_t>::value, "int8 or bf16 operands");
  static_assert(!(BF && RAW), "RAW keeps int8 dots");
  constexpr int F = SLAB_BYTES / (int)sizeof(T);  // features of a slab row
  constexpr int KF = 32 / (int)sizeof(T);         // features of a k step
  using Acc = typename std::conditional<BF, float, int>::type;
  // WG_STAGES x {rows [TR][SLAB_BYTES], queries [TQ][SLAB_BYTES]}
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring) - 2 * WG_STAGES;
  uint64_t* empty = full + WG_STAGES;
  const int tid = threadIdx.x, warp = warp_index(), lane = tid & 31;
  const int slabs = (D + F - 1) / F;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], maps.tma ? 1 : 32);  // TMA: one arrival + the bytes
      mbar_init(&empty[s], WG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= WG_CONSUMERS / 32) {  // the producer: warp 8 works
    if constexpr (BF) setmaxnreg_dec<BF16_PRODUCER_REGS>();
    for (int s = 0; warp == WG_CONSUMERS / 32 && s < slabs; ++s) {
      const int stage = s % WG_STAGES;
      uint8_t* rs = ring + stage * WG_STAGE_BYTES;
      uint8_t* qs = rs + TR * SLAB_BYTES;
      if (s >= WG_STAGES) mbar_wait(&empty[stage], (s / WG_STAGES - 1) & 1);
      if (maps.tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[stage], WG_STAGE_BYTES);
          tma_load_2d(rs, &maps.shard, s * F, row0, &full[stage]);
          tma_load_2d(qs, &maps.q, s * F, q0, &full[stage]);
        }
      } else {
        stage_slab(rs, shard, row0 + TR, D, row0, s * F, lane);
        stage_slab(qs, q, Tn, D, q0, s * F, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        mbar_arrive(&full[stage]);
      }
    }
    if constexpr (BF) setmaxnreg_inc<BF16_LAUNCH_REGS>();  // once the consumers gave theirs back
  } else {
    // The consumers keep their scores to themselves until they are in st:
    // no code they share with the producer (whose registers are fewer)
    // holds them.
    if constexpr (BF) setmaxnreg_inc<BF16_CONSUMER_REGS>();
    const int wg = warp >> 2;
    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    float p[BF16_PRODUCTS][BF16_N / 2];  // bf16: the product fragments
    if constexpr (BF) {
#pragma unroll
      for (int k = 0; k < BF16_PRODUCTS; ++k)
#pragma unroll
        for (int e = 0; e < BF16_N / 2; ++e) p[k][e] = 0.0f;
    }
    for (int s = 0; s < slabs; ++s) {
      const int stage = s % WG_STAGES;
      const uint8_t* rs = ring + stage * WG_STAGE_BYTES + wg * 64 * SLAB_BYTES;
      const uint8_t* qs = ring + stage * WG_STAGE_BYTES + TR * SLAB_BYTES;
      mbar_wait(&full[stage], (s / WG_STAGES) & 1);
      if constexpr (BF) {
        constexpr int NS = TQ / BF16_N;
        const int steps = min(4, (D - s * F + KF - 1) / KF);  // no step wholly past D
        if (steps == 4)
          bf16_slab<4 * NS>(acc, p, rs, qs);
        else if (steps == 3)
          bf16_slab<3 * NS>(acc, p, rs, qs);
        else if (steps == 2)
          bf16_slab<2 * NS>(acc, p, rs, qs);
        else
          bf16_slab<NS>(acc, p, rs, qs);
      } else {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < SLAB_BYTES / 32; ++k)
          if (s * F + KF * k < D)  // no step wholly past D
            wgmma_s8_m64n128k32(acc, sw128_desc(rs + 32 * k), sw128_desc(qs + 32 * k));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(&empty[stage]);  // this thread's wgmmas are done with the slot
    }
    // Every consumer's wgmmas have read their slabs (and every slab has
    // landed: each was waited for), so the ring becomes st.
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
    if (tid == 0)
      for (int s = 0; s < 2 * WG_STAGES; ++s) mbar_inval(&full[s]);
    const int g = lane >> 2, t = lane & 3;
    int* ist = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * h;
      const bool ok = row0 + r < valid_rows;
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const Acc a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if constexpr (RAW) {
          const int2 v = ok ? make_int2(a0, a1) : make_int2(PAD_ACC, PAD_ACC);
          if constexpr (LD % 2 == 0) {
            *reinterpret_cast<int2*>(ist + r * LD + c) = v;
          } else {
            ist[r * LD + c] = v.x;
            ist[r * LD + c + 1] = v.y;
          }
        } else {
          float2 v = make_float2(PAD_SIM, PAD_SIM);
          if (ok) {
            if constexpr (BF)
              v = make_float2(a0, a1);
            else
              v = make_float2(int8_score(a0, scale), int8_score(a1, scale));
          }
          if constexpr (LD % 2 == 0) {
            *reinterpret_cast<float2*>(smem + r * LD + c) = v;
          } else {
            smem[r * LD + c] = v.x;
            smem[r * LD + c + 1] = v.y;
          }
        }
      }
    }
    if constexpr (BF) setmaxnreg_dec<BF16_LAUNCH_REGS>();  // the scores are in st
  }
  __syncthreads();
}

// Per score-tile dtype: the block size, the blocks an SM should hold (the
// launch bound), the leading dimension of st in K1, K5 and K10, what the
// wgmma tile's TMA needs (nothing for the f32 tile), a block's dynamic
// shared memory with `extra` bytes past st (K1/K10's unit maxima), and
// where st starts in it.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int threads = F32_NT;
  static constexpr int min_blocks = F32_MIN_BLOCKS;
  static constexpr int ld = LDO;
  using Maps = NoMaps;
  // the ring is drained before st and the unit maxima are written
  static constexpr size_t smem(size_t extra) {
    return F32_RING_BYTES > ST_BYTES + extra ? F32_RING_BYTES : ST_BYTES + extra;
  }
  static __device__ __forceinline__ float* base(float4* raw) {
    return reinterpret_cast<float*>(raw);
  }
};

// ==== int8 score tile: begin (bench/ab_topk.py swaps this block) ====

// The int8 score tile: the wgmma tile on s8 operands, each score
// int8_score(acc, scale) of its exact dot (RAW: the dots themselves, for
// K10's integer key).
template <>
struct Tile<int8_t> {
  static constexpr int threads = NT_WG;
  static constexpr int min_blocks = 2;
  static constexpr int ld = WG_LD;
  using Maps = WgMaps;
  static constexpr size_t smem(size_t extra) { return wg_smem(ld, extra); }
  static __device__ __forceinline__ float* base(float4* raw) { return wg_tile_base(raw); }
};

template <bool RAW, int LD>
__device__ __forceinline__ void score_tile_i8(const int8_t* __restrict__ q,
                                              const int8_t* __restrict__ shard, int Tn, int D,
                                              int valid_rows, int row0, int q0, float* smem,
                                              const WgMaps& maps, float scale) {
  score_tile_wg<int8_t, RAW, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps, scale);
}

// ==== int8 score tile: end ====

// ==== bf16 score tile: begin (bench/ab_topk.py swaps this block) ====

// The bf16 score tile: the wgmma tile on bf16 operands, each k16 step one
// wgmma product added to the score by one __fadd_rn (bf16_slab).
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int threads = NT_BF16;
  static constexpr int min_blocks = BF16_MIN_BLOCKS;
  static constexpr int ld = WG_LD;
  using Maps = WgMaps;
  static constexpr size_t smem(size_t extra) { return wg_smem(ld, extra); }
  static __device__ __forceinline__ float* base(float4* raw) { return wg_tile_base(raw); }
};

template <int LD>
__device__ __forceinline__ void score_tile_bf16(const __nv_bfloat16* __restrict__ q,
                                                const __nv_bfloat16* __restrict__ shard, int Tn,
                                                int D, int valid_rows, int row0, int q0,
                                                float* smem, const WgMaps& maps) {
  score_tile_wg<__nv_bfloat16, false, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps,
                                          1.0f);
}

// ==== bf16 score tile: end ====

// ---- the instruction probe: one bf16 k16 step on wgmma and on mma.sync ----
//
// Rows [64 b, 64 b + 64) of rows [R, D] (block b) against the 128 queries q
// [128, D]: each k16 step's f32 sum, both ways, [steps][R][128] each with
// steps = ceil(D / 16):
//  * out_wg: wgmma_bf16_k16<128> with scale-d = 0 on slabs staged as the
//    score tile lays them out (stage_slab), descriptors 32 bytes a step;
//  * out_mma: mma_k16_product from +0.0, rows in A, queries in B, feature
//    d0 + j in k slot j, the fragments read from device memory.
// Whether the two agree bit for bit decides whether K1/K3's score tile
// (wgmma) and K2/K6's gather (mma.sync) score a pair alike (PERF.md). It
// replaces no TPU kernel; it measures the card.
constexpr int PROBE_ROWS = 64;

__global__ void __launch_bounds__(128)
k_probe_bf16_k16(const __nv_bfloat16* __restrict__ rows, const __nv_bfloat16* __restrict__ q,
                 int R, int D, float* __restrict__ out_wg, float* __restrict__ out_mma) {
  __shared__ __align__(1024) uint8_t slab[(PROBE_ROWS + TQ) * SLAB_BYTES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * PROBE_ROWS, steps = (D + 15) / 16;
  uint8_t* rs = slab;
  uint8_t* qs = slab + PROBE_ROWS * SLAB_BYTES;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int s = 0; 64 * s < D; ++s) {
    __syncthreads();  // the last slab's wgmmas have been waited for
    stage_slab(rs, rows, R, D, r0, 64 * s, tid, 128, PROBE_ROWS);
    stage_slab(qs, q, TQ, D, 0, 64 * s, tid, 128, TQ);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    for (int k = 0; k < 4 && 64 * s + 16 * k < D; ++k) {
      fence_regs(d);
      wgmma_fence();
      wgmma_bf16_k16<128>(d, sw128_desc(rs + 32 * k), sw128_desc(qs + 32 * k));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      float* o = out_wg + ((size_t)(4 * s + k) * R + r0) * TQ;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        o[(16 * warp + g + 8 * ((i >> 1) & 1)) * TQ + 8 * (i >> 2) + 2 * t + (i & 1)] = d[i];
    }
  }
  const uint16_t* rb = reinterpret_cast<const uint16_t*>(rows);
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q);
  auto pair = [&](const uint16_t* m, int n, int r, int f) -> uint32_t {  // features f, f + 1
    const uint32_t lo = (r < n && f < D) ? m[(size_t)r * D + f] : 0u;
    const uint32_t hi = (r < n && f + 1 < D) ? m[(size_t)r * D + f + 1] : 0u;
    return lo | (hi << 16);
  };
  const int ra = r0 + 16 * warp + g;
  for (int st = 0; st < steps; ++st) {
    const int d0 = 16 * st;
    const uint32_t a[4] = {pair(rb, R, ra, d0 + 2 * t), pair(rb, R, ra + 8, d0 + 2 * t),
                           pair(rb, R, ra, d0 + 2 * t + 8), pair(rb, R, ra + 8, d0 + 2 * t + 8)};
    float* o = out_mma + ((size_t)st * R + r0) * TQ;
    for (int j = 0; j < TQ / 8; ++j) {
      const uint32_t b[2] = {pair(qb, TQ, 8 * j + g, d0 + 2 * t),
                             pair(qb, TQ, 8 * j + g, d0 + 2 * t + 8)};
      float p[4];
      mma_k16_product(p, a, b);
      const int c = 8 * j + 2 * t;
      o[(16 * warp + g) * TQ + c] = p[0];
      o[(16 * warp + g) * TQ + c + 1] = p[1];
      o[(16 * warp + g + 8) * TQ + c] = p[2];
      o[(16 * warp + g + 8) * TQ + c + 1] = p[3];
    }
  }
}

// The score tile of dtype T into st [TR][LD] (LD: LDO, or Tile<T>::ld).
template <typename T, int LD>
__device__ __forceinline__ void any_score_tile(const T* __restrict__ q,
                                               const T* __restrict__ shard, int Tn,
                                               int D, int valid_rows, int row0, int q0,
                                               float* smem, const typename Tile<T>::Maps& maps) {
  if constexpr (std::is_same<T, int8_t>::value) {
    score_tile_i8<false, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps,
                             __uint_as_float(INT8_INV_SCALE2_BITS));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    score_tile_bf16<LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps);
  } else {
    static_assert(LD == LDO, "the f32 tile writes st [TR][LDO]");
    score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
  }
}

// NaN. The float bodies' maxima propagate a NaN score, as the plain
// versions' amax and the JAX kernels' jnp.max do (topk_pallas.py:114, 189,
// 353-354, 425-452); fmaxf would drop it, leaving a unit or block that holds a
// NaN row a finite maximum, which no selection then ranks first. max_nan is
// the one such max: PTX max.NaN, one instruction like fmaxf, writes the
// canonical NaN 0x7FFFFFFF, the bits every NaN score on the card has already
// (the plain versions' cuBLAS product writes the same). A unit whose max is
// NaN has no attaining row: its argmax is `sub` (unit_arg), and its m2 the
// NaN max itself, as the plain `where(eq, iota, sub).amin()` gives. The int8
// unit pass takes max_nan too; its integer scores are never NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One step of a unit's argmax scan: a greater score names its row (strict:
// the lowest attaining row wins a tie); a NaN score makes the max NaN.
__device__ __forceinline__ void argmax_step(float v, int r, float& m1, int& arg) {
  if (v > m1) arg = r;
  m1 = max_nan(m1, v);
}

// The argmax of a finished scan: `sub` (no row) where the max is NaN.
__device__ __forceinline__ int unit_arg(float m1, int arg, int sub) {
  return m1 != m1 ? sub : arg;
}

// m2_sort_key + pack_m2_argmax_key (topk_pallas.py:267-304): m2's
// order-preserving uint image (-0.0 folded into +0.0) rounded UP to a
// multiple of 128, OR the sub-local argmax, sign bit flipped into int32.
__device__ __forceinline__ int32_t pack_key(float m2, int arg) {
  const float z = m2 == 0.0f ? 0.0f : m2;
  const uint32_t b = __float_as_uint(z);
  const uint32_t mono = z < 0.0f ? ~b : (b | 0x80000000u);
  const uint32_t key = ((mono + 0x7Fu) & 0xFFFFFF80u) | (uint32_t)arg;
  return (int32_t)(key ^ 0x80000000u);
}

// The int8 tiles' passes over st give each column's rows to 2^LG adjacent
// lanes, lane k taking rows k, k + 2^LG, ...: LG = ROW_SPLIT_LG (4 lanes,
// whose reads at LD = LDO_I8 fall in 32 distinct banks) where the pass has
// at most half a block of columns (K1's unit pass at sub 128: 128 columns
// for 288 threads), else 0 (one lane a column: more lanes would only add
// shuffles). LG is a template argument, so each split's loops compile to
// fixed strides. The lanes' results combine exactly (max is exact; the
// argmax combine below), so every output is the one-lane scan's bit for bit.
constexpr int ROW_SPLIT_LG = 2;

template <int NTH>
__device__ __forceinline__ bool split_rows(int columns) {
  return columns * 2 <= NTH;
}

// The max over rows r < rows of value(col, r) for every column c < TQ of
// `groups` row groups, handed to emit(g, c, max) once per (g, c): K5's block
// maxima and K10's raw key on int8 tiles. Every thread runs the same
// iterations, so the shuffles see whole warps.
template <int NTH, int LG, typename V, typename Value, typename Emit>
__device__ __forceinline__ void max_pass_lg(int groups, int rows, Value&& value, Emit&& emit) {
  constexpr int split = 1 << LG;
  const int n = (groups * TQ) << LG;
  for (int p0 = 0; p0 < n; p0 += NTH) {
    const int p = p0 + threadIdx.x, k = p & (split - 1), c = (p >> LG) % TQ;
    const bool live = p < n;
    const int g = live ? (p >> LG) / TQ : 0;
    V m = value(g, c, k);
    for (int r = k + split; r < rows; r += split) m = max(m, value(g, c, r));
#pragma unroll
    for (int off = 1; off < split; off <<= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (live && k == 0) emit(g, c, m);
  }
}

template <int NTH, typename V, typename Value, typename Emit>
__device__ __forceinline__ void max_pass(int groups, int rows, Value&& value, Emit&& emit) {
  if (split_rows<NTH>(groups * TQ))
    max_pass_lg<NTH, ROW_SPLIT_LG, V>(groups, rows, value, emit);
  else
    max_pass_lg<NTH, 0, V>(groups, rows, value, emit);
}

// The unit pass of K1 and K10 on an int8 tile: for each unit u < TR / sub
// and query column c, the unit max m1, its lowest attaining row a and m2, the
// max with that row replaced by PAD_SIM — kept on the way (a new max hands
// the old one to m2) and combined across the lanes (the higher max wins, the
// lower row on a tie; m2 becomes the max of the winner's m2 and the loser's
// max); emit(u, c, m1, a, m2) runs once per (u, c).
template <int NTH, int LD, int LG, typename Emit>
__device__ __forceinline__ void unit_pass_i8_lg(const float* st, int sub, Emit&& emit) {
  constexpr int split = 1 << LG;
  const int n = ((TR / sub) * TQ) << LG;
  for (int p0 = 0; p0 < n; p0 += NTH) {
    const int p = p0 + threadIdx.x, k = p & (split - 1), c = (p >> LG) % TQ;
    const bool live = p < n;
    const int u = live ? (p >> LG) / TQ : 0;
    const float* col = st + (size_t)u * sub * LD + c;
    float m1 = col[k * LD], m2 = PAD_SIM;
    int a = k;
    for (int r = k + split; r < sub; r += split) {
      const float v = col[r * LD];
      if (v > m1) {  // strict: lowest attaining row
        m2 = max_nan(m2, m1);
        m1 = v;
        a = r;
      } else {
        m2 = max_nan(m2, v);
      }
    }
#pragma unroll
    for (int off = 1; off < split; off <<= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, m1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, m2, off);
      const int oa = __shfl_xor_sync(0xffffffffu, a, off);
      if (o1 > m1 || (o1 == m1 && oa < a)) {
        m2 = max_nan(o2, m1);
        m1 = o1;
        a = oa;
      } else {
        m2 = max_nan(m2, o1);
      }
    }
    if (live && k == 0) emit(u, c, m1, a, m2);
  }
}

template <int NTH, int LD, typename Emit>
__device__ __forceinline__ void unit_pass_i8(const float* st, int sub, Emit&& emit) {
  if (split_rows<NTH>((TR / sub) * TQ))
    unit_pass_i8_lg<NTH, LD, ROW_SPLIT_LG>(st, sub, emit);
  else
    unit_pass_i8_lg<NTH, LD, 0>(st, sub, emit);
}

constexpr int MAX_UNITS = TR / 8;                                // sub >= 8

// Block b of the 1-D grid of K1/K3/K5/K10 takes query tile b % qt of row
// tile (group) b / qt, qt = ceil(Tn / TQ): the query tiles that share a row
// tile run side by side, so the store streams from device memory once (the
// row tiles ride in L2 between them). blockIdx.y could not hold the row tiles:
// its limit is 65,535 and a 10M-row store has 78,375 of them.
__device__ __forceinline__ int query_tiles(int Tn) { return (Tn + TQ - 1) / TQ; }

// The 1-D grid of K1/K3/K5/K10: `groups` row tiles (K10: row tile groups)
// times the query tiles, or 0 when that exceeds a 1-D grid.
inline unsigned tile_grid(long long groups, int Tn) {
  const long long nb = groups * ((Tn + TQ - 1) / TQ);
  return nb > 0x7fffffffLL ? 0u : (unsigned)nb;
}

// K1: sub-unit maxima, optional packed (second max, argmax) key, optional
// coarse maxima at emit width ew <= TR (wider ones: K10's row-tile walk,
// see launch_k1); scores never leave shared memory.
// Outputs are transposed like the TPU kernel's: [R/sub, T], [R/ew, T].
template <typename T>
__global__ void __launch_bounds__(Tile<T>::threads, Tile<T>::min_blocks)
k1_blockmax2(const T* __restrict__ q, const T* __restrict__ shard, int Tn,
             int D, int valid_rows, int sub, int ew, float* __restrict__ bm_sub,
             int32_t* __restrict__ key, float* __restrict__ bm,
             const __grid_constant__ typename Tile<T>::Maps maps) {
  constexpr int NTH = Tile<T>::threads, LD = Tile<T>::ld;
  extern __shared__ float4 smem4[];
  float* smem = Tile<T>::base(smem4);
  const int qt = query_tiles(Tn);
  const int row0 = (blockIdx.x / qt) * TR, q0 = (blockIdx.x % qt) * TQ;
  any_score_tile<T, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps);
  const float* st = smem;
  float* um = smem + TR * LD;  // [MAX_UNITS][TQ] unit maxima
  const int units = TR / sub;
  if constexpr (std::is_same<T, int8_t>::value) {
    unit_pass_i8<NTH, LD>(st, sub, [&](int u, int c, float m1, int a, float s2) {
      um[u * TQ + c] = m1;
      if (q0 + c >= Tn) return;
      const size_t o = (size_t)(row0 / sub + u) * Tn + q0 + c;
      bm_sub[o] = m1;
      if (key != nullptr) key[o] = pack_key(s2, a);
    });
  } else {
    for (int p = threadIdx.x; p < units * TQ; p += NTH) {
      const int u = p / TQ, c = p % TQ;
      const float* col = st + (size_t)u * sub * LD + c;
      float m1 = col[0];
      int arg = 0;
      for (int r = 1; r < sub; ++r) argmax_step(col[r * LD], r, m1, arg);
      arg = unit_arg(m1, arg, sub);
      um[u * TQ + c] = m1;
      if (q0 + c >= Tn) continue;
      const size_t o = (size_t)(row0 / sub + u) * Tn + q0 + c;
      bm_sub[o] = m1;
      if (key != nullptr) {
        // second max: the max with the argmax ROW replaced by PAD_SIM
        float m2 = __uint_as_float(0xff800000u);  // -inf
        for (int r = 0; r < sub; ++r) m2 = max_nan(m2, r == arg ? PAD_SIM : col[r * LD]);
        key[o] = pack_key(m2, arg);
      }
    }
  }
  if (bm == nullptr) return;
  __syncthreads();
  const int groups = TR / ew, per = ew / sub;
  for (int p = threadIdx.x; p < groups * TQ; p += NTH) {
    const int g = p / TQ, c = p % TQ;
    if (q0 + c >= Tn) continue;
    float m = um[(g * per) * TQ + c];
    for (int u = 1; u < per; ++u) m = max_nan(m, um[(g * per + u) * TQ + c]);
    bm[(size_t)(row0 / ew + g) * Tn + q0 + c] = m;
  }
}

// The per-block maxima of a score tile st [TR][LD] (rows [row0, row0 + TR),
// queries [q0, q0 + TQ)): block group g of query column c goes to
// out[(row0 / block + g) * g_stride + (q0 + c) * q_stride]; queries at or past
// Tn are skipped. The block reduction of K5 and K12, and K3's loop written
// out (calling this cost K3 1.5 % on the card), so their maxima agree bit
// for bit. NTH: the block's threads; SPLIT_ROWS (int8 tiles) may split each
// column's rows over lanes (max_pass).
template <int NTH = NT, int LD = LDO, bool SPLIT_ROWS = false>
__device__ __forceinline__ void store_block_max(const float* st, int block, int Tn,
                                                int row0, int q0, float* __restrict__ out,
                                                size_t g_stride, size_t q_stride) {
  const int groups = TR / block;
  if constexpr (SPLIT_ROWS) {
    max_pass<NTH, float>(
        groups, block,
        [&](int g, int c, int r) { return st[((size_t)g * block + r) * LD + c]; },
        [&](int g, int c, float m) {
          if (q0 + c < Tn)
            out[(size_t)(row0 / block + g) * g_stride + (size_t)(q0 + c) * q_stride] = m;
        });
  } else {
    for (int p = threadIdx.x; p < groups * TQ; p += NTH) {
      const int g = p / TQ, c = p % TQ;
      if (q0 + c >= Tn) continue;
      const float* col = st + (size_t)g * block * LD + c;
      float m = col[0];
      for (int r = 1; r < block; ++r) m = max_nan(m, col[r * LD]);
      out[(size_t)(row0 / block + g) * g_stride + (size_t)(q0 + c) * q_stride] = m;
    }
  }
}

// K3: masked scores sims [T, R] plus per-block maxima bm_t [R/block, T]. Its
// st keeps the odd LDO on every dtype: the transposed read below needs it.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::threads, Tile<T>::min_blocks)
k3_blockmax(const T* __restrict__ q, const T* __restrict__ shard, int Tn, int R,
            int D, int valid_rows, int block, float* __restrict__ sims,
            float* __restrict__ bm_t, const __grid_constant__ typename Tile<T>::Maps maps) {
  constexpr int NTH = Tile<T>::threads;
  extern __shared__ float4 smem4[];
  float* smem = Tile<T>::base(smem4);
  const int qt = query_tiles(Tn);
  const int row0 = (blockIdx.x / qt) * TR, q0 = (blockIdx.x % qt) * TQ;
  any_score_tile<T, LDO>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps);
  const float* st = smem;
  // consecutive threads -> consecutive rows of one query: coalesced stores
  for (int e = threadIdx.x; e < TR * TQ; e += NTH) {
    const int c = e / TR, r = e % TR;
    if (q0 + c < Tn) sims[(size_t)(q0 + c) * R + row0 + r] = st[r * LDO + c];
  }
  const int groups = TR / block;
  for (int p = threadIdx.x; p < groups * TQ; p += NTH) {
    const int g = p / TQ, c = p % TQ;
    if (q0 + c >= Tn) continue;
    const float* col = st + (size_t)g * block * LDO + c;
    float m = col[0];
    for (int r = 1; r < block; ++r) m = max_nan(m, col[r * LDO]);
    bm_t[(size_t)(row0 / block + g) * Tn + q0 + c] = m;
  }
}

// K5: K3's per-block maxima bm_t [R/block, T] alone; the score tile never
// leaves shared memory. Replaces matmul_blockmax_only (topk_pallas.py:222,
// body :178), whose Mosaic row tile (pick_bm_row_tile) has no counterpart:
// the tile is K3's TR x TQ. Bound on the card: the 2*T*R*D operations of the
// product (the store is read once, the output is R/block x T floats), on the
// tensor cores for bf16 and int8 (K1/K3's score tile), the SIMT pipes for
// f32. A kernel of its own rather than a
// flag on K3, so every pointer stays __restrict__ (a shared body cost K2 9 %).
template <typename T>
__global__ void __launch_bounds__(Tile<T>::threads, Tile<T>::min_blocks)
k5_blockmax_only(const T* __restrict__ q, const T* __restrict__ shard, int Tn,
                 int D, int valid_rows, int block, float* __restrict__ bm_t,
                 const __grid_constant__ typename Tile<T>::Maps maps) {
  constexpr int LD = Tile<T>::ld;
  extern __shared__ float4 smem4[];
  float* smem = Tile<T>::base(smem4);
  const int qt = query_tiles(Tn);
  const int row0 = (blockIdx.x / qt) * TR, q0 = (blockIdx.x % qt) * TQ;
  any_score_tile<T, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps);
  store_block_max<Tile<T>::threads, LD, std::is_same<T, int8_t>::value>(
      smem, block, Tn, row0, q0, bm_t, Tn, 1);
}

// K10: the block-max prototypes of the TPU measurement record
// (scripts/proto_bm3.py bm2_v3, proto_bm2.py bm2_b, proto_bmt.py bm2t_pass,
// proto_argmax.py bm2x, proto_emit_var.py's k1only fn, proto_int8.py
// bm2t_i8), and K1 at emit widths above TR: K1's score tile, unit maxima
// always, every other output optional —
//   sims    [R, T]   masked scores (the transpose of K3's [T, R]);
//   bms     [R/sub, T], or [T, R/sub] with t_major (as arg, m2, key, raw_key);
//   arg     int32, the lowest row attaining the unit max (K1's key & 0x7F);
//   m2      f32, the max with that row replaced by PAD_SIM (K1's m2);
//   key     int32, (m2, arg) packed as K1 packs them (pack_key);
//   raw_key int32, int8 only: max over the unit of acc * 128 + (127 - row),
//           acc the exact dot (PAD_ACC on masked rows) — kept as integers in
//           the tile (score_tile_i8<true>), never recovered from floats;
//   bm      [R/ew, T] coarse maxima; `tiles` > 1 row tiles per block when
//           ew > TR, a running max per query in a register.
// int8 scores are __fmul_rn(float(acc), inv_scale2) — K1's int8_score when
// inv_scale2 is INT8_INV_SCALE2 — so every pass reads f32 scores as K1's
// does, and shared outputs equal K1's bit for bit; with raw_key the tile
// holds the exact dots first, the key is taken from them, then each becomes
// its score in place. int8's passes split rows over lanes as K1's.
// Bound on the card: the 2*T*R*D operations (bf16 and int8 on the tensor
// cores, K1's score tile); with sims, also its R*T*4 bytes. A kernel of its
// own, so K1's body is untouched.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::threads, Tile<T>::min_blocks)
k10_blockmax2x(const T* __restrict__ q, const T* __restrict__ shard, int Tn, int R,
               int D, int valid_rows, int sub, int ew, int tiles, int t_major,
               float inv_scale2, float* __restrict__ sims, float* __restrict__ bms,
               int32_t* __restrict__ arg, float* __restrict__ m2,
               int32_t* __restrict__ key, int32_t* __restrict__ raw_key,
               float* __restrict__ bm, const __grid_constant__ typename Tile<T>::Maps maps) {
  constexpr int NTH = Tile<T>::threads, LD = Tile<T>::ld;
  extern __shared__ float4 smem4[];
  float* smem = Tile<T>::base(smem4);
  const float* st = smem;
  float* um = smem + TR * LD;  // [MAX_UNITS][TQ] unit maxima
  const int qt = query_tiles(Tn), rg = blockIdx.x / qt;  // rg: this block's row tile group
  const int q0 = (blockIdx.x % qt) * TQ, units = TR / sub, n_units = R / sub;
  // offset of (global unit gu, query column c) in a unit output
  auto at = [&](int gu, int c) -> size_t {
    return t_major ? (size_t)(q0 + c) * n_units + gu : (size_t)gu * Tn + q0 + c;
  };
  float cmax = __uint_as_float(0xff800000u);  // -inf; tiles > 1 only
  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = (rg * tiles + tile) * TR;
    if constexpr (std::is_same<T, int8_t>::value) {
      if (raw_key == nullptr) {
        score_tile_i8<false, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps, inv_scale2);
      } else {
        score_tile_i8<true, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps, inv_scale2);
        const int* ist = reinterpret_cast<const int*>(smem);
        max_pass<NTH, int>(
            units, sub,
            [&](int u, int c, int r) { return ist[(u * sub + r) * LD + c] * 128 + (127 - r); },
            [&](int u, int c, int k) {
              if (q0 + c < Tn) raw_key[at(row0 / sub + u, c)] = k;
            });
        __syncthreads();
        for (int e = threadIdx.x; e < TR * TQ; e += NTH) {
          const int i = (e / TQ) * LD + e % TQ, a = ist[i];
          smem[i] = a == PAD_ACC ? PAD_SIM : int8_score(a, inv_scale2);
        }
        __syncthreads();
      }
    } else {
      any_score_tile<T, LD>(q, shard, Tn, D, valid_rows, row0, q0, smem, maps);
    }
    if (sims != nullptr) {
      // consecutive threads -> consecutive queries of one row: coalesced
      for (int e = threadIdx.x; e < TR * TQ; e += NTH) {
        const int r = e / TQ, c = e % TQ;
        if (q0 + c < Tn) sims[(size_t)(row0 + r) * Tn + q0 + c] = st[r * LD + c];
      }
    }
    auto emit = [&](int u, int c, float m1, int a, float s2) {
      um[u * TQ + c] = m1;
      if (q0 + c >= Tn) return;
      const size_t o = at(row0 / sub + u, c);
      bms[o] = m1;
      if (arg != nullptr) arg[o] = a;
      if (m2 != nullptr) m2[o] = s2;
      if (key != nullptr) key[o] = pack_key(s2, a);
    };
    if constexpr (std::is_same<T, int8_t>::value) {
      unit_pass_i8<NTH, LD>(st, sub, emit);
    } else {
      for (int p = threadIdx.x; p < units * TQ; p += NTH) {
        const int u = p / TQ, c = p % TQ;
        const float* col = st + (size_t)u * sub * LD + c;
        float m1 = col[0];
        int a = 0;
        for (int r = 1; r < sub; ++r) argmax_step(col[r * LD], r, m1, a);
        a = unit_arg(m1, a, sub);
        um[u * TQ + c] = m1;
        if (q0 + c >= Tn) continue;
        const size_t o = at(row0 / sub + u, c);
        bms[o] = m1;
        if (arg != nullptr) arg[o] = a;
        if (m2 != nullptr || key != nullptr) {
          float s2 = __uint_as_float(0xff800000u);  // -inf
          for (int r = 0; r < sub; ++r) s2 = max_nan(s2, r == a ? PAD_SIM : col[r * LD]);
          if (m2 != nullptr) m2[o] = s2;
          if (key != nullptr) key[o] = pack_key(s2, a);
        }
      }
    }
    if (bm != nullptr) {
      __syncthreads();
      if (tiles == 1) {
        const int groups = TR / ew, per = ew / sub;
        for (int p = threadIdx.x; p < groups * TQ; p += NTH) {
          const int g = p / TQ, c = p % TQ;
          if (q0 + c >= Tn) continue;
          float m = um[(g * per) * TQ + c];
          for (int u = 1; u < per; ++u) m = max_nan(m, um[(g * per + u) * TQ + c]);
          bm[(size_t)(row0 / ew + g) * Tn + q0 + c] = m;
        }
      } else if (threadIdx.x < TQ) {
        for (int u = 0; u < units; ++u) cmax = max_nan(cmax, um[u * TQ + threadIdx.x]);
      }
    }
    if (tiles > 1) __syncthreads();  // the next tile's staging overwrites st
  }
  if (bm != nullptr && tiles > 1 && threadIdx.x < TQ && q0 + threadIdx.x < Tn)
    bm[(size_t)rg * Tn + q0 + threadIdx.x] = cmax;
}

// ---- K2 and K6: one gather-and-score mainloop ----
//
// A block scores query t = blockIdx.y against G_TILE of its C candidate
// rows, s0 = blockIdx.x * G_TILE .. s0 + G_TILE - 1. K2 and K6 differ only
// in where candidate row s lies (row_of): K6 reads gathered[t, s]; K2 reads
// store row ids[t, s / unit] * unit + s % unit, and an id outside [0, R /
// unit) gives no row (nothing is read; its score is NaN). Bound: the
// candidate rows' bytes, read once, far above the time of their 2 * D
// operations a row. So the loop keeps loads in flight: D goes through
// shared memory in slabs of G_SB bytes of every candidate row and of the
// query, row-major as the rows lie in device memory (each padded to G_PITCH
// bytes), in a ring of G_STAGES slabs filled by cp.async.cg, consecutive
// threads on consecutive 16-byte pieces of one row, each piece asking L2 for
// the aligned 256 bytes around it (the row's next slab: DRAM then serves
// 256-byte runs, not 128). The next G_STAGES - 1 slabs are in flight while
// the block scores this one, behind one barrier a slab, and G_MIN_BLOCKS
// blocks share an SM. Where a row's bytes (D * itemsize) are not a multiple
// of 16 or a base is not 16-byte aligned, 4-byte cp.async pieces fill the
// same slabs (where both are multiples of 4), else the threads copy bytes
// themselves. Past D, past C and for a row that does not exist the slab
// holds zeros. Each dtype then takes the slab by its rule (see the header):
//  * f32: thread r owns row r's score and advances it over the slab's
//    features in order, 4 at a time (one 16-byte shared load of the row and
//    one of the query, fma_features); the chain runs over D rounded up to
//    the G_SB / 4 = 32 features of a slab, as every earlier K2/K6 ran it;
//  * bf16: warp w multiplies rows 32w .. 32w + 31 as two m16 tiles in
//    the score tile's k order: A fragments by ldmatrix straight
//    from the slab, the query in every column of B (so every column of the
//    result is the score), mma_k16 from +0.0 per k16 step, no step wholly
//    past D;
//  * int8: thread r owns row r's int32 dot and advances it by __dp4a over
//    the slab's 4-byte packs (exact in any order), then one int8_score.
// G_PITCH = 16 (mod 128): the 16-byte pieces of 8 consecutive slab rows at
// one offset fall in 8 distinct groups of 4 banks, so the copies' shared
// writes (8 pieces of one row a quarter warp), the f32/int8 row loads (8 rows
// a quarter warp; the query's load is one broadcast) and each ldmatrix (8
// rows a matrix) are free of bank conflicts. On the card the 256-byte
// prefetch takes ~7 % off every case; 64 or 32 rows a block, a 4-slab ring
// at 3 blocks an SM, wider slabs at fewer rows or blocks, and bulk L2
// prefetches of each row's slabs further ahead time alike or lose
// (bench/ab_topk.py's @g_* variants; PERF.md).
constexpr size_t G_SMEM = (size_t)G_STAGES * G_STAGE_BYTES + sizeof(void*) * G_ROWS;

template <typename T, typename RowOf>
__device__ __forceinline__ void gather_scores(const T* __restrict__ q,
                                              const T* __restrict__ base, int C, int D,
                                              RowOf row_of, float* __restrict__ out) {
  constexpr int F = G_SB / (int)sizeof(T);  // features of one slab row
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);  // G_STAGES x [G_ROWS][G_PITCH]
  // src[r]: candidate row s0 + r (nullptr: none); src[G_TILE]: the query
  const uint8_t** src = reinterpret_cast<const uint8_t**>(ring + G_STAGES * G_STAGE_BYTES);
  const int t = blockIdx.y, s0 = blockIdx.x * G_TILE, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row_bytes = D * (int)sizeof(T), slabs = (row_bytes + G_SB - 1) / G_SB;
  const uint8_t* q_row = reinterpret_cast<const uint8_t*>(q + (size_t)t * D);
  src[tid] = s0 + tid < C ? reinterpret_cast<const uint8_t*>(row_of(s0 + tid)) : nullptr;
  if (tid == 0) src[G_TILE] = q_row;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(base);
  const int width = (row_bytes % 16 == 0 && (bases & 15) == 0) ? 16
                    : (row_bytes % 4 == 0 && (bases & 3) == 0) ? 4 : 1;
  __syncthreads();

  // Slab s into its slot; a copy that reads nothing keeps a source address
  // inside the query's row.
  auto stage = [&](int s) {
    uint8_t* st = ring + (s % G_STAGES) * G_STAGE_BYTES;
    const int b0 = s * G_SB;
    if (width == 16) {
      for (int e = tid; e < G_ROWS * (G_SB / 16); e += G_TILE) {
        const int r = e / (G_SB / 16), b = 16 * (e % (G_SB / 16));
        const uint8_t* p = src[r];
        const bool in = p != nullptr && b0 + b < row_bytes;  // whole pieces
        cp_async16_l2_or_zero(st + r * G_PITCH + b, in ? p + b0 + b : q_row, in);
      }
    } else if (width == 4) {
      for (int e = tid; e < G_ROWS * (G_SB / 4); e += G_TILE) {
        const int r = e / (G_SB / 4), b = 4 * (e % (G_SB / 4));
        const uint8_t* p = src[r];
        const bool in = p != nullptr && b0 + b < row_bytes;
        cp_async4_or_zero(st + r * G_PITCH + b, in ? p + b0 + b : q_row, in);
      }
    } else {
      for (int e = tid; e < G_ROWS * G_SB; e += G_TILE) {
        const int r = e / G_SB, b = e % G_SB;
        const uint8_t* p = src[r];
        st[r * G_PITCH + b] = (p != nullptr && b0 + b < row_bytes) ? p[b0 + b] : 0;
      }
    }
  };

  float facc[1][1] = {{0.0f}};  // f32: row tid's chain
  int iacc = 0;                 // int8: row tid's dot
  float macc[2][4] = {};        // bf16: this warp's rows, two m16 tiles
  // ldmatrix row addresses of this lane: rows
  // G_WARP_ROWS * warp + (lane & 15), features +8 for lanes 16-31
  const int a_off = (G_WARP_ROWS * warp + (lane & 15)) * G_PITCH + ((lane >> 4) << 4);
#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < slabs) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<G_STAGES - 2>();  // this thread's copies of slab s have landed
    __syncthreads();  // ... and every thread's; every warp is done with slab s - 1
    if (s + G_STAGES - 1 < slabs) stage(s + G_STAGES - 1);  // into slab s - 1's slot
    cp_async_commit();
    const uint8_t* st = ring + (s % G_STAGES) * G_STAGE_BYTES;
    const uint8_t* qs = st + G_TILE * G_PITCH;
    if constexpr (std::is_same<T, float>::value) {
      const float4* rs = reinterpret_cast<const float4*>(st + tid * G_PITCH);
#pragma unroll
      for (int g = 0; g < G_SB / 16; ++g) {
        const float4 a = rs[g], b = reinterpret_cast<const float4*>(qs)[g];
        const float rv[1][4] = {{a.x, a.y, a.z, a.w}}, qv[1][4] = {{b.x, b.y, b.z, b.w}};
        fma_features<1, 1, 4>(facc, rv, qv);
      }
    } else if constexpr (std::is_same<T, int8_t>::value) {
      const int4* rs = reinterpret_cast<const int4*>(st + tid * G_PITCH);
#pragma unroll
      for (int g = 0; g < G_SB / 16; ++g) {
        const int4 a = rs[g], b = reinterpret_cast<const int4*>(qs)[g];
        iacc = __dp4a(a.x, b.x, iacc);
        iacc = __dp4a(a.y, b.y, iacc);
        iacc = __dp4a(a.z, b.z, iacc);
        iacc = __dp4a(a.w, b.w, iacc);
      }
    } else {
      const int t4 = lane & 3;
#pragma unroll
      for (int kk = 0; kk < F; kk += 16) {
        if (s * F + kk >= D) break;  // no step wholly past D
        // B: features kk + 2 t4, +1 and kk + 2 t4 + 8, +9 of the query, in
        // every column
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(qs + 2 * (kk + 2 * t4)),
                               *reinterpret_cast<const uint32_t*>(qs + 2 * (kk + 2 * t4 + 8))};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, reinterpret_cast<const __nv_bfloat16*>(st + a_off + m * 16 * G_PITCH +
                                                                2 * kk));
          mma_k16(macc[m], a, b);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

  const float nan = __uint_as_float(0x7fffffffu);
  float* o = out + (size_t)t * C + s0;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if ((lane & 3) == 0) {  // column 0: rows lane / 4 and lane / 4 + 8 of each tile
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = G_WARP_ROWS * warp + 16 * m + (lane >> 2) + 8 * h;
          if (s0 + r < C) o[r] = src[r] != nullptr ? macc[m][2 * h] : nan;
        }
    }
  } else if (s0 + tid < C) {
    float score;
    if constexpr (std::is_same<T, int8_t>::value)
      score = int8_score(iacc);
    else
      score = facc[0][0];
    o[tid] = src[tid] != nullptr ? score : nan;
  }
}

// K2: query t's KS selected unit-row blocks (ids [T, KS]) rescored by the
// dtype's rule (gather_scores); C = KS * unit candidate rows.
template <typename T>
__global__ void __launch_bounds__(G_TILE, G_MIN_BLOCKS)
k2_gather_rescore(const T* __restrict__ q, const T* __restrict__ shard,
                  const int32_t* __restrict__ ids, int R, int D, int KS, int unit,
                  float* __restrict__ out) {
  const int32_t* my_ids = ids + (size_t)blockIdx.y * KS;
  const int n_units = R / unit;
  gather_scores<T>(q, shard, KS * unit, D, [=](int s) -> const T* {
    const int uid = my_ids[s / unit];
    return uid >= 0 && uid < n_units ? shard + ((size_t)uid * unit + s % unit) * D : nullptr;
  }, out);
}

// K6: query t against its own C pre-gathered rows (gathered [T, C, D]).
// Replaces block_scores (topk_pallas.py:846, body :828), whose keep-row-r
// Mosaic dots existed to pin the scoring pass's arithmetic. Here the blocks,
// the slabs and the product are K2's (gather_scores), row s of query t being
// gathered[t, s] instead of a store row, so K6 == K2 == K3 bit for bit.
template <typename T>
__global__ void __launch_bounds__(G_TILE, G_MIN_BLOCKS)
k6_block_scores(const T* __restrict__ q, const T* __restrict__ gathered, int C, int D,
                float* __restrict__ out) {
  const T* rows = gathered + (size_t)blockIdx.y * C * D;
  gather_scores<T>(q, gathered, C, D, [=](int s) -> const T* { return rows + (size_t)s * D; },
                   out);
}

// K4: pure data movement, replacing gather_rows (topk_pallas.py:747, body
// :736; the TPU's cpg DMA grouping and T % 8 / sublane rules are Mosaic's
// and have no counterpart). A unit is `unit` consecutive store rows, so each
// (query t, selected unit j) is one contiguous run of `chunk` bytes, copied
// by block (j, t) whatever the dtype: 16-byte vector loads and stores where
// both ends are 16-byte aligned, single bytes for a tail (or for the whole
// run otherwise). An id outside [0, n_units) writes 0xFF bytes (NaN on float
// stores) and reads nothing past the store. Bound: the bytes, read once and
// written once.
constexpr int CT = 256;

__global__ void __launch_bounds__(CT)
k4_gather_rows(const uint8_t* __restrict__ shard, const int32_t* __restrict__ ids,
               int KS, int n_units, size_t chunk, uint8_t* __restrict__ out) {
  const int j = blockIdx.x, t = blockIdx.y;
  const int uid = ids[(size_t)t * KS + j];
  const bool ok = uid >= 0 && uid < n_units;
  const uint8_t* src = shard + (size_t)(ok ? uid : 0) * chunk;  // in bounds either way
  uint8_t* dst = out + ((size_t)t * KS + j) * chunk;
  size_t head = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const size_t n16 = chunk / 16;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4 fill = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll 4
    for (size_t i = threadIdx.x; i < n16; i += CT) d4[i] = ok ? s4[i] : fill;
    head = n16 * 16;
  }
  for (size_t i = head + threadIdx.x; i < chunk; i += CT) dst[i] = ok ? src[i] : 0xFF;
}

// K11: the copy-only gather of P19's V0 (scripts/proto_dma2.py make_v01 with
// _v0_kernel, :72 and :52): out[t, j * 128 + c] = f32(store[ids[t, j] * unit, c])
// for c < 128. The TPU kernel DMAs each selected unit x D block whole into
// VMEM and keeps 128 values of its row 0, so its time is the cost of moving
// the candidates. Here block (j, t) moves unit ids[t, j] (unit_bytes
// contiguous bytes) whole from HBM into shared memory with cp.async, 16 bytes
// a thread (.cg: through L2, not L1), CP_CHUNK bytes at a time, and writes
// the 128 values of row 0 from the first chunk. Each copy is an asm volatile
// with a "memory" clobber, so the compiler keeps every one of them although
// only row 0 is read back (chip_smoke.py also fails if K11 runs below its
// bytes bound). Several 32 KB CTAs per SM keep ~200 KB of loads in flight
// there. An id outside [0, n_units) writes NaN and reads nothing. Bound: the
// bytes of the distinct units selected (read once) and of the output.
constexpr int CP_THREADS = 256;
constexpr int CP_CHUNK = 32 * 1024;
constexpr int V0_COLS = 128;

__global__ void __launch_bounds__(CP_THREADS)
k11_gather_copy(const uint8_t* __restrict__ shard, const int32_t* __restrict__ ids, int KS,
                int n_units, int unit_bytes, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  uint8_t* buf = reinterpret_cast<uint8_t*>(smem4);
  const int j = blockIdx.x, t = blockIdx.y;
  const int uid = ids[(size_t)t * KS + j];
  float* dst = out + ((size_t)t * KS + j) * V0_COLS;
  if (uid < 0 || uid >= n_units) {
    if (threadIdx.x < V0_COLS) dst[threadIdx.x] = __uint_as_float(0x7fffffffu);
    return;
  }
  const uint8_t* src = shard + (size_t)uid * unit_bytes;
  for (int off = 0; off < unit_bytes; off += CP_CHUNK) {
    const int n = min(CP_CHUNK, unit_bytes - off);
    for (int i = threadIdx.x * 16; i < n; i += CP_THREADS * 16) cp_async16(buf + i, src + off + i);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (off == 0 && threadIdx.x < V0_COLS)
      dst[threadIdx.x] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(buf)[threadIdx.x]);
    __syncthreads();  // the next chunk overwrites buf
  }
}

// K12: P21, the gather-rescore with a resident product (scripts/proto_dma3.py
// make_fused, :80; body :57), in one launch. Two kinds of work share the
// grid, so the gather's loads and the product's arithmetic run side by side
// on the SMs:
//  * gather items: query t's candidate slots [s0, s0 + NT) of C = KS * unit
//    (ids [T, KS] into unit-row blocks), staged GDK features at a time by
//    all the block's threads, widened and multiplied by mma_staged in K2's
//    k16 steps, NT / 32 warps of 32 slots (a block's further warps take
//    part in the staging and the barriers only), so the scores equal K2's
//    bit for bit (the bf16 rule of the header); NaN for an id outside [0,
//    R/unit);
//  * product items: `copies` copies of K5's score tiles of mmq [tq, D]
//    against mms [mm_rows, D] (score_tile_bf16, K5's tile and its TMA
//    maps), each copy's 128-row block maxima stored to mmo [tq, mm_rows /
//    128] by store_block_max: K5's bm_t transposed, bit for bit. Every copy
//    writes the same values to the same places. Identical floats stored by
//    several CTAs are benign, and storing every copy's maxima, under no
//    condition of its own, keeps the compiler from dropping any copy's
//    arithmetic.
// The TPU kernel recomputes the product in each of its (T/8)·(KS/cpg) grid
// steps; the wrapper passes that count as `copies` (0: no product, mmo is not
// written). CTA b runs product item b (if b < n_product) and gather items
// [b·G/n, (b+1)·G/n) of G, n = gridDim.x, so the gather is spread evenly over
// the launch. With product items a block is the bf16 score tile's
// (Tile<__nv_bfloat16>: its threads and shared memory); without, NT threads,
// 2 blocks an SM. Bound on the card: the
// 2·copies·tq·mm_rows·D operations of the copies (on the tensor cores: K5's
// bf16 score tile) while copies > 0, else the gathered bytes (read once), as
// K2.
constexpr int MLD = NT + 4;
constexpr size_t K12_GATHER_SMEM = sizeof(float) * (GDK * MLD + GDK);
static_assert(K12_GATHER_SMEM <= Tile<__nv_bfloat16>::smem(0),
              "one buffer serves both kinds of item");

template <typename T, int NTH>
__device__ __forceinline__ void k12_gather_item(const T* __restrict__ q,
                                                const T* __restrict__ shard,
                                                const int32_t* __restrict__ ids, int R,
                                                int D, int KS, int unit, int item,
                                                float* __restrict__ out, float* smem) {
  static_assert(NTH >= NT, "a slot for each of NT threads");
  float* rs = smem;              // [GDK][MLD]
  float* qs = smem + GDK * MLD;  // [GDK]
  const int C = KS * unit, per_q = (C + NT - 1) / NT, n_units = R / unit;
  const int t = item / per_q, s0 = (item % per_q) * NT, tid = threadIdx.x;
  const int32_t* my_ids = ids + (size_t)t * KS;
  float macc[2][4] = {};  // this warp's slots (tid & ~31) + 0 .. 31
  for (int d0 = 0; d0 < D; d0 += GDK) {
    for (int e = tid; e < NT * GDK; e += NTH) {
      const int r = e / GDK, dd = e % GDK, gd = d0 + dd, s = s0 + r;
      float v = 0.0f;
      if (s < C && gd < D) {
        const int uid = my_ids[s / unit];
        if (uid >= 0 && uid < n_units)
          v = widen(shard[((size_t)uid * unit + s % unit) * D + gd]);
      }
      rs[dd * MLD + r] = v;
    }
    if (tid < GDK) qs[tid] = d0 + tid < D ? widen(q[(size_t)t * D + d0 + tid]) : 0.0f;
    __syncthreads();
    if (tid < NT) mma_staged<2>(macc, rs, MLD, tid & ~31, qs, 1, 1, d0, GDK, D);
    __syncthreads();
  }
  if (tid < NT) store_staged<2>(macc, tid & ~31, 1, rs, NT);
  __syncthreads();
  const float score = tid < NT ? rs[tid] : 0.0f;
  __syncthreads();  // the next item restages rs
  const int s = s0 + tid;
  if (tid < NT && s < C) {
    const int uid = my_ids[s / unit];
    out[(size_t)t * C + s] = (uid >= 0 && uid < n_units) ? score : __uint_as_float(0x7fffffffu);
  }
}

// PRODUCT: the launch has product items, so its blocks are the score
// tile's; without, NT threads at 2 blocks an SM, as K2's gather.
template <typename T, bool PRODUCT>
__global__ void __launch_bounds__(PRODUCT ? Tile<T>::threads : NT,
                                  PRODUCT ? Tile<T>::min_blocks : 2)
k12_gather_rescore_mm(const T* __restrict__ q, const T* __restrict__ shard,
                      const int32_t* __restrict__ ids, int R, int D, int KS, int unit,
                      int n_gather, const T* __restrict__ mmq, const T* __restrict__ mms,
                      int tq, int mm_rows, int n_product, float* __restrict__ out,
                      float* __restrict__ mmo,
                      const __grid_constant__ typename Tile<T>::Maps maps) {
  constexpr int NTH = PRODUCT ? Tile<T>::threads : NT, LD = Tile<T>::ld;
  extern __shared__ float4 smem4[];
  // without a product the block holds the gather's buffer alone (no tile pad)
  float* smem = PRODUCT ? Tile<T>::base(smem4) : reinterpret_cast<float*>(smem4);
  const long long b = blockIdx.x, nb = gridDim.x;
  if constexpr (PRODUCT) {
    if (b < n_product) {
      const int row_tiles = mm_rows / TR;
      const int tile = (int)(b % ((long long)row_tiles * ((tq + TQ - 1) / TQ)));  // of copy b / tiles
      const int row0 = (tile % row_tiles) * TR, q0 = (tile / row_tiles) * TQ;
      any_score_tile<T, LD>(mmq, mms, tq, D, mm_rows, row0, q0, smem, maps);
      store_block_max<NTH, LD>(smem, TR, tq, row0, q0, mmo, 1, row_tiles);
      __syncthreads();  // the gather items restage smem
    }
  }
  const int lo = (int)(b * n_gather / nb), hi = (int)((b + 1) * n_gather / nb);
  for (int item = lo; item < hi; ++item)
    k12_gather_item<T, NTH>(q, shard, ids, R, D, KS, unit, item, out, smem);
}

// K13: P17's fused cross scores (scripts/proto_fused.py fused_scores, :139;
// body :119). Queries come in groups of XQ = 8; step j of group i takes the
// G slots j*G .. j*G+G-1 of each of the group's 8 queries (ids [T, k],
// unit-row sub-block ids), C = 8*G*unit candidate rows in the TPU kernel's
// order c = (g*8 + r)*unit + s (slot g, query r of the group, row s of the
// unit), and scores ALL 8 queries against every one of them:
//   out[j, 8i + a, c] = dot(q[8i + a], store row ids[8i + r, j*G + g]*unit + s)
// in the G layout [k/G, T, C] directly. Keeping a == r gives K2's scores at
// this unit (extract_diag in bench/proto_fused.py). Block (x, j, i) covers
// candidates [x*GR, x*GR + GR) of step j of group i: one candidate row per
// thread, staged GDK features at a time, widened, against the group's 8
// queries staged beside it as B's 8 columns, multiplied by mma_staged, which
// gives each (row, query) pair K2's bits (the same rows in A, the same k
// steps; K2 has its one query in every column, and no element of an mma
// result depends on another column): the diagonal is K2's bit for
// bit. Each candidate row is read once per group, not once per
// query as K2 at 8x ids would read it: that traffic is what the prototype
// measures. An id outside [0, R/unit) scores NaN for all 8 queries. bf16
// operands only (the prototype's). Bound on the card: the bytes of the
// distinct sub-blocks selected (read once) and of the output, far above the
// time of the 2*8*T*k*unit*D FLOPs at the bf16 tensor peak.
constexpr int XQ = 8;

__global__ void __launch_bounds__(GR)
k13_gather_cross(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ shard,
                 const int32_t* __restrict__ ids, int Tn, int R, int D, int k, int unit,
                 int G, float* __restrict__ out) {
  __shared__ float rs[GDK * GLD];
  __shared__ float qs[GDK * XQ];
  __shared__ int row_of[GR];  // candidate row's store row, -1 when its id is out of range
  const int x = blockIdx.x, j = blockIdx.y, i = blockIdx.z, tid = threadIdx.x;
  const int C = XQ * G * unit, n_units = R / unit, c0 = x * GR;
  {
    const int c = c0 + tid;
    int row = -1;
    if (c < C) {
      const int g = c / (XQ * unit), r = (c / unit) % XQ;
      const int uid = ids[(size_t)(i * XQ + r) * k + j * G + g];
      if (uid >= 0 && uid < n_units) row = uid * unit + c % unit;
    }
    row_of[tid] = row;
  }
  __syncthreads();
  float macc[2][4] = {};  // this warp's rows (tid & ~31) + 0 .. 31 x the 8 queries
  for (int d0 = 0; d0 < D; d0 += GDK) {
    for (int e = tid; e < GR * GDK; e += GR) {
      const int r = e / GDK, dd = e % GDK, gd = d0 + dd, row = row_of[r];
      rs[dd * GLD + r] = (row >= 0 && gd < D) ? widen(shard[(size_t)row * D + gd]) : 0.0f;
    }
    for (int e = tid; e < XQ * GDK; e += GR) {
      const int a = e / GDK, dd = e % GDK, gd = d0 + dd;
      qs[dd * XQ + a] = gd < D ? widen(q[(size_t)(i * XQ + a) * D + gd]) : 0.0f;
    }
    __syncthreads();
    mma_staged<2>(macc, rs, GLD, tid & ~31, qs, XQ, XQ, d0, GDK, D);
    __syncthreads();
  }
  store_staged<2>(macc, tid & ~31, XQ, rs, GR);  // rs[a * GR + r]
  __syncthreads();
  const int c = c0 + tid;
  if (c >= C) return;
  const bool ok = row_of[tid] >= 0;
#pragma unroll
  for (int a = 0; a < XQ; ++a)
    out[((size_t)j * Tn + i * XQ + a) * C + c] = ok ? rs[a * GR + tid] : __uint_as_float(0x7fffffffu);
}

template <typename K>
int raise_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_INT8 = 2;

// The driver's cuTensorMapEncodeTiled, through the runtime's entry-point
// lookup (nothing links libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled lookup_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiled>(p)
             : nullptr;
}

// The wgmma tile's tensor map of a row-major matrix [rows, D] of T (int8
// or bf16): boxes of 128 rows x SLAB_BYTES bytes in the 128-byte swizzle,
// zeros past either edge.
template <typename T>
int encode_tile_map(CUtensorMap* map, const void* base, int rows, int D) {
  static const EncodeTiled encode = lookup_encode_tiled();  // once, thread-safe
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(SLAB_BYTES / sizeof(T)), (cuuint32_t)TR};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// What the score tile of dtype T needs beside its pointers: on the wgmma
// tile, the two tensor maps where TMA can read the operands (a row's bytes
// a multiple of 16: D % 16 == 0 on int8, D % 8 == 0 on bf16; both bases
// 16-byte aligned), else tma = 0 and the producer warp stages the slabs.
// Returns a CUDA error if a map cannot be encoded.
template <typename T>
int tile_maps(typename Tile<T>::Maps* maps, const void* q, const void* shard, int Tn, int R,
              int D) {
  if constexpr (std::is_same<typename Tile<T>::Maps, WgMaps>::value) {
    memset(maps, 0, sizeof *maps);
    maps->tma = (D * sizeof(T)) % 16 == 0 &&
                ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(shard)) & 15) == 0;
    if (!maps->tma) return 0;
    if (int err = encode_tile_map<T>(&maps->q, q, Tn, D)) return err;
    return encode_tile_map<T>(&maps->shard, shard, R, D);
  }
  return 0;
}

template <typename T>
int launch_k10(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
               int sub, int ew, int t_major, float inv_scale2, float* sims, float* bms,
               int32_t* arg, float* m2, int32_t* key, int32_t* raw_key, float* bm,
               cudaStream_t st) {
  const size_t smem = Tile<T>::smem(sizeof(float) * MAX_UNITS * TQ);
  if (int err = raise_smem(k10_blockmax2x<T>, smem)) return err;
  const int tiles = (bm != nullptr && ew > TR) ? ew / TR : 1;
  const unsigned grid = tile_grid(R / (TR * tiles), Tn);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  typename Tile<T>::Maps maps;
  if (int err = tile_maps<T>(&maps, q, shard, Tn, R, D)) return err;
  k10_blockmax2x<T><<<grid, Tile<T>::threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), Tn, R, D, valid_rows, sub,
      ew, tiles, t_major, inv_scale2, sims, bms, arg, m2, key, raw_key, bm, maps);
  return (int)cudaGetLastError();
}

// K1; coarse maxima wider than one row tile (ew > TR) come from K10's
// row-tile walk, which gives the same unit maxima and key bit for bit.
template <typename T>
int launch_k1(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
              int sub, int ew, float* bm_sub, int32_t* key, float* bm, cudaStream_t st) {
  if (bm != nullptr && ew > TR) {
    float inv_scale2;
    const uint32_t bits = INT8_INV_SCALE2_BITS;
    memcpy(&inv_scale2, &bits, sizeof bits);
    return launch_k10<T>(q, shard, Tn, R, D, valid_rows, sub, ew, 0, inv_scale2,
                         nullptr, bm_sub, nullptr, nullptr, key, nullptr, bm, st);
  }
  const size_t smem = Tile<T>::smem(sizeof(float) * MAX_UNITS * TQ);
  if (int err = raise_smem(k1_blockmax2<T>, smem)) return err;
  const unsigned grid = tile_grid(R / TR, Tn);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  typename Tile<T>::Maps maps;
  if (int err = tile_maps<T>(&maps, q, shard, Tn, R, D)) return err;
  k1_blockmax2<T><<<grid, Tile<T>::threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), Tn, D, valid_rows, sub, ew,
      bm_sub, key, bm, maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
              int block, float* sims, float* bm_t, cudaStream_t st) {
  const size_t smem = Tile<T>::smem(0);
  if (int err = raise_smem(k3_blockmax<T>, smem)) return err;
  const unsigned grid = tile_grid(R / TR, Tn);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  typename Tile<T>::Maps maps;
  if (int err = tile_maps<T>(&maps, q, shard, Tn, R, D)) return err;
  k3_blockmax<T><<<grid, Tile<T>::threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), Tn, R, D, valid_rows, block, sims,
      bm_t, maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k5(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
              int block, float* bm_t, cudaStream_t st) {
  const size_t smem = Tile<T>::smem(0);
  if (int err = raise_smem(k5_blockmax_only<T>, smem)) return err;
  const unsigned grid = tile_grid(R / TR, Tn);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  typename Tile<T>::Maps maps;
  if (int err = tile_maps<T>(&maps, q, shard, Tn, R, D)) return err;
  k5_blockmax_only<T><<<grid, Tile<T>::threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), Tn, D, valid_rows, block, bm_t,
      maps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* q, const void* shard, const int32_t* ids, int Tn, int R,
              int D, int KS, int unit, float* out, cudaStream_t st) {
  if (int err = raise_smem(k2_gather_rescore<T>, G_SMEM)) return err;
  dim3 grid((KS * unit + G_TILE - 1) / G_TILE, Tn);
  k2_gather_rescore<T><<<grid, G_TILE, G_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), ids, R, D, KS, unit, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k6(const void* q, const void* gathered, int Tn, int C, int D, float* out,
              cudaStream_t st) {
  if (int err = raise_smem(k6_block_scores<T>, G_SMEM)) return err;
  dim3 grid((C + G_TILE - 1) / G_TILE, Tn);
  k6_block_scores<T><<<grid, G_TILE, G_SMEM, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(gathered), C, D, out);
  return (int)cudaGetLastError();
}

int launch_k12(const void* q, const void* shard, const int32_t* ids, int Tn, int R, int D,
               int KS, int unit, const void* mmq, const void* mms, int tq, int mm_rows,
               int copies, float* out, float* mmo, cudaStream_t st) {
  using T = __nv_bfloat16;
  const long long n_gather = (long long)Tn * ((KS * unit + NT - 1) / NT);
  const long long n_product =
      copies > 0 ? (long long)copies * (mm_rows / TR) * ((tq + TQ - 1) / TQ) : 0;
  const long long nb = n_gather > n_product ? n_gather : n_product;
  if (nb == 0) return 0;
  if (nb > 0x7fffffffLL || mm_rows % TR) return (int)cudaErrorInvalidValue;
  typename Tile<T>::Maps maps;
  memset(&maps, 0, sizeof maps);
  if (n_product == 0) {
    if (int err = raise_smem(k12_gather_rescore_mm<T, false>, K12_GATHER_SMEM)) return err;
    k12_gather_rescore_mm<T, false><<<(unsigned)nb, NT, K12_GATHER_SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(shard), ids, R, D, KS, unit,
        (int)n_gather, static_cast<const T*>(mmq), static_cast<const T*>(mms), tq, mm_rows, 0,
        out, mmo, maps);
    return (int)cudaGetLastError();
  }
  const size_t smem = Tile<T>::smem(0);
  if (int err = raise_smem(k12_gather_rescore_mm<T, true>, smem)) return err;
  if (int err = tile_maps<T>(&maps, mmq, mms, tq, mm_rows, D)) return err;
  k12_gather_rescore_mm<T, true><<<(unsigned)nb, Tile<T>::threads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), ids, R, D, KS, unit,
      (int)n_gather, static_cast<const T*>(mmq), static_cast<const T*>(mms), tq, mm_rows,
      (int)n_product, out, mmo, maps);
  return (int)cudaGetLastError();
}

// K17: the store's and the queries' rows, f32 [N, D] -> the store dtype, in
// one pass: the L2 norm in the NORM ORDER stated above, the zero guard, the
// division and the store dtype's rounding (ops/topk_kernels.py:
// normalize_cast; plain twin normalize_cast_plain, bit for bit). It replaces
// no Pallas kernel: the JAX package does this as one XLA fusion,
// better_search_rag_rust_tpu/store/device_store.py:_normalize_cast (:62) for
// the store and cast_rows_to(normalize_rows(q)) inside the jitted search
// (better_search_rag_rust_tpu/ops/engine.py:396) for queries. Output rule per
// element y: f32 y; bf16 round to nearest even, as the card's cvt.rn.bf16.f32,
// except a NaN: ml_dtypes' bits, 0x7FC0 with the input's sign (cvt writes
// 0x7FFF; the NaN's sign decides its rank on the CPU, m2_sort_key, so rows
// must hold the JAX package's bits); int8 the lattice of ops/quantize.py,
// clip(rint(y *rn 127), -127, 127), a NaN to 0 (XLA's convert).
//
// Bound: the bytes, each input read once and each output written once (4 +
// 4, 2 or 1 bytes an element); 3 f32 operations an element are far below the
// ridge point. Design: one warp a row, lane l holding features 128c + 4l ..
// 128c + 4l + 3 as one 16-byte load a chunk c, so a warp reads 512
// contiguous bytes a chunk and the sum order above falls out of the loads.
// The first K17_REG_CHUNKS chunks (D <= 1024; 6 float4 a lane at D 768) stay
// in registers: device memory is read once and the divide and write come
// from registers. A wider D re-reads its later chunks for the write, from L2
// as a rule (the bound still counts them once). 4-byte loads and scalar
// writes where D % 4 != 0 or a base is misaligned, feature by feature in the
// same order, so both paths give the same bits.
//
// With normalization off (NORM false; cast_rows_to on the card) the same
// kernel is the bf16 cast alone: it skips the norm and the divide, and its
// warps stride over the 128-element chunks of all rows * D elements taken as
// one flat row, with the same loads and writes.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  if (v != v) return (uint16_t)(((__float_as_uint(v) >> 16) & 0x8000u) | 0x7FC0u);
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int8_t lattice_i8(float v) {
  const float r = rintf(__fmul_rn(v, 127.0f));
  if (r != r) return 0;
  return (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
}

__device__ __forceinline__ void k17_put(float* y, int f, float v) { y[f] = v; }
__device__ __forceinline__ void k17_put(uint16_t* y, int f, float v) { y[f] = bf16_bits(v); }
__device__ __forceinline__ void k17_put(int8_t* y, int f, float v) { y[f] = lattice_i8(v); }

__device__ __forceinline__ void k17_put4(float* y, float4 v) {
  *reinterpret_cast<float4*>(y) = v;
}
__device__ __forceinline__ void k17_put4(uint16_t* y, float4 v) {
  ushort4 o;
  o.x = bf16_bits(v.x);
  o.y = bf16_bits(v.y);
  o.z = bf16_bits(v.z);
  o.w = bf16_bits(v.w);
  *reinterpret_cast<ushort4*>(y) = o;
}
__device__ __forceinline__ void k17_put4(int8_t* y, float4 v) {
  char4 o;
  o.x = lattice_i8(v.x);
  o.y = lattice_i8(v.y);
  o.z = lattice_i8(v.z);
  o.w = lattice_i8(v.w);
  *reinterpret_cast<char4*>(y) = o;
}

constexpr int K17_THREADS = 256;
constexpr int K17_ROWS = K17_THREADS / 32;  // rows a block: one warp a row
constexpr int K17_REG_CHUNKS = 8;           // 128-feature chunks kept in registers

// Lane `lane`'s features 128c + 4 lane + j, j = 0..3, of row xr; +0.0 past D.
__device__ __forceinline__ float4 k17_chunk(const float* __restrict__ xr, long long D,
                                            long long c, int lane, int vec) {
  const long long f = 128 * c + 4 * lane;
  if (vec) return f < D ? *reinterpret_cast<const float4*>(xr + f) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v;
  v.x = f < D ? xr[f] : 0.0f;
  v.y = f + 1 < D ? xr[f + 1] : 0.0f;
  v.z = f + 2 < D ? xr[f + 2] : 0.0f;
  v.w = f + 3 < D ? xr[f + 3] : 0.0f;
  return v;
}

// The NORM ORDER's step over one chunk: j = 0..3 in order, no contraction.
__device__ __forceinline__ float k17_sumsq4(float acc, float4 v) {
  acc = __fadd_rn(acc, __fmul_rn(v.x, v.x));
  acc = __fadd_rn(acc, __fmul_rn(v.y, v.y));
  acc = __fadd_rn(acc, __fmul_rn(v.z, v.z));
  return __fadd_rn(acc, __fmul_rn(v.w, v.w));
}

// Chunk c's lane values into row yr, rounded to the store dtype.
template <typename OutT>
__device__ __forceinline__ void k17_store(OutT* __restrict__ yr, long long D, long long c,
                                          int lane, int vec, float4 v) {
  const long long f = 128 * c + 4 * lane;
  if (f >= D) return;
  if (vec) {
    k17_put4(yr + f, v);
    return;
  }
  k17_put(yr, f, v.x);
  if (f + 1 < D) k17_put(yr, f + 1, v.y);
  if (f + 2 < D) k17_put(yr, f + 2, v.z);
  if (f + 3 < D) k17_put(yr, f + 3, v.w);
}

template <typename OutT>
__device__ __forceinline__ void k17_write(OutT* __restrict__ yr, int D, int c, int lane,
                                          int vec, float4 v, float n) {
  v.x = __fdiv_rn(v.x, n);
  v.y = __fdiv_rn(v.y, n);
  v.z = __fdiv_rn(v.z, n);
  v.w = __fdiv_rn(v.w, n);
  k17_store(yr, D, c, lane, vec, v);
}

template <typename OutT, bool NORM>
__global__ void __launch_bounds__(K17_THREADS)
k17_normalize_cast(const float* __restrict__ x, OutT* __restrict__ y, long long rows, int D,
                   int vec) {
  const int lane = threadIdx.x & 31;
  if (!NORM) {  // the cast alone: rows * D elements as one flat row
    const long long n = rows * D, chunks = (n + 127) / 128;
    const long long warps = (long long)gridDim.x * K17_ROWS;
    for (long long c = (long long)blockIdx.x * K17_ROWS + (threadIdx.x >> 5); c < chunks;
         c += warps)
      k17_store(y, n, c, lane, vec, k17_chunk(x, n, c, lane, vec));
    return;
  }
  const long long row = (long long)blockIdx.x * K17_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: one row a warp
  const float* xr = x + row * D;
  OutT* yr = y + row * D;
  const int C = (D + 127) / 128;
  float4 keep[K17_REG_CHUNKS];
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < K17_REG_CHUNKS; ++c) {
    if (c < C) {
      keep[c] = k17_chunk(xr, D, c, lane, vec);
      acc = k17_sumsq4(acc, keep[c]);
    }
  }
  for (int c = K17_REG_CHUNKS; c < C; ++c) acc = k17_sumsq4(acc, k17_chunk(xr, D, c, lane, vec));
  // the halving tree: lane i < h takes v[i] + v[i + h]; lane 0 ends with s
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, h));
  float n = __fsqrt_rn(__shfl_sync(0xffffffffu, acc, 0));
  if (n == 0.0f) n = 1.0f;  // the reference's zero guard
#pragma unroll
  for (int c = 0; c < K17_REG_CHUNKS; ++c)
    if (c < C) k17_write(yr, D, c, lane, vec, keep[c], n);
  for (int c = K17_REG_CHUNKS; c < C; ++c)
    k17_write(yr, D, c, lane, vec, k17_chunk(xr, D, c, lane, vec), n);
}

template <typename OutT, bool NORM>
int launch_k17(const float* x, void* y, long long rows, int D, cudaStream_t st) {
  // a warp a row, or without normalization a warp a chunk of the flat row,
  // at most 16 blocks an SM of the 132 striding over the chunks
  const long long len = NORM ? D : rows * D;
  const long long warps = NORM ? rows : (len + 127) / 128;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && len % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % (4 * sizeof(OutT)) == 0;
  long long blocks = (warps + K17_ROWS - 1) / K17_ROWS;
  if (!NORM && blocks > 132 * 16) blocks = 132 * 16;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k17_normalize_cast<OutT, NORM><<<(unsigned)blocks, K17_THREADS, 0, st>>>(
      x, static_cast<OutT*>(y), rows, D, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Geometry the wrappers must respect (checked in Python too): R % 128 == 0;
// K1: sub in {8, 16, 32, 64, 128}, ew a multiple of sub dividing 128 or a
// multiple of 128 dividing R; K3: block dividing 128. key / bm may be null
// to skip those outputs. dtype: 0 float32, 1 bfloat16, 2 int8 (the lattice;
// D <= 1040).

int bsr_matmul_blockmax2(const void* q, const void* shard, int dtype, int Tn, int R,
                         int D, int valid_rows, int sub, int ew, float* bm_sub,
                         int32_t* key, float* bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_k1<__nv_bfloat16>(q, shard, Tn, R, D, valid_rows, sub, ew, bm_sub,
                                    key, bm, st);
  if (dtype == DTYPE_F32)
    return launch_k1<float>(q, shard, Tn, R, D, valid_rows, sub, ew, bm_sub, key, bm,
                            st);
  if (dtype == DTYPE_INT8)
    return launch_k1<int8_t>(q, shard, Tn, R, D, valid_rows, sub, ew, bm_sub, key, bm,
                             st);
  return (int)cudaErrorInvalidValue;
}

// K10: K1's geometry; bms is required, every other output may be null;
// bf16 and int8 only (the prototypes' dtypes), raw_key on int8 only;
// inv_scale2 scales int8 dots (INT8_INV_SCALE2 for the lattice).
int bsr_matmul_blockmax2x(const void* q, const void* shard, int dtype, int Tn, int R,
                          int D, int valid_rows, int sub, int ew, int t_major,
                          float inv_scale2, float* sims, float* bms, int32_t* arg,
                          float* m2, int32_t* raw_key, float* bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_k10<__nv_bfloat16>(q, shard, Tn, R, D, valid_rows, sub, ew, t_major,
                                     inv_scale2, sims, bms, arg, m2, nullptr, nullptr,
                                     bm, st);
  if (dtype == DTYPE_INT8)
    return launch_k10<int8_t>(q, shard, Tn, R, D, valid_rows, sub, ew, t_major,
                              inv_scale2, sims, bms, arg, m2, nullptr, raw_key, bm, st);
  return (int)cudaErrorInvalidValue;
}

int bsr_gather_rescore(const void* q, const void* shard, const int32_t* ids, int dtype,
                       int Tn, int R, int D, int KS, int unit, float* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_k2<__nv_bfloat16>(q, shard, ids, Tn, R, D, KS, unit, out, st);
  if (dtype == DTYPE_F32)
    return launch_k2<float>(q, shard, ids, Tn, R, D, KS, unit, out, st);
  if (dtype == DTYPE_INT8)
    return launch_k2<int8_t>(q, shard, ids, Tn, R, D, KS, unit, out, st);
  return (int)cudaErrorInvalidValue;
}

int bsr_matmul_blockmax(const void* q, const void* shard, int dtype, int Tn, int R,
                        int D, int valid_rows, int block, float* sims, float* bm_t,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_k3<__nv_bfloat16>(q, shard, Tn, R, D, valid_rows, block, sims, bm_t,
                                    st);
  if (dtype == DTYPE_F32)
    return launch_k3<float>(q, shard, Tn, R, D, valid_rows, block, sims, bm_t, st);
  if (dtype == DTYPE_INT8)
    return launch_k3<int8_t>(q, shard, Tn, R, D, valid_rows, block, sims, bm_t, st);
  return (int)cudaErrorInvalidValue;
}

// K5: K3's geometry (R % 128 == 0, block dividing 128); bm_t [R/block, Tn].
int bsr_matmul_blockmax_only(const void* q, const void* shard, int dtype, int Tn,
                             int R, int D, int valid_rows, int block, float* bm_t,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_k5<__nv_bfloat16>(q, shard, Tn, R, D, valid_rows, block, bm_t, st);
  if (dtype == DTYPE_F32)
    return launch_k5<float>(q, shard, Tn, R, D, valid_rows, block, bm_t, st);
  if (dtype == DTYPE_INT8)
    return launch_k5<int8_t>(q, shard, Tn, R, D, valid_rows, block, bm_t, st);
  return (int)cudaErrorInvalidValue;
}

// K4: ids [Tn, KS] unit ids; out [Tn, KS, chunk_bytes] with chunk_bytes =
// unit * D * itemsize; any dtype (a byte copy).
int bsr_gather_rows(const void* shard, const int32_t* ids, int Tn, int KS, int n_units,
                    long long chunk_bytes, void* out, void* stream) {
  dim3 grid(KS, Tn);
  k4_gather_rows<<<grid, CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(shard), ids, KS, n_units, (size_t)chunk_bytes,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

// K6: queries [Tn, D], gathered [Tn, C, D] in one dtype; out [Tn, C] f32.
int bsr_block_scores(const void* q, const void* gathered, int dtype, int Tn, int C,
                     int D, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return launch_k6<__nv_bfloat16>(q, gathered, Tn, C, D, out, st);
  if (dtype == DTYPE_F32) return launch_k6<float>(q, gathered, Tn, C, D, out, st);
  if (dtype == DTYPE_INT8) return launch_k6<int8_t>(q, gathered, Tn, C, D, out, st);
  return (int)cudaErrorInvalidValue;
}

// K11: ids [Tn, KS] unit ids into a bf16 store of n_units units of
// unit_bytes each (a multiple of 16; rows of at least 128 values);
// out [Tn, KS * 128] f32.
int bsr_gather_copy(const void* shard, const int32_t* ids, int Tn, int KS, int n_units,
                    int unit_bytes, float* out, void* stream) {
  if (unit_bytes <= 0 || unit_bytes % 16) return (int)cudaErrorInvalidValue;
  dim3 grid(KS, Tn);
  k11_gather_copy<<<grid, CP_THREADS, unit_bytes < CP_CHUNK ? unit_bytes : CP_CHUNK,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(shard), ids, KS, n_units, unit_bytes, out);
  return (int)cudaGetLastError();
}

// K12: K2's geometry on bf16 operands, plus mmq [tq, D] and mms [mm_rows, D]
// (mm_rows % 128 == 0) and `copies` copies of their product; out [Tn, KS *
// unit], mmo [tq, mm_rows / 128] (not written when copies == 0).
int bsr_gather_rescore_mm(const void* q, const void* shard, const int32_t* ids, int Tn,
                          int R, int D, int KS, int unit, const void* mmq, const void* mms,
                          int tq, int mm_rows, int copies, float* out, float* mmo,
                          void* stream) {
  return launch_k12(q, shard, ids, Tn, R, D, KS, unit, mmq, mms, tq, mm_rows, copies, out,
                    mmo, static_cast<cudaStream_t>(stream));
}

// K13: bf16 queries [Tn, D] (Tn % 8 == 0) and store [R, D] (R % unit == 0),
// ids [Tn, k] unit ids with k % G == 0; out [k / G, Tn, 8 * G * unit] f32.
int bsr_gather_cross(const void* q, const void* shard, const int32_t* ids, int Tn, int R,
                     int D, int k, int unit, int G, float* out, void* stream) {
  if (Tn % XQ || G <= 0 || k % G || unit <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((XQ * G * unit + GR - 1) / GR, k / G, Tn / XQ);
  k13_gather_cross<<<grid, GR, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(shard), ids, Tn,
      R, D, k, unit, G, out);
  return (int)cudaGetLastError();
}

// K17: x [rows, D] f32, contiguous -> y [rows, D] in dtype (0 f32, 1 bf16,
// 2 int8), each row normalized. normalize == 0: the same kernel with the
// norm and the divide off, the bf16 cast alone of rows * D elements (dtype
// must be 1). 16-byte loads where the bases allow them.
int bsr_normalize_cast(const float* x, void* y, long long rows, int D, int dtype,
                       int normalize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || D <= 0) return 0;
  if (!normalize) {
    if (dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
    return launch_k17<uint16_t, false>(x, y, rows, D, st);
  }
  if (dtype == DTYPE_F32) return launch_k17<float, true>(x, y, rows, D, st);
  if (dtype == DTYPE_BF16) return launch_k17<uint16_t, true>(x, y, rows, D, st);
  if (dtype == DTYPE_INT8) return launch_k17<int8_t, true>(x, y, rows, D, st);
  return (int)cudaErrorInvalidValue;
}

// The instruction probe: bf16 rows [R, D] (R % 64 == 0) and queries [128,
// D]; out_wg and out_mma [ceil(D / 16), R, 128] f32.
int bsr_probe_bf16_k16(const void* rows, const void* q, int R, int D, float* out_wg,
                       float* out_mma, void* stream) {
  if (R <= 0 || R % PROBE_ROWS || D <= 0) return (int)cudaErrorInvalidValue;
  k_probe_bf16_k16<<<R / PROBE_ROWS, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(rows), static_cast<const __nv_bfloat16*>(q), R, D,
      out_wg, out_mma);
  return (int)cudaGetLastError();
}

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
