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
//
// K4 and K11 move bytes only. K6, K12's gather and K13 stage and sum exactly as
// K2 does (same chunks, same routines), so what is said of K2 below holds for
// them. K5 is K3 without its score store: the same score tile and the same
// block reduction (store_block_max, also K12's; K3's loop is the same code
// written out), so its block maxima are K3's bit for bit on every dtype.
//
// ONE ARITHMETIC RULE. Every score any of the three kernels produces is the
// f32 chain
//     acc = 0.0f;  for d = 0 .. D-1:  acc = __fmaf_rn(row[d], q[d], acc)
// with bf16 operands widened by __bfloat162float (exact). fma_chunk() below
// is the only code that advances an accumulator, and all three kernels call
// it over consecutive D chunks, so each accumulator sees d in order no
// matter how a kernel tiles rows, queries or D. Zero padding of a ragged D
// chunk appends exact +0 terms, which leave the chain's bits unchanged (an
// accumulator that starts at +0.0 never becomes -0.0). Hence the same
// (query, row) pair scores bit for bit the same in K1, K2 and K3. The
// rescore route's argmax fast path (ops/topk.py) sorts K1 maxima and K2
// rescored scores together and is exact only because of this identity; the
// port's oracle scores through K3. There is no split-K and no tensor-core
// path here. A later change that moves any one kernel to tensor cores
// (wgmma) or to another summation order must move the other two with it, or
// turn the argmax fast path off.
//
// Because the chain is exact f32 arithmetic, float32 stores are sound on
// these kernels as well as bf16 ones (the TPU's Mosaic f32 product was not).
//
// INT8 STORES (the lattice of ops/quantize.py) take the other rule: one
// int32 accumulator per score, advanced only by dp4a_chunk() (__dp4a over
// 4-byte packs of features; a ragged tail is zero-padded, adding exact
// zeros), then ONE int8_score(): __fmul_rn(float(acc), INT8_INV_SCALE2).
// Integer sums are exact in any order (|acc| <= D * 127^2, far inside
// int32), and float(acc) is exact below 2^24 (D <= 1040), so every kernel,
// every tiling and the plain versions give the same bits — the argmax fast
// path's identity (K1 max == K2 rescore == K3 score) holds by construction.
// K1's emission runs on these scaled f32 scores exactly as on the float
// path. The reference packs (acc, row) into integer keys instead
// (topk_pallas.py:320, _int8_bm2_emit); both name the same argmax and m2
// unless two DISTINCT dots round to one scaled f32, and that needs |acc| near
// 2^23 (scores above 512), while lattice rows of unit vectors keep
// |acc| <~ 127^2 (scores near [-1, 1]), where adjacent integers stay ~500
// f32 ulps apart after the multiply. This replaces the int8 bodies of K1
// (topk_pallas.py:390-434) and the int8 arm of _sims_dot (:56-61) that K2
// and K3 score through. SIMT dp4a, no tensor cores (mma.sync s8 is later
// work).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrappers raise on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr float PAD_SIM = -3.0f;
// f32(1) / f32(127 * 127), bitwise ops/quantize.py's INT8_INV_SCALE2.
constexpr uint32_t INT8_INV_SCALE2_BITS = 0x38820610u;

// Score tile of K1/K3: TR store rows x TQ queries per block, NT threads, each
// thread a MR x MQ micro-tile of accumulators; D staged through shared memory
// DK features at a time, transposed and widened to f32.
constexpr int TR = 128;
constexpr int TQ = 128;
constexpr int DK = 16;
constexpr int NT = 256;
constexpr int MR = 8;
constexpr int MQ = 8;
constexpr int LDS = TR + 4;       // padded leading dim of the staged tiles
constexpr int LDO = TQ + 1;       // padded leading dim of the score tile

// K2: one query x GR gathered rows per block, one row per thread.
constexpr int GR = 128;
constexpr int GDK = 32;
constexpr int GLD = GR + 4;
static_assert(TR == TQ, "score_tile stages rows and queries in one loop");
// int8: 4-byte feature packs staged per step (64 features) in K1/K3 and K2.
constexpr int DKP = 16;
constexpr int GDKP = 16;

template <typename T> __device__ __forceinline__ float widen(T x);
template <> __device__ __forceinline__ float widen<float>(float x) { return x; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// THE dot routine (see the header): advance every accumulator acc[i][j] by
// the features d = 0 .. dk-1 of a staged chunk, in order, one FMA each.
// r[d * r_ld + i] is row i's feature d, q[d * q_ld + j] query j's.
template <int M, int N>
__device__ __forceinline__ void fma_chunk(float (&acc)[M][N],
                                          const float* __restrict__ r, int r_ld,
                                          const float* __restrict__ q, int q_ld,
                                          int dk) {
#pragma unroll 4
  for (int d = 0; d < dk; ++d) {
    float rv[M], qv[N];
#pragma unroll
    for (int i = 0; i < M; ++i) rv[i] = r[d * r_ld + i];
#pragma unroll
    for (int j = 0; j < N; ++j) qv[j] = q[d * q_ld + j];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = __fmaf_rn(rv[i], qv[j], acc[i][j]);
  }
}

// Scores of store rows [row0, row0 + TR) against queries [q0, q0 + TQ) into
// the shared score tile st[r * LDO + c]; rows at or past valid_rows are
// masked to PAD_SIM. Queries past Tn score against zeros and are never
// written out by the callers. Requires R % TR == 0.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ q,
                                           const T* __restrict__ shard,
                                           int Tn, int D, int valid_rows,
                                           int row0, int q0, float* smem) {
  float* rs = smem;             // [DK][LDS]
  float* qs = smem + DK * LDS;  // [DK][LDS]
  const int tid = threadIdx.x;
  const int tx = tid % 16;      // query micro-tile: queries tx*MQ ..
  const int ty = tid / 16;      // row micro-tile:   rows    ty*MR ..
  float acc[MR][MQ];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MQ; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    // Consecutive threads read consecutive features of one row: each warp
    // covers two rows' DK-feature runs.
    for (int e = tid; e < TR * DK; e += NT) {
      const int r = e / DK, dd = e % DK, gd = d0 + dd;
      rs[dd * LDS + r] = gd < D ? widen(shard[(size_t)(row0 + r) * D + gd]) : 0.0f;
      const int gq = q0 + r;
      qs[dd * LDS + r] = (gd < D && gq < Tn) ? widen(q[(size_t)gq * D + gd]) : 0.0f;
    }
    __syncthreads();
    fma_chunk<MR, MQ>(acc, rs + ty * MR, LDS, qs + tx * MQ, LDS, DK);
    __syncthreads();
  }

  float* st = smem;  // reuse the staging space: [TR][LDO]
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty * MR + i;
    const bool ok = row0 + r < valid_rows;
#pragma unroll
    for (int j = 0; j < MQ; ++j) st[r * LDO + tx * MQ + j] = ok ? acc[i][j] : PAD_SIM;
  }
  __syncthreads();
}

// ---- int8 lattice (see the header) ----

// Whether a row base pointer and D allow one aligned 4-byte load per pack.
__device__ __forceinline__ bool packs_aligned(const int8_t* base, int D) {
  return (D & 3) == 0 && (reinterpret_cast<uintptr_t>(base) & 3) == 0;
}

// Features gd .. gd+3 of one int8 row as a dp4a operand (byte b of the
// word = feature gd+b); features at or past D read as 0.
__device__ __forceinline__ int load_pack(const int8_t* __restrict__ row, int gd,
                                         int D, bool aligned) {
  if (aligned) return *reinterpret_cast<const int*>(row + gd);  // gd + 4 <= D
  uint32_t p = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (gd + b < D) p |= (uint32_t)(uint8_t)row[gd + b] << (8 * b);
  return (int)p;
}

// THE int8 dot routine: advance every int32 accumulator by dk staged packs.
template <int M, int N>
__device__ __forceinline__ void dp4a_chunk(int (&acc)[M][N], const int* __restrict__ r,
                                           int r_ld, const int* __restrict__ q,
                                           int q_ld, int dk) {
#pragma unroll 4
  for (int p = 0; p < dk; ++p) {
    int rv[M], qv[N];
#pragma unroll
    for (int i = 0; i < M; ++i) rv[i] = r[p * r_ld + i];
#pragma unroll
    for (int j = 0; j < N; ++j) qv[j] = q[p * q_ld + j];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = __dp4a(rv[i], qv[j], acc[i][j]);
  }
}

// THE int8 score: one rounded multiply of the exact dot.
__device__ __forceinline__ float int8_score(int acc) {
  return __fmul_rn(__int2float_rn(acc), __uint_as_float(INT8_INV_SCALE2_BITS));
}

// score_tile for int8 operands: the same tile, masking and output layout,
// D staged 4 * DKP features at a time as packs. RAW keeps the exact int32
// dots instead (masked rows PAD_ACC), for K10's integer key.
constexpr int32_t PAD_ACC = -(1 << 24);  // below any dot at D <= 1040

template <bool RAW = false>
__device__ __forceinline__ void score_tile_i8(const int8_t* __restrict__ q,
                                              const int8_t* __restrict__ shard,
                                              int Tn, int D, int valid_rows,
                                              int row0, int q0, float* smem) {
  int* rs = reinterpret_cast<int*>(smem);  // [DKP][LDS]
  int* qs = rs + DKP * LDS;                // [DKP][LDS]
  const bool s_al = packs_aligned(shard, D), q_al = packs_aligned(q, D);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  int acc[MR][MQ];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MQ; ++j) acc[i][j] = 0;

  for (int d0 = 0; d0 < D; d0 += 4 * DKP) {
    for (int e = tid; e < TR * DKP; e += NT) {
      const int r = e / DKP, p = e % DKP, gd = d0 + 4 * p;
      rs[p * LDS + r] = gd < D ? load_pack(shard + (size_t)(row0 + r) * D, gd, D, s_al) : 0;
      const int gq = q0 + r;
      qs[p * LDS + r] =
          (gd < D && gq < Tn) ? load_pack(q + (size_t)gq * D, gd, D, q_al) : 0;
    }
    __syncthreads();
    dp4a_chunk<MR, MQ>(acc, rs + ty * MR, LDS, qs + tx * MQ, LDS, DKP);
    __syncthreads();
  }

  float* st = smem;
  int* ist = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty * MR + i;
    const bool ok = row0 + r < valid_rows;
#pragma unroll
    for (int j = 0; j < MQ; ++j) {
      if constexpr (RAW)
        ist[r * LDO + tx * MQ + j] = ok ? acc[i][j] : PAD_ACC;
      else
        st[r * LDO + tx * MQ + j] = ok ? int8_score(acc[i][j]) : PAD_SIM;
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void any_score_tile(const T* __restrict__ q,
                                               const T* __restrict__ shard, int Tn,
                                               int D, int valid_rows, int row0, int q0,
                                               float* smem) {
  if constexpr (std::is_same<T, int8_t>::value)
    score_tile_i8(q, shard, Tn, D, valid_rows, row0, q0, smem);
  else
    score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
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

constexpr size_t SCORE_SMEM = sizeof(float) * (size_t)TR * LDO;  // >= staging
constexpr int MAX_UNITS = TR / 8;                                // sub >= 8

// K1: sub-unit maxima, optional packed (second max, argmax) key, optional
// coarse maxima at emit width ew <= TR (wider ones: K10's row-tile walk,
// see launch_k1); scores never leave shared memory.
// Outputs are transposed like the TPU kernel's: [R/sub, T], [R/ew, T].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
k1_blockmax2(const T* __restrict__ q, const T* __restrict__ shard, int Tn,
             int D, int valid_rows, int sub, int ew, float* __restrict__ bm_sub,
             int32_t* __restrict__ key, float* __restrict__ bm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * TR, q0 = blockIdx.y * TQ;
  any_score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
  const float* st = smem;
  float* um = smem + TR * LDO;  // [MAX_UNITS][TQ] unit maxima
  const int units = TR / sub;
  for (int p = threadIdx.x; p < units * TQ; p += NT) {
    const int u = p / TQ, c = p % TQ;
    const float* col = st + (size_t)u * sub * LDO + c;
    float m1 = col[0];
    int arg = 0;
    for (int r = 1; r < sub; ++r) {
      const float v = col[r * LDO];
      if (v > m1) { m1 = v; arg = r; }  // strict: lowest attaining row
    }
    um[u * TQ + c] = m1;
    if (q0 + c >= Tn) continue;
    const size_t o = (size_t)(row0 / sub + u) * Tn + q0 + c;
    bm_sub[o] = m1;
    if (key != nullptr) {
      // second max: the max with the argmax ROW replaced by PAD_SIM
      float m2 = __uint_as_float(0xff800000u);  // -inf
      for (int r = 0; r < sub; ++r) m2 = fmaxf(m2, r == arg ? PAD_SIM : col[r * LDO]);
      key[o] = pack_key(m2, arg);
    }
  }
  if (bm == nullptr) return;
  __syncthreads();
  const int groups = TR / ew, per = ew / sub;
  for (int p = threadIdx.x; p < groups * TQ; p += NT) {
    const int g = p / TQ, c = p % TQ;
    if (q0 + c >= Tn) continue;
    float m = um[(g * per) * TQ + c];
    for (int u = 1; u < per; ++u) m = fmaxf(m, um[(g * per + u) * TQ + c]);
    bm[(size_t)(row0 / ew + g) * Tn + q0 + c] = m;
  }
}

// The per-block maxima of a score tile st (rows [row0, row0 + TR), queries
// [q0, q0 + TQ)): block group g of query column c goes to
// out[(row0 / block + g) * g_stride + (q0 + c) * q_stride]; queries at or past
// Tn are skipped. The block reduction of K5 and K12, and K3's loop written
// out (calling this cost K3 1.5 % on the card), so their maxima agree bit
// for bit.
__device__ __forceinline__ void store_block_max(const float* st, int block, int Tn,
                                                int row0, int q0, float* __restrict__ out,
                                                size_t g_stride, size_t q_stride) {
  const int groups = TR / block;
  for (int p = threadIdx.x; p < groups * TQ; p += NT) {
    const int g = p / TQ, c = p % TQ;
    if (q0 + c >= Tn) continue;
    const float* col = st + (size_t)g * block * LDO + c;
    float m = col[0];
    for (int r = 1; r < block; ++r) m = fmaxf(m, col[r * LDO]);
    out[(size_t)(row0 / block + g) * g_stride + (size_t)(q0 + c) * q_stride] = m;
  }
}

// K3: masked scores sims [T, R] plus per-block maxima bm_t [R/block, T].
template <typename T>
__global__ void __launch_bounds__(NT, 2)
k3_blockmax(const T* __restrict__ q, const T* __restrict__ shard, int Tn, int R,
            int D, int valid_rows, int block, float* __restrict__ sims,
            float* __restrict__ bm_t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * TR, q0 = blockIdx.y * TQ;
  any_score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
  const float* st = smem;
  // consecutive threads -> consecutive rows of one query: coalesced stores
  for (int e = threadIdx.x; e < TR * TQ; e += NT) {
    const int c = e / TR, r = e % TR;
    if (q0 + c < Tn) sims[(size_t)(q0 + c) * R + row0 + r] = st[r * LDO + c];
  }
  const int groups = TR / block;
  for (int p = threadIdx.x; p < groups * TQ; p += NT) {
    const int g = p / TQ, c = p % TQ;
    if (q0 + c >= Tn) continue;
    const float* col = st + (size_t)g * block * LDO + c;
    float m = col[0];
    for (int r = 1; r < block; ++r) m = fmaxf(m, col[r * LDO]);
    bm_t[(size_t)(row0 / block + g) * Tn + q0 + c] = m;
  }
}

// K5: K3's per-block maxima bm_t [R/block, T] alone; the score tile never
// leaves shared memory. Replaces matmul_blockmax_only (topk_pallas.py:222,
// body :178), whose Mosaic row tile (pick_bm_row_tile) has no counterpart:
// the tile is K3's TR x TQ. Bound on the card: the 2*T*R*D operations of the
// product (the store is read once per 128-query tile, the output is R/block x
// T floats), on the SIMT pipes like K1/K3. A kernel of its own rather than a
// flag on K3, so every pointer stays __restrict__ (a shared body cost K2 9 %).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
k5_blockmax_only(const T* __restrict__ q, const T* __restrict__ shard, int Tn,
                 int D, int valid_rows, int block, float* __restrict__ bm_t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int row0 = blockIdx.x * TR, q0 = blockIdx.y * TQ;
  any_score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
  store_block_max(smem, block, Tn, row0, q0, bm_t, Tn, 1);
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
// int8 tiles hold the exact dots first: the raw key is taken from them, then
// each becomes __fmul_rn(float(acc), inv_scale2) in place — K1's int8_score
// when inv_scale2 is INT8_INV_SCALE2 — so every later pass reads f32 scores
// as K1's does, and shared outputs equal K1's bit for bit.
// Bound on the card: the 2*T*R*D operations on the SIMT pipes, as K1; with
// sims, also its R*T*4 bytes. A kernel of its own, so K1's body is untouched.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
k10_blockmax2x(const T* __restrict__ q, const T* __restrict__ shard, int Tn, int R,
               int D, int valid_rows, int sub, int ew, int tiles, int t_major,
               float inv_scale2, float* __restrict__ sims, float* __restrict__ bms,
               int32_t* __restrict__ arg, float* __restrict__ m2,
               int32_t* __restrict__ key, int32_t* __restrict__ raw_key,
               float* __restrict__ bm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* st = smem;
  float* um = smem + TR * LDO;  // [MAX_UNITS][TQ] unit maxima
  const int q0 = blockIdx.y * TQ, units = TR / sub, n_units = R / sub;
  // offset of (global unit gu, query column c) in a unit output
  auto at = [&](int gu, int c) -> size_t {
    return t_major ? (size_t)(q0 + c) * n_units + gu : (size_t)gu * Tn + q0 + c;
  };
  float cmax = __uint_as_float(0xff800000u);  // -inf; tiles > 1 only
  for (int tile = 0; tile < tiles; ++tile) {
    const int row0 = (blockIdx.x * tiles + tile) * TR;
    if constexpr (std::is_same<T, int8_t>::value) {
      score_tile_i8<true>(q, shard, Tn, D, valid_rows, row0, q0, smem);
      int* ist = reinterpret_cast<int*>(smem);
      if (raw_key != nullptr) {
        for (int p = threadIdx.x; p < units * TQ; p += NT) {
          const int u = p / TQ, c = p % TQ, base = u * sub * LDO + c;
          if (q0 + c >= Tn) continue;
          int k = ist[base] * 128 + 127;
          for (int r = 1; r < sub; ++r) k = max(k, ist[base + r * LDO] * 128 + (127 - r));
          raw_key[at(row0 / sub + u, c)] = k;
        }
        __syncthreads();
      }
      for (int e = threadIdx.x; e < TR * TQ; e += NT) {
        const int i = (e / TQ) * LDO + e % TQ, a = ist[i];
        smem[i] = a == PAD_ACC ? PAD_SIM : __fmul_rn(__int2float_rn(a), inv_scale2);
      }
      __syncthreads();
    } else {
      score_tile<T>(q, shard, Tn, D, valid_rows, row0, q0, smem);
    }
    if (sims != nullptr) {
      // consecutive threads -> consecutive queries of one row: coalesced
      for (int e = threadIdx.x; e < TR * TQ; e += NT) {
        const int r = e / TQ, c = e % TQ;
        if (q0 + c < Tn) sims[(size_t)(row0 + r) * Tn + q0 + c] = st[r * LDO + c];
      }
    }
    for (int p = threadIdx.x; p < units * TQ; p += NT) {
      const int u = p / TQ, c = p % TQ;
      const float* col = st + (size_t)u * sub * LDO + c;
      float m1 = col[0];
      int a = 0;
      for (int r = 1; r < sub; ++r) {
        const float v = col[r * LDO];
        if (v > m1) { m1 = v; a = r; }  // strict: lowest attaining row
      }
      um[u * TQ + c] = m1;
      if (q0 + c >= Tn) continue;
      const size_t o = at(row0 / sub + u, c);
      bms[o] = m1;
      if (arg != nullptr) arg[o] = a;
      if (m2 != nullptr || key != nullptr) {
        float s2 = __uint_as_float(0xff800000u);  // -inf
        for (int r = 0; r < sub; ++r) s2 = fmaxf(s2, r == a ? PAD_SIM : col[r * LDO]);
        if (m2 != nullptr) m2[o] = s2;
        if (key != nullptr) key[o] = pack_key(s2, a);
      }
    }
    if (bm != nullptr) {
      __syncthreads();
      if (tiles == 1) {
        const int groups = TR / ew, per = ew / sub;
        for (int p = threadIdx.x; p < groups * TQ; p += NT) {
          const int g = p / TQ, c = p % TQ;
          if (q0 + c >= Tn) continue;
          float m = um[(g * per) * TQ + c];
          for (int u = 1; u < per; ++u) m = fmaxf(m, um[(g * per + u) * TQ + c]);
          bm[(size_t)(row0 / ew + g) * Tn + q0 + c] = m;
        }
      } else if (threadIdx.x < TQ) {
        for (int u = 0; u < units; ++u) cmax = fmaxf(cmax, um[u * TQ + threadIdx.x]);
      }
    }
    if (tiles > 1) __syncthreads();  // the next tile's staging overwrites st
  }
  if (bm != nullptr && tiles > 1 && threadIdx.x < TQ && q0 + threadIdx.x < Tn)
    bm[(size_t)blockIdx.x * Tn + q0 + threadIdx.x] = cmax;
}

// K2: query t's KS selected unit-row blocks (ids [T, KS]) rescored with the
// same chain. Block (x, t) covers candidate slots [x*GR, x*GR + GR) of
// query t; an id outside [0, R/unit) scores NaN instead of reading out of
// bounds.
template <typename T>
__global__ void __launch_bounds__(GR)
k2_gather_rescore(const T* __restrict__ q, const T* __restrict__ shard,
                  const int32_t* __restrict__ ids, int R, int D, int KS,
                  int unit, float* __restrict__ out) {
  __shared__ float rs[GDK * GLD];
  __shared__ float qs[GDK];
  const int t = blockIdx.y, s0 = blockIdx.x * GR, tid = threadIdx.x;
  const int C = KS * unit, n_units = R / unit;
  const int32_t* my_ids = ids + (size_t)t * KS;
  float acc[1][1] = {{0.0f}};
  for (int d0 = 0; d0 < D; d0 += GDK) {
    for (int e = tid; e < GR * GDK; e += GR) {
      const int r = e / GDK, dd = e % GDK, gd = d0 + dd, s = s0 + r;
      float v = 0.0f;
      if (s < C && gd < D) {
        const int uid = my_ids[s / unit];
        if (uid >= 0 && uid < n_units)
          v = widen(shard[((size_t)uid * unit + s % unit) * D + gd]);
      }
      rs[dd * GLD + r] = v;
    }
    if (tid < GDK) qs[tid] = d0 + tid < D ? widen(q[(size_t)t * D + d0 + tid]) : 0.0f;
    __syncthreads();
    fma_chunk<1, 1>(acc, rs + tid, GLD, qs, 1, GDK);
    __syncthreads();
  }
  const int s = s0 + tid;
  if (s < C) {
    const int uid = my_ids[s / unit];
    out[(size_t)t * C + s] = (uid >= 0 && uid < n_units) ? acc[0][0] : __uint_as_float(0x7fffffffu);
  }
}

// K2 on int8 operands: the same blocks and NaN rule, packs staged GDKP at a
// time, one int32 dot per gathered row, one int8_score.
__global__ void __launch_bounds__(GR)
k2_gather_rescore_i8(const int8_t* __restrict__ q, const int8_t* __restrict__ shard,
                     const int32_t* __restrict__ ids, int R, int D, int KS, int unit,
                     float* __restrict__ out) {
  __shared__ int rs[GDKP * GLD];
  __shared__ int qs[GDKP];
  const int t = blockIdx.y, s0 = blockIdx.x * GR, tid = threadIdx.x;
  const int C = KS * unit, n_units = R / unit;
  const int32_t* my_ids = ids + (size_t)t * KS;
  const bool s_al = packs_aligned(shard, D), q_al = packs_aligned(q, D);
  int acc[1][1] = {{0}};
  for (int d0 = 0; d0 < D; d0 += 4 * GDKP) {
    for (int e = tid; e < GR * GDKP; e += GR) {
      const int r = e / GDKP, p = e % GDKP, gd = d0 + 4 * p, s = s0 + r;
      int v = 0;
      if (s < C && gd < D) {
        const int uid = my_ids[s / unit];
        if (uid >= 0 && uid < n_units)
          v = load_pack(shard + ((size_t)uid * unit + s % unit) * D, gd, D, s_al);
      }
      rs[p * GLD + r] = v;
    }
    if (tid < GDKP) {
      const int gd = d0 + 4 * tid;
      qs[tid] = gd < D ? load_pack(q + (size_t)t * D, gd, D, q_al) : 0;
    }
    __syncthreads();
    dp4a_chunk<1, 1>(acc, rs + tid, GLD, qs, 1, GDKP);
    __syncthreads();
  }
  const int s = s0 + tid;
  if (s < C) {
    const int uid = my_ids[s / unit];
    out[(size_t)t * C + s] =
        (uid >= 0 && uid < n_units) ? int8_score(acc[0][0]) : __uint_as_float(0x7fffffffu);
  }
}

// K6: query t against its own C pre-gathered rows (gathered [T, C, D]).
// Replaces block_scores (topk_pallas.py:846, body :828), whose keep-row-r
// Mosaic dots existed to pin the scoring pass's arithmetic. Here the blocks,
// the GDK-feature staging and fma_chunk are K2's, row s of query t being
// gathered[t, s] instead of a store row, so K6 == K2 == K3 bit for bit.
// Bound on the card: the gathered bytes (read once), far above the time of
// the 2*T*C*D FLOPs.
template <typename T>
__global__ void __launch_bounds__(GR)
k6_block_scores(const T* __restrict__ q, const T* __restrict__ gathered, int C, int D,
                float* __restrict__ out) {
  __shared__ float rs[GDK * GLD];
  __shared__ float qs[GDK];
  const int t = blockIdx.y, s0 = blockIdx.x * GR, tid = threadIdx.x;
  const T* rows = gathered + (size_t)t * C * D;
  float acc[1][1] = {{0.0f}};
  for (int d0 = 0; d0 < D; d0 += GDK) {
    for (int e = tid; e < GR * GDK; e += GR) {
      const int r = e / GDK, dd = e % GDK, gd = d0 + dd, s = s0 + r;
      rs[dd * GLD + r] = (s < C && gd < D) ? widen(rows[(size_t)s * D + gd]) : 0.0f;
    }
    if (tid < GDK) qs[tid] = d0 + tid < D ? widen(q[(size_t)t * D + d0 + tid]) : 0.0f;
    __syncthreads();
    fma_chunk<1, 1>(acc, rs + tid, GLD, qs, 1, GDK);
    __syncthreads();
  }
  const int s = s0 + tid;
  if (s < C) out[(size_t)t * C + s] = acc[0][0];
}

// K6 on int8 operands: K2 int8's packs, dp4a_chunk and int8_score.
__global__ void __launch_bounds__(GR)
k6_block_scores_i8(const int8_t* __restrict__ q, const int8_t* __restrict__ gathered,
                   int C, int D, float* __restrict__ out) {
  __shared__ int rs[GDKP * GLD];
  __shared__ int qs[GDKP];
  const int t = blockIdx.y, s0 = blockIdx.x * GR, tid = threadIdx.x;
  const int8_t* rows = gathered + (size_t)t * C * D;
  const bool s_al = packs_aligned(gathered, D), q_al = packs_aligned(q, D);
  int acc[1][1] = {{0}};
  for (int d0 = 0; d0 < D; d0 += 4 * GDKP) {
    for (int e = tid; e < GR * GDKP; e += GR) {
      const int r = e / GDKP, p = e % GDKP, gd = d0 + 4 * p, s = s0 + r;
      rs[p * GLD + r] = (s < C && gd < D) ? load_pack(rows + (size_t)s * D, gd, D, s_al) : 0;
    }
    if (tid < GDKP) {
      const int gd = d0 + 4 * tid;
      qs[tid] = gd < D ? load_pack(q + (size_t)t * D, gd, D, q_al) : 0;
    }
    __syncthreads();
    dp4a_chunk<1, 1>(acc, rs + tid, GLD, qs, 1, GDKP);
    __syncthreads();
  }
  const int s = s0 + tid;
  if (s < C) out[(size_t)t * C + s] = int8_score(acc[0][0]);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

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
//    (ids [T, KS] into unit-row blocks), staged GDK features at a time,
//    widened and summed by fma_chunk<1, 1> as K2 does, so the scores equal
//    K2's bit for bit (the one-chain rule of the header); NaN for an id
//    outside [0, R/unit). K2's staging is written out again here rather than
//    shared, so K2's kernel stays as it is (a body shared with K6 once cost
//    K2 9 %);
//  * product items: `copies` copies of K5's score tiles of mmq [tq, D]
//    against mms [mm_rows, D], each copy's 128-row block maxima stored to
//    mmo [tq, mm_rows / 128] by store_block_max: K5's bm_t transposed, bit for
//    bit. Every copy writes the same values to the same places. Identical
//    floats stored by several CTAs are benign, and storing every copy's
//    maxima, under no condition of its own, keeps the compiler from dropping
//    any copy's arithmetic.
// The TPU kernel recomputes the product in each of its (T/8)·(KS/cpg) grid
// steps; the wrapper passes that count as `copies` (0: no product, mmo is not
// written). CTA b runs product item b (if b < n_product) and gather items
// [b·G/n, (b+1)·G/n) of G, n = gridDim.x, so the gather is spread evenly over
// the launch. Bound on the card: the 2·copies·tq·mm_rows·D operations of the
// copies (on the SIMT pipes, as K5) while copies > 0, else the gathered bytes
// (read once), as K2.
constexpr int MLD = NT + 4;
constexpr size_t K12_GATHER_SMEM = sizeof(float) * (GDK * MLD + GDK);
static_assert(K12_GATHER_SMEM <= SCORE_SMEM, "one buffer serves both kinds of item");

template <typename T>
__device__ __forceinline__ void k12_gather_item(const T* __restrict__ q,
                                                const T* __restrict__ shard,
                                                const int32_t* __restrict__ ids, int R,
                                                int D, int KS, int unit, int item,
                                                float* __restrict__ out, float* smem) {
  float* rs = smem;              // [GDK][MLD]
  float* qs = smem + GDK * MLD;  // [GDK]
  const int C = KS * unit, per_q = (C + NT - 1) / NT, n_units = R / unit;
  const int t = item / per_q, s0 = (item % per_q) * NT, tid = threadIdx.x;
  const int32_t* my_ids = ids + (size_t)t * KS;
  float acc[1][1] = {{0.0f}};
  for (int d0 = 0; d0 < D; d0 += GDK) {
    for (int e = tid; e < NT * GDK; e += NT) {
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
    fma_chunk<1, 1>(acc, rs + tid, MLD, qs, 1, GDK);
    __syncthreads();
  }
  const int s = s0 + tid;
  if (s < C) {
    const int uid = my_ids[s / unit];
    out[(size_t)t * C + s] = (uid >= 0 && uid < n_units) ? acc[0][0] : __uint_as_float(0x7fffffffu);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
k12_gather_rescore_mm(const T* __restrict__ q, const T* __restrict__ shard,
                      const int32_t* __restrict__ ids, int R, int D, int KS, int unit,
                      int n_gather, const T* __restrict__ mmq, const T* __restrict__ mms,
                      int tq, int mm_rows, int n_product, float* __restrict__ out,
                      float* __restrict__ mmo) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long b = blockIdx.x, nb = gridDim.x;
  if (b < n_product) {
    const int row_tiles = mm_rows / TR;
    const int tile = (int)(b % ((long long)row_tiles * ((tq + TQ - 1) / TQ)));  // of copy b / tiles
    const int row0 = (tile % row_tiles) * TR, q0 = (tile / row_tiles) * TQ;
    score_tile<T>(mmq, mms, tq, D, mm_rows, row0, q0, smem);
    store_block_max(smem, TR, tq, row0, q0, mmo, 1, row_tiles);
    __syncthreads();  // the gather items restage smem
  }
  const int lo = (int)(b * n_gather / nb), hi = (int)((b + 1) * n_gather / nb);
  for (int item = lo; item < hi; ++item)
    k12_gather_item<T>(q, shard, ids, R, D, KS, unit, item, out, smem);
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
// thread, staged GDK features at a time as K2 stages, against the group's 8
// queries staged beside it, summed by fma_chunk<1, 8>, whose chain for each
// (row, query) pair is K2's (same operand order, d in order): the diagonal is
// K2's bit for bit. Each candidate row is read once per group, not once per
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
  float acc[1][XQ];
#pragma unroll
  for (int a = 0; a < XQ; ++a) acc[0][a] = 0.0f;
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
    fma_chunk<1, XQ>(acc, rs + tid, GLD, qs, XQ, GDK);
    __syncthreads();
  }
  const int c = c0 + tid;
  if (c >= C) return;
  const bool ok = row_of[tid] >= 0;
#pragma unroll
  for (int a = 0; a < XQ; ++a)
    out[((size_t)j * Tn + i * XQ + a) * C + c] = ok ? acc[0][a] : __uint_as_float(0x7fffffffu);
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

template <typename T>
int launch_k10(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
               int sub, int ew, int t_major, float inv_scale2, float* sims, float* bms,
               int32_t* arg, float* m2, int32_t* key, int32_t* raw_key, float* bm,
               cudaStream_t st) {
  const size_t smem = SCORE_SMEM + sizeof(float) * MAX_UNITS * TQ;
  if (int err = raise_smem(k10_blockmax2x<T>, smem)) return err;
  const int tiles = (bm != nullptr && ew > TR) ? ew / TR : 1;
  dim3 grid(R / (TR * tiles), (Tn + TQ - 1) / TQ);
  k10_blockmax2x<T><<<grid, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), Tn, R, D, valid_rows, sub,
      ew, tiles, t_major, inv_scale2, sims, bms, arg, m2, key, raw_key, bm);
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
  const size_t smem = SCORE_SMEM + sizeof(float) * MAX_UNITS * TQ;
  if (int err = raise_smem(k1_blockmax2<T>, smem)) return err;
  dim3 grid(R / TR, (Tn + TQ - 1) / TQ);
  k1_blockmax2<T><<<grid, NT, smem, st>>>(static_cast<const T*>(q),
                                          static_cast<const T*>(shard), Tn, D,
                                          valid_rows, sub, ew, bm_sub, key, bm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
              int block, float* sims, float* bm_t, cudaStream_t st) {
  if (int err = raise_smem(k3_blockmax<T>, SCORE_SMEM)) return err;
  dim3 grid(R / TR, (Tn + TQ - 1) / TQ);
  k3_blockmax<T><<<grid, NT, SCORE_SMEM, st>>>(static_cast<const T*>(q),
                                               static_cast<const T*>(shard), Tn, R,
                                               D, valid_rows, block, sims, bm_t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k5(const void* q, const void* shard, int Tn, int R, int D, int valid_rows,
              int block, float* bm_t, cudaStream_t st) {
  if (int err = raise_smem(k5_blockmax_only<T>, SCORE_SMEM)) return err;
  dim3 grid(R / TR, (Tn + TQ - 1) / TQ);
  k5_blockmax_only<T><<<grid, NT, SCORE_SMEM, st>>>(static_cast<const T*>(q),
                                                    static_cast<const T*>(shard), Tn,
                                                    D, valid_rows, block, bm_t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* q, const void* shard, const int32_t* ids, int Tn, int R,
              int D, int KS, int unit, float* out, cudaStream_t st) {
  dim3 grid((KS * unit + GR - 1) / GR, Tn);
  if constexpr (std::is_same<T, int8_t>::value)
    k2_gather_rescore_i8<<<grid, GR, 0, st>>>(static_cast<const T*>(q),
                                              static_cast<const T*>(shard), ids, R, D,
                                              KS, unit, out);
  else
    k2_gather_rescore<T><<<grid, GR, 0, st>>>(static_cast<const T*>(q),
                                              static_cast<const T*>(shard), ids, R, D,
                                              KS, unit, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k6(const void* q, const void* gathered, int Tn, int C, int D, float* out,
              cudaStream_t st) {
  dim3 grid((C + GR - 1) / GR, Tn);
  if constexpr (std::is_same<T, int8_t>::value)
    k6_block_scores_i8<<<grid, GR, 0, st>>>(static_cast<const T*>(q),
                                            static_cast<const T*>(gathered), C, D, out);
  else
    k6_block_scores<T><<<grid, GR, 0, st>>>(static_cast<const T*>(q),
                                            static_cast<const T*>(gathered), C, D, out);
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
  const size_t smem = n_product ? SCORE_SMEM : K12_GATHER_SMEM;
  if (int err = raise_smem(k12_gather_rescore_mm<T>, smem)) return err;
  k12_gather_rescore_mm<T><<<(unsigned)nb, NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(shard), ids, R, D, KS, unit,
      (int)n_gather, static_cast<const T*>(mmq), static_cast<const T*>(mms), tq, mm_rows,
      (int)n_product, out, mmo);
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

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
