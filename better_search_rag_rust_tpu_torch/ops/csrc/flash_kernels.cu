// Flash attention with segment ids for Hopper (sm_90a), plain C interface.
//
//   K14 bsr_flash_attention_fwd     <- _flash_attention_impl
//       (jax/experimental/pallas/ops/tpu/flash_attention.py:758, jax 0.9.0;
//        body _flash_attention_kernel_single_batch :340)
//   K15 bsr_flash_attention_bwd_dkv <- _flash_attention_bwd_dkv (:1121;
//        body _flash_attention_dkv_kernel :795)
//   K16 bsr_flash_attention_bwd_dq  <- _flash_attention_bwd_dq (:1456;
//        body _flash_attention_dq_kernel :1147)
//
// The encoder's attention_impl="flash" runs these: q, k, v [B, H, S, hd]
// bf16 (q and k rotated), segment ids [B, S] int32 (the attention mask:
// pad tokens form their own segment), sm_scale = 1/sqrt(hd).
//
// WHAT THEY COMPUTE (the library's arithmetic, no causal mask, no bias):
//   s = f32(q . k) * sm_scale + (seg_q == seg_kv ? 0 : MASK_VALUE)
// with the finite MASK_VALUE = -0.7 * FLT_MAX, never -inf: a pad query's
// first key tiles are all of the other segment, so its running max starts
// near MASK_VALUE and it sums p ~ 1 for those keys until a key of its own
// segment arrives, when alpha = exp(m_prev - m_next) underflows to 0 and
// wipes them (with -inf, m_prev - m_next would be NaN there).
//   K14: an online softmax in f32 (m, l per row), the unnormalised p rounded
//        to bf16 before the PV product, the sum in f32; o = acc / l in bf16,
//        and l, m f32 [B, H, Sq] for the backward.
//   K15: p = exp(s - m) * (1 / l) from the forward's l and m (1 / l once per
//        row: the wrapper's correctly rounded reciprocal); dv = bf16(p)^T
//        do; dp = do v^T; ds = (dp - di) * p * sm_scale; dk = bf16(ds)^T q,
//        all accumulated in f32 and rounded once; di = sum(o * do) comes in
//        (computed outside, as the library does).
//   K16: the same p and ds; dq = bf16(ds) k.
// The library splits the backward into the dkv and dq passes so that
// neither needs atomics; so do these. Every reduction runs in a fixed order:
// two runs give the same bits.
//
// WHAT BOUNDS THEM. K14 does 4*hd FLOP per query-key pair and head (QK^T
// and PV), K15 8*hd (QK^T again, dp, dv, dk), K16 6*hd (QK^T, dp, dq). The
// segment rule makes part of that work exact zeros: for a (query tile, key
// tile) pair whose segment-id ranges are disjoint and whose every query row
// has a key of its own segment (m a real logit), every p = exp(MASK_VALUE
// + x - m) underflows to 0, so the pair adds nothing to o, l, dk, dv or dq.
// The bounds count only the pairs the rule leaves, per row L^2 + (S-L)^2
// for a row of L real tokens: at [32, 12, 2048, 64] with chip_smoke.py
// phase 27's padding K14's is 0.282 ms at the bf16 tensor rate (989
// TFLOP/s; 0.417 over all S^2), against 201 MB, 0.060 ms at 3.35 TB/s:
// operations-bound. Beside the products each logit costs an exponential
// (the MUFU unit, 16 a cycle per SM against the tensor cores' 1024 bf16
// FMAs), which at hd 64 is a real share of the time.
//
// DESIGN (one for the three kernels: wgmma fed by TMA, one tile plan).
//   The tile plan (ops/flash_kernels.py segment_tile_plan: [B, ceil(Sq/64),
//   Sk/64] bytes, 1 where a pair is skipped) comes from the segment ids
//   alone, once a batch: a pair is skipped where the tiles' id ranges are
//   disjoint and every real query row of the query tile has a key of its
//   own segment somewhere. Each block first lists the tiles it keeps (one
//   warp, a ballot) and never loads, multiplies or exponentiates the
//   others. The skip is exact in the forward too, in any order of the
//   tiles: after a row's first own-segment tile a masked tile leaves m as
//   it is, so alpha = exp(0) = 1 and every p = 0; before it, that tile's
//   alpha = exp(MASK_VALUE - m) = 0 wipes what the masked tiles added. So
//   o, l and m are bit for bit the same with the plan on or off.
//   Warpgroup 0 is the producer, one thread of which keeps TMA loads in
//   flight into a ring of three stages behind mbarriers (full: the bytes
//   landed; empty: every consumer thread is done with it); the tiles lie in
//   TMA's 128-byte swizzle (64 / 32 bytes at hd 32 / 16), which the wgmma
//   descriptors read as written. K15 and K16 (and K14 at hd 128) have two
//   consumer warpgroups, 384 threads, setmaxnreg giving the producer 40
//   registers and the consumers 232; K14 up to hd 64 has three, 512
//   threads at 24 / 160 (12 % faster than two: more chains an SM hide
//   each other's latency). Each consumer warpgroup owns 64 rows and keeps
//   its rows' resident operand (q in K14; K and V in K15 up to hd 64; q and
//   do in K16) as wgmma A fragments in registers: S (and dP) on wgmma
//   m64n64k16 with B, the streamed tile, in shared memory; p (and ds) in
//   registers; the second products on m64n{hd}k16 with bf16(p) or bf16(ds)
//   as A from registers (the accumulator's layout is the next A
//   fragment's) and the streamed tile read transposed (MN-major). The
//   warpgroups run free: one's exponentials overlap the others' products
//   (making them take turns, FlashAttention-3's ping-pong, measured slower
//   in K14 and no faster in the backward: bench/ab_flash.py, PERF.md). A
//   warp whose 2 x 16 logits of a tile all
//   pair tokens of one segment skips the mask (a warp-uniform branch; s + 0
//   = s, the same bits). Exponentials are ex2.approx.ftz of x log2 e:
//   __expf's arithmetic, one instruction, results below 2^-126 flushed to
//   0; exp(0) = 1 and exp(-inf) = 0 exactly, which the online softmax and
//   the skip need. K14 and K16 stream key tiles past a block's 128 queries,
//   K15 query tiles past 128 keys. Each accumulates in f32 registers and
//   writes once: no atomics.
//   K14 per key tile and consumer: S = q K^T, issued with the previous
//   tile's O += bf16(p) V (FlashAttention-3's overlap within a warpgroup:
//   that product runs under this tile's softmax); the logit and mask; each
//   row's maximum over its quad of threads; alpha = exp(m_prev - m_next);
//   the thread's share of l, and (once the previous product is done) the
//   accumulator, rescaled by alpha; p = exp(s - m_next) packed straight into
//   the A fragments of the next product. The shares of l meet over the
//   quad once, at the end; O is scaled by 1 / l in registers and written
//   once, rows past Sq left out (Sq may be ragged; its q rows there are
//   zero).
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrapper raises on
// anything else.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

// The library's DEFAULT_MASK_VALUE: -0.7 * float32 max, in double, rounded once.
constexpr float MASK_VALUE = (float)(-0.7 * (double)FLT_MAX);

typedef __nv_bfloat16 bf16;

// Raise a kernel's dynamic shared-memory limit to `bytes` once; `configured`
// starts at the 48 KB default. Returns a cudaError_t (0 on success).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  configured = bytes;
  return 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragments of rows r0 .. r0 + 15 of a [S, HD] bf16 matrix, straight from
// global memory (rows at or past `rows` are zero): lane (g = lane/4, t =
// lane%4) holds, for k16 step ks, a[ks][0] (row g, k 2t, 2t+1), a[ks][1]
// (row g + 8), a[ks][2], a[ks][3] (k + 8).
template <int HD>
__device__ __forceinline__ void load_a_frags(const bf16* __restrict__ x, int r0,
                                             int rows, uint32_t (&a)[HD / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t lo = 0u, hi = 0u;
      if (r < rows) {
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(x + (size_t)r * HD + 16 * ks);
        lo = row[t];
        hi = row[4 + t];
      }
      a[ks][hr] = lo;
      a[ks][2 + hr] = hi;
    }
  }
}

// The library's logit: f32 dot times sm_scale, plus 0 or MASK_VALUE.
__device__ __forceinline__ float logit(float dot, float scale, int sa, int sb) {
  return __fadd_rn(__fmul_rn(dot, scale), sa == sb ? 0.f : MASK_VALUE);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;   // rows of a warpgroup's tile and of a streamed tile
constexpr int NT_WS = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int STAGES = 3;
// setmaxnreg: 40 x 128 + 232 x 256 = 168 x 384 registers, the block's
// allocation at __launch_bounds__(NT_WS, 1).
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int LAUNCH_REGS = (PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS) / NT_WS;
// K14 runs three consumer warpgroups up to hd 64 (FlashAttention-3's choice
// at these widths: more product and softmax chains an SM to hide each
// other's latency), at 24 x 128 + 160 x 384 = 126 x 512 registers; at hd
// 128 two, at K15/K16's split.
template <int HD>
constexpr int K14_WGS = HD <= 64 ? 3 : 2;
template <int WGS>
constexpr int K14_PRODUCER_REGS = WGS == 3 ? 24 : PRODUCER_REGS;
template <int WGS>
constexpr int K14_CONSUMER_REGS = WGS == 3 ? 160 : CONSUMER_REGS;
// Bytes of the per-row f32 / int32 vectors of a 64-row tile.
constexpr int VEC = WG_ROWS * 4;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
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

// Spin until the phase of parity `parity` has completed. (No __trap on a
// wait that never ends: a trap anywhere in the kernel keeps ptxas from
// allocating the consumers' setmaxnreg registers, and K15 spilled at hd 128.)
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory; they complete a transaction of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// Wait for all but the last committed group.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma owns (its accumulators, its A fragments) across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

template <int N = PRODUCER_REGS>
__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N = CONSUMER_REGS>
__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The layout of a 64-row bf16 tile [64][HD] as TMA writes it: column chunks
// of W = min(2 HD, 128) bytes a row (HD 128: two), each chunk's 64 rows
// packed at pitch W in TMA's W-byte swizzle (16-byte piece c of row r at
// r W + 16 (c ^ ((r / (128 / W)) % (W / 16)))), chunks one after the other.
// The wgmma descriptors read the same swizzle (layout type SWIZZLE).
template <int HD>
struct TileLayout {
  static constexpr int W = 2 * HD < 128 ? 2 * HD : 128;
  static constexpr int CHUNKS = 2 * HD / W;
  static constexpr int CHUNK_BYTES = WG_ROWS * W;
  static constexpr int BYTES = WG_ROWS * HD * 2;
  static constexpr int SWIZZLE = W == 128 ? 1 : (W == 64 ? 2 : 3);
};

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// The descriptor of k16 step kk of a tile read K-major (the contraction over
// its HD columns: rows are M or N): 8-row groups SBO = 8 W apart, the step
// 32 bytes into its chunk.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = TileLayout<HD>;
  constexpr int KPC = L::W / 32;  // k16 steps per chunk
  return gmma_desc(tile + (kk / KPC) * L::CHUNK_BYTES + (kk % KPC) * 32, 16, 8 * L::W,
                   L::SWIZZLE);
}

// The descriptor of k16 step kk of a tile read MN-major (the contraction
// over its 64 rows, its HD columns the N of the product): the step's 16
// rows, 8-row groups SBO = 8 W apart, column chunks LBO = 64 W apart.
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using L = TileLayout<HD>;
  return gmma_desc(tile + kk * 16 * L::W, L::CHUNK_BYTES, 8 * L::W, L::SWIZZLE);
}

// Rows [row, row + 64) of a [rows, HD] bf16 tensor map into a tile.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* tile, const CUtensorMap* map, int row,
                                          uint64_t* bar) {
  using L = TileLayout<HD>;
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
    tma_load_2d(tile + c * L::CHUNK_BYTES, map, c * (L::W / 2), row, bar);
}

// d (64 x 64 f32 over one warpgroup; register d[4j + e] of lane l in warp w
// holds row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2) = A B^T (+ d if
// acc): A 64 x 16 and B 64 x 16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// wgmma_ss64 with A from registers (the layout of wgmma_rs).
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x N f32, the layout of wgmma_ss64) += A B: A 64 x 16 bf16 in
// registers (lane l of warp w: a[0] row 16w + l/4, k 2(l%4), +1; a[1] the
// row + 8; a[2], a[3] k + 8), B 16 x N MN-major in shared memory
// (transposed: N contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      " %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The tile lists of a block: `list` gets, in increasing order, the tiles
// j < n that the plan keeps for the block's `tiles` 64-row tiles t0, t0 +
// 1, ...; returns how many. plan: [B][n_q][n_k] bytes, 1 where the (query
// tile, key tile) pair is skipped (nullptr: keep every tile). K15 (by_key)
// walks query tiles j for its key tiles; K14 and K16 key tiles j for their
// query tiles (K14's last block may hold fewer: a ragged Sq). One warp.
__device__ __forceinline__ int tile_list(const uint8_t* __restrict__ plan, int b, int n_q,
                                         int n_k, int t0, int tiles, bool by_key, int* list) {
  const int lane = threadIdx.x & 31;
  const int n = by_key ? n_q : n_k;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool keep = j < n;
    if (keep && plan != nullptr) {
      const uint8_t* pb = plan + (size_t)b * n_q * n_k;
      const int end = min(t0 + tiles, by_key ? n_k : n_q);
      bool skip = true;
      for (int t = t0; t < end; ++t)
        skip = skip && (by_key ? pb[(size_t)j * n_k + t] : pb[(size_t)t * n_k + j]);
      keep = !skip;
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) list[count + __popc(kept & ((1u << lane) - 1u))] = j;
    count += __popc(kept);
  }
  return count;
}

// A block's shared memory: the mbarriers (full[STAGES], empty[STAGES], the
// resident tiles'), the tile list (n + 1 ints), then from the next 1024-byte
// boundary `resident` 64-row tiles and STAGES stages of two streamed tiles
// and four 64-row vectors. The launch asks 1024 bytes of slack.
template <int HD>
struct BwdSmem {
  static constexpr int STAGE = (2 * TileLayout<HD>::BYTES + VEC * 4 + 1023) / 1024 * 1024;
  static size_t bytes(int n, int resident) {
    return 1024 + 64 + (size_t)4 * (n + 4) + resident * (size_t)TileLayout<HD>::BYTES +
           (size_t)STAGES * STAGE;
  }
};

// exp(x) as __expf computes it, ex2.approx of x log2 e, but with results
// below 2^-126 flushed to 0: one MUFU instruction, where __expf spends four
// more on keeping denormal results (p < 1.2e-38 adds nothing to a sum).
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// p = exp(s - m) * (1 / l) and ds = (dp - di) * p * sm_scale of one logit,
// the library's rounding points; p and ds go on to their products in bf16.
__device__ __forceinline__ float p_of(float dot, int sa, int sb, float m, float il, float scale) {
  return __fmul_rn(exp_ftz(__fsub_rn(logit(dot, scale, sa, sb), m)), il);
}

// p_of where the two tokens share a segment (the mask adds 0, and s + 0 = s:
// the same bits).
__device__ __forceinline__ float p_same(float dot, float m, float il, float scale) {
  return __fmul_rn(exp_ftz(__fsub_rn(__fmul_rn(dot, scale), m)), il);
}

// Whether every one of a thread's 2 x 16 logits of a tile pairs tokens of
// one segment, in every lane of the warp: its rows' ids r0, r1 against its
// columns' ids c[8 j + 2 t], + 1 (the tile's 64 ids in shared memory). Then
// the warp takes p_same (a warp-uniform branch).
__device__ __forceinline__ bool warp_one_segment(int r0, int r1, const int* c) {
  const int t = threadIdx.x & 3;
  uint32_t other = (uint32_t)(r0 ^ r1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 v = *reinterpret_cast<const int2*>(c + 8 * j + 2 * t);
    other |= (uint32_t)(v.x ^ r0) | (uint32_t)(v.y ^ r0);
  }
  return __all_sync(0xffffffffu, other == 0u);
}

__device__ __forceinline__ float ds_of(float dpv, float di, float p, float scale) {
  return __fmul_rn(__fmul_rn(__fsub_rn(dpv, di), p), scale);
}

// The four bf16 pairs of n8 columns 8j .. 8j + 7 of a 64 x 64 f32 tile (the
// wgmma_ss64 layout) as the A fragment of k16 step j / 2 of the next
// product: the accumulator's columns become the contraction.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, float v0, float v1, float v2,
                                       float v3) {
  a[j >> 1][2 * (j & 1)] = pack_bf16x2(v0, v1);
  a[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(v2, v3);
}

// A consumer's 64 x HD f32 accumulator (the wgmma_ss64 layout at N = HD)
// into rows [r0, r0 + 64) of a [rows, HD] bf16 matrix, rows at or past
// `rows` left out.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&d)[HD / 2], bf16* __restrict__ out,
                                           int r0, int rows) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + g + 8 * h;
    if (r >= rows) continue;
    bf16* row = out + (size_t)r * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16x2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
}

// The tensor maps of q, k, v and do (encode_rows); each kernel reads the
// streamed operands, and K15 at hd 128 its resident K and V, through them.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// The producer thread of K14 and K16: the plan's key tiles (list[1 .. n])
// of (b, h) = bh through the ring, K and V by TMA and the tile's 64 kv
// segment ids by a bulk copy, each stage once its consumers are done with it.
template <int HD>
__device__ __forceinline__ void stream_kv(const BwdMaps& maps, const int* __restrict__ seg_kv,
                                          const int* list, int n, unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, int b, int bh,
                                          int Sk) {
  using L = TileLayout<HD>;
  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    if (i >= STAGES) mbar_wait(&empty[stage], (i / STAGES - 1) & 1);
    unsigned char* st = ring + stage * BwdSmem<HD>::STAGE;
    const int j = list[1 + i];
    const int row = bh * Sk + j * WG_ROWS;
    mbar_expect_tx(&full[stage], 2 * L::BYTES + VEC);
    load_tile<HD>(st, &maps.k, row, &full[stage]);
    load_tile<HD>(st + L::BYTES, &maps.v, row, &full[stage]);
    bulk_load(st + 2 * L::BYTES, seg_kv + (size_t)b * Sk + j * WG_ROWS, VEC, &full[stage]);
  }
}

// One key tile of K14's online softmax over a thread's rows 0 and 1 (the
// wgmma_ss64 layout: s[4j], s[4j + 1] row 0, s[4j + 2], s[4j + 3] row 1):
// the logits from the dots s (ids sq0, sq1 of the rows, sk the tile's 64 kv
// ids), each row's new maximum m over the quad, alpha = exp(m_prev - m)
// (the caller rescales the accumulator by it), the thread's share of l
// rescaled by alpha, p = exp(s - m) added to l and packed as the A
// fragments pa of bf16(p) V.
__device__ __forceinline__ void softmax_tile(float (&s)[32], int sq0, int sq1, const int* sk,
                                             float scale, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&pa)[4][4]) {
  const int t = threadIdx.x & 3;
  if (warp_one_segment(sq0, sq1, sk)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 kv = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
      s[4 * j] = logit(s[4 * j], scale, sq0, kv.x);
      s[4 * j + 1] = logit(s[4 * j + 1], scale, sq0, kv.y);
      s[4 * j + 2] = logit(s[4 * j + 2], scale, sq1, kv.x);
      s[4 * j + 3] = logit(s[4 * j + 3], scale, sq1, kv.y);
    }
  }
  float m0 = m[0], m1 = m[1];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
    m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  // exp(-inf) = 0 on a row's first tile; afterwards the underflow to 0 that
  // wipes a pad row's masked sums (see the header), or exp(0) = 1
  const float a0 = exp_ftz(__fsub_rn(m[0], m0)), a1 = exp_ftz(__fsub_rn(m[1], m1));
  alpha[0] = a0;
  alpha[1] = a1;
  m[0] = m0;
  m[1] = m1;
  float l0 = __fmul_rn(l[0], a0), l1 = __fmul_rn(l[1], a1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float p0 = exp_ftz(__fsub_rn(s[4 * j], m0)), p1 = exp_ftz(__fsub_rn(s[4 * j + 1], m0));
    const float p2 = exp_ftz(__fsub_rn(s[4 * j + 2], m1)), p3 = exp_ftz(__fsub_rn(s[4 * j + 3], m1));
    l0 += p0 + p1;
    l1 += p2 + p3;
    pack_a(pa, j, p0, p1, p2, p3);
  }
  l[0] = l0;
  l[1] = l1;
}

// K14: a block per (b, h, 64 WGS queries): K16's producer warpgroup and
// ring, and WGS consumer warpgroups (K14_WGS). Each consumer keeps its 64
// rows of q as wgmma A fragments in registers (zero past Sq) and each
// row's segment id, running maximum and (its share of) sum; the plan's key
// tiles stream through the ring (k, v and their segment ids). Per tile j and consumer: S_j = Q K_j^T (B, the key
// tile, in shared memory) and the previous tile's O += bf16(P_j-1) V_j-1
// (A from registers, V read transposed) go out together; softmax_tile runs
// on S_j while the product of j - 1 is in flight (FlashAttention-3's
// overlap within a warpgroup); then O is rescaled by tile j's alpha. That
// is the same arithmetic in the same order as one tile after the other. O
// stays in f32 registers and is written once, scaled by 1 / l; l and m are
// written for the rows below Sq.
template <int HD, int WGS = K14_WGS<HD>>
__global__ void __launch_bounds__(128 * (WGS + 1), 1) k14_flash_fwd(
    const __grid_constant__ BwdMaps maps, const bf16* __restrict__ q,
    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    const uint8_t* __restrict__ plan, int H, int Sq, int Sk, int q_blocks, float scale,
    bf16* __restrict__ o, float* __restrict__ l_out, float* __restrict__ m_out) {
  using L = TileLayout<HD>;
  using SM = BwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* list = reinterpret_cast<int*>(smem + 64);
  const int n_q = (Sq + WG_ROWS - 1) / WG_ROWS, n_k = Sk / WG_ROWS;
  // STAGES x {k, v, seg_kv}
  unsigned char* ring = smem + ((smem_addr(smem) + 64 + 4 * (n_k + 4) + 1023) / 1024 * 1024 -
                                smem_addr(smem));

  const int qb = blockIdx.x % q_blocks;
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / H;
  const int q0 = qb * WGS * WG_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    const int n = tile_list(plan, b, n_q, n_k, WGS * qb, WGS, false, list + 1);
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  const int n = list[0];

  if (warp < 4) {  // the producer
    setmaxnreg_producer<K14_PRODUCER_REGS<WGS>>();
    if (threadIdx.x == 0) stream_kv<HD>(maps, seg_kv, list, n, ring, full, empty, b, bh, Sk);
  } else {  // a consumer: queries q0 + 64 cw .. + 63
    setmaxnreg_consumer<K14_CONSUMER_REGS<WGS>>();
    const int cw = (warp >> 2) - 1;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + cw * WG_ROWS + 16 * (warp & 3);
    const int r = r0 + g;  // this thread's rows r, r + 8
    const int* sqb = seg_q + (size_t)b * Sq;
    const int sq0 = r < Sq ? sqb[r] : 0, sq1 = r + 8 < Sq ? sqb[r + 8] : 0;
    uint32_t qf[HD / 16][4];
    load_a_frags<HD>(q + (size_t)bh * Sq * HD, r0, Sq, qf);
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    uint32_t pa[4][4];  // bf16(P) of the last tile, for its product with V
    auto pv = [&](int i) {  // O += bf16(P_i) V_i, committed
      const uint32_t va = smem_addr(ring + (i % STAGES) * SM::STAGE + L::BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(acc, pa[kk], desc_mn<HD>(va, kk));
      wgmma_commit();
    };
    for (int i = 0; i < n; ++i) {
      const int stage = i % STAGES;
      mbar_wait(&full[stage], (i / STAGES) & 1);
      const unsigned char* st = ring + stage * SM::STAGE;
      const uint32_t ka = smem_addr(st);
      float s[32];
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64(s, qf[kk], desc_k<HD>(ka, kk), kk);
      wgmma_commit();
      if (i > 0) {
        pv(i - 1);
        wgmma_wait_one();
      } else {
        wgmma_wait_all();
      }
      fence_regs(s);
      uint32_t pn[4][4];
      float alpha[2];
      softmax_tile(s, sq0, sq1, reinterpret_cast<const int*>(st + 2 * L::BYTES), scale, m, l,
                   alpha, pn);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      if (i > 0) mbar_arrive(&empty[(i - 1) % STAGES]);  // K and V of i - 1 are done
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    }
    if (n > 0) {
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      pv(n - 1);
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
    }
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= i0;
      acc[4 * j + 1] *= i0;
      acc[4 * j + 2] *= i1;
      acc[4 * j + 3] *= i1;
    }
    store_rows<HD>(acc, o + (size_t)bh * Sq * HD, q0 + cw * WG_ROWS, Sq);
    if (t == 0) {
      const size_t row = (size_t)bh * Sq + r;
      if (r < Sq) {
        l_out[row] = l0;
        m_out[row] = m[0];
      }
      if (r + 8 < Sq) {
        l_out[row + 8] = l1;
        m_out[row + 8] = m[1];
      }
    }
  }
}

// K15 keeps its warpgroup's K and V as wgmma A fragments in registers up to
// hd 64 (32 registers: half the shared-memory reads of S^T and dP^T); at hd
// 128, beside the 128 registers of dK and dV, they would spill, and K and V
// stay resident in shared memory instead.
template <int HD>
constexpr bool A_REGS15 = HD <= 64;

// K15: a block per (b, h, 128 keys): warpgroup 0 the producer (one thread
// issues every copy), warpgroups 1 and 2 the consumers of 64 keys each. The
// block's K and V stay resident (A_REGS15: in the consumers' registers);
// the plan's query tiles stream through the ring (q, do and the tile's 1/l,
// m, di and segment ids). Per tile and consumer: S^T = K Q^T and dP^T = V
// dO^T (B, the streamed tile, in shared memory), p and ds in registers, dV
// += bf16(P^T) dO and dK += bf16(dS^T) Q (A from registers, B read
// transposed); dK and dV stay in f32 registers and are written once.
template <int HD>
__global__ void __launch_bounds__(NT_WS, 1) k15_flash_bwd_dkv(
    const __grid_constant__ BwdMaps maps, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, const float* __restrict__ inv_l,
    const float* __restrict__ m_in, const float* __restrict__ di, const uint8_t* __restrict__ plan,
    int H, int Sq, int Sk, int k_blocks, float scale, bf16* __restrict__ dk,
    bf16* __restrict__ dv) {
  using L = TileLayout<HD>;
  using SM = BwdSmem<HD>;
  constexpr int RESIDENT = A_REGS15<HD> ? 0 : 4;
  // hd 128: dV += P^T dO completes before dP^T = V dO^T starts, so that the
  // 128 registers of dK and dV never meet both logit tiles and p's fragments
  constexpr bool SPLIT = HD > 64;
  static_assert(!(SPLIT && A_REGS15<HD>), "the split path reads K and V in shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  uint64_t* res = empty + STAGES;
  int* list = reinterpret_cast<int*>(smem + 64);
  const int n_q = Sq / WG_ROWS, n_k = Sk / WG_ROWS;
  unsigned char* tiles = smem + ((smem_addr(smem) + 64 + 4 * (n_q + 4) + 1023) / 1024 * 1024 -
                                 smem_addr(smem));
  unsigned char* kt = tiles;                          // K rows 0-63, 64-127
  unsigned char* vt = tiles + 2 * L::BYTES;           // V rows 0-63, 64-127
  unsigned char* ring = tiles + RESIDENT * L::BYTES;  // STAGES x {q, do, 1/l, m, di, seg_q}

  const int kb = blockIdx.x % k_blocks;
  const int bh = blockIdx.x / k_blocks;
  const int b = bh / H;
  const int k0 = kb * 2 * WG_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    const int n = tile_list(plan, b, n_q, n_k, 2 * kb, 2, true, list + 1);
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  const int n = list[0];

  if (warp < 4) {  // the producer
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      if constexpr (RESIDENT > 0) {
        const int krow = bh * Sk + k0;
        mbar_expect_tx(res, RESIDENT * L::BYTES);
        for (int c = 0; c < 2; ++c) {
          load_tile<HD>(kt + c * L::BYTES, &maps.k, krow + c * WG_ROWS, res);
          load_tile<HD>(vt + c * L::BYTES, &maps.v, krow + c * WG_ROWS, res);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int stage = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[stage], (i / STAGES - 1) & 1);
        unsigned char* st = ring + stage * SM::STAGE;
        const int j = list[1 + i];
        const size_t row = (size_t)bh * Sq + j * WG_ROWS;
        mbar_expect_tx(&full[stage], 2 * L::BYTES + 4 * VEC);
        load_tile<HD>(st, &maps.q, (int)row, &full[stage]);
        load_tile<HD>(st + L::BYTES, &maps.dout, (int)row, &full[stage]);
        unsigned char* vec = st + 2 * L::BYTES;
        bulk_load(vec, inv_l + row, VEC, &full[stage]);
        bulk_load(vec + VEC, m_in + row, VEC, &full[stage]);
        bulk_load(vec + 2 * VEC, di + row, VEC, &full[stage]);
        bulk_load(vec + 3 * VEC, seg_q + (size_t)b * Sq + j * WG_ROWS, VEC, &full[stage]);
      }
    }
  } else {  // a consumer: keys k0 + 64 cw .. + 63
    setmaxnreg_consumer();
    const int cw = (warp >> 2) - 1;
    const int g = lane >> 2, t = lane & 3;
    const int r = k0 + cw * WG_ROWS + 16 * (warp & 3) + g;  // this thread's keys r, r + 8
    const int sk0 = seg_kv[(size_t)b * Sk + r], sk1 = seg_kv[(size_t)b * Sk + r + 8];
    const uint32_t ka = smem_addr(kt + cw * L::BYTES), va = smem_addr(vt + cw * L::BYTES);
    uint32_t kf[A_REGS15<HD> ? HD / 16 : 1][4], vf[A_REGS15<HD> ? HD / 16 : 1][4];
    if constexpr (A_REGS15<HD>) {
      const int r0 = k0 + cw * WG_ROWS + 16 * (warp & 3);
      load_a_frags<HD>(k + (size_t)bh * Sk * HD, r0, Sk, kf);
      load_a_frags<HD>(v + (size_t)bh * Sk * HD, r0, Sk, vf);
    } else {
      mbar_wait(res, 0);
    }
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int stage = i % STAGES;
      mbar_wait(&full[stage], (i / STAGES) & 1);
      const unsigned char* st = ring + stage * SM::STAGE;
      const uint32_t qa = smem_addr(st), da = smem_addr(st + L::BYTES);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if constexpr (A_REGS15<HD>)
          wgmma_rs64(s, kf[kk], desc_k<HD>(qa, kk), kk);
        else
          wgmma_ss64(s, desc_k<HD>(ka, kk), desc_k<HD>(qa, kk), kk);
      }
      if constexpr (!SPLIT) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          if constexpr (A_REGS15<HD>)
            wgmma_rs64(dp, vf[kk], desc_k<HD>(da, kk), kk);
          else
            wgmma_ss64(dp, desc_k<HD>(va, kk), desc_k<HD>(da, kk), kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (!SPLIT) fence_regs(dp);
      // column c of s^T is query row c of the tile; p replaces s
      const float* il = reinterpret_cast<const float*>(st + 2 * L::BYTES);
      const float* mq = il + WG_ROWS;
      const float* dd = il + 2 * WG_ROWS;
      const int* sq = reinterpret_cast<const int*>(il + 3 * WG_ROWS);
      uint32_t pa[4][4], sa[4][4];
      if (warp_one_segment(sk0, sk1, sq)) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(il + c);
          const float2 m2 = *reinterpret_cast<const float2*>(mq + c);
          s[4 * j] = p_same(s[4 * j], m2.x, l2.x, scale);
          s[4 * j + 1] = p_same(s[4 * j + 1], m2.y, l2.y, scale);
          s[4 * j + 2] = p_same(s[4 * j + 2], m2.x, l2.x, scale);
          s[4 * j + 3] = p_same(s[4 * j + 3], m2.y, l2.y, scale);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(il + c);
          const float2 m2 = *reinterpret_cast<const float2*>(mq + c);
          const int2 s2 = *reinterpret_cast<const int2*>(sq + c);
          s[4 * j] = p_of(s[4 * j], s2.x, sk0, m2.x, l2.x, scale);
          s[4 * j + 1] = p_of(s[4 * j + 1], s2.y, sk0, m2.y, l2.y, scale);
          s[4 * j + 2] = p_of(s[4 * j + 2], s2.x, sk1, m2.x, l2.x, scale);
          s[4 * j + 3] = p_of(s[4 * j + 3], s2.y, sk1, m2.y, l2.y, scale);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pack_a(pa, j, s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      fence_regs(pa);
      fence_regs(dva);
      if constexpr (SPLIT) {  // dV's product, then dP's: fewer live registers
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dva, pa[kk], desc_mn<HD>(da, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pa);
        fence_regs(dva);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss64(dp, desc_k<HD>(va, kk), desc_k<HD>(da, kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dp);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * j + 2 * t);
        pack_a(sa, j, ds_of(dp[4 * j], d2.x, s[4 * j], scale),
               ds_of(dp[4 * j + 1], d2.y, s[4 * j + 1], scale),
               ds_of(dp[4 * j + 2], d2.x, s[4 * j + 2], scale),
               ds_of(dp[4 * j + 3], d2.y, s[4 * j + 3], scale));
      }
      fence_regs(sa);
      fence_regs(dka);
      wgmma_fence();
      if constexpr (!SPLIT) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dva, pa[kk], desc_mn<HD>(da, kk));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dka, sa[kk], desc_mn<HD>(qa, kk));
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (!SPLIT) fence_regs(pa);
      fence_regs(sa);
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(&empty[stage]);  // this thread is done with the stage
    }
    const size_t base = (size_t)bh * Sk * HD;
    store_rows<HD>(dka, dk + base, k0 + cw * WG_ROWS, Sk);
    store_rows<HD>(dva, dv + base, k0 + cw * WG_ROWS, Sk);
  }
}

// K16: a block per (b, h, 128 queries), the same three warpgroups. Each
// consumer keeps its 64 rows of q and do as wgmma A fragments in registers
// (loaded once; half the shared-memory reads of S and dP against operands
// in shared memory) and each row's 1/l, m, di and segment id; the plan's key
// tiles stream through the ring (k, v and their segment ids). Per tile and
// consumer: S = Q K^T and dP = dO V^T, p and ds in registers, dQ += bf16(dS)
// K (B read transposed).
template <int HD>
__global__ void __launch_bounds__(NT_WS, 1) k16_flash_bwd_dq(
    const __grid_constant__ BwdMaps maps, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, const float* __restrict__ inv_l,
    const float* __restrict__ m_in, const float* __restrict__ di, const uint8_t* __restrict__ plan,
    int H, int Sq, int Sk, int q_blocks, float scale, bf16* __restrict__ dq) {
  using L = TileLayout<HD>;
  using SM = BwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* list = reinterpret_cast<int*>(smem + 64);
  const int n_q = Sq / WG_ROWS, n_k = Sk / WG_ROWS;
  // STAGES x {k, v, seg_kv}
  unsigned char* ring = smem + ((smem_addr(smem) + 64 + 4 * (n_k + 4) + 1023) / 1024 * 1024 -
                                smem_addr(smem));

  const int qb = blockIdx.x % q_blocks;
  const int bh = blockIdx.x / q_blocks;
  const int b = bh / H;
  const int q0 = qb * 2 * WG_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    const int n = tile_list(plan, b, n_q, n_k, 2 * qb, 2, false, list + 1);
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  const int n = list[0];

  if (warp < 4) {  // the producer
    setmaxnreg_producer();
    if (threadIdx.x == 0) stream_kv<HD>(maps, seg_kv, list, n, ring, full, empty, b, bh, Sk);
  } else {  // a consumer: queries q0 + 64 cw .. + 63
    setmaxnreg_consumer();
    const int cw = (warp >> 2) - 1;
    const int g = lane >> 2, t = lane & 3;
    const int r = q0 + cw * WG_ROWS + 16 * (warp & 3) + g;  // this thread's rows r, r + 8
    const size_t row = (size_t)bh * Sq + r;
    const int sq0 = seg_q[(size_t)b * Sq + r], sq1 = seg_q[(size_t)b * Sq + r + 8];
    const float m0 = m_in[row], m1 = m_in[row + 8];
    const float il0 = inv_l[row], il1 = inv_l[row + 8];
    const float di0 = di[row], di1 = di[row + 8];
    uint32_t qf[HD / 16][4], df[HD / 16][4];
    load_a_frags<HD>(q + (size_t)bh * Sq * HD, q0 + cw * WG_ROWS + 16 * (warp & 3), Sq, qf);
    load_a_frags<HD>(dout + (size_t)bh * Sq * HD, q0 + cw * WG_ROWS + 16 * (warp & 3), Sq, df);
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < n; ++i) {
      const int stage = i % STAGES;
      mbar_wait(&full[stage], (i / STAGES) & 1);
      const unsigned char* st = ring + stage * SM::STAGE;
      const uint32_t ka = smem_addr(st), va = smem_addr(st + L::BYTES);
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64(s, qf[kk], desc_k<HD>(ka, kk), kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64(dp, df[kk], desc_k<HD>(va, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      const int* sk = reinterpret_cast<const int*>(st + 2 * L::BYTES);
      uint32_t sa[4][4];
      if (warp_one_segment(sq0, sq1, sk)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pack_a(sa, j, ds_of(dp[4 * j], di0, p_same(s[4 * j], m0, il0, scale), scale),
                 ds_of(dp[4 * j + 1], di0, p_same(s[4 * j + 1], m0, il0, scale), scale),
                 ds_of(dp[4 * j + 2], di1, p_same(s[4 * j + 2], m1, il1, scale), scale),
                 ds_of(dp[4 * j + 3], di1, p_same(s[4 * j + 3], m1, il1, scale), scale));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(sk + 8 * j + 2 * t);
          pack_a(sa, j, ds_of(dp[4 * j], di0, p_of(s[4 * j], sq0, kv.x, m0, il0, scale), scale),
                 ds_of(dp[4 * j + 1], di0, p_of(s[4 * j + 1], sq0, kv.y, m0, il0, scale), scale),
                 ds_of(dp[4 * j + 2], di1, p_of(s[4 * j + 2], sq1, kv.x, m1, il1, scale), scale),
                 ds_of(dp[4 * j + 3], di1, p_of(s[4 * j + 3], sq1, kv.y, m1, il1, scale), scale));
        }
      }
      fence_regs(sa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(acc, sa[kk], desc_mn<HD>(ka, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sa);
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
    }
    store_rows<HD>(acc, dq + (size_t)bh * Sq * HD, q0 + cw * WG_ROWS, Sq);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

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

// The tensor map of a row-major bf16 matrix [rows, HD]: boxes of 64 rows x
// one column chunk (TileLayout<HD>), in its swizzle.
template <int HD>
int encode_rows(CUtensorMap* map, const void* base, long long rows) {
  static const EncodeTiled encode = lookup_encode_tiled();  // once, thread-safe
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  using L = TileLayout<HD>;
  const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)HD * 2};
  const cuuint32_t box[2] = {(cuuint32_t)(L::W / 2), (cuuint32_t)WG_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = L::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int encode_maps(BwdMaps* maps, const void* q, const void* k, const void* v, const void* dout,
                int B, int H, int Sq, int Sk) {
  const long long rq = (long long)B * H * Sq, rk = (long long)B * H * Sk;
  if (int err = encode_rows<HD>(&maps->q, q, rq)) return err;
  if (int err = encode_rows<HD>(&maps->k, k, rk)) return err;
  if (int err = encode_rows<HD>(&maps->v, v, rk)) return err;
  return encode_rows<HD>(&maps->dout, dout, rq);
}

// The register split of setmaxnreg needs the block's whole allocation: a
// kernel that ptxas gave fewer registers would wait forever in
// setmaxnreg.inc, so it is refused before it launches.
template <typename Kernel>
int check_launch_regs(Kernel kernel, int need = LAUNCH_REGS) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  return attr.numRegs >= need ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* sq, const int* skv,
               const uint8_t* plan, int B, int H, int Sq, int Sk, float scale, void* o,
               float* l, float* m, cudaStream_t stream) {
  constexpr int WGS = K14_WGS<HD>;
  static size_t configured = 48 * 1024;
  static const int regs = check_launch_regs(
      k14_flash_fwd<HD>,
      (K14_PRODUCER_REGS<WGS> + K14_CONSUMER_REGS<WGS> * WGS) / (WGS + 1));
  if (regs) return regs;
  const size_t smem = BwdSmem<HD>::bytes(Sk / WG_ROWS, 0);
  if (int err = allow_smem(k14_flash_fwd<HD>, smem, configured)) return err;
  BwdMaps maps = {};
  const long long rk = (long long)B * H * Sk;
  if (int err = encode_rows<HD>(&maps.k, k, rk)) return err;
  if (int err = encode_rows<HD>(&maps.v, v, rk)) return err;
  const int q_blocks = (Sq + WGS * WG_ROWS - 1) / (WGS * WG_ROWS);
  const unsigned blocks = (unsigned)B * H * q_blocks;
  k14_flash_fwd<HD><<<blocks, 128 * (WGS + 1), smem, stream>>>(maps, (const bf16*)q, sq, skv, plan, H, Sq,
                                                      Sk, q_blocks, scale, (bf16*)o, l, m);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const int* sq, const int* skv,
               const float* il, const float* m, const void* dout, const float* di,
               const uint8_t* plan, int B, int H, int Sq, int Sk, float scale, void* dk,
               void* dv, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  static const int regs = check_launch_regs(k15_flash_bwd_dkv<HD>);
  if (regs) return regs;
  const size_t smem = BwdSmem<HD>::bytes(Sq / WG_ROWS, A_REGS15<HD> ? 0 : 4);
  if (int err = allow_smem(k15_flash_bwd_dkv<HD>, smem, configured)) return err;
  BwdMaps maps;
  if (int err = encode_maps<HD>(&maps, q, k, v, dout, B, H, Sq, Sk)) return err;
  const int k_blocks = Sk / (2 * WG_ROWS);
  const unsigned blocks = (unsigned)B * H * k_blocks;
  k15_flash_bwd_dkv<HD><<<blocks, NT_WS, smem, stream>>>(
      maps, (const bf16*)k, (const bf16*)v, sq, skv, il, m, di, plan, H, Sq, Sk, k_blocks, scale,
      (bf16*)dk, (bf16*)dv);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const int* sq, const int* skv,
              const float* il, const float* m, const void* dout, const float* di,
              const uint8_t* plan, int B, int H, int Sq, int Sk, float scale, void* dq,
              cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  static const int regs = check_launch_regs(k16_flash_bwd_dq<HD>);
  if (regs) return regs;
  const size_t smem = BwdSmem<HD>::bytes(Sk / WG_ROWS, 0);
  if (int err = allow_smem(k16_flash_bwd_dq<HD>, smem, configured)) return err;
  BwdMaps maps;
  if (int err = encode_maps<HD>(&maps, q, k, v, dout, B, H, Sq, Sk)) return err;
  const int q_blocks = Sq / (2 * WG_ROWS);
  const unsigned blocks = (unsigned)B * H * q_blocks;
  k16_flash_bwd_dq<HD><<<blocks, NT_WS, smem, stream>>>(
      maps, (const bf16*)q, (const bf16*)dout, sq, skv, il, m, di, plan, H, Sq, Sk, q_blocks,
      scale, (bf16*)dq);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, Sq|Sk, hd] bf16 contiguous (k, v 16-byte aligned);
// seg_q [B, Sq], seg_kv [B, Sk] int32 (seg_kv 16-byte aligned); the tile
// plan [B, ceil(Sq/64), Sk/64] bytes (1: the pair is skipped; nullptr: none
// is); Sk a multiple of 64 (the wrapper asks the library's 128), Sq any; o
// [B, H, Sq, hd] bf16, l and m [B, H, Sq] f32.
extern "C" int bsr_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const int* seg_q, const int* seg_kv, const uint8_t* plan,
                                       int B, int H, int Sq, int Sk, int hd, float scale, void* o,
                                       float* l, float* m, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_fwd<16>(q, k, v, seg_q, seg_kv, plan, B, H, Sq, Sk, scale, o, l, m, stream);
    case 32: return launch_fwd<32>(q, k, v, seg_q, seg_kv, plan, B, H, Sq, Sk, scale, o, l, m, stream);
    case 64: return launch_fwd<64>(q, k, v, seg_q, seg_kv, plan, B, H, Sq, Sk, scale, o, l, m, stream);
    case 128: return launch_fwd<128>(q, k, v, seg_q, seg_kv, plan, B, H, Sq, Sk, scale, o, l, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The forward's operands (all 16-byte aligned), its m, 1/l [B, H, Sq] f32
// (one reciprocal a row), do [B, H, Sq, hd] bf16, di [B, H, Sq] f32 and
// the tile plan [B, Sq/64, Sk/64] bytes (1: the pair is skipped; nullptr:
// none is); Sq and Sk multiples of 128. dk, dv: [B, H, Sk, hd] bf16.
extern "C" int bsr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
    const float* inv_l, const float* m, const void* dout, const float* di,
    const uint8_t* plan, int B, int H, int Sq, int Sk, int hd, float scale, void* dk, void* dv,
    cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dkv<16>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dk, dv, stream);
    case 32: return launch_dkv<32>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dk, dv, stream);
    case 64: return launch_dkv<64>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dk, dv, stream);
    case 128: return launch_dkv<128>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dk, dv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As bsr_flash_attention_bwd_dkv; dq: [B, H, Sq, hd] bf16.
extern "C" int bsr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const int* seg_q, const int* seg_kv,
    const float* inv_l, const float* m, const void* dout, const float* di,
    const uint8_t* plan, int B, int H, int Sq, int Sk, int hd, float scale, void* dq,
    cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dq<16>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dq, stream);
    case 32: return launch_dq<32>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dq, stream);
    case 64: return launch_dq<64>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dq, stream);
    case 128: return launch_dq<128>(q, k, v, seg_q, seg_kv, inv_l, m, dout, di, plan, B, H, Sq, Sk, scale, dq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bsr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
