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
// WHAT BOUNDS THEM. K14 does 4*S*S*hd FLOP per (b, h) (QK^T and PV) and
// moves q, k, v and o once: at [32, 12, 2048, 64] 412 GFLOP, 0.417 ms at
// the bf16 tensor rate (989 TFLOP/s), against 201 MB, 0.060 ms at 3.35
// TB/s: operations-bound by a factor of 7. K15 recomputes QK^T and adds dp,
// dv and dk (8*S*S*hd), K16 QK^T, dp and dq (6*S*S*hd): also
// operations-bound. Beside the products each logit costs an exponential
// (the MUFU unit, 16 a cycle per SM against the tensor cores' 1024 bf16
// FMAs), which at hd 64 is a real share of the time. The segment rule
// makes part of that work exact zeros: for a (query tile, key tile) pair
// whose segment-id ranges are disjoint and whose every query row has a key
// of its own segment (m a real logit, above MASK_VALUE / 2), every p =
// exp(MASK_VALUE + x - m) underflows to 0, so ds = 0 and the pair adds
// nothing to dk, dv or dq. The bounds count only the pairs the rule leaves.
//
// DESIGN.
//   K14 (a simple, right kernel first): mma.sync m16n8k16 (bf16 in, f32
//   accumulated in the instruction), K8's fragment routines
//   (attention_kernels.cu) in the same layouts, copied here since each
//   source builds into a library of its own. A block per (b, h, 64 query
//   rows), 4 warps of 16 rows. A warp's q goes from global memory straight
//   into mma A fragments once. Key and value tiles of 64 stream through a
//   two-slab cp.async ring in shared memory (pitch hd + 8: the 8 rows of an
//   ldmatrix fall in 8 distinct 16-byte bank groups), the copy of tile j +
//   1 in flight while tile j is multiplied, with the tile's 64 kv segment
//   ids beside them. The logits stay in registers; their C fragments repack
//   as the A fragments of bf16(p) . V, V read transposed by ldmatrix.trans.
//   It keeps the running max and sum of its two rows per thread in
//   registers (the sum per thread, reduced over the quad once at the end).
//   No [S, S] tensor exists anywhere, so S is bounded by the grid, not by
//   K8's MAX_S. Its exponentials are __expf (ex2.approx of x * log2 e):
//   exp(-huge) is 0 and exp(0) is 1 exactly, which the segment rule needs.
//   K15 / K16 (the backward, on wgmma fed by TMA): the wrapper's tile plan
//   (ops/flash_kernels.py backward_tile_plan: [B, Sq/64, Sk/64] bytes, 1
//   where a pair is exact zeros, as above) is read by each block, which
//   first lists the tiles it keeps (one warp, a ballot) and never loads,
//   multiplies or exponentiates the others. 384 threads: warpgroup 0 the
//   producer, one thread of which keeps TMA loads in flight into a ring of
//   three stages behind mbarriers (full: the bytes landed; empty: all 256
//   consumer threads are done with it); the tiles lie in TMA's 128-byte
//   swizzle (64 / 32 bytes at hd 32 / 16), which the wgmma descriptors read
//   as written; setmaxnreg gives the producer 40 registers and the two
//   consumer warpgroups 232. Each consumer warpgroup owns 64 rows and keeps
//   its rows' resident operand (K and V in K15 up to hd 64, q and do in
//   K16) as wgmma A fragments in registers: S and dP on wgmma m64n64k16
//   with B, the streamed tile, in shared memory; p and ds in registers; the
//   gradient products on m64n{hd}k16 with bf16(p) or bf16(ds) as A from
//   registers (the accumulator's layout is the next A fragment's) and the
//   streamed tile read transposed (MN-major). The two warpgroups run free:
//   one's exponentials overlap the other's products (making them take
//   turns, FlashAttention-3's ping-pong, measured no faster: bench/
//   ab_flash.py, PERF.md). A warp whose 2 x 16 logits of a tile
//   all pair tokens of one segment skips the mask (a warp-uniform branch;
//   s + 0 = s, the same bits). Exponentials are ex2.approx.ftz of x log2 e:
//   __expf's arithmetic, one instruction, results below 2^-126 flushed to
//   0. K15 streams query tiles past a block's 128 keys; K16 streams key
//   tiles past 128 queries. Each accumulates in f32 registers and writes
//   once: no atomics.
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

constexpr int BQ = 64;        // query rows of a K14 block
constexpr int BK = 64;        // keys of a K14 key tile
constexpr int NT = 128;       // 4 warps of 16 rows
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix
// i. Plain: lane (g = lane/4, t = lane%4) gets row g, elements 2t, 2t+1 of
// matrix i in r[i]; .trans: column g, rows 2t, 2t+1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A (16 x 16) B (16 x 8), f32 accumulated in the instruction. With
// g = lane / 4, t = lane % 4 (the PTX ISA's m16n8k16 layout):
//   a[0] (row g, k 2t..2t+1)  a[1] (row g+8, k 2t..)  a[2] (row g, k 2t+8..)
//   a[3] (row g+8, k 2t+8..);  b0 (k 2t..2t+1, col g)  b1 (k 2t+8.., col g);
//   c[0..1] (row g, cols 2t, 2t+1)  c[2..3] (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + 64) of a [S, HD] bf16 matrix into dst[r][d] (pitch HD + 8),
// one cp.async per 16 bytes, shared by the block's NT threads.
template <int HD>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ x, int r0,
                                           bf16* dst) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    cp_async16(dst + r * LD + c, x + (size_t)(r0 + r) * HD + c);
  }
}

// 64 consecutive 32-bit words (256 bytes) into dst, by threads 0-15.
__device__ __forceinline__ void stage_words(const void* __restrict__ x,
                                            void* dst) {
  if (threadIdx.x < 16)
    cp_async16(static_cast<char*>(dst) + 16 * threadIdx.x,
               static_cast<const char*>(x) + 16 * threadIdx.x);
}

// A fragments of rows r0 .. r0 + 15 of a [S, HD] bf16 matrix, straight from
// global memory (rows at or past `rows` are zero).
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


// acc = A . X^T for the warp's 16 rows (A fragments a, HD/16 k16 steps)
// against the 64 rows of a staged tile xb (pitch HD + 8): acc[j] is n8 tile
// j (rows g, g + 8; columns 8j + 2t, + 1).
template <int HD>
__device__ __forceinline__ void dot_tile(const uint32_t (&a)[HD / 16][4],
                                         const bf16* xb, float (&acc)[8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  // matrices: rows 0-7 | 8-15 of the pair (lane bit 4), d 0-7 | 8-15 of the
  // step (lane bit 3): r[0], r[1] are n8 tile 2p's b0, b1; r[2], r[3] 2p+1's.
  const bf16* base =
      xb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, base + 16 * p * LD + 16 * ks);
      mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}


// out += P . Y for the warp's 16 rows: P is [16, 64] as the C fragments pa
// (bf16 pairs, n8 tile j = columns 8j ..), Y a staged [64, HD] tile (pitch
// HD + 8) read transposed by ldmatrix.trans. n8 tiles 2kk and 2kk + 1 of P
// make k16 step kk of the product (K8's tile_pv repack).
template <int HD>
__device__ __forceinline__ void pv_tile(const uint32_t (&pa)[8][2],
                                        const bf16* yb, float (&out)[HD / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  // matrices: rows 0-7 | 8-15 of the step (lane bit 3), dims 0-7 | 8-15 of
  // the pair (lane bit 4): r[0], r[1] are dim tile 2dq's b0, b1; r[2], r[3]
  // 2dq+1's.
  const bf16* base =
      yb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                           pa[2 * kk + 1][1]};
#pragma unroll
    for (int dq = 0; dq < HD / 16; ++dq) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * kk * LD + 16 * dq);
      mma_bf16(out[2 * dq], a, b[0], b[1]);
      mma_bf16(out[2 * dq + 1], a, b[2], b[3]);
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

// Bytes of a K14 block's shared memory: a two-slab ring of K and V
// tiles [64][HD + 8] bf16 and their 64 kv segment ids.
template <int HD>
constexpr size_t ring_smem_bytes() {
  return 2 * (2 * (size_t)BK * (HD + 8) * 2 + BK * 4);
}


// ---------------------------------------------------------------------------
// K14: the forward
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT) k14_flash_fwd(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, int H, int Sq, int Sk, int q_tiles,
    float scale, bf16* __restrict__ o, float* __restrict__ l_out,
    float* __restrict__ m_out) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);           // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                         // [2][BK][LD]
  int* ss = reinterpret_cast<int*>(vs + 2 * BK * LD);  // [2][BK]

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const bf16* qh = q + (size_t)bh * Sq * HD;
  const bf16* kh = k + (size_t)bh * Sk * HD;
  const bf16* vh = v + (size_t)bh * Sk * HD;
  const int* skv = seg_kv + (size_t)b * Sk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = tile * BQ + warp * 16;
  const int n_tiles = Sk / BK;

  auto stage = [&](int j, int slot) {
    stage_tile<HD>(kh, j * BK, ks + slot * BK * LD);
    stage_tile<HD>(vh, j * BK, vs + slot * BK * LD);
    stage_words(skv + j * BK, ss + slot * BK);
    cp_async_commit();
  };
  stage(0, 0);

  uint32_t qa[HD / 16][4];
  load_a_frags<HD>(qh, r0, Sq, qa);
  const int* sqb = seg_q + (size_t)b * Sq;
  const int sq0 = r0 + g < Sq ? sqb[r0 + g] : 0;
  const int sq1 = r0 + g + 8 < Sq ? sqb[r0 + g + 8] : 0;

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = j & 1;
    const int* sk = ss + slot * BK;
    float s[8][4];
    dot_tile<HD>(qa, ks + slot * BK * LD, s);
    float t0 = m0, t1 = m1;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int2 kv = *reinterpret_cast<const int2*>(sk + 8 * jj + 2 * t);
      s[jj][0] = logit(s[jj][0], scale, sq0, kv.x);
      s[jj][1] = logit(s[jj][1], scale, sq0, kv.y);
      s[jj][2] = logit(s[jj][2], scale, sq1, kv.x);
      s[jj][3] = logit(s[jj][3], scale, sq1, kv.y);
      t0 = fmaxf(t0, fmaxf(s[jj][0], s[jj][1]));
      t1 = fmaxf(t1, fmaxf(s[jj][2], s[jj][3]));
    }
    t0 = quad_max(t0);
    t1 = quad_max(t1);
    // exp(-inf) = 0 on the first tile; afterwards the underflow to 0 that
    // wipes a pad row's masked sums (see the header)
    const float a0 = __expf(m0 - t0), a1 = __expf(m1 - t1);
    m0 = t0;
    m1 = t1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= a0;
      acc[d][1] *= a0;
      acc[d][2] *= a1;
      acc[d][3] *= a1;
    }
    uint32_t pa[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p0 = __expf(s[jj][0] - m0), p1 = __expf(s[jj][1] - m0);
      const float p2 = __expf(s[jj][2] - m1), p3 = __expf(s[jj][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[jj][0] = pack_bf16x2(p0, p1);
      pa[jj][1] = pack_bf16x2(p2, p3);
    }
    pv_tile<HD>(pa, vs + slot * BK * LD, acc);
    __syncthreads();  // the slot is restaged by the next iteration
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  bf16* oh = o + (size_t)bh * Sq * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
    if (r >= Sq) continue;
    const float inv = hr ? i1 : i0;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r * HD + 8 * d + 2 * t) =
          pack_bf16x2(acc[d][2 * hr] * inv, acc[d][2 * hr + 1] * inv);
    if (t == 0) {
      l_out[(size_t)bh * Sq + r] = hr ? l1 : l0;
      m_out[(size_t)bh * Sq + r] = hr ? m1 : m0;
    }
  }
}

// ---------------------------------------------------------------------------
// K15 / K16: wgmma tiles fed by TMA
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

__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}

__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
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
// j < n that the plan keeps for the block's two 64-row tiles; returns how
// many. plan: [B][n_q][n_k] bytes, 1 where the (query tile, key tile) pair
// is skipped (nullptr: keep every tile). K15 (by_key) walks query tiles j
// for key tiles t0, t0 + 1; K16 key tiles j for query tiles t0, t0 + 1. One
// warp.
__device__ __forceinline__ int tile_list(const uint8_t* __restrict__ plan, int b, int n_q,
                                         int n_k, int t0, bool by_key, int* list) {
  const int lane = threadIdx.x & 31;
  const int n = by_key ? n_q : n_k;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    bool keep = j < n;
    if (keep && plan != nullptr) {
      const uint8_t* pb = plan + (size_t)b * n_q * n_k;
      keep = by_key ? !(pb[(size_t)j * n_k + t0] && pb[(size_t)j * n_k + t0 + 1])
                    : !(pb[(size_t)t0 * n_k + j] && pb[(size_t)(t0 + 1) * n_k + j]);
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
// into rows [r0, r0 + 64) of a [.., HD] bf16 matrix.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&d)[HD / 2], bf16* __restrict__ out,
                                           int r0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = out + (size_t)(r0 + 16 * w + g + 8 * h) * HD + 2 * t;
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
    const int n = tile_list(plan, b, n_q, n_k, 2 * kb, true, list + 1);
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
    store_rows<HD>(dka, dk + base, k0 + cw * WG_ROWS);
    store_rows<HD>(dva, dv + base, k0 + cw * WG_ROWS);
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
    const int n = tile_list(plan, b, n_q, n_k, 2 * qb, false, list + 1);
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  const int n = list[0];

  if (warp < 4) {  // the producer
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int stage = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[stage], (i / STAGES - 1) & 1);
        unsigned char* st = ring + stage * SM::STAGE;
        const int j = list[1 + i];
        const int row = bh * Sk + j * WG_ROWS;
        mbar_expect_tx(&full[stage], 2 * L::BYTES + VEC);
        load_tile<HD>(st, &maps.k, row, &full[stage]);
        load_tile<HD>(st + L::BYTES, &maps.v, row, &full[stage]);
        bulk_load(st + 2 * L::BYTES, seg_kv + (size_t)b * Sk + j * WG_ROWS, VEC, &full[stage]);
      }
    }
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
    store_rows<HD>(acc, dq + (size_t)bh * Sq * HD, q0 + cw * WG_ROWS);
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, const int* sq,
               const int* skv, int B, int H, int Sq, int Sk, float scale,
               void* o, float* l, float* m, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t smem = ring_smem_bytes<HD>();
  const int err = allow_smem(k14_flash_fwd<HD>, smem, configured);
  if (err) return err;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const unsigned blocks = (unsigned)B * H * q_tiles;
  k14_flash_fwd<HD><<<blocks, NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sq, skv, H, Sq, Sk,
      q_tiles, scale, (bf16*)o, l, m);
  return (int)cudaGetLastError();
}

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
int check_launch_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  return attr.numRegs >= LAUNCH_REGS ? 0 : (int)cudaErrorInvalidConfiguration;
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

// q, k, v: [B, H, Sq|Sk, hd] bf16 contiguous; seg_q [B, Sq], seg_kv [B, Sk]
// int32; Sk a multiple of 64 (the wrapper asks the library's 128); o [B, H,
// Sq, hd] bf16, l and m [B, H, Sq] f32.
extern "C" int bsr_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, const int* seg_q,
                                       const int* seg_kv, int B, int H, int Sq,
                                       int Sk, int hd, float scale, void* o,
                                       float* l, float* m, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_fwd<16>(q, k, v, seg_q, seg_kv, B, H, Sq, Sk, scale, o, l, m, stream);
    case 32: return launch_fwd<32>(q, k, v, seg_q, seg_kv, B, H, Sq, Sk, scale, o, l, m, stream);
    case 64: return launch_fwd<64>(q, k, v, seg_q, seg_kv, B, H, Sq, Sk, scale, o, l, m, stream);
    case 128: return launch_fwd<128>(q, k, v, seg_q, seg_kv, B, H, Sq, Sk, scale, o, l, m, stream);
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
