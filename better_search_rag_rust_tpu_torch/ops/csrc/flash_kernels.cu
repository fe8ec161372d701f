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
//   K15: p = exp(s - m) * (1 / l) from the forward's l and m; dv = bf16(p)^T
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
// FMAs), which at hd 64 is a real share of the time.
//
// DESIGN. A simple, right kernel first: mma.sync m16n8k16 (bf16 in, f32
// accumulated in the instruction; wgmma, TMA and warp specialisation are
// later work). K8's fragment routines (attention_kernels.cu) in the same
// layouts, copied here since each source builds into a library of its own.
//   K14 / K16: a block per (b, h, 64 query rows), 4 warps of 16 rows. A
//   warp's q (and, in K16, do) go from global memory straight into mma A
//   fragments once. Key and value tiles of 64 stream through a two-slab
//   cp.async ring in shared memory (pitch hd + 8: the 8 rows of an ldmatrix
//   fall in 8 distinct 16-byte bank groups), the copy of tile j + 1 in
//   flight while tile j is multiplied, with the tile's 64 kv segment ids
//   beside them. The logits stay in registers; their C fragments repack as
//   the A fragments of the next product (bf16(p) . V in K14, bf16(ds) . K
//   in K16), V and K read transposed by ldmatrix.trans. K14 keeps the
//   running max and sum of its two rows per thread in registers (the sum
//   per thread, reduced over the quad once at the end). No [S, S] tensor
//   exists anywhere, so S is bounded by the grid, not by K8's MAX_S.
//   K15: a block per (b, h, 64 keys), 4 warps of 16 keys; the keys are the
//   M rows (s^T = K Q^T). The block's K and V stay in shared memory; q, do
//   and each 64-query tile's l, m, di and segment ids stream through a
//   two-slab ring. dk and dv accumulate in f32 registers over every query
//   tile.
//   Exponentials are __expf (ex2.approx of x * log2 e): exp(-huge) is 0
//   and exp(0) is 1 exactly, which the segment rule needs.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrapper raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows of a K14 / K16 block, and of a K15 query tile
constexpr int BK = 64;        // keys of a K14 / K16 key tile, and of a K15 block
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

// A fragments of the warp's 16 rows of a staged tile (pitch HD + 8), one
// k16 step of d: matrices (rows 0-7 | 8-15 by lane bit 3, d 0-7 | 8-15 by
// lane bit 4) are a[0], a[1], a[2], a[3].
template <int HD>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int ks) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (row0 + (lane & 15)) * LD + ((lane >> 4) << 3) + 16 * ks);
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

// dot_tile with the warp's A rows read from a staged tile `at` (rows row0
// .. row0 + 15) instead of registers.
template <int HD>
__device__ __forceinline__ void dot_tile_smem_a(const bf16* at, int row0,
                                                const bf16* xb,
                                                float (&acc)[8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const bf16* base =
      xb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldsm_a<HD>(a, at, row0, ks);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, base + 16 * p * LD + 16 * ks);
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
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

// Bytes of a K14 / K16 block's shared memory: a two-slab ring of K and V
// tiles [64][HD + 8] bf16 and their 64 kv segment ids.
template <int HD>
constexpr size_t ring_smem_bytes() {
  return 2 * (2 * (size_t)BK * (HD + 8) * 2 + BK * 4);
}

// Bytes of a K15 block's: its K and V [64][HD + 8], then a two-slab ring of
// q and do tiles and the tile's l, m, di and q segment ids (64 words each).
template <int HD>
constexpr size_t dkv_smem_bytes() {
  return 2 * (size_t)BK * (HD + 8) * 2 + 2 * (2 * (size_t)BQ * (HD + 8) * 2 + 4 * BQ * 4);
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
// K15: dk and dv
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT) k15_flash_bwd_dkv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, const float* __restrict__ l_in,
    const float* __restrict__ m_in, const bf16* __restrict__ dout,
    const float* __restrict__ di, int H, int Sq, int Sk, int k_tiles,
    float scale, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kt = reinterpret_cast<bf16*>(smem);   // [BK][LD]
  bf16* vt = kt + BK * LD;                     // [BK][LD]
  bf16* qs = vt + BK * LD;                     // [2][BQ][LD]
  bf16* ds_ = qs + 2 * BQ * LD;                // [2][BQ][LD] (do)
  float* st = reinterpret_cast<float*>(ds_ + 2 * BQ * LD);  // [2][4][BQ]

  const int tile = blockIdx.x % k_tiles;
  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H;
  const int k0 = tile * BK;
  const bf16* qh = q + (size_t)bh * Sq * HD;
  const bf16* doh = dout + (size_t)bh * Sq * HD;
  const float* lh = l_in + (size_t)bh * Sq;
  const float* mh = m_in + (size_t)bh * Sq;
  const float* dih = di + (size_t)bh * Sq;
  const int* sqb = seg_q + (size_t)b * Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = Sq / BQ;

  stage_tile<HD>(k + (size_t)bh * Sk * HD, k0, kt);
  stage_tile<HD>(v + (size_t)bh * Sk * HD, k0, vt);
  auto stage = [&](int j, int slot) {
    stage_tile<HD>(qh, j * BQ, qs + slot * BQ * LD);
    stage_tile<HD>(doh, j * BQ, ds_ + slot * BQ * LD);
    float* sl = st + slot * 4 * BQ;
    stage_words(lh + j * BQ, sl);
    stage_words(mh + j * BQ, sl + BQ);
    stage_words(dih + j * BQ, sl + 2 * BQ);
    stage_words(sqb + j * BQ, sl + 3 * BQ);
    cp_async_commit();
  };
  stage(0, 0);  // one group with the block's K and V

  const int* skb = seg_kv + (size_t)b * Sk + k0 + warp * 16;
  const int sk0 = skb[g], sk1 = skb[g + 8];

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
    dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      stage(j + 1, (j + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int slot = j & 1;
    const bf16* qb = qs + slot * BQ * LD;
    const bf16* db = ds_ + slot * BQ * LD;
    const float* sl = st + slot * 4 * BQ;
    const int* sqt = reinterpret_cast<const int*>(sl + 3 * BQ);

    // p^T: rows are the warp's keys g, g + 8, columns queries 8jj + 2t, + 1
    float p[8][4];
    dot_tile_smem_a<HD>(kt, warp * 16, qb, p);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * t;
      const float2 lq = *reinterpret_cast<const float2*>(sl + c);
      const float2 mq = *reinterpret_cast<const float2*>(sl + BQ + c);
      const int2 sq = *reinterpret_cast<const int2*>(sqt + c);
      const float il0 = __frcp_rn(lq.x), il1 = __frcp_rn(lq.y);
      p[jj][0] = __fmul_rn(__expf(logit(p[jj][0], scale, sq.x, sk0) - mq.x), il0);
      p[jj][1] = __fmul_rn(__expf(logit(p[jj][1], scale, sq.y, sk0) - mq.y), il1);
      p[jj][2] = __fmul_rn(__expf(logit(p[jj][2], scale, sq.x, sk1) - mq.x), il0);
      p[jj][3] = __fmul_rn(__expf(logit(p[jj][3], scale, sq.y, sk1) - mq.y), il1);
    }
    {  // dv += bf16(p)^T do
      uint32_t pa[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        pa[jj][0] = pack_bf16x2(p[jj][0], p[jj][1]);
        pa[jj][1] = pack_bf16x2(p[jj][2], p[jj][3]);
      }
      pv_tile<HD>(pa, db, dva);
    }
    // dp^T = V do^T, then ds^T = (dp^T - di) * p^T * scale
    float dp[8][4];
    dot_tile_smem_a<HD>(vt, warp * 16, db, dp);
    uint32_t sa[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 dd = *reinterpret_cast<const float2*>(sl + 2 * BQ + 8 * jj + 2 * t);
      const float e0 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][0], dd.x), p[jj][0]), scale);
      const float e1 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][1], dd.y), p[jj][1]), scale);
      const float e2 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][2], dd.x), p[jj][2]), scale);
      const float e3 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][3], dd.y), p[jj][3]), scale);
      sa[jj][0] = pack_bf16x2(e0, e1);
      sa[jj][1] = pack_bf16x2(e2, e3);
    }
    pv_tile<HD>(sa, qb, dka);  // dk += bf16(ds)^T q
    __syncthreads();  // the slot is restaged by the next iteration
  }

  const size_t base = (size_t)bh * Sk * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = k0 + warp * 16 + g + 8 * hr;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const size_t at = base + (size_t)r * HD + 8 * d + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16x2(dka[d][2 * hr], dka[d][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16x2(dva[d][2 * hr], dva[d][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K16: dq
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NT) k16_flash_bwd_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg_q,
    const int* __restrict__ seg_kv, const float* __restrict__ l_in,
    const float* __restrict__ m_in, const bf16* __restrict__ dout,
    const float* __restrict__ di, int H, int Sq, int Sk, int q_tiles,
    float scale, bf16* __restrict__ dq) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);           // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                         // [2][BK][LD]
  int* ss = reinterpret_cast<int*>(vs + 2 * BK * LD);  // [2][BK]

  const int tile = blockIdx.x % q_tiles;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
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

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_a_frags<HD>(q + (size_t)bh * Sq * HD, r0, Sq, qa);
  load_a_frags<HD>(dout + (size_t)bh * Sq * HD, r0, Sq, da);
  const size_t row = (size_t)bh * Sq + r0 + g;
  const int sq0 = seg_q[(size_t)b * Sq + r0 + g];
  const int sq1 = seg_q[(size_t)b * Sq + r0 + g + 8];
  const float mr0 = m_in[row], mr1 = m_in[row + 8];
  const float il0 = __frcp_rn(l_in[row]), il1 = __frcp_rn(l_in[row + 8]);
  const float di0 = di[row], di1 = di[row + 8];

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
    const bf16* kb = ks + slot * BK * LD;
    const int* sk = ss + slot * BK;
    float p[8][4], dp[8][4];
    dot_tile<HD>(qa, kb, p);
    dot_tile<HD>(da, vs + slot * BK * LD, dp);
    uint32_t sa[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int2 kv = *reinterpret_cast<const int2*>(sk + 8 * jj + 2 * t);
      const float p0 = __fmul_rn(__expf(logit(p[jj][0], scale, sq0, kv.x) - mr0), il0);
      const float p1 = __fmul_rn(__expf(logit(p[jj][1], scale, sq0, kv.y) - mr0), il0);
      const float p2 = __fmul_rn(__expf(logit(p[jj][2], scale, sq1, kv.x) - mr1), il1);
      const float p3 = __fmul_rn(__expf(logit(p[jj][3], scale, sq1, kv.y) - mr1), il1);
      const float e0 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][0], di0), p0), scale);
      const float e1 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][1], di0), p1), scale);
      const float e2 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][2], di1), p2), scale);
      const float e3 = __fmul_rn(__fmul_rn(__fsub_rn(dp[jj][3], di1), p3), scale);
      sa[jj][0] = pack_bf16x2(e0, e1);
      sa[jj][1] = pack_bf16x2(e2, e3);
    }
    pv_tile<HD>(sa, kb, acc);  // dq += bf16(ds) k
    __syncthreads();  // the slot is restaged by the next iteration
  }

  bf16* dqh = dq + (size_t)bh * Sq * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + g + 8 * hr;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dqh + (size_t)r * HD + 8 * d + 2 * t) =
          pack_bf16x2(acc[d][2 * hr], acc[d][2 * hr + 1]);
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

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const int* sq,
               const int* skv, const float* l, const float* m, const void* dout,
               const float* di, int B, int H, int Sq, int Sk, float scale,
               void* dk, void* dv, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t smem = dkv_smem_bytes<HD>();
  const int err = allow_smem(k15_flash_bwd_dkv<HD>, smem, configured);
  if (err) return err;
  const int k_tiles = Sk / BK;
  const unsigned blocks = (unsigned)B * H * k_tiles;
  k15_flash_bwd_dkv<HD><<<blocks, NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sq, skv, l, m,
      (const bf16*)dout, di, H, Sq, Sk, k_tiles, scale, (bf16*)dk, (bf16*)dv);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const int* sq,
              const int* skv, const float* l, const float* m, const void* dout,
              const float* di, int B, int H, int Sq, int Sk, float scale,
              void* dq, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t smem = ring_smem_bytes<HD>();
  const int err = allow_smem(k16_flash_bwd_dq<HD>, smem, configured);
  if (err) return err;
  const int q_tiles = Sq / BQ;
  const unsigned blocks = (unsigned)B * H * q_tiles;
  k16_flash_bwd_dq<HD><<<blocks, NT, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, sq, skv, l, m,
      (const bf16*)dout, di, H, Sq, Sk, q_tiles, scale, (bf16*)dq);
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

// The forward's operands plus l, m, do [B, H, Sq, hd] bf16 and di [B, H, Sq]
// f32; Sq and Sk multiples of 64. dk, dv: [B, H, Sk, hd] bf16.
extern "C" int bsr_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const int* seg_q,
    const int* seg_kv, const float* l, const float* m, const void* dout,
    const float* di, int B, int H, int Sq, int Sk, int hd, float scale,
    void* dk, void* dv, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dkv<16>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dk, dv, stream);
    case 32: return launch_dkv<32>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dk, dv, stream);
    case 64: return launch_dkv<64>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dk, dv, stream);
    case 128: return launch_dkv<128>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dk, dv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As bsr_flash_attention_bwd_dkv; dq: [B, H, Sq, hd] bf16.
extern "C" int bsr_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const int* seg_q,
    const int* seg_kv, const float* l, const float* m, const void* dout,
    const float* di, int B, int H, int Sq, int Sk, int hd, float scale,
    void* dq, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_dq<16>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dq, stream);
    case 32: return launch_dq<32>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dq, stream);
    case 64: return launch_dq<64>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dq, stream);
    case 128: return launch_dq<128>(q, k, v, seg_q, seg_kv, l, m, dout, di, B, H, Sq, Sk, scale, dq, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bsr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
