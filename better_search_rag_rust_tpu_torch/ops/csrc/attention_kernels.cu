// Fused rotary + softmax attention for Hopper (sm_90a), plain C interface.
//
//   K8 bsr_fused_attention_qkv     <- fused_attention_qkv
//      (better_search_rag_rust_tpu/ops/attention_pallas.py:177, body :140)
//   K9 bsr_fused_attention_qkv_bwd <- _fused_qkv_bwd
//      (better_search_rag_rust_tpu/ops/attention_pallas.py:290, body :214)
//   K7 bsr_fused_attention         <- fused_attention
//      (better_search_rag_rust_tpu/ops/attention_pallas.py:95, body :63)
//
// K8 — WHAT IT COMPUTES. For each batch row b and head h, straight off the
// Wqkv projection output qkv [B, S, 3*H*hd] bf16 (q, k and v of head h at
// lane offsets (0*H+h)*hd, (1*H+h)*hd and (2*H+h)*hd of a row):
//   1. rotary in f32: x*cos2 + roll(x, hd/2)*s2, rounded once to bf16
//      (cos2 = [cos, cos], s2 = [-sin, sin]: NeoX rotate-halves);
//   2. logits = f32(q_rot . k_rot) * scale + bias[b]   (f32);
//   3. m = row max; e = exp(logits - m) (f32); denom = sum of the f32 e;
//   4. ctx = bf16(e) . v, accumulated in f32;
//   5. out[b, s, h*hd : (h+1)*hd] = bf16(ctx / denom).
// The denominator sums the f32 e while AV takes the bf16-rounded e, and the
// normalization comes after AV: both exactly as the TPU kernel does. A query
// row whose keys are all padded (bias -1e9 everywhere) has m ~ -1e9, every
// e = 1 and stays finite.
//
// K8 — WHAT BOUNDS IT. 4*S*hd FLOP per query row per head (QK^T and PV):
// at the encoder's shape (B = 256, S = 512, H = 12, hd = 64) 206 GFLOP per
// call, 0.208 ms at the bf16 tensor rate (989 TFLOP/s), against 604 MB of
// qkv in and 201 MB of context out, 0.241 ms at 3.35 TB/s: bytes-bound, near
// the ridge. The design below does three products (309 GFLOP) on mma.sync,
// an exponential per logit (S*S per head) and, with 16 query rows per warp,
// reads every K and V fragment from shared memory once per warp and product;
// each warp's chain (QK^T, softmax, PV) is serial, so what bounds it on the
// card is latency, hidden by 16 warps per SM (bench/ab_attn.py).
//
// K8 — DESIGN. A block per (b, h). K is staged with cp.async, rotated once
// in shared memory as bf16 (pitch hd + 8: the 8 rows of an ldmatrix fall in
// 8 distinct 16-byte bank groups) and stays there with V staged whole
// beside it, while 16 warps walk every query tile of the head without a
// barrier: each key's rotary is computed once per (b, h). That holds where
// both fit (hd <= 32 at every S, hd 64 with S <= 784: the encoder's case);
// elsewhere (hd 64 above that, hd 128) K and V stream through rings of two
// cp.async tiles whose copy of tile j + 1 overlaps the products of tile j,
// stepped through by 8 warps together (two blocks per SM below hd 128),
// and each pass rotates each K tile as it lands. A warp owns 16 query rows;
// their rotated q goes from global memory straight into mma A fragments
// (the rotary partner of each lane a thread holds is held by the same
// thread). Two passes over the keys, QK^T on mma.sync m16n8k16 (bf16 in,
// each k16 step from +0.0 and added to the dot with one rounded add, d
// increasing) in both: pass 1 takes the exact row max over all S keys;
// pass 2 recomputes the same logits bit for bit, takes e = exp(l - m) in
// f32, sums the unrounded e, and repacks bf16(e) from the accumulator
// fragments straight into the A fragments of bf16(e) . V (FlashAttention-2's
// register reuse), V's B fragments by ldmatrix.trans, PV accumulated in the
// instruction. The exponential is the accurate expf: __expf (ex2.approx) is
// 9 % faster but, against a float64 evaluation of the function, leaves 5 %
// more outputs off by one bf16 step (bench/ab_attn.py, @fastexp). Every
// rounding point is the TPU kernel's; an
// online softmax, which rounds e against a partial max, is a different
// function. Keys at or past S get e = 0 and zero V rows (S % 16 == 8 leaves
// half of the last k16 step empty; an n8 tile of keys is wholly valid or
// wholly past S since S % 8 == 0); query rows at or past S run on zero q and
// are not stored. Three products rather than two: keeping the [rows, S] f32
// logits in shared memory for the max (the SIMT design's way) reads as many
// shared-memory bytes per logit as recomputing them, and at 32 KB per 16
// rows at S 512 leaves room for at most 7 warps on an SM.
//
// K7 — K8 on head-major operands: q, k and v are three [B, H, S, hd] bf16
// tensors and the context is [B, H, S, hd]. Both run one body (attend) with
// their own pointers and row strides, so K7 on the transposed Wqkv output
// equals K8 bit for bit. Forward only: the TPU kernel has no backward.
//
// K9 — WHAT IT COMPUTES. The gradient of K8 with respect to qkv, given
// g = d ctx [B, S, H*hd] bf16, with no residual beyond K8's inputs: the
// softmax is recomputed. Per (b, h), rounding where the TPU kernel rounds:
// q_r, k_r as in K8; f32 logits; p = exp(l - m) / sum (f32, normalized
// BEFORE the products, unlike the forward); dv = bf16(p)^T g; dp = g v^T
// (f32); row = sum(dp * p); ds = bf16(p * (dp - row) * scale);
// dq_r = ds k_r and dk_r = ds^T q_r (f32); then the rotary adjoint
// x*cos2 + roll(x*s2, hd/2) and one rounding to bf16. dqkv has qkv's
// [q heads | k heads | v heads] layout.
//
// K9 — WHAT BOUNDS IT. Five products of S*S*hd per head against K8's two;
// the design below recomputes three of them (eight in all), all SIMT FP32:
// compute-bound, ~2.5x the forward's FLOPs per call at the same shape.
//
// K9 — DESIGN. Two kernels, FlashAttention-2 style, deterministic, no
// atomics. (a) k9_bwd_query: a block per (b, h, 32 query rows) holds the
// tile's [32, S] f32 logits in shared memory, takes the exact row
// max m and l = sum(e), turns the tile into p, forms row = sum(dp * p) over
// a pass of V tiles, then a second pass over V and K tiles recomputes dp,
// writes ds over p in place and accumulates dq_r in registers. The tile
// holds every key, so dq is complete there. m, l and row go to a
// [3, B, H, S] f32 scratch. dp is recomputed rather than stored: a second
// [32, S] tile would not fit at S = 1024. (b) k9_bwd_key: a block per
// (b, h, 32 keys) keeps k_r and v of its keys in shared memory and walks
// every 32-row query tile: it recomputes the logits and p from the stored
// m and l, dp, ds, then accumulates dv and dk_r in registers.
// p in (b) must equal p in (a) bit for bit, or bf16(p) and ds would drift
// between dq and dk/dv: both passes take each logit as one fmaf chain over
// d from 0 up, the same __fmul_rn / __fadd_rn epilogue, expf (not __expf) of
// an exact subtraction and an IEEE __fdiv_rn by the stored f32 sum; dp is
// one fmaf chain likewise, and row is read, not recomputed.
//
// The rotary, the logit epilogues and the softmax-gradient algebra use
// __fmul_rn / __fadd_rn / __fsub_rn so the compiler does not contract them
// into FMAs: the plain PyTorch version rounds each product and sum, and so
// do these kernels.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrapper raises on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 32;        // query rows per block
constexpr int KT = 64;        // keys per K / V tile
constexpr int NT = 256;       // threads per block, 16 (tx) x 16 (ty)
constexpr int MAX_S = 1024;   // longest sequence whose logits tile fits

static_assert(TQ == 32 && KT == 64 && NT == 256,
              "the micro-tiles below assume 16 x 16 threads, 2 rows x 4 keys");

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared-memory pitch (floats) of the [TQ, S] logits tile: a multiple of 4
// (float4 reads) that is 16 mod 32, so the two rows a warp writes land in
// disjoint banks.
__host__ __device__ __forceinline__ int logits_pitch(int S) {
  return ((S + 31) / 32) * 32 + 16;
}

// N consecutive floats from shared memory, 16 or 8 bytes at a time.
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + k);
      v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + k);
      v[k] = t.x; v[k + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = p[k];
  }
}

// Rows [s0, s0 + rows) of one head's q or k (lane offset `col` in the qkv
// row) into dst[r][d] (pitch HD + 4) as f32: rotary in f32 from the bf16
// input, one rounding to bf16, widened back. One work item covers lanes
// j, j+1 and their partners j + HD/2, j + HD/2 + 1. Rows at or past S are 0.
template <int HD>
__device__ void load_rotated(const __nv_bfloat16* __restrict__ base,
                             int row_stride, int col,
                             const float* __restrict__ cos2,
                             const float* __restrict__ s2, int s0, int rows,
                             int S, float* __restrict__ dst) {
  constexpr int H2 = HD / 2;
  constexpr int PAIRS = H2 / 2;
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < rows * PAIRS; idx += NT) {
    const int r = idx / PAIRS;
    const int j = (idx % PAIRS) * 2;
    const int s = s0 + r;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
    if (s < S) {
      const __nv_bfloat16* x = base + (size_t)s * row_stride + col;
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(x + j);
      const __nv_bfloat162 hi =
          *reinterpret_cast<const __nv_bfloat162*>(x + j + H2);
      const float x0 = __low2float(lo), x1 = __high2float(lo);
      const float y0 = __low2float(hi), y1 = __high2float(hi);
      const float* c = cos2 + (size_t)s * HD;
      const float* sn = s2 + (size_t)s * HD;
      // roll(x, HD/2) brings lane j + HD/2 to lane j and lane j to j + HD/2.
      o0 = bf16_round(__fadd_rn(__fmul_rn(x0, c[j]), __fmul_rn(y0, sn[j])));
      o1 = bf16_round(
          __fadd_rn(__fmul_rn(x1, c[j + 1]), __fmul_rn(y1, sn[j + 1])));
      o2 = bf16_round(
          __fadd_rn(__fmul_rn(y0, c[j + H2]), __fmul_rn(x0, sn[j + H2])));
      o3 = bf16_round(__fadd_rn(__fmul_rn(y1, c[j + H2 + 1]),
                                __fmul_rn(x1, sn[j + H2 + 1])));
    }
    float* d = dst + r * LD;
    d[j] = o0;
    d[j + 1] = o1;
    d[j + H2] = o2;
    d[j + H2 + 1] = o3;
  }
}

// Rows [s0, s0 + rows) of one head's v into dst[r][d] as f32 (exact).
template <int HD>
__device__ void load_plain(const __nv_bfloat16* __restrict__ base,
                           int row_stride, int col, int s0, int rows, int S,
                           float* __restrict__ dst) {
  constexpr int PAIRS = HD / 2;
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < rows * PAIRS; idx += NT) {
    const int r = idx / PAIRS;
    const int j = (idx % PAIRS) * 2;
    const int s = s0 + r;
    float a = 0.f, b = 0.f;
    if (s < S) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          base + (size_t)s * row_stride + col + j);
      a = __low2float(v);
      b = __high2float(v);
    }
    dst[r * LD + j] = a;
    dst[r * LD + j + 1] = b;
  }
}

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

// ---------------------------------------------------------------------------
// K9: the recompute backward
// ---------------------------------------------------------------------------

constexpr int TK = 32;        // keys per k9_bwd_key block
constexpr int PP = TK + 16;   // pitch of its [TQ, TK] p / ds tiles: the two
                              // rows a warp writes land in disjoint banks

__device__ __forceinline__ float logit_of(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

__device__ __forceinline__ float ds_of(float p, float dp, float row,
                                       float scale) {
  return bf16_round(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale));
}

// dst[r][d] (pitch HD + 4) holds rows [s0, s0 + rows) of dx_rot in f32; write
// bf16(dx_rot * cos2 + roll(dx_rot * s2, HD/2)) to lanes col.. of those rows
// of dqkv (the rotary's adjoint, at each row's own position).
template <int HD>
__device__ void store_rotary_adjoint(const float* __restrict__ src,
                                     const float* __restrict__ cos2,
                                     const float* __restrict__ s2, int s0,
                                     int rows, int S,
                                     __nv_bfloat16* __restrict__ out,
                                     int row_stride, int col) {
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < rows * HD; idx += NT) {
    const int r = idx / HD;
    const int j = idx % HD;
    const int s = s0 + r;
    if (s < S) {
      const int jp = (j + HD / 2) % HD;
      const float v = __fadd_rn(__fmul_rn(src[r * LD + j], cos2[s * HD + j]),
                                __fmul_rn(src[r * LD + jp], s2[s * HD + jp]));
      out[(size_t)s * row_stride + col + j] = __float2bfloat16_rn(v);
    }
  }
}

template <int HD>
__host__ __device__ __forceinline__ size_t k9a_smem_bytes(int S) {
  constexpr int LD = HD + 4;
  return sizeof(float) * ((size_t)2 * TQ * LD + (size_t)KT * LD +
                          (size_t)TQ * logits_pitch(S) + 3 * TQ);
}

template <int HD>
__host__ __device__ __forceinline__ size_t k9b_smem_bytes() {
  constexpr int LD = HD + 4;
  return sizeof(float) * ((size_t)2 * TK * LD + (size_t)2 * TQ * LD +
                          (size_t)2 * TQ * PP + 3 * TQ);
}

// 2 x 4 micro-tile of a [TQ] x [KT] product: rows ty, ty + 16 of A against
// rows tx + 16j of Bm, each entry one fmaf chain over d from 0 up.
template <int HD>
__device__ __forceinline__ void dot_tile(const float* __restrict__ A,
                                         const float* __restrict__ Bm, int ty,
                                         int tx, float (&acc)[2][4]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[2], bv[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// Pass (a): a block per (b, h, TQ query rows). Writes dq and the row
// statistics m, l, row to stats [3][B*H*S].
template <int HD>
__global__ void __launch_bounds__(NT, 2)
    k9_bwd_query(const __nv_bfloat16* __restrict__ qkv,
                 const float* __restrict__ cos2, const float* __restrict__ s2,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ g, int S, int H,
                 float scale, float* __restrict__ stats,
                 __nv_bfloat16* __restrict__ dqkv) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  const int SP = logits_pitch(S);
  float* Qs = smem;              // [TQ][LD] rotated q
  float* Gs = Qs + TQ * LD;      // [TQ][LD] g, then dq_rot
  float* KVs = Gs + TQ * LD;     // [KT][LD] rotated k or v
  float* Ls = KVs + KT * LD;     // [TQ][SP] logits, then p, then ds
  float* Mr = Ls + TQ * SP;      // [TQ] row max
  float* Lr = Mr + TQ;           // [TQ] sum of e
  float* Dr = Lr + TQ;           // [TQ] row = sum(dp * p)

  const int nqt = (S + TQ - 1) / TQ;
  const int qt = blockIdx.x % nqt;
  const int h = (blockIdx.x / nqt) % H;
  const int b = blockIdx.x / (nqt * H);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row_stride = 3 * H * HD;
  const int g_stride = H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const __nv_bfloat16* gbase = g + (size_t)b * S * g_stride;
  const float* brow = bias + (size_t)b * S;
  const int q0 = qt * TQ;

  load_rotated<HD>(base, row_stride, (0 * H + h) * HD, cos2, s2, q0, TQ, S,
                   Qs);
  load_plain<HD>(gbase, g_stride, h * HD, q0, TQ, S, Gs);

  // Logits of the tile against every key, into Ls (K8's pass 1).
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();
    load_rotated<HD>(base, row_stride, (1 * H + h) * HD, cos2, s2, k0, KT, S,
                     KVs);
    __syncthreads();
    float acc[2][4];
    dot_tile<HD>(Qs, KVs, ty, tx, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      if (t < S) {
        const float bt = brow[t];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          Ls[(ty + 16 * i) * SP + t] = logit_of(acc[i][j], scale, bt);
      }
    }
  }
  __syncthreads();

  // Row pass, one warp per TQ/8 rows: exact max, l = f32 sum of e, and
  // p = e / l in place. The butterfly leaves m and l equal on every lane.
  {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    for (int rr = 0; rr < TQ / 8; ++rr) {
      const int r = warp * (TQ / 8) + rr;
      float* L = Ls + r * SP;
      float m = -INFINITY;
      for (int t = lane; t < S; t += 32) m = fmaxf(m, L[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
      for (int t = lane; t < S; t += 32) {
        const float e = expf(__fsub_rn(L[t], m));
        sum += e;
        L[t] = e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int t = lane; t < S; t += 32) L[t] = __fdiv_rn(L[t], sum);
      if (lane == 0) {
        Mr[r] = m;
        Lr[r] = sum;
      }
    }
  }

  // row = sum over keys of dp * p, dp = g . v; each thread sums its keys,
  // then the 16 threads of a row (one half-warp) reduce.
  float racc[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the row pass is done / the previous V tile consumed
    load_plain<HD>(base, row_stride, (2 * H + h) * HD, k0, KT, S, KVs);
    __syncthreads();
    float dp[2][4];
    dot_tile<HD>(Gs, KVs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      if (t < S) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          racc[i] = __fadd_rn(racc[i],
                              __fmul_rn(dp[i][j], Ls[(ty + 16 * i) * SP + t]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], off);
    if (tx == 0) Dr[ty + 16 * i] = racc[i];
  }

  // ds over p in place, tile by tile, then dq_rot += ds . k_rot.
  float dq[2][DPT] = {};
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // Dr is written / the previous K tile is consumed
    load_plain<HD>(base, row_stride, (2 * H + h) * HD, k0, KT, S, KVs);
    __syncthreads();
    float dp[2][4];
    dot_tile<HD>(Gs, KVs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      if (t < S) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = ty + 16 * i;
          Ls[r * SP + t] = ds_of(Ls[r * SP + t], dp[i][j], Dr[r], scale);
        }
      }
    }
    __syncthreads();  // ds of the tile written, V consumed
    load_rotated<HD>(base, row_stride, (1 * H + h) * HD, cos2, s2, k0, KT, S,
                     KVs);
    __syncthreads();
    const int kv = min(KT, S - k0);  // a multiple of 8 (S % 8 == 0)
    for (int t = 0; t < kv; t += 4) {
      float4 w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w[i] = *reinterpret_cast<const float4*>(Ls + (ty + 16 * i) * SP +
                                                k0 + t);
      const float wv[2][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                              {w[1].x, w[1].y, w[1].z, w[1].w}};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float k[DPT];
        lds<DPT>(KVs + (t + u) * LD + tx * DPT, k);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd)
            dq[i][dd] = fmaf(wv[i][u], k[dd], dq[i][dd]);
      }
    }
  }

  // Epilogue: dq through the rotary adjoint; the row statistics.
  __syncthreads();  // g is no longer read: Gs takes dq_rot
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      Gs[(ty + 16 * i) * LD + tx * DPT + dd] = dq[i][dd];
  __syncthreads();
  store_rotary_adjoint<HD>(Gs, cos2, s2, q0, TQ, S,
                           dqkv + (size_t)b * S * row_stride, row_stride,
                           (0 * H + h) * HD);
  if (tid < TQ && q0 + tid < S) {
    const size_t bhs = (size_t)(gridDim.x / nqt) * S;
    const size_t at = ((size_t)b * H + h) * S + q0 + tid;
    stats[at] = Mr[tid];
    stats[bhs + at] = Lr[tid];
    stats[2 * bhs + at] = Dr[tid];
  }
}

// Pass (b): a block per (b, h, TK keys). Walks every query tile, recomputes
// p from the stored m and l, and writes dk and dv. At HD = 128 its dk and dv
// accumulators need more than the 128 registers two blocks per SM allow.
template <int HD>
__global__ void __launch_bounds__(NT, HD >= 128 ? 1 : 2)
    k9_bwd_key(const __nv_bfloat16* __restrict__ qkv,
               const float* __restrict__ cos2, const float* __restrict__ s2,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ g, int S, int H, float scale,
               const float* __restrict__ stats,
               __nv_bfloat16* __restrict__ dqkv) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;
  static_assert(TK == TQ, "dk_rot reuses the [TQ][LD] q tile");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // [TK][LD] rotated k of the block's keys
  float* Vs = Ks + TK * LD;      // [TK][LD] v
  float* Qs = Vs + TK * LD;      // [TQ][LD] rotated q of a query tile
  float* Gs = Qs + TQ * LD;      // [TQ][LD] g of a query tile
  float* Ps = Gs + TQ * LD;      // [TQ][PP] bf16(p)
  float* Ds = Ps + TQ * PP;      // [TQ][PP] ds
  float* Mq = Ds + TQ * PP;      // [TQ] m, l, row of the query tile
  float* Lq = Mq + TQ;
  float* Rq = Lq + TQ;

  const int nkt = (S + TK - 1) / TK;
  const int kt = blockIdx.x % nkt;
  const int h = (blockIdx.x / nkt) % H;
  const int b = blockIdx.x / (nkt * H);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row_stride = 3 * H * HD;
  const int g_stride = H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const __nv_bfloat16* gbase = g + (size_t)b * S * g_stride;
  const size_t bhs = (size_t)(gridDim.x / nkt) * S;
  const float* st = stats + ((size_t)b * H + h) * S;
  const int k0 = kt * TK;

  load_rotated<HD>(base, row_stride, (1 * H + h) * HD, cos2, s2, k0, TK, S,
                   Ks);
  load_plain<HD>(base, row_stride, (2 * H + h) * HD, k0, TK, S, Vs);
  float bk[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = k0 + tx + 16 * j;
    bk[j] = t < S ? bias[(size_t)b * S + t] : 0.f;
  }

  float dk[2][DPT] = {}, dv[2][DPT] = {};
  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();  // the previous query tile is consumed
    load_rotated<HD>(base, row_stride, (0 * H + h) * HD, cos2, s2, q0, TQ, S,
                     Qs);
    load_plain<HD>(gbase, g_stride, h * HD, q0, TQ, S, Gs);
    if (tid < TQ) {
      const bool in = q0 + tid < S;
      Mq[tid] = in ? st[q0 + tid] : 0.f;
      Lq[tid] = in ? st[bhs + q0 + tid] : 1.f;
      Rq[tid] = in ? st[2 * bhs + q0 + tid] : 0.f;
    }
    __syncthreads();

    // logits and dp for rows ty, ty + 16 and keys tx, tx + 16: one fmaf
    // chain per entry over d from 0 up, as in pass (a).
    float sacc[2][2] = {}, pacc[2][2] = {};
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 q[2], gq[2], k[2], v[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        q[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
        gq[i] = *reinterpret_cast<const float4*>(Gs + (ty + 16 * i) * LD + d);
        k[i] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * i) * LD + d);
        v[i] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * i) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sacc[i][j] = fmaf(q[i].x, k[j].x, sacc[i][j]);
          sacc[i][j] = fmaf(q[i].y, k[j].y, sacc[i][j]);
          sacc[i][j] = fmaf(q[i].z, k[j].z, sacc[i][j]);
          sacc[i][j] = fmaf(q[i].w, k[j].w, sacc[i][j]);
          pacc[i][j] = fmaf(gq[i].x, v[j].x, pacc[i][j]);
          pacc[i][j] = fmaf(gq[i].y, v[j].y, pacc[i][j]);
          pacc[i][j] = fmaf(gq[i].z, v[j].z, pacc[i][j]);
          pacc[i][j] = fmaf(gq[i].w, v[j].w, pacc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i;
        const int t = tx + 16 * j;
        float p = 0.f, ds = 0.f;
        if (q0 + r < S && k0 + t < S) {
          const float l = logit_of(sacc[i][j], scale, bk[j]);
          p = __fdiv_rn(expf(__fsub_rn(l, Mq[r])), Lq[r]);
          ds = ds_of(p, pacc[i][j], Rq[r], scale);
        }
        Ps[r * PP + t] = bf16_round(p);
        Ds[r * PP + t] = ds;
      }
    __syncthreads();

    // dv += bf16(p)^T g and dk_rot += ds^T q_rot for keys ty, ty + 16 and
    // dims tx*DPT ..
    for (int r = 0; r < TQ; ++r) {
      float gv[DPT], qv[DPT];
      lds<DPT>(Gs + r * LD + tx * DPT, gv);
      lds<DPT>(Qs + r * LD + tx * DPT, qv);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float pb = Ps[r * PP + ty + 16 * i];
        const float dsv = Ds[r * PP + ty + 16 * i];
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
          dv[i][dd] = fmaf(pb, gv[dd], dv[i][dd]);
          dk[i][dd] = fmaf(dsv, qv[dd], dk[i][dd]);
        }
      }
    }
  }

  // Epilogue: dv straight out, dk through the rotary adjoint.
  __nv_bfloat16* out = dqkv + (size_t)b * S * row_stride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s < S) {
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        out[(size_t)s * row_stride + (2 * H + h) * HD + tx * DPT + dd] =
            __float2bfloat16_rn(dv[i][dd]);
    }
  }
  __syncthreads();  // the last query tile is consumed: Qs takes dk_rot
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd)
      Qs[(ty + 16 * i) * LD + tx * DPT + dd] = dk[i][dd];
  __syncthreads();
  store_rotary_adjoint<HD>(Qs, cos2, s2, k0, TK, S, out, row_stride,
                           (1 * H + h) * HD);
}

template <int HD>
int launch_k9(const void* qkv, const float* cos2, const float* s2,
              const float* bias, const void* g, int B, int S, int H,
              float scale, float* stats, void* dqkv, cudaStream_t stream) {
  static size_t conf_a = 48 * 1024, conf_b = 48 * 1024;
  const size_t bytes_a = k9a_smem_bytes<HD>(S);
  const size_t bytes_b = k9b_smem_bytes<HD>();
  int e = allow_smem(k9_bwd_query<HD>, bytes_a, conf_a);
  if (e) return e;
  e = allow_smem(k9_bwd_key<HD>, bytes_b, conf_b);
  if (e) return e;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* gg = static_cast<const __nv_bfloat16*>(g);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  const dim3 grid_a((unsigned)B * (unsigned)H * (unsigned)((S + TQ - 1) / TQ));
  k9_bwd_query<HD><<<grid_a, NT, bytes_a, stream>>>(q, cos2, s2, bias, gg, S,
                                                    H, scale, stats, out);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 grid_b((unsigned)B * (unsigned)H * (unsigned)((S + TK - 1) / TK));
  k9_bwd_key<HD><<<grid_b, NT, bytes_b, stream>>>(q, cos2, s2, bias, gg, S, H,
                                                  scale, stats, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8 and K7: the forward on the tensor cores (see the header)
// ---------------------------------------------------------------------------

constexpr int AKN = 64;                // keys per K / V tile
constexpr size_t SMEM_OPTIN = 232448;  // an sm_90 block's dynamic shared memory

// Threads of a forward block: 16 warps that never wait on each other where
// K and V are resident (one block per SM), 8 that step through the K and V
// rings together otherwise (two blocks per SM below hd 128).
__host__ __device__ constexpr int att_threads(bool res) {
  return res ? 512 : 256;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem, or 16 zero bytes when !full (gmem is then not read).
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem,
                                                   bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(full ? 16 : 0)
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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
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

// Bytes of a forward block's shared memory: rotated K and then V, both
// resident ([S16][HD + 8] each, S16 = S rounded up to 16) or both streamed
// (a ring of two [AKN][HD + 8] tiles each), and the key bias [S16] f32.
template <int HD>
__host__ __device__ __forceinline__ size_t attn_smem_bytes(int S, bool res) {
  const size_t ld = HD + 8, s16 = (size_t)(S + 15) / 16 * 16;
  return 2 * 2 * (res ? s16 * ld : 2 * AKN * ld) + 4 * s16;
}

// Rows [s0, s0 + rows) of one head's x (rows ld_in elements apart) into
// dst[r][d] (pitch HD + 8) as bf16, one cp.async per 16 bytes; rows at or
// past S are zero-filled.
template <int HD, int NT_>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ x,
                                           int ld_in, int s0, int rows, int S,
                                           __nv_bfloat16* dst) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT_) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async16_or_zero(dst + r * LD + c, x + (size_t)(in ? s : 0) * ld_in + c,
                       in);
  }
}

// The rotary of staged rows [0, rows) (positions s0 ..) in place, with
// load_rotated's arithmetic: f32 from the bf16 input, one rounding to bf16.
// Rows at or past S stay as staged (zero).
template <int HD, int NT_>
__device__ __forceinline__ void rotate_rows(__nv_bfloat16* x, int s0, int rows,
                                            int S,
                                            const float* __restrict__ cos2,
                                            const float* __restrict__ s2) {
  constexpr int LD = HD + 8;
  constexpr int H2 = HD / 2;
  constexpr int PAIRS = H2 / 2;
  for (int i = threadIdx.x; i < rows * PAIRS; i += NT_) {
    const int r = i / PAIRS;
    const int j = (i % PAIRS) * 2;
    const int s = s0 + r;
    if (s >= S) continue;
    auto* lo = reinterpret_cast<__nv_bfloat162*>(x + r * LD + j);
    auto* hi = reinterpret_cast<__nv_bfloat162*>(x + r * LD + j + H2);
    const float2 xl = __bfloat1622float2(*lo), xh = __bfloat1622float2(*hi);
    const float* c = cos2 + (size_t)s * HD;
    const float* sn = s2 + (size_t)s * HD;
    const float2 cl = *reinterpret_cast<const float2*>(c + j);
    const float2 ch = *reinterpret_cast<const float2*>(c + j + H2);
    const float2 sl = *reinterpret_cast<const float2*>(sn + j);
    const float2 sh = *reinterpret_cast<const float2*>(sn + j + H2);
    // roll(x, HD/2) brings lane j + HD/2 to lane j and lane j to j + HD/2.
    *lo = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(xl.x, cl.x), __fmul_rn(xh.x, sl.x)),
        __fadd_rn(__fmul_rn(xl.y, cl.y), __fmul_rn(xh.y, sl.y)));
    *hi = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(xh.x, ch.x), __fmul_rn(xl.x, sh.x)),
        __fadd_rn(__fmul_rn(xh.y, ch.y), __fmul_rn(xl.y, sh.y)));
  }
}

// A fragments of rotated q for query rows r0 .. r0 + 15, straight from
// global memory, one k16 step per qa[ks]: thread (g, t) holds rows g and
// g + 8 at lanes 8u + 2t and 8u + 2t + 1 (u < HD/8), and the rotary partner
// of lane 8u + 2t is lane 8u' + 2t with u' = u + HD/16 mod HD/8 — the same
// thread's, so q needs no shared memory. Rows at or past S are zero.
template <int HD>
__device__ __forceinline__ void load_q_frags(const __nv_bfloat16* __restrict__ q,
                                             int ld_in, int r0, int S,
                                             const float* __restrict__ cos2,
                                             const float* __restrict__ s2,
                                             uint32_t (&qa)[HD / 16][4]) {
  constexpr int NU = HD / 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = r0 + g + 8 * hr;
    float2 x[NU], c[NU], sn[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int d = 8 * u + 2 * t;
      x[u] = c[u] = sn[u] = make_float2(0.f, 0.f);
      if (s < S) {
        x[u] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            q + (size_t)s * ld_in + d));
        c[u] = *reinterpret_cast<const float2*>(cos2 + (size_t)s * HD + d);
        sn[u] = *reinterpret_cast<const float2*>(s2 + (size_t)s * HD + d);
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int up = (u + NU / 2) % NU;
      qa[u >> 1][(u & 1) * 2 + hr] = pack_bf16x2(
          __fadd_rn(__fmul_rn(x[u].x, c[u].x), __fmul_rn(x[up].x, sn[u].x)),
          __fadd_rn(__fmul_rn(x[u].y, c[u].y), __fmul_rn(x[up].y, sn[u].y)));
    }
  }
}

// Raw dots of the warp's 16 query rows against the AKN keys of a staged
// tile kb (pitch HD + 8): acc[j] is n8 tile j (rows g, g + 8; keys 8j + 2t,
// + 1). Each dot is HD/16 mma steps in increasing d, each step from +0.0
// and added to the dot with one rounded __fadd_rn (the search kernels'
// bf16 rule): accumulating the steps inside the instruction is 9 % faster
// but leaves two fifths more outputs off the float64 value
// (bench/ab_attn.py, @acc). Pass 1 and pass 2 run the same chain, so they see the same logits
// bit for bit. Unless FULL, 16-key pairs at or past `keys` are skipped
// (staged rows up to `keys` rounded up to 16 are read).
template <int HD, bool FULL>
__device__ __forceinline__ void qk_tile(const uint32_t (&qa)[HD / 16][4],
                                        const __nv_bfloat16* kb, int keys,
                                        float (&acc)[AKN / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  // matrices: keys 0-7 | 8-15 of the pair (lane bit 4), d 0-7 | 8-15 of the
  // step (lane bit 3): r[0], r[1] are n8 tile 2p's b0, b1; r[2], r[3] 2p+1's.
  const __nv_bfloat16* base =
      kb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < AKN / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < AKN / 16; ++p) {
    if (!FULL && 16 * p >= keys) break;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, base + 16 * p * LD + 16 * ks);
      if (ks == 0) {  // 0 + c = c: the first step lands in the zeroed acc
        mma_bf16(acc[2 * p], qa[0], b[0], b[1]);
        mma_bf16(acc[2 * p + 1], qa[0], b[2], b[3]);
      } else {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c0, qa[ks], b[0], b[1]);
        mma_bf16(c1, qa[ks], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * p][e] = __fadd_rn(acc[2 * p][e], c0[e]);
          acc[2 * p + 1][e] = __fadd_rn(acc[2 * p + 1][e], c1[e]);
        }
      }
    }
  }
}

// Pass 1's epilogue: the logits of a tile into the running maxima m[0] (row
// g) and m[1] (row g + 8); bias points at the tile's first key.
template <bool FULL>
__device__ __forceinline__ void tile_max(const float (&acc)[AKN / 8][4],
                                         const float* bias, int keys,
                                         float scale, float (&m)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < AKN / 8; ++j) {
    if (!FULL && 8 * j >= keys) break;
    const float2 bt = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    m[0] = fmaxf(m[0], fmaxf(logit_of(acc[j][0], scale, bt.x),
                             logit_of(acc[j][1], scale, bt.y)));
    m[1] = fmaxf(m[1], fmaxf(logit_of(acc[j][2], scale, bt.x),
                             logit_of(acc[j][3], scale, bt.y)));
  }
}

// Pass 2 on a tile: e = exp(l - m) in f32 against the exact row max (m[0]
// row g, m[1] row g + 8), the unrounded e summed
// into l, and bf16(e) · V into o. The C fragments of the logits repack as A
// fragments of the product (n8 tiles 2kk and 2kk + 1 make k16 step kk), so
// bf16(e) never leaves the registers; V's B fragments come from the staged
// tile vb with ldmatrix.trans. Keys at or past `keys` get e = 0 (their V
// rows are staged as zeros). expf, not __expf: see the header.
template <int HD, bool FULL>
__device__ __forceinline__ void tile_pv(const float (&acc)[AKN / 8][4],
                                        const float* bias, int keys,
                                        float scale, const float (&m)[2],
                                        float (&l)[2], const __nv_bfloat16* vb,
                                        float (&o)[HD / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  uint32_t pa[AKN / 8][2];
#pragma unroll
  for (int j = 0; j < AKN / 8; ++j) {
    pa[j][0] = pa[j][1] = 0u;
    if (FULL || 8 * j < keys) {
      const float2 bt = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
      const float* a = acc[j];
      const float e0 = expf(__fsub_rn(logit_of(a[0], scale, bt.x), m[0]));
      const float e1 = expf(__fsub_rn(logit_of(a[1], scale, bt.y), m[0]));
      const float e2 = expf(__fsub_rn(logit_of(a[2], scale, bt.x), m[1]));
      const float e3 = expf(__fsub_rn(logit_of(a[3], scale, bt.y), m[1]));
      l[0] = __fadd_rn(__fadd_rn(l[0], e0), e1);
      l[1] = __fadd_rn(__fadd_rn(l[1], e2), e3);
      pa[j][0] = pack_bf16x2(e0, e1);
      pa[j][1] = pack_bf16x2(e2, e3);
    }
  }
  // matrices: keys 0-7 | 8-15 of the step (lane bit 3), dims 0-7 | 8-15 of
  // the pair (lane bit 4): r[0], r[1] are dim tile 2dq's b0, b1 (transposed:
  // keys 2t, 2t+1 of dim g); r[2], r[3] 2dq+1's.
  const __nv_bfloat16* base =
      vb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < AKN / 16; ++kk) {
    if (!FULL && 16 * kk >= keys) break;
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                           pa[2 * kk + 1][1]};
#pragma unroll
    for (int dq = 0; dq < HD / 16; ++dq) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * kk * LD + 16 * dq);
      mma_bf16(o[2 * dq], a, b[0], b[1]);
      mma_bf16(o[2 * dq + 1], a, b[2], b[3]);
    }
  }
}

// One (b, h): q, k and v point at the head's row 0 (rows ld_in elements
// apart), brow at its key bias, out at its context row 0 (rows ld_out
// apart). RES: K is rotated once into shared memory, V staged whole beside
// it, and the 16 warps walk their query tiles without a barrier; otherwise
// (where the two do not fit) each pass streams K and V tiles through rings
// that the 8 warps step through together, and rotates each K tile as it
// lands. K8 and K7 run this body with different pointers and strides, so
// they agree bit for bit.
template <int HD, bool RES>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ k,
                                       const __nv_bfloat16* __restrict__ v,
                                       int ld_in, const float* __restrict__ cos2,
                                       const float* __restrict__ s2,
                                       const float* __restrict__ brow, int S,
                                       float scale,
                                       __nv_bfloat16* __restrict__ out,
                                       int ld_out) {
  constexpr int LD = HD + 8;
  constexpr int NT_ = att_threads(RES);
  constexpr int NW = NT_ / 32;
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int S16 = (S + 15) & ~15;
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(att_smem);
  __nv_bfloat16* Vs = Ks + (RES ? S16 : 2 * AKN) * LD;
  auto* Bs = reinterpret_cast<float*>(Vs + (RES ? S16 : 2 * AKN) * LD);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nkt = (S + AKN - 1) / AKN;

  for (int i = threadIdx.x; i < S16; i += NT_) Bs[i] = i < S ? brow[i] : 0.f;
  if constexpr (RES) {
    stage_rows<HD, NT_>(k, ld_in, 0, S16, S, Ks);
    cp_async_commit();
    stage_rows<HD, NT_>(v, ld_in, 0, S16, S, Vs);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed (V may still be in flight)
    __syncthreads();
    rotate_rows<HD, NT_>(Ks, 0, S, S, cos2, s2);
    cp_async_wait<0>();
  }
  __syncthreads();  // Bs (and the rotated K and V) are ready

  // Query tiles of 16 rows, NW at a time. With the rings every warp takes
  // every barrier, and a warp whose rows all lie at or past S computes
  // nothing.
  for (int r0 = 16 * warp; r0 - 16 * warp < S; r0 += 16 * NW) {
    const bool active = r0 < S;
    if constexpr (RES) {
      if (!active) break;
    } else {
      stage_rows<HD, NT_>(v, ld_in, 0, AKN, S, Vs);  // V tile 0, under pass 1
      cp_async_commit();
    }
    uint32_t qa[HD / 16][4];
    if (active) load_q_frags<HD>(q, ld_in, r0, S, cos2, s2, qa);

    // Pass 1: the exact max of each row over all S keys.
    float m[2] = {-INFINITY, -INFINITY};
    if constexpr (RES) {
      if (active) {
        for (int k0 = 0; k0 < S; k0 += AKN) {
          const int keys = min(AKN, S - k0);
          float acc[AKN / 8][4];
          if (keys == AKN) {
            qk_tile<HD, true>(qa, Ks + k0 * LD, keys, acc);
            tile_max<true>(acc, Bs + k0, keys, scale, m);
          } else {
            qk_tile<HD, false>(qa, Ks + k0 * LD, keys, acc);
            tile_max<false>(acc, Bs + k0, keys, scale, m);
          }
        }
      }
    } else {
      stage_rows<HD, NT_>(k, ld_in, 0, AKN, S, Ks);
      cp_async_commit();
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * AKN, keys = min(AKN, S - k0);
        if (kt + 1 < nkt)
          stage_rows<HD, NT_>(k, ld_in, k0 + AKN, AKN, S,
                              Ks + ((kt + 1) & 1) * AKN * LD);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        __nv_bfloat16* kb = Ks + (kt & 1) * AKN * LD;
        rotate_rows<HD, NT_>(kb, k0, AKN, S, cos2, s2);
        __syncthreads();
        if (active) {
          float acc[AKN / 8][4];
          if (keys == AKN) {
            qk_tile<HD, true>(qa, kb, keys, acc);
            tile_max<true>(acc, Bs + k0, keys, scale, m);
          } else {
            qk_tile<HD, false>(qa, kb, keys, acc);
            tile_max<false>(acc, Bs + k0, keys, scale, m);
          }
        }
        __syncthreads();  // slot kt & 1 is consumed
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      m[0] = fmaxf(m[0], __shfl_xor_sync(0xffffffffu, m[0], off));
      m[1] = fmaxf(m[1], __shfl_xor_sync(0xffffffffu, m[1], off));
    }

    // Pass 2: the logits again, e against m, the sums and bf16(e) · V.
    float l[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    if constexpr (!RES) {
      stage_rows<HD, NT_>(k, ld_in, 0, AKN, S, Ks);
      cp_async_commit();
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * AKN, keys = min(AKN, S - k0);
      const __nv_bfloat16* kb = Ks + k0 * LD;
      const __nv_bfloat16* vb = Vs + k0 * LD;
      if constexpr (!RES) {
        if (kt + 1 < nkt) {
          stage_rows<HD, NT_>(v, ld_in, k0 + AKN, AKN, S,
                              Vs + ((kt + 1) & 1) * AKN * LD);
          stage_rows<HD, NT_>(k, ld_in, k0 + AKN, AKN, S,
                              Ks + ((kt + 1) & 1) * AKN * LD);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // tile kt of V and K has landed
        vb = Vs + (kt & 1) * AKN * LD;
        kb = Ks + (kt & 1) * AKN * LD;
        rotate_rows<HD, NT_>(Ks + (kt & 1) * AKN * LD, k0, AKN, S, cos2, s2);
        __syncthreads();
      }
      if (active) {
        float acc[AKN / 8][4];
        if (keys == AKN) {
          qk_tile<HD, true>(qa, kb, keys, acc);
          tile_pv<HD, true>(acc, Bs + k0, keys, scale, m, l, vb, o);
        } else {
          qk_tile<HD, false>(qa, kb, keys, acc);
          tile_pv<HD, false>(acc, Bs + k0, keys, scale, m, l, vb, o);
        }
      }
      if constexpr (!RES) __syncthreads();  // slot kt & 1 is consumed
    }

    // Epilogue: the row sums over the quad, normalization after PV, one
    // rounding to bf16; rows at or past S are not stored.
    if (active) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l[0] = __fadd_rn(l[0], __shfl_xor_sync(0xffffffffu, l[0], off));
        l[1] = __fadd_rn(l[1], __shfl_xor_sync(0xffffffffu, l[1], off));
      }
      const int s = r0 + g;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        __nv_bfloat16* dst = out + (size_t)s * ld_out + 8 * j + 2 * t;
        if (s < S)
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              __fdiv_rn(o[j][0], l[0]), __fdiv_rn(o[j][1], l[0]));
        if (s + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * (size_t)ld_out) =
              __floats2bfloat162_rn(__fdiv_rn(o[j][2], l[1]),
                                    __fdiv_rn(o[j][3], l[1]));
      }
    }
  }
}

// K8: a block per (b, h), heads of one batch row side by side in the grid.
template <int HD, bool RES>
__global__ void __launch_bounds__(att_threads(RES), (RES || HD >= 128) ? 1 : 2)
    k8_fused_attention_qkv(const __nv_bfloat16* __restrict__ qkv,
                           const float* __restrict__ cos2,
                           const float* __restrict__ s2,
                           const float* __restrict__ bias, int S, int H,
                           float scale, __nv_bfloat16* __restrict__ out) {
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int row_stride = 3 * H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  attend<HD, RES>(base + (0 * H + h) * HD, base + (1 * H + h) * HD,
                         base + (2 * H + h) * HD, row_stride, cos2, s2,
                         bias + (size_t)b * S, S, scale,
                         out + (size_t)b * S * H * HD + h * HD, H * HD);
}

// K7: K8 on head-major operands, a block per (b, h) = blockIdx.x.
template <int HD, bool RES>
__global__ void __launch_bounds__(att_threads(RES), (RES || HD >= 128) ? 1 : 2)
    k7_fused_attention(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ cos2,
                       const float* __restrict__ s2,
                       const float* __restrict__ bias, int S, int H,
                       float scale, __nv_bfloat16* __restrict__ out) {
  const int b = blockIdx.x / H;
  const size_t head = (size_t)blockIdx.x * S * HD;
  attend<HD, RES>(q + head, k + head, v + head, HD, cos2, s2,
                         bias + (size_t)b * S, S, scale, out + head, HD);
}

template <int HD, bool RES>
int launch_k8_as(const void* qkv, const float* cos2, const float* s2,
                 const float* bias, int B, int S, int H, float scale,
                 void* out, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t bytes = attn_smem_bytes<HD>(S, RES);
  const int e =
      allow_smem(k8_fused_attention_qkv<HD, RES>, bytes, configured);
  if (e) return e;
  k8_fused_attention_qkv<HD, RES>
      <<<(unsigned)B * (unsigned)H, att_threads(RES), bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(qkv), cos2, s2, bias, S, H, scale,
          static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

template <int HD, bool RES>
int launch_k7_as(const void* q, const void* k, const void* v,
                 const float* cos2, const float* s2, const float* bias, int B,
                 int S, int H, float scale, void* out, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t bytes = attn_smem_bytes<HD>(S, RES);
  const int e =
      allow_smem(k7_fused_attention<HD, RES>, bytes, configured);
  if (e) return e;
  k7_fused_attention<HD, RES>
      <<<(unsigned)B * (unsigned)H, att_threads(RES), bytes, stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), cos2, s2, bias, S, H, scale,
          static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// K and V stay resident where both fit (every S <= MAX_S at HD 16 and 32,
// S <= 784 at HD 64); above that, and at HD 128 (whose 512-thread blocks
// would spill), both stream. Only HD 64 and 128 reach the streamed body.
template <int HD>
bool attn_resident(int S) {
  return HD < 128 && attn_smem_bytes<HD>(S, true) <= SMEM_OPTIN;
}
constexpr int ATT_STREAM_FROM_HD = 64;

template <int HD>
int launch_k8(const void* qkv, const float* cos2, const float* s2,
              const float* bias, int B, int S, int H, float scale, void* out,
              cudaStream_t stream) {
  if constexpr (HD < 128)
    if (attn_resident<HD>(S))
      return launch_k8_as<HD, true>(qkv, cos2, s2, bias, B, S, H, scale, out,
                                    stream);
  if constexpr (HD >= ATT_STREAM_FROM_HD)
    return launch_k8_as<HD, false>(qkv, cos2, s2, bias, B, S, H, scale, out,
                                   stream);
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_k7(const void* q, const void* k, const void* v, const float* cos2,
              const float* s2, const float* bias, int B, int S, int H,
              float scale, void* out, cudaStream_t stream) {
  if constexpr (HD < 128)
    if (attn_resident<HD>(S))
      return launch_k7_as<HD, true>(q, k, v, cos2, s2, bias, B, S, H, scale,
                                    out, stream);
  if constexpr (HD >= ATT_STREAM_FROM_HD)
    return launch_k7_as<HD, false>(q, k, v, cos2, s2, bias, B, S, H, scale,
                                   out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Geometry the wrapper must respect (checked in Python too): hd in
// {16, 32, 64, 128}; S % 8 == 0 and 0 < S <= MAX_S;
// qkv [B, S, 3*H*hd] bf16, cos2 / s2 [S, hd] f32, bias [B, S] f32, out
// [B, S, H*hd] bf16, all contiguous; B * H * ceil(S / 32) < 2^31.

int bsr_fused_attention_qkv(const void* qkv, const float* cos2, const float* s2,
                            const float* bias, int B, int S, int H, int hd,
                            float scale, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 8 || S > MAX_S) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_k8<16>(qkv, cos2, s2, bias, B, S, H, scale, out, st);
    case 32: return launch_k8<32>(qkv, cos2, s2, bias, B, S, H, scale, out, st);
    case 64: return launch_k8<64>(qkv, cos2, s2, bias, B, S, H, scale, out, st);
    case 128:
      return launch_k8<128>(qkv, cos2, s2, bias, B, S, H, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7. q, k, v and out [B, H, S, hd] bf16; cos2, s2, bias and the geometry
// limits as for K8.
int bsr_fused_attention(const void* q, const void* k, const void* v,
                        const float* cos2, const float* s2, const float* bias,
                        int B, int S, int H, int hd, float scale, void* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 8 || S > MAX_S) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_k7<16>(q, k, v, cos2, s2, bias, B, S, H, scale, out, st);
    case 32: return launch_k7<32>(q, k, v, cos2, s2, bias, B, S, H, scale, out, st);
    case 64: return launch_k7<64>(q, k, v, cos2, s2, bias, B, S, H, scale, out, st);
    case 128:
      return launch_k7<128>(q, k, v, cos2, s2, bias, B, S, H, scale, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9. qkv, cos2, s2, bias as for K8; g [B, S, H*hd] bf16; stats a
// [3, B, H, S] f32 scratch (m, l, row from pass (a) to pass (b)); dqkv
// [B, S, 3*H*hd] bf16, every element written. Same geometry limits as K8.
int bsr_fused_attention_qkv_bwd(const void* qkv, const float* cos2,
                                const float* s2, const float* bias,
                                const void* g, int B, int S, int H, int hd,
                                float scale, float* stats, void* dqkv,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 8 || S > MAX_S) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_k9<16>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                           dqkv, st);
    case 32:
      return launch_k9<32>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                           dqkv, st);
    case 64:
      return launch_k9<64>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                           dqkv, st);
    case 128:
      return launch_k9<128>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                            dqkv, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
