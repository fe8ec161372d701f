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
// K8 — WHAT BOUNDS IT. 4*S*hd FLOP per query row per head (QK^T and AV): at
// the encoder's shape (B = 256, S = 512, H = 12, hd = 64) 206 GFLOP per call
// against 100 MB of qkv in and 25 MB out, so it is compute-bound by a wide
// margin. This first version runs on the SIMT FP32 pipes (every product is
// of two bf16 values, hence exact in f32, and sums in f32), not on tensor
// cores: mma.sync / wgmma is a later change.
//
// K8 — DESIGN. The TPU cell holds a whole head's [S, S] f32 logits in VMEM;
// an SM has 227 KB. A block owns (b, h, a tile of TQ = 32 query rows) and
// keeps that tile's [TQ, S] f32 logits in shared memory (66 KB at S = 512),
// while K and then V stream through one [KT = 64, hd] f32 tile. Two passes
// over the keys rather than an online softmax: pass 1 writes every logit of
// the tile, the row pass takes the exact max m, the f32 sum of exp(l - m)
// and rounds each e to bf16 in place, pass 2 multiplies those rounded e by V.
// So every rounding happens where the TPU kernel rounds; an online softmax
// would rescale running bf16-cast weights and round elsewhere. About 94 KB of
// shared memory per block at S = 512 (dynamic, above the 48 KB default), two
// blocks per SM. S is capped at MAX_S so the logits tile fits.
// Both products use 2 x 4 register micro-tiles fed by 16-byte shared loads;
// rows of a thread are 16 apart and keys of a thread 16 apart, which keeps the
// float4 reads of a warp at two wavefronts. The rotary of K is recomputed by
// each of the S/TQ query tiles of a head (~6 % of the block's FLOPs).
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
// the design below recomputes three of them (eight in all), all SIMT FP32
// like K8: compute-bound, ~2.5x K8's FLOPs per call at the same shape.
//
// K9 — DESIGN. Two kernels, FlashAttention-2 style, deterministic, no
// atomics. (a) k9_bwd_query: a block per (b, h, 32 query rows) holds the
// tile's [32, S] f32 logits in shared memory like K8, takes the exact row
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

template <int HD>
__host__ __device__ __forceinline__ size_t smem_bytes(int S) {
  constexpr int LD = HD + 4;
  return sizeof(float) * ((size_t)TQ * LD + (size_t)KT * LD +
                          (size_t)TQ * logits_pitch(S) + TQ);
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

template <int HD>
__global__ void __launch_bounds__(NT, 2)
    k8_fused_attention_qkv(const __nv_bfloat16* __restrict__ qkv,
                           const float* __restrict__ cos2,
                           const float* __restrict__ s2,
                           const float* __restrict__ bias, int S, int H,
                           float scale, __nv_bfloat16* __restrict__ out) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;  // context dims per thread
  extern __shared__ __align__(16) float smem[];
  const int SP = logits_pitch(S);
  float* Qs = smem;              // [TQ][LD] rotated q
  float* KVs = Qs + TQ * LD;     // [KT][LD] rotated k, then v
  float* Ls = KVs + KT * LD;     // [TQ][SP] logits, then bf16-rounded e
  float* Dn = Ls + TQ * SP;      // [TQ] softmax denominators

  const int nqt = (S + TQ - 1) / TQ;
  const int qt = blockIdx.x % nqt;
  const int h = (blockIdx.x / nqt) % H;
  const int b = blockIdx.x / (nqt * H);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row_stride = 3 * H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const float* brow = bias + (size_t)b * S;
  const int q0 = qt * TQ;

  load_rotated<HD>(base, row_stride, (0 * H + h) * HD, cos2, s2, q0, TQ, S,
                   Qs);

  // Pass 1: logits of the query tile against every key, into Ls.
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous K tile is consumed (Qs is ready)
    load_rotated<HD>(base, row_stride, (1 * H + h) * HD, cos2, s2, k0, KT, S,
                     KVs);
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 q[2], k[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        q[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(q[i].x, k[j].x, acc[i][j]);
          acc[i][j] = fmaf(q[i].y, k[j].y, acc[i][j]);
          acc[i][j] = fmaf(q[i].z, k[j].z, acc[i][j]);
          acc[i][j] = fmaf(q[i].w, k[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      if (t < S) {
        const float bt = brow[t];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          Ls[(ty + 16 * i) * SP + t] =
              __fadd_rn(__fmul_rn(acc[i][j], scale), bt);
      }
    }
  }
  __syncthreads();

  // Row pass: one warp per TQ/8 rows. Exact max, f32 sum of exp(l - m),
  // then each e rounded to bf16 in place for pass 2.
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
        const float e = expf(L[t] - m);
        sum += e;
        L[t] = bf16_round(e);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) Dn[r] = sum;
    }
  }

  // Pass 2: ctx = bf16(e) . v over V tiles; thread owns rows ty, ty + 16
  // and dims tx*DPT .. tx*DPT + DPT - 1.
  float ctx[2][DPT] = {};
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // row pass done / the previous V tile is consumed
    load_plain<HD>(base, row_stride, (2 * H + h) * HD, k0, KT, S, KVs);
    __syncthreads();
    const int kv = min(KT, S - k0);  // a multiple of 8 (S % 8 == 0)
    for (int t = 0; t < kv; t += 4) {
      float4 p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ls + (ty + 16 * i) * SP +
                                                k0 + t);
      const float pv[2][4] = {{p[0].x, p[0].y, p[0].z, p[0].w},
                              {p[1].x, p[1].y, p[1].z, p[1].w}};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[DPT];
        lds<DPT>(KVs + (t + u) * LD + tx * DPT, v);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd)
            ctx[i][dd] = fmaf(pv[i][u], v[dd], ctx[i][dd]);
      }
    }
  }

  // Epilogue: normalize after AV, one rounding to bf16.
  const int out_stride = H * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r;
    if (s < S) {
      const float dn = Dn[r];
      __nv_bfloat16* o =
          out + ((size_t)b * S + s) * out_stride + h * HD + tx * DPT;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        o[dd] = __float2bfloat16_rn(ctx[i][dd] / dn);
    }
  }
}

// K7 — K8 on head-major operands. q, k and v are three [B, H, S, hd] bf16
// tensors (rows of a head hd apart) and the context is [B, H, S, hd]; per
// (b, h) the function, the tiles, the loaders and every rounding are K8's,
// so K7 on the transposed Wqkv output equals K8 bit for bit, and what bounds
// it is what bounds K8. Forward only: the TPU kernel has no backward. The body is K8's written out again rather
// than shared: K8's code stays byte for byte as measured (a body shared
// through pointer parameters lost __restrict__ and slowed K2 by 9 %).
template <int HD>
__global__ void __launch_bounds__(NT, 2)
    k7_fused_attention(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ cos2,
                       const float* __restrict__ s2,
                       const float* __restrict__ bias, int S, int H,
                       float scale, __nv_bfloat16* __restrict__ out) {
  constexpr int LD = HD + 4;
  constexpr int DPT = HD / 16;  // context dims per thread
  extern __shared__ __align__(16) float smem[];
  const int SP = logits_pitch(S);
  float* Qs = smem;              // [TQ][LD] rotated q
  float* KVs = Qs + TQ * LD;     // [KT][LD] rotated k, then v
  float* Ls = KVs + KT * LD;     // [TQ][SP] logits, then bf16-rounded e
  float* Dn = Ls + TQ * SP;      // [TQ] softmax denominators

  const int nqt = (S + TQ - 1) / TQ;
  const int qt = blockIdx.x % nqt;
  const int bh = blockIdx.x / nqt;  // b * H + h
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t head = (size_t)bh * S * HD;
  const float* brow = bias + (size_t)b * S;
  const int q0 = qt * TQ;

  load_rotated<HD>(q + head, HD, 0, cos2, s2, q0, TQ, S, Qs);

  // Pass 1: logits of the query tile against every key, into Ls.
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // the previous K tile is consumed (Qs is ready)
    load_rotated<HD>(k + head, HD, 0, cos2, s2, k0, KT, S, KVs);
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[2], kv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = k0 + tx + 16 * j;
      if (t < S) {
        const float bt = brow[t];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          Ls[(ty + 16 * i) * SP + t] =
              __fadd_rn(__fmul_rn(acc[i][j], scale), bt);
      }
    }
  }
  __syncthreads();

  // Row pass: exact max, f32 sum of exp(l - m), each e rounded to bf16.
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
        const float e = expf(L[t] - m);
        sum += e;
        L[t] = bf16_round(e);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) Dn[r] = sum;
    }
  }

  // Pass 2: ctx = bf16(e) . v over V tiles.
  float ctx[2][DPT] = {};
  for (int k0 = 0; k0 < S; k0 += KT) {
    __syncthreads();  // row pass done / the previous V tile is consumed
    load_plain<HD>(v + head, HD, 0, k0, KT, S, KVs);
    __syncthreads();
    const int kv = min(KT, S - k0);  // a multiple of 8 (S % 8 == 0)
    for (int t = 0; t < kv; t += 4) {
      float4 p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ls + (ty + 16 * i) * SP +
                                                k0 + t);
      const float pv[2][4] = {{p[0].x, p[0].y, p[0].z, p[0].w},
                              {p[1].x, p[1].y, p[1].z, p[1].w}};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[DPT];
        lds<DPT>(KVs + (t + u) * LD + tx * DPT, vv);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int dd = 0; dd < DPT; ++dd)
            ctx[i][dd] = fmaf(pv[i][u], vv[dd], ctx[i][dd]);
      }
    }
  }

  // Epilogue: normalize after AV, one rounding to bf16.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r;
    if (s < S) {
      const float dn = Dn[r];
      __nv_bfloat16* o = out + head + (size_t)s * HD + tx * DPT;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd)
        o[dd] = __float2bfloat16_rn(ctx[i][dd] / dn);
    }
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

template <int HD>
int launch_k8(const void* qkv, const float* cos2, const float* s2,
              const float* bias, int B, int S, int H, float scale, void* out,
              cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t bytes = smem_bytes<HD>(S);
  const int e = allow_smem(k8_fused_attention_qkv<HD>, bytes, configured);
  if (e) return e;
  const int nqt = (S + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)H * (unsigned)nqt);
  k8_fused_attention_qkv<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), cos2, s2, bias, S, H, scale,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_k7(const void* q, const void* k, const void* v, const float* cos2,
              const float* s2, const float* bias, int B, int S, int H,
              float scale, void* out, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t bytes = smem_bytes<HD>(S);
  const int e = allow_smem(k7_fused_attention<HD>, bytes, configured);
  if (e) return e;
  const int nqt = (S + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)H * (unsigned)nqt);
  k7_fused_attention<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), cos2, s2, bias, S, H, scale,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
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
