// Fused rotary + softmax attention for Hopper (sm_90a), plain C interface.
//
//   K8 bsr_fused_attention_qkv <- fused_attention_qkv
//      (better_search_rag_rust_tpu/ops/attention_pallas.py:177, body :140)
//
// WHAT IT COMPUTES. For each batch row b and head h, straight off the Wqkv
// projection output qkv [B, S, 3*H*hd] bf16 (q, k and v of head h at lane
// offsets (0*H+h)*hd, (1*H+h)*hd and (2*H+h)*hd of a row):
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
// WHAT BOUNDS IT. 4*S*hd FLOP per query row per head (QK^T and AV): at the
// encoder's shape (B = 256, S = 512, H = 12, hd = 64) 206 GFLOP per call
// against 100 MB of qkv in and 25 MB out, so it is compute-bound by a wide
// margin. This first version runs on the SIMT FP32 pipes (every product is
// of two bf16 values, hence exact in f32, and sums in f32), not on tensor
// cores: mma.sync / wgmma is a later change.
//
// DESIGN. The TPU cell holds a whole head's [S, S] f32 logits in VMEM; an SM
// has 227 KB. A block here owns (b, h, a tile of TQ = 32 query rows) and
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
// The rotary and the logit epilogue use __fmul_rn / __fadd_rn so the compiler
// does not contract them into FMAs: the plain PyTorch version rounds each
// product and sum, and so does this kernel.
//
// The entry point launches on the caller's stream, allocates nothing and
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

template <int HD>
int launch_k8(const void* qkv, const float* cos2, const float* s2,
              const float* bias, int B, int S, int H, float scale, void* out,
              cudaStream_t stream) {
  static size_t configured = 48 * 1024;  // the default dynamic-smem limit
  const size_t bytes = smem_bytes<HD>(S);
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        k8_fused_attention_qkv<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = bytes;
  }
  const int nqt = (S + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)H * (unsigned)nqt);
  k8_fused_attention_qkv<HD><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), cos2, s2, bias, S, H, scale,
      static_cast<__nv_bfloat16*>(out));
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

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
