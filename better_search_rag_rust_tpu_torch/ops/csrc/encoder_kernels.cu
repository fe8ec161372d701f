// The encoder layer's elementwise glue for Hopper (sm_90a), plain C interface.
//
//   K18  bsr_add_layer_norm      <- no Pallas kernel: the XLA fusion of the
//   K18b bsr_add_layer_norm_bwd     residual add, the f32 LayerNorm and the
//                                   rounding, forward and backward
//                                   (better_search_rag_rust_tpu/models/nomic.py
//                                   :392-396 norm1, :399-403 norm2, :430-432
//                                   emb_norm)
//   K19  bsr_swiglu              <- no Pallas kernel: the XLA fusion of the
//   K19b bsr_swiglu_bwd             MLP gate y * silu(gate) (nomic.py:354-359),
//                                   or gelu(y) (:361-363), forward and backward
//
// The JAX package's encoder layer is one jitted program, and XLA fuses these
// into a few passes over memory; run as eager torch ops they were separate
// passes (an add, a copy to f32, LayerNorm's read and write, a cast back; silu
// and a multiply). Each kernel here is one pass: it reads its inputs once and
// writes its outputs once.
//
// K18, y = round_dt(LN(round_dt(x + r))): x, r [N, D] in the compute dtype
// (bf16, or f32, where round_dt is the identity), gamma, beta f32 [D]. Per
// row, all in f32 with round-to-nearest operations and no contraction:
//   s_d  = round_dt(x_d + r_d)
//   sum  = the s_d in THE LANE ORDER below; sq the same over s_d * s_d
//   mean = sum / D;  v = sq / D - mean * mean;  var = v < 0 ? 0 : v
//   rstd = 1 / sqrt(var + eps)          (both correctly rounded)
//   y_d  = round_dt((s_d - mean) * (rstd * gamma_d) + beta_d)
// This is flax's LayerNorm as the JAX reference runs it (flax 0.12.3:
// _compute_stats with use_fast_variance, var = max(0, E[s^2] - E[s]^2), a
// NaN kept; _normalize's order, the scale folded into the multiplier), not
// torch's two-pass LayerNorm. The sums' order is the kernel's own, so it
// agrees with the JAX package to a tolerance and with its plain version
// (ops/encoder_kernels.py:add_layer_norm_plain, torch ops in the same order)
// bit for bit; the division, the sqrt and the reciprocal are correctly
// rounded on both devices (rsqrtf is not).
//
// THE LANE ORDER. One warp a row. Lane l of 32 holds the features 256c + 8l
// + j, c = 0, 1, ... (chunks of 256) and j = 0..7: one 16-byte load of bf16
// (two of f32) a chunk. A lane's sum starts at +0.0 and adds its terms c
// ascending, j ascending in each c; then the lane sums halve, v[i] += v[i +
// h] for h = 16, 8, 4, 2, 1, and the row's sum is v[0]. A feature past D
// adds +0.0, which leaves a sum as it is (a sum that starts at +0.0 never
// holds -0.0). The row stays in registers: D <= 1024 (4 chunks).
//
// K18b, the gradient of K18 for dy [N, D] in the compute dtype (the
// rounding's gradient passes dy through, as torch's cast does). It reads x
// and r again rather than saved statistics: it recomputes s, mean, v and
// rstd by the same code as K18, so they are K18's bits, and knows which
// branch of flax's max a row took. With g_d = dy_d * gamma_d and xh_d = (s_d
// - mean) * rstd:
//   mg  = (sum of g) / D;  mgx = ((sum of g * xh) / D) * c
//   ds_d = round_dt(rstd * ((g_d - mg) - xh_d * mgx))
// the sums in THE LANE ORDER; c = d var / d v is 1 where v > 0, 1/2 where v
// == 0 (jax's max splits a tie) and 0 where v < 0 (the clip). ds is the
// gradient of both x and r. dgamma_d = sum over rows of dy_d * xh_d and
// dbeta_d = sum of dy_d, in a fixed order with no atomics, so two runs give
// the same bits, and so does the plain version: the wrapper launches G =
// min(ceil(N / 8), 264) blocks of 8 warps (ops/encoder_kernels.py:
// k18b_blocks); warp w = 8b + k of block b takes the rows w, w + 8G, w +
// 16G, ... in order and adds each row's terms into its lanes' f32
// accumulators (+0.0 first); block b's partial is warp 0's accumulators plus
// warp 1's, ... plus warp 7's, in that order; then a second kernel sums the
// G partials from +0.0, b ascending.
//
// K19, y = round_dt(a * round_dt(silu(g))) over a, g [N, I] taken as one
// flat array: silu(x) = x / (1 + expf(-x)) in f32, torch's CUDA silu, so
// the kernel is the eager chain a * F.silu(g) bit for bit. The gelu flag
// (the JAX package's activation="gelu", no a): y = round_dt(gelu(g)) with
// gelu(x) = x * 0.5 * (1 + erff(x * sqrt(1/2))), torch's CUDA
// F.gelu(approximate="none").
// K19b, torch autograd's rounding points and formulas: da = round_dt(dy *
// round_dt(silu(g))), dg = round_dt(t * s * (1 + g * (1 - s))) with t =
// round_dt(dy * a) and s = 1 / (1 + expf(-g)) (torch's silu_backward); gelu:
// dg = round_dt(dy * (cdf + g * pdf)), cdf = 0.5 * (1 + erff(g sqrt(1/2))),
// pdf = expf(-0.5 g g) * (2 / sqrt(pi)) sqrt(1/2) / 2 (gelu_backward). The
// formulas are written as torch writes them, so nvcc contracts them alike.
//
// BOUND: the bytes. Each element costs a few f32 operations against 2 or 4
// bytes, far below the card's ridge point. At the encoder's 131,072 x 768
// bf16, K18 moves 604 MB (0.180 ms at 3.35 TB/s), K18b 805 MB (0.240 ms);
// at 131,072 x 3,072, K19 2.42 GB (0.721 ms), K19b 4.03 GB (1.202 ms).
// DESIGN: one pass, 16-byte loads and stores where every base is 16-byte
// aligned (and, for K18/K18b, D % 8 == 0), else element by element in the
// same order, so both paths give the same bits; a tail shorter than 8 goes
// element by element. No shared memory but K18b's block partial.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success); the Python wrappers raise on
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int ACT_SILU = 0;
constexpr int ACT_GELU = 1;

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;  // rows in flight a block: one warp a row
constexpr int LN_CHUNK = 256;              // features a warp covers a chunk: 8 a lane
constexpr int LN_MAX_CHUNKS = 4;           // the row in registers: D <= 1024
constexpr int GATE_THREADS = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // torch's cast on the card: cvt.rn, a NaN as 0x7FFF
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// The compute dtype's rounding, as an f32 value.
template <typename T>
__device__ __forceinline__ float round_dt(float v) {
  return to_f32(from_f32<T>(v));
}

// Elements f .. f + 7 of p (n elements) as f32, +0.0 past n: one 16-byte
// load of bf16 (two of f32) where vec and all 8 lie inside, else one by one.
__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, long long f,
                                      long long n, int vec, float (&v)[8]) {
  if (vec && f + 8 <= n) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + f);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      v[2 * i] = t.x;
      v[2 * i + 1] = t.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f + j < n ? __bfloat162float(p[f + j]) : 0.0f;
}

__device__ __forceinline__ void load8(const float* __restrict__ p, long long f, long long n,
                                      int vec, float (&v)[8]) {
  if (vec && f + 8 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(p + f);
    const float4 b = *reinterpret_cast<const float4*>(p + f + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = f + j < n ? p[f + j] : 0.0f;
}

// v[0..7] rounded to T into p[f .. f + 7], the ones below n.
__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ p, long long f, long long n,
                                       int vec, const float (&v)[8]) {
  if (vec && f + 8 <= n) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i].x = __float2bfloat16_rn(v[2 * i]);
      h[i].y = __float2bfloat16_rn(v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p + f) = u;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (f + j < n) p[f + j] = __float2bfloat16_rn(v[j]);
}

__device__ __forceinline__ void store8(float* __restrict__ p, long long f, long long n, int vec,
                                       const float (&v)[8]) {
  if (vec && f + 8 <= n) {
    *reinterpret_cast<float4*>(p + f) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + f + 4) = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (f + j < n) p[f + j] = v[j];
}

// THE LANE ORDER's halving: lane i < h takes v[i] + v[i + h]; every lane
// gets lane 0's total.
__device__ __forceinline__ float lane_tree(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  return __shfl_sync(0xffffffffu, v, 0);
}

struct LnStats {
  float mean, rstd;
  float vfac;  // d var / d v: 1 (v > 0), 1/2 (v == 0, jax's max at a tie), 0 (clipped, NaN)
};

// A row's s = round_dt(x + r) into registers (lane l's features 256c + 8l +
// j) and its statistics: K18's and K18b's one copy of this arithmetic.
template <typename T, int NC>
__device__ __forceinline__ LnStats ln_row(const T* __restrict__ xr, const T* __restrict__ rr,
                                          int D, int lane, int vec, float eps,
                                          float (&s)[NC][8]) {
  float sum = 0.0f, sq = 0.0f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long f = (long long)LN_CHUNK * c + 8 * lane;
    float a[8], b[8];
    load8(xr, f, D, vec, a);
    load8(rr, f, D, vec, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[c][j] = round_dt<T>(__fadd_rn(a[j], b[j]));
      sum = __fadd_rn(sum, s[c][j]);
      sq = __fadd_rn(sq, __fmul_rn(s[c][j], s[c][j]));
    }
  }
  sum = lane_tree(sum);
  sq = lane_tree(sq);
  const float mean = __fdiv_rn(sum, (float)D);
  const float v = __fsub_rn(__fdiv_rn(sq, (float)D), __fmul_rn(mean, mean));
  const float var = v < 0.0f ? 0.0f : v;  // flax's max(0, v): a NaN stays
  LnStats st;
  st.mean = mean;
  st.rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  st.vfac = v > 0.0f ? 1.0f : (v == 0.0f ? 0.5f : 0.0f);
  return st;
}

template <typename T, int NC>
__global__ void __launch_bounds__(LN_THREADS)
k18_add_layer_norm(const T* __restrict__ x, const T* __restrict__ r,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   T* __restrict__ y, long long rows, int D, float eps, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: one row a warp
  float s[NC][8];
  const LnStats st = ln_row<T, NC>(x + row * D, r + row * D, D, lane, vec, eps, s);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long f = (long long)LN_CHUNK * c + 8 * lane;
    if (f >= D) continue;
    float g[8], b[8], out[8];
    load8(gamma, f, D, vec, g);
    load8(beta, f, D, vec, b);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = __fadd_rn(__fmul_rn(__fsub_rn(s[c][j], st.mean), __fmul_rn(st.rstd, g[j])), b[j]);
    store8(y + row * D, f, D, vec, out);
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(LN_THREADS, NC <= 3 ? 2 : 1)
k18b_add_layer_norm_bwd(const T* __restrict__ dy, const T* __restrict__ x,
                        const T* __restrict__ r, const float* __restrict__ gamma,
                        T* __restrict__ ds, float* __restrict__ partial, long long rows, int D,
                        float eps, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long W = (long long)gridDim.x * LN_WARPS;
  float acc_g[NC][8], acc_b[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_g[c][j] = acc_b[c][j] = 0.0f;

  for (long long row = (long long)blockIdx.x * LN_WARPS + warp; row < rows; row += W) {
    float s[NC][8], d[NC][8];
    const LnStats st = ln_row<T, NC>(x + row * D, r + row * D, D, lane, vec, eps, s);
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long f = (long long)LN_CHUNK * c + 8 * lane;
      float gm[8];
      load8(dy + row * D, f, D, vec, d[c]);
      load8(gamma, f, D, vec, gm);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xh = __fmul_rn(__fsub_rn(s[c][j], st.mean), st.rstd);
        const float g = __fmul_rn(d[c][j], gm[j]);
        sg = __fadd_rn(sg, g);
        sgx = __fadd_rn(sgx, __fmul_rn(g, xh));
        acc_g[c][j] = __fadd_rn(acc_g[c][j], __fmul_rn(d[c][j], xh));
        acc_b[c][j] = __fadd_rn(acc_b[c][j], d[c][j]);
      }
    }
    sg = lane_tree(sg);
    sgx = lane_tree(sgx);
    const float mg = __fdiv_rn(sg, (float)D);
    const float mgx = __fmul_rn(__fdiv_rn(sgx, (float)D), st.vfac);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const long long f = (long long)LN_CHUNK * c + 8 * lane;
      if (f >= D) continue;
      float gm[8], out[8];
      load8(gamma, f, D, vec, gm);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xh = __fmul_rn(__fsub_rn(s[c][j], st.mean), st.rstd);
        const float g = __fmul_rn(d[c][j], gm[j]);
        out[j] = __fmul_rn(st.rstd, __fsub_rn(__fsub_rn(g, mg), __fmul_rn(xh, mgx)));
      }
      store8(ds + row * D, f, D, vec, out);
    }
  }

  // the block's partial: warp 0's accumulators, then + warp 1's, ... + warp 7's
  __shared__ float red[2][LN_MAX_CHUNKS * LN_CHUNK];
  for (int w = 0; w < LN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = LN_CHUNK * c + 8 * lane + j;
          red[0][i] = w == 0 ? acc_g[c][j] : __fadd_rn(red[0][i], acc_g[c][j]);
          red[1][i] = w == 0 ? acc_b[c][j] : __fadd_rn(red[1][i], acc_b[c][j]);
        }
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < D; i += LN_THREADS) {
    out[i] = red[0][i];
    out[D + i] = red[1][i];
  }
}

// dgamma, dbeta [D] from the G block partials [G, 2, D]: +0.0, then b ascending.
__global__ void __launch_bounds__(LN_THREADS)
k18b_reduce(const float* __restrict__ partial, int G, int D, float* __restrict__ dgamma,
            float* __restrict__ dbeta) {
  const int i = blockIdx.x * LN_THREADS + threadIdx.x;
  if (i >= 2 * D) return;
  const int which = i / D, d = i - which * D;
  float t = 0.0f;
  for (int b = 0; b < G; ++b) t = __fadd_rn(t, partial[((long long)b * 2 + which) * D + d]);
  (which ? dbeta : dgamma)[d] = t;
}

// torch's CUDA activations, written as torch writes them (opmath f32).
constexpr float GELU_ALPHA = (float)0.70710678118654752440;  // M_SQRT1_2
constexpr float GELU_BETA =
    (float)(1.12837916709551257390 * 0.70710678118654752440 * 0.5);  // M_2_SQRTPI M_SQRT1_2 / 2

__device__ __forceinline__ float silu_f32(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float gelu_f32(float x) {
  return x * 0.5f * (1.0f + erff(x * GELU_ALPHA));
}

__device__ __forceinline__ float silu_backward_f32(float dy, float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return dy * s * (1.0f + x * (1.0f - s));
}

__device__ __forceinline__ float gelu_backward_f32(float dy, float x) {
  const float cdf = 0.5f * (1.0f + erff(x * GELU_ALPHA));
  const float pdf = expf(-0.5f * x * x) * GELU_BETA;
  return dy * (cdf + x * pdf);
}

template <typename T, int ACT>
__global__ void __launch_bounds__(GATE_THREADS)
k19_gate(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ y, long long n,
         int vec) {
  const long long stride = 8LL * gridDim.x * GATE_THREADS;
  for (long long f = 8LL * ((long long)blockIdx.x * GATE_THREADS + threadIdx.x); f < n;
       f += stride) {
    float gv[8], av[8], out[8];
    load8(g, f, n, vec, gv);
    if (ACT == ACT_SILU) load8(a, f, n, vec, av);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[j] = ACT == ACT_SILU ? __fmul_rn(av[j], round_dt<T>(silu_f32(gv[j]))) : gelu_f32(gv[j]);
    store8(y, f, n, vec, out);
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(GATE_THREADS)
k19b_gate_bwd(const T* __restrict__ dy, const T* __restrict__ a, const T* __restrict__ g,
              T* __restrict__ da, T* __restrict__ dg, long long n, int vec) {
  const long long stride = 8LL * gridDim.x * GATE_THREADS;
  for (long long f = 8LL * ((long long)blockIdx.x * GATE_THREADS + threadIdx.x); f < n;
       f += stride) {
    float dv[8], gv[8], av[8], outa[8], outg[8];
    load8(dy, f, n, vec, dv);
    load8(g, f, n, vec, gv);
    if (ACT == ACT_SILU) {
      load8(a, f, n, vec, av);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        outa[j] = __fmul_rn(dv[j], round_dt<T>(silu_f32(gv[j])));
        outg[j] = silu_backward_f32(round_dt<T>(__fmul_rn(dv[j], av[j])), gv[j]);
      }
      store8(da, f, n, vec, outa);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) outg[j] = gelu_backward_f32(dv[j], gv[j]);
    }
    store8(dg, f, n, vec, outg);
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int NC>
int launch_k18(const void* x, const void* r, const float* gamma, const float* beta, void* y,
               long long rows, int D, float eps, cudaStream_t st) {
  const int vec = D % 8 == 0 && aligned16(x) && aligned16(r) && aligned16(gamma) &&
                  aligned16(beta) && aligned16(y);
  const long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k18_add_layer_norm<T, NC><<<(unsigned)blocks, LN_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), gamma, beta, static_cast<T*>(y), rows,
      D, eps, vec);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_k18b(const void* dy, const void* x, const void* r, const float* gamma, void* ds,
                float* partial, float* dgamma, float* dbeta, long long rows, int D, float eps,
                int blocks, cudaStream_t st) {
  const int vec = D % 8 == 0 && aligned16(dy) && aligned16(x) && aligned16(r) &&
                  aligned16(gamma) && aligned16(ds);
  k18b_add_layer_norm_bwd<T, NC><<<blocks, LN_THREADS, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const T*>(r), gamma,
      static_cast<T*>(ds), partial, rows, D, eps, vec);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  k18b_reduce<<<(2 * D + LN_THREADS - 1) / LN_THREADS, LN_THREADS, 0, st>>>(partial, blocks, D,
                                                                           dgamma, dbeta);
  return (int)cudaGetLastError();
}

// Blocks of a grid-stride elementwise pass: 8 elements a thread a step, at
// most 16 blocks an SM of the 132.
long long gate_blocks(long long n) {
  long long blocks = (n + 8LL * GATE_THREADS - 1) / (8LL * GATE_THREADS);
  return blocks > 132 * 16 ? 132 * 16 : blocks;
}

template <typename T, int ACT>
int launch_k19(const void* a, const void* g, void* y, long long n, cudaStream_t st) {
  const int vec = (ACT == ACT_GELU || aligned16(a)) && aligned16(g) && aligned16(y);
  k19_gate<T, ACT><<<(unsigned)gate_blocks(n), GATE_THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), static_cast<T*>(y), n, vec);
  return (int)cudaGetLastError();
}

template <typename T, int ACT>
int launch_k19b(const void* dy, const void* a, const void* g, void* da, void* dg, long long n,
                cudaStream_t st) {
  const int vec = (ACT == ACT_GELU || (aligned16(a) && aligned16(da))) && aligned16(dy) &&
                  aligned16(g) && aligned16(dg);
  k19b_gate_bwd<T, ACT><<<(unsigned)gate_blocks(n), GATE_THREADS, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(a), static_cast<const T*>(g),
      static_cast<T*>(da), static_cast<T*>(dg), n, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k18(const void* x, const void* r, const float* gamma, const float* beta, void* y,
                 long long rows, int D, float eps, cudaStream_t st) {
  switch ((D + LN_CHUNK - 1) / LN_CHUNK) {
    case 1: return launch_k18<T, 1>(x, r, gamma, beta, y, rows, D, eps, st);
    case 2: return launch_k18<T, 2>(x, r, gamma, beta, y, rows, D, eps, st);
    case 3: return launch_k18<T, 3>(x, r, gamma, beta, y, rows, D, eps, st);
    case 4: return launch_k18<T, 4>(x, r, gamma, beta, y, rows, D, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_k18b(const void* dy, const void* x, const void* r, const float* gamma, void* ds,
                  float* partial, float* dgamma, float* dbeta, long long rows, int D, float eps,
                  int blocks, cudaStream_t st) {
  switch ((D + LN_CHUNK - 1) / LN_CHUNK) {
    case 1: return launch_k18b<T, 1>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D, eps, blocks, st);
    case 2: return launch_k18b<T, 2>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D, eps, blocks, st);
    case 3: return launch_k18b<T, 3>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D, eps, blocks, st);
    case 4: return launch_k18b<T, 4>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D, eps, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K18: x, r, y [rows, D] contiguous in dtype (0 f32, 1 bf16); gamma, beta
// f32 [D]; 1 <= D <= 1024.
int bsr_add_layer_norm(const void* x, const void* r, const float* gamma, const float* beta,
                       void* y, long long rows, int D, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (D <= 0 || D > LN_MAX_CHUNKS * LN_CHUNK) return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return dispatch_k18<__nv_bfloat16>(x, r, gamma, beta, y, rows, D, eps, st);
  if (dtype == DTYPE_F32) return dispatch_k18<float>(x, r, gamma, beta, y, rows, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// K18b: dy, x, r, ds [rows, D] in dtype; gamma f32 [D]; partial f32
// [blocks, 2, D] (scratch); dgamma, dbeta f32 [D]; blocks = the wrapper's
// k18b_blocks(rows), which the plain version sums in the same order.
int bsr_add_layer_norm_bwd(const void* dy, const void* x, const void* r, const float* gamma,
                           void* ds, float* partial, float* dgamma, float* dbeta, long long rows,
                           int D, float eps, int blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > LN_MAX_CHUNKS * LN_CHUNK || blocks <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_BF16)
    return dispatch_k18b<__nv_bfloat16>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D,
                                        eps, blocks, st);
  if (dtype == DTYPE_F32)
    return dispatch_k18b<float>(dy, x, r, gamma, ds, partial, dgamma, dbeta, rows, D, eps,
                                blocks, st);
  return (int)cudaErrorInvalidValue;
}

// K19: a, g, y n elements in dtype; act 0 silu (y = a * silu(g)), 1 gelu
// (y = gelu(g); a unused, may be null).
int bsr_swiglu(const void* a, const void* g, void* y, long long n, int dtype, int act,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == DTYPE_BF16 && act == ACT_SILU) return launch_k19<__nv_bfloat16, ACT_SILU>(a, g, y, n, st);
  if (dtype == DTYPE_BF16 && act == ACT_GELU) return launch_k19<__nv_bfloat16, ACT_GELU>(a, g, y, n, st);
  if (dtype == DTYPE_F32 && act == ACT_SILU) return launch_k19<float, ACT_SILU>(a, g, y, n, st);
  if (dtype == DTYPE_F32 && act == ACT_GELU) return launch_k19<float, ACT_GELU>(a, g, y, n, st);
  return (int)cudaErrorInvalidValue;
}

// K19b: dy, a, g, da, dg n elements in dtype; gelu: a and da unused.
int bsr_swiglu_bwd(const void* dy, const void* a, const void* g, void* da, void* dg, long long n,
                   int dtype, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  if (dtype == DTYPE_BF16 && act == ACT_SILU)
    return launch_k19b<__nv_bfloat16, ACT_SILU>(dy, a, g, da, dg, n, st);
  if (dtype == DTYPE_BF16 && act == ACT_GELU)
    return launch_k19b<__nv_bfloat16, ACT_GELU>(dy, a, g, da, dg, n, st);
  if (dtype == DTYPE_F32 && act == ACT_SILU) return launch_k19b<float, ACT_SILU>(dy, a, g, da, dg, n, st);
  if (dtype == DTYPE_F32 && act == ACT_GELU) return launch_k19b<float, ACT_GELU>(dy, a, g, da, dg, n, st);
  return (int)cudaErrorInvalidValue;
}

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
