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
// K9 — WHAT BOUNDS IT. Five products of S*S*hd per head (QK^T, dp, dv, dq,
// dk: 10*S*S*hd FLOP): at the finetune shape (B 64, S 512, H 12, hd 64) 129
// GFLOP, 0.130 ms at the bf16 tensor rate, against ~0.03 ms for its bytes
// (qkv and g in, dqkv out): operations-bound. The design below computes
// seven products, not five: with no atomics and no residual beyond K8's
// inputs, a pass over a key block cannot know the softmax statistics of a
// query row without a pass over all of that row's keys, so QK^T and dp run
// in both kernels — three products in the query pass (QK^T, dp, dq) and four
// in the key pass (S^T, dP^T, dv, dk) — with an exponential per logit in
// each.
//
// K9 — DESIGN. Three kernels, deterministic (no atomics), every product on
// mma.sync m16n8k16 (bf16 in, f32 out) in K8's fragment layout.
// (0) k9_rotate_k: k_r, each key's rotary once per head, into dqkv's own k
// lanes (no scratch beyond the statistics): the query pass reads it there,
// and each key-pass block stages its own rows of it before it overwrites
// them with dk. Rotating K in every query block instead reads the rotary
// tables again for every 16 query rows. q_r cannot take the same road: the
// only lanes free for it would be dq's or dv's, written while other blocks
// still read it, so the key pass rotates each q tile as it lands.
// (a) k9_bwd_query: a block per (b, h, 16 query rows); its 8 warps split the
// keys, warp w taking the 64-key tiles w and w + 8. Every warp holds the
// rotated q (load_q_frags) and g of the 16 rows as A fragments, read from
// global memory. A warp stages its V tile with cp.async into a slot of its
// own (pitch hd + 8), takes dp = g v^T (dot_tile, V by ldmatrix), stages its
// K_r tile into the same slot and takes the logits by K8's own qk_tile, so
// they are K8's bit for bit. The f32 logits of its tiles (at most two: S <=
// 1024) stay in registers, their dp in the thread's own shared-memory slots;
// the exact row max, the sum of the f32 e and row = sum(dp * p) are reduced
// over the quad and then over the 8 warps through shared memory, in a fixed
// order. ds = bf16(p * (dp - row) *
// scale) is repacked from the C fragments into the A fragments of ds . K_r
// (tile_pv's repack; K_r by ldmatrix.trans from the slot, restaged where a
// warp had two tiles), and the 8 partial dq are summed in warp order through
// shared memory before the rotary adjoint and one rounding. m, l and row go
// to the [3, B, H, S] f32 scratch. Three products: the logits and dp are
// kept, not recomputed.
// (b) k9_bwd_key: a block per (b, h, KB keys), KW warps of 16 keys each: the
// keys are the M rows. K_r and V of the block's keys stay in shared memory;
// q, g and the statistics of KQ-query tiles stream through a two-tile
// cp.async ring, each q tile rotated as it lands. Per tile a warp takes S^T
// = K_r Q_r^T by qk_tile (its A fragments by ldmatrix from K_r), p from the
// stored m and l, dP^T = V g^T by dot_tile and ds, then dV += bf16(P)^T g
// and dK += dS^T Q_r, both A operands repacked C -> A and g, Q_r by
// ldmatrix.trans. dV accumulates in registers, dK (and a tile's p, while
// dP^T runs) in the thread's own shared-memory slots; dK's rotary adjoint
// pairs lane d with its partner d + hd/2, which the same thread holds. Four
// products.
// Rounding: QK^T is qk_tile's (each k16 step from +0.0, one rounded add);
// dp, dv, dk and dq follow K9_STEP_ADDS, chosen by bench/ab_attn.py's float64
// line (the variant @bwdacc flips it).
//
// K9 — WHERE TROUBLE LIES.
// 1. p and ds must agree bit for bit between the two kernels, or bf16(p)
//    and ds would drift between dq and dk/dv. The query pass takes Q K^T and
//    g V^T, the key pass K Q^T and V g^T: the same routines on the same bf16
//    operands, and a k16 step of m16n8k16 sums the same 16 exact products at
//    the same k positions whichever operand is A. The card shows that the two
//    orientations give the same f32 (a build with K9_DUMP, which writes both
//    kernels' p, dp and ds behind the statistics: tests/test_torch_gpu.py).
//    Then the same logit_of epilogue, expf (not __expf) of an exact
//    __fsub_rn, the __fdiv_rn by the stored f32 sum; row is read, not
//    recomputed.
// 2. Padding. Keys at or past S get the logit -inf in the query pass (e = 0)
//    and p = 0 in the key pass, against zero K, V, q and g rows — never the
//    -1e9 bias: a fully padded batch row has every real logit at ~ -1e9, so
//    p = 1/S there. With S % 16 == 8 half of the last k16 step is empty.
//    Query rows at or past S run on zero q and g and are not stored.
// 3. Registers. The key pass's dV and dK are hd/2 f32 each per thread, beside
//    a tile's p and dp. 32-query tiles (KQ; @kq64 shows 64) halve p and dp;
//    dK and p wait in shared memory (the __fdiv_rn of p has a slow-path call
//    whose caller-saved registers spill otherwise), so that three blocks
//    share an SM. The query pass keeps a tile's logits in registers (one
//    tile below S 512: two blocks per SM; two above: one) and its dp in
//    shared memory. No instantiation below hd 128 spills; bench/ab_attn.py
//    prints the ptxas report of every one.
// 4. bench/ab_attn.py's variants edit this source by exact text. K9 calls
//    qk_tile, so @acc moves both kernels' QK^T together; @bwdacc flips
//    K9_STEP_ADDS; @dump defines K9_DUMP; @fastexp, @stream and @nopass1
//    leave K9 as it is.
// 5. Determinism: every reduction (k16 steps, tiles, the quad, the warps)
//    runs in a fixed order.
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

constexpr int MAX_S = 1024;   // longest sequence: two key tiles per K9 warp

__device__ __forceinline__ float logit_of(float acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(acc, scale), bias);
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
// past S are zero-filled. Threads tid, tid + nt, .. of those that share the
// copy take its 16-byte chunks.
template <int HD>
__device__ __forceinline__ void stage_rows_by(const __nv_bfloat16* __restrict__ x,
                                              int ld_in, int s0, int rows, int S,
                                              __nv_bfloat16* dst, int tid,
                                              int nt) {
  constexpr int LD = HD + 8;
  constexpr int CH = HD / 8;
  for (int i = tid; i < rows * CH; i += nt) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const int s = s0 + r;
    const bool in = s < S;
    cp_async16_or_zero(dst + r * LD + c, x + (size_t)(in ? s : 0) * ld_in + c,
                       in);
  }
}

// stage_rows_by over the NT_ threads of a block.
template <int HD, int NT_>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ x,
                                           int ld_in, int s0, int rows, int S,
                                           __nv_bfloat16* dst) {
  stage_rows_by<HD>(x, ld_in, s0, rows, S, dst, threadIdx.x, NT_);
}

// The rotary of staged rows [0, rows) (positions s0 ..) in place, with
// load_q_frags's arithmetic: f32 from the bf16 input, one rounding to bf16.
// Rows at or past S stay as staged (zero). Threads tid, tid + nt, .. share
// the work.
template <int HD>
__device__ __forceinline__ void rotate_rows_by(__nv_bfloat16* x, int s0,
                                               int rows, int S,
                                               const float* __restrict__ cos2,
                                               const float* __restrict__ s2,
                                               int tid, int nt) {
  constexpr int LD = HD + 8;
  constexpr int H2 = HD / 2;
  constexpr int PAIRS = H2 / 2;
  for (int i = tid; i < rows * PAIRS; i += nt) {
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

// rotate_rows_by over the NT_ threads of a block.
template <int HD, int NT_>
__device__ __forceinline__ void rotate_rows(__nv_bfloat16* x, int s0, int rows,
                                            int S,
                                            const float* __restrict__ cos2,
                                            const float* __restrict__ s2) {
  rotate_rows_by<HD>(x, s0, rows, S, cos2, s2, threadIdx.x, NT_);
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
// (staged rows up to `keys` rounded up to 16 are read). NK: the tile's keys
// (K8 and K9's query pass AKN, K9's key pass KQ queries).
template <int HD, bool FULL, int NK = AKN>
__device__ __forceinline__ void qk_tile(const uint32_t (&qa)[HD / 16][4],
                                        const __nv_bfloat16* kb, int keys,
                                        float (&acc)[NK / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  // matrices: keys 0-7 | 8-15 of the pair (lane bit 4), d 0-7 | 8-15 of the
  // step (lane bit 3): r[0], r[1] are n8 tile 2p's b0, b1; r[2], r[3] 2p+1's.
  const __nv_bfloat16* base =
      kb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < NK / 16; ++p) {
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

// ---------------------------------------------------------------------------
// K9: the recompute backward on the tensor cores (see the header)
// ---------------------------------------------------------------------------

constexpr int QW = 8;  // warps of a query-pass block; warp w: key tiles w, w + QW
constexpr int KW = 4;  // warps of a key-pass block, 16 keys each
constexpr int KB = 16 * KW;  // keys of a key-pass block
constexpr int KQ = 32;       // queries of a key-pass tile
constexpr int KEY_BLOCKS = 3;  // key-pass blocks per SM (registers)
static_assert(2 * QW * AKN >= MAX_S, "a query-pass warp holds two key tiles");

// dp, dv, dk and dq: each k16 step from +0.0 and added with one rounded add,
// as qk_tile takes QK^T (true), or accumulated inside the mma (false).
constexpr bool K9_STEP_ADDS = true;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ds_of(float p, float dp, float row,
                                       float scale) {
  return bf16_round(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale));
}

// c += A B under K9_STEP_ADDS.
__device__ __forceinline__ void mma_k9(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (K9_STEP_ADDS) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(s, a, b0, b1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], s[e]);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// A fragments of rows r0 .. r0 + 15 of x (rows ld_in elements apart) straight
// from global memory, load_q_frags's layout without the rotary: thread (g, t)
// holds rows g and g + 8 at lanes 8u + 2t, + 1. Rows at or past S are zero.
template <int HD>
__device__ __forceinline__ void load_a_frags(const __nv_bfloat16* __restrict__ x,
                                             int ld_in, int r0, int S,
                                             uint32_t (&a)[HD / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = r0 + g + 8 * hr;
#pragma unroll
    for (int u = 0; u < HD / 8; ++u)
      a[u >> 1][(u & 1) * 2 + hr] =
          s < S ? *reinterpret_cast<const uint32_t*>(x + (size_t)s * ld_in +
                                                     8 * u + 2 * t)
                : 0u;
  }
}

// A fragments of the staged rows 0 .. 15 of ta (pitch HD + 8) by ldmatrix:
// matrices rows 0-7 | 8-15 (lane bit 3), k 0-7 | 8-15 of the step (lane bit
// 4), which is m16n8k16's a[0] .. a[3].
template <int HD>
__device__ __forceinline__ void ldsm_a_frags(const __nv_bfloat16* ta,
                                             uint32_t (&a)[HD / 16][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base =
      ta + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) ldsm_x4(a[ks], base + 16 * ks);
}

// The dots of the warp's 16 A rows with the NK rows of the staged tile tb
// (pitch HD + 8), as qk_tile lays them out (acc[j]: rows g, g + 8; tile rows
// 8j + 2t, + 1) but under K9_STEP_ADDS: dp = g v^T in the query pass, dP^T
// = v g^T in the key pass. Unless FULL, 16-row pairs at or past n are
// skipped.
template <int HD, bool FULL, int NK>
__device__ __forceinline__ void dot_tile(const uint32_t (&a)[HD / 16][4],
                                         const __nv_bfloat16* tb, int n,
                                         float (&acc)[NK / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base =
      tb + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < NK / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int p = 0; p < NK / 16; ++p) {
    if (!FULL && 16 * p >= n) break;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, base + 16 * p * LD + 16 * ks);
      mma_k9(acc[2 * p], a[ks], b[0], b[1]);
      mma_k9(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}

// bf16 pairs of a [16, NK] f32 tile held as C fragments: pa[j][0] row g,
// pa[j][1] row g + 8 (tile_pv's repack; n8 tiles 2kk, 2kk + 1 make k16 step
// kk of the next product).
template <int NK>
__device__ __forceinline__ void pack_tile(const float (&c)[NK / 8][4],
                                          uint32_t (&pa)[NK / 8][2]) {
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    pa[j][0] = pack_bf16x2(c[j][0], c[j][1]);
    pa[j][1] = pack_bf16x2(c[j][2], c[j][3]);
  }
}

// o += A . tb, A the repacked [16, NK] tile pa, tb's B fragments by
// ldmatrix.trans (tile_pv's map), under K9_STEP_ADDS: ds . K_r in the query
// pass, bf16(P)^T . g and dS^T . Q_r in the key pass. Unless FULL, k16 steps
// at or past n are skipped.
template <int HD, bool FULL, int NK>
__device__ __forceinline__ void pv_acc(const uint32_t (&pa)[NK / 8][2],
                                       const __nv_bfloat16* tb, int n,
                                       float (&o)[HD / 8][4]) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base =
      tb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    if (!FULL && 16 * kk >= n) break;
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                           pa[2 * kk + 1][1]};
#pragma unroll
    for (int dq = 0; dq < HD / 16; ++dq) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * kk * LD + 16 * dq);
      mma_k9(o[2 * dq], a, b[0], b[1]);
      mma_k9(o[2 * dq + 1], a, b[2], b[3]);
    }
  }
}

// pv_acc with the accumulator in the thread's lane-contiguous shared-memory
// slots os (element (j, e) of o at os[(j * 4 + e) * 32]) instead of
// registers: each pair of n8 output tiles is loaded, takes its k16 steps in
// increasing order and is stored back, so every output element sees the
// same adds in the same order as pv_acc's. (pv_acc walked in this order too
// makes the key pass spill at hd 64, so the two loops stay apart.)
template <int HD, bool FULL, int NK>
__device__ __forceinline__ void pv_acc_smem(const uint32_t (&pa)[NK / 8][2],
                                            const __nv_bfloat16* tb, int n,
                                            float* os) {
  constexpr int LD = HD + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* base =
      tb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int dq = 0; dq < HD / 16; ++dq) {
    float o0[4], o1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o0[e] = os[(2 * dq * 4 + e) * 32];
      o1[e] = os[((2 * dq + 1) * 4 + e) * 32];
    }
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      if (!FULL && 16 * kk >= n) break;
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
      uint32_t b[4];
      ldsm_x4_trans(b, base + 16 * kk * LD + 16 * dq);
      mma_k9(o0, a, b[0], b[1]);
      mma_k9(o1, a, b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      os[(2 * dq * 4 + e) * 32] = o0[e];
      os[((2 * dq + 1) * 4 + e) * 32] = o1[e];
    }
  }
}

#ifdef K9_DUMP
// Debug builds (bench/ab_attn.py @dump): p, dp and ds of (query q, key k)
// as each kernel saw them, at dump[((pass * BH + bh) * 3 + c) * S * S +
// q * S + k] behind the statistics (c = 0 p, 1 dp, 2 ds).
__device__ __forceinline__ void k9_dump(float* dump, int pass, size_t bh,
                                        size_t BH, int S, int q, int k,
                                        float p, float dp, float ds) {
  const size_t at = ((pass * BH + bh) * 3) * S * S + (size_t)q * S + k;
  dump[at] = p;
  dump[at + (size_t)S * S] = dp;
  dump[at + 2 * (size_t)S * S] = ds;
}
#endif

// Query pass, one key tile of a warp (sweep 1): V into the warp's slot, dp
// with g's A fragments ga, stored to the thread's shared-memory slots dps
// (stride 32) at once so that it does not hold registers; K_r (rotated by
// k9_rotate_k) into the slot, the logits with q_r's qa (keys at or past S:
// -inf) and the running maxima mx[0] (row g), mx[1] (row g + 8). Leaves K_r
// in the slot.
template <int HD, bool FULL>
__device__ __forceinline__ void q_tile_logits(
    const uint32_t (&qa)[HD / 16][4], const uint32_t (&ga)[HD / 16][4],
    const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, int ld_in,
    const float* __restrict__ brow, int S, float scale, int k0, int keys,
    __nv_bfloat16* slot, float (&lg)[AKN / 8][4], float* dps,
    float (&mx)[2]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float dp[AKN / 8][4];
  stage_rows_by<HD>(vp, ld_in, k0, AKN, S, slot, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  dot_tile<HD, FULL, AKN>(ga, slot, keys, dp);
#pragma unroll
  for (int j = 0; j < AKN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dps[(j * 4 + e) * 32] = dp[j][e];
  __syncwarp();  // every lane's reads of V are done
  stage_rows_by<HD>(kp, ld_in, k0, AKN, S, slot, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  qk_tile<HD, FULL>(qa, slot, keys, lg);
#pragma unroll
  for (int j = 0; j < AKN / 8; ++j) {
    const int key = k0 + 8 * j + 2 * t;  // an n8 tile is wholly < S or >= S
    if (FULL || key < S) {
      const float2 bt = *reinterpret_cast<const float2*>(brow + key);
      lg[j][0] = logit_of(lg[j][0], scale, bt.x);
      lg[j][1] = logit_of(lg[j][1], scale, bt.y);
      lg[j][2] = logit_of(lg[j][2], scale, bt.x);
      lg[j][3] = logit_of(lg[j][3], scale, bt.y);
    } else {
      lg[j][0] = lg[j][1] = lg[j][2] = lg[j][3] = -INFINITY;
    }
    mx[0] = fmaxf(mx[0], fmaxf(lg[j][0], lg[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(lg[j][2], lg[j][3]));
  }
}

// Shared memory of a query-pass block: a [AKN][HD + 8] bf16 slot per warp
// (its V tile, then its rotated K tile, at last its partial dq in f32), the
// per-warp row partials of the max, the sum and row, and each thread's dp
// (TPW tiles of AKN / 8 x 4 f32, lane-contiguous), kept out of registers
// across the block's reductions.
template <int HD, int TPW>
__host__ __device__ __forceinline__ size_t k9q_smem_bytes() {
  return (size_t)QW * AKN * (HD + 8) * 2 + (size_t)3 * QW * 16 * 4 +
         (size_t)QW * TPW * AKN * 16 * 4;
}

// Quad, then warps 0 .. QW-1 in order, through red[QW][16]: the block's
// value of rows g (v[0]) and g + 8 (v[1]) in every thread. MAX: fmaxf, else
// a rounded sum.
template <bool MAX>
__device__ __forceinline__ void block_rows(float (&v)[2], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float o = __shfl_xor_sync(0xffffffffu, v[k], off);
      v[k] = MAX ? fmaxf(v[k], o) : __fadd_rn(v[k], o);
    }
  if ((lane & 3) == 0) {
    red[warp * 16 + (lane >> 2)] = v[0];
    red[warp * 16 + (lane >> 2) + 8] = v[1];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float s = MAX ? -INFINITY : 0.f;
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      const float o = red[w * 16 + (lane >> 2) + 8 * k];
      s = MAX ? fmaxf(s, o) : __fadd_rn(s, o);
    }
    v[k] = s;
  }
}

// Pass (a): a block per (b, h, 16 query rows). TPW key tiles per warp (1
// where S <= QW * AKN, else 2). Writes dq and the row statistics m, l, row
// to stats [3][B*H*S].
template <int HD, int TPW>
__global__ void __launch_bounds__(QW * 32, (HD <= 64 && TPW == 1) ? 2 : 1)
    k9_bwd_query(const __nv_bfloat16* __restrict__ qkv,
                 const float* __restrict__ cos2, const float* __restrict__ s2,
                 const float* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ g, int S, int H,
                 float scale, float* __restrict__ stats,
                 __nv_bfloat16* __restrict__ dqkv) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char k9_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  auto* slots = reinterpret_cast<__nv_bfloat16*>(k9_smem);
  __nv_bfloat16* slot = slots + warp * AKN * LD;
  float* red = reinterpret_cast<float*>(slots + QW * AKN * LD);  // [3][QW][16]
  // the thread's dp: element (i, j, e) at dps[((i * AKN / 8 + j) * 4 + e) * 32]
  float* dps = red + 3 * QW * 16 + warp * TPW * AKN * 16 + lane;
  const int nq = (S + 15) / 16;
  const int h = (blockIdx.x / nq) % H;
  const int b = blockIdx.x / (nq * H);
  const int r0 = (blockIdx.x % nq) * 16;
  const int nkt = (S + AKN - 1) / AKN;
  const int row_stride = 3 * H * HD, g_stride = H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  // k_r, rotated by k9_rotate_k into dqkv's k lanes
  const __nv_bfloat16* kp = dqkv + (size_t)b * S * row_stride + (1 * H + h) * HD;
  const __nv_bfloat16* vp = base + (2 * H + h) * HD;
  const float* brow = bias + (size_t)b * S;
  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  load_q_frags<HD>(base + (0 * H + h) * HD, row_stride, r0, S, cos2, s2, qa);
  load_a_frags<HD>(g + (size_t)b * S * g_stride + h * HD, g_stride, r0, S, ga);

  // Sweep 1: the logits of the warp's tiles, kept in registers, and dp.
  float lg[TPW][AKN / 8][4];
  float m[2];  // row maxima (not K8's initializer text: @nopass1 edits that)
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    const int kt = warp + QW * i;
    if (kt >= nkt) {  // no tile: e = 0 (and its dp is never read)
#pragma unroll
      for (int j = 0; j < AKN / 8; ++j)
        lg[i][j][0] = lg[i][j][1] = lg[i][j][2] = lg[i][j][3] = -INFINITY;
      continue;
    }
    const int k0 = kt * AKN, keys = min(AKN, S - k0);
    float* dpi = dps + i * AKN * 16;
    if (keys == AKN)
      q_tile_logits<HD, true>(qa, ga, kp, vp, row_stride, brow, S, scale, k0,
                              keys, slot, lg[i], dpi, m);
    else
      q_tile_logits<HD, false>(qa, ga, kp, vp, row_stride, brow, S, scale, k0,
                               keys, slot, lg[i], dpi, m);
  }

  // The exact row max, e and l = the f32 sum of e, p = e / l and row =
  // sum(dp * p): each over the thread's values, the quad, the warps.
  block_rows<true>(m, red);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TPW; ++i)
#pragma unroll
    for (int j = 0; j < AKN / 8; ++j) {
      float* x = lg[i][j];
      x[0] = expf(__fsub_rn(x[0], m[0]));
      x[1] = expf(__fsub_rn(x[1], m[0]));
      x[2] = expf(__fsub_rn(x[2], m[1]));
      x[3] = expf(__fsub_rn(x[3], m[1]));
      l[0] = __fadd_rn(__fadd_rn(l[0], x[0]), x[1]);
      l[1] = __fadd_rn(__fadd_rn(l[1], x[2]), x[3]);
    }
  block_rows<false>(l, red + QW * 16);
  float row[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TPW; ++i) {
    if (warp + QW * i >= nkt) continue;  // p = 0 there
#pragma unroll
    for (int j = 0; j < AKN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lg[i][j][e] = __fdiv_rn(lg[i][j][e], l[e >> 1]);
        row[e >> 1] = __fadd_rn(
            row[e >> 1],
            __fmul_rn(dps[((i * AKN / 8 + j) * 4 + e) * 32], lg[i][j][e]));
      }
  }
  block_rows<false>(row, red + 2 * QW * 16);

  // Sweep 2: ds, repacked, times K_r; the slot still holds the warp's last
  // tile, an earlier one is staged again.
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  bool in_slot = true;
#pragma unroll
  for (int i = TPW - 1; i >= 0; --i) {
    const int kt = warp + QW * i;
    if (kt >= nkt) continue;
    const int k0 = kt * AKN, keys = min(AKN, S - k0);
    if (!in_slot) {
      __syncwarp();  // the slot's reads are done
      stage_rows_by<HD>(kp, row_stride, k0, AKN, S, slot, lane, 32);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    }
    in_slot = false;
    // ds over p in place
#pragma unroll
    for (int j = 0; j < AKN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dp = dps[((i * AKN / 8 + j) * 4 + e) * 32];
        const float ds = ds_of(lg[i][j][e], dp, row[e >> 1], scale);
#ifdef K9_DUMP
        const int q = r0 + gq + 8 * (e >> 1), k = k0 + 8 * j + 2 * t + (e & 1);
        if (q < S && k < S)
          k9_dump(stats + 3 * (size_t)(gridDim.x / nq) * S, 0,
                  blockIdx.x / nq, gridDim.x / nq, S, q, k, lg[i][j][e], dp,
                  ds);
#endif
        lg[i][j][e] = ds;
      }
    uint32_t pa[AKN / 8][2];
    pack_tile<AKN>(lg[i], pa);
    if (keys == AKN)
      pv_acc<HD, true, AKN>(pa, slot, keys, dq);
    else
      pv_acc<HD, false, AKN>(pa, slot, keys, dq);
  }

  // The 8 partial dq in warp order, the rotary adjoint, one rounding.
  __syncwarp();
  float* part = reinterpret_cast<float*>(slot);  // [16][HD] f32
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(part + gq * HD + 8 * j + 2 * t) =
        make_float2(dq[j][0], dq[j][1]);
    *reinterpret_cast<float2*>(part + (gq + 8) * HD + 8 * j + 2 * t) =
        make_float2(dq[j][2], dq[j][3]);
  }
  __syncthreads();
  __nv_bfloat16* out = dqkv + (size_t)b * S * row_stride + (0 * H + h) * HD;
  for (int idx = threadIdx.x; idx < 16 * HD; idx += QW * 32) {
    const int r = idx / HD, d = idx % HD, s = r0 + r;
    if (s >= S) continue;
    const int dpart = (d + HD / 2) % HD;
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      const float* pw = reinterpret_cast<const float*>(slots + w * AKN * LD);
      x = __fadd_rn(x, pw[r * HD + d]);
      y = __fadd_rn(y, pw[r * HD + dpart]);
    }
    out[(size_t)s * row_stride + d] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(x, cos2[(size_t)s * HD + d]),
                  __fmul_rn(y, s2[(size_t)s * HD + dpart])));
  }
  if (threadIdx.x < 16 && r0 + (int)threadIdx.x < S) {
    // red holds every warp's partials of row threadIdx.x: reduce as above
    const int r = threadIdx.x;
    float mm = -INFINITY, ll = 0.f, rr = 0.f;
#pragma unroll
    for (int w = 0; w < QW; ++w) {
      mm = fmaxf(mm, red[w * 16 + r]);
      ll = __fadd_rn(ll, red[QW * 16 + w * 16 + r]);
      rr = __fadd_rn(rr, red[2 * QW * 16 + w * 16 + r]);
    }
    const size_t bhs = (size_t)(gridDim.x / nq) * S;
    const size_t at = ((size_t)b * H + h) * S + r0 + r;
    stats[at] = mm;
    stats[bhs + at] = ll;
    stats[2 * bhs + at] = rr;
  }
}

// Key pass, one KQ-query tile of a warp (its 16 keys kr, kr + 8): S^T and
// p from the stored statistics, dv += bf16(P)^T g; then dP^T and ds, dk +=
// dS^T Q_r. dv's product runs before dP^T; p waits for ds, and dk
// accumulates, in the thread's lane-contiguous shared-memory slots ps and
// dks (stride 32) rather than in registers, so that the key pass does not
// spill. qb / gb: the staged rotated q and g of the tile; st: its m, l, row.
template <int HD, bool FULL>
__device__ __forceinline__ void k_tile(const __nv_bfloat16* ks,
                                       const __nv_bfloat16* vs,
                                       const __nv_bfloat16* qb,
                                       const __nv_bfloat16* gb,
                                       const float* st, int q0, int qn, int kr,
                                       const float (&bk)[2], int S,
                                       float scale, float (&dv)[HD / 8][4],
                                       float* dks, float* ps, float* dump,
                                       size_t bh, size_t BH) {
  const int t = threadIdx.x & 3;
  uint32_t fa[HD / 16][4];
  uint32_t pa[KQ / 8][2];
  float p[KQ / 8][4], dpt[KQ / 8][4];
  ldsm_a_frags<HD>(ks, fa);
  qk_tile<HD, FULL, KQ>(fa, qb, qn, p);
#pragma unroll
  for (int j = 0; j < KQ / 8; ++j) {
    const int c = 8 * j + 2 * t;  // an n8 tile of queries is wholly < S or >= S
    const float2 m = *reinterpret_cast<const float2*>(st + c);
    const float2 l = *reinterpret_cast<const float2*>(st + KQ + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = q0 + c < S && kr + 8 * (e >> 1) < S;
      const float lg = logit_of(p[j][e], scale, bk[e >> 1]);
      p[j][e] = ok ? __fdiv_rn(expf(__fsub_rn(lg, (e & 1) ? m.y : m.x)),
                               (e & 1) ? l.y : l.x)
                   : 0.f;
      ps[(j * 4 + e) * 32] = p[j][e];
    }
  }
  pack_tile<KQ>(p, pa);
  pv_acc<HD, FULL, KQ>(pa, gb, qn, dv);
  ldsm_a_frags<HD>(vs, fa);
  dot_tile<HD, FULL, KQ>(fa, gb, qn, dpt);
#pragma unroll
  for (int j = 0; j < KQ / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 r = *reinterpret_cast<const float2*>(st + 2 * KQ + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = q0 + c < S && kr + 8 * (e >> 1) < S;
      const float pe = ps[(j * 4 + e) * 32];
      const float ds =
          ok ? ds_of(pe, dpt[j][e], (e & 1) ? r.y : r.x, scale) : 0.f;
#ifdef K9_DUMP
      if (ok)
        k9_dump(dump, 1, bh, BH, S, q0 + c + (e & 1), kr + 8 * (e >> 1), pe,
                dpt[j][e], ds);
#endif
      dpt[j][e] = ds;
    }
  }
  pack_tile<KQ>(dpt, pa);
  pv_acc_smem<HD, FULL, KQ>(pa, qb, qn, dks);
}

// Shared memory of a key-pass block: K_r and V of its KB keys, a ring of
// two (rotated q, g) tiles of KQ queries, the ring's statistics [2][3][KQ]
// f32, and each thread's p of a tile (KQ / 8 x 4 f32) and dk accumulator
// (HD / 8 x 4 f32), lane-contiguous.
template <int HD>
__host__ __device__ __forceinline__ size_t k9k_smem_bytes() {
  return (size_t)(2 * KB + 4 * KQ) * (HD + 8) * 2 + (size_t)2 * 3 * KQ * 4 +
         (size_t)KW * (KQ + HD) * 16 * 4;
}

// Pass (b): a block per (b, h, KB keys). Walks every query tile, recomputes
// p from the stored m and l, and writes dk (over the block's own rows of
// k_r, staged before) and dv.
template <int HD>
__global__ void __launch_bounds__(KW * 32, KEY_BLOCKS)
    k9_bwd_key(const __nv_bfloat16* __restrict__ qkv,
               const float* __restrict__ cos2, const float* __restrict__ s2,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ g, int S, int H, float scale,
               float* __restrict__ stats, __nv_bfloat16* __restrict__ dqkv) {
  constexpr int LD = HD + 8;
  constexpr int NT_ = KW * 32;
  extern __shared__ __align__(16) unsigned char k9_smem[];
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(k9_smem);  // [KB][LD]
  __nv_bfloat16* Vs = Ks + KB * LD;       // [KB][LD]
  __nv_bfloat16* Qs = Vs + KB * LD;       // [2][KQ][LD]
  __nv_bfloat16* Gs = Qs + 2 * KQ * LD;   // [2][KQ][LD]
  auto* St = reinterpret_cast<float*>(Gs + 2 * KQ * LD);  // [2][3][KQ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ps = St + 2 * 3 * KQ + warp * KQ * 16 + lane;  // the thread's p
  float* dks = St + 2 * 3 * KQ + KW * KQ * 16 + warp * HD * 16 + lane;  // dk
  const int nkb = (S + KB - 1) / KB, nqt = (S + KQ - 1) / KQ;
  const int h = (blockIdx.x / nkb) % H;
  const int b = blockIdx.x / (nkb * H);
  const int k0 = (blockIdx.x % nkb) * KB;
  const int row_stride = 3 * H * HD, g_stride = H * HD;
  const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride;
  const __nv_bfloat16* qp = base + (0 * H + h) * HD;
  const __nv_bfloat16* gp = g + (size_t)b * S * g_stride + h * HD;
  const size_t BH = gridDim.x / nkb, bhs = BH * S;
  const float* st = stats + ((size_t)b * H + h) * S;
  float* dump = stats + 3 * bhs;

  // the tile of queries from q0 into ring slot sl: q and g rows, m, l, row
  auto stage_q = [&](int q0, int sl) {
    stage_rows<HD, NT_>(qp, row_stride, q0, KQ, S, Qs + sl * KQ * LD);
    stage_rows<HD, NT_>(gp, g_stride, q0, KQ, S, Gs + sl * KQ * LD);
    for (int i = threadIdx.x; i < 3 * KQ / 4; i += NT_) {
      const int c = i / (KQ / 4), q = q0 + 4 * (i % (KQ / 4));
      const bool in = q < S;  // a 4-query chunk is wholly < S or >= S
      cp_async16_or_zero(St + (sl * 3 + c) * KQ + 4 * (i % (KQ / 4)),
                         st + c * bhs + (in ? q : 0), in);
    }
  };
  __nv_bfloat16* out = dqkv + (size_t)b * S * row_stride;
  stage_rows<HD, NT_>(out + (1 * H + h) * HD, row_stride, k0, KB, S, Ks);
  stage_rows<HD, NT_>(base + (2 * H + h) * HD, row_stride, k0, KB, S, Vs);
  cp_async_commit();
  stage_q(0, 0);
  cp_async_commit();
  const int kr = k0 + 16 * warp + (lane >> 2);  // the thread's keys kr, kr + 8
  const float bk[2] = {kr < S ? bias[(size_t)b * S + kr] : 0.f,
                       kr + 8 < S ? bias[(size_t)b * S + kr + 8] : 0.f};

  float dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dv[j][e] = 0.f;
      dks[(j * 4 + e) * 32] = 0.f;
    }
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * KQ, qn = min(KQ, S - q0), sl = qt & 1;
    if (qt + 1 < nqt) stage_q(q0 + KQ, sl ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile qt (and K_r, V) have landed
    __nv_bfloat16* qb = Qs + sl * KQ * LD;
    rotate_rows<HD, NT_>(qb, q0, KQ, S, cos2, s2);
    __syncthreads();
    const __nv_bfloat16* ks = Ks + 16 * warp * LD;
    const __nv_bfloat16* vs = Vs + 16 * warp * LD;
    if (qn == KQ)
      k_tile<HD, true>(ks, vs, qb, Gs + sl * KQ * LD, St + sl * 3 * KQ, q0,
                       qn, kr, bk, S, scale, dv, dks, ps, dump,
                       blockIdx.x / nkb, BH);
    else
      k_tile<HD, false>(ks, vs, qb, Gs + sl * KQ * LD, St + sl * 3 * KQ, q0,
                        qn, kr, bk, S, scale, dv, dks, ps, dump,
                        blockIdx.x / nkb, BH);
    __syncthreads();  // slot sl is consumed
  }

  // dv straight out, dk through the rotary adjoint (lane d's partner d +
  // HD/2 is n8 tile j + HD/16 of the same thread).
  const int t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = kr + 8 * hr;
    if (s >= S) continue;
    const float* c = cos2 + (size_t)s * HD;
    const float* sn = s2 + (size_t)s * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + 2 * t;
      const int jp = (j + HD / 16) % (HD / 8), dpart = 8 * jp + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)s * row_stride +
                                         (2 * H + h) * HD + d) =
          __floats2bfloat162_rn(dv[j][2 * hr], dv[j][2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)s * row_stride +
                                         (1 * H + h) * HD + d) =
          __floats2bfloat162_rn(
              __fadd_rn(__fmul_rn(dks[(j * 4 + 2 * hr) * 32], c[d]),
                        __fmul_rn(dks[(jp * 4 + 2 * hr) * 32], sn[dpart])),
              __fadd_rn(__fmul_rn(dks[(j * 4 + 2 * hr + 1) * 32], c[d + 1]),
                        __fmul_rn(dks[(jp * 4 + 2 * hr + 1) * 32],
                                  sn[dpart + 1])));
    }
  }
}

// Pass (0): k_r, the rotary of every key of every head in f32 rounded to
// bf16 (rotate_rows's arithmetic), into dqkv's k lanes: the query pass reads
// it there, and each key-pass block overwrites its own rows with dk after
// staging them. One thread per lane pair (j, j + 1) and partners j + HD/2.
template <int HD>
__global__ void __launch_bounds__(256)
    k9_rotate_k(const __nv_bfloat16* __restrict__ qkv,
                const float* __restrict__ cos2, const float* __restrict__ s2,
                int S, int H, size_t items, __nv_bfloat16* __restrict__ dqkv) {
  constexpr int H2 = HD / 2;
  constexpr int PAIRS = H2 / 2;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= items) return;
  const int j = (int)(i % PAIRS) * 2;
  const size_t bsh = i / PAIRS;  // (b * S + s) * H + h
  const int h = (int)(bsh % H);
  const int s = (int)((bsh / H) % S);
  const size_t at = (bsh / H) * 3 * H * HD + (size_t)(H + h) * HD + j;
  const float2 xl = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(qkv + at));
  const float2 xh = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(qkv + at + H2));
  const float* c = cos2 + (size_t)s * HD;
  const float* sn = s2 + (size_t)s * HD;
  const float2 cl = *reinterpret_cast<const float2*>(c + j);
  const float2 ch = *reinterpret_cast<const float2*>(c + j + H2);
  const float2 sl = *reinterpret_cast<const float2*>(sn + j);
  const float2 sh = *reinterpret_cast<const float2*>(sn + j + H2);
  *reinterpret_cast<__nv_bfloat162*>(dqkv + at) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(xl.x, cl.x), __fmul_rn(xh.x, sl.x)),
      __fadd_rn(__fmul_rn(xl.y, cl.y), __fmul_rn(xh.y, sl.y)));
  *reinterpret_cast<__nv_bfloat162*>(dqkv + at + H2) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(xh.x, ch.x), __fmul_rn(xl.x, sh.x)),
      __fadd_rn(__fmul_rn(xh.y, ch.y), __fmul_rn(xl.y, sh.y)));
}

template <int HD, int TPW>
int launch_k9_as(const void* qkv, const float* cos2, const float* s2,
                 const float* bias, const void* g, int B, int S, int H,
                 float scale, float* stats, void* dqkv, cudaStream_t stream) {
  static size_t conf_q = 48 * 1024, conf_k = 48 * 1024;
  const size_t bytes_q = k9q_smem_bytes<HD, TPW>();
  const size_t bytes_k = k9k_smem_bytes<HD>();
  int e = allow_smem(k9_bwd_query<HD, TPW>, bytes_q, conf_q);
  if (e) return e;
  e = allow_smem(k9_bwd_key<HD>, bytes_k, conf_k);
  if (e) return e;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* gg = static_cast<const __nv_bfloat16*>(g);
  auto* out = static_cast<__nv_bfloat16*>(dqkv);
  const unsigned bh = (unsigned)B * (unsigned)H;
  const size_t items = (size_t)bh * S * (HD / 4);
  k9_rotate_k<HD><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      q, cos2, s2, S, H, items, out);
  e = (int)cudaGetLastError();
  if (e) return e;
  k9_bwd_query<HD, TPW><<<bh * (unsigned)((S + 15) / 16), QW * 32, bytes_q,
                          stream>>>(q, cos2, s2, bias, gg, S, H, scale, stats,
                                    out);
  e = (int)cudaGetLastError();
  if (e) return e;
  k9_bwd_key<HD><<<bh * (unsigned)((S + KB - 1) / KB), KW * 32, bytes_k,
                   stream>>>(q, cos2, s2, bias, gg, S, H, scale, stats, out);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_k9(const void* qkv, const float* cos2, const float* s2,
              const float* bias, const void* g, int B, int S, int H,
              float scale, float* stats, void* dqkv, cudaStream_t stream) {
  if (S <= QW * AKN)
    return launch_k9_as<HD, 1>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                               dqkv, stream);
  return launch_k9_as<HD, 2>(qkv, cos2, s2, bias, g, B, S, H, scale, stats,
                             dqkv, stream);
}

}  // namespace

extern "C" {

// Geometry the wrapper must respect (checked in Python too): hd in
// {16, 32, 64, 128}; S % 8 == 0 and 0 < S <= MAX_S;
// qkv [B, S, 3*H*hd] bf16, cos2 / s2 [S, hd] f32, bias [B, S] f32, out
// [B, S, H*hd] bf16, all contiguous; B * H * ceil(S / 16) < 2^31.

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
// A build with K9_DUMP also writes both kernels' p, dp and ds behind the
// statistics (6 * B*H*S*S more floats, which the caller allocates).
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
