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
// the ridge. The design below does three products (309 GFLOP, 0.31 ms) and,
// per logit over its two passes, ~23 FP32-pipe instructions (the k16 rule's
// adds, the logit, the max, the exponential, the sum, the pack): 1.9e10 in
// all, ~0.6 ms at 128 lanes a clock on 132 SMs. The FP32 work, not the
// tensor cores, sets its floor; a block's two consumer warpgroups overlap
// one's products with the other's softmax.
//
// K8 — DESIGN. Every product on wgmma (bf16 in, f32 out); K and V reach
// shared memory by TMA as 64-row boxes of 3-D tensor maps (rows past S land
// as zeros) in TileLayout's swizzle, which the wgmma descriptors read. A
// block is K9's: a producer warpgroup and two consumer warpgroups of 64
// query rows. How a block holds a head's K and V is the first of three
// modes that fits its shared memory (ATT_PERSISTENT .. ATT_RING): persistent
// blocks, one an SM, walk heads with two K buffers and one V buffer — the
// producer loads and rotates the next head's K, and loads its V once the
// last head is done, while the consumers work on this one (hd 16 and 32 at
// every S, hd 64 up to S 512: the encoder's case, hd 128 up to 256); a block
// a head, its K rotated by all 384 threads before the roles split and its V
// streamed through a four-stage ring behind mbarriers (landed, empty) once
// for each pair of query tiles, which the two consumer warpgroups take in
// step (hd 64 above S 512, hd 128 up to 512); above that a block per 128
// query rows, the head's K tiles (pass 1), then its K and V tiles (pass 2),
// streaming through the ring, each K tile rotated as it lands: twice a
// block, once for each pass (2n rotations of n tiles; @ringonce in
// bench/ab_attn.py times the second). Each key's rotary is computed once
// per (b, h) in the first two modes. The rotary in place:
// lane d's partner d + hd/2 lies in the same row — at hd 128 at the same
// place of the other 64-lane column chunk, below that in 16-byte piece p ^
// hd/16 of the same swizzled row (the swizzle XORs a piece index with bits
// of the row only); a thread takes four lanes and their partners with 16-byte reads of
// the rotary tables, several items' reads in flight; the writers' stores
// reach wgmma (the async proxy) through fence.proxy.async before the barrier
// or mbarrier that releases the tile. Rotated q stays in registers as
// wgmma's A fragments, loaded from global memory (a warp's 16 rows of a
// 64-row tile have mma.sync's m16 A layout, and each lane's rotary partner
// is the same thread's). Two passes over the keys, S = Q_r K_r^T on wgmma
// m64n64k16 (A from registers, B the K tile read K-major, S's k16 steps
// issued in batches, all four at hd 64, with one wait a batch) in both:
// pass 1 takes the exact row max over all S keys; pass 2 recomputes the
// same logits bit for bit, takes e = exp(l - m) in f32, sums the unrounded
// e, and repacks bf16(e) from the accumulator straight into the A fragments
// of bf16(e) . V (C -> A, as K9 does), the V tile read MN-major; that
// product goes out behind the next tile's S. Full key tiles take a
// branch-free body (the compiler interleaves all 32 cells' exponentials).
// Pass 1 also marks the key tiles whose e may be nonzero: a tile where every
// thread's tile maximum lies at least 120 below its running maximum (no NaN
// among its logits) has every e exactly 0 in f32 (expf(-120) is 0; the
// final maximum is no lower), so pass 2 skips it — keys padded past a
// row's length, bias -1e9, are such tiles — unless its V tile holds a NaN
// or an inf (bf16(0) times either is NaN, which the TPU kernel's PV and the
// mma.sync build's keep: a consumer warpgroup reads a streamed V tile as it
// comes in pass 2 and votes with one bar.red; in a persistent block the
// producer marks the head's V tiles once they land, off the consumers'
// loop, which a check there slowed by 8 %), with no bit of l or of the
// context changed (in a ring the pending product goes out before a skipped
// tile's stage is freed, so no stage is held across a skip). The
// exponential is the accurate expf: __expf (ex2.approx) was 9 % faster in
// the mma.sync build but, against a float64 evaluation of the function,
// left 5 % more outputs off by one bf16 step (bench/ab_attn.py, @fastexp).
// Every rounding point is the TPU kernel's; an online softmax, which
// rounds e against a partial max, is a different function. Keys at or
// past S get e = 0 against TMA's zero rows of V (S % 16 == 8 leaves half
// of the last k16 step empty; an n8 group of keys is wholly below S or
// wholly past it, since S % 8 == 0); query rows
// at or past S run on zero q and are not stored. The context goes out eight
// rows a warp at a time through shared-memory staging rows, as 16-byte
// stores. Three products rather than two: a 64-row tile's f32 logits at S
// 512 are 128 KB, which leaves no room for K and V.
//
// K8 — ROUNDING AND ORDER. S: each k16 step from +0.0 (scale-d = 0) and
// added with one __fadd_rn in increasing step order (ATT_QK_ADDS, the search
// kernels' rule; @acc in bench/ab_attn.py accumulates inside the wgmma). A
// wgmma k16 step with scale-d = 0 gives mma.sync's f32 bits (PERF.md §6),
// and wgmma's accumulator holds a thread's cells at mma.sync's places (row
// g or g + 8, column 8j + 2t), so the logits, m, e and l are the mma.sync
// build's bit for bit: l sums a thread's cells in increasing key order, then
// its quad (xor 1, xor 2). PV: accumulated inside the wgmma from o = 0, k16
// steps in increasing key order, as the mma.sync build accumulated inside
// mma.sync; the PV probe (k_probe_pv_acc) finds the two instructions'
// accumulations bit for bit alike (PERF.md §6). A partial last key tile runs
// all four k16 steps of PV, its empty ones adding exact zeros. Then the
// division after PV and one rounding: every output the mma.sync build's.
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
// (qkv and g in, dqkv out): operations-bound. With no atomics and no
// residual beyond K8's inputs the design below computes eleven products
// (each 25.8 GFLOP there, 0.026 ms at the tensor rate): a query row's
// statistics need every key first, so the query kernel sweeps the head's
// keys four times (S; S; S and dP; S, dP and dQ: seven) and the key kernel
// once (S^T, dP^T, dV, dK: four). Beside the products each logit costs, per
// the rule below, one f32 add a k16 step of each product, four expf and
// three __fdiv_rn over the two kernels (the FP32 pipes, 128 a clock an SM,
// against the tensor cores' 1,024 bf16 FMAs): those, not the tensor cores,
// set its floor.
//
// K9 — DESIGN. Three kernels, deterministic (no atomics), every product on
// wgmma (bf16 in, f32 out) with its operands in shared memory written by
// TMA, or, for the second products, A from registers repacked from an
// accumulator (C -> A). The split, and why: a wgmma tile is 64 rows a
// warpgroup, and the exact softmax needs a row's whole sum before any p; at
// 64 rows x S 512 a row block's f32 logits and dp would take 256 KB, so they
// are recomputed, never kept.
// (0) k9_rotate_qk: q_r and k_r, each query's and key's rotary once per
// head (f32, one rounding to bf16), into a scratch [2, B, H, S, hd] bf16
// behind the statistics, which both kernels read as 64-row TMA boxes.
// (a) k9_wg_query: a block per (b, h, 128 query rows), 384 threads: a
// producer warpgroup (one thread issues every TMA copy; setmaxnreg 40) and
// two consumer warpgroups of 64 rows (setmaxnreg 232), each with its q_r
// and g tiles and the head's key bias resident. The head's k_r tiles (and
// from sweep 3 its v tiles, read straight out of qkv) stream through a
// three-stage ring behind mbarriers, four times: 1. S = Q_r K_r^T, the exact
// row max m; 2. S again, l = the f32 sum of e = expf(l - m); 3. S and dP = G
// V^T, p = e / l, row = sum(dp * p); 4. S and dP, p, ds =
// bf16(p (dp - row) scale), repacked C -> A, and dQ_r += dS K_r (K_r read
// MN-major). Then dq's rotary adjoint and one rounding, and m, l, row and
// 1/l to the statistics [4, B, H, S] f32.
// (b) k9_wg_key: a block per (b, h, 128 keys), the same warpgroups; each
// consumer's k_r and v tiles and the head's m, l and row resident; the
// head's q_r and g tiles stream through the ring once. Per tile: S^T = K_r
// Q_r^T, p from the stored m and l, dV += bf16(P)^T G (A repacked C -> A, G
// read MN-major); dP^T = V G^T, ds with the stored row, dK_r += dS^T Q_r.
// dK and dV stay in f32 registers (p in the thread's shared-memory slots at
// hd 128, where dK and dV take 128 registers) and are written once, dk
// through the rotary adjoint, whose partner lane d + hd/2 the same thread
// holds.
// The tiles lie in TMA's swizzle (128 bytes; 64 / 32 at hd 32 / 16), which
// the wgmma descriptors read as written (K-major for S, S^T, dP and dP^T;
// MN-major for the B of dQ, dV and dK); hd 128 runs each second product as
// two n64 units, one per 64-column chunk.
// Rounding and order: S and S^T take each k16 step from +0.0 (scale-d = 0)
// and add it with one __fadd_rn in increasing step order (K9_QK_ADDS, K8's
// s_tile rule: wgmma's k16 sums are mma.sync's bits, PERF.md §6); dp,
// dv, dk and dq the same under K9_STEP_ADDS (bench/ab_attn.py's float64
// line; @bwdacc flips it), each (step, column unit) of dv, dk and dq into
// a product fragment added while the next runs. l and row: a thread sums
// its 16 cells of a row in a tile in order (j, then the pair) into the
// tile's share, the shares tile after tile, then its quad (xor 1, xor 2).
// dq: each key tile's share from +0.0 (its four k16 steps), the shares
// added tile after tile (the mma.sync build's per-warp partials); dk and dv
// the query tiles' k16 steps in order.
// The division p = e / l is __fdiv_rn's (k9_div), taken branch free: q = e
// (1/l) corrected once by the residual (k9_quot). Sweep 3 certifies each q
// exact by its residual (k9_certified); a warp with any uncertified cell
// takes k9_div for the tile and records it (a byte per 16-row group and key
// tile behind the rotated scratch). Sweep 4 and the key kernel, which
// compute the same q from the same bits, take it alone, and k9_div where
// the record says so: one certificate a cell, not three.
//
// K9 — WHERE TROUBLE LIES.
// 1. p and ds must agree bit for bit between the two kernels, or bf16(p)
//    and ds would drift between dq and dk/dv. The query kernel takes Q K^T
//    and G V^T, the key kernel K Q^T and V G^T: the same dot64 on the same
//    bf16 tiles, and a k16 step sums the same 16 exact products at the same
//    k positions whichever operand is A (a build with K9_DUMP writes both
//    kernels' p, dp and ds behind the scratch: tests/test_torch_gpu.py).
//    Then the same logit_of, k9_exp of an exact __fsub_rn, k9_div's p by
//    the stored f32 sum; both read the same m, l and row.
// 2. Padding. Keys at or past S get the logit -inf in the query kernel (e
//    = 0) and p = 0 in the key kernel, against the zero rows TMA writes past
//    S — never the -1e9 bias: a fully padded batch row has every real
//    logit at ~ -1e9, so p = 1/S there. Query rows at or past S run on zero
//    q_r and g and are not stored; S % 64 != 0 leaves a partial last tile.
// 3. Registers. Up to hd 64 a consumer holds its accumulators (dq and a
//    tile's share of it; dk and dv), S and dP (32 each), p (32) and two
//    product fragments (32 each). At hd 128 the key kernel's dK and dV take
//    128, so it keeps one product fragment and p in shared memory; the query
//    kernel adds dq's steps to dq itself (a share would spill). ptxas
//    reports every body without spills (tests/test_torch_gpu.py), and
//    bench/ab_attn.py prints the report.
// 4. bench/ab_attn.py's variants edit this source by exact text: @bwdacc
//    flips K9_STEP_ADDS; @k9noadd both K9_QK_ADDS and K9_STEP_ADDS (what
//    the rule's adds cost); @k9fastexp takes __expf, @k9fastdiv p = e (1/l)
//    (what the accurate exponential and the exact division cost; other
//    answers); @dump defines K9_DUMP; K8's variants (@mma_sync, which
//    splices bench/attend_mma_sync.cuh between the "K8/K7 forward" and
//    "K8/K7 launchers" markers, @stream, @kres, @nopersist, @acc, @fastexp,
//    @nopass1) leave K9 as it is.
// 5. Determinism: every reduction (k16 steps, tiles, the pair, the quad)
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

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int MAX_S = 1024;   // longest sequence (K9 keeps per-head vectors of it)

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

constexpr size_t SMEM_OPTIN = 232448;  // an sm_90 block's dynamic shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A (16 x 16) B (16 x 8), f32 accumulated in the instruction (the PV
// probe's mma.sync side: the mma.sync build's PV). With g = lane / 4, t =
// lane % 4 (the PTX ISA's m16n8k16 layout): a[0] (row g, k 2t..2t+1), a[1]
// (row g+8, k 2t..), a[2] (row g, k 2t+8..), a[3] (row g+8, k 2t+8..); b0
// (k 2t..2t+1, col g), b1 (k 2t+8.., col g); c[0..1] (row g, cols 2t, 2t+1),
// c[2..3] (row g+8, cols 2t, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// ---------------------------------------------------------------------------
// K9: the recompute backward on wgmma fed by TMA (see the header)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int WG_ROWS = 64;      // rows of a warpgroup's tile and of a streamed tile
constexpr int K9_STAGES = 3;     // the ring of streamed tiles
constexpr int K9_SWEEPS = 4;     // the query kernel's sweeps over the head's keys
constexpr int K9_STATS = 4;      // per query row: m, l, row and 1/l
// A block is a producer warpgroup and two consumer warpgroups of 64 rows.
// (Three consumer warpgroups in the query kernel, at 160 registers each,
// ran 2 % faster at hd 64 and spilled there: PERF.md §6.)
constexpr int K9_ROWS = 2 * WG_ROWS;  // query rows (keys) of a query (key) block
constexpr int K9_THREADS = 384;
constexpr int K9_CONSUMERS = 256;
// setmaxnreg: 40 x 128 + 232 x 256 = 168 x 384 registers, the block's
// allocation at __launch_bounds__(K9_THREADS, 1).
constexpr int K9_PRODUCER_REGS = 40;
constexpr int K9_CONSUMER_REGS = 232;
constexpr int K9_LAUNCH_REGS =
    (K9_PRODUCER_REGS * 128 + K9_CONSUMER_REGS * K9_CONSUMERS) / K9_THREADS;
static_assert(K9_LAUNCH_REGS * K9_THREADS <= 65536, "one block an SM");

// QK^T (S and S^T): each k16 step from +0.0 and added with one rounded add,
// in increasing step order (true; K8's s_tile rule), or accumulated inside
// the wgmma (false: a measurement variant only).
constexpr bool K9_QK_ADDS = true;
// dp, dv, dk and dq: each k16 step from +0.0 and added with one rounded add,
// as QK^T (true), or accumulated inside the wgmma (false).
constexpr bool K9_STEP_ADDS = true;

// The exponential and the division of p = exp(l - m) / sum: the accurate
// expf (not __expf) and the correctly rounded division, in both kernels.
__device__ __forceinline__ float k9_exp(float x) {
  return expf(x);
}

__device__ __forceinline__ float k9_div(float a, float b) {
  return __fdiv_rn(a, b);
}

// e / l, branch free, nearly always k9_div(e, l): e y corrected once by the
// residual (Markstein's step). y ~ 1/l: its accuracy moves only how often
// the certificate fails, never p's bits.
__device__ __forceinline__ float k9_quot(float e, float l, float y) {
  const float q0 = __fmul_rn(e, y);
  return __fmaf_rn(__fmaf_rn(-l, q0, e), y, q0);
}

// Whether q is k9_div(e, l), for e in [0, 1] and l >= 1 (a softmax row's
// sum): the exact residual r = e - l q below half an ulp of q times l (a
// quarter below a power of two) makes q the float nearest e / l. False on a
// tie, an off-by-one and a quotient below 2^-100.
__device__ __forceinline__ bool k9_certified(float e, float l, float q) {
  const float r = __fmaf_rn(-l, q, e);
  const int bits = __float_as_int(q);
  const float hl = __fmul_rn(__int_as_float((bits & 0x7f800000) - (24 << 23)), l);
  const float thr = ((bits & 0x7fffff) == 0 && r < 0.f) ? __fmul_rn(hl, 0.5f) : hl;
  return e == 0.f || (bits >= (27 << 23) && fabsf(r) < thr);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ds_of(float p, float dp, float row,
                                       float scale) {
  return bf16_round(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, row)), scale));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The quad's rounded sum, the same bits in its four threads.
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// This thread's warp, through a shuffle from lane 0: ptxas then knows it is
// uniform in the warp and need not serialize the wgmmas of a role's branch.
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. (No __trap: a trap
// anywhere in the kernel keeps ptxas from honouring setmaxnreg.)
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

// One box of a 3-D tensor map (x the lane, y the row, z the plane) into
// shared memory; its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x,
                                            int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory; they complete a transaction of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

template <int NC, int N>
__device__ __forceinline__ void fence_regs(float (&d)[NC][N]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(d[c]);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
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
// its HD columns: its 64 rows are M or N): 8-row groups SBO = 8 W apart, the
// step 32 bytes into its chunk.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = TileLayout<HD>;
  constexpr int KPC = L::W / 32;  // k16 steps per chunk
  return gmma_desc(tile + (kk / KPC) * L::CHUNK_BYTES + (kk % KPC) * 32, 16, 8 * L::W,
                   L::SWIZZLE);
}

// The descriptor of k16 step kk of a tile read MN-major (the contraction
// over its 64 rows, columns 64 c .. of its HD the N of the product): the
// step's 16 rows, 8-row groups SBO = 8 W apart, column chunk c.
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c) {
  using L = TileLayout<HD>;
  return gmma_desc(tile + c * L::CHUNK_BYTES + kk * 16 * L::W, L::CHUNK_BYTES, 8 * L::W,
                   L::SWIZZLE);
}

// Rows [y, y + 64) of lanes [x, x + HD) of plane z of a 3-D tensor map into
// a tile; rows past the map's end land as zeros.
template <int HD>
__device__ __forceinline__ void load_tile(unsigned char* tile, const CUtensorMap* map, int x,
                                          int y, int z, uint64_t* bar) {
  using L = TileLayout<HD>;
#pragma unroll
  for (int c = 0; c < L::CHUNKS; ++c)
    tma_load_3d(tile + c * L::CHUNK_BYTES, map, x + c * (L::W / 2), y, z, bar);
}

// d (64 x 64 f32 over one warpgroup; register d[4j + e] of lane l in warp w
// holds row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2) = A B^T (+ d if
// acc): A 64 x 16 and B 64 x 16, both K-major in shared memory. acc = 0
// (scale-d = 0) does not read d: the step's sum starts from nothing.
__device__ __forceinline__ void wg_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
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

// d (64 x N, the layout of wg_ss64) = A B (+ d if acc): A 64 x 16 bf16 in
// registers (lane l of warp w: a[0] row 16w + l/4, k 2(l%4), +1; a[1] the
// row + 8; a[2], a[3] k + 8), B 16 x N MN-major in shared memory
// (transposed: N contiguous).
template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                      int acc);

template <>
__device__ __forceinline__ void wg_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wg_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35},"
      " %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// A consumer's 64 x HD f32 accumulator of dq, dk or dv: UC units of UN
// columns (column 64 c + 8 j + 2 t + e of a thread's row h in acc[c][4 j + 2
// h + e]; one unit below hd 128, two at hd 128), one wgmma m64nUNk16 each.
template <int HD>
constexpr int UN = HD < 64 ? HD : 64;
template <int HD>
constexpr int UC = HD / UN<HD>;
// Product fragments in flight beside an accumulator: two (each k16 step's
// product added while the next runs), one where registers are short (the
// key kernel at hd 128, whose dk and dv take 128). The query kernel keeps
// two: with one, its dq at hd 128 came out wrong on the card (PERF.md §6),
// where the key kernel's dk and dv with one are right.
template <int HD>
constexpr int K9_KEY_PRODUCTS = HD > 64 ? 1 : 2;
constexpr int K9_QUERY_PRODUCTS = 2;
// dq sums each key tile's share from +0.0 before adding it (the mma.sync
// build's per-warp partials, the float64 line's choice) up to hd 64; at hd
// 128 the share's 64 registers would spill, and dq takes the steps in order.
template <int HD>
constexpr bool K9_DQ_SHARES = HD <= 64;

// Element (column group j < HD / 8, row h, e) of a 64 x HD accumulator.
template <int HD>
__device__ __forceinline__ float& acc_at(float (&acc)[UC<HD>][UN<HD> / 2], int j, int h,
                                         int e) {
  constexpr int JN = UN<HD> / 8;
  return acc[j / JN][4 * (j % JN) + 2 * h + e];
}

// d (64 x 64 over the warpgroup, the layout of wg_ss64) = the HD-deep dot of
// the 64 rows of tile ta with the 64 rows of tile tb, both read K-major.
// ADDS: each k16 step from +0.0 (scale-d = 0), step 0 straight into d and
// every later one into one of NP product fragments, added to d with one
// __fadd_rn in increasing step order while the next step runs; else
// accumulated inside the wgmma. Every wgmma is complete on return.
template <int HD, bool ADDS, int NP>
__device__ __forceinline__ void dot64(float (&d)[32], uint32_t ta, uint32_t tb) {
  constexpr int KS = HD / 16;
  fence_regs(d);
  wgmma_fence();
  if constexpr (!ADDS || KS == 1) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wg_ss64(d, desc_k<HD>(ta, kk), desc_k<HD>(tb, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    float p[NP][32];
    wg_ss64(d, desc_k<HD>(ta, 0), desc_k<HD>(tb, 0), 0);
    wgmma_commit();
    wg_ss64(p[0], desc_k<HD>(ta, 1), desc_k<HD>(tb, 1), 0);
    wgmma_commit();
#pragma unroll
    for (int v = 1; v < KS; ++v) {  // step v's product is in p[(v - 1) % NP]
      if (NP > 1 && v + 1 < KS) {
        fence_regs(d);
        wgmma_fence();
        wg_ss64(p[v % NP], desc_k<HD>(ta, v + 1), desc_k<HD>(tb, v + 1), 0);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(d);
      fence_regs(p[(v - 1) % NP]);
#pragma unroll
      for (int e = 0; e < 32; ++e) d[e] = __fadd_rn(d[e], p[(v - 1) % NP][e]);
      if (NP == 1 && v + 1 < KS) {
        fence_regs(d);
        wgmma_fence();
        wg_ss64(p[0], desc_k<HD>(ta, v + 1), desc_k<HD>(tb, v + 1), 0);
        wgmma_commit();
      }
    }
  }
  fence_regs(d);
}

// acc (the 64 x HD accumulator) += A B: A the 64 x 64 tile repacked from an
// accumulator into four k16 steps of A fragments (a[kk], C -> A), B the 64 x
// HD tile tb read MN-major (the contraction over its 64 rows). ADDS: each
// (k16 step, column unit) from +0.0 into one of NP product fragments and
// added with one __fadd_rn, a unit's steps in increasing order; else
// accumulated inside the wgmma. Every wgmma is complete on return.
template <int HD, bool ADDS, int NP>
__device__ __forceinline__ void acc_rows(float (&acc)[UC<HD>][UN<HD> / 2],
                                         uint32_t (&a)[4][4], uint32_t tb) {
  constexpr int N = UN<HD>, NC = UC<HD>, U = 4 * NC;
  fence_regs(a);
  fence_regs(acc);
  wgmma_fence();
  if constexpr (!ADDS) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) wg_rs<N>(acc[c], a[kk], desc_mn<HD>(tb, kk, c), 1);
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    float p[NP][N / 2];
    wg_rs<N>(p[0], a[0], desc_mn<HD>(tb, 0, 0), 0);
    wgmma_commit();
#pragma unroll
    for (int v = 0; v < U; ++v) {  // unit v = (step v / NC, column unit v % NC)
      if (NP > 1 && v + 1 < U) {
        fence_regs(acc);
        wgmma_fence();
        wg_rs<N>(p[(v + 1) % NP], a[(v + 1) / NC], desc_mn<HD>(tb, (v + 1) / NC, (v + 1) % NC),
                 0);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(acc[v % NC]);
      fence_regs(p[v % NP]);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[v % NC][e] = __fadd_rn(acc[v % NC][e], p[v % NP][e]);
      if (NP == 1 && v + 1 < U) {
        fence_regs(acc[v % NC]);
        wgmma_fence();
        wg_rs<N>(p[0], a[(v + 1) / NC], desc_mn<HD>(tb, (v + 1) / NC, (v + 1) % NC), 0);
        wgmma_commit();
      }
    }
  }
  fence_regs(acc);
  fence_regs(a);
}

// The four bf16 pairs of n8 columns 8j .. 8j + 7 of a 64 x 64 f32 tile (the
// wg_ss64 layout) as the A fragment of k16 step j / 2 of the next product:
// the accumulator's columns become the contraction.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], int j, float v0, float v1, float v2,
                                       float v3) {
  a[j >> 1][2 * (j & 1)] = pack_bf16x2(v0, v1);
  a[j >> 1][2 * (j & 1) + 1] = pack_bf16x2(v2, v3);
}

// p = k9_div(e, l) of a thread's 32 cells, ly(i) = (l, y) the cell's row
// sum and its reciprocal. CERTIFY: k9_quot, each cell certified; if any
// lane of the warp was not, k9_div for every cell of the warp (a
// warp-uniform branch, rare); returns whether it was. Else `exact`
// (warp-uniform: what an earlier certification of these cells returned)
// picks k9_div or k9_quot alone, whose bits are then certified already. e =
// 0 gives p = 0 whatever l (a key kernel's cell past S reads no real
// statistics), as k9_div(0, l) does.
template <bool CERTIFY, typename LY>
__device__ __forceinline__ bool k9_probs(const float (&e)[32], LY ly, bool exact,
                                         float (&p)[32]) {
  bool slow = false;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float2 v = ly(i);
    const float q = k9_quot(e[i], v.x, v.y);
    if constexpr (CERTIFY) slow = slow || !k9_certified(e[i], v.x, q);
    p[i] = e[i] == 0.f ? 0.f : q;
  }
  slow = CERTIFY ? __any_sync(0xffffffffu, slow) : exact;
  if (slow) {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = e[i] == 0.f ? 0.f : k9_div(e[i], ly(i).x);
  }
  return slow;
}

// Where sweep 3 of the query kernel fell back to k9_div: a byte per (b, h,
// 16-row group, 64-key tile), 1 where any cell of the warp's rows and that
// tile was not certified. Sweep 4 and the key kernel take k9_quot alone on
// every other cell (the same function of the same bits).
__host__ __device__ __forceinline__ size_t k9_flag_bytes(size_t BH, int S) {
  return BH * (size_t)((S + K9_ROWS - 1) / K9_ROWS) * (K9_ROWS / 16) *
         (size_t)((S + WG_ROWS - 1) / WG_ROWS);
}

// The logits of a query-major S tile in place: f32 dot times scale plus the
// key's bias (bias points at the head's first key), -inf for keys at or past
// S (an n8 group of keys is wholly below S or wholly past it).
__device__ __forceinline__ void q_logits(float (&s)[32], const float* bias, int k0, int S,
                                         float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + 8 * j + 2 * t;
    if (k0 + 8 * j < S) {
      const float2 bk = *reinterpret_cast<const float2*>(bias + k);
      s[4 * j] = logit_of(s[4 * j], scale, bk.x);
      s[4 * j + 1] = logit_of(s[4 * j + 1], scale, bk.y);
      s[4 * j + 2] = logit_of(s[4 * j + 2], scale, bk.x);
      s[4 * j + 3] = logit_of(s[4 * j + 3], scale, bk.y);
    } else {
      s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = -INFINITY;
    }
  }
}

#ifdef K9_DUMP
// Debug builds (bench/ab_attn.py @dump): p, dp and ds of (query q, key k)
// as each kernel saw them, at dump[((pass * BH + bh) * 3 + c) * S * S +
// q * S + k] behind the scratch (c = 0 p, 1 dp, 2 ds).
__device__ __forceinline__ void k9_dump(float* dump, int pass, size_t bh,
                                        size_t BH, int S, int q, int k,
                                        float p, float dp, float ds) {
  const size_t at = ((pass * BH + bh) * 3) * S * S + (size_t)q * S + k;
  dump[at] = p;
  dump[at + (size_t)S * S] = dp;
  dump[at + 2 * (size_t)S * S] = ds;
}
#endif

// The tensor maps K9 reads through: the rotated q and k (the scratch [2, B,
// H, S, HD]: planes c * B * H + b * H + h), qkv (for v: planes b, lanes (2 H
// + h) HD ..) and g (planes b, lanes h HD ..); rows past S land as zeros.
struct K9Maps {
  CUtensorMap rot, qkv, g;
};

// A K9 block's dynamic shared memory: 64 bytes of mbarriers (full[STAGES],
// empty[STAGES], the resident tiles'), up to the next 1024-byte boundary;
// the two consumers' resident tiles (q_r[2], g[2]; k_r[2], v[2]); STAGES
// stages of two streamed tiles (k_r and v; q_r and g); K9_STATS per-head
// f32 vectors of MAX_S (the key bias; m, l, row and 1/l); at hd 128 the key
// kernel's p slots (32 f32 a consumer thread, element e of thread i at e *
// K9_CONSUMERS + i).
template <int HD>
struct K9Layout {
  static constexpr int TILE = TileLayout<HD>::BYTES;
  static constexpr int RESIDENT = 4 * TILE;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int VEC = 4 * MAX_S;
  static constexpr bool P_SMEM = HD > 64;
  static constexpr int PSLOTS = P_SMEM ? 32 * 4 * K9_CONSUMERS : 0;
  static constexpr int BYTES =
      1024 + 64 + RESIDENT + K9_STAGES * STAGE + K9_STATS * VEC + PSLOTS;
};
static_assert(K9Layout<128>::BYTES <= SMEM_OPTIN, "K9's shared memory fits a block");

// The resident tiles' start: the next 1024-byte boundary past the mbarriers.
__device__ __forceinline__ unsigned char* k9_tiles(unsigned char* smem) {
  const uint32_t a = smem_addr(smem);
  return smem + ((a + 64 + 1023) / 1024 * 1024 - a);
}

__device__ __forceinline__ void k9_init_barriers(uint64_t* full, uint64_t* empty,
                                                 uint64_t* res) {
  for (int s = 0; s < K9_STAGES; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], K9_CONSUMERS);
  }
  mbar_init(res, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The query kernel: a block per (b, h, 128 query rows). Warpgroup 0 is the
// producer (one thread issues every copy); consumer warpgroup cw owns rows
// q0 + 64 cw .. + 63, its rotated q and g tiles resident. The head's key
// tiles stream through the ring four times (sweeps): 1. S = Q_r K_r^T, the
// exact row max; 2. S, e = exp(l - m), the f32 sum l; 3. S and dP = G V^T,
// p = e / l, row = sum(dp p); 4. S and dP, p, ds, dQ_r += dS K_r. Then the
// rotary adjoint of dq and one rounding, and m, l, row to the statistics.
template <int HD>
__global__ void __launch_bounds__(K9_THREADS, 1)
    k9_wg_query(const __grid_constant__ K9Maps maps, const float* __restrict__ cos2,
                const float* __restrict__ s2, const float* __restrict__ bias, int S, int H,
                float scale, float* __restrict__ stats, bf16* __restrict__ dqkv) {
  using L = TileLayout<HD>;
  using Y = K9Layout<HD>;
  extern __shared__ __align__(16) unsigned char k9_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(k9_smem);
  uint64_t* empty = full + K9_STAGES;
  uint64_t* res = empty + K9_STAGES;
  unsigned char* tiles = k9_tiles(k9_smem);  // q_r[2], g[2]
  unsigned char* ring = tiles + Y::RESIDENT;  // STAGES x {k_r, v}
  float* bs = reinterpret_cast<float*>(ring + K9_STAGES * Y::STAGE);  // the key bias
  const int n = (S + WG_ROWS - 1) / WG_ROWS;
  const int blocks = (S + K9_ROWS - 1) / K9_ROWS;
  const int bh = blockIdx.x / blocks, b = bh / H, h = bh % H;
  const int BH = gridDim.x / blocks;
  const int q0 = (blockIdx.x % blocks) * K9_ROWS;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) k9_init_barriers(full, empty, res);
  __syncthreads();

  if (warp < 4) {  // the producer
    setmaxnreg_dec<K9_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(res, 4 * L::BYTES + 4 * S);
      for (int c = 0; c < 2; ++c) {
        load_tile<HD>(tiles + c * L::BYTES, &maps.rot, 0, q0 + c * WG_ROWS, bh, res);
        load_tile<HD>(tiles + (2 + c) * L::BYTES, &maps.g, h * HD, q0 + c * WG_ROWS, b, res);
      }
      bulk_load(bs, bias + (size_t)b * S, 4 * S, res);
      for (int i = 0; i < K9_SWEEPS * n; ++i) {
        const int stage = i % K9_STAGES;
        if (i >= K9_STAGES) mbar_wait(&empty[stage], (i / K9_STAGES - 1) & 1);
        unsigned char* st = ring + stage * Y::STAGE;
        const int k0 = (i % n) * WG_ROWS;
        const bool with_v = i >= 2 * n;  // sweeps 3 and 4 take dP
        mbar_expect_tx(&full[stage], (with_v ? 2 : 1) * L::BYTES);
        load_tile<HD>(st, &maps.rot, 0, k0, BH + bh, &full[stage]);
        if (with_v) load_tile<HD>(st + L::BYTES, &maps.qkv, (2 * H + h) * HD, k0, b, &full[stage]);
      }
    }
  } else {  // a consumer: query rows q0 + 64 cw .. + 63
    setmaxnreg_inc<K9_CONSUMER_REGS>();
    constexpr int NP = K9_QUERY_PRODUCTS;
    const int cw = (warp >> 2) - 1;
    const int g = lane >> 2, t = lane & 3;
    const int r = q0 + cw * WG_ROWS + 16 * (warp & 3) + g;  // this thread's rows r, r + 8
    const uint32_t qa = smem_addr(tiles + cw * L::BYTES);
    const uint32_t ga = smem_addr(tiles + (2 + cw) * L::BYTES);
    mbar_wait(res, 0);
    int i = 0;  // the ring's running tile

    // Sweep 1: the exact row max.
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j = 0; j < n; ++j, ++i) {
      mbar_wait(&full[i % K9_STAGES], (i / K9_STAGES) & 1);
      const uint32_t ka = smem_addr(ring + (i % K9_STAGES) * Y::STAGE);
      float s[32];
      dot64<HD, K9_QK_ADDS, NP>(s, qa, ka);
      mbar_arrive(&empty[i % K9_STAGES]);
      q_logits(s, bs, j * WG_ROWS, S, scale);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        m0 = fmaxf(m0, fmaxf(s[4 * jj], s[4 * jj + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // Sweep 2: l, the f32 sum of e = exp(l - m), key tile after key tile.
    float l0 = 0.f, l1 = 0.f;
    for (int j = 0; j < n; ++j, ++i) {
      mbar_wait(&full[i % K9_STAGES], (i / K9_STAGES) & 1);
      const uint32_t ka = smem_addr(ring + (i % K9_STAGES) * Y::STAGE);
      float s[32];
      dot64<HD, K9_QK_ADDS, NP>(s, qa, ka);
      mbar_arrive(&empty[i % K9_STAGES]);
      q_logits(s, bs, j * WG_ROWS, S, scale);
      float t0 = 0.f, t1 = 0.f;  // the tile's share
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        t0 = __fadd_rn(__fadd_rn(t0, k9_exp(__fsub_rn(s[4 * jj], m0))),
                       k9_exp(__fsub_rn(s[4 * jj + 1], m0)));
        t1 = __fadd_rn(__fadd_rn(t1, k9_exp(__fsub_rn(s[4 * jj + 2], m1))),
                       k9_exp(__fsub_rn(s[4 * jj + 3], m1)));
      }
      l0 = __fadd_rn(l0, t0);
      l1 = __fadd_rn(l1, t1);
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float y0 = __frcp_rn(l0), y1 = __frcp_rn(l1);
    // a cell's row sum and its reciprocal (cells 4j, 4j + 1 row r; + 2, + 3 row r + 8)
    const auto ly = [&](int i) {
      return (i & 2) ? make_float2(l1, y1) : make_float2(l0, y0);
    };

    // Sweep 3: row = sum(dp * p), p = e / l.
    float w0 = 0.f, w1 = 0.f;
    uint32_t fb = 0;  // the key tiles where the warp fell back to k9_div
    for (int j = 0; j < n; ++j, ++i) {
      mbar_wait(&full[i % K9_STAGES], (i / K9_STAGES) & 1);
      const unsigned char* st = ring + (i % K9_STAGES) * Y::STAGE;
      float s[32], dp[32];
      dot64<HD, K9_QK_ADDS, NP>(s, qa, smem_addr(st));
      dot64<HD, K9_STEP_ADDS, NP>(dp, ga, smem_addr(st + L::BYTES));
      mbar_arrive(&empty[i % K9_STAGES]);
      q_logits(s, bs, j * WG_ROWS, S, scale);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = k9_exp(__fsub_rn(s[e], (e & 2) ? m1 : m0));
      float p[32];
      if (k9_probs<true>(s, ly, false, p)) fb |= 1u << j;
      float t0 = 0.f, t1 = 0.f;  // the tile's share
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        if (e & 2)
          t1 = __fadd_rn(t1, __fmul_rn(dp[e], p[e]));
        else
          t0 = __fadd_rn(t0, __fmul_rn(dp[e], p[e]));
      }
      w0 = __fadd_rn(w0, t0);
      w1 = __fadd_rn(w1, t1);
    }
    w0 = quad_sum(w0);
    w1 = quad_sum(w1);

    // Sweep 4: ds = bf16(p (dp - row) scale), repacked C -> A, dQ_r += dS K_r.
    float dq[UC<HD>][UN<HD> / 2];
#pragma unroll
    for (int c = 0; c < UC<HD>; ++c)
#pragma unroll
      for (int e = 0; e < UN<HD> / 2; ++e) dq[c][e] = 0.f;
    for (int j = 0; j < n; ++j, ++i) {
      mbar_wait(&full[i % K9_STAGES], (i / K9_STAGES) & 1);
      const unsigned char* st = ring + (i % K9_STAGES) * Y::STAGE;
      const uint32_t ka = smem_addr(st);
      float s[32], dp[32];
      dot64<HD, K9_QK_ADDS, NP>(s, qa, ka);
      dot64<HD, K9_STEP_ADDS, NP>(dp, ga, smem_addr(st + L::BYTES));
      q_logits(s, bs, j * WG_ROWS, S, scale);
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = k9_exp(__fsub_rn(s[e], (e & 2) ? m1 : m0));
      float p[32];
      k9_probs<false>(s, ly, (fb >> j) & 1u, p);
      uint32_t sa[4][4];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds[e] = ds_of(p[4 * jj + e], dp[4 * jj + e], e < 2 ? w0 : w1, scale);
#ifdef K9_DUMP
          const int q = r + 8 * (e >> 1), k = j * WG_ROWS + 8 * jj + 2 * t + (e & 1);
          if (q < S && k < S)
            k9_dump(stats + (size_t)BH * S * (K9_STATS + HD) + (k9_flag_bytes(BH, S) + 3) / 4, 0,
                    bh, BH, S, q, k, p[4 * jj + e], dp[4 * jj + e], ds[e]);
#endif
        }
        pack_a(sa, jj, ds[0], ds[1], ds[2], ds[3]);
      }
      if constexpr (K9_DQ_SHARES<HD>) {  // the tile's share of dq_r from +0.0, then added
        float part[UC<HD>][UN<HD> / 2];
#pragma unroll
        for (int c = 0; c < UC<HD>; ++c)
#pragma unroll
          for (int e = 0; e < UN<HD> / 2; ++e) part[c][e] = 0.f;
        acc_rows<HD, K9_STEP_ADDS, NP>(part, sa, ka);
        mbar_arrive(&empty[i % K9_STAGES]);
#pragma unroll
        for (int c = 0; c < UC<HD>; ++c)
#pragma unroll
          for (int e = 0; e < UN<HD> / 2; ++e) dq[c][e] = __fadd_rn(dq[c][e], part[c][e]);
      } else {
        acc_rows<HD, K9_STEP_ADDS, NP>(dq, sa, ka);
        mbar_arrive(&empty[i % K9_STAGES]);
      }
    }

    if (lane == 0) {  // sweep 3's fallbacks, for sweep 4's twin: the key kernel
      uint8_t* flags = reinterpret_cast<uint8_t*>(stats + (size_t)BH * S * (K9_STATS + HD));
      const size_t grp = (size_t)bh * blocks * (K9_ROWS / 16) + (r - g) / 16;
      for (int j = 0; j < n; ++j) flags[grp * n + j] = (fb >> j) & 1u;
    }

    // dq through the rotary adjoint (lane d's partner d + HD/2 is column
    // group j + HD/16 of the same thread), one rounding; m, l and row.
    const int row_stride = 3 * H * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int sq = r + 8 * hh;
      if (sq >= S) continue;
      const float* c = cos2 + (size_t)sq * HD;
      const float* sn = s2 + (size_t)sq * HD;
      bf16* out = dqkv + ((size_t)b * S + sq) * row_stride + h * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + 2 * t;
        const int jp = (j + HD / 16) % (HD / 8), dpart = 8 * jp + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(acc_at<HD>(dq, j, hh, 0), c[d]),
                      __fmul_rn(acc_at<HD>(dq, jp, hh, 0), sn[dpart])),
            __fadd_rn(__fmul_rn(acc_at<HD>(dq, j, hh, 1), c[d + 1]),
                      __fmul_rn(acc_at<HD>(dq, jp, hh, 1), sn[dpart + 1])));
      }
      if (t == 0) {
        const size_t bhs = (size_t)BH * S, at = (size_t)bh * S + sq;
        stats[at] = hh ? m1 : m0;
        stats[bhs + at] = hh ? l1 : l0;
        stats[2 * bhs + at] = hh ? w1 : w0;
        stats[3 * bhs + at] = hh ? y1 : y0;
      }
    }
  }
}

// The key kernel: a block per (b, h, 128 keys), the same three warpgroups.
// Consumer warpgroup cw owns keys k0 + 64 cw .. + 63, its k_r and v tiles
// resident, and the head's m, l and row (written by the query kernel) lie in
// shared memory; the head's query tiles (q_r, g) stream through the ring
// once. Per tile: S^T = K_r Q_r^T, p from the stored m and l, dV += bf16(P)^T
// G; dP^T = V G^T, ds with the stored row, dK_r += dS^T Q_r. dK and dV stay
// in f32 registers and are written once (dk through the rotary adjoint).
template <int HD>
__global__ void __launch_bounds__(K9_THREADS, 1)
    k9_wg_key(const __grid_constant__ K9Maps maps, const float* __restrict__ cos2,
              const float* __restrict__ s2, const float* __restrict__ bias, int S, int H,
              float scale, float* __restrict__ stats, bf16* __restrict__ dqkv) {
  using L = TileLayout<HD>;
  using Y = K9Layout<HD>;
  extern __shared__ __align__(16) unsigned char k9_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(k9_smem);
  uint64_t* empty = full + K9_STAGES;
  uint64_t* res = empty + K9_STAGES;
  unsigned char* tiles = k9_tiles(k9_smem);  // k_r[2], v[2]
  unsigned char* ring = tiles + Y::RESIDENT;  // STAGES x {q_r, g}
  float* mq = reinterpret_cast<float*>(ring + K9_STAGES * Y::STAGE);  // m, l, row, 1/l
  const int n = (S + WG_ROWS - 1) / WG_ROWS;
  const int blocks = (S + K9_ROWS - 1) / K9_ROWS;
  const int bh = blockIdx.x / blocks, b = bh / H, h = bh % H;
  const int BH = gridDim.x / blocks;
  const int k0 = (blockIdx.x % blocks) * K9_ROWS;
  const int warp = warp_index(), lane = threadIdx.x & 31;
  if (threadIdx.x == 0) k9_init_barriers(full, empty, res);
  __syncthreads();

  if (warp < 4) {  // the producer
    setmaxnreg_dec<K9_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const size_t bhs = (size_t)BH * S;
      mbar_expect_tx(res, 4 * L::BYTES + K9_STATS * 4 * S);
      for (int c = 0; c < 2; ++c) {
        load_tile<HD>(tiles + c * L::BYTES, &maps.rot, 0, k0 + c * WG_ROWS, BH + bh, res);
        load_tile<HD>(tiles + (2 + c) * L::BYTES, &maps.qkv, (2 * H + h) * HD,
                      k0 + c * WG_ROWS, b, res);
      }
      for (int c = 0; c < K9_STATS; ++c)
        bulk_load(mq + c * MAX_S, stats + c * bhs + (size_t)bh * S, 4 * S, res);
      for (int i = 0; i < n; ++i) {
        const int stage = i % K9_STAGES;
        if (i >= K9_STAGES) mbar_wait(&empty[stage], (i / K9_STAGES - 1) & 1);
        unsigned char* st = ring + stage * Y::STAGE;
        mbar_expect_tx(&full[stage], 2 * L::BYTES);
        load_tile<HD>(st, &maps.rot, 0, i * WG_ROWS, bh, &full[stage]);
        load_tile<HD>(st + L::BYTES, &maps.g, h * HD, i * WG_ROWS, b, &full[stage]);
      }
    }
  } else {  // a consumer: keys k0 + 64 cw .. + 63
    setmaxnreg_inc<K9_CONSUMER_REGS>();
    constexpr int NP = K9_KEY_PRODUCTS<HD>;
    const int cw = (warp >> 2) - 1;
    const int g = lane >> 2, t = lane & 3;
    const int r = k0 + cw * WG_ROWS + 16 * (warp & 3) + g;  // this thread's keys r, r + 8
    const float bk0 = r < S ? bias[(size_t)b * S + r] : 0.f;
    const float bk1 = r + 8 < S ? bias[(size_t)b * S + r + 8] : 0.f;
    const uint32_t ka = smem_addr(tiles + cw * L::BYTES);
    const uint32_t va = smem_addr(tiles + (2 + cw) * L::BYTES);
    const float* lq = mq + MAX_S;
    const float* rq = mq + 2 * MAX_S;
    const float* yq = mq + 3 * MAX_S;
    const uint8_t* flags =
        reinterpret_cast<const uint8_t*>(stats + (size_t)BH * S * (K9_STATS + HD));
    const int kt = (k0 + cw * WG_ROWS) / WG_ROWS;  // this warpgroup's key tile
    float* ps = mq + K9_STATS * MAX_S + (threadIdx.x - 128);  // P_SMEM: this thread's p
    float dk[UC<HD>][UN<HD> / 2], dv[UC<HD>][UN<HD> / 2];
#pragma unroll
    for (int c = 0; c < UC<HD>; ++c)
#pragma unroll
      for (int e = 0; e < UN<HD> / 2; ++e) dk[c][e] = dv[c][e] = 0.f;
    mbar_wait(res, 0);
#ifdef K9_DUMP
    float* dump = stats + (size_t)BH * S * (K9_STATS + HD) + (k9_flag_bytes(BH, S) + 3) / 4;
#endif
    for (int i = 0; i < n; ++i) {
      mbar_wait(&full[i % K9_STAGES], (i / K9_STAGES) & 1);
      const unsigned char* st = ring + (i % K9_STAGES) * Y::STAGE;
      const uint32_t qa = smem_addr(st), ga = smem_addr(st + L::BYTES);
      const int q0 = i * WG_ROWS;
      // S^T: rows are this warpgroup's keys, columns the tile's queries
      float s[32];
      dot64<HD, K9_QK_ADDS, NP>(s, ka, qa);
      // e of each cell (0 where its query or key lies past S), then p
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = q0 + 8 * j + 2 * t;  // an n8 group of queries is wholly < S or >= S
        const float2 m2 = *reinterpret_cast<const float2*>(mq + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = q0 + 8 * j < S && r + 8 * (e >> 1) < S;
          const float lg = logit_of(s[4 * j + e], scale, e < 2 ? bk0 : bk1);
          s[4 * j + e] = ok ? k9_exp(__fsub_rn(lg, (e & 1) ? m2.y : m2.x)) : 0.f;
        }
      }
      // the query kernel's fallbacks on these cells: its four 16-row groups of
      // the tile's queries against this warpgroup's key tile
      const uint8_t* fl = flags + ((size_t)bh * blocks * (K9_ROWS / 16) + 4 * i) * n + kt;
      const bool exact = fl[0] | fl[n] | fl[2 * n] | fl[3 * n];
      float p[32];
      k9_probs<false>(s, [&](int i) {
        const int c = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
        return make_float2(lq[c], yq[c]);
      }, exact, p);
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) pack_a(pa, j, p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
      if constexpr (Y::P_SMEM) {
#pragma unroll
        for (int e = 0; e < 32; ++e) ps[e * K9_CONSUMERS] = p[e];
      }
      acc_rows<HD, K9_STEP_ADDS, NP>(dv, pa, ga);
      float dp[32];
      dot64<HD, K9_STEP_ADDS, NP>(dp, va, ga);  // dP^T
      uint32_t sa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = q0 + 8 * j + 2 * t;
        const float2 w2 = *reinterpret_cast<const float2*>(rq + c);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = q0 + 8 * j < S && r + 8 * (e >> 1) < S;
          float pe;
          if constexpr (Y::P_SMEM)
            pe = ps[(4 * j + e) * K9_CONSUMERS];
          else
            pe = p[4 * j + e];
          ds[e] = ok ? ds_of(pe, dp[4 * j + e], (e & 1) ? w2.y : w2.x, scale) : 0.f;
#ifdef K9_DUMP
          if (ok)
            k9_dump(dump, 1, bh, BH, S, c + (e & 1), r + 8 * (e >> 1), pe, dp[4 * j + e], ds[e]);
#endif
        }
        pack_a(sa, j, ds[0], ds[1], ds[2], ds[3]);
      }
      acc_rows<HD, K9_STEP_ADDS, NP>(dk, sa, qa);
      mbar_arrive(&empty[i % K9_STAGES]);
    }

    // dv straight out, dk through the rotary adjoint, one rounding each.
    const int row_stride = 3 * H * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int sk = r + 8 * hh;
      if (sk >= S) continue;
      const float* c = cos2 + (size_t)sk * HD;
      const float* sn = s2 + (size_t)sk * HD;
      bf16* out = dqkv + ((size_t)b * S + sk) * row_stride;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + 2 * t;
        const int jp = (j + HD / 16) % (HD / 8), dpart = 8 * jp + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(out + (2 * H + h) * HD + d) =
            __floats2bfloat162_rn(acc_at<HD>(dv, j, hh, 0), acc_at<HD>(dv, j, hh, 1));
        *reinterpret_cast<__nv_bfloat162*>(out + (H + h) * HD + d) = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(acc_at<HD>(dk, j, hh, 0), c[d]),
                      __fmul_rn(acc_at<HD>(dk, jp, hh, 0), sn[dpart])),
            __fadd_rn(__fmul_rn(acc_at<HD>(dk, j, hh, 1), c[d + 1]),
                      __fmul_rn(acc_at<HD>(dk, jp, hh, 1), sn[dpart + 1])));
      }
    }
  }
}

// The pre-pass: q_r and k_r, the rotary of every query and key of every
// head in f32 rounded once to bf16 (rotate_tile's arithmetic), into the
// scratch [2, B, H, S, HD] that both kernels read through TMA. One thread
// per lane pair (j, j + 1) and partners j + HD/2; consecutive threads write
// consecutive pairs of a scratch row.
template <int HD>
__global__ void __launch_bounds__(256)
    k9_rotate_qk(const bf16* __restrict__ qkv, const float* __restrict__ cos2,
                 const float* __restrict__ s2, int B, int S, int H, size_t items,
                 bf16* __restrict__ rot) {
  constexpr int H2 = HD / 2;
  constexpr int PAIRS = H2 / 2;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= items) return;
  const int j = (int)(i % PAIRS) * 2;
  const size_t row = i / PAIRS;  // ((c * B + b) * H + h) * S + s
  const int s = (int)(row % S);
  const size_t cbh = row / S;
  const int h = (int)(cbh % H);
  const size_t cb = cbh / H;
  const int b = (int)(cb % B), c = (int)(cb / B);
  const size_t at = ((size_t)b * S + s) * 3 * H * HD + (size_t)(c * H + h) * HD + j;
  const float2 xl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qkv + at));
  const float2 xh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qkv + at + H2));
  const float* cs = cos2 + (size_t)s * HD;
  const float* sn = s2 + (size_t)s * HD;
  const float2 cl = *reinterpret_cast<const float2*>(cs + j);
  const float2 ch = *reinterpret_cast<const float2*>(cs + j + H2);
  const float2 sl = *reinterpret_cast<const float2*>(sn + j);
  const float2 sh = *reinterpret_cast<const float2*>(sn + j + H2);
  bf16* out = rot + row * HD + j;
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(xl.x, cl.x), __fmul_rn(xh.x, sl.x)),
      __fadd_rn(__fmul_rn(xl.y, cl.y), __fmul_rn(xh.y, sl.y)));
  *reinterpret_cast<__nv_bfloat162*>(out + H2) = __floats2bfloat162_rn(
      __fadd_rn(__fmul_rn(xh.x, ch.x), __fmul_rn(xl.x, sh.x)),
      __fadd_rn(__fmul_rn(xh.y, ch.y), __fmul_rn(xl.y, sh.y)));
}

// ---------------------------------------------------------------------------
// K8 and K7: the forward on wgmma fed by TMA (see the header)
// ---------------------------------------------------------------------------

// The byte of lane d of row r in a 64-row tile as TMA writes it
// (TileLayout): column chunk d / (W / 2), 16-byte piece x / 8 of the row
// at its swizzled place, x = d % (W / 2).
template <int HD>
__device__ __forceinline__ int tile_byte(int r, int d) {
  using L = TileLayout<HD>;
  constexpr int LPC = L::W / 2;  // lanes of a column chunk
  const int x = d % LPC;
  return (d / LPC) * L::CHUNK_BYTES + r * L::W +
         16 * ((x / 8) ^ ((r / (128 / L::W)) % (L::W / 16))) + 2 * (x % 8);
}

// Writes by threads become visible to the async proxy (wgmma) only through
// this fence, made by the writers before they signal the readers.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ==== K8/K7 forward: begin ====

// A forward block is K9's: a producer warpgroup and two consumer
// warpgroups of 64 query rows, one block an SM, setmaxnreg 40 / 232 where
// the producer only copies and 56 / 224 where it also rotates K (the
// persistent and streamed modes: two rotary items in flight a thread).
constexpr int ATT_THREADS = 384;
constexpr int ATT_CONSUMERS = 256;
constexpr int ATT_PRODUCER_REGS = 40;
constexpr int ATT_CONSUMER_REGS = 232;
constexpr int ATT_ROTATING_PRODUCER_REGS = 56;
constexpr int ATT_ROTATING_CONSUMER_REGS = 224;
static_assert(ATT_THREADS == K9_THREADS &&
                  ATT_PRODUCER_REGS * 128 + ATT_CONSUMER_REGS * ATT_CONSUMERS ==
                      K9_LAUNCH_REGS * K9_THREADS &&
                  ATT_ROTATING_PRODUCER_REGS * 128 +
                          ATT_ROTATING_CONSUMER_REGS * ATT_CONSUMERS ==
                      K9_LAUNCH_REGS * K9_THREADS,
              "check_launch_regs holds the forward to K9's register allocation");
constexpr int ATT_STAGES = 4;                       // the streamed ring
constexpr int ATT_MAX_TILES = MAX_S / WG_ROWS;      // 64-row tiles of the longest S
// S = Q_r K_r^T: each k16 step from +0.0 (scale-d = 0) and added with one
// rounded add in increasing step order (true: the search kernels' rule, and
// the mma.sync build's), or accumulated inside the wgmma (false: @acc, a
// measurement variant). PV always accumulates inside the wgmma from o = 0,
// the mma.sync build's rule: the PV probe holds the two instructions'
// accumulations to each other (k_probe_pv_acc).
constexpr bool ATT_QK_ADDS = true;
// Product fragments of S's k16 steps in flight beside S (NP + 1 steps a
// batch, one wait a batch): all of hd 64's four steps at once; one at hd
// 128, whose o takes 64 registers (two spilled there).
template <int HD>
constexpr int ATT_PRODUCTS = HD == 64 ? 3 : 1;

// Pass 2 skips a key tile where every e of the warpgroup's rows is exactly
// 0: pass 1 finds each thread's tile maximum at least this far below its
// running maximum (expf(-120) is 0 in f32; the final maximum is no lower).
constexpr float ATT_SKIP_BELOW = -120.f;

// How a forward block holds a head's K and V (the launcher takes the first
// of these that fits a block's shared memory):
//  ATT_PERSISTENT: a block an SM walks heads; two K buffers and one V
//    buffer, each of the head's n = ceil(S / 64) tiles, so that the
//    producer loads and rotates the next head's K, and loads its V, while
//    the consumers work (every S at hd 16 and 32, S <= 512 at hd 64, S <=
//    256 at hd 128);
//  ATT_KRES: a block a head, its K resident and rotated by every thread
//    before the warpgroups split, its V streamed through ATT_STAGES stages
//    once for each pair of query tiles, which the two consumer warpgroups
//    take in step (hd 64 above S 512, hd 128 up to 512; a block a head with
//    V resident too was at most 2.5 % faster there and up to 10 % slower:
//    PERF.md §6);
//  ATT_RING: a block per 128 query rows; the head's K tiles, then its K and
//    V tiles, stream through ATT_STAGES stages, K rotated as it lands (hd
//    128 above 512).
constexpr int ATT_RING = 0;
constexpr int ATT_PERSISTENT = 1;
constexpr int ATT_KRES = 2;
// mbarriers: kfull[2][MT] (K landed; ATT_KRES: kfull[1] a V stage landed),
// kready[2][MT], third[MT] (V landed; the rings' empty), the bias's [2],
// done[2] (a head's consumers finished with a K buffer and the V buffer),
// vmarked (the producer warps marked a persistent head's V tiles), MT =
// ATT_MAX_TILES.
constexpr int ATT_BARRIERS = 5 * ATT_MAX_TILES + 5;

// 64-row tiles of a forward block's K and V (n: the head's key tiles).
__host__ __device__ constexpr int att_tiles(int mode, int n) {
  return mode == ATT_RING ? 2 * ATT_STAGES : mode == ATT_KRES ? n + ATT_STAGES : 3 * n;
}

// A forward block's dynamic shared memory, from the first 1024-byte
// boundary (up to 1024 bytes of slack): the tiles of K and V (att_tiles);
// the key bias (64 n f32, two buffers when persistent); each consumer
// warp's eight output staging rows (store_rows); the mbarriers; the
// consumer warps' masks of the key tiles pass 2 needs (two query tiles'
// worth, 2 x 8 words) and the producer warps' marks of V tiles (4 words).
template <int HD>
__host__ __device__ constexpr size_t att_smem_bytes(int S, int mode) {
  const int n = (S + WG_ROWS - 1) / WG_ROWS;
  return 1024 + (size_t)att_tiles(mode, n) * TileLayout<HD>::BYTES +
         4 * WG_ROWS * n * (mode == ATT_PERSISTENT ? 2 : 1) +
         (ATT_CONSUMERS / 32) * 8 * (HD + 8) * 2 + 8 * ATT_BARRIERS + 4 * 20;
}

// The rotary of the K tile of keys k0 .. k0 + 63 in place, in TMA's
// swizzle, by threads tid, tid + nt, ..: an item is lanes j .. j + 3 of a
// row (8 bytes of its 16-byte piece p) with their partners j + HD/2 .. —
// the same bytes of piece p + HD/16, which at hd 128 lies at the same place
// of the other column chunk and below it at piece p ^ HD/16 of the same
// swizzled row (the swizzle XORs a piece index with bits of the row only).
// f32 from the bf16 input, one rounding to bf16: load_q_frags's arithmetic,
// lane by lane. A thread loads U items (the tile's lanes and 16-byte rows
// of the rotary tables) before it computes any, so that U items' table
// reads are in flight at once. Rows at or past S stay as TMA wrote them
// (zero).
template <int HD, int U>
__device__ __forceinline__ void rotate_tile(unsigned char* tile, int k0, int S,
                                            const float* __restrict__ cos2,
                                            const float* __restrict__ s2, int tid, int nt) {
  constexpr int H2 = HD / 2;
  constexpr int QUADS = H2 / 4;
  const int items = min(WG_ROWS, S - k0) * QUADS;
  for (int i0 = tid; i0 < items; i0 += U * nt) {
    uint2* lo[U];
    uint2* hi[U];
    uint2 xl[U], xh[U];
    float4 cl[U], ch[U], sl[U], sh[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(i0 + u * nt, items - 1);  // a repeat of the last item is not stored
      const int r = i / QUADS;
      const int j = (i % QUADS) * 4;
      const float* c = cos2 + (size_t)(k0 + r) * HD + j;
      const float* sn = s2 + (size_t)(k0 + r) * HD + j;
      lo[u] = reinterpret_cast<uint2*>(tile + tile_byte<HD>(r, j));
      hi[u] = reinterpret_cast<uint2*>(tile + tile_byte<HD>(r, j + H2));
      xl[u] = *lo[u];
      xh[u] = *hi[u];
      cl[u] = *reinterpret_cast<const float4*>(c);
      ch[u] = *reinterpret_cast<const float4*>(c + H2);
      sl[u] = *reinterpret_cast<const float4*>(sn);
      sh[u] = *reinterpret_cast<const float4*>(sn + H2);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * nt >= items) break;
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xl[u].x));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xl[u].y));
      const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xh[u].x));
      const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xh[u].y));
      // roll(x, HD/2) brings lane j + HD/2 to lane j and lane j to j + HD/2.
      *lo[u] = make_uint2(
          pack_bf16x2(__fadd_rn(__fmul_rn(a0.x, cl[u].x), __fmul_rn(b0.x, sl[u].x)),
                      __fadd_rn(__fmul_rn(a0.y, cl[u].y), __fmul_rn(b0.y, sl[u].y))),
          pack_bf16x2(__fadd_rn(__fmul_rn(a1.x, cl[u].z), __fmul_rn(b1.x, sl[u].z)),
                      __fadd_rn(__fmul_rn(a1.y, cl[u].w), __fmul_rn(b1.y, sl[u].w))));
      *hi[u] = make_uint2(
          pack_bf16x2(__fadd_rn(__fmul_rn(b0.x, ch[u].x), __fmul_rn(a0.x, sh[u].x)),
                      __fadd_rn(__fmul_rn(b0.y, ch[u].y), __fmul_rn(a0.y, sh[u].y))),
          pack_bf16x2(__fadd_rn(__fmul_rn(b1.x, ch[u].z), __fmul_rn(a1.x, sh[u].z)),
                      __fadd_rn(__fmul_rn(b1.y, ch[u].w), __fmul_rn(a1.y, sh[u].w))));
    }
  }
}

// wgmma's A fragments of rotated q for the warp's 16 query rows r0 .. r0 +
// 15, straight from global memory, one k16 step per qa[ks]: thread (g, t)
// holds rows g and g + 8 at lanes 8u + 2t and 8u + 2t + 1 (u < HD/8), and
// the rotary partner of lane 8u + 2t is lane 8u' + 2t with u' = u + HD/16
// mod HD/8 — the same thread's, so q needs no shared memory. Rows at or
// past S are zero.
template <int HD>
__device__ __forceinline__ void load_q_frags(const bf16* __restrict__ q, int ld_in, int r0,
                                             int S, const float* __restrict__ cos2,
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
        x[u] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(q + (size_t)s * ld_in + d));
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

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d (64 x 64, the layout of wg_ss64) = A B^T (+ d if acc): A 64 x 16 bf16
// in registers (wg_rs's A), B 64 rows x 16 read K-major (desc_k).
__device__ __forceinline__ void wg_rs64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      " %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35},"
      " %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// o (the 64 x HD accumulator, acc_rows's units) += bf16(e) V, issued and
// not committed: A the four k16 steps of bf16(e) repacked C -> A (pa), B
// the V tile vt read MN-major, accumulated inside the wgmma in increasing
// key order (a partial last tile's empty steps add exact zeros).
template <int HD>
__device__ __forceinline__ void pv_issue(float (&o)[UC<HD>][UN<HD> / 2], uint32_t (&pa)[4][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < UC<HD>; ++c) wg_rs<UN<HD>>(o[c], pa[kk], desc_mn<HD>(vt, kk, c), 1);
}

// The raw dots of a warpgroup's 64 query rows (q_r in registers) with the
// 64 keys of the K tile kt into d, in wg_ss64's layout. ATT_QK_ADDS: each
// k16 step from +0.0, step 0 straight into d and the others into NP product
// fragments, issued NP + 1 steps a batch with one wait a batch and added to
// d with one __fadd_rn in increasing step order; else every step
// accumulated inside the wgmma. Pass 1 and pass 2 run the same chain, so
// they see the same logits bit for bit. PV: the previous tile's product
// (o += bf16(e) V, pa and vt) goes out behind S's first batch. Every wgmma
// is complete on return. (Leaving PV in flight under the softmax, as
// FlashAttention-3 does, timed no faster and gave wrong rows at hd 16 once
// the context went out through the staging rows: PERF.md §6.)
template <int HD, int NP, bool PV>
__device__ __forceinline__ void s_tile(float (&d)[32], uint32_t (&qa)[HD / 16][4], uint32_t kt,
                                       float (&o)[UC<HD>][UN<HD> / 2], uint32_t (&pa)[4][4],
                                       uint32_t vt) {
  constexpr int KS = HD / 16;
  constexpr int NB = (!ATT_QK_ADDS || KS == 1) ? 1 : (KS - 1 + NP - 1) / NP;
  fence_regs(qa);
  fence_regs(d);
  if constexpr (PV) {
    fence_regs(o);
    fence_regs(pa);
  }
  wgmma_fence();
  float p[NP][32];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int v0 = 1 + b * NP;  // the batch's first step into p[0]
    if constexpr (!ATT_QK_ADDS) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) wg_rs64_k(d, qa[kk], desc_k<HD>(kt, kk), kk);
    } else {
      if (b == 0) wg_rs64_k(d, qa[0], desc_k<HD>(kt, 0), 0);
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (v0 + k < KS) wg_rs64_k(p[k], qa[v0 + k], desc_k<HD>(kt, v0 + k), 0);
    }
    wgmma_commit();
    if (PV && b == 0) {
      pv_issue<HD>(o, pa, vt);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(d);
    if constexpr (PV) {
      fence_regs(o);
      fence_regs(pa);
    }
    if constexpr (ATT_QK_ADDS) {
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        if (v0 + k >= KS) break;
        fence_regs(p[k]);
#pragma unroll
        for (int e = 0; e < 32; ++e) d[e] = __fadd_rn(d[e], p[k][e]);
      }
      if (b + 1 < NB) {
        fence_regs(d);
        wgmma_fence();
      }
    }
  }
  fence_regs(d);
  fence_regs(qa);
}

// The larger of a and b, NaN if either is (PTX max.NaN; fmaxf drops NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Pass 1 on a tile's raw dots s: the maxima t0 (row g) and t1 (row g + 8)
// of this thread's logits (dot * scale + the key's bias; bias points at
// the tile's first key) over the tile's keys below `keys` (FULL: all 64,
// with no branch, so the compiler may interleave every cell's work), by
// `mx` (fmaxf, which drops NaN, or max_nan, which keeps it).
template <bool FULL, typename Max>
__device__ __forceinline__ void tile_max(const float (&s)[32], const float* bias, int keys,
                                         float scale, Max mx, float& t0, float& t1) {
  const int t = threadIdx.x & 3;
  t0 = t1 = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    if (!FULL && 8 * jj >= keys) break;  // an n8 group of keys is wholly below S or past it
    const float2 bk = *reinterpret_cast<const float2*>(bias + 8 * jj + 2 * t);
    t0 = mx(t0, mx(logit_of(s[4 * jj], scale, bk.x), logit_of(s[4 * jj + 1], scale, bk.y)));
    t1 = mx(t1, mx(logit_of(s[4 * jj + 2], scale, bk.x), logit_of(s[4 * jj + 3], scale, bk.y)));
  }
}

// Pass 1's tile maxima (the row maxima take fmaxf's, NaN dropped, as the
// mma.sync build's did), and whether any of the thread's logits in the tile
// is NaN (max_nan's first, fmaxf's only then: a tile with a NaN is never
// skipped, its e being NaN).
template <bool FULL>
__device__ __forceinline__ bool tile_maxima(const float (&s)[32], const float* bias, int keys,
                                            float scale, float& t0, float& t1) {
  tile_max<FULL>(s, bias, keys, scale, max_nan, t0, t1);
  if (!isnan(t0) && !isnan(t1)) return false;
  tile_max<FULL>(s, bias, keys, scale, [](float a, float b) { return fmaxf(a, b); }, t0, t1);
  return true;
}

// Pass 2 on a tile's raw dots s: e = exp(logit - m) of this thread's cells
// against the exact row maxima m0 (row g) and m1 (row g + 8), the unrounded
// e summed into l0 and l1 in increasing key order, and bf16(e) packed C ->
// A into pa; keys at or past `keys` get e = 0 (FULL: none, no branch).
// expf, not __expf: see the header.
template <bool FULL>
__device__ __forceinline__ void tile_exp(const float (&s)[32], const float* bias, int keys,
                                         float scale, float m0, float m1, float& l0, float& l1,
                                         uint32_t (&pa)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
    if (FULL || 8 * jj < keys) {
      const float2 bk = *reinterpret_cast<const float2*>(bias + 8 * jj + 2 * t);
      e0 = expf(__fsub_rn(logit_of(s[4 * jj], scale, bk.x), m0));
      e1 = expf(__fsub_rn(logit_of(s[4 * jj + 1], scale, bk.y), m0));
      e2 = expf(__fsub_rn(logit_of(s[4 * jj + 2], scale, bk.x), m1));
      e3 = expf(__fsub_rn(logit_of(s[4 * jj + 3], scale, bk.y), m1));
      l0 = __fadd_rn(__fadd_rn(l0, e0), e1);
      l1 = __fadd_rn(__fadd_rn(l1, e2), e3);
    }
    pack_a(pa, jj, e0, e1, e2, e3);
  }
}

// Whether thread t's share of the V tile at shared address vt (TMA's rows,
// zeros past S) holds a non-finite lane (a bf16 whose exponent bits are all
// ones): the 16 bytes at 16 t + 2048 u, so that a warpgroup's 128 threads
// read the tile once. Pass 2 skips a key tile whose e is all 0 only where
// no lane of its V is: bf16(0) times a NaN or an inf is NaN, and the JAX
// kernel and the mma.sync build run that product.
template <int HD>
__device__ __forceinline__ bool v_share_nonfinite(uint32_t vt, int t) {
  constexpr uint32_t E = 0x7F807F80u;  // the exponent bits of two bf16
  uint32_t bad = 0u;
#pragma unroll
  for (int u = 0; u < TileLayout<HD>::BYTES / 2048; ++u) {
    uint32_t x0, x1, x2, x3;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                 : "r"(vt + 16 * t + 2048 * u));
    bad |= __vcmpeq2(x0 & E, E) | __vcmpeq2(x1 & E, E) | __vcmpeq2(x2 & E, E) |
           __vcmpeq2(x3 & E, E);
  }
  return bad != 0u;
}

// v_share_nonfinite over a warpgroup, voted with one barrier reduction
// (bar.red.or) on named barrier `id`.
template <int HD>
__device__ __forceinline__ bool v_tile_nonfinite(uint32_t vt, int id) {
  const uint32_t bad = v_share_nonfinite<HD>(vt, threadIdx.x & 127);
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(any)
      : "r"(bad), "r"(id));
  return any != 0u;
}

// The context of a warp's 16 rows r0 .. r0 + 15 (o / l, one rounding to
// bf16) to out (rows ld_out apart; rows at or past S not stored): eight rows
// at a time through the warp's staging rows in shared memory (pitch HD + 8
// bf16: the eight rows of a column fall in distinct banks), then 16-byte
// stores, a row's HD lanes contiguous.
template <int HD>
__device__ __forceinline__ void store_rows(float (&o)[UC<HD>][UN<HD> / 2], float l0,
                                           float l1, bf16* stage, bf16* __restrict__ out,
                                           int ld_out, int r0, int S) {
  constexpr int LDS = HD + 8;
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float l = hh ? l1 : l0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + g * LDS + 8 * j + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(acc_at<HD>(o, j, hh, 0), l),
                                __fdiv_rn(acc_at<HD>(o, j, hh, 1), l));
    __syncwarp();
    for (int i = lane; i < 8 * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      const int s = r0 + 8 * hh + r;
      if (s < S)
        *reinterpret_cast<uint4*>(out + (size_t)s * ld_out + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + r * LDS + 8 * c);
    }
    __syncwarp();
  }
}

// The tensor maps K and V come through: 3-D (lanes, rows, planes), rows past
// S zero. K8: both qkv's; K7: k's and v's.
struct AttMaps {
  CUtensorMap k, v;
};

// Where head bh lies: its K and V at lanes kx .. and vx .. of plane `plane`
// of the maps, its query row 0 (q), its key bias (brow) and its context row
// 0 (out).
struct AttHead {
  int kx, vx, plane;
  const bf16* q;
  const float* brow;
  bf16* out;
};

// A head's forward in a block of ATT_THREADS (see the header and the block
// modes ATT_PERSISTENT .. ATT_RING): heads bh of BH from head(bh),
// query rows ld_in and context rows ld_out elements apart. K8 and K7 run
// this body with different maps and pointers, so they agree bit for bit.
template <int HD, int MODE, typename Head>
__device__ __forceinline__ void attend(const AttMaps& maps, Head head, int BH, int ld_in,
                                       int ld_out, const float* __restrict__ cos2,
                                       const float* __restrict__ s2, int S, float scale) {
  using L = TileLayout<HD>;
  constexpr int ST = ATT_STAGES, MT = ATT_MAX_TILES;
  constexpr bool RING = MODE == ATT_RING, PERSIST = MODE == ATT_PERSISTENT;
  constexpr bool KRES = MODE == ATT_KRES;
  constexpr bool STREAM = RING || KRES;  // V comes through a ring
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int n = (S + WG_ROWS - 1) / WG_ROWS;
  unsigned char* tiles = att_smem + (1024 - smem_addr(att_smem) % 1024) % 1024;
  // K tile j of buffer kb (RING: stage j's) and V tile j (RING, KRES: stage
  // j's)
  const auto ktile = [&](int kb, int j) { return tiles + (RING ? 2 * j : kb * n + j) * L::BYTES; };
  const auto vtile = [&](int j) {
    return tiles + (RING ? 2 * j + 1 : (PERSIST ? 2 : 1) * n + j) * L::BYTES;
  };
  const int nq = n;  // 64-row query tiles; pairs of them go to the two warpgroups
  const int pairs = (nq + 1) / 2;
  float* bias_s = reinterpret_cast<float*>(tiles + att_tiles(MODE, n) * L::BYTES);
  bf16* staging = reinterpret_cast<bf16*>(bias_s + WG_ROWS * n * (PERSIST ? 2 : 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(staging + (ATT_CONSUMERS / 32) * 8 * (HD + 8));
  // [2][8 consumer warps], then [4 producer warps] (persistent: V's marks)
  uint32_t* masks = reinterpret_cast<uint32_t*>(bars + ATT_BARRIERS);
  const auto kfull = [&](int kb, int j) { return bars + kb * MT + j; };        // K landed
  const auto kready = [&](int kb, int j) { return bars + (2 + kb) * MT + j; }; // K rotated
  const auto third = [&](int j) { return bars + 4 * MT + j; };  // V landed; the ring: empty
  const auto bias_bar = [&](int kb) { return bars + 5 * MT + kb; };
  const auto done = [&](int kb) { return bars + 5 * MT + 2 + kb; };  // a head is finished
  uint64_t* vmarked = bars + 5 * MT + 4;  // persistent: the head's V tiles are marked
  const int warp = warp_index(), lane = threadIdx.x & 31;
  // RING: query tiles tile0 and tile0 + 1 of head blockIdx.x / per;
  // otherwise heads blockIdx.x, + gridDim.x (persistent), ..
  const int per = RING ? (S + 2 * WG_ROWS - 1) / (2 * WG_ROWS) : 1;
  const int bh0 = blockIdx.x / per, tile0 = 2 * (blockIdx.x % per);
  const int step = PERSIST ? gridDim.x : BH;
  if (threadIdx.x == 0) {
    const int slots = RING ? ST : n;
    for (int kb = 0; kb < (PERSIST ? 2 : 1); ++kb) {
      for (int j = 0; j < slots; ++j) {
        mbar_init(kfull(kb, j), 1);
        mbar_init(kready(kb, j), 128);
      }
      mbar_init(bias_bar(kb), 1);
      mbar_init(done(kb), ATT_CONSUMERS);
    }
    for (int j = 0; j < slots; ++j) mbar_init(third(j), STREAM ? ATT_CONSUMERS : 1);
    if constexpr (KRES)
      for (int st = 0; st < ST; ++st) mbar_init(kfull(1, st), 1);
    mbar_init(vmarked, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!PERSIST && threadIdx.x == 0) {
    const AttHead hh = head(bh0);
    mbar_expect_tx(bias_bar(0), 4 * S);
    bulk_load(bias_s, hh.brow, 4 * S, bias_bar(0));
    if constexpr (KRES) {
      for (int j = 0; j < n; ++j) {
        mbar_expect_tx(kfull(0, j), L::BYTES);
        load_tile<HD>(ktile(0, j), &maps.k, hh.kx, j * WG_ROWS, hh.plane, kfull(0, j));
      }
    }
  }
  if constexpr (KRES) {  // every thread rotates every K tile as it lands, once
    for (int j = 0; j < n; ++j) {
      mbar_wait(kfull(0, j), 0);
      rotate_tile<HD, 4>(ktile(0, j), j * WG_ROWS, S, cos2, s2, threadIdx.x, ATT_THREADS);
    }
    fence_proxy_async();
    __syncthreads();
  }

  if (warp < 4) {  // the producer warpgroup: thread 0 issues the copies, all 128 rotate K
    if constexpr (KRES)
      setmaxnreg_dec<ATT_PRODUCER_REGS>();
    else
      setmaxnreg_dec<ATT_ROTATING_PRODUCER_REGS>();
    const int tid = threadIdx.x;
    if constexpr (RING) {
      // tiles 0 .. n - 1: K (pass 1); n .. 2n - 1: K and V (pass 2)
      const AttHead hh = head(bh0);
      const int total = 2 * n;
      const auto issue = [&](int i) {
        const int st = i % ST;
        if (i >= ST) mbar_wait(third(st), (i / ST - 1) & 1);
        const int k0 = (i % n) * WG_ROWS;
        mbar_expect_tx(kfull(0, st), (i >= n ? 2 : 1) * L::BYTES);
        load_tile<HD>(ktile(0, st), &maps.k, hh.kx, k0, hh.plane, kfull(0, st));
        if (i >= n) load_tile<HD>(vtile(st), &maps.v, hh.vx, k0, hh.plane, kfull(0, st));
      };
      if (tid == 0)
        for (int i = 0; i < min(ST - 1, total); ++i) issue(i);
      for (int i = 0; i < total; ++i) {
        const int st = i % ST;
        mbar_wait(kfull(0, st), (i / ST) & 1);
        rotate_tile<HD, 2>(ktile(0, st), (i % n) * WG_ROWS, S, cos2, s2, tid, 128);
        fence_proxy_async();
        mbar_arrive(kready(0, st));
        // the slot of tile i - 1, which the consumers are finishing
        if (tid == 0 && i + ST - 1 < total) issue(i + ST - 1);
      }
    } else if constexpr (KRES) {
      // V tile i % n of query-tile pair i / n into stage i % ST
      const AttHead hh = head(bh0);
      for (int i = 0; tid == 0 && i < pairs * n; ++i) {
        const int st = i % ST;
        if (i >= ST) mbar_wait(third(st), (i / ST - 1) & 1);
        mbar_expect_tx(kfull(1, st), L::BYTES);
        load_tile<HD>(vtile(st), &maps.v, hh.vx, (i % n) * WG_ROWS, hh.plane, kfull(1, st));
      }
    } else if constexpr (PERSIST) {
      // head it: its bias and K into buffer it & 1 (free once head it - 2 is
      // done), K rotated, then its V (free once head it - 1 is done)
      for (int it = 0, bh = bh0; bh < BH; ++it, bh += step) {
        const AttHead hh = head(bh);
        const int kb = it & 1, use = it >> 1;
        if (tid == 0) {
          if (it >= 2) mbar_wait(done(kb), (use - 1) & 1);
          mbar_expect_tx(bias_bar(kb), 4 * S);
          bulk_load(bias_s + kb * WG_ROWS * n, hh.brow, 4 * S, bias_bar(kb));
          for (int j = 0; j < n; ++j) {
            mbar_expect_tx(kfull(kb, j), L::BYTES);
            load_tile<HD>(ktile(kb, j), &maps.k, hh.kx, j * WG_ROWS, hh.plane, kfull(kb, j));
          }
        }
        for (int j = 0; j < n; ++j) {
          mbar_wait(kfull(kb, j), use & 1);
          rotate_tile<HD, 2>(ktile(kb, j), j * WG_ROWS, S, cos2, s2, tid, 128);
          fence_proxy_async();
          mbar_arrive(kready(kb, j));
        }
        if (tid == 0) {
          if (it >= 1) mbar_wait(done((it - 1) & 1), ((it - 1) >> 1) & 1);
          for (int j = 0; j < n; ++j) {
            mbar_expect_tx(third(j), L::BYTES);
            load_tile<HD>(vtile(j), &maps.v, hh.vx, j * WG_ROWS, hh.plane, third(j));
          }
        }
        // V's tiles that hold a NaN or an inf, marked for pass 2 (each
        // warp's word; the consumers read the marks of head it before they
        // finish it, and those of head it + 1 are written after)
        uint32_t bad = 0u;
        for (int j = 0; j < n; ++j) {
          mbar_wait(third(j), it & 1);
          bad |= (uint32_t)v_share_nonfinite<HD>(smem_addr(vtile(j)), tid) << j;
        }
        bad = __reduce_or_sync(0xffffffffu, bad);
        if ((tid & 31) == 0) {
          masks[16 + (tid >> 5)] = bad;
          mbar_arrive(vmarked);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 query rows at a time
    if constexpr (KRES)
      setmaxnreg_inc<ATT_CONSUMER_REGS>();
    else
      setmaxnreg_inc<ATT_ROTATING_CONSUMER_REGS>();
    constexpr int NP = ATT_PRODUCTS<HD>;
    const int cw = (warp >> 2) - 1;
    for (int it = 0, bh = bh0; bh < BH; ++it, bh += step) {
      const AttHead hh = head(bh);
      const int kb = PERSIST ? it & 1 : 0, use = it >> 1;
      mbar_wait(bias_bar(kb), PERSIST ? use & 1 : 0);
      const float* bs = bias_s + kb * WG_ROWS * n;
      // The K tile (and V tile) of key tile j, the ring's tile ri (RING:
      // pass 1 ri = j, pass 2 n + j; KRES: V tiles only, ri = pair n + j),
      // after its rotary.
      const auto wait_tile = [&](int ri, int j, bool with_v, uint32_t& kt, uint32_t& vt) {
        if constexpr (RING) {
          const int st = ri % ST;
          mbar_wait(kfull(0, st), (ri / ST) & 1);
          mbar_wait(kready(0, st), (ri / ST) & 1);
          kt = smem_addr(ktile(0, st));
          vt = smem_addr(vtile(st));
        } else if constexpr (KRES) {
          kt = smem_addr(ktile(0, j));
          if (with_v) mbar_wait(kfull(1, ri % ST), (ri / ST) & 1);
          vt = smem_addr(vtile(ri % ST));
        } else {  // persistent: the producer rotated it
          mbar_wait(kfull(kb, j), use & 1);
          mbar_wait(kready(kb, j), use & 1);
          if (with_v) mbar_wait(third(j), it & 1);
          kt = smem_addr(ktile(kb, j));
          vt = smem_addr(vtile(j));
        }
      };
      const auto release = [&](int ri) {  // the ring's tile ri is consumed
        if constexpr (STREAM) mbar_arrive(third(ri % ST));
      };
      for (int pair = RING ? tile0 / 2 : 0;; ++pair) {
        const int qt = 2 * pair + cw;
        if (RING ? pair > tile0 / 2 : (KRES ? pair >= pairs : qt >= nq)) break;
        // In the rings, a warpgroup whose rows all lie past S computes
        // nothing but frees every stage.
        const bool active = qt * WG_ROWS < S;
        const int r0 = qt * WG_ROWS + 16 * (warp & 3);  // the warp's 16 rows
        uint32_t qa[HD / 16][4];
        if (active) load_q_frags<HD>(hh.q, ld_in, r0, S, cos2, s2, qa);
        float o[UC<HD>][UN<HD> / 2];  // the context, f32
        uint32_t pa[4][4];            // bf16(e) of the last tile, for its product with V

        // Pass 1: the exact max of each row over all S keys, and the key tiles
        // whose e may be nonzero.
        float m0 = -INFINITY, m1 = -INFINITY;
        uint32_t need = 0u;
        for (int j = 0; j < n; ++j) {
          uint32_t kt, vt;
          wait_tile(j, j, false, kt, vt);
          if (active) {
            float s[32];
            s_tile<HD, NP, false>(s, qa, kt, o, pa, vt);
            const int k0 = j * WG_ROWS;
            float t0, t1;  // the tile's maxima of this thread's cells
            const bool nan = k0 + WG_ROWS <= S
                                 ? tile_maxima<true>(s, bs + k0, WG_ROWS, scale, t0, t1)
                                 : tile_maxima<false>(s, bs + k0, S - k0, scale, t0, t1);
            m0 = fmaxf(m0, t0);
            m1 = fmaxf(m1, t1);
            // a NaN keeps the tile
            const bool live = nan || !(__fsub_rn(t0, m0) <= ATT_SKIP_BELOW &&
                                       __fsub_rn(t1, m1) <= ATT_SKIP_BELOW);
            need |= (uint32_t)(__any_sync(0xffffffffu, live) != 0) << j;
          }
          if constexpr (RING) release(j);
        }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        if (active) {  // the warpgroup's union of its warps' tiles
          uint32_t* wm = masks + 8 * ((qt >> 1) & 1) + 4 * cw;
          if (lane == 0) wm[warp & 3] = need;
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
          need = wm[0] | wm[1] | wm[2] | wm[3];
          if constexpr (PERSIST) {  // the tiles whose V holds a NaN or an inf run
            mbar_wait(vmarked, it & 1);
            need |= masks[16] | masks[17] | masks[18] | masks[19];
          }
        }

        // Pass 2: the logits again, e = exp(l - m), the sums, and bf16(e) V of
        // each tile, which goes out with the next tile's S.
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int c = 0; c < UC<HD>; ++c)
#pragma unroll
          for (int e = 0; e < UN<HD> / 2; ++e) o[c][e] = 0.f;
        uint32_t vprev = 0;    // the V tile of pa
        bool pending = false;  // pa's product with V is still to go out
        int rprev = 0;         // the ring's tile of pa's V
        // pa's product with V, alone (before a streamed tile is freed)
        const auto flush = [&]() {
          fence_regs(o);
          fence_regs(pa);
          wgmma_fence();
          pv_issue<HD>(o, pa, vprev);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o);
          fence_regs(pa);
          pending = false;
          release(rprev);
        };
        for (int j = 0; j < n; ++j) {
          const int ri = KRES ? pair * n + j : n + j;
          uint32_t kt, vt;
          wait_tile(ri, j, true, kt, vt);
          // every e of the tile is 0 (a streamed V tile that holds a NaN or
          // an inf runs; a persistent block's producer marked those)
          if (!active || (!((need >> j) & 1u) && !(STREAM && v_tile_nonfinite<HD>(vt, 1 + cw)))) {
            if (STREAM && pending) flush();
            release(ri);
            continue;
          }
          float s[32];
          if (pending)
            s_tile<HD, NP, true>(s, qa, kt, o, pa, vprev);
          else
            s_tile<HD, NP, false>(s, qa, kt, o, pa, vprev);
          if (pending) release(rprev);  // its product is complete: pa is free
          const int k0 = j * WG_ROWS;
          if (k0 + WG_ROWS <= S)
            tile_exp<true>(s, bs + k0, WG_ROWS, scale, m0, m1, l0, l1, pa);
          else
            tile_exp<false>(s, bs + k0, S - k0, scale, m0, m1, l0, l1, pa);
          pending = true;
          vprev = vt;
          rprev = ri;
        }
        if (pending) flush();  // the last tile's PV

        // The row sums over the quad, the division after PV, one rounding to
        // bf16; rows at or past S are not stored.
        if (active)
          store_rows<HD>(o, quad_sum(l0), quad_sum(l1), staging + (warp - 4) * 8 * (HD + 8),
                         hh.out, ld_out, r0, S);
      }
      if constexpr (PERSIST) mbar_arrive(done(kb));  // this head's K buffer and V are free
    }
  }
}

// K8: heads of one batch row side by side.
template <int HD, int MODE>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    k8_fused_attention_qkv(const __grid_constant__ AttMaps maps, const bf16* __restrict__ qkv,
                           const float* __restrict__ cos2, const float* __restrict__ s2,
                           const float* __restrict__ bias, int S, int H, int BH, float scale,
                           bf16* __restrict__ out) {
  const int row_stride = 3 * H * HD;
  attend<HD, MODE>(
      maps,
      [=](int bh) {
        const int b = bh / H, h = bh % H;
        return AttHead{(H + h) * HD, (2 * H + h) * HD, b,
                       qkv + (size_t)b * S * row_stride + h * HD, bias + (size_t)b * S,
                       out + (size_t)b * S * H * HD + h * HD};
      },
      BH, row_stride, H * HD, cos2, s2, S, scale);
}

// K7: K8 on head-major operands, planes (b, h) of q, k, v and out.
template <int HD, int MODE>
__global__ void __launch_bounds__(ATT_THREADS, 1)
    k7_fused_attention(const __grid_constant__ AttMaps maps, const bf16* __restrict__ q,
                       const float* __restrict__ cos2, const float* __restrict__ s2,
                       const float* __restrict__ bias, int S, int H, int BH, float scale,
                       bf16* __restrict__ out) {
  attend<HD, MODE>(
      maps,
      [=](int bh) {
        const size_t head = (size_t)bh * S * HD;
        return AttHead{0, 0, bh, q + head, bias + (size_t)(bh / H) * S, out + head};
      },
      BH, HD, HD, cos2, s2, S, scale);
}

// ==== K8/K7 forward: end ====

// ---- the PV probe: k16 steps accumulated inside wgmma and inside mma.sync ----
//
// a [R, 16 steps] bf16 (R % 64 == 0, steps % 4 == 0) and b [16 steps, 64]
// bf16: out = a b with the k16 steps taken in increasing order, [R, 64] f32,
// both ways (a block a 64-row tile of a):
//  * out_wg: wgmma m64n64k16 with scale-d = 1 from d = 0 — attend's PV
//    (pv_issue): A from registers, B read MN-major from b's rows, staged 64
//    at a time in the 128-byte swizzle;
//  * out_mma: mma.sync m16n8k16 accumulated from c = +0.0 — the mma.sync
//    build's PV (bench/attend_mma_sync.cuh).
// Whether the two agree bit for bit decides whether PV may stay inside the
// instruction and keep the mma.sync build's bits. It replaces no TPU
// kernel; it measures the card.
__global__ void __launch_bounds__(128)
    k_probe_pv_acc(const bf16* __restrict__ a, const bf16* __restrict__ b, int steps,
                   float* __restrict__ out_wg, float* __restrict__ out_mma) {
  __shared__ __align__(1024) unsigned char tile[TileLayout<64>::BYTES];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int K = 16 * steps;
  const int r = blockIdx.x * WG_ROWS + 16 * warp + g;  // this thread's rows r, r + 8
  const uint32_t* a2 = reinterpret_cast<const uint32_t*>(a);  // bf16 pairs
  const uint16_t* b1 = reinterpret_cast<const uint16_t*>(b);
  const auto a_frag = [&](int st, uint32_t (&f)[4]) {
    const size_t k = 16 * st + 2 * t;
    f[0] = a2[((size_t)r * K + k) / 2];
    f[1] = a2[((size_t)(r + 8) * K + k) / 2];
    f[2] = a2[((size_t)r * K + k + 8) / 2];
    f[3] = a2[((size_t)(r + 8) * K + k + 8) / 2];
  };
  float d[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) d[e] = 0.f;
  for (int t0 = 0; t0 < steps; t0 += 4) {
    __syncthreads();  // the last tile's wgmmas have been waited for
    for (int i = tid; i < WG_ROWS * 8; i += 128) {  // rows 16 t0 .. of b, 16 bytes a copy
      const int row = i / 8, p = i % 8;
      *reinterpret_cast<uint4*>(tile + tile_byte<64>(row, 8 * p)) =
          *reinterpret_cast<const uint4*>(b + (size_t)(16 * t0 + row) * 64 + 8 * p);
    }
    fence_proxy_async();
    __syncthreads();
    uint32_t f[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(t0 + kk, f[kk]);
    fence_regs(f);
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg_rs<64>(d, f[kk], desc_mn<64>(smem_addr(tile), kk, 0), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_regs(f);
  }
  float c[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  for (int st = 0; st < steps; ++st) {
    uint32_t f[4];
    a_frag(st, f);
    const size_t k = 16 * st + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + g;
      const uint32_t b0 = b1[k * 64 + col] | ((uint32_t)b1[(k + 1) * 64 + col] << 16);
      const uint32_t b8 = b1[(k + 8) * 64 + col] | ((uint32_t)b1[(k + 9) * 64 + col] << 16);
      mma_bf16(c[j], f, b0, b8);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t at = (size_t)(r + 8 * (e >> 1)) * 64 + 8 * j + 2 * t + (e & 1);
      out_wg[at] = d[4 * j + e];
      out_mma[at] = c[j][e];
    }
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

// The tensor map of a bf16 array [planes][S][lanes] whose rows lie `pitch`
// bytes apart: boxes of one column chunk (TileLayout<HD>) x 64 rows x one
// plane, in the chunk's swizzle; rows at or past S read as zeros.
template <int HD>
int encode_3d(CUtensorMap* map, const void* base, long long lanes, int S, long long planes,
              long long pitch) {
  static const EncodeTiled encode = lookup_encode_tiled();  // once, thread-safe
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  using L = TileLayout<HD>;
  const cuuint64_t dims[3] = {(cuuint64_t)lanes, (cuuint64_t)S, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch, (cuuint64_t)pitch * S};
  const cuuint32_t box[3] = {(cuuint32_t)(L::W / 2), (cuuint32_t)WG_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::W == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::W == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The register split of setmaxnreg needs the block's whole allocation: a
// kernel that ptxas gave fewer registers would wait forever in
// setmaxnreg.inc, so it is refused before it launches.
template <typename Kernel>
int check_launch_regs(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  return attr.numRegs >= K9_LAUNCH_REGS ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <int HD>
int launch_k9(const void* qkv, const float* cos2, const float* s2,
              const float* bias, const void* g, int B, int S, int H,
              float scale, float* stats, void* dqkv, cudaStream_t stream) {
  static size_t conf_q = 48 * 1024, conf_k = 48 * 1024;
  static const int regs_q = check_launch_regs(k9_wg_query<HD>);
  static const int regs_k = check_launch_regs(k9_wg_key<HD>);
  if (regs_q) return regs_q;
  if (regs_k) return regs_k;
  constexpr size_t smem = K9Layout<HD>::BYTES;
  int e = allow_smem(k9_wg_query<HD>, smem, conf_q);
  if (e) return e;
  e = allow_smem(k9_wg_key<HD>, smem, conf_k);
  if (e) return e;
  const long long bh = (long long)B * H;
  auto* rot = reinterpret_cast<bf16*>(stats + K9_STATS * bh * S);
  K9Maps maps;
  if ((e = encode_3d<HD>(&maps.rot, rot, HD, S, 2 * bh, 2LL * HD))) return e;
  if ((e = encode_3d<HD>(&maps.qkv, qkv, 3LL * H * HD, S, B, 6LL * H * HD))) return e;
  if ((e = encode_3d<HD>(&maps.g, g, (long long)H * HD, S, B, 2LL * H * HD))) return e;
  const size_t items = (size_t)2 * bh * S * (HD / 4);
  k9_rotate_qk<HD><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(qkv), cos2, s2, B, S, H, items, rot);
  if ((e = (int)cudaGetLastError())) return e;
  const unsigned blocks = (unsigned)bh * (unsigned)((S + K9_ROWS - 1) / K9_ROWS);
  k9_wg_query<HD><<<blocks, K9_THREADS, smem, stream>>>(maps, cos2, s2, bias, S, H, scale,
                                                        stats, static_cast<bf16*>(dqkv));
  if ((e = (int)cudaGetLastError())) return e;
  k9_wg_key<HD><<<blocks, K9_THREADS, smem, stream>>>(maps, cos2, s2, bias, S, H, scale,
                                                      stats, static_cast<bf16*>(dqkv));
  return (int)cudaGetLastError();
}

// ==== K8/K7 launchers: begin ====

// The first block mode whose shared memory fits (see ATT_PERSISTENT).
template <int HD>
int att_mode(int S) {
  if (att_smem_bytes<HD>(S, ATT_PERSISTENT) <= SMEM_OPTIN) return ATT_PERSISTENT;
  if (att_smem_bytes<HD>(S, ATT_KRES) <= SMEM_OPTIN) return ATT_KRES;
  return ATT_RING;
}

// The current device's SM count into sms, read from the driver once a
// device.
inline int att_sm_count(int& sms) {
  static std::atomic<int> known[64];  // zero: not read yet
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  if (dev < 64 && (sms = known[dev].load(std::memory_order_relaxed)) > 0) return 0;
  if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return e;
  if (dev < 64) known[dev].store(sms, std::memory_order_relaxed);
  return 0;
}

// One forward launch of `kernel` (K8 or K7 at HD, MODE) on maps and its
// pointers, its shared memory allowed and its register split checked once.
// Persistent: a block an SM, at most a block a head.
template <int HD, int MODE, typename Kernel>
int launch_attend(Kernel kernel, size_t& configured, int regs, const AttMaps& maps,
                  const void* q, const float* cos2, const float* s2, const float* bias, int B,
                  int S, int H, float scale, void* out, cudaStream_t stream) {
  if (regs) return regs;
  const size_t bytes = att_smem_bytes<HD>(S, MODE);
  int e = allow_smem(kernel, bytes, configured);
  if (e) return e;
  const int BH = B * H;
  unsigned blocks = (unsigned)BH;
  if (MODE == ATT_RING) blocks *= (unsigned)((S + 2 * WG_ROWS - 1) / (2 * WG_ROWS));
  if (MODE == ATT_PERSISTENT) {
    int sms = 0;
    if ((e = att_sm_count(sms))) return e;
    blocks = (unsigned)min(BH, sms);
  }
  kernel<<<blocks, ATT_THREADS, bytes, stream>>>(maps, static_cast<const bf16*>(q), cos2, s2,
                                                 bias, S, H, BH, scale, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

template <int HD, int MODE>
int launch_k8_as(const AttMaps& maps, const void* qkv, const float* cos2, const float* s2,
                 const float* bias, int B, int S, int H, float scale, void* out,
                 cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  static const int regs = check_launch_regs(k8_fused_attention_qkv<HD, MODE>);
  return launch_attend<HD, MODE>(k8_fused_attention_qkv<HD, MODE>, configured, regs, maps, qkv,
                                 cos2, s2, bias, B, S, H, scale, out, stream);
}

template <int HD, int MODE>
int launch_k7_as(const AttMaps& maps, const void* q, const float* cos2, const float* s2,
                 const float* bias, int B, int S, int H, float scale, void* out,
                 cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  static const int regs = check_launch_regs(k7_fused_attention<HD, MODE>);
  return launch_attend<HD, MODE>(k7_fused_attention<HD, MODE>, configured, regs, maps, q, cos2,
                                 s2, bias, B, S, H, scale, out, stream);
}

// `launch` (a generic lambda) at block mode att_mode<HD>(S), instantiated
// only for the modes that some S <= MAX_S reaches at HD (hd 16 and 32:
// persistent only; hd 64: no ring).
template <int HD, typename Launch>
int with_mode(int S, Launch launch) {
  constexpr bool kres = att_smem_bytes<HD>(MAX_S, ATT_PERSISTENT) > SMEM_OPTIN;
  constexpr bool ring = att_smem_bytes<HD>(MAX_S, ATT_KRES) > SMEM_OPTIN;
  const int mode = att_mode<HD>(S);
  if constexpr (kres)
    if (mode == ATT_KRES) return launch(std::integral_constant<int, ATT_KRES>{});
  if constexpr (ring)
    if (mode == ATT_RING) return launch(std::integral_constant<int, ATT_RING>{});
  return launch(std::integral_constant<int, ATT_PERSISTENT>{});
}

template <int HD>
int launch_k8(const void* qkv, const float* cos2, const float* s2, const float* bias, int B,
              int S, int H, float scale, void* out, cudaStream_t stream) {
  AttMaps maps;
  const int e = encode_3d<HD>(&maps.k, qkv, 3LL * H * HD, S, B, 6LL * H * HD);
  if (e) return e;
  maps.v = maps.k;
  return with_mode<HD>(S, [&](auto mode) {
    return launch_k8_as<HD, decltype(mode)::value>(maps, qkv, cos2, s2, bias, B, S, H, scale,
                                                   out, stream);
  });
}

template <int HD>
int launch_k7(const void* q, const void* k, const void* v, const float* cos2, const float* s2,
              const float* bias, int B, int S, int H, float scale, void* out,
              cudaStream_t stream) {
  AttMaps maps;
  int e = encode_3d<HD>(&maps.k, k, HD, S, (long long)B * H, 2LL * HD);
  if (e) return e;
  if ((e = encode_3d<HD>(&maps.v, v, HD, S, (long long)B * H, 2LL * HD))) return e;
  return with_mode<HD>(S, [&](auto mode) {
    return launch_k7_as<HD, decltype(mode)::value>(maps, q, cos2, s2, bias, B, S, H, scale, out,
                                                   stream);
  });
}
// ==== K8/K7 launchers: end ====

}  // namespace

extern "C" {

// Geometry the wrapper must respect (checked in Python too): hd in
// {16, 32, 64, 128}; S % 8 == 0 and 0 < S <= MAX_S;
// qkv [B, S, 3*H*hd] bf16, cos2 / s2 [S, hd] f32, bias [B, S] f32, out
// [B, S, H*hd] bf16, all contiguous, qkv 16-byte aligned (TMA reads it);
// B * H * ceil(S / 16) < 2^31.

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

// K7. q, k, v and out [B, H, S, hd] bf16, k and v 16-byte aligned; cos2,
// s2, bias and the geometry limits as for K8.
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

// K9. qkv, cos2, s2, bias as for K8; g [B, S, H*hd] bf16; stats a scratch
// of (4 + hd) * B*H*S f32 and k9_flag_bytes: [4, B, H, S] f32 (m, l, row and
// 1/l from the query kernel to the key kernel), then the rotated q and k [2,
// B, H, S, hd] bf16, then the query kernel's fallback record;
// dqkv [B, S, 3*H*hd] bf16, every element written. qkv, g and stats 16-byte
// aligned (TMA reads them). Same geometry limits as K8. A build with
// K9_DUMP also writes both kernels' p, dp and ds behind the scratch (6 *
// B*H*S*S more floats, which the caller allocates).
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

// The PV probe: a [R, 16 steps] and b [16 steps, 64] bf16 (R % 64 == 0,
// steps % 4 == 0, b 16-byte aligned); out_wg and out_mma [R, 64] f32.
int bsr_probe_pv_acc(const void* a, const void* b, int R, int steps, float* out_wg,
                     float* out_mma, void* stream) {
  if (R <= 0 || R % WG_ROWS || steps <= 0 || steps % 4) return (int)cudaErrorInvalidValue;
  k_probe_pv_acc<<<R / WG_ROWS, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), steps, out_wg, out_mma);
  return (int)cudaGetLastError();
}

const char* bsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
