// ==== K8/K7 forward: begin (the mma.sync variant of bench/ab_attn.py) ====

// K8 and K7's forward on mma.sync m16n8k16, as shipped before the wgmma
// body: a block per (b, h); K staged by cp.async, rotated once in shared
// memory at a pitch of hd + 8 and resident with V (16 warps) where both fit
// (hd <= 32, hd 64 up to S 784), else both streamed through rings of two
// cp.async tiles stepped by 8 warps, K rotated per tile; B fragments by
// ldmatrix (.trans for V); QK^T each k16 step from +0.0 with one rounded
// add, PV accumulated inside mma.sync. bench/ab_attn.py splices this block
// (device code and launchers, with the same entry-point contract:
// launch_k8<HD> and launch_k7<HD>) into a copy of ops/csrc/attention_kernels.cu
// in place of the wgmma body and its launchers, to time the two in one call
// and hold their outputs bit for bit (tests/test_torch_gpu.py).

constexpr int AKN = 64;                // keys per K / V tile

// Threads of a forward block: 16 warps that never wait on each other where
// K and V are resident (one block per SM), 8 that step through the K and V
// rings together otherwise (two blocks per SM below hd 128).
__host__ __device__ constexpr int att_threads(bool res) {
  return res ? 512 : 256;
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
// (staged rows up to `keys` rounded up to 16 are read). NK: the tile's keys.
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

// ==== K8/K7 forward: end ====
