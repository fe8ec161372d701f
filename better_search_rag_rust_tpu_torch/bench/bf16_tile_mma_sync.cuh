// ==== bf16 score tile: begin (the mma.sync variant of bench/ab_topk.py) ====

// The bf16 score tile of K1/K3/K5/K10/K12 on mma.sync m16n8k16 fed by
// ldmatrix from a cp.async ring, as shipped before the wgmma tile: 256
// threads, 2 blocks an SM. bench/ab_topk.py splices this block into a copy
// of ops/csrc/topk_kernels.cu in place of the shipped one (the same names
// and contract: Tile<__nv_bfloat16> and score_tile_bf16<LD>) to time the two
// tiles in one call and hold their outputs bit for bit. Each pair takes one
// mma.sync per k16 step from +0.0 and one rounded add, the rule of the
// source's header, so the two tiles agree bit for bit wherever the two
// instructions' k16 sums do.

// bf16: WM x WN warps, each a (TR / WM) x (TQ / WN) tile of MT x NQ8 mma
// fragments (64 f32 accumulators a thread); D staged SK features at a time,
// row-major bf16, in an NSTAGE ring of cp.async slabs whose rows are padded
// to SLD (144 bytes: the 8 rows of an ldmatrix fall in 8 disjoint bank
// quarters, so it is free of bank conflicts). On the card (bench/ab_topk.py,
// PERF.md) SK 64 x 2 stages beat SK 32 x 3, which spills at the 128-register
// cap, and 2 CTAs per SM beat 1 with 255 registers; 4 x 2 and 2 x 4 warps
// time alike.
constexpr int WM = 4;
constexpr int WN = 2;
constexpr int MT = TR / WM / 16;
constexpr int NQ8 = TQ / WN / 8;
constexpr int SK = 64;
constexpr int SLD = SK + 8;
constexpr int NSTAGE = 2;
constexpr int SLAB = TR * SLD;    // bf16 elements of one operand's slab
static_assert(WM * WN * 32 == NT, "one warp per warp tile");

// The st leading dimension LDO, 256 threads, 2 blocks an SM, no TMA.
constexpr size_t ST_BYTES_BF = sizeof(float) * (size_t)TR * LDO;
constexpr size_t RING_BYTES = sizeof(__nv_bfloat16) * (size_t)NSTAGE * 2 * SLAB;
constexpr size_t SCORE_SMEM = ST_BYTES_BF > RING_BYTES ? ST_BYTES_BF : RING_BYTES;

template <>
struct Tile<__nv_bfloat16> {
  static constexpr int threads = NT;
  static constexpr int min_blocks = 2;
  static constexpr int ld = LDO;
  using Maps = NoMaps;
  static constexpr size_t smem(size_t extra) { return SCORE_SMEM + extra; }
  static __device__ __forceinline__ float* base(float4* raw) {
    return reinterpret_cast<float*>(raw);
  }
};

// The bf16 score tile on mma.sync; the same contract as score_tile<float>.
// Bound: the 2*TR*TQ*D operations of the product at the bf16 tensor rate
// against the operand bytes, 2*(TR + TQ)*D per tile: the product wins by far
// (K1 at 512 queries of 1M x 768: 0.80 ms of operations, 0.24 of reading the
// store once), so the tile keeps the tensor cores fed and the store streamed
// once. Operands stay bf16: each thread copies 16-byte pieces of the next
// slabs (SK features of the TR rows and TQ queries) with cp.async, NSTAGE - 1
// slabs ahead of the one the warps multiply, so one barrier pair covers SK
// features (the SIMT tile took two per 16) and the loads hide under the
// mma.sync steps. Fragments come from ldmatrix; each warp multiplies a 32 x 64
// tile, 16 mma.sync per k16 step. The ring (72 KB) becomes the f32 score
// tile after the k loop, and K1/K3/K5/K10/K12 keep 2 CTAs per SM
// (__launch_bounds__(NT, 2): at most 128 registers a thread, 64 of them
// scores). A ragged D, or a row base that is not 16-byte aligned, stages
// element by element into the same slabs with the same zero padding: the
// same fragments, the same bits.
template <int LD>
__device__ __forceinline__ void score_tile_bf16(const __nv_bfloat16* __restrict__ q,
                                                const __nv_bfloat16* __restrict__ shard, int Tn,
                                                int D, int valid_rows, int row0, int q0,
                                                float* smem, const NoMaps&) {
  static_assert(LD == LDO, "this tile writes st [TR][LDO]");
  using bf16 = __nv_bfloat16;
  bf16* ring = reinterpret_cast<bf16*>(smem);  // NSTAGE x {rows [TR][SLD], queries [TQ][SLD]}
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / WN) * (TR / WM), wq = (warp % WN) * (TQ / WN);
  const bool vec = (D & 7) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(shard)) & 15) == 0;
  const int slabs = (D + SK - 1) / SK;

  auto stage = [&](int s) {
    bf16* rs = ring + (s % NSTAGE) * 2 * SLAB;
    bf16* qs = rs + SLAB;
    const int d0 = s * SK;
    if (vec) {
      constexpr int CH = SK / 8;  // 16-byte pieces per slab row
      for (int e = tid; e < TR * CH; e += NT) {
        const int r = e / CH, gd = d0 + 8 * (e % CH), gq = q0 + r;
        const bool in = gd < D, q_in = in && gq < Tn;  // D % 8 == 0: whole pieces
        cp_async16_or_zero(rs + r * SLD + gd - d0, shard + (size_t)(row0 + r) * D + (in ? gd : 0),
                           in);
        cp_async16_or_zero(qs + r * SLD + gd - d0, q + (q_in ? (size_t)gq * D + gd : 0), q_in);
      }
    } else {
      const bf16 zero = __float2bfloat16(0.0f);
      for (int e = tid; e < TR * SK; e += NT) {
        const int r = e / SK, dd = e % SK, gd = d0 + dd, gq = q0 + r;
        rs[r * SLD + dd] = gd < D ? shard[(size_t)(row0 + r) * D + gd] : zero;
        qs[r * SLD + dd] = (gd < D && gq < Tn) ? q[(size_t)gq * D + gd] : zero;
      }
    }
  };

  float acc[MT][NQ8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // ldmatrix row addresses of this lane: A rows wr + (lane & 15), features
  // +8 for lanes 16-31; B (two n8 tiles per x4) queries (lane & 7) + 8 *
  // (lane >> 4), features +8 for lanes 8-15 and 24-31.
  const int a_off = (wr + (lane & 15)) * SLD + ((lane >> 4) << 3);
  const int b_off = (wq + (lane & 7) + ((lane >> 4) << 3)) * SLD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < slabs) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    if (s + NSTAGE - 1 < slabs) stage(s + NSTAGE - 1);  // the slot slab s-1 left
    cp_async_commit();
    cp_async_wait<NSTAGE - 1>();  // this thread's pieces of slab s have landed
    __syncthreads();              // ... and every thread's
    const bf16* rs = ring + (s % NSTAGE) * 2 * SLAB;
    const bf16* qs = rs + SLAB;
#pragma unroll
    for (int kk = 0; kk < SK; kk += 16) {
      if (s * SK + kk >= D) break;  // no step wholly past D
      uint32_t b[NQ8][2];
#pragma unroll
      for (int p = 0; p < NQ8 / 2; ++p) {
        uint32_t r4[4];
        ldmatrix_x4(r4, qs + b_off + p * 16 * SLD + kk);
        b[2 * p][0] = r4[0];
        b[2 * p][1] = r4[1];
        b[2 * p + 1][0] = r4[2];
        b[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, rs + a_off + i * 16 * SLD + kk);
#pragma unroll
        for (int j = 0; j < NQ8; ++j) mma_k16(acc[i][j], a, b[j]);
      }
    }
    __syncthreads();  // slab s's slot is refilled next iteration
  }
  cp_async_wait<0>();  // only empty groups are left; the ring becomes st

  float* st = smem;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + i * 16 + g + 8 * h;
      const bool ok = row0 + r < valid_rows;
#pragma unroll
      for (int j = 0; j < NQ8; ++j) {
        const int c = wq + j * 8 + 2 * t;
        st[r * LDO + c] = ok ? acc[i][j][2 * h] : PAD_SIM;
        st[r * LDO + c + 1] = ok ? acc[i][j][2 * h + 1] : PAD_SIM;
      }
    }
  __syncthreads();
}

// ==== bf16 score tile: end ====
