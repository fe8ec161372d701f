// ==== int8 score tile: begin (the mma.sync variant of bench/ab_topk.py) ====

// The int8 score tile on mma.sync m16n8k32 s8 instead of wgmma: 256 threads,
// 8 warps of 32 rows x 64 queries (I8M_WM x I8M_WN), each a tile of I8M_MT x
// I8M_NQ8 mma fragments, D through a ring of I8M_STAGES cp.async slabs of
// 128 bytes a row, rows padded to 144 bytes, ldmatrix fragments. An ldmatrix
// 8x8 b16 load gives each lane 4 consecutive bytes of one row, which is the
// s8 fragment's layout, so the bf16 ldmatrix addresses serve k32 steps of 32
// bytes; the s32 sum accumulates in the instruction across all of D.
// bench/ab_topk.py splices this block into a copy of
// ops/csrc/topk_kernels.cu in place of the shipped block (the same names and
// contract: Tile<int8_t> and score_tile_i8<RAW, LD>) to time the two tiles in
// one call.
constexpr int I8M_WM = 4;
constexpr int I8M_WN = 2;
constexpr int I8M_MT = TR / I8M_WM / 16;
constexpr int I8M_NQ8 = TQ / I8M_WN / 8;
constexpr int I8M_STAGES = 2;
constexpr int I8_SLAB = 128;
constexpr int I8_SLD = I8_SLAB + 16;
constexpr size_t I8_RING_BYTES = (size_t)I8M_STAGES * 2 * TR * I8_SLD;
constexpr size_t I8_ST_BYTES = sizeof(float) * (size_t)TR * LDO_I8;
constexpr size_t I8_TILE_BYTES = I8_RING_BYTES > I8_ST_BYTES ? I8_RING_BYTES : I8_ST_BYTES;
static_assert(I8M_WM * I8M_WN * 32 == NT, "one warp per warp tile");

template <>
struct Tile<int8_t> {
  static constexpr int threads = NT;
  static constexpr int min_blocks = 2;
  static constexpr int ld = LDO_I8;
  using Maps = NoMaps;
  static constexpr size_t smem(size_t extra) {
    return I8_TILE_BYTES > I8_ST_BYTES + extra ? I8_TILE_BYTES : I8_ST_BYTES + extra;
  }
  static __device__ __forceinline__ float* base(float4* raw) {
    return reinterpret_cast<float*>(raw);
  }
};

// c += A (16 rows x 32 features) * B (32 features x 8 queries), s32.
__device__ __forceinline__ void mma_s8_k32(int (&c)[4], const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool RAW, int LD>
__device__ __forceinline__ void score_tile_i8(const int8_t* __restrict__ q,
                                              const int8_t* __restrict__ shard, int Tn, int D,
                                              int valid_rows, int row0, int q0, float* smem,
                                              const NoMaps&, float scale) {
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp / I8M_WN) * (TR / I8M_WM), wq = (warp % I8M_WN) * (TQ / I8M_WN);
  const bool vec = (D & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(shard)) & 15) == 0;
  const int slabs = (D + I8_SLAB - 1) / I8_SLAB;

  auto stage = [&](int s) {
    uint8_t* rs = ring + (s % I8M_STAGES) * 2 * TR * I8_SLD;
    uint8_t* qs = rs + TR * I8_SLD;
    const int d0 = s * I8_SLAB;
    if (vec) {
      constexpr int CH = I8_SLAB / 16;
      for (int e = tid; e < TR * CH; e += NT) {
        const int r = e / CH, gd = d0 + 16 * (e % CH), gq = q0 + r;
        const bool in = gd < D, q_in = in && gq < Tn;
        cp_async16_or_zero(rs + r * I8_SLD + gd - d0,
                           shard + (size_t)(row0 + r) * D + (in ? gd : 0), in);
        cp_async16_or_zero(qs + r * I8_SLD + gd - d0, q + (q_in ? (size_t)gq * D + gd : 0), q_in);
      }
    } else {
      for (int e = tid; e < TR * I8_SLAB; e += NT) {
        const int r = e / I8_SLAB, dd = e % I8_SLAB, gd = d0 + dd, gq = q0 + r;
        rs[r * I8_SLD + dd] = gd < D ? (uint8_t)shard[(size_t)(row0 + r) * D + gd] : 0;
        qs[r * I8_SLD + dd] = (gd < D && gq < Tn) ? (uint8_t)q[(size_t)gq * D + gd] : 0;
      }
    }
  };

  int acc[I8M_MT][I8M_NQ8][4];
#pragma unroll
  for (int i = 0; i < I8M_MT; ++i)
#pragma unroll
    for (int j = 0; j < I8M_NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the bf16 tile's ldmatrix row addresses, in bytes
  const int a_off = (wr + (lane & 15)) * I8_SLD + ((lane >> 4) << 4);
  const int b_off = (wq + (lane & 7) + ((lane >> 4) << 3)) * I8_SLD + (((lane >> 3) & 1) << 4);
#pragma unroll
  for (int s = 0; s < I8M_STAGES - 1; ++s) {
    if (s < slabs) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < slabs; ++s) {
    if (s + I8M_STAGES - 1 < slabs) stage(s + I8M_STAGES - 1);
    cp_async_commit();
    cp_async_wait<I8M_STAGES - 1>();
    __syncthreads();
    const uint8_t* rs = ring + (s % I8M_STAGES) * 2 * TR * I8_SLD;
    const uint8_t* qs = rs + TR * I8_SLD;
#pragma unroll
    for (int kk = 0; kk < I8_SLAB; kk += 32) {
      if (s * I8_SLAB + kk >= D) break;
      uint32_t b[I8M_NQ8][2];
#pragma unroll
      for (int p = 0; p < I8M_NQ8 / 2; ++p) {
        uint32_t r4[4];
        ldmatrix_x4(r4, reinterpret_cast<const __nv_bfloat16*>(qs + b_off + p * 16 * I8_SLD + kk));
        b[2 * p][0] = r4[0];
        b[2 * p][1] = r4[1];
        b[2 * p + 1][0] = r4[2];
        b[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < I8M_MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, reinterpret_cast<const __nv_bfloat16*>(rs + a_off + i * 16 * I8_SLD + kk));
#pragma unroll
        for (int j = 0; j < I8M_NQ8; ++j) mma_s8_k32(acc[i][j], a, b[j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  int* ist = reinterpret_cast<int*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < I8M_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + i * 16 + g + 8 * h;
      const bool ok = row0 + r < valid_rows;
#pragma unroll
      for (int j = 0; j < I8M_NQ8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wq + j * 8 + 2 * t + e, a = acc[i][j][2 * h + e];
          if constexpr (RAW)
            ist[r * LD + c] = ok ? a : PAD_ACC;
          else
            smem[r * LD + c] = ok ? int8_score(a, scale) : PAD_SIM;
        }
    }
  __syncthreads();
}

// ==== int8 score tile: end ====
