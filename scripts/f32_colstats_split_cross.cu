// A design of the f32 K9/K10 that graphlap_tpu_torch/csrc/colstats_v.cu does
// not ship: the cross on the tensor cores too (fa and f_t in three bf16
// parts, six part products), one 16-column tile a warp. It is not built by
// the package: scripts/f32_colstats_designs.py puts it in place of that
// file's f32 section (from its "f32 layouts" header to the bf16 entry
// points) to time it and to measure its errors; PERF.md section 6 has the
// numbers (its V lies 2e-2 to 6.5e-2 of max |V| from the plain version).
//
// ---------------------------------------------------------------------------
// f32 layouts: the reference's "highest" class
// ---------------------------------------------------------------------------
//
// K10: V_j = (c_j k_j)^T gr, norms, coeffs; K9: ks_j = k_j^T t, s_j =
// sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j, V_j = (s_j k_j)^T gr. The entry is
// the f32 class: d2 = max(na + nb - 2 cross, 0) with the f32 norms passed
// in, k = expf(-d2), every product f32-exact and rounded to nearest, no
// bf16 rounding point (pp _finish_colstats_kernel and _colstats_kernel
// run the cross, ks and V as dots at "highest": six bf16 passes on the
// TPU). What bounds them at 8 MP (p_pad 4096, N 8388608, E = 3.44e10 tile
// entries, V width 64): on the tensor cores as six bf16 passes, the cross
// over the layout's FD lanes (2 FD flop an entry a pass: 53.4 / 40.0 /
// 26.7 ms at 128 / 96 / 64 lanes, 989 TFLOP/s) and V with ks as one more
// n8 tile (72 columns; 30.0 ms, K10's 64 26.7), against one expf an entry
// (8.2 ms on MUFU); as f32 FFMA (67 TFLOP/s) 193.9 ms at 128 lanes.
//
// Design (colstats_tc_kernel), flash attention's shape: the cross, the exp
// and the product with gr in one walk over p, each tile entry formed once.
//   * A 256-thread block owns a tile of VT_TN = 128 columns, a warp 16 of
//     them, and walks p in stages of VT_TP = 32 sample rows: the stage's fa
//     rows (three bf16 parts), na and B's parts arrive by cp.async double
//     buffering. B = [gr | t] (K9: t in column 64 of a ninth n8 tile) or gr
//     (K10), split once a launch by split_cols_kernel into three bf16
//     planes on the grid of each column a stage (split3_grid).
//   * The cross, at 32 to 128 lanes, on the tensor cores (mma.sync
//     m16n8k16) as six part products: fa is split by split_rows_kernel on
//     the grid of each sample row over its lanes (3 x P x FD bf16, 3.1 MB at
//     128 lanes), the tile's f_t columns once when the tile begins on the
//     grid of each column over its lanes, held in shared memory for the
//     whole walk (never in device memory). The corrections a1 b0, a0 b1, a1
//     b1, a2 b0, a0 b2 run in one chain over the lanes from zero; a0 b0 in
//     chains of 32 lanes from zero (21 bits: exact, as K3/K4's stages),
//     added in f32. At 4 live lanes (a 32-lane layout) the cross is 8 FFMA
//     an entry on the FP32 pipe, entry_f32's chain: six passes over 32
//     lanes would be 48x the work.
//   * The exp epilogue (kf32) runs on the accumulator registers, whose
//     layout is the A-fragment layout. Each column's entries in the stage
//     are scaled by 2^-E (E: the column's largest entry in the stage < 2^E,
//     a power of two, so exact) and split into three bf16 parts on the grid
//     2^-8; the scale factors out of the column's sums, so a column of tiny
//     entries (a huge Sinkhorn scale's) keeps f32's relative precision,
//     where split fp16 flushed them.
//   * V's products: six part products a stage and n8 tile of B, the
//     corrections in one chain and a0 b0 in another (exact: 32 rows of
//     2^-16-grid products), each from zero; their sum, times 2^E, is added
//     to the running f32 sum (registers, 36 a thread). The tensor core's
//     f32 accumulation truncates, so no chain runs past one stage.
//   * At the tile's end, K9's ks_j is column 64 of the running sum: s_j from
//     it, V_j = s_j W_j (K10: c_j W_j). The f32 class rounds each product to
//     nearest and has no rounding point between k and its scale, so the
//     scale after the sum is the same function (the bf16 K9 keeps its
//     bf16(k bf16(s)) point). V is written once; norms and coeffs go through
//     a shuffle tree, the warps' slots, per-block partials and the
//     fixed-order reduction. Blocks are persistent and walk the column tiles
//     in a fixed stride order: runs repeat bit for bit.
//   * The FFMA design it replaces (PR 13-20: a ks pass, then the V pass as
//     an SGEMM on entries staged in shared memory) ran K9 / K10 at 846.6 /
//     531.6 ms at 128 lanes, 641.8 / 401.0 at 96, 486.2 / 327.4 at 64 and
//     166.5 / 140.8 at 4 live lanes (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
constexpr int VF_MP = 64;                   // V width a launch (gr padded to it)
constexpr int VT_THREADS = 256;
constexpr int VT_WARPS = VT_THREADS / 32;
constexpr int VT_TN = VT_WARPS * 16;        // columns a block tile, 16 a warp
constexpr int VT_TP = 32;                   // sample rows a stage
constexpr int VT_LDG = VT_TP + 8;           // B parts row stride (bf16): conflict-free ldmatrix
static_assert(VT_THREADS == 2 * VT_TN, "two threads a column split the tile's f_t");
template <int LV>
constexpr int FD_OF = LV <= 32 ? 32 : LV;   // the layout's depth for LV live lanes
template <int LV>
constexpr bool TC_CROSS = LV >= 32;         // the cross on the tensor cores
template <int FD>
constexpr int VT_LDF = FD + 8;              // fa / f_t parts row stride (bf16)
template <bool KS>
constexpr int VT_NB = KS ? 9 : 8;           // n8 tiles of B: gr, and K9's t

struct VF32Args {
  const float* fa;     // (P, FD) FD 32, 64, 96 or 128
  const float* ft;     // (FD, N)
  const float* gr;     // (P, 64) row-major
  const float* c;      // (N) column scale                      K10
  const float* t;      // (P)                                   K9
  const float* s_pre;  // (N)                                   K9
  const float* bm;     // (N)                                   K9
  const float* y;      // (N)
  const float* na;     // (P)
  const float* nb;     // (N)
  bf16* b_parts;       // (3, 8 NB, P) B's parts, column-major (scratch)
  bf16* fa_parts;      // (3, P, FD) fa's parts (scratch, after B's)
  float* v_out;        // (N, 64)
  float* s_out;        // (N)                                   K9
  float* part;         // (gridDim.x, 2, 64) norms, coeffs
  int P, N;
};

// the shared-memory layout of colstats_tc_kernel<LV, KS> (byte offsets)
template <int LV, bool KS>
struct VtSmem {
  static constexpr int FD = FD_OF<LV>, LDF = VT_LDF<FD>, NB = VT_NB<KS>;
  // the tile's f_t parts [3][VT_TN][LDF]
  static constexpr size_t FT = TC_CROSS<LV> ? (size_t)3 * VT_TN * LDF * 2 : 0;
  // a stage of fa: parts [3][VT_TP][LDF], or 4 f32 lanes a row
  static constexpr size_t FA_STAGE =
      TC_CROSS<LV> ? (size_t)3 * VT_TP * LDF * 2 : (size_t)VT_TP * 16;
  static constexpr size_t B_STAGE = (size_t)3 * NB * 8 * VT_LDG * 2;   // [3][8 NB][VT_LDG]
  static constexpr size_t OFF_FA = FT;
  static constexpr size_t OFF_B = OFF_FA + 2 * FA_STAGE;
  static constexpr size_t OFF_NA = OFF_B + 2 * B_STAGE;               // [2][VT_TP]
  static constexpr size_t OFF_CM = OFF_NA + 2 * VT_TP * 4;            // [2][VT_TN]
  static constexpr size_t OFF_WP = OFF_CM + 2 * VT_TN * 4;            // [warps][2][64]
  static constexpr size_t BYTES = OFF_WP + (size_t)VT_WARPS * 2 * VF_MP * 4;
};

// c += a . b, bf16 m16n8k16 with f32 accumulation; not volatile, so the
// compiler interleaves independent chains
__device__ __forceinline__ void mma_tc(float c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fa (P, FD) as its three bf16 parts (3, P, FD), each row on the grid of
// its largest lane: a warp a row, lane l holding lanes 4 l .. 4 l + 3
template <int FD>
__global__ void split_rows_kernel(const float* __restrict__ fa, bf16* __restrict__ out, int P) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= P) return;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < FD / 4) x = *reinterpret_cast<const float4*>(fa + (size_t)row * FD + 4 * lane);
  float m = fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int e = grid_exp(m);
  const float q = pow2(8 - e), qi = pow2(e - 8);
  if (lane < FD / 4) {
    uint32_t lo[3], hi[3];
    split3_grid(x.x, x.y, q, qi, q, qi, lo);
    split3_grid(x.z, x.w, q, qi, q, qi, hi);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(out + ((size_t)p * P + row) * FD + 4 * lane) =
          make_uint2(lo[p], hi[p]);
  }
}

// B = [gr | t | 0] (K9, t != null, nb8 = 72) or gr (K10, nb8 = 64) as its
// three bf16 parts, column-major (3, nb8, P): thread (column m, stage s)
// splits rows [32 s, 32 s + 32) of column m on the grid of their largest
template <int NB8>
__global__ void split_cols_kernel(const float* __restrict__ gr, const float* __restrict__ t,
                                  bf16* __restrict__ out, int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NB8 * (P / VT_TP)) return;
  const int m = i % NB8, r0 = (i / NB8) * VT_TP;
  auto val = [&](int r) {
    return m < VF_MP ? gr[(size_t)r * VF_MP + m] : (m == VF_MP && t != nullptr) ? t[r] : 0.f;
  };
  float mx = 0.f;
#pragma unroll 8
  for (int r = r0; r < r0 + VT_TP; ++r) mx = fmaxf(mx, fabsf(val(r)));
  const int e = grid_exp(mx);
  const float q = pow2(8 - e), qi = pow2(e - 8);
#pragma unroll 4
  for (int r = r0; r < r0 + VT_TP; r += 2) {
    uint32_t o[3];
    split3_grid(val(r), val(r + 1), q, qi, q, qi, o);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint32_t*>(out + ((size_t)p * NB8 + m) * P + r) = o[p];
  }
}

// the stage of rows [p0, p0 + VT_TP) into buffer buf: fa (its parts, or 4
// f32 lanes a row at LV 4), B's parts and na; one cp.async commit group
template <int LV, bool KS>
__device__ __forceinline__ void vt_load_stage(unsigned char* smem, const VF32Args& a, int buf,
                                              int p0) {
  using S = VtSmem<LV, KS>;
  const int tid = threadIdx.x;
  if constexpr (TC_CROSS<LV>) {
    constexpr int CH = S::FD / 8;   // 16-byte chunks a row
    bf16* d = reinterpret_cast<bf16*>(smem + S::OFF_FA + buf * S::FA_STAGE);
#pragma unroll 1
    for (int c = tid; c < 3 * VT_TP * CH; c += VT_THREADS) {
      const int q = c % CH, pr = c / CH;   // pr = part * VT_TP + row
      const int p = pr / VT_TP, r = pr % VT_TP;
      cp_async16(d + pr * S::LDF + 8 * q,
                 a.fa_parts + ((size_t)p * a.P + p0 + r) * S::FD + 8 * q);
    }
  } else {
    float* d = reinterpret_cast<float*>(smem + S::OFF_FA + buf * S::FA_STAGE);
    if (tid < VT_TP) cp_async16(d + 4 * tid, a.fa + (size_t)(p0 + tid) * S::FD);
  }
  bf16* bd = reinterpret_cast<bf16*>(smem + S::OFF_B + buf * S::B_STAGE);
  constexpr int GCH = VT_TP / 8;
#pragma unroll 1
  for (int c = tid; c < 3 * S::NB * 8 * GCH; c += VT_THREADS) {
    const int q = c % GCH, pm = c / GCH;   // pm = part * 8 NB + column
    cp_async16(bd + pm * VT_LDG + 8 * q, a.b_parts + (size_t)pm * a.P + p0 + 8 * q);
  }
  if (tid < VT_TP / 4) {
    float* nd = reinterpret_cast<float*>(smem + S::OFF_NA) + buf * VT_TP;
    cp_async16(nd + 4 * tid, a.na + p0 + 4 * tid);
  }
  cp_async_commit();
}

// the tile's f_t columns [j0, j0 + VT_TN) as three bf16 parts into ft_s
// [3][VT_TN][LDF], each column on the grid of its largest lane: thread
// (column c, half h) reads lanes [h FD / 2, (h + 1) FD / 2) twice (their
// largest, then the split). Ends with the parts written, not yet synced
template <int FD>
__device__ __forceinline__ void split_tile(bf16* ft_s, float* cm_s, const VF32Args& a, int j0) {
  constexpr int LDF = VT_LDF<FD>, H = FD / 2;
  const int c = threadIdx.x % VT_TN, h = threadIdx.x / VT_TN;
  const float* src = a.ft + (size_t)(h * H) * a.N + j0 + c;
  float m = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; ++k) m = fmaxf(m, fabsf(src[(size_t)k * a.N]));
  cm_s[h * VT_TN + c] = m;
  __syncthreads();
  const int e = grid_exp(fmaxf(cm_s[c], cm_s[VT_TN + c]));
  const float q = pow2(8 - e), qi = pow2(e - 8);
#pragma unroll 4
  for (int k = 0; k < H; k += 2) {
    uint32_t o[3];
    split3_grid(src[(size_t)k * a.N], src[(size_t)(k + 1) * a.N], q, qi, q, qi, o);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint32_t*>(ft_s + (p * VT_TN + c) * LDF + h * H + k) = o[p];
  }
}

// The f32 K9 (KS) / K10 at LV lanes: see the section's note.
template <int LV, bool KS>
__global__ __launch_bounds__(VT_THREADS, 1) void colstats_tc_kernel(const VF32Args a) {
  using S = VtSmem<LV, KS>;
  constexpr int FD = S::FD, LDF = S::LDF, NB = S::NB;
  extern __shared__ __align__(16) unsigned char vt_smem[];
  bf16* const ft_s = reinterpret_cast<bf16*>(vt_smem);
  float* const na_s = reinterpret_cast<float*>(vt_smem + S::OFF_NA);
  float* const cm_s = reinterpret_cast<float*>(vt_smem + S::OFF_CM);
  float* const wp_s = reinterpret_cast<float*>(vt_smem + S::OFF_WP);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / VT_TN, nst = a.P / VT_TP;

  for (int i = tid; i < VT_WARPS * 2 * VF_MP; i += VT_THREADS) wp_s[i] = 0.f;
  if ((int)blockIdx.x < ntiles) vt_load_stage<LV, KS>(vt_smem, a, 0, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j0 = tile * VT_TN, jg = j0 + warp * 16 + g;   // this thread's columns jg, jg + 8
    float fcol[2][4];                                        // LV 4: their lanes
    if constexpr (TC_CROSS<LV>) {
      __syncthreads();   // every warp is past the last tile's cross
      split_tile<FD>(ft_s, cm_s, a, j0);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 4; ++k) fcol[h][k] = a.ft[(size_t)k * a.N + jg + 8 * h];
    }
    const float nbv[2] = {a.nb[jg], a.nb[jg + 8]};
    float run[NB][4];
#pragma unroll
    for (int t = 0; t < NB; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[t][e] = 0.f;

    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();   // stage (and the tile's f_t parts) in; everyone done with buf ^ 1
      if (s + 1 < nst)
        vt_load_stage<LV, KS>(vt_smem, a, buf ^ 1, (s + 1) * VT_TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        vt_load_stage<LV, KS>(vt_smem, a, buf ^ 1, 0);
      const float* ns = na_s + buf * VT_TP;

      // the cross of the warp's 16 columns x the stage's 32 rows: n8 tile i
      // holds rows 8 i + 2 tq, + 1 of columns jg (0, 1) and jg + 8 (2, 3)
      float cr[4][4];
      if constexpr (TC_CROSS<LV>) {
        const bf16* fs = reinterpret_cast<const bf16*>(vt_smem + S::OFF_FA + buf * S::FA_STAGE);
        float corr[4][4], sub[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[i][e] = corr[i][e] = sub[i][e] = 0.f;
        const bf16* fa_row = ft_s + (warp * 16 + (lane & 15)) * LDF + (lane >> 4) * 8;
        const bf16* fb_row = fs + ((lane & 7) + ((lane >> 4) << 3)) * LDF + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < FD / 16; ++kk) {
          uint32_t af[3][4];
#pragma unroll
          for (int p = 0; p < 3; ++p) ldsm_x4(af[p], fa_row + p * VT_TN * LDF + 16 * kk);
#pragma unroll
          for (int hp = 0; hp < 2; ++hp) {   // rows 16 hp .. 16 hp + 15: n8 tiles 2 hp, 2 hp + 1
            uint32_t bf[3][4];
#pragma unroll
            for (int p = 0; p < 3; ++p)
              ldsm_x4(bf[p], fb_row + (p * VT_TP + 16 * hp) * LDF + 16 * kk);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = 2 * hp + u;
              const uint32_t b00 = bf[0][2 * u], b01 = bf[0][2 * u + 1];
              const uint32_t b10 = bf[1][2 * u], b11 = bf[1][2 * u + 1];
              const uint32_t b20 = bf[2][2 * u], b21 = bf[2][2 * u + 1];
              mma_tc(corr[i], af[1], b00, b01);
              mma_tc(corr[i], af[0], b10, b11);
              mma_tc(corr[i], af[1], b10, b11);
              mma_tc(corr[i], af[2], b00, b01);
              mma_tc(corr[i], af[0], b20, b21);
              mma_tc(sub[i], af[0], b00, b01);
            }
          }
          if (kk % 2 == 1 || kk + 1 == FD / 16) {   // a0 b0 over 32 lanes: exact, into the cross
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                cr[i][e] += sub[i][e];
                sub[i][e] = 0.f;
              }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[i][e] += corr[i][e];
      } else {
        const float4* fs = reinterpret_cast<const float4*>(vt_smem + S::OFF_FA + buf * S::FA_STAGE);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 x = fs[8 * i + 2 * tq + e];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              cr[i][2 * h + e] =
                  dot4(x, make_float4(fcol[h][0], fcol[h][1], fcol[h][2], fcol[h][3]), 0.f);
          }
      }

      // the entries, each column's largest in the stage (over the quad's
      // rows), and their parts on the grid 2^-8 of the entries times 2^-E
      float mx[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cr[i][e] = kf32(ns[8 * i + 2 * tq + (e & 1)] + nbv[e >> 1], cr[i][e]);
          mx[e >> 1] = fmaxf(mx[e >> 1], cr[i][e]);
        }
      float sc[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // mx < 2^E: E = its exponent + 1, at least -126 (2^-E and 2^E normal)
        const int ex = (int)((__float_as_uint(mx[h]) >> 23) & 0xff) - 126;
        const float inv = pow2(-ex);
        sc[h] = pow2(ex);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          cr[i][2 * h] *= inv;
          cr[i][2 * h + 1] *= inv;
        }
      }
      // A fragments of the two k16 steps: kp[part][step][reg], reg 0 / 1
      // the first n8 tile's rows of columns jg / jg + 8, 2 / 3 the second's
      uint32_t kp[3][2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t o[3];
          split3_grid(cr[i][2 * h], cr[i][2 * h + 1], 256.f, 1.f / 256.f, 256.f, 1.f / 256.f, o);
#pragma unroll
          for (int p = 0; p < 3; ++p) kp[p][i >> 1][2 * (i & 1) + h] = o[p];
        }

      // W += the stage's k^T B: per n8 tile, the corrections' chain and a0
      // b0's, each from zero over the stage's two k16 steps
      const bf16* bs = reinterpret_cast<const bf16*>(vt_smem + S::OFF_B + buf * S::B_STAGE) +
                       (lane & 7) * VT_LDG + (lane >> 3) * 8;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        uint32_t b[3][4];   // part p: step 0's two registers, then step 1's
#pragma unroll
        for (int p = 0; p < 3; ++p) ldsm_x4(b[p], bs + (p * NB * 8 + t * 8) * VT_LDG);
        float c[4] = {0.f, 0.f, 0.f, 0.f}, z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          mma_tc(c, kp[1][k], b[0][2 * k], b[0][2 * k + 1]);
          mma_tc(c, kp[0][k], b[1][2 * k], b[1][2 * k + 1]);
          mma_tc(c, kp[1][k], b[1][2 * k], b[1][2 * k + 1]);
          mma_tc(c, kp[2][k], b[0][2 * k], b[0][2 * k + 1]);
          mma_tc(c, kp[0][k], b[2][2 * k], b[2][2 * k + 1]);
          mma_tc(z, kp[0][k], b[0][2 * k], b[0][2 * k + 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) run[t][e] += (z[e] + c[e]) * sc[e >> 1];
      }
    }

    // the column scales: K9's s from ks (column 64, B's ninth n8 tile, held
    // by the quad's tq 0 lane), K10's c
    float cs[2];
    if constexpr (KS) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jg + 8 * h;
        const float ks = __shfl_sync(0xffffffffu, run[NB - 1][2 * h], lane & ~3);
        cs[h] = sqrtf(a.s_pre[j] / fmaxf(ks, EPS)) * a.bm[j];
        if (tq == 0) a.s_out[j] = cs[h];
      }
    } else {
      cs[0] = a.c[jg];
      cs[1] = a.c[jg + 8];
    }
    // V out; this tile's norms and coeffs into the warp's slots
    const float yv[2] = {a.y[jg], a.y[jg + 8]};
#pragma unroll
    for (int t = 0; t < VF_MP / 8; ++t) {
      const float v0 = run[t][0] * cs[0], v1 = run[t][1] * cs[0];
      const float v2 = run[t][2] * cs[1], v3 = run[t][3] * cs[1];
      *reinterpret_cast<float2*>(a.v_out + (size_t)jg * VF_MP + 8 * t + 2 * tq) =
          make_float2(v0, v1);
      *reinterpret_cast<float2*>(a.v_out + (size_t)(jg + 8) * VF_MP + 8 * t + 2 * tq) =
          make_float2(v2, v3);
      const float va[2][2] = {{v0, v2}, {v1, v3}};   // [entry][column jg, jg + 8]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float nn = fmaf(va[e][1], va[e][1], va[e][0] * va[e][0]);
        float cc = fmaf(yv[1], va[e][1], yv[0] * va[e][0]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {   // over g: a fixed tree
          nn += __shfl_xor_sync(0xffffffffu, nn, off);
          cc += __shfl_xor_sync(0xffffffffu, cc, off);
        }
        if (g == 0) {
          wp_s[(warp * 2 + 0) * VF_MP + 8 * t + 2 * tq + e] += nn;
          wp_s[(warp * 2 + 1) * VF_MP + 8 * t + 2 * tq + e] += cc;
        }
      }
    }
  }
  __syncthreads();
  if (tid < 2 * VF_MP) {   // warps in order
    float s = 0.f;
    for (int w = 0; w < VT_WARPS; ++w) s += wp_s[(w * 2 + tid / VF_MP) * VF_MP + tid % VF_MP];
    a.part[(size_t)blockIdx.x * 2 * VF_MP + tid] = s;
  }
}

template <int LV, bool KS>
int vt_setup(int* blocks_out) {
  using S = VtSmem<LV, KS>;
  cudaError_t e = cudaFuncSetAttribute(colstats_tc_kernel<LV, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(colstats_tc_kernel<LV, KS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess || blocks_out == nullptr) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, colstats_tc_kernel<LV, KS>,
                                                      VT_THREADS, S::BYTES);
  *blocks_out = occ * sms;
  return static_cast<int>(e);
}

// the pre-passes (fa's parts, past 4 lanes; B's), the kernel, then the
// fixed-order reduction of its partials
template <int LV, bool KS>
int launch_vt(int blocks, cudaStream_t s, const VF32Args& a, void* norms_coeffs) {
  using S = VtSmem<LV, KS>;
  int rc = vt_setup<LV, KS>(nullptr);
  if (rc != 0) return rc;
  if constexpr (TC_CROSS<LV>)
    split_rows_kernel<S::FD><<<(a.P + 7) / 8, 256, 0, s>>>(a.fa, a.fa_parts, a.P);
  constexpr int NB8 = 8 * S::NB;
  split_cols_kernel<NB8><<<(NB8 * (a.P / VT_TP) + 255) / 256, 256, 0, s>>>(
      a.gr, KS ? a.t : nullptr, a.b_parts, a.P);
  colstats_tc_kernel<LV, KS><<<blocks, VT_THREADS, S::BYTES, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_reduce(a.part, static_cast<float*>(norms_coeffs), blocks, (size_t)2 * VF_MP, s);
}

template <bool KS>
int launch_vt_lv(int lv, int blocks, cudaStream_t s, const VF32Args& a, void* norms_coeffs) {
  return lv == 4     ? launch_vt<4, KS>(blocks, s, a, norms_coeffs)
         : lv == 32  ? launch_vt<32, KS>(blocks, s, a, norms_coeffs)
         : lv == 64  ? launch_vt<64, KS>(blocks, s, a, norms_coeffs)
         : lv == 96  ? launch_vt<96, KS>(blocks, s, a, norms_coeffs)
         : lv == 128 ? launch_vt<128, KS>(blocks, s, a, norms_coeffs)
                     : static_cast<int>(cudaErrorInvalidValue);
}

VF32Args vf32_args(const void* fa, const void* ft, const void* gr, const void* y, const void* na,
                   const void* nb, void* v_out, void* part, void* scratch, int P, int N, int fd) {
  VF32Args a = {};
  a.fa = static_cast<const float*>(fa);
  a.ft = static_cast<const float*>(ft);
  a.gr = static_cast<const float*>(gr);
  a.y = static_cast<const float*>(y);
  a.na = static_cast<const float*>(na);
  a.nb = static_cast<const float*>(nb);
  a.v_out = static_cast<float*>(v_out);
  a.part = static_cast<float*>(part);
  a.b_parts = static_cast<bf16*>(scratch);
  a.fa_parts = a.b_parts + (size_t)3 * 8 * VT_NB<true> * P;
  (void)fd;
  a.P = P;
  a.N = N;
  return a;
}

}  // namespace

extern "C" {

// the scratch bytes of an f32 K9 (ks != 0) or K10 launch at P sample rows
// and fd lanes: B's three bf16 parts (K9's width), then fa's
size_t glt_colstats_f32_scratch_bytes(int P, int fd, int ks) {
  (void)ks;
  return (size_t)3 * (8 * VT_NB<true> + fd) * P * sizeof(bf16);
}

// how many f32 K9 (ks != 0) or K10 blocks fit the card at once
int glt_colstats_f32_blocks(int lv, int ks) {
  int n = 0;
  int rc = -1;
  if (ks)
    rc = lv == 4     ? vt_setup<4, true>(&n)
         : lv == 32  ? vt_setup<32, true>(&n)
         : lv == 64  ? vt_setup<64, true>(&n)
         : lv == 96  ? vt_setup<96, true>(&n)
         : lv == 128 ? vt_setup<128, true>(&n)
                     : -1;
  else
    rc = lv == 4     ? vt_setup<4, false>(&n)
         : lv == 32  ? vt_setup<32, false>(&n)
         : lv == 64  ? vt_setup<64, false>(&n)
         : lv == 96  ? vt_setup<96, false>(&n)
         : lv == 128 ? vt_setup<128, false>(&n)
                     : -1;
  return rc < 0 ? 0 : rc != 0 ? -rc : n;
}

int glt_colstats_v_f32(const void* fa, const void* ft, const void* gr, const void* c,
                       const void* y, const void* na, const void* nb, void* v_out, void* part,
                       void* norms_coeffs, void* scratch, int P, int N, int lv, int blocks,
                       void* stream) {
  if (P % VT_TP || N % VT_TN || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, scratch, P, N, lv);
  a.c = static_cast<const float*>(c);
  return launch_vt_lv<false>(lv, blocks, reinterpret_cast<cudaStream_t>(stream), a,
                             norms_coeffs);
}

int glt_finish_colstats_f32(const void* fa, const void* ft, const void* gr, const void* t,
                            const void* s_pre, const void* bm, const void* y, const void* na,
                            const void* nb, void* v_out, void* s_out, void* part,
                            void* norms_coeffs, void* scratch, int P, int N, int lv, int blocks,
                            void* stream) {
  if (P % VT_TP || N % VT_TN || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, scratch, P, N, lv);
  a.t = static_cast<const float*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s_out = static_cast<float*>(s_out);
  return launch_vt_lv<true>(lv, blocks, reinterpret_cast<cudaStream_t>(stream), a,
                            norms_coeffs);
}
