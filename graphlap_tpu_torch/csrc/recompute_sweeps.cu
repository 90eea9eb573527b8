// K7-K9 — the recompute-streaming kernels of the fused-finish path: every
// kernel tile k(p, j) = exp(-d2(f_Ap, f_j)) is recomputed from the bf16
// features, never stored in device memory.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K7  kb_strip_pallas        (_kb_emit_kernel)
//         out[p, j] = bf16(bf16(exp(-bf16(max(d2_aug, 0)))) * bf16(cols_j))
//   K8  ext2_matvec_pallas     (_ext2_matvec_kernel), aug layout
//         kbt_j = k_j^T bf16([t_r, t_c]);  s_j = bm_j / sqrt(max(kbt_r kbt_c, 1e-30))
//         u    += k_j s_j                          (k_j: bf16, s_j: f32)
//   K9  finish_colstats_pallas (_finish_colstats_kernel), plain layout
//         k_j   = bf16(exp(-max(na + nb_j - 2 cross, 0)))   (f32 exp)
//         ks_j  = k_j^T bf16(t);  s_j = sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j
//         V_j   = bf16(k_j bf16(s_j))^T bf16(gr);  norms += V_j^2;  coeffs += y_j V_j
// with the Pallas rounding points. d2 (aug) and cross (plain) come from
// bf16 x bf16 tensor-core products with f32 accumulation (mma.sync
// m16n8k16), the feature depth is 32 (d_pad_of / aug_d_pad_of of NLM d=25).
//
// What bounds them on an H100, at the 8 MP shape (p_pad 4096, N 8388608):
// K8 and K9 each evaluate 3.4e10 tile entries, each one expf (a MUFU ex2
// plus ~8 FP32 instructions) and ~10 more FP32 operations (bf16 rounding,
// max, the column and row sums): ~2-4e11 FP32-pipe instructions, ~10-20 ms
// at 132 SMs x 128 lanes x 1.98 GHz; the tensor-core work (2.2 TFLOP of d2,
// K9's 4.4 TFLOP V product at m_pad 64) is ~2-7 ms at the bf16 peak, and
// memory (features 0.5 GB, K9's V 2.1 GB) ~1 ms. They are bound by the
// per-entry SIMT work. K7 emits 1.07 GB of bf16 (0.32 ms at 3.35 TB/s) for
// 5.4e8 entries: bound by its store.
//
// Design of K8/K9. Each tile has two consumers that need the whole sample
// column first (kbt / ks before s, s before u / V). A (4096 x tn) tile does
// not fit one SM's 227 KB, and blocks run in no order, so the kernels run
// in thread-block clusters of 8 (Hopper distributed shared memory):
//   * block r of a cluster owns sample rows [r P/8, (r+1) P/8), keeps its
//     feature rows in shared memory for the whole run, and computes its
//     (tn x P/8) slice of each column tile ONCE: mma for d2 / cross, then the
//     exp epilogue on the accumulator registers, the bf16 tile stored
//     transposed ([j][p]) in shared memory;
//   * the column sums (kbt, ks) are a second mma per block: the packed bf16
//     tile fragments times [t_r, t_c] (K8) or t (K9) as a B operand padded
//     with zeros (bf16 products are exact in f32, so only the f32 order
//     differs from a SIMT sum), then summed across the cluster through
//     distributed shared memory, every block adding the 8 partials in rank
//     order, so all 8 get the same s;
//   * K8's u stays in registers (one row a thread) across all tiles; K9's
//     V partials (tn x m_pad) are summed across the cluster the same way,
//     each block finishing tn/8 rows of V, norms and coeffs;
//   * 16 warps a block (one block an SM: the features and the tile take
//     most of its shared memory) to hide the exp chain's latency, and the
//     next column tile's features load into registers while the current
//     tile is finished;
//   * clusters walk the column tiles in a fixed order, and every cross-
//     cluster sum (u, norms, coeffs) goes through per-cluster partials and
//     a fixed-order reduction kernel — no float atomics, so runs repeat
//     bit for bit.
// K7 writes one (128 x 128) output tile a block: mma, the exp and scale
// epilogue into shared memory, then 16-byte coalesced stores.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() (or the first error) after
// its launches.

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int CL = 8;        // blocks a cluster (sample-row slices)
constexpr int FD = 32;       // feature depth
constexpr int LDF = FD + 8;  // padded shared row stride of feature tiles (bf16)
constexpr int X_TN = 128;    // K8 columns a tile
constexpr int F_TN = 64;     // K9 columns a tile
constexpr int E_TM = 128;    // K7 rows a block
constexpr int E_TN = 128;    // K7 columns a block
constexpr int E_LDO = E_TN + 8;

// A fragment (16 rows x 16 k) of a row-major [row][k] tile, stride LDF
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int row0,
                                       int k0, int g, int tq) {
  a[0] = ld32(s + (row0 + g) * LDF + k0 + 2 * tq);
  a[1] = ld32(s + (row0 + g + 8) * LDF + k0 + 2 * tq);
  a[2] = ld32(s + (row0 + g) * LDF + k0 + 8 + 2 * tq);
  a[3] = ld32(s + (row0 + g + 8) * LDF + k0 + 8 + 2 * tq);
}

// B fragment (16 k x 8 n) where B[k][n] = s[n][k] (row-major [n][k], LDF)
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* s, int n0,
                                       int k0, int g, int tq) {
  b[0] = ld32(s + (n0 + g) * LDF + k0 + 2 * tq);
  b[1] = ld32(s + (n0 + g) * LDF + k0 + 8 + 2 * tq);
}

// rows [r0, r0 + rows) of a (*, 32) bf16 matrix -> s[row][k], stride LDF
__device__ void load_rows(bf16* s, const bf16* __restrict__ m, int r0, int rows) {
  for (int v = threadIdx.x; v < rows * 4; v += THREADS) {
    const int r = v / 4, q = v % 4;
    *reinterpret_cast<uint4*>(s + r * LDF + q * 8) =
        *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * FD + q * 8);
  }
}

// columns [j0, j0 + cols) of the (32, ld) bf16 f_t -> s[j][k], stride LDF
__device__ void load_cols_t(bf16* s, const bf16* __restrict__ ft, size_t ld,
                            int j0, int cols) {
  for (int v = threadIdx.x; v < (FD / 2) * cols; v += THREADS) {
    const int kp = v / cols, j = v % cols;
    const bf16 lo = ft[(size_t)(2 * kp) * ld + j0 + j];
    const bf16 hi = ft[(size_t)(2 * kp + 1) * ld + j0 + j];
    __nv_bfloat162 h;
    h.x = lo;
    h.y = hi;
    *reinterpret_cast<__nv_bfloat162*>(s + j * LDF + 2 * kp) = h;
  }
}

// ---------------------------------------------------------------------------
// K7: the column-scaled tile emitter (aug layout)
// ---------------------------------------------------------------------------

constexpr size_t E_SMEM = (size_t)(E_TM + E_TN) * LDF * 2 + (size_t)E_TM * E_LDO * 2 +
                          (size_t)E_TN * 4;

__global__ __launch_bounds__(THREADS) void kb_emit_kernel(
    const bf16* __restrict__ fa,    // (P, 32) aug
    const bf16* __restrict__ ft,    // (32, S) aug
    const bf16* __restrict__ cols,  // (S)
    bf16* __restrict__ out,         // (P, S)
    int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* fa_s = reinterpret_cast<bf16*>(smem);
  bf16* ft_s = fa_s + E_TM * LDF;
  bf16* o_s = ft_s + E_TN * LDF;
  float* c_s = reinterpret_cast<float*>(o_s + E_TM * E_LDO);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * E_TN, p0 = blockIdx.y * E_TM;

  load_rows(fa_s, fa, p0, E_TM);
  load_cols_t(ft_s, ft, (size_t)S, j0, E_TN);
  if (tid < E_TN) c_s[tid] = __bfloat162float(cols[j0 + tid]);
  __syncthreads();

  const int pb = warp * 16;
  uint32_t a0[4], a1[4];
  frag_a(a0, fa_s, pb, 0, g, tq);
  frag_a(a1, fa_s, pb, 16, g, tq);
#pragma unroll 4
  for (int nt = 0; nt < E_TN / 8; ++nt) {
    uint32_t b0[2], b1[2];
    frag_b(b0, ft_s, nt * 8, 0, g, tq);
    frag_b(b1, ft_s, nt * 8, 16, g, tq);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(c, a0, b0);
    mma16816(c, a1, b1);
    const int j = nt * 8 + 2 * tq;
    const float s0 = c_s[j], s1 = c_s[j + 1];
    *reinterpret_cast<uint32_t*>(o_s + (pb + g) * E_LDO + j) =
        pack2(kb_aug(c[0]) * s0, kb_aug(c[1]) * s1);
    *reinterpret_cast<uint32_t*>(o_s + (pb + g + 8) * E_LDO + j) =
        pack2(kb_aug(c[2]) * s0, kb_aug(c[3]) * s1);
  }
  __syncthreads();
  for (int v = tid; v < E_TM * (E_TN / 8); v += THREADS) {
    const int r = v / (E_TN / 8), q = v % (E_TN / 8);
    *reinterpret_cast<uint4*>(out + (size_t)(p0 + r) * S + j0 + q * 8) =
        *reinterpret_cast<const uint4*>(o_s + r * E_LDO + q * 8);
  }
}

// ---------------------------------------------------------------------------
// the cluster kernels (K8, K9): 16 warps a block, and the next column
// tile's features prefetched into registers while the current one is
// finished
// ---------------------------------------------------------------------------

constexpr int C_THREADS = 512;

// the (32, TN) f_t tile at column j0 as packed bf16 pairs (k 2kp, 2kp + 1),
// ITEMS = 16 TN / C_THREADS a thread
template <int TN>
struct TilePrefetch {
  static constexpr int ITEMS = (FD / 2) * TN / C_THREADS;
  uint32_t v[ITEMS];
  __device__ void load(const bf16* __restrict__ ft, size_t ld, int j0) {
    const unsigned short* f = reinterpret_cast<const unsigned short*>(ft);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = threadIdx.x + q * C_THREADS, kp = i / TN, j = i % TN;
      v[q] = (uint32_t)f[(size_t)(2 * kp) * ld + j0 + j] |
             ((uint32_t)f[(size_t)(2 * kp + 1) * ld + j0 + j] << 16);
    }
  }
  __device__ void store(bf16* s) const {     // -> s[j][k], stride LDF
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = threadIdx.x + q * C_THREADS, kp = i / TN, j = i % TN;
      *reinterpret_cast<uint32_t*>(s + j * LDF + 2 * kp) = v[q];
    }
  }
};

// rows [r0, r0 + rows) of a (*, 32) bf16 matrix -> s[row][k], stride LDF
__device__ void load_rows_c(bf16* s, const bf16* __restrict__ m, int r0, int rows) {
  for (int v = threadIdx.x; v < rows * 4; v += C_THREADS) {
    const int r = v / 4, q = v % 4;
    *reinterpret_cast<uint4*>(s + r * LDF + q * 8) =
        *reinterpret_cast<const uint4*>(m + (size_t)(r0 + r) * FD + q * 8);
  }
}

// ---------------------------------------------------------------------------
// K8: extension + polish matvec (aug layout), clusters of 8
// ---------------------------------------------------------------------------

size_t ext2_smem(int P) {
  const int rb = P / CL, ldk = rb + 8;
  return (size_t)(rb + X_TN) * LDF * 2 + (size_t)X_TN * ldk * 2 +
         sizeof(float) * ((size_t)rb + 4 * X_TN + 4 * X_TN + X_TN);
}

__global__ __launch_bounds__(C_THREADS, 1) void ext2_matvec_kernel(
    const bf16* __restrict__ fa,   // (P, 32) aug
    const bf16* __restrict__ ft,   // (32, N) aug
    const bf16* __restrict__ t2,   // (2, P), bf16-rounded
    const float* __restrict__ bm,  // (N)
    float* __restrict__ s_out,     // (N)
    float* __restrict__ u_part,    // (clusters, P)
    int P, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  const int rb = P / CL, r0 = rank * rb, ldk = rb + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* fa_s = reinterpret_cast<bf16*>(smem);
  bf16* ft_s = fa_s + rb * LDF;
  bf16* kb_s = ft_s + X_TN * LDF;                         // [j][p]
  bf16* t2_s = kb_s + X_TN * ldk;                         // [2][rb] bf16(t_r | t_c)
  float* kbw_s = reinterpret_cast<float*>(t2_s) + rb;     // [2 halves][2][X_TN]
  float* kbt_s = kbw_s + 4 * X_TN;                         // [2 bufs][2][X_TN]
  float* s_s = kbt_s + 4 * X_TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  load_rows_c(fa_s, fa, r0, rb);
  for (int i = tid; i < rb; i += C_THREADS) {
    t2_s[i] = t2[r0 + i];
    t2_s[rb + i] = t2[P + r0 + i];
  }
  const bool owns = tid < rb;       // this thread's u row
  float u = 0.f;
  const int jb = (warp & 7) * 16;   // this warp's 16 columns of a tile
  const int half = warp >> 3;       // and its half of the block's rows
  const int nth = rb / 16;          // 8-row n-tiles a half
  const int ntiles = N / X_TN;

  TilePrefetch<X_TN> pre;
  if (cid < ntiles) pre.load(ft, (size_t)N, cid * X_TN);
  int it = 0;
  for (int tile = cid; tile < ntiles; tile += ncl, ++it) {
    const int j0 = tile * X_TN;
    float* kbt = kbt_s + (it & 1) * 2 * X_TN;
    __syncthreads();                       // the last tile's readers are done
    pre.store(ft_s);
    __syncthreads();
    if (tile + ncl < ntiles) pre.load(ft, (size_t)N, (tile + ncl) * X_TN);
    uint32_t a0[4], a1[4];
    frag_a(a0, ft_s, jb, 0, g, tq);
    frag_a(a1, ft_s, jb, 16, g, tq);
    // kbt on the tensor cores: the packed tile of two n-tiles (16 rows) is
    // the A fragment of (16 columns x 16 rows) . (16 rows x [t_r, t_c, 0..])
    float kt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int np = half * (nth / 2); np < (half + 1) * (nth / 2); ++np) {
      uint32_t a[4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * np + h2;
        uint32_t b0[2], b1[2];
        frag_b(b0, fa_s, nt * 8, 0, g, tq);
        frag_b(b1, fa_s, nt * 8, 16, g, tq);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c, a0, b0);
        mma16816(c, a1, b1);
        const int p = nt * 8 + 2 * tq;
        a[2 * h2] = pack2(kb_aug(c[0]), kb_aug(c[1]));
        a[2 * h2 + 1] = pack2(kb_aug(c[2]), kb_aug(c[3]));
        *reinterpret_cast<uint32_t*>(kb_s + (jb + g) * ldk + p) = a[2 * h2];
        *reinterpret_cast<uint32_t*>(kb_s + (jb + g + 8) * ldk + p) = a[2 * h2 + 1];
      }
      const int p0 = np * 16 + 2 * tq;
      uint32_t b[2];
      b[0] = g < 2 ? ld32(t2_s + g * rb + p0) : 0u;
      b[1] = g < 2 ? ld32(t2_s + g * rb + p0 + 8) : 0u;
      mma16816(kt, a, b);
    }
    if (tq == 0) {   // kt: (column jb+g | jb+g+8) x (t_r | t_c)
      float* w = kbw_s + half * 2 * X_TN;
      w[jb + g] = kt[0];
      w[jb + g + 8] = kt[2];
      w[X_TN + jb + g] = kt[1];
      w[X_TN + jb + g + 8] = kt[3];
    }
    __syncthreads();
    if (tid < 2 * X_TN) kbt[tid] = kbw_s[tid] + kbw_s[2 * X_TN + tid];  // halves in order
    cluster.sync();                        // every block's partials are in
    if (tid < X_TN) {
      float kr = 0.f, kc = 0.f;
      for (int r = 0; r < CL; ++r) {       // rank order: the same s everywhere
        const float* rem = cluster.map_shared_rank(kbt, r);
        kr += rem[tid];
        kc += rem[X_TN + tid];
      }
      const float s = bm[j0 + tid] / sqrtf(fmaxf(kr * kc, EPS));
      s_s[tid] = s;
      if (rank == 0) s_out[j0 + tid] = s;
    }
    __syncthreads();
    if (owns) {
#pragma unroll 8
      for (int j = 0; j < X_TN; ++j)
        u = fmaf(__bfloat162float(kb_s[j * ldk + tid]), s_s[j], u);
    }
  }
  if (owns) u_part[(size_t)cid * P + r0 + tid] = u;
  cluster.sync();                          // no block leaves while read remotely
}

// ---------------------------------------------------------------------------
// K9: polish rmatvec + scale update + V, norms, coeffs (plain layout)
// ---------------------------------------------------------------------------

size_t finish_smem(int P, int MP) {
  const int rb = P / CL, ldk = rb + 8;
  return (size_t)(rb + F_TN) * LDF * 2 + (size_t)(F_TN + MP) * ldk * 2 +
         sizeof(bf16) * (size_t)rb +
         sizeof(float) * ((size_t)rb + 4 * F_TN + F_TN + F_TN + (size_t)F_TN * MP);
}

__global__ __launch_bounds__(C_THREADS, 1) void finish_colstats_kernel(
    const bf16* __restrict__ fa,     // (P, 32) plain
    const bf16* __restrict__ ft,     // (32, N) aug superset
    const bf16* __restrict__ t,      // (P) bf16-rounded
    const float* __restrict__ s_pre, // (N)
    const float* __restrict__ bm,    // (N)
    const float* __restrict__ gr,    // (P, MP)
    const float* __restrict__ y,     // (N)
    const float* __restrict__ na,    // (P)
    const float* __restrict__ nb,    // (N)
    float* __restrict__ v_out,       // (N, MP)
    float* __restrict__ s_out,       // (N)
    float* __restrict__ part,        // (gridDim.x, 2, MP) norms, coeffs
    int P, int N, int MP) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  const int rb = P / CL, r0 = rank * rb, ldk = rb + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* fa_s = reinterpret_cast<bf16*>(smem);
  bf16* ft_s = fa_s + rb * LDF;
  bf16* kb_s = ft_s + F_TN * LDF;                      // [j][p]
  bf16* gr_s = kb_s + F_TN * ldk;                      // [m][p], bf16(gr)
  bf16* t_s = gr_s + MP * ldk;                         // bf16(t)
  float* na_s = reinterpret_cast<float*>(t_s + rb);
  float* ksw_s = na_s + rb;                            // [4 quarters][F_TN]
  float* ks_s = ksw_s + 4 * F_TN;                      // block partial ks
  float* s_s = ks_s + F_TN;                            // bf16(s_new)
  float* vp_s = s_s + F_TN;                            // [F_TN][MP] V partial
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  load_rows_c(fa_s, fa, r0, rb);
  for (int i = tid; i < rb; i += C_THREADS) {
    t_s[i] = t[r0 + i];
    na_s[i] = na[r0 + i];
  }
  for (int v = tid; v < rb * MP; v += C_THREADS) {
    const int p = v / MP, m = v % MP;
    gr_s[m * ldk + p] = __float2bfloat16_rn(gr[(size_t)(r0 + p) * MP + m]);
  }
  const int jb = (warp & 3) * 16;       // this warp's 16 columns of a tile
  const int quarter = warp >> 2;        // and its quarter of p (or of m)
  const int ntq = rb / 32;              // 8-row p n-tiles a quarter
  const int ntm = MP / 8;               // 8-wide m n-tiles in all
  const int rows_mine = F_TN / CL;      // V rows this block finishes a tile
  const int items = rows_mine * MP;     // <= 512 (MP <= 64)
  float nacc = 0.f, cacc = 0.f;
  const int ntiles = N / F_TN;

  TilePrefetch<F_TN> pre;
  if (cid < ntiles) pre.load(ft, (size_t)N, cid * F_TN);
  for (int tile = cid; tile < ntiles; tile += ncl) {
    const int j0 = tile * F_TN;
    __syncthreads();
    pre.store(ft_s);
    __syncthreads();
    if (tile + ncl < ntiles) pre.load(ft, (size_t)N, (tile + ncl) * F_TN);
    // cross -> k (f32 exp, bf16 tile) and the ks partial over this quarter
    uint32_t a0[4], a1[4];
    frag_a(a0, ft_s, jb, 0, g, tq);
    frag_a(a1, ft_s, jb, 16, g, tq);
    const float nb0 = nb[j0 + jb + g], nb1 = nb[j0 + jb + g + 8];
    // ks on the tensor cores, as K8's kbt: (16 columns x 16 rows) . (16
    // rows x [t, 0..])
    float kt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int np = quarter * (ntq / 2); np < (quarter + 1) * (ntq / 2); ++np) {
      uint32_t a[4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int nt = 2 * np + h2;
        uint32_t b0[2], b1[2];
        frag_b(b0, fa_s, nt * 8, 0, g, tq);
        frag_b(b1, fa_s, nt * 8, 16, g, tq);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c, a0, b0);
        mma16816(c, a1, b1);
        const int p = nt * 8 + 2 * tq;
        const float n0 = na_s[p], n1 = na_s[p + 1];
        a[2 * h2] = pack2(expf(-fmaxf(n0 + nb0 - 2.f * c[0], 0.f)),
                          expf(-fmaxf(n1 + nb0 - 2.f * c[1], 0.f)));
        a[2 * h2 + 1] = pack2(expf(-fmaxf(n0 + nb1 - 2.f * c[2], 0.f)),
                              expf(-fmaxf(n1 + nb1 - 2.f * c[3], 0.f)));
        *reinterpret_cast<uint32_t*>(kb_s + (jb + g) * ldk + p) = a[2 * h2];
        *reinterpret_cast<uint32_t*>(kb_s + (jb + g + 8) * ldk + p) = a[2 * h2 + 1];
      }
      const int p0 = np * 16 + 2 * tq;
      uint32_t b[2];
      b[0] = g == 0 ? ld32(t_s + p0) : 0u;
      b[1] = g == 0 ? ld32(t_s + p0 + 8) : 0u;
      mma16816(kt, a, b);
    }
    if (tq == 0) {   // kt[0], kt[2]: ks of columns jb+g, jb+g+8
      ksw_s[quarter * F_TN + jb + g] = kt[0];
      ksw_s[quarter * F_TN + jb + g + 8] = kt[2];
    }
    __syncthreads();
    if (tid < F_TN)                                   // quarters in order
      ks_s[tid] = ((ksw_s[tid] + ksw_s[F_TN + tid]) + ksw_s[2 * F_TN + tid]) +
                  ksw_s[3 * F_TN + tid];
    cluster.sync();                                   // #1: ks partials in
    if (tid < F_TN) {
      float ks = 0.f;
      for (int r = 0; r < CL; ++r) ks += cluster.map_shared_rank(ks_s, r)[tid];
      const int j = j0 + tid;
      const float s = sqrtf(s_pre[j] / fmaxf(ks, EPS)) * bm[j];
      if (rank == 0) s_out[j] = s;
      s_s[tid] = rbf(s);
    }
    __syncthreads();
    // the tile scaled in place: kb_s[j][p] = bf16(k bf16(s_j))
    for (int v = tid; v < F_TN * (rb / 2); v += C_THREADS) {
      const int j = v / (rb / 2), pp = 2 * (v % (rb / 2));
      uint32_t* w = reinterpret_cast<uint32_t*>(kb_s + j * ldk + pp);
      const float2 x = unpack2(*w);
      const float sj = s_s[j];
      *w = pack2(x.x * sj, x.y * sj);
    }
    __syncthreads();
    // V partial (F_TN x MP) = kb_s^T bf16(gr) over this block's rows;
    // warp: 16 columns, m n-tiles quarter, quarter + 4
    {
      float acc[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll 4
      for (int k0 = 0; k0 < rb; k0 += 16) {
        uint32_t a[4];
        a[0] = ld32(kb_s + (jb + g) * ldk + k0 + 2 * tq);
        a[1] = ld32(kb_s + (jb + g + 8) * ldk + k0 + 2 * tq);
        a[2] = ld32(kb_s + (jb + g) * ldk + k0 + 8 + 2 * tq);
        a[3] = ld32(kb_s + (jb + g + 8) * ldk + k0 + 8 + 2 * tq);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nt = quarter + 4 * q;
          if (nt < ntm) {
            uint32_t b[2];
            b[0] = ld32(gr_s + (nt * 8 + g) * ldk + k0 + 2 * tq);
            b[1] = ld32(gr_s + (nt * 8 + g) * ldk + k0 + 8 + 2 * tq);
            mma16816(acc[q], a, b);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nt = quarter + 4 * q;
        if (nt < ntm) {
          const int m = nt * 8 + 2 * tq;
          vp_s[(jb + g) * MP + m] = acc[q][0];
          vp_s[(jb + g) * MP + m + 1] = acc[q][1];
          vp_s[(jb + g + 8) * MP + m] = acc[q][2];
          vp_s[(jb + g + 8) * MP + m + 1] = acc[q][3];
        }
      }
    }
    cluster.sync();                                   // #2: V partials in
    // this block finishes V rows [rank rows_mine, (rank + 1) rows_mine)
    if (tid < items) {
      const int jl = rank * rows_mine + tid / MP, m = tid % MP;
      float val = 0.f;
      for (int r = 0; r < CL; ++r) val += cluster.map_shared_rank(vp_s, r)[jl * MP + m];
      const int j = j0 + jl;
      v_out[(size_t)j * MP + m] = val;
      nacc = fmaf(val, val, nacc);
      cacc = fmaf(y[j], val, cacc);
    }
  }
  cluster.sync();             // remote reads of vp_s are over; reuse it
  // block partial norms / coeffs: item v holds column v % MP, summed over
  // v / MP in order
  if (tid < items) {
    vp_s[tid] = nacc;
    vp_s[items + tid] = cacc;
  }
  __syncthreads();
  if (tid < MP) {
    float ns = 0.f, co = 0.f;
    for (int r = 0; r < rows_mine; ++r) {
      ns += vp_s[r * MP + tid];
      co += vp_s[items + r * MP + tid];
    }
    part[(size_t)blockIdx.x * 2 * MP + tid] = ns;
    part[(size_t)blockIdx.x * 2 * MP + MP + tid] = co;
  }
}

template <typename K>
int cluster_count(K kernel, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(C_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
  return static_cast<int>(e);
}

cudaLaunchConfig_t cluster_cfg(int clusters, size_t smem, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * clusters, 1, 1);
  cfg.blockDim = dim3(C_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// K7. P % 128 == 0, S % 128 == 0 (the wrapper checks).
int glt_kb_strip(const void* fa, const void* ft, const void* cols, void* out, int P, int S,
                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(kb_emit_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)E_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S / E_TN, P / E_TM);
  kb_emit_kernel<<<grid, THREADS, E_SMEM, s>>>(
      static_cast<const bf16*>(fa), static_cast<const bf16*>(ft),
      static_cast<const bf16*>(cols), static_cast<bf16*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

// how many 8-block clusters of K8 (which=0) / K9 (which=1) fit the card at
// once; a negative value is a cudaError
int glt_recompute_clusters(int which, int P, int MP) {
  int n = 0, rc;
  if (which == 0)
    rc = cluster_count(ext2_matvec_kernel, ext2_smem(P), &n);
  else
    rc = cluster_count(finish_colstats_kernel, finish_smem(P, MP), &n);
  return rc != 0 ? -rc : n;
}

// K8. P % 128 == 0, N % 128 == 0; u_part holds (clusters, P) floats.
int glt_ext2_matvec(const void* fa, const void* ft, const void* t2, const void* bm,
                    void* s_out, void* u_part, void* u, int P, int N, int clusters,
                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = ext2_smem(P);
  cudaError_t e = cudaFuncSetAttribute(ext2_matvec_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_cfg(clusters, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, ext2_matvec_kernel, static_cast<const bf16*>(fa),
                         static_cast<const bf16*>(ft), static_cast<const bf16*>(t2),
                         static_cast<const float*>(bm), static_cast<float*>(s_out),
                         static_cast<float*>(u_part), P, N);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(u_part), static_cast<float*>(u), clusters,
                       (size_t)P, s);
}

// K9. P % 128 == 0, N % 64 == 0, MP in {16, 32, 48, 64}; part holds
// (8 clusters, 2, MP) floats, norms_coeffs (2, MP).
int glt_finish_colstats(const void* fa, const void* ft, const void* t, const void* s_pre,
                        const void* bm, const void* gr, const void* y, const void* na,
                        const void* nb, void* v_out, void* s_out, void* part,
                        void* norms_coeffs, int P, int N, int MP, int clusters,
                        void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = finish_smem(P, MP);
  cudaError_t e = cudaFuncSetAttribute(finish_colstats_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_cfg(clusters, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, finish_colstats_kernel, static_cast<const bf16*>(fa),
                         static_cast<const bf16*>(ft), static_cast<const bf16*>(t),
                         static_cast<const float*>(s_pre), static_cast<const float*>(bm),
                         static_cast<const float*>(gr), static_cast<const float*>(y),
                         static_cast<const float*>(na), static_cast<const float*>(nb),
                         static_cast<float*>(v_out), static_cast<float*>(s_out),
                         static_cast<float*>(part), P, N, MP);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(norms_coeffs),
                       CL * clusters, (size_t)2 * MP, s);
}

}  // extern "C"
