// K2-K4 — the fused strip sweeps of the strip_cache factor, on a bf16 or
// an f32 (P, N) strip whose padding rows and columns are exactly zero.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K2  strip_ext2_pallas            (_strip_ext2_kernel)
//         kbt_j = K_j^T [t_r, t_c];  s_j = bm_j / sqrt(max(kbt_r kbt_c, 1e-30))
//         u    += K_j s_j
//   K3  strip_sandwich_spost_pallas  (_strip_sandwich_spost_kernel)
//         ks_j = K_j^T t;  s_post_j = sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j
//         u   += K_j bf16((K_j^T ta) * s_post_j^2)
//   K4  strip_sandwich_pallas        (_strip_sandwich_kernel)
//         u   += K_j bf16((K_j^T ta) * s2_j)
// with the Pallas rounding points (_strip_prec): on a bf16 strip t2, t and
// ta arrive as bf16, the products accumulate in f32, ws rounds to bf16
// before the second product; on an f32 strip ("highest") every operand and
// ws stay f32 and every product is IEEE f32 (no TF32).
//
// What bounds them on an H100: the strip is 2.75 GB at the main-path shape
// (P 5248, N 262144), 0.82 ms a read at 3.35 TB/s. K2 does 3 flops a
// strip element, so it is a pure stream: one read is its bound, and its
// kbt (all of P) must be known before any of its u terms. K3/K4 do two
// (P x N) x (N x 256) products, 0.70 TFLOP each: 1.42 ms of bf16 tensor-core work at the
// 989 TFLOP/s dense peak, the bound; a strip read per product is 256
// flops a byte, just under the card's ~295, so each product is close to
// balanced between the tensor cores and memory.
//
// Design.
//   * K2 reads the strip once. A cluster of 8 blocks (16 past P = 6400)
//     shares a 64-column slab: each block stages its P / 8 rows of the slab
//     (128-byte rows, 128-byte swizzle) by one 3-D TMA box into a ring of
//     2-4 slabs, sums kbt over its rows, pushes its 2 x 64 partials into
//     every block of the cluster (st.async, completing on the receiver's
//     mbarrier), adds the cluster's partials in rank order (every block
//     forms the same s), then forms its rows' u terms from the same staged
//     rows. Per-cluster u partials meet in the fixed-order reduction. At
//     config 2's shapes it runs at 0.94 ms, 1.14x its bound (ext2_kernel,
//     512 threads, 80 registers). Measured beside it on an H100 80GB HBM3
//     (700 W) by scripts/strip_designs.py: the partials exchanged through a
//     cluster barrier and DSMEM reads instead of pushed, 1.18 ms; the rows
//     staged in 8-row TMA boxes, 1.34-1.37 ms; 256 threads a block, 0.95
//     ms; the three together (this kernel's first design) 1.62 ms; no
//     sweeps at all (loads and exchange alone, timing only) 1.04 ms;
//     clusters of 16 at P = 5248 (7 fit the card, 112 SMs) 1.45-1.47 ms;
//     one slab in flight 1.28 ms. At P = 8192 (clusters of 16, 3 slabs in
//     flight) 1.67 ms against its 1.28 ms bound; 8-block clusters with one
//     slab in flight there 1.75 ms. The PR 1 design (each block sweeping
//     its 128-column tiles twice, the second read from device memory) took
//     3.90 ms.
//   * K3/K4 run as two launches of one warp-specialized wgmma kernel
//     (sandwich_kernel): phase 1 W = K^T ta (output rows = strip columns,
//     depth = P) with the epilogue ws = bf16(W s2), K3's ks = K^T t beside
//     it; phase 2 U = K ws (output rows = strip rows, depth = N, split over
//     N into S slices that each write a (P, kp) partial). A block owns a
//     128 x 256 output tile: one lane of a producer warpgroup keeps a
//     4-stage ring of 64-deep operand tiles in flight by TMA (128-byte
//     swizzle, mbarriers) and gives its registers up (setmaxnreg); two
//     consumer warpgroups each run m64n128k16 wgmma from shared memory on
//     64 rows of the tile, one 128-column half at a time, K3's ks as an
//     m64n8k16 wgmma on the same A tile. The strip tile is read as it lies
//     in memory: phase 1's A (K^T) is the MN-major (transposed) operand,
//     phase 2's the K-major one; ta and ws are MN-major B operands.
//   * No lean: the H100's f32 tensor-core accumulation rounds toward zero,
//     so no wgmma chain runs longer than one stage (4 k16 steps from a zero
//     accumulator); each stage's half is then added to the running f32 sum
//     with an f32 add. The running sums take 128 registers a thread, the
//     stage accumulator 64 (232 a consumer thread after setmaxnreg).
//   * Each phase runs at ~1.2 ms, 60% of the tensor-core peak, with 8.25 GB
//     moving from L2 to the SMs (the strip once, ta or ws once a 128-row
//     tile). Two variants were slower and are not kept. At config 2's
//     shapes on an H100 80GB HBM3 (700 W), where this design ran K3 in
//     2.607 ms and K4 in 2.479 ms, B shared between the two blocks of a
//     2-block cluster by TMA multicast took 4.179 / 4.042 ms (both phases
//     ~2.05 ms), and a 128 x 128 tile with two stage accumulators in
//     flight took 3.131 / 2.847 ms (phase 1 1.73 ms, phase 2 1.31 ms).
//   * Two strip reads a call (one a phase), where the Pallas kernel reads
//     each tile once: W needs all of P before its s2 scale and bf16 round,
//     and U all of N, so one read would need a cross-block exchange of W
//     partials before the rounding or a grid barrier per L2-sized band.
//   * Every cross-block sum (K2's kbt and u, phase 2's U) meets in a fixed
//     order (K2's kbt in rank order, the per-block or per-cluster partials
//     in a reduction pass) — no float atomics, so a run is bit-for-bit
//     repeatable.
//
// On an f32 strip (5.50 GB at config 2's shapes, 1.64 ms a read):
//   * K2 is the same kernel (ext2_kernel<float>): 32 f32 columns fill the
//     128-byte swizzled slab row that 64 bf16 fill, so the plans, the TMA
//     boxes and the exchange carry over (two 84 KB slabs in flight at P
//     5248). A strip read is twice the slabs, so each row's u sums spans of
//     X2_USPAN_F32 slabs from zero before its running sum: a running f32
//     sum of positive terms drops the tails of those far below it and
//     leans low. 2.21 ms at config 2's shapes (bound 1.64) on an H100 80GB
//     HBM3 (700 W), 0.95 ms for the bf16 strip from the same template.
//   * K3/K4 do 4 P N kp = 1.41e12 flop a launch, every product f32-exact
//     ("highest", never plain TF32): 21.0 ms at the 67 TFLOP/s f32 FFMA
//     peak. So each f32 operand runs on the tensor cores as three bf16
//     parts (split3_grid: b0 = x on the grid 2^(E-8), b1 = bf16(x - b0),
//     b2 = bf16(x - b0 - b1)), and six of the nine part products are kept:
//     a0 b0, a0 b1, a1 b0, a1 b1, a0 b2, a2 b0 (the three dropped are
//     below 2^-25 of the stage's largest product). Six bf16 passes are
//     8.46e12 flop, 8.6 ms at 989 TFLOP/s, against 3.3 ms for the two strip
//     reads: the bound.
//   * No lean: the tensor core's f32 accumulation truncates, so a0 b0 must
//     sum exactly. E is a stage's (32 depths): the largest |x| of the row
//     of A, or of the column of B, in the stage is < 2^E. Then a0 b0 are
//     multiples of 2^(Ea + Eb - 16) of magnitude at most 2^(Ea + Eb), and
//     their stage sum needs 22 bits: exact. The corrections (2^-9 and less
//     of it) sum from zero in a chain of their own, where the truncation is
//     relative to their size: each stage and 128-column half runs the
//     corrections' chain, then a0 b0's, each from zero and added to the
//     half's running f32 sum (128 running registers a consumer thread, 64
//     for the chain). bf16 keeps the f32 exponent and b1, b2 keep 16 more
//     bits of every remainder, so ta's and ws's columns, which span many
//     octaves, need no scales beyond their stage's E.
//   * sandwich_split_kernel, two launches as the bf16 pair (phase 1 W =
//     K^T ta with the ws epilogue, phase 2 U = K ws split over N into S
//     slices of fixed-order partials), a 128 x 256 tile and one 212 KB
//     block an SM. The strip is split inside the kernel, never copied, once
//     a tile: a converter warpgroup (its thread 0 issues every TMA load)
//     takes each 32-deep f32 strip tile from a ring of 4 (16 KB each),
//     finds each output row's E by warp shuffles and writes the three parts
//     into a ring of 2 stages (72 KB each) in the layout wgmma reads (phase
//     1's K^T MN-major with the 128-byte swizzle, as stored; phase 2's K
//     K-major with the 64-byte swizzle). B's three parts arrive there by
//     TMA, split by split_parts_kernel (each 32 rows' E) from ta and from
//     the f32 ws that phase 1 writes (0.27 GB written and read, 0.40 GB of
//     parts written and read). Two consumer warpgroups each run m64n128k16
//     wgmma on 64 output rows. K3's ks = K^T t (2.75e9 flop) is an f32 FFMA
//     sum in the converter on the f32 tile it splits: spans of SS_KSPAN
//     stages from zero added to a running sum, a column's 4 lanes added in
//     a fixed tree.
//   * Cross-block sums meet in the fixed-order reduction as on the bf16
//     strip: a launch repeats bit for bit.
//   * Designs measured at config 2's f32 shapes on an H100 80GB HBM3 (700
//     W), scripts/f32_sandwich_designs.py, K3 / K4 ms (cuBLAS's f32
//     products of the same function 29.5 / 27.8 in the same call): this
//     one 14.5-14.7 / 14.3-14.6, u's share below the f64 sums 0.495 / 0.503;
//     a0 b0 on top of the corrections in one chain a half, 14.0 / 13.8-14.1
//     but leaning, 0.70 / 0.71 below f64 (the truncation of the sum of the
//     corrections and a0 b0); timing only, no split 11.1-13.2, no wgmma
//     9.1-10.0; two f32 tiles in flight 14.3-14.6; the first design, an
//     FFMA tile (sandwich_f32_kernel: 128 x 128 outputs a 256-thread
//     block, 16-deep cp.async stages, spans of 256 depths from zero, two
//     blocks an SM), 35.3-35.6 / 35.1. In other calls: b0 = bf16(x) on no
//     grid, every product of a stage in one chain (the corrections first),
//     11.8 / 12.5, leaning 0.72 below f64 (0.81 on a 768-row strip); a 128 x
//     128 tile with a0 b0 and the corrections in two accumulators (192
//     registers; each strip tile split twice, for two blocks), 18.7-20.1 /
//     18.2-19.5 with a converter warpgroup, 16.6-17.4 / 16.6-16.8 with each
//     consumer warpgroup splitting its rows of the next stage beside its
//     wgmma (no wgmma: 8.5-8.9, the split alone bounding it).
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches (or the
// first error).

#include <cooperative_groups.h>

#include <algorithm>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// K2: strip_ext2, one strip read in clusters
// ---------------------------------------------------------------------------

constexpr int X2_THREADS = 512;
constexpr int X2_WARPS = X2_THREADS / 32;
constexpr int X2_ROW = 128;               // bytes of a slab row: one 128-byte swizzle row
constexpr int X2_RSTEP = X2_THREADS / 8;  // rows a pass: 8 lanes a row, 16 B each
constexpr int X2_MAXR = 16;               // rows a thread: a block holds at most 1024 rows
constexpr int X2_SMEM_CAP = 232448;       // a block's shared memory on an H100
constexpr int X2_USPAN_F32 = 16;          // f32 strip: slabs a span of u's sum

// columns a slab: 64 bf16 or 32 f32
template <typename T>
__host__ __device__ constexpr int x2_w() {
  return X2_ROW / (int)sizeof(T);
}

// shared bytes of a block of a `cl`-block cluster with `rows` rows,
// `stages` slabs of `w` columns in flight: 1024 B of alignment slack, the
// slabs, tr and tc of its rows, the warps' kbt partials, the block's
// partial, the partials received from the cluster (two slabs), s, a barrier
// a stage and two for the received partials
size_t x2_smem(int rows, int stages, int cl, int w) {
  return 1024 + (size_t)stages * rows * X2_ROW +
         sizeof(float) * (2 * (size_t)rows + X2_WARPS * 2 * w + 2 * w + 2 * (size_t)cl * 2 * w + w) +
         8 * ((size_t)stages + 2);
}

template <typename T>
struct X2Args {
  const T* t2;      // (2, P) t_r, t_c in the strip's type (bf16-rounded or f32)
  const float* bm;  // (N)
  float* s_out;     // (N)
  float* u_part;    // (clusters, P)
  int P, N, rows, stages;
};

__device__ __forceinline__ float f32_of(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32_of(float x) { return x; }

// the elements of a 16-byte chunk of the strip as f32: 8 bf16 or 4 f32
__device__ __forceinline__ void unpack_chunk(const uint4 v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    x[2 * q] = __uint_as_float(w[q] << 16);
    x[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack_chunk(const uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

// slab q of cluster cid of ncl: the clusters walk the slabs in turn, so at
// any time they read neighbouring column ranges of the same rows
__device__ __forceinline__ int x2_slab(int cid, int ncl, int q) { return cid + q * ncl; }

// the block's rows of a slab, one TMA box (columns x 8 rows x rows / 8
// groups of a 3-D view of the strip), into a ring stage
__device__ __forceinline__ void x2_load(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                        uint32_t bytes, int col0, int row0) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(0), "r"(row0 / 8), "r"(bar)
      : "memory");
}

// the shared::cluster address of `addr` in the block of rank `rank`
__device__ __forceinline__ uint32_t x2_mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory, completing on its barrier
__device__ __forceinline__ void x2_send(uint32_t raddr, float4 v, uint32_t rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(raddr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
      : "memory");
}

// wait for a phase of a barrier that other blocks of the cluster complete
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A cluster of C blocks walks slabs of W columns, 128 bytes a row (W = 64
// on a bf16 strip, 32 on an f32 one; cluster c: slabs c, c + clusters,
// ...); block `rank` owns the strip rows [rank R, rank R + R). Its slab rows
// arrive by one TMA box (128-byte swizzle: the 16-byte chunk ch of row r
// lies at ch ^ (r & 7)) into a ring of `stages` slabs. Thread (warp, lane)
// reads chunk lane & 7 (E = 16 / sizeof(T) columns) of rows warp * 4 +
// lane / 8 + 64 i, in both sweeps. Sweep 1 sums kbt of the chunk's E
// columns over those rows; the partials meet in a fixed tree (the 4 row
// lanes of a warp, the warps in order), and each block pushes its partial
// into every block of the cluster (st.async, completing on the receiver's
// barrier), where the C partials are added in rank order: every block forms
// the same s, and no cluster barrier is waited on. Sweep 2 adds each row's
// E-column part of K s, from zero a slab, to the row's running u in a
// register (on an f32 strip, whose read is twice the slabs, through a span
// of X2_USPAN_F32 slabs summed from zero first); the 8 chunk lanes meet at
// the end.
template <typename T>
__global__ __launch_bounds__(X2_THREADS, 1) void ext2_kernel(
    const __grid_constant__ CUtensorMap map, const X2Args<T> a) {
  constexpr int W = x2_w<T>(), E = 16 / (int)sizeof(T);
  constexpr int USPAN = sizeof(T) == 4 ? X2_USPAN_F32 : 1;
  extern __shared__ unsigned char x2_raw[];
  unsigned char* smem = x2_raw + ((1024 - (smem_u32(x2_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int R = a.rows, S = a.stages, row0 = rank * R;
  const uint32_t slab_bytes = (uint32_t)R * X2_ROW;
  float* tr_s = reinterpret_cast<float*>(smem + (size_t)S * slab_bytes);
  float* tc_s = tr_s + R;
  float* red = tc_s + R;                        // [warp][r | c][W]
  float* part = red + X2_WARPS * 2 * W;         // [r | c][W]: this block's kbt partial
  float* recv = part + 2 * W;                   // [slab & 1][rank][r | c][W]
  float* s_s = recv + 2 * C * 2 * W;            // [W]
  const uint32_t ring = smem_u32(smem), bar0 = smem_u32(s_s + W);
  const uint32_t rbar0 = bar0 + 8 * S;          // the received partials' barriers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = lane & 7;                      // this thread's chunk of a row
  const int rfirst = warp * 4 + lane / 8;       // its rows: rfirst + X2_RSTEP i
  for (int i = tid; i < R; i += X2_THREADS) {
    tr_s[i] = f32_of(a.t2[row0 + i]);
    tc_s[i] = f32_of(a.t2[a.P + row0 + i]);
  }
  if (tid == 0) {
    for (int st = 0; st < S + 2; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();   // every block's barriers are set before any partial is pushed

  const int nslabs = (a.N + W - 1) / W;
  const int mine = (nslabs - cid + ncl - 1) / ncl;   // the same in every rank
  if (tid == 0)
    for (int q = 0; q < min(S, mine); ++q)
      x2_load(&map, ring + q * slab_bytes, bar0 + 8 * q, slab_bytes, x2_slab(cid, ncl, q) * W,
              row0);

  float u[X2_MAXR], us[X2_MAXR];
#pragma unroll
  for (int i = 0; i < X2_MAXR; ++i) u[i] = us[i] = 0.f;

  for (int q = 0; q < mine; ++q) {
    const int st = q % S, j0 = x2_slab(cid, ncl, q) * W;
    const uint32_t rbar = rbar0 + 8 * (q & 1);
    float* rq = recv + (q & 1) * C * 2 * W;
    // arm this slab's receive barrier (its previous phase, slab q - 2, is
    // done); partials that land first take the count below zero meanwhile
    if (tid == 0) mbar_expect_tx(rbar, (uint32_t)(C * 2 * W * 4));
    // the slab's b_mask, loaded now so its latency is not on the path to s
    const float bmv = (tid < W && j0 + tid < a.N) ? a.bm[j0 + tid] : 0.f;
    mbar_wait(bar0 + 8 * st, (q / S) & 1);
    const unsigned char* slab = smem + (size_t)st * slab_bytes;
    // sweep 1: kbt of the chunk's columns over this thread's rows (a row
    // group of a warp is all in or all out of range: R % 8 == 0)
    float kr[E], kc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kr[e] = kc[e] = 0.f;
#pragma unroll 4
    for (int r = rfirst; r < R; r += X2_RSTEP) {
      float x[E];
      unpack_chunk(*reinterpret_cast<const uint4*>(slab + r * X2_ROW + ((ch ^ (r & 7)) << 4)), x);
      const float tr = tr_s[r], tc = tc_s[r];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[e] = fmaf(x[e], tr, kr[e]);
        kc[e] = fmaf(x[e], tc, kc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        kr[e] += __shfl_xor_sync(0xffffffffu, kr[e], off);
        kc[e] += __shfl_xor_sync(0xffffffffu, kc[e], off);
      }
    }
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        red[(warp * 2 + 0) * W + ch * E + e] = kr[e];
        red[(warp * 2 + 1) * W + ch * E + e] = kc[e];
      }
    }
    __syncthreads();
    if (tid < 2 * W) {
      float acc = 0.f;
      for (int w = 0; w < X2_WARPS; ++w) acc += red[w * 2 * W + tid];   // warp order
      part[tid] = acc;
    }
    __syncthreads();
    // push the partial (W / 2 float4) into slot `rank` of every block's
    // receive buffer. A block writes slab q + 2's slot after it has every
    // partial of slab q + 1, which the receiver sent after it read slab q's
    // slot
    if (tid < C * (W / 2)) {
      const int dst = tid / (W / 2), f4 = tid % (W / 2);
      x2_send(x2_mapa(smem_u32(rq + rank * 2 * W + 4 * f4), dst),
              reinterpret_cast<const float4*>(part)[f4], x2_mapa(rbar, dst));
    }
    if (tid < W) {
      mbar_wait_cluster(rbar, (q >> 1) & 1);
      float kbr = 0.f, kbc = 0.f;
      for (int rk = 0; rk < C; ++rk) {   // rank order: every block forms the same s
        kbr += rq[rk * 2 * W + tid];
        kbc += rq[rk * 2 * W + W + tid];
      }
      const int col = j0 + tid;
      float s = 0.f;
      if (col < a.N) {
        s = bmv / sqrtf(fmaxf(kbr * kbc, EPS));
        if (rank == 0) a.s_out[col] = s;
      }
      s_s[tid] = s;
    }
    __syncthreads();
    // sweep 2: each row's E-column part of K s, from zero, into its u
    float sv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sv[e] = s_s[ch * E + e];
#pragma unroll
    for (int i = 0; i < X2_MAXR; ++i) {
      const int r = rfirst + X2_RSTEP * i;
      if (r >= R) break;
      float x[E];
      unpack_chunk(*reinterpret_cast<const uint4*>(slab + r * X2_ROW + ((ch ^ (r & 7)) << 4)), x);
      float t = x[0] * sv[0];
#pragma unroll
      for (int e = 1; e < E; ++e) t = fmaf(x[e], sv[e], t);
      if (USPAN == 1)
        u[i] += t;
      else
        us[i] += t;
    }
    if (USPAN > 1 && ((q + 1) % USPAN == 0 || q + 1 == mine)) {
#pragma unroll
      for (int i = 0; i < X2_MAXR; ++i) {
        u[i] += us[i];
        us[i] = 0.f;
      }
    }
    __syncthreads();   // stage st, part and s_s are free
    if (tid == 0 && q + S < mine)
      x2_load(&map, ring + st * slab_bytes, bar0 + 8 * st, slab_bytes,
              x2_slab(cid, ncl, q + S) * W, row0);
  }
  // each row's 8 chunk lanes in a fixed tree, then the cluster's u partial
#pragma unroll
  for (int i = 0; i < X2_MAXR; ++i) {
    const int r = rfirst + X2_RSTEP * i;
    if (r >= R) break;                 // warp-uniform: R % 8 == 0
    float v = u[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (ch == 0) a.u_part[(size_t)cid * a.P + row0 + r] = v;
  }
  cluster.sync();   // no block leaves while partials are pushed to it
}

// the strip as a 3-D view (N columns, 8 rows, P / 8 row groups; rows ld
// elements apart) read in (W, 8, rows / 8) boxes with the 128-byte swizzle:
// one box is a block's rows of a slab, row-major
template <typename T>
bool x2_map(CUtensorMap* m, const void* base, int N, int P, int ld, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)N, 8, (cuuint64_t)P / 8};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * sizeof(T), (cuuint64_t)ld * sizeof(T) * 8};
  const cuuint32_t box[3] = {(cuuint32_t)x2_w<T>(), 8, (cuuint32_t)rows / 8}, unit[3] = {1, 1, 1};
  return fn(m, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// K3/K4: the strip sandwich on wgmma
// ---------------------------------------------------------------------------

constexpr int SW_CONSUMERS = 256;              // two consumer warpgroups
constexpr int SW_THREADS = SW_CONSUMERS + 128; // + the producer warpgroup (one lane issues)
constexpr int SW_PRODUCER_REGS = 40;           // setmaxnreg: the producer gives registers
constexpr int SW_CONSUMER_REGS = 232;          // to the consumers (2 x 128 x 232 + 128 x 40)
constexpr int SW_BM = 128;                     // output rows a block
constexpr int SW_BN = 256;                     // sketch columns a block
constexpr int SW_BK = 64;                      // depth a stage: one 128-byte swizzle row
constexpr int SW_STAGES = 4;
constexpr int SW_BOX = SW_BK * 64 * 2;         // one TMA box, 64 x 64 bf16 (8 KB)
constexpr int SW_A_BYTES = 2 * SW_BOX;         // 128 output rows x 64 deep
constexpr int SW_B_BYTES = 4 * SW_BOX;         // 64 deep x 256 sketch columns
constexpr int SW_T_BYTES = 1024;               // K3's [bf16(t), 0 x 7] n8 B operand
constexpr int SW_STAGE_BYTES = SW_A_BYTES + SW_B_BYTES + SW_T_BYTES;
// 1024 B of alignment slack, the ring, 2 barriers a stage, ks, s2
constexpr size_t SW_SMEM = 1024 + (size_t)SW_STAGES * SW_STAGE_BYTES + 16 * SW_STAGES +
                           4 * 2 * SW_BM;

struct SwArgs {
  const bf16* t;       // (P) bf16(t)             phase 1, K3
  const float* s_pre;  // (N)                     phase 1, K3
  const float* bm;     // (N)                     phase 1, K3
  const float* s2_in;  // (N)                     phase 1, K4
  float* s_post;       // (N) out                 phase 1, K3
  bf16* ws;            // (N, kp) out             phase 1
  float* part;         // (splits, P, kp) out     phase 2
  int P, N, kp, chunk;
};

// shared-memory matrix descriptor, 128-byte swizzle: the operand starts at
// `addr` (its 1024-byte swizzle atoms aligned); lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads of the accumulators across a wgmma
// fence or wait
__device__ __forceinline__ void fence_regs(float d[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16) B (16 x 128), bf16 in, f32 accumulate; scale_d 0
// starts from zero. TA: A MN-major (1) or K-major (0); B is MN-major.
template <int TA>
__device__ __forceinline__ void wgmma_n128(float d[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// d (+)= A (64 x 16) B (16 x 8), B K-major (8 rows of 16 deep)
template <int TA>
__device__ __forceinline__ void wgmma_n8(float d[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA));
}

// PHASE 1: W = K^T ta, output rows = strip columns [j0, j0 + 128), depth P;
//          epilogue ws = bf16(W s2) (K3: s2 = s_post^2 from ks = K^T t).
// PHASE 2: part[z] = K ws, output rows = strip rows [i0, i0 + 128), depth
//          = the strip columns of slice z.
// a_map: the strip, (N inner, P outer); b_map: ta (kp, P) or ws (kp, N);
// both 64 x 64 boxes with 128-byte swizzle.
template <int PHASE, bool SPOST>
__global__ __launch_bounds__(SW_THREADS, 1) void sandwich_kernel(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    const SwArgs a) {
  extern __shared__ unsigned char sw_raw[];
  unsigned char* smem = sw_raw + ((1024 - (smem_u32(sw_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + SW_STAGES * SW_STAGE_BYTES);
  float* ks_s = reinterpret_cast<float*>(bars + 2 * SW_STAGES);   // [SW_BM]
  float* s2_s = ks_s + SW_BM;                                      // [SW_BM]
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * SW_STAGES;

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * SW_BM;   // first output row
  const int n0 = blockIdx.y * SW_BN;   // first sketch column
  // depth range of this block: all of P (phase 1), the slice (phase 2)
  const int k_beg = PHASE == 1 ? 0 : blockIdx.z * a.chunk;
  const int k_end = PHASE == 1 ? a.P : min(a.N, k_beg + a.chunk);
  const int nk = k_end > k_beg ? (k_end - k_beg + SW_BK - 1) / SW_BK : 0;

  if (SPOST) {   // rows 1-7 of each stage's n8 B operand stay zero
    for (int i = tid; i < SW_STAGES * (SW_T_BYTES - 128) / 16; i += SW_THREADS) {
      const int st = i / ((SW_T_BYTES - 128) / 16), q = i % ((SW_T_BYTES - 128) / 16);
      *reinterpret_cast<uint4*>(smem + st * SW_STAGE_BYTES + SW_A_BYTES + SW_B_BYTES + 128 +
                                16 * q) = make_uint4(0, 0, 0, 0);
    }
    fence_async_smem();   // seen by wgmma
  }
  if (tid == 0) {
    for (int s = 0; s < SW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, SW_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= SW_CONSUMERS / 32) {
    // producer: one lane keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SW_PRODUCER_REGS));
    if (tid == SW_CONSUMERS) {
      const uint32_t tx = SW_A_BYTES + SW_B_BYTES + (SPOST ? SW_BK * 2 : 0);
      for (int k = 0; k < nk; ++k) {
        const int st = k % SW_STAGES;
        const uint32_t par = ((k / SW_STAGES) & 1) ^ 1;
        mbar_wait(empty0 + 8 * st, par);
        const uint32_t full = full0 + 8 * st, base = ring + st * SW_STAGE_BYTES;
        const int kd = k_beg + k * SW_BK;
        mbar_expect_tx(full, tx);
        // A: 128 output rows x 64 deep, two boxes
        for (int h = 0; h < 2; ++h) {
          if (PHASE == 1)
            tma_box(base + h * SW_BOX, &a_map, m0 + 64 * h, kd, full);   // K^T: strip cols
          else
            tma_box(base + h * SW_BOX, &a_map, kd, m0 + 64 * h, full);   // K: strip rows
        }
        // B: 64 deep x 256 sketch columns, four boxes
        for (int c = 0; c < 4; ++c)
          tma_box(base + SW_A_BYTES + c * SW_BOX, &b_map, n0 + 64 * c, kd, full);
        if (SPOST) bulk_copy(base + SW_A_BYTES + SW_B_BYTES, a.t + kd, SW_BK * 2, full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [m0 + 64 wg, m0 + 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SW_CONSUMER_REGS));
  const int wg = tid / 128, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int rw = 16 * (warp & 3) + g;   // this thread's rows rw, rw + 8 of the 64
  float run[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) run[h][i] = 0.f;
  float acc[64];
  // K3's ks = K^T bf16(t) for the warpgroup's 64 strip columns: an n8 wgmma
  // on the same A with B = [bf16(t), 0, ..., 0] (column 0 of the result,
  // held by the tq == 0 lanes), from zero each stage as the main product
  float ks_acc[4], ks_run[2] = {0.f, 0.f};

  for (int k = 0; k < nk; ++k) {
    const int st = k % SW_STAGES;
    mbar_wait(full0 + 8 * st, (k / SW_STAGES) & 1);
    const uint32_t base = ring + st * SW_STAGE_BYTES;
    const uint32_t a_base = base + wg * SW_BOX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SW_BK / 16; ++kk) {
        // A: phase 1 MN-major (64 rows in one swizzle atom; k16 = 16 rows
        // of 128 B), phase 2 K-major (k16 = 32 B along the row)
        const uint64_t da = PHASE == 1 ? sw128_desc(a_base + kk * 2048, 1024, 1024)
                                       : sw128_desc(a_base + kk * 32, 16, 1024);
        // B: MN-major, 128 columns = two 64-column atoms (8 KB apart)
        const uint64_t db =
            sw128_desc(base + SW_A_BYTES + 2 * h * SW_BOX + kk * 2048, SW_BOX, 1024);
        wgmma_n128<PHASE == 1 ? 1 : 0>(acc, da, db, kk);
        if (SPOST && h == 0)   // B: K-major, one 8-row atom, k16 = 32 B
          wgmma_n8<1>(ks_acc, da, sw128_desc(base + SW_A_BYTES + SW_B_BYTES + kk * 32, 16, 1024),
                      kk);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[h][i] += acc[i];
      if (SPOST && h == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(ks_acc[i])::"memory");
        ks_run[0] += ks_acc[0];
        ks_run[1] += ks_acc[2];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  if (PHASE == 1) {
    // column scales of this tile, then ws = bf16(W s2)
    if (SPOST && tq == 0) {
      ks_s[wg * 64 + rw] = ks_run[0];
      ks_s[wg * 64 + rw + 8] = ks_run[1];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(SW_CONSUMERS) : "memory");
    if (tid < SW_BM) {
      const int j = m0 + tid;
      float s2 = 0.f;
      if (j < a.N) {
        if (SPOST) {
          const float sp = sqrtf(a.s_pre[j] / fmaxf(ks_s[tid], EPS)) * a.bm[j];
          if (blockIdx.y == 0) a.s_post[j] = sp;
          s2 = sp * sp;
        } else {
          s2 = a.s2_in[j];
        }
      }
      s2_s[tid] = s2;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(SW_CONSUMERS) : "memory");
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wg * 64 + rw + 8 * e, j = m0 + r;
      if (j >= a.N) continue;
      const float s2 = s2_s[r];
      bf16* out = a.ws + (size_t)j * a.kp + n0 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<__nv_bfloat162*>(out + 128 * h + 8 * i) =
              __floats2bfloat162_rn(run[h][4 * i + 2 * e] * s2, run[h][4 * i + 2 * e + 1] * s2);
    }
  } else {
    float* out = a.part + (size_t)blockIdx.z * a.P * a.kp;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i_row = m0 + wg * 64 + rw + 8 * e;
      float* o = out + (size_t)i_row * a.kp + n0 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<float2*>(o + 128 * h + 8 * i) =
              make_float2(run[h][4 * i + 2 * e], run[h][4 * i + 2 * e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3/K4 on an f32 strip: the sandwich on wgmma, each operand in three bf16
// parts
// ---------------------------------------------------------------------------

constexpr int SS_CONV = 128;                    // the converter warpgroup
constexpr int SS_CONSUMERS = 256;               // two consumer warpgroups
constexpr int SS_THREADS = SS_CONV + SS_CONSUMERS;
constexpr int SS_CONV_REGS = 56;                // setmaxnreg: 128 x 56 + 256 x 224 =
constexpr int SS_CONSUMER_REGS = 224;           //   64512, the block's 384 x 168 at launch
constexpr int SS_BM = 128;                      // output rows a block
constexpr int SS_BN = 256;                      // sketch columns a block
constexpr int SS_BK = 32;                       // depth a stage
constexpr int SS_FST = 4;                       // f32 strip tiles in flight
constexpr int SS_PST = 2;                       // stages of bf16 parts
constexpr int SS_KSPAN = 8;                     // K3's ks: stages a span from zero
constexpr int SS_F_BYTES = SS_BM * SS_BK * 4;   // a strip tile in f32 (16 KB)
constexpr int SS_APART = SS_BM * SS_BK * 2;     // one part of A (8 KB)
constexpr int SS_BBOX = 64 * SS_BK * 2;         // a TMA box of B: 64 columns x 32 deep
constexpr int SS_BPART = SS_BN / 64 * SS_BBOX;  // one part of B (16 KB)
constexpr int SS_PSTAGE = 3 * SS_APART + 3 * SS_BPART;
// 1024 B of alignment slack, the f32 ring, the parts ring, K3's t of each
// f32 tile, a barrier an f32 tile and three a parts stage, ks, s2
constexpr size_t SS_SMEM = 1024 + (size_t)SS_FST * SS_F_BYTES + (size_t)SS_PST * SS_PSTAGE +
                           4 * SS_BK * SS_FST + 8 * (SS_FST + 3 * SS_PST) + 4 * SS_BM +
                           4 * SS_BM;

struct SsArgs {
  const float* t;      // (P)              phase 1, K3
  const float* s_pre;  // (N)              phase 1, K3
  const float* bm;     // (N)              phase 1, K3
  const float* s2_in;  // (N)              phase 1, K4
  float* s_post;       // (N) out          phase 1, K3
  float* ws;           // (N, kp) out      phase 1 (then split into its parts)
  float* part;         // (splits, P, kp) out      phase 2
  int P, N, kp, chunk;
};

// shared-memory matrix descriptor, 64-byte swizzle, K-major: 8-row groups
// of 64-byte rows `sbo` bytes apart (the 512-byte atoms aligned)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)2 << 62);
}

// a box at element coordinates (c0, c1, c2) of a 3-D tensor map into shared
// memory, completing on the barrier
__device__ __forceinline__ void tma_box3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// depth row j of a phase 1 converter thread whose row group is rs: rows
// {0, 4, 2, 6}[rs] + {0, 1} + 8 {0 .. 3}, so a warp's 16-lane stores (row
// groups 0, 1 or 2, 3) fall in rows 4 apart, whose swizzles differ
__device__ __forceinline__ int ss_row(int rs, int j) {
  return ((rs & 1) << 2) + ((rs >> 1) << 1) + (j & 1) + 8 * (j >> 1);
}

// The converter's part of a stage: the f32 strip tile `f` (as TMA stored
// it, 128-byte swizzle) into the three bf16 parts of A at `ap`
// (split3_grid, each output row's grid from its largest entry of the
// stage), in the layout each phase's wgmma reads.
// PHASE 1 (A = K^T, MN-major): the tile is four 32-column boxes of 32 depth
//   rows; thread (warp b, lane (rs, c4)) = (box, (lane / 8, lane % 8))
//   holds strip columns 32 b + 4 c4 .. + 3 of depth rows ss_row(rs, 0 ..
//   7), so a column's 32 depths lie in 4 lanes of a warp (its largest entry
//   by two shuffles); two passes over the tile (the largest entries and
//   K3's ks = sum t_d K[d][col], then the split) hold no more than a row's
//   4 entries. Each part's 4 bf16 go into the 64-column 128-byte-swizzled
//   atoms (atom b / 2 of 32 rows, 4 KB).
// PHASE 2 (A = K, K-major): the tile is one box, 128 strip rows of 32
//   depths; thread (r0, q) = (tid / 8, tid % 8) splits depths 4 q .. 4 q +
//   3 of rows r0 + 16 i (a row's 32 depths in 8 lanes: its largest entry by
//   three shuffles) into 64-byte rows with the 64-byte swizzle (the 16-byte
//   chunk c of row r at c ^ ((r / 2) & 3)).
// Reads (8 lanes a phase, one 128-byte row) and writes (16 lanes a phase,
// 128 bytes in distinct banks) meet no bank conflict.
template <int PHASE, bool SPOST>
__device__ __forceinline__ void ss_convert(const unsigned char* f, unsigned char* ap,
                                           const float* ts, float (&ks)[4]) {
  const int tid = threadIdx.x;
  if (PHASE == 1) {
    const int b = tid >> 5, rs = (tid >> 3) & 3, c4 = tid & 7;
    f += b * 4096;
    float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SS_BK / 4; ++j) {
      const int d = ss_row(rs, j);
      const float4 x = *reinterpret_cast<const float4*>(f + d * 128 + ((c4 ^ (d & 7)) << 4));
      m[0] = fmaxf(m[0], fabsf(x.x));
      m[1] = fmaxf(m[1], fabsf(x.y));
      m[2] = fmaxf(m[2], fabsf(x.z));
      m[3] = fmaxf(m[3], fabsf(x.w));
      if (SPOST) {
        const float tv = ts[d];
        ks[0] = fmaf(x.x, tv, ks[0]);
        ks[1] = fmaf(x.y, tv, ks[1]);
        ks[2] = fmaf(x.z, tv, ks[2]);
        ks[3] = fmaf(x.w, tv, ks[3]);
      }
    }
    int e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], 8));
      m[c] = fmaxf(m[c], __shfl_xor_sync(0xffffffffu, m[c], 16));
      e[c] = grid_exp(m[c]);
    }
    const int chunk = 4 * (b & 1) + (c4 >> 1);
    ap += (b >> 1) * 4096;
#pragma unroll
    for (int j = 0; j < SS_BK / 4; ++j) {
      const int d = ss_row(rs, j);
      const float4 x = *reinterpret_cast<const float4*>(f + d * 128 + ((c4 ^ (d & 7)) << 4));
      uint32_t lo[3], hi[3];
      split3_grid(x.x, x.y, pow2(8 - e[0]), pow2(e[0] - 8), pow2(8 - e[1]), pow2(e[1] - 8), lo);
      split3_grid(x.z, x.w, pow2(8 - e[2]), pow2(e[2] - 8), pow2(8 - e[3]), pow2(e[3] - 8), hi);
      const int off = d * 128 + ((chunk ^ (d & 7)) << 4) + 8 * (c4 & 1);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(ap + p * SS_APART + off) = make_uint2(lo[p], hi[p]);
    }
  } else {
    const int q4 = tid & 7, r0 = tid >> 3;
#pragma unroll
    for (int i = 0; i < SS_BM / 16; ++i) {
      const int r = r0 + 16 * i;
      const float4 x = *reinterpret_cast<const float4*>(f + r * 128 + ((q4 ^ (r & 7)) << 4));
      float m = fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w)));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      const int e = grid_exp(m);
      const float q = pow2(8 - e), qi = pow2(e - 8);
      uint32_t lo[3], hi[3];
      split3_grid(x.x, x.y, q, qi, q, qi, lo);
      split3_grid(x.z, x.w, q, qi, q, qi, hi);
      const int off = r * 64 + (((q4 >> 1) ^ ((r >> 1) & 3)) << 4) + 8 * (q4 & 1);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(ap + p * SS_APART + off) = make_uint2(lo[p], hi[p]);
    }
  }
}

// stage k's f32 strip tile (and K3's t) into its slot of the f32 ring (base
// `fring`, barriers from `ffull0`): phase 1 four 32 x 32 boxes (strip
// columns m0 + 32 b, depth rows kd), phase 2 one 32 x 128 box (depths kd,
// strip rows m0)
template <int PHASE, bool SPOST>
__device__ __forceinline__ void ss_load_f(const CUtensorMap* map, uint32_t fring,
                                          uint32_t ffull0, float* t_s, const float* t, int m0,
                                          int k_beg, int k) {
  const int st = k % SS_FST, kd = k_beg + k * SS_BK;
  const uint32_t bar = ffull0 + 8 * st, dst = fring + st * SS_F_BYTES;
  mbar_expect_tx(bar, SS_F_BYTES + (SPOST ? SS_BK * 4 : 0));
  if (PHASE == 1) {
    for (int b = 0; b < 4; ++b) tma_box(dst + b * 4096, map, m0 + 32 * b, kd, bar);
  } else {
    tma_box(dst, map, kd, m0, bar);
  }
  if (SPOST) bulk_copy(smem_u32(t_s + st * SS_BK), t + kd, SS_BK * 4, bar);
}

// PHASE 1: W = K^T ta, output rows = strip columns [m0, m0 + 128), depth P;
//          epilogue ws = W s2 in f32 (K3: s2 = s_post^2, s_post from ks =
//          K^T t, which the converter sums on the FP32 pipe).
// PHASE 2: part[z] = K ws, output rows = strip rows [m0, m0 + 128), depth
//          the strip columns of slice z.
// Sketch columns [n0, n0 + 256). f_map: the f32 strip (N inner, P outer)
// in 32 x 32 boxes (phase 1: four make a stage) or 32 x 128 (phase 2:
// one); b_map: the three parts of ta (P rows) or of ws (N rows), (3, rows,
// kp) bf16, in 64 x 32 boxes.
// Warpgroup 0 converts (its thread 0 also issues every load); warpgroups 1
// and 2 each run the wgmma of 64 output rows by the 256 sketch columns, one
// 128-column half at a time: per 32-deep stage and half, from zero, the
// five correction products a1 b0, a0 b1, a1 b1, a2 b0, a0 b2 of both k16
// steps, added to the half's running f32 sum, then a0 b0 of both (exact:
// split3_grid), added too.
template <int PHASE, bool SPOST>
__global__ __launch_bounds__(SS_THREADS, 1) void sandwich_split_kernel(
    const __grid_constant__ CUtensorMap f_map, const __grid_constant__ CUtensorMap b_map,
    const SsArgs a) {
  extern __shared__ unsigned char ss_raw[];
  unsigned char* smem = ss_raw + ((1024 - (smem_u32(ss_raw) & 1023)) & 1023);
  const uint32_t fring = smem_u32(smem);
  const uint32_t pring = fring + SS_FST * SS_F_BYTES;
  unsigned char* pring_p = smem + SS_FST * SS_F_BYTES;
  float* t_s = reinterpret_cast<float*>(pring_p + SS_PST * SS_PSTAGE);   // [SS_FST][SS_BK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(t_s + SS_FST * SS_BK);
  float* ks_s = reinterpret_cast<float*>(bars + SS_FST + 3 * SS_PST);    // [SS_BM]
  float* s2_s = ks_s + SS_BM;                                             // [SS_BM]
  const uint32_t ffull0 = smem_u32(bars), bfull0 = ffull0 + 8 * SS_FST;
  const uint32_t afull0 = bfull0 + 8 * SS_PST, empty0 = afull0 + 8 * SS_PST;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int n0 = blockIdx.x * SS_BN;   // first sketch column
  const int m0 = blockIdx.y * SS_BM;   // first output row
  const int k_beg = PHASE == 1 ? 0 : blockIdx.z * a.chunk;
  const int k_end = PHASE == 1 ? a.P : min(a.N, k_beg + a.chunk);
  const int nk = k_end > k_beg ? (k_end - k_beg + SS_BK - 1) / SS_BK : 0;

  if (tid == 0) {
    for (int s = 0; s < SS_FST; ++s) mbar_init(ffull0 + 8 * s, 1);
    for (int s = 0; s < SS_PST; ++s) {
      mbar_init(bfull0 + 8 * s, 1);
      mbar_init(afull0 + 8 * s, SS_CONV);
      mbar_init(empty0 + 8 * s, SS_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < SS_CONV) {
    // the converter warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SS_CONV_REGS));
    if (tid == 0)
      for (int k = 0; k < min(SS_FST, nk); ++k)
        ss_load_f<PHASE, SPOST>(&f_map, fring, ffull0, t_s, a.t, m0, k_beg, k);
    float ks_span[4] = {0.f, 0.f, 0.f, 0.f}, ks_run[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < nk; ++k) {
      const int fs = k % SS_FST, ps = k % SS_PST;
      if (k >= SS_PST) mbar_wait(empty0 + 8 * ps, ((k / SS_PST) - 1) & 1);
      if (tid == 0) {   // B's three parts of the stage: 3 x 4 boxes
        const uint32_t bar = bfull0 + 8 * ps, pbase = pring + ps * SS_PSTAGE;
        const int kd = k_beg + k * SS_BK;
        mbar_expect_tx(bar, 3 * SS_BPART);
        for (int p = 0; p < 3; ++p)
          for (int c = 0; c < SS_BN / 64; ++c)
            tma_box3(pbase + 3 * SS_APART + p * SS_BPART + c * SS_BBOX, &b_map, n0 + 64 * c, kd,
                     p, bar);
      }
      mbar_wait(ffull0 + 8 * fs, (k / SS_FST) & 1);
      ss_convert<PHASE, SPOST>(smem + fs * SS_F_BYTES, pring_p + ps * SS_PSTAGE,
                               t_s + fs * SS_BK, ks_span);
      if (SPOST && ((k + 1) % SS_KSPAN == 0 || k + 1 == nk)) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ks_run[c] += ks_span[c];
          ks_span[c] = 0.f;
        }
      }
      fence_async_smem();   // the parts seen by wgmma
      mbar_arrive(afull0 + 8 * ps);
      // every converter thread is done with f32 slot fs: refill it
      asm volatile("bar.sync 2, %0;\n" ::"n"(SS_CONV) : "memory");
      if (tid == 0 && k + SS_FST < nk)
        ss_load_f<PHASE, SPOST>(&f_map, fring, ffull0, t_s, a.t, m0, k_beg, k + SS_FST);
    }
    if (PHASE == 1) {
      // the column scales of this tile (K3: a column's 4 lanes' ks, in a
      // fixed tree)
      if (SPOST) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ks_run[c] += __shfl_xor_sync(0xffffffffu, ks_run[c], 8);
          ks_run[c] += __shfl_xor_sync(0xffffffffu, ks_run[c], 16);
          if (lane < 8) ks_s[32 * warp + 4 * lane + c] = ks_run[c];
        }
        asm volatile("bar.sync 2, %0;\n" ::"n"(SS_CONV) : "memory");
      }
      const int j = m0 + tid;
      float s2 = 0.f;
      if (j < a.N) {
        if (SPOST) {
          const float sp = sqrtf(a.s_pre[j] / fmaxf(ks_s[tid], EPS)) * a.bm[j];
          if (blockIdx.x == 0) a.s_post[j] = sp;
          s2 = sp * sp;
        } else {
          s2 = a.s2_in[j];
        }
      }
      s2_s[tid] = s2;
      asm volatile("bar.sync 1, %0;\n" ::"n"(SS_THREADS) : "memory");
    }
    return;
  }

  // consumers: warpgroup wg owns output rows [m0 + 64 wg, m0 + 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SS_CONSUMER_REGS));
  constexpr int TA = PHASE == 1 ? 1 : 0;   // A MN-major (phase 1) or K-major
  const int wg = (tid - SS_CONV) / 128, g = lane >> 2, tq = lane & 3;
  const int rw = 16 * (warp & 3) + g;   // this thread's rows rw, rw + 8 of the 64
  float run[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) run[h][i] = 0.f;
  float acc[64];

  for (int k = 0; k < nk; ++k) {
    const int ps = k % SS_PST;
    const uint32_t par = (k / SS_PST) & 1;
    mbar_wait(bfull0 + 8 * ps, par);
    mbar_wait(afull0 + 8 * ps, par);
    const uint32_t abase = pring + ps * SS_PSTAGE + wg * 4096;
    const uint32_t bbase = pring + ps * SS_PSTAGE + 3 * SS_APART;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // A: phase 1 MN-major (64 columns in one swizzle atom; k16 = 16 rows
      // of 128 B), phase 2 K-major (k16 = 32 B along the 64-byte row).
      // B: MN-major, 128 columns = two 64-column boxes (4 KB apart)
      auto da = [&](int p, int kk) {
        return PHASE == 1 ? sw128_desc(abase + p * SS_APART + kk * 2048, 1024, 1024)
                          : sw64_desc(abase + p * SS_APART + kk * 32, 512);
      };
      auto db = [&](int p, int kk) {
        return sw128_desc(bbase + p * SS_BPART + 2 * h * SS_BBOX + kk * 2048, SS_BBOX, 1024);
      };
      // the corrections, then a0 b0, each chain from zero into the
      // half's running sum
#pragma unroll
      for (int chain = 0; chain < 2; ++chain) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SS_BK / 16; ++kk) {
          if (chain == 0) {
            wgmma_n128<TA>(acc, da(1, kk), db(0, kk), kk);   // from zero at kk 0
            wgmma_n128<TA>(acc, da(0, kk), db(1, kk), 1);
            wgmma_n128<TA>(acc, da(1, kk), db(1, kk), 1);
            wgmma_n128<TA>(acc, da(2, kk), db(0, kk), 1);
            wgmma_n128<TA>(acc, da(0, kk), db(2, kk), 1);
          } else {
            wgmma_n128<TA>(acc, da(0, kk), db(0, kk), kk);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) run[h][i] += acc[i];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * ps);
  }

  if (PHASE == 1) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(SS_THREADS) : "memory");   // s2_s is set
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wg * 64 + rw + 8 * e, j = m0 + r;
      if (j >= a.N) continue;
      const float s2 = s2_s[r];
      float* out = a.ws + (size_t)j * a.kp + n0 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<float2*>(out + 128 * h + 8 * i) =
              make_float2(run[h][4 * i + 2 * e] * s2, run[h][4 * i + 2 * e + 1] * s2);
    }
  } else {
    float* out = a.part + (size_t)blockIdx.z * a.P * a.kp;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i_row = m0 + wg * 64 + rw + 8 * e;
      float* o = out + (size_t)i_row * a.kp + n0 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i)
          *reinterpret_cast<float2*>(o + 128 * h + 8 * i) =
              make_float2(run[h][4 * i + 2 * e], run[h][4 * i + 2 * e + 1]);
    }
  }
}

// out[p][r][c] = part p of x[r][c] (split3_grid), p = 0, 1, 2, for a
// (rows, kp) matrix (kp even): thread (block rb of 32 rows, column pair)
// finds each column's largest |x| over the block's rows (a stage of B: the
// kernel's stages start at multiples of 32), then splits them on its grid
__global__ void split_parts_kernel(const float* __restrict__ x, bf16* __restrict__ out, int rows,
                                   int kp) {
  const int pairs = kp / 2;
  const size_t n = (size_t)rows * kp;
  const size_t nt = (size_t)((rows + SS_BK - 1) / SS_BK) * pairs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < nt;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = 2 * (int)(i % pairs), r0 = SS_BK * (int)(i / pairs);
    const int r1 = min(rows, r0 + SS_BK);
    float m0 = 0.f, m1 = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(x + (size_t)r * kp + c);
      m0 = fmaxf(m0, fabsf(v.x));
      m1 = fmaxf(m1, fabsf(v.y));
    }
    const int e0 = grid_exp(m0), e1 = grid_exp(m1);
    const float q0 = pow2(8 - e0), qi0 = pow2(e0 - 8), q1 = pow2(8 - e1), qi1 = pow2(e1 - 8);
    for (int r = r0; r < r1; ++r) {
      const size_t o = (size_t)r * kp + c;
      const float2 v = *reinterpret_cast<const float2*>(x + o);
      uint32_t q[3];
      split3_grid(v.x, v.y, q0, qi0, q1, qi1, q);
#pragma unroll
      for (int p = 0; p < 3; ++p) *reinterpret_cast<uint32_t*>(out + p * n + o) = q[p];
    }
  }
}

// the (rows, kp) f32 matrix x as its three bf16 parts (3, rows, kp)
int launch_split_parts(const float* x, bf16* out, int rows, int kp, cudaStream_t s) {
  const size_t nt = (size_t)((rows + SS_BK - 1) / SS_BK) * (kp / 2);
  split_parts_kernel<<<(unsigned)std::min<size_t>(8192, (nt + 255) / 256), 256, 0, s>>>(
      x, out, rows, kp);
  return static_cast<int>(cudaGetLastError());
}

// the three bf16 parts of a (rows, kp) matrix, stored (3, rows, kp), in
// (64 x 32 x 1) boxes with the 128-byte swizzle; rows past the edge read as
// zero
bool parts_map(CUtensorMap* m, const void* base, int kp, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)rows, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * 2, (cuuint64_t)kp * 2 * rows};
  const cuuint32_t box[3] = {64, SS_BK, 1}, unit[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int PHASE, bool SPOST>
int launch_sandwich_split(dim3 grid, const CUtensorMap& fm, const CUtensorMap& bmap,
                          const SsArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(sandwich_split_kernel<PHASE, SPOST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SS_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  sandwich_split_kernel<PHASE, SPOST><<<grid, SS_THREADS, SS_SMEM, s>>>(fm, bmap, a);
  return static_cast<int>(cudaGetLastError());
}

// K2's kernel for a cluster of `cl` blocks and `smem` bytes a block
template <typename T>
cudaError_t x2_prepare(int cl, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(ext2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess && cl > 8)
    e = cudaFuncSetAttribute(ext2_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// how many K2 clusters of `cl` blocks, `rows` rows and `stages` slabs a
// block fit the card at once; a negative value is a cudaError
template <typename T>
int x2_clusters(int cl, int rows, int stages) {
  const size_t smem = x2_smem(rows, stages, cl, x2_w<T>());
  cudaError_t e = x2_prepare<T>(cl, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(cl, 1, X2_THREADS, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)ext2_kernel<T>, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// K2 on the plan of ops/cuda_strip.ext2_plan: clusters of cl (8 or 16)
// blocks of P / cl rows (a multiple of 8, at most 1024), `stages` slabs in
// flight within 227 KB of shared memory; strip rows ld >= N apart, 16 bytes
// a multiple, a 16-byte aligned base; 1 <= clusters <= ceil(N / W). u_part
// holds (clusters, P) floats, summed into u in cluster order.
template <typename T>
int x2_launch(const void* strip, const void* t2, const void* bm, void* s_out, void* u_part,
              void* u, int P, int N, int ld, int cl, int stages, int clusters, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rows = (cl == 8 || cl == 16) ? P / cl : 0;
  const size_t smem = x2_smem(rows, stages, cl, x2_w<T>());
  CUtensorMap map;
  if (rows == 0 || rows * cl != P || rows % 8 || rows > X2_RSTEP * X2_MAXR || stages < 1 ||
      smem > X2_SMEM_CAP || clusters < 1 || clusters > (N + x2_w<T>() - 1) / x2_w<T>() ||
      !x2_map<T>(&map, strip, N, P, ld, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = x2_prepare<T>(cl, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const X2Args<T> a = {static_cast<const T*>(t2), static_cast<const float*>(bm),
                       static_cast<float*>(s_out), static_cast<float*>(u_part), P, N, rows, stages};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(cl, clusters, X2_THREADS, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, ext2_kernel<T>, map, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(u_part), static_cast<float*>(u), clusters,
                       (size_t)P, s);
}

template <int PHASE, bool SPOST>
int launch_sandwich(dim3 grid, const CUtensorMap& am, const CUtensorMap& bmap, const SwArgs& a,
                    cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(sandwich_kernel<PHASE, SPOST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SW_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  sandwich_kernel<PHASE, SPOST><<<grid, SW_THREADS, SW_SMEM, s>>>(am, bmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2's shared bytes a block of a `cl`-block cluster with `rows` rows and
// `stages` slabs in flight, bf16 and f32 strips (ops/cuda_strip.ext2_plan
// mirrors them)
size_t glt_ext2_smem_bytes(int rows, int stages, int cl) {
  return x2_smem(rows, stages, cl, x2_w<bf16>());
}
size_t glt_strip_ext2_f32_smem_bytes(int rows, int stages, int cl) {
  return x2_smem(rows, stages, cl, x2_w<float>());
}

// how many K2 clusters fit the card at once (see x2_clusters)
int glt_ext2_strip_clusters(int cl, int rows, int stages) {
  return x2_clusters<bf16>(cl, rows, stages);
}
int glt_strip_ext2_f32_clusters(int cl, int rows, int stages) {
  return x2_clusters<float>(cl, rows, stages);
}

// K2 on a bf16 strip (t2 bf16, ld % 8 == 0, 64-column slabs) and on an f32
// strip (t2 f32, ld % 4 == 0, 32-column slabs); see x2_launch
int glt_strip_ext2(const void* strip, const void* t2, const void* bm, void* s_out,
                   void* u_part, void* u, int P, int N, int ld, int cl, int stages,
                   int clusters, void* stream) {
  return x2_launch<bf16>(strip, t2, bm, s_out, u_part, u, P, N, ld, cl, stages, clusters, stream);
}
int glt_strip_ext2_f32(const void* strip, const void* t2, const void* bm, void* s_out,
                       void* u_part, void* u, int P, int N, int ld, int cl, int stages,
                       int clusters, void* stream) {
  return x2_launch<float>(strip, t2, bm, s_out, u_part, u, P, N, ld, cl, stages, clusters,
                          stream);
}

// K3 (t != null: s_post from s_pre, bm) or K4 (t == null: s2 given).
// P % 128 == 0, strip rows ld >= N apart with ld % 8 == 0, kp % 256 == 0
// and 16-byte aligned operands (the wrapper checks); ta holds (P, kp) bf16, ws (N, kp) bf16, part
// (splits, P, kp) f32, u (P, kp) f32. Phase 2's slices are `splits`
// column ranges of ceil(N / splits) rounded up to 64.
int glt_strip_sandwich(const void* strip, const void* ta, const void* t,
                       const void* s_pre, const void* bm, const void* s2,
                       void* s_post, void* ws, void* part, void* u,
                       int P, int N, int ld, int kp, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  CUtensorMap strip_map, ta_map, ws_map;
  if (!tile_map(&strip_map, strip, false, N, P, ld, 64, 64) ||
      !tile_map(&ta_map, ta, false, kp, P, kp, 64, 64) ||
      !tile_map(&ws_map, ws, false, kp, N, kp, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  SwArgs a = {};
  a.t = static_cast<const bf16*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s2_in = static_cast<const float*>(s2);
  a.s_post = static_cast<float*>(s_post);
  a.ws = static_cast<bf16*>(ws);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  a.kp = kp;
  int chunk = (N + splits - 1) / splits;
  a.chunk = (chunk + SW_BK - 1) / SW_BK * SW_BK;

  const dim3 g1((N + SW_BM - 1) / SW_BM, kp / SW_BN);
  int rc = t != nullptr ? launch_sandwich<1, true>(g1, strip_map, ta_map, a, s)
                        : launch_sandwich<1, false>(g1, strip_map, ta_map, a, s);
  if (rc != 0) return rc;
  rc = launch_sandwich<2, false>(dim3(P / SW_BM, kp / SW_BN, splits), strip_map, ws_map, a, s);
  if (rc != 0) return rc;
  launch_reduce(static_cast<const float*>(part), static_cast<float*>(u), splits,
                (size_t)P * kp, s);
  return static_cast<int>(cudaGetLastError());
}

// K3 / K4 on an f32 strip (t != null: K3), every operand f32: P % 128 ==
// 0, strip rows ld >= N apart with ld % 4 == 0, kp % 128 == 0, 16-byte
// aligned strip, ta, t and the parts; ta (P, kp) f32, ws (N, kp) f32
// scratch, ta_parts (3, P, kp) and ws_parts (3, N, kp) bf16 scratch, part
// (splits, P, kp), u (P, kp). Phase 2's slices are `splits` column ranges
// of ceil(N / splits) rounded up to 32.
int glt_strip_sandwich_f32(const void* strip, const void* ta, const void* t,
                           const void* s_pre, const void* bm, const void* s2,
                           void* s_post, void* ws, void* ta_parts, void* ws_parts, void* part,
                           void* u, int P, int N, int ld, int kp, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(strip) | reinterpret_cast<uintptr_t>(ta) |
                          reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(ws) |
                          reinterpret_cast<uintptr_t>(ta_parts) |
                          reinterpret_cast<uintptr_t>(ws_parts);
  CUtensorMap f1_map, f2_map, ta_map, ws_map;
  if (P <= 0 || P % SS_BM || N <= 0 || ld < N || ld % 4 || kp <= 0 || kp % SS_BN ||
      splits < 1 || splits > 65535 || (N + SS_BM - 1) / SS_BM > 65535 || align % 16 ||
      !tile_map(&f1_map, strip, true, N, P, ld, 32, 32) ||
      !tile_map(&f2_map, strip, true, N, P, ld, 32, SS_BM) ||
      !parts_map(&ta_map, ta_parts, kp, P) || !parts_map(&ws_map, ws_parts, kp, N))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_split_parts(static_cast<const float*>(ta), static_cast<bf16*>(ta_parts), P, kp,
                              s);
  if (rc != 0) return rc;
  SsArgs a = {};
  a.t = static_cast<const float*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s2_in = static_cast<const float*>(s2);
  a.s_post = static_cast<float*>(s_post);
  a.ws = static_cast<float*>(ws);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  a.kp = kp;
  const int chunk = (N + splits - 1) / splits;
  a.chunk = (chunk + SS_BK - 1) / SS_BK * SS_BK;

  const dim3 g1(kp / SS_BN, (N + SS_BM - 1) / SS_BM);
  rc = t != nullptr ? launch_sandwich_split<1, true>(g1, f1_map, ta_map, a, s)
                    : launch_sandwich_split<1, false>(g1, f1_map, ta_map, a, s);
  if (rc != 0) return rc;
  rc = launch_split_parts(a.ws, static_cast<bf16*>(ws_parts), N, kp, s);
  if (rc != 0) return rc;
  rc = launch_sandwich_split<2, false>(dim3(kp / SS_BN, P / SS_BM, splits), f2_map, ws_map, a, s);
  if (rc != 0) return rc;
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(u), splits,
                       (size_t)P * kp, s);
}

}  // extern "C"
