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
//   * K3/K4 are bound by operations: 4 P N kp = 1.41e12 f32 flop a launch,
//     21.0 ms at the 67 TFLOP/s FFMA peak against 3.3 ms for the two strip
//     reads. No TF32 ("highest"), and no split tensor-core product: the
//     mma's truncating accumulation leaned a split-tf32 V (K9/K10 f32). So
//     sandwich_f32_kernel is an FFMA tile, two launches as the bf16 pair:
//     a 256-thread block owns 128 x 128 outputs (8 x 8 a thread), 16-deep
//     stages arrive by cp.async (zeros past N) in two buffers, two blocks
//     an SM. Phase 1 reads the strip as stored (K^T is m-major: two 16-byte
//     A loads a depth), phase 2 k-major rows (8-byte loads of two depths);
//     K3's ks sums beside phase 1 on the same staged tile. Every output sums
//     spans of 256 depths from zero, each added to its running sum in
//     shared memory with one f32 add, so no chain is longer than 256 terms
//     (phase 2 runs ~16384 deep a slice). 35.8 / 35.3 ms (phase 1 ~16.5,
//     phase 2 ~19.0) at config 2's shapes on the same card, against 29.5 /
//     27.7 ms for cuBLAS's f32 products of the same function.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches (or the
// first error).

#include <cooperative_groups.h>

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
// K3/K4 on an f32 strip: the sandwich as an f32 FFMA tile
// ---------------------------------------------------------------------------

constexpr int SF_THREADS = 256;
constexpr int SF_BM = 128;                    // output rows a block
constexpr int SF_BN = 128;                    // sketch columns a block
constexpr int SF_BK = 16;                     // depth a stage
constexpr int SF_SPAN = 16;                   // stages a span: 256 deep, summed from zero
constexpr int SF_LDK = SF_BK + 4;             // phase 2's A rows, k-major (floats)
constexpr int SF_A = SF_BM * SF_LDK;          // >= SF_BK * SF_BM, phase 1's m-major A
constexpr int SF_B = SF_BK * SF_BN;
constexpr int SF_STAGE = SF_A + SF_B + SF_BK; // + K3's t of the stage
// two stages, the running sums (64 a thread), the s2 of the tile's rows
constexpr size_t SF_SMEM = sizeof(float) * (2 * (size_t)SF_STAGE + 64 * SF_THREADS + SF_BM);

struct SfArgs {
  const float* strip;  // (P, ld)
  const float* ta;     // (P, kp)                 phase 1
  const float* t;      // (P)                     phase 1, K3
  const float* s_pre;  // (N)                     phase 1, K3
  const float* bm;     // (N)                     phase 1, K3
  const float* s2_in;  // (N)                     phase 1, K4
  float* s_post;       // (N) out                 phase 1, K3
  float* ws;           // (N, kp) out / in        phase 1 / phase 2
  float* part;         // (splits, P, kp) out     phase 2
  int P, N, ld, kp, chunk;
};

// 16 bytes into shared memory, or 16 zero bytes where `valid` is false
__device__ __forceinline__ void cp_async16z(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// the stage of depth [kd, kd + 16) into `st`: A (phase 1 m-major
// [k][m] from strip rows kd + k; phase 2 k-major [m][k] from strip columns
// kd + k), B [k][n] (ta or ws rows kd + k), K3's t; zeros past N and past
// the slice's end k_end (a multiple of 16, or N). One commit group
template <int PHASE, bool SPOST>
__device__ __forceinline__ void sf_load(float* st, const SfArgs& a, int m0, int n0, int kd,
                                        int k_end) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = tid + h * SF_THREADS;   // 512 chunks of 16 B each
    if (PHASE == 1) {
      const int k = c >> 5, col = m0 + 4 * (c & 31);
      const bool v = col < a.N;
      cp_async16z(st + k * SF_BM + 4 * (c & 31),
                  v ? a.strip + (size_t)(kd + k) * a.ld + col : a.strip, v);
    } else {
      const int r = c >> 2, col = kd + 4 * (c & 3);
      const bool v = col < k_end;
      cp_async16z(st + r * SF_LDK + 4 * (c & 3),
                  v ? a.strip + (size_t)(m0 + r) * a.ld + col : a.strip, v);
    }
    const int k = c >> 5;
    const bool v = kd + k < k_end;
    const float* b = PHASE == 1 ? a.ta : a.ws;
    cp_async16z(st + SF_A + k * SF_BN + 4 * (c & 31),
                v ? b + (size_t)(kd + k) * a.kp + n0 + 4 * (c & 31) : b, v);
  }
  if (SPOST && tid < SF_BK / 4) cp_async16z(st + SF_A + SF_B + 4 * tid, a.t + kd + 4 * tid, true);
  cp_async_commit();
}

// acc[i][j] += av[i] b[j]: the thread's 8 rows by its 8 columns
__device__ __forceinline__ void sf_fma(float (&acc)[8][8], const float (&av)[8], float4 b0,
                                       float4 b1) {
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], b[j], acc[i][j]);
}

// PHASE 1: W = K^T ta over all of P for output rows = strip columns [m0,
//          m0 + 128), sketch columns [n0, n0 + 128); epilogue ws = W s2 in
//          f32 (K3: s2 = s_post^2, s_post from ks = K^T t summed beside).
// PHASE 2: part[z] = K ws for output rows = strip rows [m0, m0 + 128) over
//          the strip columns of slice z.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty + {0..3}, 64 + 4 ty
// + {0..3} and columns 4 tx + {0..3}, 64 + 4 tx + {0..3}: a B row is two
// 16-byte loads (a warp reads 256 contiguous bytes), A two (phase 1, two
// addresses a warp) or, k-major, one 8-byte load a row for two depths.
// Each output sums a span of 256 depths from zero in registers, then adds
// it to its running sum in shared memory with one f32 add.
template <int PHASE, bool SPOST>
__global__ __launch_bounds__(SF_THREADS, 2) void sandwich_f32_kernel(const SfArgs a) {
  extern __shared__ __align__(16) float sf_smem[];
  float* run_s = sf_smem + 2 * SF_STAGE;     // [64][SF_THREADS]
  float* s2_s = run_s + 64 * SF_THREADS;     // [SF_BM]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * SF_BN, m0 = blockIdx.y * SF_BM;
  const int k_beg = PHASE == 1 ? 0 : blockIdx.z * a.chunk;
  const int k_end = PHASE == 1 ? a.P : min(a.N, k_beg + a.chunk);
  const int nst = k_end > k_beg ? (k_end - k_beg + SF_BK - 1) / SF_BK : 0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ks_acc = 0.f, ks_run = 0.f;   // K3: ks of strip column m0 + tid (tid < 128)
  if (nst > 0) sf_load<PHASE, SPOST>(sf_smem, a, m0, n0, k_beg, k_end);
  for (int s = 0; s < nst; ++s) {
    const float* as = sf_smem + (s & 1) * SF_STAGE;
    const float* bs = as + SF_A;
    cp_async_wait_all();
    __syncthreads();   // stage s in; every thread is done with stage s - 1's buffer
    if (s + 1 < nst)
      sf_load<PHASE, SPOST>(sf_smem + ((s + 1) & 1) * SF_STAGE, a, m0, n0,
                            k_beg + (s + 1) * SF_BK, k_end);
    if (s % SF_SPAN == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      ks_acc = 0.f;
    }
    if (PHASE == 1) {
#pragma unroll
      for (int k = 0; k < SF_BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(as + k * SF_BM + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(as + k * SF_BM + 64 + 4 * ty);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        sf_fma(acc, av, *reinterpret_cast<const float4*>(bs + k * SF_BN + 4 * tx),
               *reinterpret_cast<const float4*>(bs + k * SF_BN + 64 + 4 * tx));
      }
      if (SPOST && tid < SF_BM) {
        const float* ts = bs + SF_B;
#pragma unroll
        for (int k = 0; k < SF_BK; ++k) ks_acc = fmaf(ts[k], as[k * SF_BM + tid], ks_acc);
      }
    } else {
#pragma unroll
      for (int k = 0; k < SF_BK; k += 2) {
        float2 ar[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ar[i] = *reinterpret_cast<const float2*>(as + ((i & 4) * 16 + 4 * ty + (i & 3)) * SF_LDK + k);
        const float av0[8] = {ar[0].x, ar[1].x, ar[2].x, ar[3].x,
                              ar[4].x, ar[5].x, ar[6].x, ar[7].x};
        sf_fma(acc, av0, *reinterpret_cast<const float4*>(bs + k * SF_BN + 4 * tx),
               *reinterpret_cast<const float4*>(bs + k * SF_BN + 64 + 4 * tx));
        const float av1[8] = {ar[0].y, ar[1].y, ar[2].y, ar[3].y,
                              ar[4].y, ar[5].y, ar[6].y, ar[7].y};
        sf_fma(acc, av1, *reinterpret_cast<const float4*>(bs + (k + 1) * SF_BN + 4 * tx),
               *reinterpret_cast<const float4*>(bs + (k + 1) * SF_BN + 64 + 4 * tx));
      }
    }
    if ((s + 1) % SF_SPAN == 0 || s + 1 == nst) {   // the span into the running sums
      const bool first = s < SF_SPAN, last = s + 1 == nst;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* q = run_s + (i * 8 + j) * SF_THREADS + tid;
          const float v = first ? acc[i][j] : *q + acc[i][j];
          if (last)
            acc[i][j] = v;
          else
            *q = v;
        }
      ks_run = first ? ks_acc : ks_run + ks_acc;
    }
  }

  if (PHASE == 1) {
    // the column scales of this tile, then ws = W s2
    if (tid < SF_BM) {
      const int j = m0 + tid;
      float s2 = 0.f;
      if (j < a.N) {
        if (SPOST) {
          const float sp = sqrtf(a.s_pre[j] / fmaxf(ks_run, EPS)) * a.bm[j];
          if (blockIdx.x == 0) a.s_post[j] = sp;
          s2 = sp * sp;
        } else {
          s2 = a.s2_in[j];
        }
      }
      s2_s[tid] = s2;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i & 4) * 16 + 4 * ty + (i & 3), j = m0 + r;
      if (j >= a.N) continue;
      const float s2 = s2_s[r];
      float4* o = reinterpret_cast<float4*>(a.ws + (size_t)j * a.kp + n0 + 4 * tx);
      o[0] = make_float4(acc[i][0] * s2, acc[i][1] * s2, acc[i][2] * s2, acc[i][3] * s2);
      o[16] = make_float4(acc[i][4] * s2, acc[i][5] * s2, acc[i][6] * s2, acc[i][7] * s2);
    }
  } else {
    float* out = a.part + (size_t)blockIdx.z * a.P * a.kp;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + (i & 4) * 16 + 4 * ty + (i & 3);
      float4* o = reinterpret_cast<float4*>(out + (size_t)r * a.kp + n0 + 4 * tx);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[16] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

template <int PHASE, bool SPOST>
int launch_sandwich_f32(dim3 grid, const SfArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(sandwich_f32_kernel<PHASE, SPOST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SF_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  sandwich_f32_kernel<PHASE, SPOST><<<grid, SF_THREADS, SF_SMEM, s>>>(a);
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
// aligned strip, ta, t and ws; ta (P, kp), ws (N, kp), part (splits, P,
// kp), u (P, kp). Phase 2's slices are `splits` column ranges of
// ceil(N / splits) rounded up to 16.
int glt_strip_sandwich_f32(const void* strip, const void* ta, const void* t,
                           const void* s_pre, const void* bm, const void* s2,
                           void* s_post, void* ws, void* part, void* u,
                           int P, int N, int ld, int kp, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(strip) | reinterpret_cast<uintptr_t>(ta) |
                          reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(ws);
  if (P <= 0 || P % SF_BM || N <= 0 || ld < N || ld % 4 || kp <= 0 || kp % SF_BN ||
      splits < 1 || splits > 65535 || (N + SF_BM - 1) / SF_BM > 65535 || align % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  SfArgs a = {};
  a.strip = static_cast<const float*>(strip);
  a.ta = static_cast<const float*>(ta);
  a.t = static_cast<const float*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s2_in = static_cast<const float*>(s2);
  a.s_post = static_cast<float*>(s_post);
  a.ws = static_cast<float*>(ws);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  a.ld = ld;
  a.kp = kp;
  const int chunk = (N + splits - 1) / splits;
  a.chunk = (chunk + SF_BK - 1) / SF_BK * SF_BK;

  const dim3 g1(kp / SF_BN, (N + SF_BM - 1) / SF_BM);
  int rc = t != nullptr ? launch_sandwich_f32<1, true>(g1, a, s)
                        : launch_sandwich_f32<1, false>(g1, a, s);
  if (rc != 0) return rc;
  rc = launch_sandwich_f32<2, false>(dim3(kp / SF_BN, P / SF_BM, splits), a, s);
  if (rc != 0) return rc;
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(u), splits,
                       (size_t)P * kp, s);
}

}  // extern "C"
