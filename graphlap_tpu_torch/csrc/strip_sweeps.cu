// K2-K4 — the fused strip sweeps of the strip_cache factor, on a bf16
// (P, N) strip whose padding rows and columns are exactly zero.
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
// with the Pallas rounding points: t2, t and ta arrive as bf16, the
// products accumulate in f32, ws rounds to bf16 before the second product.
//
// What bounds them on an H100: the strip is 2.75 GB at the main-path shape
// (P 5248, N 262144), 0.82 ms a read at 3.35 TB/s. K2 does 3 flops a
// strip element, so it is a pure stream. K3/K4 do two (P x N) x (N x 256)
// products, 0.70 TFLOP each: 1.42 ms of bf16 tensor-core work at the
// 989 TFLOP/s dense peak, the bound; a strip read per product is 256
// flops a byte, just under the card's ~295, so each product is close to
// balanced between the tensor cores and memory.
//
// Design.
//   * K2 gives each block a fixed set of 128-column tiles. For each tile it
//     sweeps the rows once for kbt (column sums, warps over rows, lanes over
//     columns), forms s, then sweeps again for the row sums K s into a
//     P-float accumulator in shared memory. The second sweep re-reads the
//     tile (from L2 or device memory): 2 strip reads.
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
//   * Every cross-block sum (K2's u, phase 2's U) goes through per-block
//     partials and a reduction pass that adds them in a fixed order — no
//     float atomics, so a run is bit-for-bit repeatable.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches (or the
// first error).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float EPS = 1e-30f;
constexpr int THREADS = 256;   // K2's block

// ---------------------------------------------------------------------------
// K2: strip_ext2
// ---------------------------------------------------------------------------

constexpr int E_TN = 128;        // columns a tile (4 per lane)
constexpr int E_WARPS = THREADS / 32;

__device__ __forceinline__ void load4(const bf16* __restrict__ strip, size_t row_off,
                                      int c, int n, bool vec, float v[4]) {
  if (vec && c + 4 <= n) {
    const uint2 raw = *reinterpret_cast<const uint2*>(strip + row_off + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(h[0]);
    const float2 hi = __bfloat1622float2(h[1]);
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = (c + q < n) ? __bfloat162float(strip[row_off + c + q]) : 0.f;
  }
}

__global__ __launch_bounds__(THREADS) void ext2_kernel(
    const bf16* __restrict__ strip,  // (P, N)
    const bf16* __restrict__ t2,     // (2, P)
    const float* __restrict__ bm,    // (N)
    float* __restrict__ s_out,       // (N)
    float* __restrict__ u_part,      // (gridDim.x, P)
    int P, int N) {
  extern __shared__ __align__(16) float esm[];
  float* u_s = esm;                 // P
  float* tr_s = u_s + P;            // P
  float* tc_s = tr_s + P;           // P
  float* red = tc_s + P;            // E_WARPS * 2 * E_TN
  float* s_s = red + E_WARPS * 2 * E_TN;  // E_TN

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < P; i += THREADS) {
    u_s[i] = 0.f;
    tr_s[i] = __bfloat162float(t2[i]);
    tc_s[i] = __bfloat162float(t2[P + i]);
  }
  __syncthreads();

  const bool vec = (N % 4 == 0);
  const int ntiles = (N + E_TN - 1) / E_TN;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int c = tile * E_TN + lane * 4;
    // sweep 1: kbt for this tile's columns
    float ar[4] = {0.f, 0.f, 0.f, 0.f}, ac[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = warp; i < P; i += E_WARPS) {
      float v[4];
      load4(strip, (size_t)i * N, c, N, vec, v);
      const float tr = tr_s[i], tc = tc_s[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ar[q] = fmaf(v[q], tr, ar[q]);
        ac[q] = fmaf(v[q], tc, ac[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      red[(warp * 2 + 0) * E_TN + lane * 4 + q] = ar[q];
      red[(warp * 2 + 1) * E_TN + lane * 4 + q] = ac[q];
    }
    __syncthreads();
    if (tid < E_TN) {
      float kr = 0.f, kc = 0.f;
      for (int w = 0; w < E_WARPS; ++w) {   // fixed order
        kr += red[(w * 2 + 0) * E_TN + tid];
        kc += red[(w * 2 + 1) * E_TN + tid];
      }
      const int col = tile * E_TN + tid;
      float s = 0.f;
      if (col < N) {
        s = bm[col] / sqrtf(fmaxf(kr * kc, EPS));
        s_out[col] = s;
      }
      s_s[tid] = s;
    }
    __syncthreads();
    // sweep 2: u += K_tile s_tile
    float sv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) sv[q] = s_s[lane * 4 + q];
#pragma unroll 4
    for (int i = warp; i < P; i += E_WARPS) {
      float v[4];
      load4(strip, (size_t)i * N, c, N, vec, v);
      float acc = v[0] * sv[0];
      acc = fmaf(v[1], sv[1], acc);
      acc = fmaf(v[2], sv[2], acc);
      acc = fmaf(v[3], sv[3], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) u_s[i] += acc;   // row i belongs to one warp
    }
    __syncthreads();
  }
  for (int i = tid; i < P; i += THREADS) u_part[(size_t)blockIdx.x * P + i] = u_s[i];
}

// out[i] = sum_g part[g * len + i], g in order
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int groups, size_t len) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[(size_t)g * len + i];
    out[i] = acc;
  }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a (64 x 64) bf16 box at element coordinates (c0 inner, c1 outer) of a 2-D
// tensor map into shared memory, completing on the barrier
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // seen by wgmma
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

int launch_reduce(const float* part, float* out, int groups, size_t len, cudaStream_t s) {
  const int threads = 256;
  size_t blocks = (len + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  reduce_partials<<<(unsigned)blocks, threads, 0, s>>>(part, out, groups, len);
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (outer, inner) bf16 matrix, rows ld apart, read in 64 x 64 boxes with the
// 128-byte swizzle; out-of-range box entries read as zero
bool bf16_map(CUtensorMap* m, const void* base, int inner, int outer, int ld) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

size_t glt_ext2_smem_bytes(int P) {
  return sizeof(float) * (3 * (size_t)P + E_WARPS * 2 * E_TN + E_TN);
}

// K2. u_part holds (blocks, P) floats.
int glt_strip_ext2(const void* strip, const void* t2, const void* bm, void* s_out,
                   void* u_part, void* u, int P, int N, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = glt_ext2_smem_bytes(P);
  cudaFuncSetAttribute(ext2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ext2_kernel<<<blocks, THREADS, smem, s>>>(
      static_cast<const bf16*>(strip), static_cast<const bf16*>(t2),
      static_cast<const float*>(bm), static_cast<float*>(s_out),
      static_cast<float*>(u_part), P, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  launch_reduce(static_cast<const float*>(u_part), static_cast<float*>(u), blocks,
                (size_t)P, s);
  return static_cast<int>(cudaGetLastError());
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
  if (!bf16_map(&strip_map, strip, N, P, ld) || !bf16_map(&ta_map, ta, kp, P, kp) ||
      !bf16_map(&ws_map, ws, kp, N, kp))
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

}  // extern "C"
