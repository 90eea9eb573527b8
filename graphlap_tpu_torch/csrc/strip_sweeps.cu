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
// (P 5248, N 262144), 0.8 ms per read at 3.35 TB/s. K2 does 3 flops a
// strip element, so it is a pure stream. K3/K4 do two (P x N) x (N x 256)
// products, 0.70 TFLOP each — bf16 tensor-core work (2.9 ms at the 989
// TFLOP/s dense peak, the strip reads then hide under it).
//
// Design. A Pallas grid step holds a whole (P, tn) strip tile in VMEM and
// feeds it to both consumers; a (5248, tn) tile does not fit the 227 KB of
// an SM's shared memory, and Hopper blocks run in no order, so:
//   * K2 gives each block a fixed set of 128-column tiles. For each tile it
//     sweeps the rows once for kbt (column sums, warps over rows, lanes over
//     columns), forms s, then sweeps again for the row sums K s into a
//     P-float accumulator in shared memory. The second sweep re-reads the
//     tile (from L2 or device memory): 2 strip reads.
//   * K3/K4 run as two kernels. Phase 1 is W = K^T ta on tensor cores
//     (WMMA bf16 16x16x16, f32 accumulate; 128 strip columns x 256 sketch
//     columns a block), with K3's K^T t column sums done beside it on the
//     SIMT cores from the same shared-memory tile; the epilogue scales the
//     rows by s^2 and writes ws (N, 256) in bf16. Phase 2 is U = K ws, split
//     over N into S slices that each write a partial (P, 256) block. Each
//     kernel reads the strip once: 2 strip reads a call.
//   * Every cross-block sum (K2's u, phase 2's U) goes through per-block
//     partials and a reduction pass that adds them in a fixed order — no
//     float atomics, so a run is bit-for-bit repeatable.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float EPS = 1e-30f;
constexpr int THREADS = 256;

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
// K3/K4 phase 1: ws = bf16((K^T ta) * s2), K3 also s_post from K^T t
// ---------------------------------------------------------------------------

constexpr int P1_BM = 128;          // strip columns a block
constexpr int P1_BN = 256;          // sketch columns a block
constexpr int P1_BK = 32;           // strip rows a step
constexpr int P1_LDA = P1_BM + 8;   // As[k][m], bf16
constexpr int P1_LDB = P1_BN + 8;   // Bs[k][n], bf16
constexpr int P1_LDC = P1_BN + 4;   // Cs[m][n], f32

constexpr size_t P1_A_BYTES = (size_t)P1_BK * P1_LDA * 2;
constexpr size_t P1_B_BYTES = (size_t)P1_BK * P1_LDB * 2;
constexpr size_t P1_C_BYTES = (size_t)P1_BM * P1_LDC * 4;
constexpr size_t P1_MAIN = (P1_A_BYTES + P1_B_BYTES) > P1_C_BYTES
                               ? (P1_A_BYTES + P1_B_BYTES) : P1_C_BYTES;
// + t chunk (BK f32) + ks halves (2 x BM f32) + s2 (BM f32)
constexpr size_t P1_SMEM = P1_MAIN + 4 * (P1_BK + 3 * P1_BM);

// 8 bf16 of row `row` at column `col` of a row-major (rows x ld) matrix,
// zero outside [0, rows) x [0, cols).
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ m, int row, int col,
                                       int rows, int cols, int ld, bool vec) {
  if (row < rows && vec && col + 8 <= cols)
    return *reinterpret_cast<const uint4*>(m + (size_t)row * ld + col);
  uint4 r;
  bf16* h = reinterpret_cast<bf16*>(&r);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    h[q] = (row < rows && col + q < cols) ? m[(size_t)row * ld + col + q]
                                          : __float2bfloat16_rn(0.f);
  return r;
}

__global__ __launch_bounds__(THREADS, 1) void sandwich_p1_kernel(
    const bf16* __restrict__ strip,  // (P, N)
    const bf16* __restrict__ ta,     // (P, kp), kp % 256 == 0
    const bf16* __restrict__ t,      // (P) or null (K4)
    const float* __restrict__ s_pre, // (N)  K3
    const float* __restrict__ bm,    // (N)  K3
    const float* __restrict__ s2_in, // (N)  K4
    float* __restrict__ s_post,      // (N)  K3 out
    bf16* __restrict__ ws,           // (N, kp) out
    int P, int N, int kp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + P1_A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);
  float* t_s = reinterpret_cast<float*>(smem + P1_MAIN);
  float* ks_s = t_s + P1_BK;          // 2 * BM
  float* s2_s = ks_s + 2 * P1_BM;     // BM

  const int tid = threadIdx.x, warp = tid / 32;
  const int j0 = blockIdx.x * P1_BM;
  const int n0 = blockIdx.y * P1_BN;
  const bool spost = (t != nullptr);
  const bool vec_a = (N % 8 == 0);

  const int wm = warp % 2;   // 64 strip columns
  const int wn = warp / 2;   // 64 sketch columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // per-thread load slots: A 32 rows x 16 vectors (2 a thread),
  // B 32 rows x 32 vectors (4 a thread)
  uint4 ra[2], rb[4];
  float tv = 0.f;
  auto gload = [&](int i0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = tid + q * THREADS, k = v / 16, c = (v % 16) * 8;
      ra[q] = load8(strip, i0 + k, j0 + c, P, N, N, vec_a);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + q * THREADS, k = v / 32, c = (v % 32) * 8;
      rb[q] = load8(ta, i0 + k, n0 + c, P, kp, kp, true);
    }
    if (spost && tid < P1_BK)
      tv = (i0 + tid < P) ? __bfloat162float(t[i0 + tid]) : 0.f;
  };
  auto sstore = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = tid + q * THREADS, k = v / 16, c = (v % 16) * 8;
      *reinterpret_cast<uint4*>(As + k * P1_LDA + c) = ra[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + q * THREADS, k = v / 32, c = (v % 32) * 8;
      *reinterpret_cast<uint4*>(Bs + k * P1_LDB + c) = rb[q];
    }
    if (spost && tid < P1_BK) t_s[tid] = tv;
  };

  // K3's column sums K^T t on the SIMT cores: column tid % 128, rows of
  // the step's half tid / 128
  const int kcol = tid % P1_BM, khalf = tid / P1_BM;
  float ks_acc = 0.f;

  gload(0);
  for (int i0 = 0; i0 < P; i0 += P1_BK) {
    sstore();
    __syncthreads();
    if (i0 + P1_BK < P) gload(i0 + P1_BK);   // next step's loads in flight
    if (spost) {
#pragma unroll
      for (int k = khalf * 16; k < khalf * 16 + 16; ++k)
        ks_acc = fmaf(__bfloat162float(As[k * P1_LDA + kcol]), t_s[k], ks_acc);
    }
#pragma unroll
    for (int kk = 0; kk < P1_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + kk * P1_LDA + wm * 64 + i * 16, P1_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, Bs + kk * P1_LDB + wn * 64 + j * 16, P1_LDB);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // column scales of this tile
  if (spost) ks_s[khalf * P1_BM + kcol] = ks_acc;
  __syncthreads();
  if (tid < P1_BM) {
    const int j = j0 + tid;
    float s2 = 0.f;
    if (j < N) {
      if (spost) {
        const float ks = ks_s[tid] + ks_s[P1_BM + tid];
        const float sp = sqrtf(s_pre[j] / fmaxf(ks, EPS)) * bm[j];
        if (blockIdx.y == 0) s_post[j] = sp;
        s2 = sp * sp;
      } else {
        s2 = s2_in[j];
      }
    }
    s2_s[tid] = s2;
  }
  // accumulators -> Cs (aliases As/Bs: the loop ended on a barrier)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * P1_LDC + wn * 64 + j * 16,
                              acc[i][j], P1_LDC, wmma::mem_row_major);
  __syncthreads();
  // ws[j, n0 + c] = bf16(W * s2_j), 8 values a vector
  for (int v = tid; v < P1_BM * (P1_BN / 8); v += THREADS) {
    const int m = v / (P1_BN / 8), c = (v % (P1_BN / 8)) * 8;
    const int j = j0 + m;
    if (j >= N) continue;
    const float s2 = s2_s[m];
    __nv_bfloat162 h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[q] = __floats2bfloat162_rn(Cs[m * P1_LDC + c + 2 * q] * s2,
                                   Cs[m * P1_LDC + c + 2 * q + 1] * s2);
    *reinterpret_cast<uint4*>(ws + (size_t)j * kp + n0 + c) = *reinterpret_cast<uint4*>(h);
  }
}

// ---------------------------------------------------------------------------
// K3/K4 phase 2: part[z] = K[:, slice z] ws[slice z, :]
// ---------------------------------------------------------------------------

constexpr int P2_BM = 128;          // strip rows a block
constexpr int P2_BN = 256;          // sketch columns a block
constexpr int P2_BK = 32;           // strip columns a step
constexpr int P2_LDA = P2_BK + 8;   // As[m][k], bf16
constexpr int P2_LDB = P2_BN + 8;   // Bs[k][n], bf16
constexpr size_t P2_A_BYTES = (size_t)P2_BM * P2_LDA * 2;
constexpr size_t P2_SMEM = P2_A_BYTES + (size_t)P2_BK * P2_LDB * 2;

__global__ __launch_bounds__(THREADS, 1) void sandwich_p2_kernel(
    const bf16* __restrict__ strip,  // (P, N)
    const bf16* __restrict__ ws,     // (N, kp)
    float* __restrict__ part,        // (S, P, kp)
    int P, int N, int kp, int chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + P2_A_BYTES);

  const int tid = threadIdx.x, warp = tid / 32;
  const int i0 = blockIdx.x * P2_BM;
  const int n0 = blockIdx.y * P2_BN;
  const int jb = blockIdx.z * chunk;
  const int je = min(N, jb + chunk);
  const bool vec_a = (N % 8 == 0);

  const int wm = warp % 2;   // 64 strip rows
  const int wn = warp / 2;   // 64 sketch columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A 128 rows x 4 vectors (2 a thread), B 32 rows x 32 vectors (4 a thread)
  uint4 ra[2], rb[4];
  auto gload = [&](int j0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = tid + q * THREADS, m = v / 4, c = (v % 4) * 8;
      ra[q] = load8(strip, i0 + m, j0 + c, P, je, N, vec_a);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + q * THREADS, k = v / 32, c = (v % 32) * 8;
      rb[q] = load8(ws, j0 + k, n0 + c, je, kp, kp, true);
    }
  };
  auto sstore = [&]() {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int v = tid + q * THREADS, m = v / 4, c = (v % 4) * 8;
      *reinterpret_cast<uint4*>(As + m * P2_LDA + c) = ra[q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int v = tid + q * THREADS, k = v / 32, c = (v % 32) * 8;
      *reinterpret_cast<uint4*>(Bs + k * P2_LDB + c) = rb[q];
    }
  };

  if (jb < je) gload(jb);
  for (int j0 = jb; j0 < je; j0 += P2_BK) {
    sstore();
    __syncthreads();
    if (j0 + P2_BK < je) gload(j0 + P2_BK);
#pragma unroll
    for (int kk = 0; kk < P2_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * P2_LDA + kk, P2_LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, Bs + kk * P2_LDB + wn * 64 + j * 16, P2_LDB);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * P * kp;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (size_t)(i0 + wm * 64 + i * 16) * kp + n0 + wn * 64 + j * 16,
                              acc[i][j], kp, wmma::mem_row_major);
}

int launch_reduce(const float* part, float* out, int groups, size_t len, cudaStream_t s) {
  const int threads = 256;
  size_t blocks = (len + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  reduce_partials<<<(unsigned)blocks, threads, 0, s>>>(part, out, groups, len);
  return 0;
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
// P % 128 == 0 and kp % 256 == 0 (the wrapper checks); ws holds (N, kp)
// bf16, part (splits, P, kp) f32, u (P, kp) f32.
int glt_strip_sandwich(const void* strip, const void* ta, const void* t,
                       const void* s_pre, const void* bm, const void* s2,
                       void* s_post, void* ws, void* part, void* u,
                       int P, int N, int kp, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(sandwich_p1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)P1_SMEM);
  dim3 g1((N + P1_BM - 1) / P1_BM, kp / P1_BN);
  sandwich_p1_kernel<<<g1, THREADS, P1_SMEM, s>>>(
      static_cast<const bf16*>(strip), static_cast<const bf16*>(ta),
      static_cast<const bf16*>(t), static_cast<const float*>(s_pre),
      static_cast<const float*>(bm), static_cast<const float*>(s2),
      static_cast<float*>(s_post), static_cast<bf16*>(ws), P, N, kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  int chunk = (N + splits - 1) / splits;
  chunk = (chunk + P2_BK - 1) / P2_BK * P2_BK;
  cudaFuncSetAttribute(sandwich_p2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)P2_SMEM);
  dim3 g2(P / P2_BM, kp / P2_BN, splits);
  sandwich_p2_kernel<<<g2, THREADS, P2_SMEM, s>>>(
      static_cast<const bf16*>(strip), static_cast<const bf16*>(ws),
      static_cast<float*>(part), P, N, kp, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  launch_reduce(static_cast<const float*>(part), static_cast<float*>(u), splits,
                (size_t)P * kp, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
