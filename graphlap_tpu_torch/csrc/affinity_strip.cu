// K1 — the strip emitter: out[i, j] = exp(-max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)).
//
// Replaces graphlap_tpu/ops/pallas_affinity.py:affinity_strip_pallas
// (_affinity_kernel): the (p_pad, n_pad) kernel strip of the strip_cache
// path, written once, GEMM and exp fused so no f32 distance temp reaches
// device memory.
//
// What bounds it on an H100: at the slice's main-path shape (p_pad 5248,
// n 262144, d 25 padded to 32) it writes 2.75 GB of bf16 (0.8 ms at
// 3.35 TB/s) and does 88 GFLOP of IEEE f32 FMA (1.3 ms at the 67 TFLOP/s
// SIMT f32 peak). The GEMM must stay IEEE f32 — the GEMM-trick cancellation
// is why the reference pins "highest" — so tensor cores (TF32 at best) are
// out, and the kernel is bound by f32 FMA throughput, then by the store.
//
// Design: a 128 x 128 output tile per 256-thread block, each thread an
// 8 x 8 register tile; the (128 x 32) A slice and (32 x 128) B^T slice sit
// in shared memory. The norms are recomputed from the same f32 tile values
// (as the Pallas body does), and each thread stores 8 adjacent outputs as
// one 16-byte vector so a row of 16 threads writes 256 contiguous bytes.
// Ragged edges are masked in the loads and stores.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = 256;

template <bool BF16_OUT>
__global__ __launch_bounds__(THREADS) void affinity_kernel(
    const float* __restrict__ a,    // (p, dp) row-major
    const float* __restrict__ bt,   // (dp, n) row-major
    void* __restrict__ out,         // (p, n) bf16 or f32
    int p, int n, int dp) {
  __shared__ float As[BK][BM + 4];  // As[k][m]
  __shared__ float Bs[BK][BN];      // Bs[k][c]
  __shared__ float na_s[BM];
  __shared__ float nb_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float norm_part = 0.f;  // tid < 128: |a_row|^2, else |b_col|^2

  for (int k0 = 0; k0 < dp; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int m = idx / BK, k = idx % BK;
      const int r = row0 + m, kk = k0 + k;
      As[k][m] = (r < p && kk < dp) ? a[(size_t)r * dp + kk] : 0.f;
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      const int k = idx / BN, c = idx % BN;
      const int col = col0 + c, kk = k0 + k;
      Bs[k][c] = (col < n && kk < dp) ? bt[(size_t)kk * n + col] : 0.f;
    }
    __syncthreads();
    if (tid < BM) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) norm_part = fmaf(As[k][tid], As[k][tid], norm_part);
    } else {
      const int c = tid - BM;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) norm_part = fmaf(Bs[k][c], Bs[k][c], norm_part);
    }
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < BM) na_s[tid] = norm_part; else nb_s[tid - BM] = norm_part;
  __syncthreads();

  const bool vec = BF16_OUT ? (n % 8 == 0) : (n % 4 == 0);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= p) continue;
    const float na = na_s[ty * TM + i];
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float d2 = fmaxf(na + nb_s[tx * TN + j] - 2.f * acc[i][j], 0.f);
      v[j] = expf(-d2);
    }
    const int c0 = col0 + tx * TN;
    const size_t base = (size_t)r * n + c0;
    if (BF16_OUT) {
      __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
      if (vec && c0 + TN <= n) {
        __nv_bfloat162 h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        *reinterpret_cast<uint4*>(o + base) = *reinterpret_cast<uint4*>(h);
      } else {
        for (int j = 0; j < TN; ++j)
          if (c0 + j < n) o[base + j] = __float2bfloat16_rn(v[j]);
      }
    } else {
      float* o = reinterpret_cast<float*>(out);
      if (vec && c0 + TN <= n) {
        *reinterpret_cast<float4*>(o + base) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(o + base + 4) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        for (int j = 0; j < TN; ++j)
          if (c0 + j < n) o[base + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" int glt_affinity_strip(const void* a, const void* bt, void* out,
                                  int p, int n, int dp, int out_bf16,
                                  void* stream) {
  dim3 grid((n + BN - 1) / BN, (p + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16)
    affinity_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(bt), out, p, n, dp);
  else
    affinity_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(bt), out, p, n, dp);
  return static_cast<int>(cudaGetLastError());
}
