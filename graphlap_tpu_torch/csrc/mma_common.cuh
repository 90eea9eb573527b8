// Helpers shared by the recompute kernels (recompute_sweeps.cu, K7/K8,
// recompute_matvec.cu, K5/K6, and colstats_v.cu, K9/K10): the bf16 tensor-core
// instruction, bf16 packing and rounding, the aug-layout tile entry, ldmatrix
// and movmatrix, cp.async staging, the A fragment of a k-major feature
// matrix, and the fixed-order
// reduction of per-block partials. Header-only: every source that includes it gets its own
// copy inside an anonymous namespace (ops/_build.py hashes *.cuh with the
// sources, so an edit here rebuilds).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float EPS = 1e-30f;
constexpr int RED_THREADS = 256;

// c += a . b: one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

__device__ __forceinline__ float rbf(float x) {  // round to bf16, as f32
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the aug-layout tile entry before its final rounding: exp(-bf16(max(d2, 0)))
__device__ __forceinline__ float kexp_aug(float d2) {
  return expf(-rbf(fmaxf(d2, 0.f)));
}

// the aug-layout tile entry: bf16(exp(-bf16(max(d2, 0))))
__device__ __forceinline__ float kb_aug(float d2) { return rbf(kexp_aug(d2)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory: lane l gives the row address
// of matrix l / 8, row l % 8; register q gets (row g; cols 2 tq, 2 tq + 1)
// of matrix q
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, transposed: register q gets (rows 2 tq, 2 tq + 1; col g)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// an 8 x 8 bf16 matrix held one row pair a lane (row g, cols 2 tq, 2 tq + 1)
// transposed in registers
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A fragment (16 fixed x 16 k) of a k-major (32, ld) bf16 matrix: A[m][k] =
// M[k0 + k][f0 + m], read straight from device memory
__device__ __forceinline__ void frag_a_kmajor(uint32_t a[4],
                                              const unsigned short* __restrict__ m,
                                              size_t ld, int f0, int k0, int g, int tq) {
  const size_t r0 = (size_t)(k0 + 2 * tq) * ld, r8 = r0 + 8 * ld;
  a[0] = (uint32_t)m[r0 + f0 + g] | ((uint32_t)m[r0 + ld + f0 + g] << 16);
  a[1] = (uint32_t)m[r0 + f0 + g + 8] | ((uint32_t)m[r0 + ld + f0 + g + 8] << 16);
  a[2] = (uint32_t)m[r8 + f0 + g] | ((uint32_t)m[r8 + ld + f0 + g] << 16);
  a[3] = (uint32_t)m[r8 + f0 + g + 8] | ((uint32_t)m[r8 + ld + f0 + g + 8] << 16);
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

int launch_reduce(const float* part, float* out, int groups, size_t len, cudaStream_t s) {
  size_t blocks = (len + RED_THREADS - 1) / RED_THREADS;
  if (blocks > 4096) blocks = 4096;
  reduce_partials<<<(unsigned)blocks, RED_THREADS, 0, s>>>(part, out, groups, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
