// Helpers shared by the port's kernels (affinity_strip.cu, K1;
// strip_sweeps.cu, K2-K4; recompute_sweeps.cu, K7/K8; recompute_matvec.cu,
// K5/K6; colstats_v.cu, K9/K10; coord_store.cu, K1 on coordinates and the
// f32 K7): the bf16 and fp16 tensor-core instructions,
// bf16 packing and rounding, the aug-layout tile entry and the bf16 entry's
// fast exp, the IEEE f32 tile entry and the f32 layouts' norms pre-pass,
// the split-fp16 cross of f32 features,
// f32 operands as three bf16 parts on a grid (split3_grid),
// ldmatrix and movmatrix,
// cp.async staging, the A fragment of a k-major feature matrix, mbarriers,
// TMA and bulk copies with their tensor maps, the cluster launch, and the
// fixed-order reduction of per-block partials. Header-only: every source that
// includes it gets its own copy inside an anonymous namespace (ops/_build.py
// hashes *.cuh with the sources, so an edit here rebuilds).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// the bf16 entry before its rounding, exp(-max(d2, 0)) of an f32 d2, as one
// FMUL by -log2(e) and one MUFU ex2 (K1, K9, K10). The entry is
// bf16(exp(..)): a result within a few f32 ulps of expf's rounds to the same
// bf16 except within that distance of a bf16 rounding boundary (chip_smoke.py
// counts the share that flips). Not the ftz form: subnormal entries survive
// as under expf
__device__ __forceinline__ float kexp(float d2) {
  float r;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(r) : "f"(fmaxf(d2, 0.f) * -1.4426950408889634f));
  return r;
}

// --- the IEEE f32 cross (K7-K10 f32; K1 and the f32 K5/K6 on coordinates) ----
//
// The f32 tile entry of the reference's _kb_tile f32 class:
// exp(-max((na + nb) - 2 cross, 0)) with f32 norms, the cross an f32 FFMA
// chain over the live lanes in lane order (the zero pad lanes add exact
// zeros, so a chain over lanes rounded up to 4 is the same value), and
// expf. Unlike the split-fp16 cross it keeps the IEEE product's error on
// features of any norm: coordinates / spatial_h reach |f|^2 ~ 3e5 at
// 2048 x 4096, where the split's fp16 small part loses about four times as
// much as the f32 product.

// c + a . b over four lanes, in lane order
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// d2 = max((na + nb) - 2 cross, 0): 2 cross is exact, so the FMA rounds as
// the plain version's subtraction does
__device__ __forceinline__ float d2f32(float nab, float cross) {
  return fmaxf(fmaf(-2.f, cross, nab), 0.f);
}

// the f32 entry exp(-d2)
__device__ __forceinline__ float kf32(float nab, float cross) { return expf(-d2f32(nab, cross)); }

// each sample row's and each column's norm, the FMA chain over the first L
// lanes in lane order (the tile entries' chain, so a pixel's d2 with itself
// is 0): rows of the row-major fa (P, fd) into nrm[0, P), columns of the
// k-major ft (fd, N) into nrm[P, P + N) (the f32 K7 and K8, K1 on
// coordinates)
__global__ void ext2_norms_kernel(const float* __restrict__ fa, const float* __restrict__ ft,
                                  float* __restrict__ nrm, int P, int N, int fd, int L) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)P + N;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool row = i < (size_t)P;
    const float* x = row ? fa + i * fd : ft + (i - P);
    const size_t ld = row ? 1 : (size_t)N;
    float s = 0.f;
#pragma unroll 4
    for (int k = 0; k < L; ++k) s = fmaf(x[k * ld], x[k * ld], s);
    nrm[i] = s;
  }
}

// the aug entries of two d2 (K7, K8 past 64 lanes, the aug K5/K6 at 128),
// bf16(exp(-bf16(max(d2, 0)))) packed (lo in the low half): d2 rounded to
// bf16 (cvt.rn.bf16x2), then kexp's one FMUL and one MUFU ex2 on each,
// rounded again. Equal to kb_aug at every one of the
// 65536 bf16(d2) patterns (glt_kb_entries evaluates this function there;
// chip_smoke.py requires it); kexp's fmaxf maps the negative and NaN
// patterns to the entry 1.0, as kb_aug's does
__device__ __forceinline__ uint32_t kb_pair(float lo, float hi) {
  const uint32_t w = pack2(lo, hi);
  return pack2(kexp(__uint_as_float(w << 16)), kexp(__uint_as_float(w & 0xFFFF0000u)));
}

// --- the split-fp16 cross of f32 features (K1, the f32 K5/K6) --------------

__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

// the E of a feature vector whose largest |x_k| is maxabs: maxabs < 2^E,
// clamped so that 2^E and 2^-E stay normal
__device__ __forceinline__ int vec_exp(float maxabs) {
  const int e = ((__float_as_int(maxabs) >> 23) & 0xff) - 126;
  return min(max(e, -100), 100);
}

// x' = x 2^-E (|x'| < 1) of a feature vector as big + small: big = x'
// rounded to the grid 2^-10, at most 2^10 steps, so 11 significant bits
// and exact in fp16; small = fp16(x' - big), x' - big exact in f32. A
// product of two bigs is then a multiple of 2^-20 of magnitude at most 1,
// and a sum of 16 of them is exact in f32: the tensor core's accumulation,
// which truncates, has nothing to drop there. Returns (big, small) as f32
__device__ __forceinline__ float2 split2(float x, float sinv) {
  const float xs = x * sinv;
  const float b = rintf(xs * 1024.f) * (1.f / 1024.f);
  return make_float2(b, xs - b);
}

// x' = x 2^-E (|x'| < 1) of a feature vector as big + mid + lo, each
// exact in fp16 and in its normal range: big = x' rounded to the grid
// 2^-10 (as split2); mid = x' - big rounded to the grid 2^-21 (|mid| <=
// 2^-11), returned times 2^11; lo = x' - big - mid (|lo| <= 2^-22, exact in
// f32), returned times 2^22. Products of two scaled parts are then
// multiples of 2^-20 of magnitude at most 1, so a k16 step of big.big is
// exact, and x'a.x'b = big.big + 2^-11 (big.mid + mid.big) + 2^-22
// (mid.mid + big.lo + lo.big) drops only terms below 2^-33 (the f32 K5/K6:
// the fp16 small part of split2 keeps 11 of the residual's bits, an error
// of up to 2^-23 a lane, 4x an f32 rounding). Returns (big, mid', lo')
__device__ __forceinline__ float3 split3(float x, float sinv) {
  const float xs = x * sinv;
  const float b = rintf(xs * 1024.f) * (1.f / 1024.f);
  const float r = xs - b;
  const float m = rintf(r * 2097152.f) * (1.f / 2097152.f);
  return make_float3(b, m * 2048.f, (r - m) * 4194304.f);
}

// --- f32 operands as three bf16 parts (the f32 K3/K4, K9/K10) -------------

constexpr int GRID_EMAX = 100;   // |a grid's exponent| (2^E and the grids normal)

// x0, x1 (each |x| <= 2^E, its qi = 2^(E-8), q = 1 / qi) as three bf16 parts,
// packed in pairs (x0 in the low half): b0 = x rounded to the grid qi (at
// most 2^8 steps, so exact in bf16), b1 = bf16(x - b0), b2 = bf16(x - b0 -
// b1). Both remainders are exact in f32, and b0 + b1 + b2 holds x to 2^-17
// of |x - b0| <= qi / 2. E is the stage's: the largest |x| of the row of A,
// or of the column of B, over the 32 depths of the stage is < 2^E. Products
// of two b0 are then multiples of 2^(Ea + Eb - 16) of magnitude at most
// 2^(Ea + Eb): the stage's sum of 32 needs 22 bits, so the tensor core's
// accumulation, which truncates, drops nothing
__device__ __forceinline__ void split3_grid(float x0, float x1, float q0, float qi0, float q1,
                                            float qi1, uint32_t (&out)[3]) {
  const float b0 = rintf(x0 * q0) * qi0, b1 = rintf(x1 * q1) * qi1;
  out[0] = pack2(b0, b1);
  const float r0 = x0 - b0, r1 = x1 - b1;
  out[1] = pack2(r0, r1);
  const float2 c = unpack2(out[1]);
  out[2] = pack2(r0 - c.x, r1 - c.y);
}

// the grid's E of values whose largest |x| is m: m < 2^E, clamped so that
// 2^E and the grid 2^(E - 8) stay normal (all zero: the least E)
__device__ __forceinline__ int grid_exp(float m) {
  const int e = (int)((__float_as_uint(m) >> 23) & 0xff) - 126;
  return min(max(e, -GRID_EMAX), GRID_EMAX);
}

__device__ __forceinline__ uint32_t h2(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a . b: one m16n8k16 fp16 product with f32 accumulation
__device__ __forceinline__ void mma16816h(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// until at most N of the thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// --- mbarriers, TMA and bulk copies (K1-K4) ---------------------------------

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

// a box at element coordinates (c0 inner, c1 outer) of a 2-D tensor map
// into shared memory, completing on the barrier
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                        uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// a box of shared memory out to (c0 inner, c1 outer) of a 2-D tensor map;
// the parts past the tensor's edge are not written. Joins the thread's open
// bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until every bulk group of the thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// a row-major (outer, inner) matrix of bf16 (f32 = false) or f32 elements,
// rows ld elements apart, in (box_inner x box_outer) boxes with the 128-byte
// swizzle (box_inner * element size == 128); box entries past the edge read
// as zero and are not written
bool tile_map(CUtensorMap* m, const void* base, bool f32, int inner, int outer, int ld,
              int box_inner, int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer}, unit[2] = {1, 1};
  return fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- thread-block clusters (K2, K8) -------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the launch of `clusters` clusters of `cl` blocks (attr: storage for the
// cluster-dimension attribute the config points to)
cudaLaunchConfig_t cluster_cfg(int cl, int clusters, int threads, size_t smem, cudaStream_t s,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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
