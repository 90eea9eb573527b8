// K5 / K6 — the recompute matvecs of the operator-filter route: every kernel
// tile k(i, j) = exp(-d2(f_Ai, f_j)) is recomputed from the features, never
// stored in device memory.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K5  matvec_pallas  (_matvec_kernel)   out_i = sum_j k_ij v_j   (p_pad,)
//   K6  rmatvec_pallas (_rmatvec_kernel)  out_j = sum_i t_i k_ij   (n,)
// in the two layouts a preset reaches, with the Pallas rounding points:
//   aug bf16   k = bf16(exp(-bf16(max(fa' . ft', 0)))), d2 straight from the
//              augmented product (ops/recompute_layout.aug_pads); the vector
//              is rounded to bf16 (by the wrapper) and every product k * bf16(x)
//              is exact in f32, so only the f32 summation order differs;
//   plain f32  k = exp(-max(na + nb - 2 cross, 0)) with IEEE-f32 cross and the
//              norms summed from the same f32 tile values (no TF32: the GEMM
//              trick cancels, which is why the reference runs "highest").
//
// Both are one sum, out[f] = sum_s w_s k(f, s), over two k-major (32, L)
// feature matrices: K5 fixes the sample rows (fa^T, which the wrapper
// transposes) and streams the pixel columns (f_t) against w = v; K6 fixes the
// columns and streams the rows against w = t. d2 is symmetric in the roles, so
// one kernel per layout serves both.
//
// What bounds them on an H100. Config 3 (aug, p_pad 4096, n 1048576): 4.3e9
// tile entries a launch; d2 is 0.28 TFLOP bf16 (0.28 ms at 989 TFLOP/s) and
// each entry's epilogue (max, bf16 round, expf, pack) ~10 FP32-pipe
// instructions plus one MUFU ex2: ~1-1.5 ms of SIMT issue at 132 SMs — bound
// by the per-entry SIMT work. 8 MP (f32, p_pad 4096, n 8388608): 3.4e10
// entries, each 32 IEEE f32 FMAs of cross plus the epilogue, ~2.5 TFLOP of
// f32 (37 ms at 67 TFLOP/s): bound by f32 FMA issue. Memory is small beside
// either (features 64-128 B a column, read once from device memory; the fixed
// side's tile re-reads come from L2).
//
// Design, aug (tensor cores): a 256-thread block owns 256 fixed entries, each
// warp 32 of them as bf16 A fragments held in registers for the whole run;
// 128-entry tiles of the streamed side arrive through shared memory with
// cp.async double buffering and feed the B fragments by ldmatrix.trans. A
// warp's d2 is two m16n8k16 mma per 16 x 8 sub-tile, the exp epilogue runs on
// the accumulator registers, and the packed bf16 tile (the accumulator layout
// is the A-fragment layout) times [bf16(w), 0, ...] is one more mma that
// keeps each fixed entry's running sum in registers.
// Design, f32 (SIMT): a 256-thread block owns 128 fixed entries (their 32 x
// 128 features in shared memory), streams 128-entry tiles (cp.async double
// buffered), and each thread computes an 8 x 8 register tile of cross with
// float4 shared loads, then the exp epilogue and its fixed entries' sums.
// Fixed entries' sums meet across the 16 threads that share them by a shuffle
// tree.
// Both: the streamed axis splits across blocks (grid.y) only where the fixed
// side alone does not fill the card (K5); per-split partials are then summed
// by a fixed-order reduction kernel. No float atomics: runs repeat bit for
// bit.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() (or the first error).

#include "mma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FD = 32;                  // feature depth (both layouts)
constexpr int A_RT = 2;                 // aug: fixed 16-tiles a warp
constexpr int A_FT = 8 * A_RT * 16;     // aug: fixed entries a block (256)
constexpr int A_ST = 128;               // aug: streamed entries a tile
constexpr int A_LDS = A_ST + 8;         // padded smem row: 272 B, ldmatrix conflict-free
constexpr int F_T = 128;                // f32: fixed entries a block, streamed a tile
constexpr size_t F_SMEM = sizeof(float) * ((size_t)FD * F_T * 3 + 3 * F_T);

// columns [c0, c0 + tile) of a k-major (32, ld) matrix -> dst[k][0, tile)
// (row stride lds elements), and w[c0, c0 + tile) -> wdst, by cp.async in
// 16-byte chunks (8 bf16 or 4 f32); one commit group
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, int lds, E* wdst, const E* __restrict__ m,
                                          const E* __restrict__ w, size_t ld, size_t c0,
                                          int tile) {
  constexpr int V = 16 / sizeof(E);
  for (int c = threadIdx.x; c < FD * (tile / V); c += THREADS) {
    const int k = c / (tile / V), q = c % (tile / V);
    cp_async16(dst + k * lds + q * V, m + (size_t)k * ld + c0 + q * V);
  }
  if ((int)threadIdx.x < tile / V) cp_async16(wdst + threadIdx.x * V, w + c0 + threadIdx.x * V);
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// aug bf16: out_part[split][f] = sum_s bf16(w_s) k_aug(f, s) over the split
// ---------------------------------------------------------------------------

__global__ __launch_bounds__(THREADS) void aug_sum_kernel(
    const bf16* __restrict__ fixed_t,   // (32, Lf) k-major aug
    const bf16* __restrict__ strm_t,    // (32, Ls) k-major aug
    const bf16* __restrict__ w,         // (Ls) bf16-rounded
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int tiles_per_split) {
  __shared__ __align__(16) bf16 s_s[2][FD][A_LDS];
  __shared__ __align__(16) bf16 w_s[2][A_ST];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = Ls / A_ST;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int fw = blockIdx.x * A_FT + warp * A_RT * 16;   // this warp's fixed entries

  uint32_t a[A_RT][2][4];
  const unsigned short* fx = reinterpret_cast<const unsigned short*>(fixed_t);
#pragma unroll
  for (int r = 0; r < A_RT; ++r) {
    frag_a_kmajor(a[r][0], fx, (size_t)Lf, fw + 16 * r, 0, g, tq);
    frag_a_kmajor(a[r][1], fx, (size_t)Lf, fw + 16 * r, 16, g, tq);
  }
  float acc[A_RT][4];
#pragma unroll
  for (int r = 0; r < A_RT; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  if (t0 < t1)
    load_tile(&s_s[0][0][0], A_LDS, w_s[0], strm_t, w, (size_t)Ls, (size_t)t0 * A_ST, A_ST);
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    cp_async_wait_all();
    __syncthreads();                     // tile in; everyone done with buf ^ 1
    if (tile + 1 < t1)
      load_tile(&s_s[buf ^ 1][0][0], A_LDS, w_s[buf ^ 1], strm_t, w, (size_t)Ls,
                (size_t)(tile + 1) * A_ST, A_ST);
#pragma unroll 2
    for (int c = 0; c < A_ST / 16; ++c) {
      uint32_t b0[4], b1[4];             // streamed 16c..16c+7 and 16c+8..16c+15
      ldsm_x4_trans(b0, &s_s[buf][lane][c * 16]);
      ldsm_x4_trans(b1, &s_s[buf][lane][c * 16 + 8]);
      uint32_t wb[2];
      wb[0] = g == 0 ? ld32(&w_s[buf][c * 16 + 2 * tq]) : 0u;
      wb[1] = g == 0 ? ld32(&w_s[buf][c * 16 + 8 + 2 * tq]) : 0u;
#pragma unroll
      for (int r = 0; r < A_RT; ++r) {
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(d0, a[r][0], b0);
        mma16816(d0, a[r][1], b0 + 2);
        mma16816(d1, a[r][0], b1);
        mma16816(d1, a[r][1], b1 + 2);
        // the accumulator layout is the A-fragment layout: fixed g | g + 8
        // by streamed 2tq.. | 8 + 2tq..
        uint32_t kb[4];
        kb[0] = pack2(kexp_aug(d0[0]), kexp_aug(d0[1]));
        kb[1] = pack2(kexp_aug(d0[2]), kexp_aug(d0[3]));
        kb[2] = pack2(kexp_aug(d1[0]), kexp_aug(d1[1]));
        kb[3] = pack2(kexp_aug(d1[2]), kexp_aug(d1[3]));
        mma16816(acc[r], kb, wb);
      }
    }
  }
  if (tq == 0) {   // acc[r][0], acc[r][2]: fixed fw + 16r + g, + g + 8
    float* o = part + (size_t)blockIdx.y * Lf + fw;
#pragma unroll
    for (int r = 0; r < A_RT; ++r) {
      o[16 * r + g] = acc[r][0];
      o[16 * r + g + 8] = acc[r][2];
    }
  }
}

// ---------------------------------------------------------------------------
// plain f32: out_part[split][f] = sum_s w_s exp(-max(nf + ns - 2 cross, 0))
// ---------------------------------------------------------------------------

__global__ __launch_bounds__(THREADS) void f32_sum_kernel(
    const float* __restrict__ fixed_t,  // (32, Lf) k-major
    const float* __restrict__ strm_t,   // (32, Ls) k-major
    const float* __restrict__ w,        // (Ls)
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int tiles_per_split) {
  extern __shared__ __align__(16) float fsm[];
  float* fx_s = fsm;                    // [32][F_T] fixed features
  float* st_s = fx_s + FD * F_T;        // [2][32][F_T] streamed tiles
  float* w_s = st_s + 2 * FD * F_T;     // [2][F_T]
  float* ns_s = w_s + 2 * F_T;          // [F_T] streamed norms of the tile
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ntiles = Ls / F_T;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int f0 = blockIdx.x * F_T;

  for (int c = tid; c < FD * (F_T / 4); c += THREADS) {
    const int k = c / (F_T / 4), q = c % (F_T / 4);
    reinterpret_cast<float4*>(fx_s)[c] =
        *reinterpret_cast<const float4*>(fixed_t + (size_t)k * Lf + f0 + q * 4);
  }
  if (t0 < t1) load_tile(st_s, F_T, w_s, strm_t, w, (size_t)Ls, (size_t)t0 * F_T, F_T);
  __syncthreads();
  // this thread's fixed entries: ty*4 + [0, 4) and 64 + ty*4 + [0, 4); its
  // streamed entries of a tile: tx*4 + [0, 4) and 64 + tx*4 + [0, 4)
  float nf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int fi = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    float s = 0.f;
    for (int k = 0; k < FD; ++k) s = fmaf(fx_s[k * F_T + fi], fx_s[k * F_T + fi], s);
    nf[i] = s;
  }
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;

  const float4* fx4 = reinterpret_cast<const float4*>(fx_s);
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    cp_async_wait_all();
    __syncthreads();                    // tile in; everyone done with buf ^ 1 and ns_s
    if (tile + 1 < t1)
      load_tile(st_s + (buf ^ 1) * FD * F_T, F_T, w_s + (buf ^ 1) * F_T, strm_t, w,
                (size_t)Ls, (size_t)(tile + 1) * F_T, F_T);
    const float* S = st_s + buf * FD * F_T;
    if (tid < F_T) {
      float s = 0.f;
      for (int k = 0; k < FD; ++k) s = fmaf(S[k * F_T + tid], S[k * F_T + tid], s);
      ns_s[tid] = s;
    }
    const float4* s4 = reinterpret_cast<const float4*>(S);
    float cr[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cr[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < FD; ++k) {
      const float4 a0 = fx4[k * (F_T / 4) + ty], a1 = fx4[k * (F_T / 4) + 16 + ty];
      const float4 b0 = s4[k * (F_T / 4) + tx], b1 = s4[k * (F_T / 4) + 16 + tx];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) cr[i][j] = fmaf(av[i], bv[j], cr[i][j]);
    }
    __syncthreads();                    // ns_s in
    float nsv[8], wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int sj = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      nsv[j] = ns_s[sj];
      wv[j] = w_s[buf * F_T + sj];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d2 = fmaxf(nf[i] + nsv[j] - 2.f * cr[i][j], 0.f);
        acc[i] = fmaf(expf(-d2), wv[j], acc[i]);
      }
  }
  // the 16 threads of a half-warp share fixed entries: a fixed shuffle tree
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (tx == 0) {
    float* o = part + (size_t)blockIdx.y * Lf + f0;
#pragma unroll
    for (int i = 0; i < 8; ++i) o[(i < 4 ? 0 : 64) + ty * 4 + (i & 3)] = acc[i];
  }
}

}  // namespace

extern "C" {

// out[f] = sum_s w_s k(f, s) over k-major (32, Lf) fixed and (32, Ls)
// streamed features. aug: bf16 layouts and w, Lf % 256 == 0, Ls % 128 == 0;
// else f32 layouts and w, Lf % 128 == 0, Ls % 128 == 0 (the wrapper checks).
// splits > 1: part holds (splits, Lf) floats and a fixed-order reduction
// writes out; splits == 1: the kernel writes part, which may be out.
int glt_recompute_sum(int aug, const void* fixed_t, const void* strm_t, const void* w,
                      void* part, void* out, int Lf, int Ls, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int st = aug ? A_ST : F_T;
  const int ntiles = Ls / st;
  const int per = (ntiles + splits - 1) / splits;
  cudaError_t e;
  if (aug) {
    dim3 grid(Lf / A_FT, splits);
    aug_sum_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(fixed_t), static_cast<const bf16*>(strm_t),
        static_cast<const bf16*>(w), static_cast<float*>(part), Lf, Ls, per);
  } else {
    e = cudaFuncSetAttribute(f32_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)F_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(Lf / F_T, splits);
    f32_sum_kernel<<<grid, THREADS, F_SMEM, s>>>(
        static_cast<const float*>(fixed_t), static_cast<const float*>(strm_t),
        static_cast<const float*>(w), static_cast<float*>(part), Lf, Ls, per);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(out), splits,
                       (size_t)Lf, s);
}

}  // extern "C"
