// K10 — the colstats + V pass of the unfused spectral eigensolve: every
// kernel tile k(p, j) = exp(-d2(f_Ap, f_j)) is recomputed from the bf16
// features, never stored in device memory.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K10 colstats_v_pallas (_colstats_kernel), plain precision class
//         k_j   = bf16(exp(-max(na + nb_j - 2 cross, 0)))        (f32 exp)
//         V_j   = bf16(k_j bf16(c_j))^T bf16(gr);  norms += V_j^2;  coeffs += y_j V_j
// with the Pallas rounding points. cross comes from bf16 x bf16 tensor-core
// products with f32 accumulation (mma.sync m16n8k16) of the plain fa (zero
// lanes beyond d) against the aug-superset f_t, the feature depth is 32, and
// the f32 norms arrive precomputed. It is K9 (recompute_sweeps.cu) without the
// column sum ks and the scale update, so no column needs the whole p before
// V, and no cluster is needed: each V row sums over all p rows, K6's shape
// with a (p, m) right-hand side.
//
// What bounds it on an H100, at the 8 MP shape (p_pad 4096, N 8388608, V
// width 64): 3.4e10 tile entries, each one expf (a MUFU ex2 plus ~8 FP32
// instructions) and ~6 more (max, two bf16 roundings, the column scale,
// pack): ~4-5e11 FP32-pipe instructions, ~12-15 ms of SIMT issue at 132 SMs;
// the tensor-core work (2.2 TFLOP of cross, 4.4 TFLOP of V at width 64) is
// ~6.7 ms at the bf16 peak, and memory (features 0.5 GB, V 2.1 GB) ~0.8 ms.
//
// Design:
//   * a 256-thread block owns a tile of 256 pixel columns, each warp 32 of
//     them (two 16-column A fragments of f_t held in registers, with their nb
//     and bf16(c));
//   * the block walks p in stages of 64 sample rows: the fa rows, na and the
//     bf16 gr^T rows of the next stage arrive in shared memory by cp.async
//     while the current stage runs (double buffering);
//   * per 16 sample rows a warp forms the cross on the tensor cores (two
//     mma a 16 x 8 sub-tile), runs the f32 epilogue on the accumulator
//     registers, and since the accumulator layout is the A-fragment layout,
//     the packed bf16(k bf16(c)) tile times bf16(gr) is one more mma per 8
//     V columns that keeps the warp's (32 x m) V block in registers over all
//     of p;
//   * V is written once; norms and coeffs go through a shuffle tree over the
//     warp, per-warp shared-memory slots, per-block partials and the
//     fixed-order reduction kernel — no float atomics, so runs repeat bit for
//     bit;
//   * blocks are persistent (as many as fit the card at once), each walking
//     the column tiles in a fixed stride order, so the partials number one
//     per resident block.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() (or the first error).

#include "mma_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FD = 32;              // feature depth
constexpr int LDF = FD + 8;         // fa_s row stride (bf16): conflict-free B fragments
constexpr int CT = 2;               // 16-column tiles a warp
constexpr int TN = WARPS * CT * 16; // columns a block tile (256)
constexpr int TP = 64;              // sample rows a stage
constexpr int LDG = TP + 8;         // gr_s row stride (bf16): conflict-free B fragments
constexpr int MP_MAX = 64;          // widest V a launch holds in registers

// the stage of sample rows [p0, p0 + TP): fa rows, bf16 gr^T rows, na
__device__ __forceinline__ void load_stage(bf16* fa_d, bf16* gr_d, float* na_d,
                                           const bf16* __restrict__ fa,
                                           const bf16* __restrict__ grt,
                                           const float* __restrict__ na, int P, int mp,
                                           int p0) {
  for (int c = threadIdx.x; c < TP * (FD / 8); c += THREADS) {
    const int r = c / (FD / 8), q = c % (FD / 8);
    cp_async16(fa_d + r * LDF + q * 8, fa + (size_t)(p0 + r) * FD + q * 8);
  }
  for (int c = threadIdx.x; c < mp * (TP / 8); c += THREADS) {
    const int m = c / (TP / 8), q = c % (TP / 8);
    cp_async16(gr_d + m * LDG + q * 8, grt + (size_t)m * P + p0 + q * 8);
  }
  if ((int)threadIdx.x < TP / 4) cp_async16(na_d + threadIdx.x * 4, na + p0 + threadIdx.x * 4);
  cp_async_commit();
}

template <int NTM>   // V width / 8
__global__ __launch_bounds__(THREADS, 2) void colstats_v_kernel(
    const bf16* __restrict__ fa,    // (P, 32) plain
    const bf16* __restrict__ ft,    // (32, N) aug superset
    const bf16* __restrict__ grt,   // (MP, P) bf16(gr)^T
    const bf16* __restrict__ cb,    // (N) bf16(c)
    const float* __restrict__ y,    // (N)
    const float* __restrict__ na,   // (P)
    const float* __restrict__ nb,   // (N)
    float* __restrict__ v_out,      // (N, MP)
    float* __restrict__ part,       // (gridDim.x, 2, MP) norms, coeffs
    int P, int N) {
  constexpr int MP = NTM * 8;
  __shared__ __align__(16) bf16 fa_s[2][TP * LDF];
  __shared__ __align__(16) bf16 gr_s[2][MP_MAX * LDG];
  __shared__ __align__(16) float na_s[2][TP];
  __shared__ float wp_s[WARPS][2][MP];          // per-warp norms, coeffs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = N / TN, nst = P / TP;
  const unsigned short* fu = reinterpret_cast<const unsigned short*>(ft);

  for (int i = tid; i < WARPS * 2 * MP; i += THREADS) (&wp_s[0][0][0])[i] = 0.f;
  if ((int)blockIdx.x < ntiles) load_stage(fa_s[0], gr_s[0], na_s[0], fa, grt, na, P, MP, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int jw = tile * TN + warp * CT * 16;   // this warp's first column
    uint32_t af[CT][2][4];
    float nbv[CT][2], cbv[CT][2];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int j = jw + 16 * ct + g;
      frag_a_kmajor(af[ct][0], fu, (size_t)N, jw + 16 * ct, 0, g, tq);
      frag_a_kmajor(af[ct][1], fu, (size_t)N, jw + 16 * ct, 16, g, tq);
      nbv[ct][0] = nb[j];
      nbv[ct][1] = nb[j + 8];
      cbv[ct][0] = __bfloat162float(cb[j]);
      cbv[ct][1] = __bfloat162float(cb[j + 8]);
    }
    float acc[CT][NTM][4];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int mt = 0; mt < NTM; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ct][mt][e] = 0.f;

    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();                 // stage in; everyone done with buf ^ 1
      if (s + 1 < nst)
        load_stage(fa_s[buf ^ 1], gr_s[buf ^ 1], na_s[buf ^ 1], fa, grt, na, P, MP,
                   (s + 1) * TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        load_stage(fa_s[buf ^ 1], gr_s[buf ^ 1], na_s[buf ^ 1], fa, grt, na, P, MP, 0);
      const bf16* fs = fa_s[buf];
      const bf16* gs = gr_s[buf];
      const float* ns = na_s[buf];
#pragma unroll 1
      for (int r0 = 0; r0 < TP; r0 += 16) {
        uint32_t bf[2][2][2];          // [8-row n-tile][k half]
        float nav[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            bf[h][kh][0] = ld32(fs + (r + g) * LDF + 16 * kh + 2 * tq);
            bf[h][kh][1] = ld32(fs + (r + g) * LDF + 16 * kh + 8 + 2 * tq);
          }
          nav[h][0] = ns[r + 2 * tq];
          nav[h][1] = ns[r + 2 * tq + 1];
        }
        // the column-scaled tile as A fragments: (16 columns x 16 rows)
        uint32_t ka[CT][4];
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma16816(c, af[ct][0], bf[h][0]);
            mma16816(c, af[ct][1], bf[h][1]);
            const float k0 = rbf(expf(-fmaxf(nav[h][0] + nbv[ct][0] - 2.f * c[0], 0.f)));
            const float k1 = rbf(expf(-fmaxf(nav[h][1] + nbv[ct][0] - 2.f * c[1], 0.f)));
            const float k2 = rbf(expf(-fmaxf(nav[h][0] + nbv[ct][1] - 2.f * c[2], 0.f)));
            const float k3 = rbf(expf(-fmaxf(nav[h][1] + nbv[ct][1] - 2.f * c[3], 0.f)));
            ka[ct][2 * h] = pack2(k0 * cbv[ct][0], k1 * cbv[ct][0]);
            ka[ct][2 * h + 1] = pack2(k2 * cbv[ct][1], k3 * cbv[ct][1]);
          }
        // V += tile^T bf16(gr): one mma per 8 V columns and column tile
#pragma unroll
        for (int mt = 0; mt < NTM; ++mt) {
          uint32_t b[2];
          b[0] = ld32(gs + (mt * 8 + g) * LDG + r0 + 2 * tq);
          b[1] = ld32(gs + (mt * 8 + g) * LDG + r0 + 8 + 2 * tq);
#pragma unroll
          for (int ct = 0; ct < CT; ++ct) mma16816(acc[ct][mt], ka[ct], b);
        }
      }
    }

    // V out; this tile's norms and coeffs into the warp's slots
    float yv[CT][2];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int j = jw + 16 * ct + g;
      yv[ct][0] = y[j];
      yv[ct][1] = y[j + 8];
#pragma unroll
      for (int mt = 0; mt < NTM; ++mt) {
        const int m = mt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(v_out + (size_t)j * MP + m) =
            make_float2(acc[ct][mt][0], acc[ct][mt][1]);
        *reinterpret_cast<float2*>(v_out + (size_t)(j + 8) * MP + m) =
            make_float2(acc[ct][mt][2], acc[ct][mt][3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < NTM; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float nn = 0.f, cc = 0.f;
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          const float v0 = acc[ct][mt][e], v1 = acc[ct][mt][2 + e];
          nn = fmaf(v1, v1, fmaf(v0, v0, nn));
          cc = fmaf(yv[ct][1], v1, fmaf(yv[ct][0], v0, cc));
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {   // over g: a fixed tree
          nn += __shfl_xor_sync(0xffffffffu, nn, off);
          cc += __shfl_xor_sync(0xffffffffu, cc, off);
        }
        if (g == 0) {
          wp_s[warp][0][mt * 8 + 2 * tq + e] += nn;
          wp_s[warp][1][mt * 8 + 2 * tq + e] += cc;
        }
      }
  }
  __syncthreads();
  if (tid < 2 * MP) {                 // warps in order
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += wp_s[w][tid / MP][tid % MP];
    part[(size_t)blockIdx.x * 2 * MP + tid] = acc;
  }
}

template <int NTM>
int resident_blocks(int* out) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, colstats_v_kernel<NTM>, THREADS, 0);
  *out = occ * sms;
  return static_cast<int>(e);
}

template <int NTM>
void launch(int blocks, cudaStream_t s, const void* fa, const void* ft, const void* grt,
            const void* cb, const void* y, const void* na, const void* nb, void* v_out,
            void* part, int P, int N) {
  colstats_v_kernel<NTM><<<blocks, THREADS, 0, s>>>(
      static_cast<const bf16*>(fa), static_cast<const bf16*>(ft),
      static_cast<const bf16*>(grt), static_cast<const bf16*>(cb),
      static_cast<const float*>(y), static_cast<const float*>(na),
      static_cast<const float*>(nb), static_cast<float*>(v_out), static_cast<float*>(part), P,
      N);
}

}  // namespace

extern "C" {

// how many K10 blocks for V width MP fit the card at once (the persistent
// grid); a negative value is a cudaError, 0 an unsupported MP
int glt_colstats_v_blocks(int MP) {
  int n = 0, rc;
  switch (MP) {
    case 16: rc = resident_blocks<2>(&n); break;
    case 32: rc = resident_blocks<4>(&n); break;
    case 48: rc = resident_blocks<6>(&n); break;
    case 64: rc = resident_blocks<8>(&n); break;
    default: return 0;
  }
  return rc != 0 ? -rc : n;
}

// K10. P % 64 == 0, N % 256 == 0, MP in {16, 32, 48, 64} (the wrapper
// checks); part holds (blocks, 2, MP) floats, norms_coeffs (2, MP).
int glt_colstats_v(const void* fa, const void* ft, const void* grt, const void* cb,
                   const void* y, const void* na, const void* nb, void* v_out, void* part,
                   void* norms_coeffs, int P, int N, int MP, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (MP) {
    case 16: launch<2>(blocks, s, fa, ft, grt, cb, y, na, nb, v_out, part, P, N); break;
    case 32: launch<4>(blocks, s, fa, ft, grt, cb, y, na, nb, v_out, part, P, N); break;
    case 48: launch<6>(blocks, s, fa, ft, grt, cb, y, na, nb, v_out, part, P, N); break;
    case 64: launch<8>(blocks, s, fa, ft, grt, cb, y, na, nb, v_out, part, P, N); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(norms_coeffs),
                       blocks, (size_t)2 * MP, s);
}

}  // extern "C"
