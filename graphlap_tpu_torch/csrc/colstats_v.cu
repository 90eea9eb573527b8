// K9, K10 — the V passes of the spectral eigensolve: every kernel tile
// k(p, j) = exp(-d2(f_Ap, f_j)) is recomputed from the bf16 features, never
// stored in device memory.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K10 colstats_v_pallas      (_colstats_kernel), plain precision class
//         k_j   = bf16(exp(-max(na + nb_j - 2 cross, 0)))        (f32 exp)
//         V_j   = bf16(k_j bf16(c_j))^T bf16(gr);  norms += V_j^2;  coeffs += y_j V_j
//   K9  finish_colstats_pallas (_finish_colstats_kernel), the fused finish's
//       second sweep: K10 with c_j the post-polish scale
//         ks_j  = k_j^T bf16(t);  c_j = s_j = sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j
// with the Pallas rounding points. cross comes from bf16 x bf16 tensor-core
// products with f32 accumulation (mma.sync m16n8k16) of the plain fa (zero
// lanes beyond d) against the aug-superset f_t, the feature depth is 32, and
// the f32 norms arrive precomputed.
//
// What bounds them on an H100, at the 8 MP shape (p_pad 4096, N 8388608, V
// width 64): 3.4e10 tile entries, one exp each — one MUFU ex2 an entry at 16
// a clock an SM is 8.2 ms at 132 SMs and 1.98 GHz, the bound. The exp is
// that ex2 after one FMUL (kexp: the entry is rounded to bf16, so a full
// expf's ~8 FP32 instructions buy nothing), plus ~6 more (max, two bf16
// roundings, the column scale, pack): ~7 ms of FP32-pipe issue; the
// tensor-core work (2.2 TFLOP of cross, 4.4 TFLOP of V at width 64) is
// ~6.7 ms at the bf16 peak, and memory (features 0.5 GB, V 2.1 GB) ~0.8 ms. K9's function needs each
// entry's exp once (the Pallas kernel keeps the whole p tile resident for
// that); K9 here computes it twice, once a pass.
//
// Design. Two kernels share the tile: the stage loader, the warp's column
// fragments (warp_cols) and the 16-row step that forms the cross and its exp
// epilogue (tile_step). K10 is the V pass alone; K9 is a ks pass, then the
// same V pass with c = bf16(s).
//   * A 256-thread block owns a tile of 256 pixel columns, each warp 32 of
//     them (two 16-column A fragments of f_t held in registers, with their nb
//     and the column scale).
//   * The block walks p in stages of 64 sample rows: the fa rows, na, and
//     the bf16 gr^T rows (or, in the ks pass, bf16(t)) of the next stage
//     arrive in shared memory by cp.async while the current stage runs
//     (double buffering).
//   * Per 16 sample rows a warp forms the cross on the tensor cores (two mma
//     a 16 x 8 sub-tile) and runs the exp epilogue (kexp) on the
//     accumulator registers. The accumulator layout is the A-fragment
//     layout, so the packed bf16(k bf16(c)) tile times bf16(gr) is one more
//     mma per 8 V columns. The H100's f32 tensor-core accumulation rounds
//     toward zero, so the warp's (32 x m) V block sums in registers over
//     spans of 4 stages (256 rows, 16 mma steps) from zero, and each span is
//     added to the running V, held in shared memory (64 KB a block at
//     width 64, still two blocks an SM), with an f32 add; one chain over
//     all of p (256 steps at p 4096) left V low on ~85% of its entries.
//   * K9's ks pass multiplies the packed bf16(k) by [bf16(t), 0, ...], one
//     mma a 16-row step, summing its columns' ks in registers over a stage
//     and the stages' sums over all of p (a two-level f32 sum keeps ks
//     close to the plain version's, so fewer bf16(s) land on the other
//     neighbour), then writes s and bf16(s). A column's ks never leaves its warp, so no
//     cluster and no cross-block exchange exist: the Pallas kernel's whole-p
//     residency becomes a second exp of each entry. Holding no V, the pass
//     runs three blocks an SM with two 16-row steps in flight.
//   * V is written once; norms and coeffs go through a shuffle tree over the
//     warp, per-warp shared-memory slots, per-block partials and the
//     fixed-order reduction kernel — no float atomics, so runs repeat bit for
//     bit.
//   * Blocks are persistent (as many as fit the card at once), each walking
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
constexpr int KS_BLOCKS_SM = 3;     // ks-pass blocks an SM: it holds no V accumulators

// a launch's operands; K10 reads cb, K9's ks pass tb, s_pre, bm and writes
// s_out and cb
struct VArgs {
  const bf16* fa;     // (P, 32) plain
  const bf16* ft;     // (32, N) aug superset
  const bf16* grt;    // (MP, P) bf16(gr)^T
  const bf16* cb;     // (N) bf16(c)
  const bf16* tb;     // (P) bf16(t)                          K9
  const float* s_pre; // (N)                                  K9
  const float* bm;    // (N)                                  K9
  const float* y;     // (N)
  const float* na;    // (P)
  const float* nb;    // (N)
  float* v_out;       // (N, MP)
  float* s_out;       // (N)                                  K9
  bf16* cb_out;       // (N) bf16(s)                          K9
  float* part;        // (gridDim.x, 2, MP) norms, coeffs
  int P, N;
};

// out[i] = bf16(kexp(d2[i])): the tile entry alone, for checking its exp
__global__ void kexp_kernel(const float* __restrict__ d2, bf16* __restrict__ out, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(kexp(d2[i]));
}

// the stage of sample rows [p0, p0 + TP): fa rows, na, and mp bf16 gr^T
// rows (the V pass) or bf16(t) (K9's ks pass); one cp.async commit group
__device__ __forceinline__ void load_stage(bf16* fa_d, bf16* gr_d, float* na_d, bf16* t_d,
                                           const VArgs& a, int mp, int p0) {
  // the loops stay rolled: their addresses are recomputed a stage at a
  // time, not held in registers over the pass (the V pass at width 64 has
  // none to spare)
#pragma unroll 1
  for (int c = threadIdx.x; c < TP * (FD / 8); c += THREADS) {
    const int r = c / (FD / 8), q = c % (FD / 8);
    cp_async16(fa_d + r * LDF + q * 8, a.fa + (size_t)(p0 + r) * FD + q * 8);
  }
  if (t_d != nullptr && (int)threadIdx.x < TP / 8)
    cp_async16(t_d + threadIdx.x * 8, a.tb + p0 + threadIdx.x * 8);
#pragma unroll 1
  for (int c = threadIdx.x; c < mp * (TP / 8); c += THREADS) {
    const int m = c / (TP / 8), q = c % (TP / 8);
    cp_async16(gr_d + m * LDG + q * 8, a.grt + (size_t)m * a.P + p0 + q * 8);
  }
  if ((int)threadIdx.x < TP / 4) cp_async16(na_d + threadIdx.x * 4, a.na + p0 + threadIdx.x * 4);
  cp_async_commit();
}

// the warp's two 16-column A fragments of f_t (columns jw..jw+31) and nb
__device__ __forceinline__ void warp_cols(uint32_t af[CT][2][4], float nbv[CT][2],
                                          const VArgs& a, int jw, int g, int tq) {
  const unsigned short* fu = reinterpret_cast<const unsigned short*>(a.ft);
#pragma unroll
  for (int ct = 0; ct < CT; ++ct) {
    frag_a_kmajor(af[ct][0], fu, (size_t)a.N, jw + 16 * ct, 0, g, tq);
    frag_a_kmajor(af[ct][1], fu, (size_t)a.N, jw + 16 * ct, 16, g, tq);
    nbv[ct][0] = a.nb[jw + 16 * ct + g];
    nbv[ct][1] = a.nb[jw + 16 * ct + g + 8];
  }
}

// rows [r0, r0 + 16) of the warp's tile as A fragments (16 columns x 16
// rows) of bf16(k bf16(c)), or of k = bf16(exp(..)) unscaled (SCALED false,
// K9's ks pass): the cross on the tensor cores (two mma a 16 x 8 sub-tile),
// then the exp epilogue (kexp) on the accumulator registers, whose layout is
// the A-fragment layout
template <bool SCALED>
__device__ __forceinline__ void tile_step(uint32_t ka[CT][4], const bf16* fs, const float* ns,
                                          int r0, const uint32_t af[CT][2][4],
                                          const float nbv[CT][2], const float cbv[CT][2],
                                          int g, int tq) {
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
#pragma unroll
  for (int ct = 0; ct < CT; ++ct)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(c, af[ct][0], bf[h][0]);
      mma16816(c, af[ct][1], bf[h][1]);
      const float e0 = kexp(nav[h][0] + nbv[ct][0] - 2.f * c[0]);
      const float e1 = kexp(nav[h][1] + nbv[ct][0] - 2.f * c[1]);
      const float e2 = kexp(nav[h][0] + nbv[ct][1] - 2.f * c[2]);
      const float e3 = kexp(nav[h][1] + nbv[ct][1] - 2.f * c[3]);
      if (SCALED) {   // k rounded to bf16 (two at a time), times bf16(c), rounded
        const float2 k01 = unpack2(pack2(e0, e1)), k23 = unpack2(pack2(e2, e3));
        ka[ct][2 * h] = pack2(k01.x * cbv[ct][0], k01.y * cbv[ct][0]);
        ka[ct][2 * h + 1] = pack2(k23.x * cbv[ct][1], k23.y * cbv[ct][1]);
      } else {
        ka[ct][2 * h] = pack2(e0, e1);
        ka[ct][2 * h + 1] = pack2(e2, e3);
      }
    }
}

// the running V of a thread in shared memory: CT * NTM float4s, entry q of
// thread tid at q * THREADS + tid (consecutive threads, consecutive 16 B)
template <int NTM>
constexpr size_t run_smem_bytes() {
  return (size_t)CT * NTM * THREADS * 16;
}

// the V pass's spans: V_FLUSH stages (16 mma steps over 256 rows of p).
// Spans of 8 ran 2% faster but left V below its plain version on 0.77 of
// the entries of a small input (p 600, 100 V columns), outside the (0.25, 0.75)
// band that the tests and chip_smoke.py require.
constexpr int V_FLUSH = 4;

// The V pass. V's sum over p runs on the tensor cores, whose f32
// accumulation rounds toward zero: a chain of mma over all of p (256 steps
// at p 4096) ends low on most entries. So V sums in spans of V_FLUSH stages
// (the first mma of a span from a zero accumulator) and each span is added
// to the running V with an f32 add. The running V lives in dynamic shared
// memory, which keeps the pass at two blocks an SM.
template <int NTM>   // V width / 8
__global__ __launch_bounds__(THREADS, 2) void colstats_v_kernel(const VArgs a) {
  constexpr int MP = NTM * 8;
  __shared__ __align__(16) bf16 fa_s[2][TP * LDF];
  __shared__ __align__(16) bf16 gr_s[2][MP_MAX * LDG];
  __shared__ __align__(16) float na_s[2][TP];
  __shared__ float wp_s[WARPS][2][MP];          // per-warp norms, coeffs
  extern __shared__ float4 run_s[];             // CT * NTM * THREADS: the running V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / TN, nst = a.P / TP;

  for (int i = tid; i < WARPS * 2 * MP; i += THREADS) (&wp_s[0][0][0])[i] = 0.f;
  if ((int)blockIdx.x < ntiles) load_stage(fa_s[0], gr_s[0], na_s[0], nullptr, a, MP, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int jw = tile * TN + warp * CT * 16;   // this warp's first column
    uint32_t af[CT][2][4];
    float nbv[CT][2], cbv[CT][2];
    warp_cols(af, nbv, a, jw, g, tq);
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      cbv[ct][0] = __bfloat162float(a.cb[jw + 16 * ct + g]);
      cbv[ct][1] = __bfloat162float(a.cb[jw + 16 * ct + g + 8]);
    }
    float acc[CT][NTM][4];                      // the span's sum

    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();                 // stage in; everyone done with buf ^ 1
      if (s + 1 < nst)
        load_stage(fa_s[buf ^ 1], gr_s[buf ^ 1], na_s[buf ^ 1], nullptr, a, MP, (s + 1) * TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        load_stage(fa_s[buf ^ 1], gr_s[buf ^ 1], na_s[buf ^ 1], nullptr, a, MP, 0);
      const bf16* gs = gr_s[buf];
      const bool fresh = s % V_FLUSH == 0;       // a span starts here
      if (fresh) {
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
#pragma unroll
          for (int mt = 0; mt < NTM; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[ct][mt][e] = 0.f;
      }
#pragma unroll 1
      for (int r0 = 0; r0 < TP; r0 += 16) {
        uint32_t ka[CT][4];
        tile_step<true>(ka, fa_s[buf], na_s[buf], r0, af, nbv, cbv, g, tq);
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
      if ((s + 1) % V_FLUSH == 0 || s + 1 == nst) {   // the span into the running V
        const bool first = s < V_FLUSH;
#pragma unroll
        for (int ct = 0; ct < CT; ++ct)
#pragma unroll
          for (int mt = 0; mt < NTM; ++mt) {
            float4* q = run_s + (ct * NTM + mt) * THREADS + tid;
            float4 v = make_float4(acc[ct][mt][0], acc[ct][mt][1], acc[ct][mt][2],
                                   acc[ct][mt][3]);
            if (!first) {
              const float4 o = *q;
              v.x += o.x;
              v.y += o.y;
              v.z += o.z;
              v.w += o.w;
            }
            *q = v;
          }
      }
    }
    // the running V back into acc
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int mt = 0; mt < NTM; ++mt) {
        const float4 v = run_s[(ct * NTM + mt) * THREADS + tid];
        acc[ct][mt][0] = v.x;
        acc[ct][mt][1] = v.y;
        acc[ct][mt][2] = v.z;
        acc[ct][mt][3] = v.w;
      }

    // V out; this tile's norms and coeffs into the warp's slots
    float yv[CT][2];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int j = jw + 16 * ct + g;
      yv[ct][0] = a.y[j];
      yv[ct][1] = a.y[j + 8];
#pragma unroll
      for (int mt = 0; mt < NTM; ++mt) {
        const int m = mt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(a.v_out + (size_t)j * MP + m) =
            make_float2(acc[ct][mt][0], acc[ct][mt][1]);
        *reinterpret_cast<float2*>(a.v_out + (size_t)(j + 8) * MP + m) =
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
    a.part[(size_t)blockIdx.x * 2 * MP + tid] = acc;
  }
}

// K9's ks pass: the same tile (c = 1) times [bf16(t), 0, ...], one mma a
// 16-row step, summed in registers over all of p; then s and bf16(s) for
// the warp's columns
__global__ __launch_bounds__(THREADS, KS_BLOCKS_SM) void ks_kernel(const VArgs a) {
  __shared__ __align__(16) bf16 fa_s[2][TP * LDF];
  __shared__ __align__(16) bf16 t_s[2][TP];
  __shared__ __align__(16) float na_s[2][TP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / TN, nst = a.P / TP;

  if ((int)blockIdx.x < ntiles) load_stage(fa_s[0], nullptr, na_s[0], t_s[0], a, 0, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int jw = tile * TN + warp * CT * 16;
    uint32_t af[CT][2][4];
    float nbv[CT][2];
    warp_cols(af, nbv, a, jw, g, tq);
    float kt[CT][4];
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) kt[ct][e] = 0.f;
    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < nst)
        load_stage(fa_s[buf ^ 1], nullptr, na_s[buf ^ 1], t_s[buf ^ 1], a, 0, (s + 1) * TP);
      else if (tile + (int)gridDim.x < ntiles)
        load_stage(fa_s[buf ^ 1], nullptr, na_s[buf ^ 1], t_s[buf ^ 1], a, 0, 0);
      const bf16* ts = t_s[buf];
      float kst[CT][4];              // this stage's ks, then added to the total
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) kst[ct][e] = 0.f;
#pragma unroll 2             // two 16-row steps in flight
      for (int r0 = 0; r0 < TP; r0 += 16) {
        uint32_t ka[CT][4];
        tile_step<false>(ka, fa_s[buf], na_s[buf], r0, af, nbv, nbv, g, tq);  // no scale
        uint32_t b[2];
        b[0] = g == 0 ? ld32(ts + r0 + 2 * tq) : 0u;
        b[1] = g == 0 ? ld32(ts + r0 + 8 + 2 * tq) : 0u;
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) mma16816(kst[ct], ka[ct], b);
      }
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) kt[ct][e] += kst[ct][e];
    }
    // ks of columns g | g + 8 sits in lane tq = 0 (B column 0)
    if (tq == 0) {
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = jw + 16 * ct + g + 8 * h;
          const float sj = sqrtf(a.s_pre[j] / fmaxf(kt[ct][2 * h], EPS)) * a.bm[j];
          a.s_out[j] = sj;
          a.cb_out[j] = __float2bfloat16_rn(sj);
        }
    }
  }
}

template <int NTM>
int v_kernel_setup(size_t* smem) {
  *smem = run_smem_bytes<NTM>();
  cudaError_t e = cudaFuncSetAttribute(colstats_v_kernel<NTM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(colstats_v_kernel<NTM>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return static_cast<int>(e);
}

template <int NTM>
int resident_blocks(int* out) {
  int dev = 0, sms = 0, occ = 0;
  size_t smem = 0;
  int rc = v_kernel_setup<NTM>(&smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, colstats_v_kernel<NTM>, THREADS,
                                                      smem);
  *out = occ * sms;
  return static_cast<int>(e);
}

template <int NTM>
int launch_v_ntm(int blocks, cudaStream_t s, const VArgs& a) {
  size_t smem = 0;
  int rc = v_kernel_setup<NTM>(&smem);
  if (rc != 0) return rc;
  colstats_v_kernel<NTM><<<blocks, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the V pass for width MP, then the fixed-order reduction of its partials
int launch_v(int MP, int blocks, cudaStream_t s, const VArgs& a, void* norms_coeffs) {
  int rc;
  switch (MP) {
    case 16: rc = launch_v_ntm<2>(blocks, s, a); break;
    case 32: rc = launch_v_ntm<4>(blocks, s, a); break;
    case 48: rc = launch_v_ntm<6>(blocks, s, a); break;
    case 64: rc = launch_v_ntm<8>(blocks, s, a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return launch_reduce(a.part, static_cast<float*>(norms_coeffs), blocks, (size_t)2 * MP, s);
}

}  // namespace

extern "C" {

// how many V-pass blocks for width MP fit the card at once (the persistent
// grid of K10 and of K9's V pass); a negative value is a cudaError, 0 an
// unsupported MP
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
  VArgs a = {};
  a.fa = static_cast<const bf16*>(fa);
  a.ft = static_cast<const bf16*>(ft);
  a.grt = static_cast<const bf16*>(grt);
  a.cb = static_cast<const bf16*>(cb);
  a.y = static_cast<const float*>(y);
  a.na = static_cast<const float*>(na);
  a.nb = static_cast<const float*>(nb);
  a.v_out = static_cast<float*>(v_out);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  return launch_v(MP, blocks, reinterpret_cast<cudaStream_t>(stream), a, norms_coeffs);
}

// K9: the ks pass (s and bf16(s) into s_out, cb_out), then K10's V pass with
// c = s. Shapes as K10; tb (P) bf16, s_pre and bm (N) f32, cb_out (N) bf16.
int glt_finish_colstats(const void* fa, const void* ft, const void* grt, const void* tb,
                        const void* s_pre, const void* bm, const void* y, const void* na,
                        const void* nb, void* v_out, void* s_out, void* cb_out, void* part,
                        void* norms_coeffs, int P, int N, int MP, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  VArgs a = {};
  a.fa = static_cast<const bf16*>(fa);
  a.ft = static_cast<const bf16*>(ft);
  a.grt = static_cast<const bf16*>(grt);
  a.cb = static_cast<const bf16*>(cb_out);
  a.tb = static_cast<const bf16*>(tb);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.y = static_cast<const float*>(y);
  a.na = static_cast<const float*>(na);
  a.nb = static_cast<const float*>(nb);
  a.v_out = static_cast<float*>(v_out);
  a.s_out = static_cast<float*>(s_out);
  a.cb_out = static_cast<bf16*>(cb_out);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ks_kernel, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ks_blocks = occ * sms < N / TN ? occ * sms : N / TN;
  ks_kernel<<<ks_blocks, THREADS, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_v(MP, blocks, s, a, norms_coeffs);
}

// out = bf16(exp(-max(d2, 0))) with K9's and K10's exp (kexp), elementwise
// over n f32 values: a check of that exp against expf, on no path
int glt_kexp_bf16(const void* d2, void* out, size_t n, void* stream) {
  size_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 65536) blocks = 65536;
  kexp_kernel<<<(unsigned)blocks, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
