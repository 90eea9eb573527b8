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
// the f32 norms arrive precomputed. The f32 layouts (the bilateral recipes)
// take kernels of their own at the end of the file (colstats_f32_kernel,
// ks_f32_kernel): every value f32, V in f32 FFMA.
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
//     mma a 16-row step from a zero accumulator, summing its columns' ks in
//     registers over a stage by f32 adds and the stages' sums over all of p
//     (a two-level f32 sum keeps ks close to the plain version's, so fewer
//     bf16(s) land on the other neighbour), then writes s and bf16(s). A column's ks never leaves its warp, so no
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
// The bf16 kernels take the feature depth FD as a template parameter: 32
// (NLM 5 x 5, d 25) or 64 (NLM 7 x 7, d 49). So do the f32 kernels, through
// their live-lane count LV (below).
template <int FD>
constexpr int LDF_OF = FD + 8;      // fa_s row stride (bf16): conflict-free B fragments
constexpr int CT = 2;               // 16-column tiles a warp
constexpr int TN = WARPS * CT * 16; // columns a block tile (256)
constexpr int TP = 64;              // sample rows a stage
constexpr int LDG = TP + 8;         // gr_s row stride (bf16): conflict-free B fragments
constexpr int MP_MAX = 64;          // widest V a launch holds in registers
constexpr int KS_BLOCKS_SM = 3;     // ks-pass blocks an SM: it holds no V accumulators

// a launch's operands; K10 reads cb, K9's ks pass tb, s_pre, bm and writes
// s_out and cb
struct VArgs {
  const bf16* fa;     // (P, FD) plain
  const bf16* ft;     // (FD, N) aug superset
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
template <int FD>
__device__ __forceinline__ void load_stage(bf16* fa_d, bf16* gr_d, float* na_d, bf16* t_d,
                                           const VArgs& a, int mp, int p0) {
  // the loops stay rolled: their addresses are recomputed a stage at a
  // time, not held in registers over the pass (the V pass at width 64 has
  // none to spare)
#pragma unroll 1
  for (int c = threadIdx.x; c < TP * (FD / 8); c += THREADS) {
    const int r = c / (FD / 8), q = c % (FD / 8);
    cp_async16(fa_d + r * LDF_OF<FD> + q * 8, a.fa + (size_t)(p0 + r) * FD + q * 8);
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

// the warp's two 16-column A fragments of f_t (columns jw..jw+31), a k16
// step each FD / 16, and nb
template <int FD>
__device__ __forceinline__ void warp_cols(uint32_t af[CT][FD / 16][4], float nbv[CT][2],
                                          const VArgs& a, int jw, int g, int tq) {
  const unsigned short* fu = reinterpret_cast<const unsigned short*>(a.ft);
#pragma unroll
  for (int ct = 0; ct < CT; ++ct) {
#pragma unroll
    for (int ks = 0; ks < FD / 16; ++ks)
      frag_a_kmajor(af[ct][ks], fu, (size_t)a.N, jw + 16 * ct, 16 * ks, g, tq);
    nbv[ct][0] = a.nb[jw + 16 * ct + g];
    nbv[ct][1] = a.nb[jw + 16 * ct + g + 8];
  }
}

// rows [r0, r0 + 16) of the warp's tile as A fragments (16 columns x 16
// rows) of bf16(k bf16(c)), or of k = bf16(exp(..)) unscaled (SCALED false,
// K9's ks pass): the cross on the tensor cores (FD / 16 mma a 16 x 8
// sub-tile, one chain from zero), then the exp epilogue (kexp) on the
// accumulator registers, whose layout is the A-fragment layout
template <int FD, bool SCALED>
__device__ __forceinline__ void tile_step(uint32_t ka[CT][4], const bf16* fs, const float* ns,
                                          int r0, const uint32_t af[CT][FD / 16][4],
                                          const float nbv[CT][2], const float cbv[CT][2],
                                          int g, int tq) {
  constexpr int KS = FD / 16, LDF = LDF_OF<FD>;
  uint32_t bf[2][KS][2];         // [8-row n-tile][k16 step]
  float nav[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int kh = 0; kh < KS; ++kh) {
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
#pragma unroll
      for (int kh = 0; kh < KS; ++kh) mma16816(c, af[ct][kh], bf[h][kh]);
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

// the V pass's two stages of fa rows: static shared memory up to 64 lanes;
// past it (35 KB at 128 lanes) they would take the static part past its
// 48 KB, so they follow the running V in dynamic shared memory
template <int FD>
constexpr bool FA_DYN = FD > 64;
template <int FD>
constexpr size_t fa_stage_bytes() {
  return sizeof(bf16) * 2 * TP * LDF_OF<FD>;
}
template <int NTM, int FD>
constexpr size_t v_smem_bytes() {
  return run_smem_bytes<NTM>() + (FA_DYN<FD> ? fa_stage_bytes<FD>() : 0);
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
// memory, which keeps the pass at two blocks an SM at 32 lanes. At 64 the
// f_t fragments take 32 registers a thread, not 16, beside V's 64: the
// pass runs one block an SM with the registers of two. At 96 and 128 they
// take 48 and 64, and the fa stages move to dynamic shared memory (FA_DYN).
template <int NTM, int FD>   // V width / 8, feature depth
__global__ __launch_bounds__(THREADS, FD == 32 ? 2 : 1) void colstats_v_kernel(const VArgs a) {
  constexpr int MP = NTM * 8, FA_STAGE = TP * LDF_OF<FD>;
  __shared__ __align__(16) bf16 fa_st[FA_DYN<FD> ? 8 : 2 * FA_STAGE];
  __shared__ __align__(16) bf16 gr_s[2][MP_MAX * LDG];
  __shared__ __align__(16) float na_s[2][TP];
  __shared__ float wp_s[WARPS][2][MP];          // per-warp norms, coeffs
  extern __shared__ float4 run_s[];             // CT * NTM * THREADS: the running V
  // [2][FA_STAGE] the stages' fa rows
  bf16* const fa_s = FA_DYN<FD> ? reinterpret_cast<bf16*>(run_s + CT * NTM * THREADS) : fa_st;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / TN, nst = a.P / TP;

  for (int i = tid; i < WARPS * 2 * MP; i += THREADS) (&wp_s[0][0][0])[i] = 0.f;
  if ((int)blockIdx.x < ntiles) load_stage<FD>(fa_s, gr_s[0], na_s[0], nullptr, a, MP, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int jw = tile * TN + warp * CT * 16;   // this warp's first column
    uint32_t af[CT][FD / 16][4];
    float nbv[CT][2], cbv[CT][2];
    warp_cols<FD>(af, nbv, a, jw, g, tq);
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
        load_stage<FD>(fa_s + (buf ^ 1) * FA_STAGE, gr_s[buf ^ 1], na_s[buf ^ 1], nullptr, a, MP,
                       (s + 1) * TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        load_stage<FD>(fa_s + (buf ^ 1) * FA_STAGE, gr_s[buf ^ 1], na_s[buf ^ 1], nullptr, a, MP,
                       0);
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
        tile_step<FD, true>(ka, fa_s + buf * FA_STAGE, na_s[buf], r0, af, nbv, cbv, g, tq);
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
// the warp's columns. At 64 lanes, two blocks an SM (its f_t fragments
// double). Each 16-row step's ks starts from a zero accumulator and joins
// the stage's sum by an f32 add, and each stage's sum the column's: with a
// stage's ks one truncating mma chain, s lay above its plain version on
// 0.60 of the columns where they differ (0.52 now; scripts/finish_repairs.py,
// PERF.md). The cross stays one chain: in spans too it moved that share by
// under 0.01 and cost 4-5% more (NVIDIA H100 80GB HBM3, 700 W). Where an
// f32 s lies on a bf16 rounding boundary,
// bf16(s) lands on either neighbour whatever the sum order, and scales its
// whole V row by one bf16 ulp: that, not a lean, sets V's error against
// the plain version. Past 64 lanes one block an SM: the f_t fragments take
// 48 and 64 registers
template <int FD>
__global__ __launch_bounds__(THREADS, FD == 32 ? KS_BLOCKS_SM : FD == 64 ? 2 : 1) void ks_kernel(
    const VArgs a) {
  __shared__ __align__(16) bf16 fa_s[2][TP * LDF_OF<FD>];
  __shared__ __align__(16) bf16 t_s[2][TP];
  __shared__ __align__(16) float na_s[2][TP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / TN, nst = a.P / TP;

  if ((int)blockIdx.x < ntiles) load_stage<FD>(fa_s[0], nullptr, na_s[0], t_s[0], a, 0, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int jw = tile * TN + warp * CT * 16;
    uint32_t af[CT][FD / 16][4];
    float nbv[CT][2];
    warp_cols<FD>(af, nbv, a, jw, g, tq);
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
        load_stage<FD>(fa_s[buf ^ 1], nullptr, na_s[buf ^ 1], t_s[buf ^ 1], a, 0, (s + 1) * TP);
      else if (tile + (int)gridDim.x < ntiles)
        load_stage<FD>(fa_s[buf ^ 1], nullptr, na_s[buf ^ 1], t_s[buf ^ 1], a, 0, 0);
      const bf16* ts = t_s[buf];
      float kst[CT][4];              // this stage's ks, then added to the total
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) kst[ct][e] = 0.f;
#pragma unroll 2             // two 16-row steps in flight
      for (int r0 = 0; r0 < TP; r0 += 16) {
        uint32_t ka[CT][4];
        tile_step<FD, false>(ka, fa_s[buf], na_s[buf], r0, af, nbv, nbv, g, tq);  // no scale
        uint32_t b[2];
        b[0] = g == 0 ? ld32(ts + r0 + 2 * tq) : 0u;
        b[1] = g == 0 ? ld32(ts + r0 + 8 + 2 * tq) : 0u;
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(c, ka[ct], b);
#pragma unroll
          for (int e = 0; e < 4; ++e) kst[ct][e] += c[e];
        }
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

template <int NTM, int FD>
int v_kernel_setup(size_t* smem) {
  *smem = v_smem_bytes<NTM, FD>();
  cudaError_t e = cudaFuncSetAttribute(colstats_v_kernel<NTM, FD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(colstats_v_kernel<NTM, FD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return static_cast<int>(e);
}

template <int NTM, int FD>
int resident_blocks(int* out) {
  int dev = 0, sms = 0, occ = 0;
  size_t smem = 0;
  int rc = v_kernel_setup<NTM, FD>(&smem);
  if (rc != 0) return rc;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, colstats_v_kernel<NTM, FD>, THREADS,
                                                      smem);
  *out = occ * sms;
  return static_cast<int>(e);
}

template <int NTM, int FD>
int launch_v_ntm(int blocks, cudaStream_t s, const VArgs& a) {
  size_t smem = 0;
  int rc = v_kernel_setup<NTM, FD>(&smem);
  if (rc != 0) return rc;
  colstats_v_kernel<NTM, FD><<<blocks, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the V pass for width MP at feature depth FD
template <int FD>
int launch_v_fd(int MP, int blocks, cudaStream_t s, const VArgs& a) {
  switch (MP) {
    case 16: return launch_v_ntm<2, FD>(blocks, s, a);
    case 32: return launch_v_ntm<4, FD>(blocks, s, a);
    case 48: return launch_v_ntm<6, FD>(blocks, s, a);
    case 64: return launch_v_ntm<8, FD>(blocks, s, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the V pass for width MP and fd lanes, then the fixed-order reduction of
// its partials
int launch_v(int MP, int fd, int blocks, cudaStream_t s, const VArgs& a, void* norms_coeffs) {
  const int rc = fd == 32    ? launch_v_fd<32>(MP, blocks, s, a)
                 : fd == 64  ? launch_v_fd<64>(MP, blocks, s, a)
                 : fd == 96  ? launch_v_fd<96>(MP, blocks, s, a)
                 : fd == 128 ? launch_v_fd<128>(MP, blocks, s, a)
                             : static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return launch_reduce(a.part, static_cast<float*>(norms_coeffs), blocks, (size_t)2 * MP, s);
}

// blocks a V pass for width MP of fd lanes keeps resident on the card
template <int FD>
int resident_blocks_fd(int MP, int* n) {
  switch (MP) {
    case 16: return resident_blocks<2, FD>(n);
    case 32: return resident_blocks<4, FD>(n);
    case 48: return resident_blocks<6, FD>(n);
    case 64: return resident_blocks<8, FD>(n);
    default: *n = 0; return 0;
  }
}

// K9's ks pass at feature depth FD, as many blocks as fit the card (at most
// one a column tile)
template <int FD>
int launch_ks(cudaStream_t s, const VArgs& a) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ks_kernel<FD>, THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ks_blocks = occ * sms < a.N / TN ? occ * sms : a.N / TN;
  ks_kernel<FD><<<ks_blocks, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32 layouts: the reference's "highest" class
// ---------------------------------------------------------------------------
//
// K10: V_j = (c_j k_j)^T gr, norms, coeffs; K9: ks_j = k_j^T t, s_j =
// sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j, then K10's pass with c = s. The
// entry is the f32 class (kf32: an f32 FFMA cross over the live lanes, the
// f32 norms passed in, expf), every product f32 and rounded to nearest, no
// bf16 rounding point. What bounds them at 8 MP (p_pad 4096, N 8388608, V
// width 64): V is 4.4e12 flop a launch, 65.7 ms of FFMA at the 67 TFLOP/s
// f32 peak, against the exps' 8.2 ms. V runs as f32 FFMA: on the tensor
// cores (split tf32, three passes, 26.7 ms at 494.7 TFLOP/s) the mma's
// accumulation truncates the products it aligns below its largest, and V
// leaned low on 0.89 of its entries whatever the span; split fp16 (13.3
// ms) flushed the tiny entries that a huge Sinkhorn scale c_j weighs
// (PERF.md section 6). Design of the V pass, an SGEMM on entries staged in
// shared memory:
//   * a 256-thread block owns a tile of 256 pixel columns and walks p in
//     stages of VB_TP rows (fa rows, na, gr rows by cp.async double
//     buffering);
//   * a stage first forms its entries, a thread a column (the cross from
//     the column's lanes in registers against the row's, broadcast from
//     shared memory), VB_TP independent chains a thread, into shared
//     memory as e_s[row][column] = k c_j;
//   * then V += e_s^T gr: a thread owns 4 columns x 16 V entries (64
//     accumulators); a row is one 16-byte load of its 4 entries, four of
//     its 16 gr values (conflict-free or broadcast) and 64 FFMA: 47% of
//     the f32 peak at 8 MP. The first design, a thread a column with its
//     entry formed in the FFMA loop, ran at 37% (16 loads a 64 FFMA, or 8
//     with two columns a thread, the same);
//   * V sums over spans of VB_SPAN stages (256 rows) from zero, each added
//     to the running V in shared memory with one f32 add;
//   * the V width is 64 a launch (the wrapper pads gr with zero columns);
//     the live lanes LV are 4, or the layout's depth for wider features:
//     32 (a 5 x 5 patch and the coordinates), 64 (a 7 x 7 patch and the
//     coordinates, 52 live), 96 or 128 (9 x 9 or 11 x 11, 84 or 124 live);
//     the pad lanes are zero, so the extra lanes add exact zeros. The
//     layout's depth is 32 for LV 4 and 32, else LV (FD_OF). Up to 64
//     lanes a column's LV lanes stay in registers (float b[LV]): at 64
//     they sit beside the V pass's 64 accumulators under its 255-register
//     cap, and the ks pass, ~80 registers at 32 lanes and three blocks an
//     SM, takes two blocks an SM at 64 (128 registers a thread), so
//     neither spills (-Xptxas -v); an f_t tile in shared memory would read
//     the lanes again for each of a stage's rows. Past 64 lanes the ks
//     pass keeps them in registers, one block an SM, and the V pass takes
//     the wide design below (colstats_f32_wide_kernel);
//   * V is written once; norms and coeffs go through a shuffle tree, the
//     warps' slots, per-block partials and the fixed-order reduction; K9's
//     ks pass (a column a thread) sums a stage from zero, then adds it to
//     the column's total. Blocks are persistent and walk the column tiles
//     in a fixed stride order: runs repeat bit for bit.
constexpr int VF_THREADS = 256;           // ks pass: one column a thread
constexpr int VF_MP = 64;                 // V width a launch
constexpr int VF_TP = 32;                 // ks pass: sample rows a stage
template <int LV>
constexpr int FD_OF = LV <= 32 ? 32 : LV;    // the layout's depth for LV live lanes
template <int LV>
constexpr int VF_LDA_OF = FD_OF<LV> + 4;     // fa_s row stride (floats)
constexpr int VB_TN = 256;                // V pass: columns a block tile
constexpr int VB_TP = 16;                 // V pass: sample rows a stage
constexpr int VB_SPAN = 16;               // V pass: stages a span (256 rows)
constexpr int VB_LDE = VB_TN + 4;         // e_s row stride (floats)
constexpr int VB_CT = 4, VB_MT = 16;      // a thread's columns, V entries
constexpr size_t VF_RUN_BYTES = (size_t)VF_MP * VF_THREADS * 4;   // the running V

struct VF32Args {
  const float* fa;     // (P, FD) FD 32, 64, 96 or 128
  const float* ft;     // (FD, N)
  const float* gr;     // (P, 64) row-major
  const float* c;      // (N) column scale (K10), or K9's s
  const float* t;      // (P)                                  K9
  const float* s_pre;  // (N)                                  K9
  const float* bm;     // (N)                                  K9
  const float* y;      // (N)
  const float* na;     // (P)
  const float* nb;     // (N)
  float* v_out;        // (N, 64)
  float* s_out;        // (N)                                  K9
  float* part;         // (gridDim.x, 2, 64) norms, coeffs
  int P, N;
};

// the stage of rows [p0, p0 + TPR): fa rows (LV lanes), na, and gr rows
// (the V pass) or t (the ks pass); one cp.async commit group
template <int LV, int TPR>
__device__ __forceinline__ void load_stage_f32(float* fa_d, float* na_d, float* x_d,
                                               const VF32Args& a, bool v, int p0) {
#pragma unroll 1
  for (int c = threadIdx.x; c < TPR * (LV / 4); c += VF_THREADS) {
    const int r = c / (LV / 4), q = c % (LV / 4);
    cp_async16(fa_d + r * VF_LDA_OF<LV> + 4 * q, a.fa + (size_t)(p0 + r) * FD_OF<LV> + 4 * q);
  }
  if (threadIdx.x < TPR / 4) cp_async16(na_d + 4 * threadIdx.x, a.na + p0 + 4 * threadIdx.x);
  if (v) {
#pragma unroll 1
    for (int c = threadIdx.x; c < TPR * (VF_MP / 4); c += VF_THREADS)
      cp_async16(x_d + 4 * c, a.gr + (size_t)p0 * VF_MP + 4 * c);
  } else if (threadIdx.x < TPR / 4) {
    cp_async16(x_d + 4 * threadIdx.x, a.t + p0 + 4 * threadIdx.x);
  }
  cp_async_commit();
}

// the thread's column j: its LV lanes
template <int LV>
__device__ __forceinline__ void col_lanes(float (&b)[LV], const VF32Args& a, int j) {
#pragma unroll
  for (int k = 0; k < LV; ++k) b[k] = a.ft[(size_t)k * a.N + j];
}

// the entry of stage row r for the thread's column
template <int LV>
__device__ __forceinline__ float entry_f32(const float* fa_s, const float* na_s, int r,
                                           const float (&b)[LV], float nbv) {
  float cr = 0.f;
#pragma unroll
  for (int k = 0; k < LV; k += 4)
    cr = dot4(*reinterpret_cast<const float4*>(fa_s + r * VF_LDA_OF<LV> + k),
              make_float4(b[k], b[k + 1], b[k + 2], b[k + 3]), cr);
  return kf32(na_s[r] + nbv, cr);
}

template <int LV>
__global__ __launch_bounds__(VF_THREADS, LV == 4 ? 2 : 1) void colstats_f32_kernel(
    const VF32Args a) {
  __shared__ __align__(16) float fa_s[2][VB_TP * VF_LDA_OF<LV>];
  __shared__ __align__(16) float gr_s[2][VB_TP * VF_MP];
  __shared__ __align__(16) float na_s[2][VB_TP];
  __shared__ __align__(16) float e_s[VB_TP * VB_LDE];   // the stage's entries k c_j
  __shared__ float wp_s[VF_THREADS / 32][2][VF_MP];     // per-warp norms, coeffs
  extern __shared__ float vrun_s[];                     // [VB_CT * VB_MT][VF_THREADS] running V
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the GEMM's owner: columns 4 cg .. 4 cg + 3 and V entries 16 q + 4 mg
  // + i (q, i < 4), so a warp's four m groups read 64 contiguous bytes of
  // a gr row at once
  const int cg = warp * 8 + (lane >> 2), mg = lane & 3;
  const int ntiles = a.N / VB_TN, nst = a.P / VB_TP;

  for (int i = tid; i < (VF_THREADS / 32) * 2 * VF_MP; i += VF_THREADS)
    (&wp_s[0][0][0])[i] = 0.f;
  if ((int)blockIdx.x < ntiles)
    load_stage_f32<LV, VB_TP>(fa_s[0], na_s[0], gr_s[0], a, true, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = tile * VB_TN + tid;   // the column whose entries this thread forms
    float b[LV];
    col_lanes<LV>(b, a, j);
    const float nbv = a.nb[j], cv = a.c[j];
    float acc[VB_CT][VB_MT];
    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();                 // stage in; everyone done with buf ^ 1 and e_s
      if (s + 1 < nst)
        load_stage_f32<LV, VB_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], gr_s[buf ^ 1], a, true,
                                  (s + 1) * VB_TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        load_stage_f32<LV, VB_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], gr_s[buf ^ 1], a, true, 0);
#pragma unroll
      for (int r = 0; r < VB_TP; ++r)
        e_s[r * VB_LDE + tid] = entry_f32<LV>(fa_s[buf], na_s[buf], r, b, nbv) * cv;
      __syncthreads();                 // the stage's entries in
      if (s % VB_SPAN == 0) {
#pragma unroll
        for (int c = 0; c < VB_CT; ++c)
#pragma unroll
          for (int m = 0; m < VB_MT; ++m) acc[c][m] = 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < VB_TP; ++r) {
        const float4 ev = *reinterpret_cast<const float4*>(e_s + r * VB_LDE + 4 * cg);
        const float e[VB_CT] = {ev.x, ev.y, ev.z, ev.w};
        const float4* g = reinterpret_cast<const float4*>(gr_s[buf] + r * VF_MP + 4 * mg);
#pragma unroll
        for (int q = 0; q < VB_MT / 4; ++q) {
          const float4 gv = g[4 * q];
#pragma unroll
          for (int c = 0; c < VB_CT; ++c) {
            acc[c][4 * q] = fmaf(e[c], gv.x, acc[c][4 * q]);
            acc[c][4 * q + 1] = fmaf(e[c], gv.y, acc[c][4 * q + 1]);
            acc[c][4 * q + 2] = fmaf(e[c], gv.z, acc[c][4 * q + 2]);
            acc[c][4 * q + 3] = fmaf(e[c], gv.w, acc[c][4 * q + 3]);
          }
        }
      }
      if ((s + 1) % VB_SPAN == 0 || s + 1 == nst) {   // the span into the running V
        const bool first = s < VB_SPAN;
#pragma unroll
        for (int c = 0; c < VB_CT; ++c)
#pragma unroll
          for (int m = 0; m < VB_MT; ++m) {
            float* q = vrun_s + (c * VB_MT + m) * VF_THREADS + tid;
            *q = first ? acc[c][m] : *q + acc[c][m];
          }
      }
    }
    // V out; this tile's norms and coeffs into the warp's slots
    float yv[VB_CT];
#pragma unroll
    for (int c = 0; c < VB_CT; ++c) {
      const int jc = tile * VB_TN + 4 * cg + c;
      yv[c] = a.y[jc];
#pragma unroll
      for (int m = 0; m < VB_MT; ++m) acc[c][m] = vrun_s[(c * VB_MT + m) * VF_THREADS + tid];
      float4* vo = reinterpret_cast<float4*>(a.v_out + (size_t)jc * VF_MP + 4 * mg);
#pragma unroll
      for (int q = 0; q < VB_MT / 4; ++q)
        vo[4 * q] = make_float4(acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
                                acc[c][4 * q + 3]);
    }
#pragma unroll
    for (int m = 0; m < VB_MT; ++m) {
      float nn = 0.f, cc = 0.f;
#pragma unroll
      for (int c = 0; c < VB_CT; ++c) {
        nn = fmaf(acc[c][m], acc[c][m], nn);
        cc = fmaf(yv[c], acc[c][m], cc);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {   // over the warp's 8 column groups
        nn += __shfl_xor_sync(0xffffffffu, nn, off);
        cc += __shfl_xor_sync(0xffffffffu, cc, off);
      }
      if (lane < 4) {   // V entry 16 (m / 4) + 4 mg + m % 4
        wp_s[warp][0][16 * (m / 4) + 4 * mg + m % 4] += nn;
        wp_s[warp][1][16 * (m / 4) + 4 * mg + m % 4] += cc;
      }
    }
  }
  __syncthreads();
  if (tid < 2 * VF_MP) {              // warps in order
    float s = 0.f;
    for (int w = 0; w < VF_THREADS / 32; ++w) s += wp_s[w][tid / VF_MP][tid % VF_MP];
    a.part[(size_t)blockIdx.x * 2 * VF_MP + tid] = s;
  }
}

// The V pass past 64 lanes (an NLM 9 x 9 or 11 x 11 patch and the
// coordinates, 84 or 124 live lanes of 96 or 128). A column's lanes in
// registers beside the 64 accumulators would pass the 255-register cap,
// and a 256-column tile's lanes in shared memory (96 or 128 KB) beside the
// 64 KB running V pass a block's 227 KB. So the block tile is 128 columns,
// whose lanes sit in shared memory for the tile (bt_s[lane][column], 48 or
// 64 KB, loaded once a tile), and two threads a column form a stage's
// entries, 8 rows each, taking the column's lanes 32 at a time into
// registers: each entry's cross is still one FFMA chain over the lanes in
// order, entry_f32's. The GEMM: a thread owns 4 columns x 8 V entries (32
// accumulators), V entries 32 q + 4 mg + i (q < 2, i < 4), so a warp's 8 m
// groups read 128 contiguous bytes of a gr row; V sums in the same spans,
// into a running V of 32 KB. Per stage row a thread loads one float4 of
// entries and two of gr for 32 FFMA; the entries take one broadcast float4
// of fa and, a chunk of 32 lanes, 32 column lanes per 8 x 32 FFMA.
constexpr int VW_TN = 128;                // columns a block tile
constexpr int VW_LDE = VW_TN + 4;         // e_s row stride (floats)
constexpr int VW_LC = 32;                 // a column's lanes in registers at a time
constexpr int VW_MT = 8;                  // a thread's V entries
constexpr int VW_RH = VB_TP / 2;          // stage rows of a thread's entries
static_assert(VF_THREADS == 2 * VW_TN && VW_TN / VB_CT * VF_MP / VW_MT == VF_THREADS,
              "two threads a column; 4 columns x 8 V entries a thread");
template <int LV>
constexpr size_t VW_DYN_OF = sizeof(float) * ((size_t)VB_CT * VW_MT * VF_THREADS + (size_t)LV * VW_TN);

template <int LV>
__global__ __launch_bounds__(VF_THREADS, 1) void colstats_f32_wide_kernel(const VF32Args a) {
  constexpr int LDA = VF_LDA_OF<LV>;
  __shared__ __align__(16) float fa_s[2][VB_TP * LDA];
  __shared__ __align__(16) float gr_s[2][VB_TP * VF_MP];
  __shared__ __align__(16) float na_s[2][VB_TP];
  __shared__ __align__(16) float e_s[VB_TP * VW_LDE];   // the stage's entries k c_j
  __shared__ float wp_s[VF_THREADS / 32][2][VF_MP];     // per-warp norms, coeffs
  extern __shared__ __align__(16) float vw_smem[];
  float* vrun_s = vw_smem;                              // [VB_CT * VW_MT][VF_THREADS] running V
  float* bt_s = vw_smem + VB_CT * VW_MT * VF_THREADS;   // [LV][VW_TN] the tile's column lanes
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int jc = tid % VW_TN, rh = (tid / VW_TN) * VW_RH;   // entries: column, first row
  const int cg = tid / 8, mg = tid % 8;                     // GEMM: columns 4 cg .. 4 cg + 3
  const int ntiles = a.N / VW_TN, nst = a.P / VB_TP;

  for (int i = tid; i < (VF_THREADS / 32) * 2 * VF_MP; i += VF_THREADS)
    (&wp_s[0][0][0])[i] = 0.f;
  if ((int)blockIdx.x < ntiles)
    load_stage_f32<LV, VB_TP>(fa_s[0], na_s[0], gr_s[0], a, true, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // the tile's column lanes: every thread is past the last tile's entries
#pragma unroll 1
    for (int c = tid; c < LV * (VW_TN / 4); c += VF_THREADS) {
      const int k = c / (VW_TN / 4), q = c % (VW_TN / 4);
      cp_async16(bt_s + k * VW_TN + 4 * q, a.ft + (size_t)k * a.N + (size_t)tile * VW_TN + 4 * q);
    }
    cp_async_commit();
    const int j = tile * VW_TN + jc;    // the column whose entries this thread forms
    const float nbv = a.nb[j], cv = a.c[j];
    float acc[VB_CT][VW_MT];
    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();                 // stage (and lanes) in; everyone done with buf ^ 1, e_s
      if (s + 1 < nst)
        load_stage_f32<LV, VB_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], gr_s[buf ^ 1], a, true,
                                  (s + 1) * VB_TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        load_stage_f32<LV, VB_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], gr_s[buf ^ 1], a, true, 0);
      float cr[VW_RH];
#pragma unroll
      for (int r = 0; r < VW_RH; ++r) cr[r] = 0.f;
#pragma unroll 1
      for (int k0 = 0; k0 < LV; k0 += VW_LC) {
        float b[VW_LC];
#pragma unroll
        for (int k = 0; k < VW_LC; ++k) b[k] = bt_s[(k0 + k) * VW_TN + jc];
#pragma unroll
        for (int r = 0; r < VW_RH; ++r)
#pragma unroll
          for (int k = 0; k < VW_LC; k += 4)
            cr[r] = dot4(*reinterpret_cast<const float4*>(fa_s[buf] + (rh + r) * LDA + k0 + k),
                         make_float4(b[k], b[k + 1], b[k + 2], b[k + 3]), cr[r]);
      }
#pragma unroll
      for (int r = 0; r < VW_RH; ++r)
        e_s[(rh + r) * VW_LDE + jc] = kf32(na_s[buf][rh + r] + nbv, cr[r]) * cv;
      __syncthreads();                 // the stage's entries in
      if (s % VB_SPAN == 0) {
#pragma unroll
        for (int c = 0; c < VB_CT; ++c)
#pragma unroll
          for (int m = 0; m < VW_MT; ++m) acc[c][m] = 0.f;
      }
#pragma unroll 4
      for (int r = 0; r < VB_TP; ++r) {
        const float4 ev = *reinterpret_cast<const float4*>(e_s + r * VW_LDE + 4 * cg);
        const float e[VB_CT] = {ev.x, ev.y, ev.z, ev.w};
        const float4* g = reinterpret_cast<const float4*>(gr_s[buf] + r * VF_MP + 4 * mg);
#pragma unroll
        for (int q = 0; q < VW_MT / 4; ++q) {
          const float4 gv = g[8 * q];
#pragma unroll
          for (int c = 0; c < VB_CT; ++c) {
            acc[c][4 * q] = fmaf(e[c], gv.x, acc[c][4 * q]);
            acc[c][4 * q + 1] = fmaf(e[c], gv.y, acc[c][4 * q + 1]);
            acc[c][4 * q + 2] = fmaf(e[c], gv.z, acc[c][4 * q + 2]);
            acc[c][4 * q + 3] = fmaf(e[c], gv.w, acc[c][4 * q + 3]);
          }
        }
      }
      if ((s + 1) % VB_SPAN == 0 || s + 1 == nst) {   // the span into the running V
        const bool first = s < VB_SPAN;
#pragma unroll
        for (int c = 0; c < VB_CT; ++c)
#pragma unroll
          for (int m = 0; m < VW_MT; ++m) {
            float* q = vrun_s + (c * VW_MT + m) * VF_THREADS + tid;
            *q = first ? acc[c][m] : *q + acc[c][m];
          }
      }
    }
    // V out; this tile's norms and coeffs into the warp's slots
    float yv[VB_CT];
#pragma unroll
    for (int c = 0; c < VB_CT; ++c) {
      const int jg = tile * VW_TN + 4 * cg + c;
      yv[c] = a.y[jg];
#pragma unroll
      for (int m = 0; m < VW_MT; ++m) acc[c][m] = vrun_s[(c * VW_MT + m) * VF_THREADS + tid];
      float4* vo = reinterpret_cast<float4*>(a.v_out + (size_t)jg * VF_MP + 4 * mg);
#pragma unroll
      for (int q = 0; q < VW_MT / 4; ++q)
        vo[8 * q] = make_float4(acc[c][4 * q], acc[c][4 * q + 1], acc[c][4 * q + 2],
                                acc[c][4 * q + 3]);
    }
#pragma unroll
    for (int m = 0; m < VW_MT; ++m) {
      float nn = 0.f, cc = 0.f;
#pragma unroll
      for (int c = 0; c < VB_CT; ++c) {
        nn = fmaf(acc[c][m], acc[c][m], nn);
        cc = fmaf(yv[c], acc[c][m], cc);
      }
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {   // over the warp's 4 column groups
        nn += __shfl_xor_sync(0xffffffffu, nn, off);
        cc += __shfl_xor_sync(0xffffffffu, cc, off);
      }
      if (lane < 8) {   // V entry 32 (m / 4) + 4 mg + m % 4
        wp_s[warp][0][32 * (m / 4) + 4 * mg + m % 4] += nn;
        wp_s[warp][1][32 * (m / 4) + 4 * mg + m % 4] += cc;
      }
    }
  }
  __syncthreads();
  if (tid < 2 * VF_MP) {              // warps in order
    float s = 0.f;
    for (int w = 0; w < VF_THREADS / 32; ++w) s += wp_s[w][tid / VF_MP][tid % VF_MP];
    a.part[(size_t)blockIdx.x * 2 * VF_MP + tid] = s;
  }
}

// K9's ks pass, f32: ks_j = k_j^T t over all of p (a stage's sum from zero,
// then added to the total), then s_j
template <int LV>
__global__ __launch_bounds__(VF_THREADS, LV <= 32 ? 3 : LV == 64 ? 2 : 1) void ks_f32_kernel(
    const VF32Args a) {
  __shared__ __align__(16) float fa_s[2][VF_TP * VF_LDA_OF<LV>];
  __shared__ __align__(16) float t_s[2][VF_TP];
  __shared__ __align__(16) float na_s[2][VF_TP];
  const int tid = threadIdx.x;
  const int ntiles = a.N / VF_THREADS, nst = a.P / VF_TP;

  if ((int)blockIdx.x < ntiles) load_stage_f32<LV, VF_TP>(fa_s[0], na_s[0], t_s[0], a, false, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j = tile * VF_THREADS + tid;
    float b[LV];
    col_lanes<LV>(b, a, j);
    const float nbv = a.nb[j];
    float ks = 0.f;
    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < nst)
        load_stage_f32<LV, VF_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], t_s[buf ^ 1], a, false,
                                  (s + 1) * VF_TP);
      else if (tile + (int)gridDim.x < ntiles)
        load_stage_f32<LV, VF_TP>(fa_s[buf ^ 1], na_s[buf ^ 1], t_s[buf ^ 1], a, false, 0);
      float kst = 0.f;
#pragma unroll 4
      for (int r = 0; r < VF_TP; ++r)
        kst = fmaf(t_s[buf][r], entry_f32<LV>(fa_s[buf], na_s[buf], r, b, nbv), kst);
      ks += kst;
    }
    a.s_out[j] = sqrtf(a.s_pre[j] / fmaxf(ks, EPS)) * a.bm[j];
  }
}

// the f32 V pass at LV lanes: its kernel and dynamic shared memory (the
// running V; past 64 lanes the wide design's, with the tile's lanes)
typedef void (*v_f32_fn)(const VF32Args);
template <int LV>
v_f32_fn v_f32_kernel() {
  if constexpr (LV <= 64)
    return colstats_f32_kernel<LV>;
  else
    return colstats_f32_wide_kernel<LV>;
}
template <int LV>
constexpr size_t VF_DYN_OF = LV <= 64 ? VF_RUN_BYTES : VW_DYN_OF<LV>;

template <int LV>
int v_f32_setup(int* blocks_out) {
  cudaError_t e = cudaFuncSetAttribute(v_f32_kernel<LV>(),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)VF_DYN_OF<LV>);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(v_f32_kernel<LV>(), cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (e != cudaSuccess || blocks_out == nullptr) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, v_f32_kernel<LV>(), VF_THREADS,
                                                      VF_DYN_OF<LV>);
  *blocks_out = occ * sms;
  return static_cast<int>(e);
}

// the f32 V pass (K10, or K9's second pass), then the fixed-order reduction
template <int LV>
int launch_v_f32(int blocks, cudaStream_t s, const VF32Args& a, void* norms_coeffs) {
  int rc = v_f32_setup<LV>(nullptr);
  if (rc != 0) return rc;
  const v_f32_fn kernel = v_f32_kernel<LV>();
  kernel<<<blocks, VF_THREADS, VF_DYN_OF<LV>, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_reduce(a.part, static_cast<float*>(norms_coeffs), blocks, (size_t)2 * VF_MP, s);
}

template <int LV>
int launch_ks_f32(cudaStream_t s, const VF32Args& a) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, ks_f32_kernel<LV>, VF_THREADS, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = a.N / VF_THREADS;
  ks_f32_kernel<LV><<<occ * sms < tiles ? occ * sms : tiles, VF_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

VF32Args vf32_args(const void* fa, const void* ft, const void* gr, const void* y, const void* na,
                   const void* nb, void* v_out, void* part, int P, int N) {
  VF32Args a = {};
  a.fa = static_cast<const float*>(fa);
  a.ft = static_cast<const float*>(ft);
  a.gr = static_cast<const float*>(gr);
  a.y = static_cast<const float*>(y);
  a.na = static_cast<const float*>(na);
  a.nb = static_cast<const float*>(nb);
  a.v_out = static_cast<float*>(v_out);
  a.part = static_cast<float*>(part);
  a.P = P;
  a.N = N;
  return a;
}

}  // namespace

extern "C" {

// how many f32 V-pass blocks (lv = 4, 32, 64, 96 or 128 live lanes) fit
// the card at once; a negative value is a cudaError, 0 an unsupported lv
int glt_colstats_f32_blocks(int lv) {
  int n = 0;
  const int rc = lv == 4     ? v_f32_setup<4>(&n)
                 : lv == 32  ? v_f32_setup<32>(&n)
                 : lv == 64  ? v_f32_setup<64>(&n)
                 : lv == 96  ? v_f32_setup<96>(&n)
                 : lv == 128 ? v_f32_setup<128>(&n)
                             : -1;
  return rc < 0 ? 0 : rc != 0 ? -rc : n;
}

// K10, f32 layouts. P % 32 == 0, N % 256 == 0, gr (P, 64) row-major f32, lv
// 4 or 32 (a 32-lane layout), or the layout's depth 64, 96 or 128,
// 16-byte aligned operands (the wrapper checks); part holds (blocks, 2, 64)
// floats, norms_coeffs (2, 64).
int glt_colstats_v_f32(const void* fa, const void* ft, const void* gr, const void* c,
                       const void* y, const void* na, const void* nb, void* v_out, void* part,
                       void* norms_coeffs, int P, int N, int lv, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (P % VF_TP || N % VB_TN || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, P, N);
  a.c = static_cast<const float*>(c);
  return lv == 4     ? launch_v_f32<4>(blocks, s, a, norms_coeffs)
         : lv == 32  ? launch_v_f32<32>(blocks, s, a, norms_coeffs)
         : lv == 64  ? launch_v_f32<64>(blocks, s, a, norms_coeffs)
         : lv == 96  ? launch_v_f32<96>(blocks, s, a, norms_coeffs)
         : lv == 128 ? launch_v_f32<128>(blocks, s, a, norms_coeffs)
                     : static_cast<int>(cudaErrorInvalidValue);
}

// K9, f32 layouts: the ks pass (s into s_out), then K10's V pass with c = s.
// Shapes as glt_colstats_v_f32; t (P), s_pre and bm (N) f32.
int glt_finish_colstats_f32(const void* fa, const void* ft, const void* gr, const void* t,
                            const void* s_pre, const void* bm, const void* y, const void* na,
                            const void* nb, void* v_out, void* s_out, void* part,
                            void* norms_coeffs, int P, int N, int lv, int blocks, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (P % VF_TP || N % VB_TN || blocks < 1 ||
      (lv != 4 && lv != 32 && lv != 64 && lv != 96 && lv != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, P, N);
  a.t = static_cast<const float*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s_out = static_cast<float*>(s_out);
  a.c = static_cast<const float*>(s_out);
  const int rc = lv == 4    ? launch_ks_f32<4>(s, a)
                 : lv == 32 ? launch_ks_f32<32>(s, a)
                 : lv == 64 ? launch_ks_f32<64>(s, a)
                 : lv == 96 ? launch_ks_f32<96>(s, a)
                            : launch_ks_f32<128>(s, a);
  if (rc != 0) return rc;
  return lv == 4    ? launch_v_f32<4>(blocks, s, a, norms_coeffs)
         : lv == 32 ? launch_v_f32<32>(blocks, s, a, norms_coeffs)
         : lv == 64 ? launch_v_f32<64>(blocks, s, a, norms_coeffs)
         : lv == 96 ? launch_v_f32<96>(blocks, s, a, norms_coeffs)
                    : launch_v_f32<128>(blocks, s, a, norms_coeffs);
}

// how many V-pass blocks for width MP and fd lanes fit the card at once
// (the persistent grid of K10 and of K9's V pass); a negative value is a
// cudaError, 0 an unsupported MP or fd
int glt_colstats_v_blocks(int MP, int fd) {
  int n = 0;
  const int rc = fd == 32    ? resident_blocks_fd<32>(MP, &n)
                 : fd == 64  ? resident_blocks_fd<64>(MP, &n)
                 : fd == 96  ? resident_blocks_fd<96>(MP, &n)
                 : fd == 128 ? resident_blocks_fd<128>(MP, &n)
                             : 0;
  return rc != 0 ? -rc : n;
}

// K10. P % 64 == 0, N % 256 == 0, MP in {16, 32, 48, 64}, fd 32, 64, 96 or
// 128 (the wrapper checks); part holds (blocks, 2, MP) floats, norms_coeffs
// (2, MP).
int glt_colstats_v(const void* fa, const void* ft, const void* grt, const void* cb,
                   const void* y, const void* na, const void* nb, void* v_out, void* part,
                   void* norms_coeffs, int P, int N, int MP, int fd, int blocks,
                   void* stream) {
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
  return launch_v(MP, fd, blocks, reinterpret_cast<cudaStream_t>(stream), a, norms_coeffs);
}

// K9: the ks pass (s and bf16(s) into s_out, cb_out), then K10's V pass with
// c = s. Shapes as K10; tb (P) bf16, s_pre and bm (N) f32, cb_out (N) bf16.
int glt_finish_colstats(const void* fa, const void* ft, const void* grt, const void* tb,
                        const void* s_pre, const void* bm, const void* y, const void* na,
                        const void* nb, void* v_out, void* s_out, void* cb_out, void* part,
                        void* norms_coeffs, int P, int N, int MP, int fd, int blocks,
                        void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (fd != 32 && fd != 64 && fd != 96 && fd != 128)
    return static_cast<int>(cudaErrorInvalidValue);
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
  const int rc = fd == 32   ? launch_ks<32>(s, a)
                 : fd == 64 ? launch_ks<64>(s, a)
                 : fd == 96 ? launch_ks<96>(s, a)
                            : launch_ks<128>(s, a);
  if (rc != 0) return rc;
  return launch_v(MP, fd, blocks, s, a, norms_coeffs);
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
