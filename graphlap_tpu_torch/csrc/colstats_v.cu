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
// take a kernel of its own at the end of the file (colstats_tc_kernel):
// every value f32, each tile entry formed once a launch by an FFMA cross, V
// and K9's ks as f32-exact products of three bf16 parts on the tensor
// cores.
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
// sqrt(s_pre_j / max(ks_j, 1e-30)) bm_j, V_j = (s_j k_j)^T gr. The entry is
// the f32 class: d2 = max(na + nb - 2 cross, 0) with the f32 norms passed
// in, k = expf(-d2), every product f32-exact and rounded to nearest, no
// bf16 rounding point (pp _finish_colstats_kernel and _colstats_kernel
// run the cross, ks and V as dots at "highest": six bf16 passes on the
// TPU). What bounds them at 8 MP (p_pad 4096, N 8388608, E = 3.44e10 tile
// entries, V width 64): the cross as f32 FFMA over the live lanes (2 live
// flop an entry: 127.4 / 86.3 / 53.4 ms at 124 / 84 / 52 live lanes, 67
// TFLOP/s), against V with ks as one more n8 tile on the tensor cores as
// six bf16 passes (72 columns; 30.0 ms, K10's 64 26.7, at 989 TFLOP/s)
// and one expf an entry (8.2 ms on MUFU).
//
// Design (colstats_tc_kernel), flash attention's shape: the cross, the exp
// and the product with gr in one walk over p, each tile entry formed once.
//   * A 256-thread block owns a tile of VT_TN = 256 columns, a warp two
//     16-column tiles of them, and walks p in stages of VT_TP = 32 sample
//     rows (one block an SM at every width): the stage's f32
//     fa rows, na and B's parts arrive by cp.async double buffering. B = [gr
//     | t] (K9: t in column 64 of a ninth n8 tile) or gr (K10), split once a
//     launch by split_cols_kernel into three bf16 planes on the grid of each
//     column a stage (split3_grid).
//   * The cross on the FP32 pipe, each entry's an FFMA chain over the lanes
//     in lane order (the plain version's cuBLAS order, so its tile entries
//     agree with the plain version's bit for bit on most entries), formed
//     straight into the mma accumulator layout: a thread's 32 entries (4
//     columns x 8 rows a stage) take its columns' lanes (in registers at 4
//     lanes; past that from the tile's f32 lanes, in shared memory for the
//     tile's whole walk) and the rows' lanes broadcast from shared memory,
//     a float4 of each a 4-lane step. On the tensor cores (fa and f_t in
//     three bf16 parts each, six part products) the cross lay 1.3e-2 to
//     5.2e-2 of max |V| from the plain version at 28 to 124 live lanes (the
//     kernels' bar is 2e-4): a tile entry moves with every rounding of its
//     cross, by the f32 cancellation error itself, at |f|^2 up to 3.3e5
//     (scripts/f32_colstats_designs.py; PERF.md).
//   * The exp epilogue (kf32) runs on those registers, whose layout is the
//     mma A-fragment layout. Each column's entries in the stage are scaled
//     by 2^-E (E: the column's largest entry in the stage < 2^E, a power of
//     two, so exact) and split into three bf16 parts on the grid 2^-8; the
//     scale factors out of the column's sums, so a column of tiny entries
//     (a huge Sinkhorn scale's) keeps f32's relative precision, where split
//     fp16 flushed them.
//   * V's and ks's products on the tensor cores (mma.sync m16n8k16): six
//     part products a stage and n8 tile of B, the corrections a1 b0, a0 b1,
//     a1 b1, a2 b0, a0 b2 in one chain and a0 b0 in another (exact: 32 rows
//     of products on the grid 2^(E_B - 16)), each from zero; their sum joins
//     the running f32 sum (registers, 36 a thread), which a column keeps on
//     the largest E of its stages so far (both scaled by powers of two), so
//     W leaves the subnormal range only where V does. The tensor core's f32
//     accumulation truncates, so no chain runs past one stage.
//   * At the tile's end, K9's ks_j is column 64 of the running sum: s_j from
//     it, V_j = s_j W_j (K10: c_j W_j). The f32 class rounds each product to
//     nearest and has no rounding point between k and its scale, so the
//     scale after the sum is the same function (the bf16 K9 keeps its
//     bf16(k bf16(s)) point). V is written once; norms and coeffs go through
//     a shuffle tree, the warps' slots, per-block partials and the
//     fixed-order reduction. Blocks are persistent and walk the column tiles
//     in a fixed stride order: runs repeat bit for bit.
//   * Designs measured at the bilateral recipes' 8 MP shapes on an NVIDIA
//     H100 80GB HBM3 (700 W), scripts/f32_colstats_designs.py, K9 / K10 ms
//     at 124 / 84 / 52 / 28 / 4 live lanes: this one 315.3 / 309.9, 258.0
//     / 262.1, 201.8 / 194.4, 149.2 / 142.5, 103.4 / 94.5; the design it
//     replaced (PR 13-20: a ks pass, then the V pass as an FFMA SGEMM on
//     entries staged in shared memory, each entry formed twice in K9)
//     846.4 / 531.5, 641.7 / 400.7, 489.9 / 329.8, 330.9 / 243.8, 166.3 /
//     140.8; a stage's products beside the next stage's cross (one basic
//     block, B's parts in a ring of 3; it spills at 255 registers) 323.8 /
//     319.3, 268.9 / 262.3, 215.6 / 210.2, 158.5 / 145.0, 108.2 / 102.5;
//     one 16-column tile a warp, its 16 entries 10 float4 loads a 4-lane
//     step (2.5 B of shared memory an FFMA, the cross bound by them), 464.5
//     / 457.1 at 124 lanes; the split cross (six part products) 249.6 /
//     237.2 at 124 lanes, eight 268.6 / 253.3, both 2.0e-2 to 6.5e-2 of max
//     |V| from the plain version. V, ks, the exp and the split alone (no
//     cross, timing only) take 93-101 ms at every width.
constexpr int VF_MP = 64;                   // V width a launch (gr padded to it)
constexpr int VT_THREADS = 256;
constexpr int VT_WARPS = VT_THREADS / 32;
constexpr int VT_CT = 2;                    // 16-column tiles a warp
constexpr int VT_TN = VT_WARPS * VT_CT * 16;  // columns a block tile
constexpr int VT_TP = 32;                   // sample rows a stage
constexpr int VT_LDG = VT_TP + 8;           // B parts row stride (bf16): conflict-free ldmatrix
template <int LV>
constexpr int FD_OF = LV <= 32 ? 32 : LV;   // the layout's depth for LV live lanes
template <int LV>
constexpr bool COLS_REG = LV == 4;          // a thread's columns' lanes in registers
template <int LV>
constexpr int VT_LDA = COLS_REG<LV> ? 4 : FD_OF<LV> + 4;   // fa / f_t row stride (floats)
template <bool KS>
constexpr int VT_NB = KS ? 9 : 8;           // n8 tiles of B: gr, and K9's t

struct VF32Args {
  const float* fa;     // (P, FD) FD 32, 64, 96 or 128
  const float* ft;     // (FD, N)
  const float* gr;     // (P, 64) row-major
  const float* c;      // (N) column scale                      K10
  const float* t;      // (P)                                   K9
  const float* s_pre;  // (N)                                   K9
  const float* bm;     // (N)                                   K9
  const float* y;      // (N)
  const float* na;     // (P)
  const float* nb;     // (N)
  bf16* b_parts;       // (3, 8 NB, P) B's parts, column-major (scratch)
  float* v_out;        // (N, 64)
  float* s_out;        // (N)                                   K9
  float* part;         // (gridDim.x, 2, 64) norms, coeffs
  int P, N;
};

// the shared-memory layout of colstats_tc_kernel<LV, KS> (byte offsets)
template <int LV, bool KS>
struct VtSmem {
  static constexpr int FD = FD_OF<LV>, LDA = VT_LDA<LV>, NB = VT_NB<KS>;
  // the tile's columns' f32 lanes [VT_TN][LDA] (past 4 lanes)
  static constexpr size_t FT = COLS_REG<LV> ? 0 : (size_t)VT_TN * LDA * 4;
  static constexpr size_t FA_STAGE = (size_t)VT_TP * LDA * 4;          // [VT_TP][LDA] f32
  static constexpr size_t B_STAGE = (size_t)3 * NB * 8 * VT_LDG * 2;   // [3][8 NB][VT_LDG]
  static constexpr size_t OFF_FA = FT;                                // [2] stages
  static constexpr size_t OFF_B = OFF_FA + 2 * FA_STAGE;              // [2] stages
  static constexpr size_t OFF_NA = OFF_B + 2 * B_STAGE;               // [2][VT_TP]
  static constexpr size_t OFF_WP = OFF_NA + 2 * VT_TP * 4;            // [warps][2][64]
  static constexpr size_t BYTES = OFF_WP + (size_t)VT_WARPS * 2 * VF_MP * 4;
};

// c += a . b, bf16 m16n8k16 with f32 accumulation; not volatile, so the
// compiler interleaves independent chains
__device__ __forceinline__ void mma_tc(float c[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B = [gr | t | 0] (K9, t != null, nb8 = 72) or gr (K10, nb8 = 64) as its
// three bf16 parts, column-major (3, nb8, P): thread (column m, stage s)
// splits rows [32 s, 32 s + 32) of column m on the grid of their largest
template <int NB8>
__global__ void split_cols_kernel(const float* __restrict__ gr, const float* __restrict__ t,
                                  bf16* __restrict__ out, int P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NB8 * (P / VT_TP)) return;
  const int m = i % NB8, r0 = (i / NB8) * VT_TP;
  auto val = [&](int r) {
    return m < VF_MP ? gr[(size_t)r * VF_MP + m] : (m == VF_MP && t != nullptr) ? t[r] : 0.f;
  };
  float mx = 0.f;
#pragma unroll 8
  for (int r = r0; r < r0 + VT_TP; ++r) mx = fmaxf(mx, fabsf(val(r)));
  const int e = grid_exp(mx);
  const float q = pow2(8 - e), qi = pow2(e - 8);
#pragma unroll 4
  for (int r = r0; r < r0 + VT_TP; r += 2) {
    uint32_t o[3];
    split3_grid(val(r), val(r + 1), q, qi, q, qi, o);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint32_t*>(out + ((size_t)p * NB8 + m) * P + r) = o[p];
  }
}

// the stage of rows [p0, p0 + VT_TP) into buffer buf: fa's f32 rows (4
// lanes at LV 4, of rows FD apart), na and B's parts; one cp.async commit
// group
template <int LV, bool KS>
__device__ __forceinline__ void vt_load_stage(unsigned char* smem, const VF32Args& a, int buf,
                                              int p0) {
  using S = VtSmem<LV, KS>;
  constexpr int CH = COLS_REG<LV> ? 1 : S::FD / 4;   // 16-byte chunks a row
  const int tid = threadIdx.x;
  float* d = reinterpret_cast<float*>(smem + S::OFF_FA + buf * S::FA_STAGE);
#pragma unroll 1
  for (int c = tid; c < VT_TP * CH; c += VT_THREADS) {
    const int q = c % CH, r = c / CH;
    cp_async16(d + r * S::LDA + 4 * q, a.fa + (size_t)(p0 + r) * S::FD + 4 * q);
  }
  bf16* bd = reinterpret_cast<bf16*>(smem + S::OFF_B + buf * S::B_STAGE);
  constexpr int GCH = VT_TP / 8;
#pragma unroll 1
  for (int c = tid; c < 3 * S::NB * 8 * GCH; c += VT_THREADS) {
    const int q = c % GCH, pm = c / GCH;   // pm = part * 8 NB + column
    cp_async16(bd + pm * VT_LDG + 8 * q, a.b_parts + (size_t)pm * a.P + p0 + 8 * q);
  }
  if (tid < VT_TP / 4) {
    float* nd = reinterpret_cast<float*>(smem + S::OFF_NA) + buf * VT_TP;
    cp_async16(nd + 4 * tid, a.na + p0 + 4 * tid);
  }
  cp_async_commit();
}

// the tile's columns [j0, j0 + VT_TN) of f_t into ft_s [VT_TN][LDA],
// transposed, each load coalesced over the columns
template <int FD, int LDA>
__device__ __forceinline__ void load_tile(float* ft_s, const VF32Args& a, int j0) {
#pragma unroll 8
  for (int i = threadIdx.x; i < VT_TN * FD; i += VT_THREADS) {
    const int c = i % VT_TN, k = i / VT_TN;
    ft_s[c * LDA + k] = a.ft[(size_t)k * a.N + j0 + c];
  }
}

// the cross of the warp's 32 columns x a stage's 32 rows, an FFMA chain an
// entry over the lanes in order: cr[ct][i] holds rows 8 i + 2 tq, + 1 of
// column tile ct's columns c0 + 16 ct (0, 1) and c0 + 16 ct + 8 (2, 3);
// the columns' lanes from fcol (LV 4) or the tile's lanes in ft_s (c0 the
// thread's first column there), the rows' from the stage's fs. A thread's
// 32 entries take 12 float4 loads of shared memory a 4-lane step
template <int LV>
__device__ __forceinline__ void vt_cross(float (&cr)[VT_CT][4][4], const float* fs,
                                         const float* ft_s, const float (&fcol)[VT_CT][2][4],
                                         int c0, int tq) {
  constexpr int LDA = VT_LDA<LV>;
#pragma unroll
  for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) cr[ct][i][e] = 0.f;
#pragma unroll
  for (int k = 0; k < (COLS_REG<LV> ? 4 : FD_OF<LV>); k += 4) {
    float4 b[VT_CT][2];
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[ct][h] = COLS_REG<LV>
                       ? make_float4(fcol[ct][h][0], fcol[ct][h][1], fcol[ct][h][2], fcol[ct][h][3])
                       : *reinterpret_cast<const float4*>(ft_s + (c0 + 16 * ct + 8 * h) * LDA + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(fs + (8 * i + 2 * tq + e) * LDA + k);
#pragma unroll
        for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            cr[ct][i][2 * h + e] = dot4(x, b[ct][h], cr[ct][i][2 * h + e]);
      }
  }
}

// a column tile's entries from their cross (ns: the stage's na), each
// column's largest in the stage (over the quad's rows) < 2^E, and the
// entries times 2^-E as three bf16 parts on the grid 2^-8: the A fragments
// of the two k16 steps, kp[part][step][reg] (reg 0 / 1 the first n8 tile's
// rows of its columns 0 / 8, 2 / 3 the second's), and each column's E
__device__ __forceinline__ void vt_entries(uint32_t (&kp)[3][2][4], int (&es)[2],
                                           float (&cr)[4][4], const float* ns,
                                           const float (&nbv)[2], int tq) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cr[i][e] = kf32(ns[8 * i + 2 * tq + (e & 1)] + nbv[e >> 1], cr[i][e]);
      mx[e >> 1] = fmaxf(mx[e >> 1], cr[i][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // mx < 2^E: E = its exponent + 1, at least -126 (2^-E and 2^E normal)
    const int ex = (int)((__float_as_uint(mx[h]) >> 23) & 0xff) - 126;
    const float inv = pow2(-ex);
    es[h] = ex;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cr[i][2 * h] *= inv;
      cr[i][2 * h + 1] *= inv;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t o[3];
      split3_grid(cr[i][2 * h], cr[i][2 * h + 1], 256.f, 1.f / 256.f, 256.f, 1.f / 256.f, o);
#pragma unroll
      for (int p = 0; p < 3; ++p) kp[p][i >> 1][2 * (i & 1) + h] = o[p];
    }
}

// W += a stage's k^T B (bs: this lane's ldmatrix row of the stage's B
// parts), for the warp's column tiles: per n8 tile of B (its parts loaded
// once for both tiles) and column tile, the corrections' chain and a0 b0's,
// each from zero over the stage's two k16 steps. The running sum of a column
// is W 2^-er: it and the stage's sum (its entries' scale es) join on the
// larger exponent, each times a power of two (exact; a factor below 2^-126
// is 0, the term below 2^-127 of the other), so a column of tiny entries
// never sums in the subnormal range
template <int NB>
__device__ __forceinline__ void vt_products(float (&run)[VT_CT][NB][4], int (&er)[VT_CT][2],
                                            const uint32_t (&kp)[VT_CT][3][2][4],
                                            const int (&es)[VT_CT][2], const bf16* bs) {
  float f_run[VT_CT][2], f_st[VT_CT][2];
#pragma unroll
  for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int en = max(er[ct][h], es[ct][h]);
      f_run[ct][h] = pow2(max(er[ct][h] - en, -127));
      f_st[ct][h] = pow2(max(es[ct][h] - en, -127));
      er[ct][h] = en;
    }
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    uint32_t b[3][4];   // part p: step 0's two registers, then step 1's
#pragma unroll
    for (int p = 0; p < 3; ++p) ldsm_x4(b[p], bs + (p * NB * 8 + t * 8) * VT_LDG);
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct) {
      float c[4] = {0.f, 0.f, 0.f, 0.f}, z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t(&a)[3][2][4] = kp[ct];
        mma_tc(c, a[1][k], b[0][2 * k], b[0][2 * k + 1]);
        mma_tc(c, a[0][k], b[1][2 * k], b[1][2 * k + 1]);
        mma_tc(c, a[1][k], b[1][2 * k], b[1][2 * k + 1]);
        mma_tc(c, a[2][k], b[0][2 * k], b[0][2 * k + 1]);
        mma_tc(c, a[0][k], b[2][2 * k], b[2][2 * k + 1]);
        mma_tc(z, a[0][k], b[0][2 * k], b[0][2 * k + 1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        run[ct][t][e] = fmaf(run[ct][t][e], f_run[ct][e >> 1], (z[e] + c[e]) * f_st[ct][e >> 1]);
    }
  }
}

// The f32 K9 (KS) / K10 at LV lanes: see the section's note.
template <int LV, bool KS>
__global__ __launch_bounds__(VT_THREADS, 1) void colstats_tc_kernel(const VF32Args a) {
  using S = VtSmem<LV, KS>;
  constexpr int FD = S::FD, NB = S::NB;
  extern __shared__ __align__(16) unsigned char vt_smem[];
  float* const ft_s = reinterpret_cast<float*>(vt_smem);
  float* const na_s = reinterpret_cast<float*>(vt_smem + S::OFF_NA);
  float* const wp_s = reinterpret_cast<float*>(vt_smem + S::OFF_WP);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = a.N / VT_TN, nst = a.P / VT_TP;
  const int c0 = warp * VT_CT * 16 + g;   // the thread's first column in the tile
  const bf16* const b_lane = reinterpret_cast<const bf16*>(vt_smem + S::OFF_B) +
                             (lane & 7) * VT_LDG + (lane >> 3) * 8;

  for (int i = tid; i < VT_WARPS * 2 * VF_MP; i += VT_THREADS) wp_s[i] = 0.f;
  if ((int)blockIdx.x < ntiles) vt_load_stage<LV, KS>(vt_smem, a, 0, 0);
  int step = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int j0 = tile * VT_TN;
    float fcol[VT_CT][2][4];   // LV 4: the thread's columns' lanes
    if constexpr (!COLS_REG<LV>) {
      __syncthreads();   // every warp is past the last tile's cross
      load_tile<FD, S::LDA>(ft_s, a, j0);
    } else {
#pragma unroll
      for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            fcol[ct][h][k] = a.ft[(size_t)k * a.N + j0 + c0 + 16 * ct + 8 * h];
    }
    float nbv[VT_CT][2];
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
      for (int h = 0; h < 2; ++h) nbv[ct][h] = a.nb[j0 + c0 + 16 * ct + 8 * h];
    float run[VT_CT][NB][4];
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct)
#pragma unroll
      for (int t = 0; t < NB; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[ct][t][e] = 0.f;
    int er[VT_CT][2];   // the running sums' exponents
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct) er[ct][0] = er[ct][1] = -126;

    for (int s = 0; s < nst; ++s, ++step) {
      const int buf = step & 1;
      cp_async_wait_all();
      __syncthreads();   // stage s (and the tile's lanes) in; everyone done with buf ^ 1
      if (s + 1 < nst)
        vt_load_stage<LV, KS>(vt_smem, a, buf ^ 1, (s + 1) * VT_TP);
      else if (tile + (int)gridDim.x < ntiles)   // the next tile's first stage
        vt_load_stage<LV, KS>(vt_smem, a, buf ^ 1, 0);
      float cr[VT_CT][4][4];
      vt_cross<LV>(cr, reinterpret_cast<const float*>(vt_smem + S::OFF_FA + buf * S::FA_STAGE),
                   ft_s, fcol, c0, tq);
      uint32_t kp[VT_CT][3][2][4];
      int es[VT_CT][2];
#pragma unroll
      for (int ct = 0; ct < VT_CT; ++ct)
        vt_entries(kp[ct], es[ct], cr[ct], na_s + buf * VT_TP, nbv[ct], tq);
      vt_products<NB>(run, er, kp, es, b_lane + buf * (S::B_STAGE / 2));
    }

#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct) {
      const int jg = j0 + c0 + 16 * ct;   // the thread's columns jg, jg + 8
      // the column scales times 2^er: K9's s from ks (column 64, B's ninth
      // n8 tile, held by the quad's tq 0 lane), K10's c
      float cs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = jg + 8 * h;
        const float w = pow2(er[ct][h]);
        if constexpr (KS) {
          const float ks = __shfl_sync(0xffffffffu, run[ct][NB - 1][2 * h], lane & ~3) * w;
          const float sj = sqrtf(a.s_pre[j] / fmaxf(ks, EPS)) * a.bm[j];
          if (tq == 0) a.s_out[j] = sj;
          cs[h] = sj * w;
        } else {
          cs[h] = a.c[j] * w;
        }
      }
      // V out; this column tile's norms and coeffs into the warp's slots
      const float yv[2] = {a.y[jg], a.y[jg + 8]};
#pragma unroll
      for (int t = 0; t < VF_MP / 8; ++t) {
        const float v0 = run[ct][t][0] * cs[0], v1 = run[ct][t][1] * cs[0];
        const float v2 = run[ct][t][2] * cs[1], v3 = run[ct][t][3] * cs[1];
        *reinterpret_cast<float2*>(a.v_out + (size_t)jg * VF_MP + 8 * t + 2 * tq) =
            make_float2(v0, v1);
        *reinterpret_cast<float2*>(a.v_out + (size_t)(jg + 8) * VF_MP + 8 * t + 2 * tq) =
            make_float2(v2, v3);
        const float va[2][2] = {{v0, v2}, {v1, v3}};   // [entry][column jg, jg + 8]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float nn = fmaf(va[e][1], va[e][1], va[e][0] * va[e][0]);
          float cc = fmaf(yv[1], va[e][1], yv[0] * va[e][0]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {   // over g: a fixed tree
            nn += __shfl_xor_sync(0xffffffffu, nn, off);
            cc += __shfl_xor_sync(0xffffffffu, cc, off);
          }
          if (g == 0) {
            wp_s[(warp * 2 + 0) * VF_MP + 8 * t + 2 * tq + e] += nn;
            wp_s[(warp * 2 + 1) * VF_MP + 8 * t + 2 * tq + e] += cc;
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < 2 * VF_MP) {   // warps in order
    float s = 0.f;
    for (int w = 0; w < VT_WARPS; ++w) s += wp_s[(w * 2 + tid / VF_MP) * VF_MP + tid % VF_MP];
    a.part[(size_t)blockIdx.x * 2 * VF_MP + tid] = s;
  }
}

template <int LV, bool KS>
int vt_setup(int* blocks_out) {
  using S = VtSmem<LV, KS>;
  cudaError_t e = cudaFuncSetAttribute(colstats_tc_kernel<LV, KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(colstats_tc_kernel<LV, KS>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess || blocks_out == nullptr) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, colstats_tc_kernel<LV, KS>,
                                                      VT_THREADS, S::BYTES);
  *blocks_out = occ * sms;
  return static_cast<int>(e);
}

// B's parts (split_cols_kernel), the kernel, then the
// fixed-order reduction of its partials
template <int LV, bool KS>
int launch_vt(int blocks, cudaStream_t s, const VF32Args& a, void* norms_coeffs) {
  using S = VtSmem<LV, KS>;
  int rc = vt_setup<LV, KS>(nullptr);
  if (rc != 0) return rc;
  constexpr int NB8 = 8 * S::NB;
  split_cols_kernel<NB8><<<(NB8 * (a.P / VT_TP) + 255) / 256, 256, 0, s>>>(
      a.gr, KS ? a.t : nullptr, a.b_parts, a.P);
  colstats_tc_kernel<LV, KS><<<blocks, VT_THREADS, S::BYTES, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  return launch_reduce(a.part, static_cast<float*>(norms_coeffs), blocks, (size_t)2 * VF_MP, s);
}

template <bool KS>
int launch_vt_lv(int lv, int blocks, cudaStream_t s, const VF32Args& a, void* norms_coeffs) {
  return lv == 4     ? launch_vt<4, KS>(blocks, s, a, norms_coeffs)
         : lv == 32  ? launch_vt<32, KS>(blocks, s, a, norms_coeffs)
         : lv == 64  ? launch_vt<64, KS>(blocks, s, a, norms_coeffs)
         : lv == 96  ? launch_vt<96, KS>(blocks, s, a, norms_coeffs)
         : lv == 128 ? launch_vt<128, KS>(blocks, s, a, norms_coeffs)
                     : static_cast<int>(cudaErrorInvalidValue);
}

VF32Args vf32_args(const void* fa, const void* ft, const void* gr, const void* y, const void* na,
                   const void* nb, void* v_out, void* part, void* scratch, int P, int N) {
  VF32Args a = {};
  a.fa = static_cast<const float*>(fa);
  a.ft = static_cast<const float*>(ft);
  a.gr = static_cast<const float*>(gr);
  a.y = static_cast<const float*>(y);
  a.na = static_cast<const float*>(na);
  a.nb = static_cast<const float*>(nb);
  a.v_out = static_cast<float*>(v_out);
  a.part = static_cast<float*>(part);
  a.b_parts = static_cast<bf16*>(scratch);
  a.P = P;
  a.N = N;
  return a;
}

}  // namespace

extern "C" {

// how many f32 K9 (ks != 0) or K10 blocks (lv = 4, 32, 64, 96 or 128 live
// lanes) fit the card at once; a negative value is a cudaError, 0 an
// unsupported lv
int glt_colstats_f32_blocks(int lv, int ks) {
  int n = 0;
  int rc = -1;
  if (ks)
    rc = lv == 4     ? vt_setup<4, true>(&n)
         : lv == 32  ? vt_setup<32, true>(&n)
         : lv == 64  ? vt_setup<64, true>(&n)
         : lv == 96  ? vt_setup<96, true>(&n)
         : lv == 128 ? vt_setup<128, true>(&n)
                     : -1;
  else
    rc = lv == 4     ? vt_setup<4, false>(&n)
         : lv == 32  ? vt_setup<32, false>(&n)
         : lv == 64  ? vt_setup<64, false>(&n)
         : lv == 96  ? vt_setup<96, false>(&n)
         : lv == 128 ? vt_setup<128, false>(&n)
                     : -1;
  return rc < 0 ? 0 : rc != 0 ? -rc : n;
}

// the scratch bytes of an f32 K9 (ks != 0) or K10 launch at P sample rows
// and fd lanes: B's three bf16 parts
size_t glt_colstats_f32_scratch_bytes(int P, int fd, int ks) {
  (void)fd;
  return (size_t)3 * 8 * (ks ? VT_NB<true> : VT_NB<false>) * P * sizeof(bf16);
}

// K10, f32 layouts. P % 32 == 0, N % 256 == 0, gr (P, 64) row-major f32,
// lv 4 or 32 (a 32-lane layout), or the layout's depth 64, 96 or 128,
// 16-byte aligned operands (the wrapper checks); scratch holds
// glt_colstats_f32_scratch_bytes, part (blocks, 2, 64) floats,
// norms_coeffs (2, 64).
int glt_colstats_v_f32(const void* fa, const void* ft, const void* gr, const void* c,
                       const void* y, const void* na, const void* nb, void* v_out, void* part,
                       void* norms_coeffs, void* scratch, int P, int N, int lv, int blocks,
                       void* stream) {
  if (P % VT_TP || N % VT_TN || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, scratch, P, N);
  a.c = static_cast<const float*>(c);
  return launch_vt_lv<false>(lv, blocks, reinterpret_cast<cudaStream_t>(stream), a,
                             norms_coeffs);
}

// K9, f32 layouts: one launch, s into s_out. Shapes as glt_colstats_v_f32;
// t (P), s_pre and bm (N) f32.
int glt_finish_colstats_f32(const void* fa, const void* ft, const void* gr, const void* t,
                            const void* s_pre, const void* bm, const void* y, const void* na,
                            const void* nb, void* v_out, void* s_out, void* part,
                            void* norms_coeffs, void* scratch, int P, int N, int lv, int blocks,
                            void* stream) {
  if (P % VT_TP || N % VT_TN || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  VF32Args a = vf32_args(fa, ft, gr, y, na, nb, v_out, part, scratch, P, N);
  a.t = static_cast<const float*>(t);
  a.s_pre = static_cast<const float*>(s_pre);
  a.bm = static_cast<const float*>(bm);
  a.s_out = static_cast<float*>(s_out);
  return launch_vt_lv<true>(lv, blocks, reinterpret_cast<cudaStream_t>(stream), a,
                            norms_coeffs);
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
