// K1 — the strip emitter: out[i, j] = exp(-max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0)).
//
// Replaces graphlap_tpu/ops/pallas_affinity.py:affinity_strip_pallas
// (_affinity_kernel): the (p_pad, n_pad) kernel strip of the strip_cache
// path, written once, the cross and the exp fused so no f32 distance temp
// reaches device memory.
//
// What bounds it on an H100: at the main path's shape (p_pad 5248, n 262144,
// d 25 padded to 32, or d 49, 81, 121 of a 7 x 7, 9 x 9, 11 x 11 patch
// padded to 64, 96, 128) it writes 2.75 GB of bf16, 0.82 ms at 3.35 TB/s,
// the bound (at 128 lanes the three fp16 passes, 1.07 ms, pass it). The cross must keep the
// precision the reference pins with "highest" (the GEMM trick cancels); as
// an IEEE-f32 SIMT product it would be 88 GFLOP, 1.3 ms at the 67 TFLOP/s
// f32 peak, so the cross runs on the tensor cores as the f32 K5/K6 run it
// (recompute_matvec.cu): each feature vector scaled by 2^-E, each scaled
// feature split into big + small fp16 (split2, mma_common.cuh), cross =
// 2^(Ea + Eb) (big.big + big.small + small.big), small.small (~2^-20 of
// |f|^2) dropped; three fp16 passes are 0.27 ms at 989 TFLOP/s (0.53 ms
// over 64 lanes). The bf16 entry's exp is one FMUL and one MUFU ex2
// (kexp), 1.4e9 of them 0.33 ms; the f32 store keeps IEEE expf. Features
// that carry coordinates take an IEEE f32 cross instead (glt_affinity_coord,
// coord_store.cu: one store tile with the f32 K7).
//
// Design: a prep kernel splits the sample rows once into m16n8k16 A
// fragments (big and small fp16 per lane, per 16-row tile and k16 step),
// their norms and -2 2^Ea, 17 KB a 128-row block (33, 49, 65 KB at 64, 96,
// 128 lanes). The emitter's 256-thread blocks are persistent (two an SM at
// 32 lanes, one past it: at 64 a warp's split B fragments alone take 64
// registers and the two A buffers 66 KB; past 64 a warp holds 16 pixels,
// A1_NT, and the f32 store one A buffer, A1_ABUFS) and walk a contiguous range of
// 128 x 128 output units, the 41 row blocks of one pixel tile after
// another. A warp holds 32 pixels as split B fragments in registers
// (reloaded when the pixel tile changes) and runs 4 of the unit's 8 row
// tiles against them: per 16 x 8 sub-tile 6 mma (12 at 64 lanes; big.big
// a k16 step from zero, the corrections in a third chain), then the
// epilogue on the accumulator registers, which hold adjacent pixels of a row, so two bf16
// entries pack into one word. The unit's A block arrives by a bulk copy
// into one of two buffers while the previous unit runs. The finished tile
// is staged in shared memory in the 128-byte-swizzled layout of a TMA box
// (the 8 rows a warp writes at once land in 8 distinct 16-byte chunks: no
// bank conflicts) and written by TMA store from one of two staging
// buffers, so the next unit's mma runs while it drains; rows and pixels
// past the strip's edge are clipped by the store.
//
// At config 2's shapes it runs at 1.22 ms, 1.47x its bound (128 registers,
// two blocks an SM). No one limit holds it there: measured beside it on an
// H100 80GB HBM3 (700 W) by scripts/strip_designs.py, leaving out the
// store takes it to 1.16 ms, the exp to 1.11, the mma to 1.09 (timing
// only), so the tensor, FP32 and MUFU pipes and the store each hold part
// of it. The exp as ex2.approx.ftz (subnormal entries flushed, unlike the
// plain version's expf) 1.13-1.15 ms; the row-tile loop unrolled by 2,
// 1.24-1.25 ms; the corrections in two mma chains, 1.27-1.28 ms. The PR 1
// design (an IEEE-f32 SIMT product, 8 x 8 outputs a thread, direct 16-byte
// stores) took 4.17 ms.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).

#include "mma_common.cuh"

namespace {

constexpr int A1_THREADS = 256;   // 8 warps: pixel groups x row groups
constexpr int A1_TM = 128;        // sample rows a unit (8 m16 tiles)
constexpr int A1_TN = 128;        // pixels a unit
// The feature depth FD is a template parameter of the split and the
// emitter: 32 (2 k16 steps: NLM 5 x 5, d 25), 64 (4: NLM 7 x 7, d 49), 96
// (6: NLM 9 x 9, d 81) or 128 (8: NLM 11 x 11, d 121). At 64 the split A
// block is 33 KB and a warp's split B fragments 64 registers, so the
// emitter runs one block an SM (two at 32). Past 64 a warp holds 16 pixels
// (2 n8 tiles) in place of 32, so its split B fragments stay at 48 (96
// lanes) and 64 (128) registers beside the row tile's A fragments (as
// many), and runs all 8 row tiles of the unit: 8 pixel groups of one row
// group
template <int FD>
constexpr int A1_NT = FD <= 64 ? 4 : 2;          // n8 tiles (8 pixels) a warp
template <int FD>
constexpr int A1_WP = A1_TN / (8 * A1_NT<FD>);   // pixel groups a unit (4 | 8)
template <int FD>
constexpr int A1_ML = A1_TM / 16 / (A1_THREADS / 32 / A1_WP<FD>);  // row tiles a warp
// The split: big + small (split2) in general; big + mid + lo (split3,
// mma_common.cuh) for the f32 store past 64 lanes, where the fp16 small
// part's error, up to 2^-23 a lane (four f32 roundings), summed over 81 or
// 121 lanes takes the f32 entries past the plain f32 version's error
// against f64, while one bf16 ulp of the bf16 store hides it. There the
// norms are f64 sums rounded once, as the f32 K5/K6 form them
// (recompute_matvec.cu): an f32 FMA chain's rounding over 121 lanes
// moves every entry of a row or column together
template <int FD, bool BF16_OUT>
constexpr int A1_PARTS = (FD > 64 && !BF16_OUT) ? 3 : 2;
// one 128-row block of split A: its fragments ([m16 tile][k16 step][big |
// small, or big | mid | lo][lane] x 16 bytes), then the rows' norms and
// their -2 2^Ea
template <int FD, int PARTS>
constexpr int A1_FRAG_BYTES = (A1_TM / 16) * (FD / 16) * PARTS * 32 * 16;
template <int FD, int PARTS>
constexpr int A1_ABLK = A1_FRAG_BYTES<FD, PARTS> + 2 * A1_TM * 4;
constexpr int A1_BOX = 16384;     // one staged TMA box: 128 rows x 128 bytes
// A blocks in flight: two, the next unit's arriving while one runs; one
// for the f32 store past 64 lanes, whose two 64 KB staging buffers and two
// A blocks (73 or 97 KB each) pass the 232,448 bytes a block may take
template <int FD, bool BF16_OUT>
constexpr int A1_ABUFS = (FD > 64 && !BF16_OUT) ? 1 : 2;

template <int FD, bool BF16_OUT>
constexpr size_t a1_smem() {
  // alignment slack, two staged units, the A blocks, their barriers
  return 1024 + 2 * (size_t)A1_TM * A1_TN * (BF16_OUT ? 2 : 4) +
         A1_ABUFS<FD, BF16_OUT> * (size_t)A1_ABLK<FD, A1_PARTS<FD, BF16_OUT>> + 16;
}
static_assert(a1_smem<96, true>() == 166928 && a1_smem<128, true>() == 199696 &&
                  a1_smem<96, false>() == 206864 && a1_smem<128, false>() == 231440,
              "K1's shared memory past 64 lanes");
static_assert(a1_smem<128, true>() <= 232448 && a1_smem<128, false>() <= 232448 &&
                  a1_smem<64, false>() <= 232448,
              "K1's blocks fit an SM");

// the split A blocks of rows [0, p_pad): thread r splits row r
template <int FD, int PARTS>
__global__ void affinity_split_kernel(const float* __restrict__ a, unsigned char* __restrict__ out,
                                      int p, int d, int p_pad) {
  constexpr int KS = FD / 16;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= p_pad) return;
  float x[FD];
  float m = 0.f, nrm = 0.f;
  [[maybe_unused]] double nrm64 = 0.0;   // PARTS 3: the norm as an f64 sum
#pragma unroll
  for (int k = 0; k < FD; ++k) {
    x[k] = (r < p && k < d) ? a[(size_t)r * d + k] : 0.f;
    m = fmaxf(m, fabsf(x[k]));
    if constexpr (PARTS == 2)
      nrm = fmaf(x[k], x[k], nrm);
    else
      nrm64 = fma((double)x[k], (double)x[k], nrm64);
  }
  if constexpr (PARTS == 3) nrm = (float)nrm64;
  const int e = vec_exp(m);
  const float sinv = pow2(-e);
  unsigned char* blk = out + (size_t)(r / A1_TM) * A1_ABLK<FD, PARTS>;
  const int rr = r % A1_TM, mt = rr / 16, g = rr % 8, hi = (rr % 16) / 8;
#pragma unroll
  for (int k = 0; k < FD; ++k) {
    // A fragment register (row g | g + 8) x (k 2tq, 2tq + 1 | 2tq + 8, 2tq + 9)
    const int ks = k / 16, kk = k % 16, tq = (kk % 8) / 2;
    const int reg = hi + 2 * (kk / 8);
    const size_t off = (size_t)((mt * KS + ks) * PARTS) * 512 + (g * 4 + tq) * 16 + reg * 4 +
                       (kk % 2) * 2;
    if constexpr (PARTS == 2) {
      const float2 bs = split2(x[k], sinv);
      *reinterpret_cast<__half*>(blk + off) = __float2half_rn(bs.x);
      *reinterpret_cast<__half*>(blk + off + 512) = __float2half_rn(bs.y);
    } else {
      const float3 bs = split3(x[k], sinv);
      *reinterpret_cast<__half*>(blk + off) = __float2half_rn(bs.x);
      *reinterpret_cast<__half*>(blk + off + 512) = __float2half_rn(bs.y);
      *reinterpret_cast<__half*>(blk + off + 1024) = __float2half_rn(bs.z);
    }
  }
  float* tail = reinterpret_cast<float*>(blk + A1_FRAG_BYTES<FD, PARTS>);
  tail[rr] = nrm;
  tail[A1_TM + rr] = -2.f * pow2(e);
}

template <int FD, bool BF16_OUT>
__global__ __launch_bounds__(A1_THREADS, FD == 32 ? 2 : 1) void affinity_kernel(
    const __grid_constant__ CUtensorMap out_map,
    const unsigned char* __restrict__ asplit,   // split A blocks (affinity_split_kernel)
    const float* __restrict__ b,                // (n, d) pixel features
    int n, int d, int nrb) {
  constexpr int KS = FD / 16, PARTS = A1_PARTS<FD, BF16_OUT>;
  constexpr int ABLK = A1_ABLK<FD, PARTS>, FRAG = A1_FRAG_BYTES<FD, PARTS>;
  constexpr int NT = A1_NT<FD>, WP = A1_WP<FD>, ML = A1_ML<FD>;
  constexpr int ABUFS = A1_ABUFS<FD, BF16_OUT>;
  constexpr int STAGE = A1_TM * A1_TN * (BF16_OUT ? 2 : 4);
  extern __shared__ unsigned char a1_raw[];
  unsigned char* smem = a1_raw + ((1024 - (smem_u32(a1_raw) & 1023)) & 1023);
  unsigned char* abuf = smem + 2 * STAGE;
  const uint32_t bar0 = smem_u32(abuf + ABUFS * ABLK);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3, wp = warp % WP, wr = warp / WP;
  const long long units = (long long)nrb * ((n + A1_TN - 1) / A1_TN);
  const int t0 = (int)(blockIdx.x * units / gridDim.x);
  const int t1 = (int)((blockIdx.x + 1) * units / gridDim.x);

  if (tid == 0) {
    for (int i = 0; i < ABUFS; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = t0; t < min(t0 + ABUFS, t1); ++t) {
      const uint32_t bar = bar0 + 8 * (t - t0);
      mbar_expect_tx(bar, ABLK);
      bulk_copy(smem_u32(abuf + (t - t0) * ABLK), asplit + (size_t)(t % nrb) * ABLK,
                ABLK, bar);
    }
  }
  __syncthreads();

  // this warp's 8 NT pixels as split B fragments ([n8 tile][k16 step][b0 |
  // b1]: big, small or mid, and lo) and, for the accumulator's pixels 2tq,
  // 2tq + 1 of each n8 tile, their norms and 2^Eb
  uint32_t bb[NT][KS][2], bsm[NT][KS][2];
  [[maybe_unused]] uint32_t blo[PARTS == 3 ? NT : 1][PARTS == 3 ? KS : 1][2];
  float nb[NT][2], sc[NT][2];
  int ct_held = -1;

  for (int t = t0, q = 0; t < t1; ++t, ++q) {
    const int ct = t / nrb, rb = t % nrb;
    if (ct != ct_held) {
      ct_held = ct;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = ct * A1_TN + 8 * NT * wp + 8 * nt + g;   // this lane's B column
        const float* fj = b + (size_t)min(j, n - 1) * d;
        auto feat = [&](int k) { return (j < n && k < d) ? fj[k] : 0.f; };
        float m = 0.f, nrm = 0.f;
        [[maybe_unused]] double nrm64 = 0.0;
        for (int k = 0; k < d; ++k) {
          const float x = fj[k] * (j < n);
          m = fmaxf(m, fabsf(x));
          if constexpr (PARTS == 2)
            nrm = fmaf(x, x, nrm);
          else
            nrm64 = fma((double)x, (double)x, nrm64);
        }
        if constexpr (PARTS == 3) nrm = (float)nrm64;
        const int e = vec_exp(m);
        const float sinv = pow2(-e), scale = pow2(e);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int k = 16 * ks + 2 * tq;
          if constexpr (PARTS == 2) {
            const float2 p0 = split2(feat(k), sinv), p1 = split2(feat(k + 1), sinv);
            const float2 p8 = split2(feat(k + 8), sinv), p9 = split2(feat(k + 9), sinv);
            bb[nt][ks][0] = h2(p0.x, p1.x);
            bb[nt][ks][1] = h2(p8.x, p9.x);
            bsm[nt][ks][0] = h2(p0.y, p1.y);
            bsm[nt][ks][1] = h2(p8.y, p9.y);
          } else {
            const float3 p0 = split3(feat(k), sinv), p1 = split3(feat(k + 1), sinv);
            const float3 p8 = split3(feat(k + 8), sinv), p9 = split3(feat(k + 9), sinv);
            bb[nt][ks][0] = h2(p0.x, p1.x);
            bb[nt][ks][1] = h2(p8.x, p9.x);
            bsm[nt][ks][0] = h2(p0.y, p1.y);
            bsm[nt][ks][1] = h2(p8.y, p9.y);
            blo[nt][ks][0] = h2(p0.z, p1.z);
            blo[nt][ks][1] = h2(p8.z, p9.z);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {   // pixel 2tq + c is held by lanes (2tq + c) * 4 + ..
          nb[nt][c] = __shfl_sync(0xffffffffu, nrm, (2 * tq + c) * 4);
          sc[nt][c] = __shfl_sync(0xffffffffu, scale, (2 * tq + c) * 4);
        }
      }
    }
    const unsigned char* A = abuf + (q % ABUFS) * ABLK;
    const float* na_s = reinterpret_cast<const float*>(A + FRAG);
    const float* m2_s = na_s + A1_TM;
    unsigned char* stage = smem + (q & 1) * STAGE;
    if (tid == 0) bulk_wait_read<1>();   // the store of unit q - 2 has left this stage
    mbar_wait(bar0 + 8 * (q % ABUFS), (q / ABUFS) & 1);
    __syncthreads();

#pragma unroll 1
    for (int ml = 0; ml < ML; ++ml) {
      const int mt = wr * ML + ml;
      // the row tile's big and small (or mid) A fragments; lo (PARTS 3)
      // is read where it is used
      uint32_t ab[KS][4], as[KS][4];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint4 vb =
            *reinterpret_cast<const uint4*>(A + ((mt * KS + ks) * PARTS) * 512 + lane * 16);
        const uint4 vs =
            *reinterpret_cast<const uint4*>(A + ((mt * KS + ks) * PARTS + 1) * 512 + lane * 16);
        ab[ks][0] = vb.x, ab[ks][1] = vb.y, ab[ks][2] = vb.z, ab[ks][3] = vb.w;
        as[ks][0] = vs.x, as[ks][1] = vs.y, as[ks][2] = vs.z, as[ks][3] = vs.w;
      }
      const int r0 = mt * 16 + g;   // rows r0, r0 + 8 of the unit; r0 & 7 == g
      const float na[2] = {na_s[r0], na_s[r0 + 8]}, m2a[2] = {m2_s[r0], m2_s[r0 + 8]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // big.big a k16 step from zero (16 products on the 2^-20 grid:
        // exact in f32), the k16 steps added in pairs, the pairs in order;
        // the corrections in a third chain (two, 2^-11 and 2^-22 of the
        // cross, as the f32 K5/K6 run them, for PARTS 3)
        float big[4], cr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kp = 0; kp < KS / 2; ++kp) {
          float h0[4] = {0.f, 0.f, 0.f, 0.f}, h1[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816h(h0, ab[2 * kp], bb[nt][2 * kp][0], bb[nt][2 * kp][1]);
          mma16816h(h1, ab[2 * kp + 1], bb[nt][2 * kp + 1][0], bb[nt][2 * kp + 1][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) big[e] = kp == 0 ? h0[e] + h1[e] : big[e] + (h0[e] + h1[e]);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma16816h(cr, ab[ks], bsm[nt][ks][0], bsm[nt][ks][1]);
          mma16816h(cr, as[ks], bb[nt][ks][0], bb[nt][ks][1]);
        }
        if constexpr (PARTS == 3) {
          float c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint4 vl = *reinterpret_cast<const uint4*>(
                A + ((mt * KS + ks) * PARTS + 2) * 512 + lane * 16);
            const uint32_t al[4] = {vl.x, vl.y, vl.z, vl.w};
            mma16816h(c2, as[ks], bsm[nt][ks][0], bsm[nt][ks][1]);
            mma16816h(c2, ab[ks], blo[nt][ks][0], blo[nt][ks][1]);
            mma16816h(c2, al, bb[nt][ks][0], bb[nt][ks][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cr[e] = fmaf(c2[e], 2.384185791015625e-7f, cr[e] * 4.8828125e-4f);
        }
        // accumulator (row g | g + 8, pixel 2tq | 2tq + 1): d2 as the plain
        // version forms it, (na + nb) - 2 cross, rounded once
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float cross = big[e] + cr[e];
          const float d2 = fmaf(m2a[e >> 1] * sc[nt][e & 1], cross, na[e >> 1] + nb[nt][e & 1]);
          v[e] = BF16_OUT ? kexp(d2) : expf(-fmaxf(d2, 0.f));
        }
        const int ni = NT * wp + nt;   // the unit's n8 tile
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (BF16_OUT) {   // box ni / 8, 16-byte chunk ni % 8 of the row
            const int chunk = ni & 7;
            *reinterpret_cast<uint32_t*>(stage + (ni >> 3) * A1_BOX + r * 128 +
                                         ((chunk ^ g) << 4) + tq * 4) =
                pack2(v[2 * h], v[2 * h + 1]);
          } else {          // box ni / 4, chunk 2 (ni % 4) + tq / 2
            const int chunk = 2 * (ni & 3) + (tq >> 1);
            *reinterpret_cast<float2*>(stage + (ni >> 2) * A1_BOX + r * 128 + ((chunk ^ g) << 4) +
                                       (tq & 1) * 8) = make_float2(v[2 * h], v[2 * h + 1]);
          }
        }
      }
    }
    fence_async_smem();
    __syncthreads();   // the unit is staged; its A block is free
    if (tid == 0) {
      constexpr int BOXES = BF16_OUT ? 2 : 4, BOX_COLS = A1_TN / BOXES;
#pragma unroll
      for (int bx = 0; bx < BOXES; ++bx)
        tma_store(&out_map, smem_u32(stage + bx * A1_BOX), ct * A1_TN + bx * BOX_COLS, rb * A1_TM);
      bulk_commit();
      if (t + ABUFS < t1) {
        const uint32_t bar = bar0 + 8 * (q % ABUFS);
        mbar_expect_tx(bar, ABLK);
        bulk_copy(smem_u32(abuf + (q % ABUFS) * ABLK),
                  asplit + (size_t)((t + ABUFS) % nrb) * ABLK, ABLK, bar);
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int FD, bool BF16_OUT>
int launch_affinity(const CUtensorMap& map, const unsigned char* asplit, const float* b, int n,
                    int d, int nrb, cudaStream_t s) {
  constexpr size_t smem = a1_smem<FD, BF16_OUT>();
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaFuncSetAttribute(affinity_kernel<FD, BF16_OUT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_kernel<FD, BF16_OUT>,
                                                      A1_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long units = (long long)nrb * ((n + A1_TN - 1) / A1_TN);
  const int grid = (int)((long long)occ * sms < units ? (long long)occ * sms : units);
  affinity_kernel<FD, BF16_OUT><<<grid, A1_THREADS, smem, s>>>(map, asplit, b, n, d, nrb);
  return static_cast<int>(cudaGetLastError());
}

// the split, then the emitter, at feature depth FD and store
template <int FD, bool BF16_OUT>
int launch_split_affinity(const float* a, const float* b, unsigned char* asplit,
                          const CUtensorMap& map, int p, int n, int d, cudaStream_t s) {
  const int nrb = (p + A1_TM - 1) / A1_TM;
  affinity_split_kernel<FD, A1_PARTS<FD, BF16_OUT>>
      <<<(nrb * A1_TM + 127) / 128, 128, 0, s>>>(a, asplit, p, d, nrb * A1_TM);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_affinity<FD, BF16_OUT>(map, asplit, b, n, d, nrb, s);
}

template <int FD>
int launch_split_affinity_fd(const float* a, const float* b, unsigned char* asplit,
                             const CUtensorMap& map, int p, int n, int d, int out_bf16,
                             cudaStream_t s) {
  return out_bf16 ? launch_split_affinity<FD, true>(a, b, asplit, map, p, n, d, s)
                  : launch_split_affinity<FD, false>(a, b, asplit, map, p, n, d, s);
}

}  // namespace

extern "C" {

// bytes of the split-A scratch for p sample rows of d feature lanes
// (of the store whose split takes more: the f32 one's past 64 lanes)
size_t glt_affinity_scratch_bytes(int p, int d) {
  return (size_t)((p + A1_TM - 1) / A1_TM) *
         (d <= 32   ? A1_ABLK<32, 2>
          : d <= 64 ? A1_ABLK<64, 2>
          : d <= 96 ? A1_ABLK<96, 3>
                    : A1_ABLK<128, 3>);
}

// K1. a (p, d) and b (n, d) row-major f32 features, d <= 128 (the kernel
// of the least depth of 32, 64, 96 and 128 that holds d); out (p, ld)
// bf16 (out_bf16) or f32 with ld >= n, rows 16 bytes apart in multiples and
// a 16-byte aligned base; scratch holds glt_affinity_scratch_bytes(p) bytes,
// 16-byte aligned (the wrapper checks).
int glt_affinity_strip(const void* a, const void* b, void* scratch, void* out, int p, int n,
                       int d, int ld, int out_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p < 1 || n < 1 || d < 1 || d > 128 || ld < n)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  if (!tile_map(&map, out, !out_bf16, n, p, ld, out_bf16 ? 64 : 32, A1_TM))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  unsigned char* asplit = static_cast<unsigned char*>(scratch);
  return d <= 32   ? launch_split_affinity_fd<32>(af, bf, asplit, map, p, n, d, out_bf16, s)
         : d <= 64 ? launch_split_affinity_fd<64>(af, bf, asplit, map, p, n, d, out_bf16, s)
         : d <= 96 ? launch_split_affinity_fd<96>(af, bf, asplit, map, p, n, d, out_bf16, s)
                   : launch_split_affinity_fd<128>(af, bf, asplit, map, p, n, d, out_bf16, s);
}

}  // extern "C"
