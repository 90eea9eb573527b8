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
//   plain f32  k = exp(-max(na + nb - 2 cross, 0)) with the norms summed from
//              the same f32 feature values and the cross at the precision the
//              reference's "highest" asks for (the GEMM trick cancels): on the
//              TPU a multi-pass bf16 product on the matrix unit, here its card
//              counterpart, a split-precision tensor-core product (fp16
//              big, mid and lo parts of scaled features, the six products
//              above 2^-33 of the cross kept); on features that carry
//              coordinates, an IEEE f32 FFMA cross over the live lanes
//              (coord_tile_kernel, below).
//
// Both are one sum, out[f] = sum_s w_s k(f, s), over two k-major (FD, L)
// feature matrices, FD 32, 64, 96 or 128 lanes (an NLM 5 x 5, 7 x 7, 9 x 9
// or 11 x 11 patch, and on coordinate features each of them with the
// coordinates, or a gaussian's 3 lanes): K5 fixes the
// sample rows (fa^T, which the wrapper transposes) and streams the pixel
// columns (f_t) against w = v; K6 fixes the columns and streams the rows
// against w = t. d2 is symmetric in the roles, so
// one kernel per layout serves both.
//
// What bounds them on an H100. Config 3 (aug, p_pad 4096, n 1048576): 4.3e9
// tile entries a launch; d2 is 0.28 TFLOP bf16 (0.28 ms at 989 TFLOP/s). The
// entry bf16(exp(-bf16(max(d2, 0)))) is a function of the 16-bit bf16(d2)
// alone, so it needs no exp: one conflict-free shared-memory load an entry
// (32 lanes a clock an SM) or 8 f32 operations an entry give 0.51 ms at 132
// SMs, the bound. An IEEE expf an entry (the first port) cost ~10 FP32-pipe
// instructions and one MUFU: 3.1 ms a launch (NVIDIA H100 80GB HBM3,
// 700.00 W). 8 MP (f32, p_pad 4096, n 8388608): 3.4e10 entries; the cross
// is 2.2 TFLOP, six fp16 passes of it 13.4 ms at the card's 989 TFLOP/s
// (as an IEEE-f32 SIMT product 37 ms at 67), the bound; each entry's
// epilogue (two adds, the scale, d2, max, expf, the FMA into its sum) is
// ~15 FP32-pipe instructions, ~15 ms of issue, and one MUFU ex2 (8.2 ms).
// Memory is small beside either (features 64-128 B a column, read once
// from device memory; the fixed side's tile re-reads come from L2). At 64
// lanes the d2 product doubles: aug 0.56 TFLOP at config 3 (0.56 ms, now
// the bound beside 0.51 of table loads), f32 six fp16 passes of 4.4 TFLOP
// at 8 MP (26.7 ms); at 96 and 128 lanes aug 0.83 / 1.11 ms and f32 40.0 /
// 53.4 ms, the d2 product the bound of both.
//
// Design, aug (tensor cores, an entry table): persistent blocks, one an SM,
// walk work items (a 1024-entry slice of the fixed side by a split of the
// streamed side). Each block first builds the entry table, 128 KB, one
// 2-byte entry for each bf16(d2) pattern, with the same kb_aug the plain
// route evaluates, so a lookup is bit-identical to it: an entry is
// bf16(max(d2, 0)) (a pair at a time) and one 2-byte shared load. The loads fall on
// random banks; copies of the 1979 live patterns (16 or 32 a bank, fewer
// wavefronts) need a clamp and more address arithmetic, and measured
// slower. A producer warp keeps a ring of 256-entry streamed tiles (32 rows
// and w, bulk copies completing on mbarriers) in flight; 16 consumer warps
// each hold 64 fixed entries as bf16 A fragments in registers for the item
// and release a stage by an mbarrier arrive, so no block barrier stalls
// them. At 64 lanes a warp holds 32 fixed entries (16 A-fragment registers
// a 16-row tile, so 64 entries would take 64 registers of the 120 a
// thread of 544 may have), a work item 512, and the ring 2 stages of 256
// (34 KB each beside the 128 KB table; 4 of 128 fit too, and ran no
// faster: scripts/matvec_designs.py --patch 7). Past 64 lanes a stage of
// 256 entries beside the table passes the block's shared memory (233,504
// bytes at 96 lanes, two stages): at 96 lanes the ring takes 2 stages of
// 128 (a span each) beside the table; at 128 the entries come from kb_pair
// (K7's: kexp on bf16(d2), equal to the table at every pattern) with no
// table, beside 3 stages of 256, and a warp holds 16 fixed entries (32
// A-fragment registers), a work item 256. Each route measured faster at
// its width (scripts/matvec_designs.py --patch 9 / 11, PERF.md: the table
// at 128 lanes, 2 stages of 128, ran 25% slower; kb_pair at 96, 12%).
// The w product runs on the FP32 pipe at every depth: by mma, whose
// accumulation truncates the products it aligns below its largest, K6's
// sums sat below the f64 sums of the same bf16 entries on 0.88 of config
// 3's columns at 32 and 64 lanes, and below its plain version's on 98% of
// a synthetic test's columns at 81 and 121 lanes, where a span's entries
// spread over more octaves (PERF.md; scripts/matvec_designs.py variant
// ``mma w`` keeps the mma). A warp's d2 is FD / 16 m16n8k16 mma per 16 x 8
// sub-tile (one chain from zero), the entries replace the accumulator in
// place (the accumulator layout is the A-fragment layout), and the packed
// bf16 tile times bf16(w) is 8 f32 FMAs a lane, each product exact, the
// quad's four partial sums joined by shuffles at the end. Each 128-entry
// span's sums start from zero and join the running sums by an f32 add, so
// no f32 chain runs over more than a span's terms. Measured
// (scripts/matvec_designs.py, PERF.md): the entry path (rounding, address,
// two loads, the pack) holds it; a wgmma design
// (three warpgroups, d2 from a TMA ring) ran slower, its entry path alone
// as long.
// Design, f32 (tensor cores, split fp16): each feature vector is scaled
// by 2^-E (exact), E the exponent of its largest entry, and each scaled
// feature is big + mid + lo (split3, mma_common.cuh), each exact in fp16:
// big on the grid 2^-10, mid the rest on the grid 2^-21, lo what remains
// (mid and lo scaled up by 2^11 and 2^22 into fp16's normal range); cross =
// 2^(Ea + Eb) (big.big + 2^-11 (big.mid + mid.big) + 2^-22 (mid.mid +
// big.lo + lo.big)), the terms below 2^-33 dropped: six m16n8k16 fp16
// passes, fp16 having tf32's 11 significant bits at twice its tensor-core
// rate. The norms are f64 sums rounded once to f32: a norm's rounding
// moves every entry of its row (column) together, and a sequential f32
// FMA chain rounds more than the plain version's pairwise sum of squares.
// Measured on the 8 MP matvec denoise (scripts/f32_matvec_designs.py,
// PERF.md): with FMA-chain norms the first split design (two parts, big +
// fp16(rest), three passes) left K5's and K6's sums at 1.3-2.4x the plain
// version's error from their f64 values, where every other f32 kernel
// stays within 1.5x, and the three-part split and the IEEE-f32 FFMA cross
// (the coordinate kernel then, one fixed entry a thread over the layout's
// depth, 1.3x slower) at 1.7-2.2x; with f64-sum norms (+2-6% time) the two-part split still reached 2.4x (its
// fp16 small part keeps 11 of the rest's ~14 bits, an error of up to
// 2^-23 a lane, four f32 roundings), the three-part split 0.2-0.6x. A
// 128-thread block
// owns 128 fixed entries, each warp 32 of them as big, mid and lo A
// fragments in registers for the whole run; 128-entry streamed tiles
// arrive by cp.async into one raw stage, which the block splits once into
// shared memory as B fragments (24 bytes a lane) before the next tile
// streams in behind the products. Per 16 x 8 sub-tile a warp runs 6 FD / 16
// m16n8k16 mma (big.big a k16 step each from zero, added in pairs in f32,
// the 2^-11 terms in one more chain and the 2^-22 terms in a third), then
// the epilogue on the accumulator
// registers: d2 = max((nf + ns) - 2 cross, 0) with the f32 norms nf and ns
// as above, expf (IEEE class: no bf16
// rounding here to hide a cheaper exp), an f32 FMA with w into the tile's
// sum of each fixed entry, which joins its running sum by one
// compensated f32 add a tile (the bits each add drops are carried into the
// next: K5's rows run 8192 tiles a split at 8 MP, and on NLM features the
// tiles far from a row's few live entries sum to less than half an ulp of
// the running sum, so a plain add dropped them, every one the same way:
// 0.63 (32 lanes) and 0.73 (64) of K5's rows lay below their f64 sums, and
// as many with each row's own sample pixel zeroed out of v, while K6's
// columns, 32 tiles long, did not lean; scripts/f32_matvec_designs.py);
// the quad's lanes meet by a shuffle tree at the end. At 64 lanes
// the block keeps 128 threads, one streamed column a thread for the norms
// and scales, and each warp splits 16 (n8 tile, k16 step) fragments of a
// tile in place of 8: 256 threads would halve the fixed entries a warp
// holds or leave half the threads idle in the norms, for a split that is
// a small part of a tile's work. Its shared memory (85 KB: the split
// fragments and one raw stage) and the fragments' 96 registers allow two
// blocks an SM, not four. At 96 and 128 lanes the shared memory (124 and
// 165 KB) allows one block an SM, and two fixed 16-tiles a warp would take
// 144 and 192 registers of A fragments: the block runs 8 warps of one
// 16-tile each (the same 128 fixed entries, so each split B tile serves as
// many products as at 64 lanes), the first 128 threads alone in the norms.
// Both: the streamed axis splits (the f32 kernel's grid.y, the aug kernel's
// work items) only where the fixed side alone does not fill the card (K5),
// as many splits as fill one wave of the kernel's resident blocks
// (glt_recompute_slots); per-split partials are then summed by a
// fixed-order reduction kernel. No float atomics: runs repeat bit for bit.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() (or the first error).

#include "mma_common.cuh"

namespace {

// Both layouts' kernels take the feature depth FD as a template parameter:
// 32 (NLM 5 x 5: the aug layout of d 25, the plain of d 25), 64 (NLM 7 x
// 7: the aug layout's 55 lanes, the plain layout's 49), 96 (9 x 9: 87 and
// 81) or 128 (11 x 11: 127 and 121). At 32 and 64 they run the same chains
// in the same order as before the wider instantiations.
constexpr int A_WARPS = 16;             // aug: consumer warps a block
constexpr int A_THREADS = 32 * (A_WARPS + 1);   // aug: + one producer warp
// aug: fixed 16-tiles a warp. At 64 lanes a warp's fixed A fragments are 16
// registers a 16-tile, and 4 tiles (64 registers) beside the streamed B
// fragments, the span sums and the entry path pass the 120 registers a
// thread of 544 threads on one SM: 2 tiles, 512 fixed entries a work item;
// at 96 lanes 2 tiles too (48 registers), at 128 one (32)
template <int FD>
constexpr int A_RT_OF = FD == 32 ? 4 : FD == 128 ? 1 : 2;
template <int FD>
constexpr int A_FT_OF = A_WARPS * A_RT_OF<FD> * 16;   // fixed entries a work item (1024 | 512 | 256)
template <int FD>
constexpr bool A_TABLE_OF = FD <= 96;   // aug: the entry from the table, else kb_pair
template <int FD>
constexpr int A_ST_OF = FD == 96 ? 128 : 256;   // aug: streamed entries a ring stage
template <int FD>
constexpr int A_STAGES_OF = FD == 32 ? 4 : FD == 128 ? 3 : 2;   // aug: ring depth
constexpr int A_SPAN = 128;             // aug: streamed entries a tile sum runs from zero
template <int FD>
constexpr int A_LDS_OF = A_ST_OF<FD> + 8;   // padded stage row (528 B at 256): ldmatrix conflict-free
template <int FD>
constexpr int A_STAGE_BYTES_OF = 2 * (FD * A_LDS_OF<FD> + A_ST_OF<FD>);  // FD feature rows and w
// the entry table: the bf16 entry of every one of the 65536 bf16(d2)
// patterns (chip_smoke.py checks each against kb_aug on the card)
constexpr size_t TAB_BYTES = 65536 * 2;
// the table, the ring, 2 barriers a stage. At 64 lanes a 256-entry stage
// is 34,304 bytes: 4 stages (268,352 in all) or 3 (233,984) pass the
// 232,448 a block may take; 2 take 199,712, as 4 stages of 128 entries
// (201,792) would. At 96 lanes 2 stages of 256 would take 233,504; 2 of 128
// take 183,840. At 128, with no table, 3 stages of 256 take 204,336
template <int FD>
constexpr size_t A_SMEM_OF = (A_TABLE_OF<FD> ? TAB_BYTES : 0) +
                             (size_t)A_STAGES_OF<FD> * A_STAGE_BYTES_OF<FD> + 16 * A_STAGES_OF<FD>;
static_assert(A_SMEM_OF<32> == 200768 && A_SMEM_OF<64> == 199712 && A_SMEM_OF<96> == 183840 &&
                  A_SMEM_OF<128> == 204336,
              "aug ring sizes");
static_assert(A_SMEM_OF<64> <= 232448 && A_SMEM_OF<96> <= 232448 && A_SMEM_OF<128> <= 232448,
              "an aug block fits an SM");
static_assert(A_STAGE_BYTES_OF<32> % 16 == 0 && A_STAGE_BYTES_OF<64> % 16 == 0 &&
                  A_STAGE_BYTES_OF<96> % 16 == 0 && A_STAGE_BYTES_OF<128> % 16 == 0,
              "alignment");
static_assert(A_ST_OF<32> % A_SPAN == 0 && A_ST_OF<96> % A_SPAN == 0 && A_SPAN % 16 == 0,
              "aug spans");
// f32: warps a block, 4 up to 64 lanes, 8 past them
template <int FD>
constexpr int T_WARPS_OF = FD <= 64 ? 4 : 8;
template <int FD>
constexpr int T_THREADS_OF = 32 * T_WARPS_OF<FD>;
// f32: blocks an SM (registers; shared memory, 44 KB at 32 lanes, 85 KB
// at 64, 124 and 165 KB at 96 and 128)
template <int FD>
constexpr int T_BLOCKS_SM_OF = FD == 32 ? 4 : FD == 64 ? 2 : 1;
template <int FD>
constexpr int T_RT_OF = FD <= 64 ? 2 : 1;   // f32: fixed 16-tiles a warp
constexpr int T_FT = 128;               // f32: fixed entries a block
constexpr int T_ST = 128;               // f32: streamed entries a tile, one a norm thread
constexpr int T_LDS = T_ST + 4;         // padded raw row: conflict-free split loads
template <int FD>
constexpr int T_BFRAGS_OF = (T_ST / 8) * (FD / 16) * 32;  // B fragments a tile, a lane each
// the split B fragments (24 bytes a lane: big and mid a uint4, lo a
// uint2), one raw stage, w twice, the streamed norms and scales
template <int FD>
constexpr size_t T_SMEM_OF =
    24 * (size_t)T_BFRAGS_OF<FD> + sizeof(float) * ((size_t)FD * T_LDS + 2 * T_ST + 3 * T_ST);
static_assert(T_SMEM_OF<32> == 44032 && T_SMEM_OF<64> == 85504 && T_SMEM_OF<96> == 126976 &&
                  T_SMEM_OF<128> == 168448,
              "f32 shared memory");
static_assert(4 * (T_SMEM_OF<32> + 1024) <= 233472 && 2 * (T_SMEM_OF<64> + 1024) <= 233472 &&
                  T_SMEM_OF<128> <= 232448,
              "the f32 blocks an SM fit its shared memory");
static_assert(T_WARPS_OF<32> * T_RT_OF<32> * 16 == T_FT &&
                  T_WARPS_OF<128> * T_RT_OF<128> * 16 == T_FT,
              "f32: 128 fixed entries a block");
static_assert(T_THREADS_OF<32> == T_ST && T_THREADS_OF<128> >= T_ST,
              "f32: one streamed column a norm thread");

// columns [c0, c0 + tile) of a k-major (FD, ld) matrix -> dst[k][0, tile)
// (row stride lds elements), and w[c0, c0 + tile) -> wdst, by cp.async in
// 16-byte chunks (8 bf16 or 4 f32); one commit group
template <int FD, int NT, typename E>
__device__ __forceinline__ void load_tile(E* dst, int lds, E* wdst, const E* __restrict__ m,
                                          const E* __restrict__ w, size_t ld, size_t c0,
                                          int tile) {
  constexpr int V = 16 / sizeof(E);
  for (int c = threadIdx.x; c < FD * (tile / V); c += NT) {
    const int k = c / (tile / V), q = c % (tile / V);
    cp_async16(dst + k * lds + q * V, m + (size_t)k * ld + c0 + q * V);
  }
  if ((int)threadIdx.x < tile / V) cp_async16(wdst + threadIdx.x * V, w + c0 + threadIdx.x * V);
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// aug bf16: out_part[split][f] = sum_s bf16(w_s) k_aug(f, s) over the split
// ---------------------------------------------------------------------------

// the bf16 bits of the aug entry kb_aug at bf16(d2) pattern x
__device__ __forceinline__ uint32_t entry_bits(uint32_t x) {
  return __float_as_uint(kb_aug(__uint_as_float(x << 16))) >> 16;
}

// the entry table, from kb_aug: one 2-byte entry a pattern
__device__ void build_table(unsigned char* tab, int tid, int nthreads) {
  for (int x = tid; x < 65536; x += nthreads)
    reinterpret_cast<unsigned short*>(tab)[x] = (unsigned short)entry_bits(x);
}

// the table's shared address, taken after the table is built: the loads
// that add to it cannot move above that barrier
__device__ __forceinline__ uint32_t table_base(const unsigned char* tab) {
  uint32_t a = smem_u32(tab);
  asm volatile("" : "+r"(a)::"memory");
  return a;
}

__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

// two aug entries, packed bf16 (lo in the low half), from two f32 d2: the
// pair rounded to bf16 with negatives to +0 (the entry of a negative
// pattern is 1.0, as +0's), then two 2-byte table loads at the patterns
// (tl: table_base); the low pattern's sign bit is then clear, so the high
// one's byte offset is w >> 15. Lanes load where their patterns fall: a
// load takes as many shared-memory wavefronts as its busiest bank (copies
// of the live patterns a bank, or a clamp, cost more than they save:
// PERF.md)
__device__ __forceinline__ uint32_t entry2(float lo, float hi, uint32_t tl) {
  uint32_t w;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(w) : "f"(hi), "f"(lo));
  return lds16(tl + 2u * (w & 0xFFFFu)) | (lds16(tl + (w >> 15)) << 16);
}

template <int FD>
__global__ __launch_bounds__(A_THREADS, 1) void aug_sum_kernel(
    const bf16* __restrict__ fixed_t,   // (FD, Lf) k-major aug
    const bf16* __restrict__ strm_t,    // (FD, Ls) k-major aug
    const bf16* __restrict__ w,         // (Ls) bf16-rounded
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int splits, int tiles_per_split) {
  constexpr int RT = A_RT_OF<FD>, FT = A_FT_OF<FD>, ST = A_ST_OF<FD>, STAGES = A_STAGES_OF<FD>;
  constexpr int LDS = A_LDS_OF<FD>, STAGE_BYTES = A_STAGE_BYTES_OF<FD>, KS = FD / 16;
  constexpr bool TABLE = A_TABLE_OF<FD>;
  extern __shared__ __align__(16) unsigned char a_smem[];
  unsigned char* tab = a_smem;
  unsigned char* ring = a_smem + (TABLE ? TAB_BYTES : 0);
  const uint32_t full0 = smem_u32(ring + STAGES * STAGE_BYTES), empty0 = full0 + 8 * STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int items = (Lf + FT - 1) / FT * splits;
  const int ntiles = Ls / ST;

  if constexpr (TABLE) build_table(tab, tid, A_THREADS);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, A_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == A_WARPS) {
    // producer: one lane keeps the ring full, item after item
    if (lane == 0) {
      uint32_t k = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int t0 = (it % splits) * tiles_per_split;
        const int t1 = min(ntiles, t0 + tiles_per_split);
        for (int t = t0; t < t1; ++t, ++k) {
          const uint32_t st = k % STAGES;
          mbar_wait(empty0 + 8 * st, ((k / STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, dst = smem_u32(ring + st * STAGE_BYTES);
          const size_t c0 = (size_t)t * ST;
          mbar_expect_tx(full, STAGE_BYTES - 2 * FD * (LDS - ST));
          for (int kk = 0; kk < FD; ++kk)
            bulk_copy(dst + 2 * kk * LDS, strm_t + (size_t)kk * Ls + c0, 2 * ST, full);
          bulk_copy(dst + 2 * FD * LDS, w + c0, 2 * ST, full);
        }
      }
    }
    return;
  }

  // consumers: warp owns fixed entries fw .. fw + 16 RT - 1 of each item
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t tl = table_base(tab);
  const unsigned short* fx = reinterpret_cast<const unsigned short*>(fixed_t);
  uint32_t k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits;
    const int t0 = split * tiles_per_split, t1 = min(ntiles, t0 + tiles_per_split);
    const int fw = (it / splits) * FT + warp * RT * 16;
    const bool live = fw < Lf;          // Lf % 256 == 0: a last item may be part full
    uint32_t a[RT][KS][4];
    if (live) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          frag_a_kmajor(a[r][ks], fx, (size_t)Lf, fw + 16 * r, 16 * ks, g, tq);
    }
    float acc[RT][2];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.f;

    for (int t = t0; t < t1; ++t, ++k) {
      const uint32_t st = k % STAGES;
      mbar_wait(full0 + 8 * st, (k / STAGES) & 1);
      if (live) {
        const bf16* S = reinterpret_cast<const bf16*>(ring + st * STAGE_BYTES);
        const bf16* ws = S + FD * LDS;
#pragma unroll 1
        for (int sp = 0; sp < ST; sp += A_SPAN) {
          // this span's sums start from zero and join the running sums by
          // an f32 add: no chain runs over more than a span's terms
          float tacc[RT][4];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) tacc[r][e] = 0.f;
#pragma unroll 2
          for (int c = sp; c < sp + A_SPAN; c += 16) {
            // streamed c..c+7 (b0) and c+8..c+15 (b1), feature rows 32 q ..
            // 32 q + 31 a load (q < FD / 32)
            uint32_t b0[FD / 32][4], b1[FD / 32][4];
#pragma unroll
            for (int q = 0; q < FD / 32; ++q) {
              ldsm_x4_trans(b0[q], S + (32 * q + lane) * LDS + c);
              ldsm_x4_trans(b1[q], S + (32 * q + lane) * LDS + c + 8);
            }
            // the w product's operand: this lane's four streamed entries' w
            uint32_t wb[2];
            wb[0] = ld32(ws + c + 2 * tq);
            wb[1] = ld32(ws + c + 8 + 2 * tq);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              // d2: one chain over the k16 steps from zero
              float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int ks = 0; ks < KS; ++ks) {
                mma16816(d0, a[r][ks], b0[ks / 2] + 2 * (ks % 2));
                mma16816(d1, a[r][ks], b1[ks / 2] + 2 * (ks % 2));
              }
              // the accumulator layout is the A-fragment layout: fixed g |
              // g + 8 by streamed 2tq.. | 8 + 2tq..
              uint32_t kb[4];
              if constexpr (TABLE) {
                kb[0] = entry2(d0[0], d0[1], tl);
                kb[1] = entry2(d0[2], d0[3], tl);
                kb[2] = entry2(d1[0], d1[1], tl);
                kb[3] = entry2(d1[2], d1[3], tl);
              } else {
                kb[0] = kb_pair(d0[0], d0[1]);
                kb[1] = kb_pair(d0[2], d0[3]);
                kb[2] = kb_pair(d1[0], d1[1]);
                kb[3] = kb_pair(d1[2], d1[3]);
              }
              // the w product on the FP32 pipe, each product exact: rows g
              // (tacc[r][0]) and g + 8 ([2]); streamed 2tq.., 8 + 2tq..
              const float2 w0 = unpack2(wb[0]), w8 = unpack2(wb[1]);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 e0 = unpack2(kb[h]), e8 = unpack2(kb[2 + h]);
                float y = fmaf(e0.x, w0.x, tacc[r][2 * h]);
                y = fmaf(e0.y, w0.y, y);
                y = fmaf(e8.x, w8.x, y);
                tacc[r][2 * h] = fmaf(e8.y, w8.y, y);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {   // rows g and g + 8: elements 0 and 2
            acc[r][0] += tacc[r][0];
            acc[r][1] += tacc[r][2];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    if (live) {   // the quad's partial sums over its streamed columns
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[r][h] += __shfl_xor_sync(0xffffffffu, acc[r][h], 1);
          acc[r][h] += __shfl_xor_sync(0xffffffffu, acc[r][h], 2);
        }
    }
    if (live && tq == 0) {   // acc[r][0], acc[r][1]: fixed fw + 16r + g, + g + 8
      float* o = part + (size_t)split * Lf + fw;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        o[16 * r + g] = acc[r][0];
        o[16 * r + g + 8] = acc[r][1];
      }
    }
  }
}

// every bf16 pattern x (as d2) -> the aug entry's bf16 bits, by route 0
// (kb_aug evaluated) or route 1 (aug_sum_kernel's table lookup)
__global__ __launch_bounds__(1024) void aug_entries_kernel(unsigned short* out, int route) {
  extern __shared__ __align__(16) unsigned char e_smem[];
  build_table(e_smem, threadIdx.x, blockDim.x);
  __syncthreads();
  const uint32_t tl = table_base(e_smem);
  for (uint32_t i = threadIdx.x; i < 32768; i += blockDim.x) {
    const uint32_t x = 2 * i;
    const uint32_t r = route == 0 ? entry_bits(x) | (entry_bits(x + 1) << 16)
                                  : entry2(__uint_as_float(x << 16),
                                           __uint_as_float((x + 1) << 16), tl);
    out[x] = (unsigned short)(r & 0xFFFF);
    out[x + 1] = (unsigned short)(r >> 16);
  }
}

// ---------------------------------------------------------------------------
// plain f32: out_part[split][f] = sum_s w_s exp(-max(nf + ns - 2 cross, 0)),
// the cross a split-precision (big + mid + lo, fp16) tensor-core product
// ---------------------------------------------------------------------------

// the big.big k16 steps of a sub-tile entry, joined in f32: pairs, then
// pairs of pairs, then those in order: (h0 + h1) at 32 lanes, (h0 + h1) +
// (h2 + h3) at 64, that + (h4 + h5) at 96, that + ((h4 + h5) + (h6 + h7))
// at 128
template <int KS>
__device__ __forceinline__ float join_steps(const float (&hb)[KS][4], int e) {
  float big = hb[0][e] + hb[1][e];
  if constexpr (KS >= 4) big += hb[2][e] + hb[3][e];
  if constexpr (KS == 6) big += hb[4][e] + hb[5][e];
  if constexpr (KS == 8) big += (hb[4][e] + hb[5][e]) + (hb[6][e] + hb[7][e]);
  return big;
}

template <int FD>
__global__ __launch_bounds__(T_THREADS_OF<FD>, T_BLOCKS_SM_OF<FD>) void f32_sum_kernel(
    const float* __restrict__ fixed_t,  // (FD, Lf) k-major
    const float* __restrict__ strm_t,   // (FD, Ls) k-major
    const float* __restrict__ w,        // (Ls)
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int tiles_per_split) {
  constexpr int KS = FD / 16, T_BFRAGS = T_BFRAGS_OF<FD>, T_RT = T_RT_OF<FD>;
  constexpr int T_THREADS = T_THREADS_OF<FD>, T_WARPS = T_WARPS_OF<FD>;
  extern __shared__ __align__(16) float fsm[];
  // the tile's B fragments, split: [n8 tile][k16 step][lane] = fp16 pairs
  // (big rows 2tq, 2tq + 1 | big rows 2tq + 8, 2tq + 9 | the same mids)
  // and (the same los), column g; a warp reads 512 + 256 contiguous bytes
  uint4* bs = reinterpret_cast<uint4*>(fsm);
  uint2* bl = reinterpret_cast<uint2*>(bs + T_BFRAGS);
  float* raw = reinterpret_cast<float*>(bl + T_BFRAGS);   // [FD][T_LDS] the tile as loaded
  float* w_s = raw + FD * T_LDS;        // [2][T_ST]
  float* ns_s = w_s + 2 * T_ST;         // [T_ST] streamed norms of the tile
  float* sinv_s = ns_s + T_ST;          // [T_ST] their scales 2^-E
  float* sc_s = sinv_s + T_ST;          // [T_ST] and 2^E
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = Ls / T_ST;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(ntiles, t0 + tiles_per_split);
  const int fw = blockIdx.x * T_FT + warp * T_RT * 16;   // this warp's fixed entries

  if (t0 < t1)
    load_tile<FD, T_THREADS>(raw, T_LDS, w_s, strm_t, w, (size_t)Ls, (size_t)t0 * T_ST, T_ST);

  // the fixed side, once: A fragments (16 fixed x 16 k) of rows g and g + 8,
  // k = 2tq, 2tq + 1, 2tq + 8, 2tq + 9 of each k16 step, split in three on
  // each row's scale; the rows' norms (f64 sums, rounded once), and -2 2^E
  uint32_t ab[T_RT][KS][4], am[T_RT][KS][4], al[T_RT][KS][4];
  float nf[T_RT][2], m2s[T_RT][2];
#pragma unroll
  for (int r = 0; r < T_RT; ++r) {
    const float* col = fixed_t + fw + 16 * r + g;
    float x[KS][2][4];                  // [k16 step][row g | g + 8][k 2tq, +1, +8, +9]
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = ks * 16 + 2 * tq + (j & 1) + 8 * (j >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = col[(size_t)k * Lf + 8 * h];
          x[ks][h][j] = v;
          m[h] = fmaxf(m[h], fabsf(v));
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
      const int e = vec_exp(m[h]);
      m2s[r][h] = -2.f * pow2(e);
      const float sinv = pow2(-e);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const float3 p0 = split3(x[ks][h][0], sinv), p1 = split3(x[ks][h][1], sinv);
        const float3 p8 = split3(x[ks][h][2], sinv), p9 = split3(x[ks][h][3], sinv);
        ab[r][ks][h] = h2(p0.x, p1.x);          // a0 / a1: k 2tq, 2tq + 1
        am[r][ks][h] = h2(p0.y, p1.y);
        al[r][ks][h] = h2(p0.z, p1.z);
        ab[r][ks][2 + h] = h2(p8.x, p9.x);      // a2 / a3: k 2tq + 8, 2tq + 9
        am[r][ks][2 + h] = h2(p8.y, p9.y);
        al[r][ks][2 + h] = h2(p8.z, p9.z);
      }
      double s = 0.0;                   // the norm, rounded once (f64 sum)
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const double v = col[(size_t)k * Lf + 8 * h];
        s = fma(v, v, s);
      }
      nf[r][h] = (float)s;
    }
  }
  float acc[T_RT][2], cmp[T_RT][2];   // the running sums, their dropped bits
#pragma unroll
  for (int r = 0; r < T_RT; ++r) acc[r][0] = acc[r][1] = cmp[r][0] = cmp[r][1] = 0.f;

  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    cp_async_wait_all();
    __syncthreads();                    // tile in; everyone done with the last tile
    if (tid < T_ST) {   // each streamed column's norm (an f64 sum, rounded once) and scale
      float m = 0.f;
      double s = 0.0;
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const float x = raw[k * T_LDS + tid];
        m = fmaxf(m, fabsf(x));
        s = fma((double)x, (double)x, s);
      }
      const int e = vec_exp(m);
      ns_s[tid] = (float)s;
      sinv_s[tid] = pow2(-e);
      sc_s[tid] = pow2(e);
    }
    __syncthreads();                    // scales in
    // the split B fragments: warp w writes the (n8 tile, k16 step) pairs q
    // = w, w + T_WARPS, ... (n8 tile q / KS, step q % KS): at 32 lanes step
    // w & 1 of every other n8 tile, at 64 step w of every n8 tile; the
    // padded rows make the loads conflict-free
#pragma unroll 2
    for (int q = warp; q < (T_ST / 8) * KS; q += T_WARPS) {
      const int nt = q / KS, ks = q % KS;
      const int c = nt * 8 + g, k = ks * 16 + 2 * tq;
      const float sinv = sinv_s[c];
      const float3 p0 = split3(raw[k * T_LDS + c], sinv);
      const float3 p1 = split3(raw[(k + 1) * T_LDS + c], sinv);
      const float3 p8 = split3(raw[(k + 8) * T_LDS + c], sinv);
      const float3 p9 = split3(raw[(k + 9) * T_LDS + c], sinv);
      bs[(nt * KS + ks) * 32 + lane] =
          make_uint4(h2(p0.x, p1.x), h2(p8.x, p9.x), h2(p0.y, p1.y), h2(p8.y, p9.y));
      bl[(nt * KS + ks) * 32 + lane] = make_uint2(h2(p0.z, p1.z), h2(p8.z, p9.z));
    }
    __syncthreads();                    // fragments in; the raw stage is free
    // the next tile streams in behind this one's products: one raw stage
    // (two, beside the split's 24-byte fragments, would pass the shared
    // memory of two 64-lane blocks an SM)
    if (tile + 1 < t1)
      load_tile<FD, T_THREADS>(raw, T_LDS, w_s + (buf ^ 1) * T_ST, strm_t, w, (size_t)Ls,
                               (size_t)(tile + 1) * T_ST, T_ST);
    const float* wt = w_s + buf * T_ST;
    // this tile's sums start from zero and join the running sums by one
    // compensated add: one f32 chain over every tile of a split (~175000
    // terms a lane at 8 MP) drops the tail of terms far below it, and ends
    // low, and so did a plain add of each tile's sum
    float tacc[T_RT][2];
#pragma unroll
    for (int r = 0; r < T_RT; ++r) tacc[r][0] = tacc[r][1] = 0.f;
#pragma unroll 1
    for (int nt = 0; nt < T_ST / 8; ++nt) {
      uint4 b[KS];
      uint2 bo[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        b[ks] = bs[(nt * KS + ks) * 32 + lane];
        bo[ks] = bl[(nt * KS + ks) * 32 + lane];
      }
      const float2 nsv = *reinterpret_cast<const float2*>(ns_s + nt * 8 + 2 * tq);
      const float2 scv = *reinterpret_cast<const float2*>(sc_s + nt * 8 + 2 * tq);
      const float2 wv = *reinterpret_cast<const float2*>(wt + nt * 8 + 2 * tq);
#pragma unroll
      for (int r = 0; r < T_RT; ++r) {
        // big.big a k16 step each, from zero (exact, see split3); big.mid
        // + mid.big (2^11 times their share) in one chain; mid.mid +
        // big.lo + lo.big (2^22 times theirs) in another
        float hb[KS][4];
        float c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) hb[ks][e] = 0.f;
          mma16816h(hb[ks], ab[r][ks], b[ks].x, b[ks].y);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma16816h(c1, ab[r][ks], b[ks].z, b[ks].w);
          mma16816h(c1, am[r][ks], b[ks].x, b[ks].y);
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma16816h(c2, am[r][ks], b[ks].z, b[ks].w);
          mma16816h(c2, ab[r][ks], bo[ks].x, bo[ks].y);
          mma16816h(c2, al[r][ks], b[ks].x, b[ks].y);
        }
        // accumulator (fixed g | g + 8, streamed 2tq | 2tq + 1); the cross
        // is 2^(Ea + Eb) times the scaled one, so d2 as the plain version
        // forms it, (nf + ns) - 2 cross, rounds once. The big.big steps
        // join pairwise (join_steps)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float big = join_steps<KS>(hb, e);
          const float cross = big + fmaf(c2[e], 2.384185791015625e-7f, c1[e] * 4.8828125e-4f);
          const float m2 = m2s[r][e >> 1] * ((e & 1) ? scv.y : scv.x);
          const float d2 = fmaxf(fmaf(m2, cross, nf[r][e >> 1] + ((e & 1) ? nsv.y : nsv.x)), 0.f);
          tacc[r][e >> 1] = fmaf(expf(-d2), (e & 1) ? wv.y : wv.x, tacc[r][e >> 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < T_RT; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // compensated (Kahan) add
        const float y = tacc[r][h] - cmp[r][h];
        const float s = acc[r][h] + y;
        cmp[r][h] = (s - acc[r][h]) - y;
        acc[r][h] = s;
      }
  }
  // the quad's four lanes share fixed rows: a fixed shuffle tree
#pragma unroll
  for (int r = 0; r < T_RT; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[r][h] -= cmp[r][h];
      acc[r][h] += __shfl_xor_sync(0xffffffffu, acc[r][h], 1);
      acc[r][h] += __shfl_xor_sync(0xffffffffu, acc[r][h], 2);
    }
  if (tq == 0) {
    float* o = part + (size_t)blockIdx.y * Lf + fw;
#pragma unroll
    for (int r = 0; r < T_RT; ++r) {
      o[16 * r + g] = acc[r][0];
      o[16 * r + g + 8] = acc[r][1];
    }
  }
}

// ---------------------------------------------------------------------------
// plain f32 on coordinate features: the IEEE f32 cross, a register tile
// ---------------------------------------------------------------------------
//
// Features that carry (row, col) / spatial_h reach |f|^2 ~ 3e5 at 8 MP,
// where the split cross's fp16 small part loses about four times the IEEE
// f32 product's error; for those the sum takes the reference's f32 class
// (kf32, mma_common.cuh): each entry's cross an f32 FFMA chain over the
// lanes in lane order from zero, its norms the same chain over its own
// lanes, so a pixel's d2 with itself is exactly 0. The kernel reads the
// L = _lanes(live, fd) live lanes (4, 28, 52, 84 or 124 on the recipes'
// layouts; any L up to 128): the pad lanes are zero, so a chain over them
// would add exact zeros, and every tile entry is the same bits as over the
// layout's whole depth.
//
// What bounds it at 8 MP (p_pad 4096, N 2^23, 3.44e10 entries): the cross,
// 2 L flop an entry, 8.5e12 flop at 124 lanes, 128.2 ms at the f32 peak
// (87.2 at 84, 54.4 at 52); each entry's epilogue (the norms' add, d2, the
// clamp, expf, the FMA with w) is ~12 FP32-pipe instructions beside it, so
// ~140 ms at 124 lanes; at 4 lanes the epilogue and one MUFU ex2 an entry
// (8.2 ms) are all of it. Memory is small: the features are read once from
// device memory (the fixed side's re-reads of the streamed tiles come from
// L2).
//
// Design (coord_tile_kernel): an SGEMM's register tile. A block of
// CT_THREADS threads owns CT_FT fixed entries (K5: sample rows; K6: pixel
// columns) and walks CT_ST-entry streamed tiles of its split. A thread
// holds CT_R fixed x CT_C streamed entries' crosses in registers (two groups
// of four consecutive entries on each side, 4 TY and 4 TX apart) and, a lane
// at a time, reads both sides' values as float4 loads of shared memory:
// (CT_R + CT_C) / 4 loads for CT_R CT_C FFMA (4 for 64 at 8 x 8; the design
// it replaced, one fixed entry a thread: one per 4). Both sides sit k-major
// in shared memory (a lane's row of entries), as the layouts lie in device
// memory, so cp.async copies them straight: a warp's 4 x 8 threads read 4
// fixed and 8 streamed float4 of one row, conflict-free. The fixed tile is
// staged once for the walk; the streamed tiles arrive by cp.async double
// buffering in chunks of at most 32 lanes (L split evenly: 4 chunks of 31
// lanes at 124, 3 of 28 at 84, 2 of 26 at 52; up to 32 lanes, up to
// CT_TPS whole tiles a stage, 4 at 4 lanes), each tile's w and streamed
// norms with its last chunk, so the stages stay small beside the fixed
// tile (104 KB a block at 124 lanes) and two blocks share an SM: 16 warps,
// at most 128 registers a thread (127, no spills). The norms come from a
// pre-pass (coord_norms_kernel: one thread an entry, the same chain; 1.3
// ms of device-memory reads at 124 lanes, 0.05 at 4), which spares the
// walk their chains and a barrier a tile. After a tile's last chunk each
// entry's epilogue runs on its cross register: a tile's sums of a
// thread's fixed entries start from zero (the first term's product) and
// join its running sums by one f32 add; at the end the CT_TX threads that
// share a fixed entry join by a fixed shuffle tree and then warp by warp
// in order, and the splits through part and launch_reduce: two launches
// give the same bits. The K5 grid fills whole waves (ops/cuda_matvec.py
// _coord_plan: 32 fixed blocks by 33 splits on 264 slots, four waves; 8
// splits left 8 slots idle, 4-6% slower). A __global__ of its own name,
// beside the tensor-core kernels that chip_smoke.py's HMMA check reads.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at the 8 MP bilateral
// shapes, scripts/coord_matvec_designs.py (PERF.md), K5 / K6 ms at 124 /
// 84 / 52 / 28 / 4 live lanes: this design 216.2 / 215.0, 151.5 / 150.5,
// 100.2 / 99.6, 60.1 / 59.9, 22.3 / 22.3 (the SM clock at its 1980 MHz
// throughout, 0.47-0.55 kW); the design it replaced 351.6 / 342.7, 259.6 /
// 251.1, 126.7 / 118.4, 70.2 / 64.2, 23.1 / 22.1; the norms in the walk
// (tid < CT_ST chaining each streamed entry's over the chunks, a barrier
// before each epilogue) 4-6% slower past 4 lanes; 8 x 4 entries a thread
// 15-23%, 128 threads (three blocks an SM) 4-14%, 4 x 4 (four blocks)
// 26-40%, one block an SM 14-18% slower; one tile a stage at 4 lanes 11%
// slower; a fixed entry's sum at a time in the epilogue 1-4% slower; 16 x
// 8 entries, 128 threads (6 float4 loads for 128 FFMA), 1-4% faster past
// 4 lanes and 4% slower at 4 (not taken: one kernel at every width). A
// cuBLAS composition of the same function (f32 GEMM, the norms, the
// clamp, exp, the product) takes 645-755 ms.
constexpr int CT_R = 8;                 // fixed entries a thread
constexpr int CT_C = 8;                 // streamed entries a thread
constexpr int CT_TY = 16;               // threads along the fixed side
constexpr int CT_TX = 16;               // threads along the streamed side
constexpr int CT_THREADS = CT_TY * CT_TX;
constexpr int CT_BLOCKS_SM = 2;         // blocks an SM (launch bounds: registers)
constexpr int CT_FT = CT_TY * CT_R;     // fixed entries a block
constexpr int CT_ST = CT_TX * CT_C;     // streamed entries a tile
constexpr int CT_KC = 32;               // lanes a streamed stage holds at most
constexpr int CT_TPS = 4;               // streamed tiles a stage holds at most
constexpr int CT_STAGES = 2;
constexpr int CT_LMAX = 128;            // lanes read at most (the widest layout)
constexpr int CT_STAGE = (CT_KC + 2 * CT_TPS) * CT_ST;   // floats a stage: its lanes, w, norms
static_assert(CT_R % 4 == 0 && CT_C % 4 == 0 && CT_TY % 4 == 0 && CT_TX % 8 == 0,
              "coord tile: float4 groups, warps of 4 x 8 threads");
static_assert(256 % CT_FT == 0 && 256 % CT_ST == 0, "coord tile: tiles divide 256");

// dynamic shared memory at L lanes (bytes): the fixed tile, the stages, the
// fixed norms, the warps' partial sums
__host__ __device__ constexpr size_t ct_smem_bytes(int L) {
  return sizeof(float) * ((size_t)L * CT_FT + (size_t)CT_STAGES * CT_STAGE + CT_FT +
                          (size_t)(CT_TX / 8) * CT_FT);
}
static_assert(ct_smem_bytes(CT_LMAX) + 1024 <= 233472 / CT_BLOCKS_SM,
              "coord tile: the blocks an SM fit its shared memory");

// a block's walk over its split's streamed tiles: steps of tps tiles by nch
// lane chunks of at most kc lanes. Up to 32 lanes a step holds as many
// whole tiles as 32 lanes' room does (at most CT_TPS: 4 at 4 lanes, 1 at
// 28), past them one tile in chunks of L / nch lanes (L = 124: 4 of 31)
struct CtWalk {
  int L, nch, kc, tps, t0, ntile, steps;
  __device__ CtWalk(int lanes, int Ls, int tiles_per_split) : L(lanes) {
    nch = (L + CT_KC - 1) / CT_KC;
    kc = (L + nch - 1) / nch;
    tps = nch > 1 ? 1 : min(CT_TPS, CT_KC / L);
    t0 = blockIdx.y * tiles_per_split;
    ntile = max(0, min(Ls / CT_ST, t0 + tiles_per_split) - t0);
    steps = (ntile + tps - 1) / tps * nch;
  }
  __device__ int tile0(int i) const { return t0 + i / nch * tps; }          // step i's first tile
  __device__ int tiles(int i) const { return min(tps, ntile - i / nch * tps); }   // and its tiles
};

// step i of the walk into stage i % CT_STAGES: the chunk's rows of the
// step's streamed entries (row stride tps CT_ST), and with the last chunk
// their w and norms; one cp.async commit group (empty past the walk)
__device__ __forceinline__ void ct_load_stage(float* stg, const float* __restrict__ strm_t,
                                              const float* __restrict__ w,
                                              const float* __restrict__ ns, size_t Ls,
                                              const CtWalk& wk, int i) {
  if (i < wk.steps) {
    const int ch = i % wk.nch, k0 = ch * wk.kc, nk = min(wk.kc, wk.L - k0);
    const int rs = wk.tps * CT_ST, q4 = wk.tiles(i) * (CT_ST / 4);   // 16-byte chunks a row
    float* d = stg + (i % CT_STAGES) * CT_STAGE;
    const size_t c0 = (size_t)wk.tile0(i) * CT_ST;
    for (int c = threadIdx.x; c < nk * q4; c += CT_THREADS) {
      const int k = c / q4, q = c % q4;
      cp_async16(d + k * rs + 4 * q, strm_t + (size_t)(k0 + k) * Ls + c0 + 4 * q);
    }
    if (ch == wk.nch - 1)
      for (int q = threadIdx.x; q < q4; q += CT_THREADS) {
        cp_async16(d + CT_KC * CT_ST + 4 * q, w + c0 + 4 * q);
        cp_async16(d + (CT_KC + CT_TPS) * CT_ST + 4 * q, ns + c0 + 4 * q);
      }
  }
  cp_async_commit();
}

// one lane's products into a thread's crosses: its CT_R fixed values (two
// float4 of a row of the fixed tile at fa) by its CT_C streamed ones (fb);
// START: a chain's first lane, its products alone (an FMA onto zero but for
// the sign of a zero cross, which moves no entry)
template <bool START>
__device__ __forceinline__ void ct_lane(float (&cr)[CT_R][CT_C], const float* fa,
                                        const float* fb) {
  float4 a[CT_R / 4], b[CT_C / 4];
#pragma unroll
  for (int g = 0; g < CT_R / 4; ++g) a[g] = *reinterpret_cast<const float4*>(fa + 4 * CT_TY * g);
#pragma unroll
  for (int g = 0; g < CT_C / 4; ++g) b[g] = *reinterpret_cast<const float4*>(fb + 4 * CT_TX * g);
#pragma unroll
  for (int r = 0; r < CT_R; ++r) {
    const float4 ar = a[r / 4];
    const float x = (r & 3) == 0 ? ar.x : (r & 3) == 1 ? ar.y : (r & 3) == 2 ? ar.z : ar.w;
#pragma unroll
    for (int c = 0; c < CT_C; ++c) {
      const float4 bc = b[c / 4];
      const float y = (c & 3) == 0 ? bc.x : (c & 3) == 1 ? bc.y : (c & 3) == 2 ? bc.z : bc.w;
      cr[r][c] = START ? x * y : fmaf(x, y, cr[r][c]);
    }
  }
}

// each entry's norm, the FMA chain over its first L lanes in order (the
// chain of the tile entries' crosses, so a pixel's d2 with itself is 0):
// entries [0, La) of k-major a (row stride La) into na, then those of b
__global__ void coord_norms_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ na, float* __restrict__ nb, int La,
                                   int Lb, int L) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < La + Lb; i += gridDim.x * blockDim.x) {
    const bool in_a = i < La;
    const float* x = in_a ? a + i : b + (i - La);
    const size_t ld = in_a ? La : Lb;
    float s = 0.f;
#pragma unroll 4
    for (int k = 0; k < L; ++k) s = fmaf(x[k * ld], x[k * ld], s);
    (in_a ? na[i] : nb[i - La]) = s;
  }
}

__global__ __launch_bounds__(CT_THREADS, CT_BLOCKS_SM) void coord_tile_kernel(
    const float* __restrict__ fixed_t,  // (>= L, Lf) k-major
    const float* __restrict__ strm_t,   // (>= L, Ls) k-major
    const float* __restrict__ w,        // (Ls)
    const float* __restrict__ nf,       // (Lf) the fixed entries' norms (coord_norms_kernel)
    const float* __restrict__ ns,       // (Ls) and the streamed ones'
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int L, int tiles_per_split) {
  extern __shared__ __align__(16) float ct_smem[];
  float* fx_s = ct_smem;                             // [L][CT_FT]
  float* stg = fx_s + (size_t)L * CT_FT;             // [CT_STAGES][CT_STAGE]
  float* nf_s = stg + CT_STAGES * CT_STAGE;          // [CT_FT]
  float* red_s = nf_s + CT_FT;                       // [CT_TX / 8][CT_FT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp is 4 x 8 threads: ty along the fixed side, tx the streamed
  const int ty = (warp / (CT_TX / 8)) * 4 + lane / 8;
  const int tx = (warp % (CT_TX / 8)) * 8 + lane % 8;
  const int f0 = blockIdx.x * CT_FT;
  const CtWalk wk(L, Ls, tiles_per_split);

  // the fixed tile and its norms, once for the walk; the first streamed
  // stages behind them
  for (int c = tid; c < L * (CT_FT / 4); c += CT_THREADS) {
    const int k = c / (CT_FT / 4), q = c % (CT_FT / 4);
    cp_async16(fx_s + k * CT_FT + 4 * q, fixed_t + (size_t)k * Lf + f0 + 4 * q);
  }
  if (tid < CT_FT / 4) cp_async16(nf_s + 4 * tid, nf + f0 + 4 * tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < CT_STAGES - 1; ++i) ct_load_stage(stg, strm_t, w, ns, (size_t)Ls, wk, i);

  float acc[CT_R];                      // this thread's running sums of its fixed entries
#pragma unroll
  for (int r = 0; r < CT_R; ++r) acc[r] = 0.f;
  float cr[CT_R][CT_C];                 // a tile's crosses, over the chunks so far
  for (int i = 0; i < wk.steps; ++i) {
    const int ch = i % wk.nch, nt = wk.tiles(i);
    cp_async_wait_pending<CT_STAGES - 2>();
    __syncthreads();                    // step i in (the fixed tile too); everyone done with i - 1
    ct_load_stage(stg, strm_t, w, ns, (size_t)Ls, wk, i + CT_STAGES - 1);
    const float* d = stg + (i % CT_STAGES) * CT_STAGE;
    const int rs = wk.tps * CT_ST, k0 = ch * wk.kc, nk = min(wk.kc, L - k0);
    const bool last = ch == wk.nch - 1;
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      // the cross: each entry one FFMA chain over the lanes in order
      const float* fa = fx_s + (size_t)k0 * CT_FT + 4 * ty;
      const float* fb = d + j * CT_ST + 4 * tx;
      if (ch == 0) ct_lane<true>(cr, fa, fb);
#pragma unroll 2
      for (int k = ch == 0 ? 1 : 0; k < nk; ++k) ct_lane<false>(cr, fa + k * CT_FT, fb + k * rs);
      if (last) {                       // tile j's entries and their sums
        const float* wt = d + CT_KC * CT_ST + j * CT_ST;
        const float* nt_s = wt + CT_TPS * CT_ST;
        float nsv[CT_C], wv[CT_C];
#pragma unroll
        for (int g = 0; g < CT_C / 4; ++g) {
          const float4 n4 = *reinterpret_cast<const float4*>(nt_s + 4 * tx + 4 * CT_TX * g);
          const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * tx + 4 * CT_TX * g);
          nsv[4 * g] = n4.x, nsv[4 * g + 1] = n4.y, nsv[4 * g + 2] = n4.z, nsv[4 * g + 3] = n4.w;
          wv[4 * g] = w4.x, wv[4 * g + 1] = w4.y, wv[4 * g + 2] = w4.z, wv[4 * g + 3] = w4.w;
        }
        float nfv[CT_R];
#pragma unroll
        for (int g = 0; g < CT_R / 4; ++g) {
          const float4 n4 = *reinterpret_cast<const float4*>(nf_s + 4 * ty + 4 * CT_TY * g);
          nfv[4 * g] = n4.x, nfv[4 * g + 1] = n4.y, nfv[4 * g + 2] = n4.z, nfv[4 * g + 3] = n4.w;
        }
        // each tile's sums start from zero (the first term's product) and
        // join the running sums by one add; the CT_R sums advance together
        float tacc[CT_R];
#pragma unroll
        for (int r = 0; r < CT_R; ++r) tacc[r] = kf32(nfv[r] + nsv[0], cr[r][0]) * wv[0];
#pragma unroll
        for (int c = 1; c < CT_C; ++c)
#pragma unroll
          for (int r = 0; r < CT_R; ++r)
            tacc[r] = fmaf(kf32(nfv[r] + nsv[c], cr[r][c]), wv[c], tacc[r]);
#pragma unroll
        for (int r = 0; r < CT_R; ++r) acc[r] += tacc[r];
      }
    }
  }
  cp_async_wait_all();                  // (an empty split's walk waited for nothing)
  // the CT_TX threads that share a fixed entry: a shuffle tree over the
  // warp's 8, then the warps' sums in order
#pragma unroll
  for (int r = 0; r < CT_R; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 4);
  }
  if (lane % 8 == 0) {
#pragma unroll
    for (int r = 0; r < CT_R; ++r)
      red_s[(tx / 8) * CT_FT + 4 * ty + 4 * CT_TY * (r / 4) + (r & 3)] = acc[r];
  }
  __syncthreads();
  if (tid < CT_FT) {
    float s = red_s[tid];
#pragma unroll
    for (int q = 1; q < CT_TX / 8; ++q) s += red_s[q * CT_FT + tid];
    part[(size_t)blockIdx.y * Lf + f0 + tid] = s;
  }
}

template <typename K>
int slots_of(K kernel, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  *out = occ * sms;
  return static_cast<int>(e);
}

// the layout's kernel at feature depth FD: its slots on the card, and one
// launch (the wrapper checks the shapes)
template <int FD>
int recompute_slots(int aug, int* n) {
  return aug ? slots_of(aug_sum_kernel<FD>, A_THREADS, A_SMEM_OF<FD>, n)
             : slots_of(f32_sum_kernel<FD>, T_THREADS_OF<FD>, T_SMEM_OF<FD>, n);
}

template <int FD>
int recompute_launch(int aug, const void* fixed_t, const void* strm_t, const void* w, void* part,
                     int Lf, int Ls, int splits, int blocks, cudaStream_t s) {
  const int ntiles = Ls / (aug ? A_ST_OF<FD> : T_ST);
  const int per = (ntiles + splits - 1) / splits;
  cudaError_t e;
  if (aug) {
    e = cudaFuncSetAttribute(aug_sum_kernel<FD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)A_SMEM_OF<FD>);
    if (e != cudaSuccess) return static_cast<int>(e);
    aug_sum_kernel<FD><<<blocks, A_THREADS, A_SMEM_OF<FD>, s>>>(
        static_cast<const bf16*>(fixed_t), static_cast<const bf16*>(strm_t),
        static_cast<const bf16*>(w), static_cast<float*>(part), Lf, Ls, splits, per);
  } else {
    e = cudaFuncSetAttribute(f32_sum_kernel<FD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T_SMEM_OF<FD>);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid(Lf / T_FT, splits);
    f32_sum_kernel<FD><<<grid, T_THREADS_OF<FD>, T_SMEM_OF<FD>, s>>>(
        static_cast<const float*>(fixed_t), static_cast<const float*>(strm_t),
        static_cast<const float*>(w), static_cast<float*>(part), Lf, Ls, per);
  }
  return static_cast<int>(cudaGetLastError());
}

// the coordinate kernel's dynamic shared memory opted in for the widest L
// (past 48 KB it takes no other way), before its slots and each launch
int coord_opt_in() {
  return static_cast<int>(cudaFuncSetAttribute(
      coord_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ct_smem_bytes(CT_LMAX)));
}

}  // namespace

extern "C" {

// how many blocks of the layout's kernel (aug != 0: bf16 aug, else f32) at
// fd feature lanes (32, 64, 96 or 128) fit the card at once: the wrapper
// splits the streamed axis to fill whole waves of them (and launches at
// most that many persistent aug blocks); a negative value is a cudaError, 0
// an unsupported fd
int glt_recompute_slots(int aug, int fd) {
  int n = 0;
  const int rc = fd == 32    ? recompute_slots<32>(aug, &n)
                 : fd == 64  ? recompute_slots<64>(aug, &n)
                 : fd == 96  ? recompute_slots<96>(aug, &n)
                 : fd == 128 ? recompute_slots<128>(aug, &n)
                             : -1;
  return rc < 0 ? 0 : rc != 0 ? -rc : n;
}

// out[f] = sum_s w_s k(f, s) over k-major (fd, Lf) fixed and (fd, Ls)
// streamed features, fd 32, 64, 96 or 128. aug: bf16 layouts and w, Lf %
// 256 == 0, Ls % 256 == 0, `blocks` persistent blocks over ceil(Lf / (1024
// at 32 lanes, 512 at 64 and 96, 256 at 128)) x splits work items; else
// f32 layouts and w, Lf % 128 == 0, Ls % 128 == 0, a grid of (Lf / 128,
// splits) (`blocks` unused); the wrapper checks the shapes. splits > 1:
// part holds (splits, Lf) floats and a fixed-order reduction writes out;
// splits == 1: the kernel writes part, which may be out.
int glt_recompute_sum(int aug, int fd, const void* fixed_t, const void* strm_t, const void* w,
                      void* part, void* out, int Lf, int Ls, int splits, int blocks,
                      void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  switch (fd) {
    case 32:
      rc = recompute_launch<32>(aug, fixed_t, strm_t, w, part, Lf, Ls, splits, blocks, s);
      break;
    case 64:
      rc = recompute_launch<64>(aug, fixed_t, strm_t, w, part, Lf, Ls, splits, blocks, s);
      break;
    case 96:
      rc = recompute_launch<96>(aug, fixed_t, strm_t, w, part, Lf, Ls, splits, blocks, s);
      break;
    case 128:
      rc = recompute_launch<128>(aug, fixed_t, strm_t, w, part, Lf, Ls, splits, blocks, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0 || splits == 1) return rc;
  return launch_reduce(static_cast<const float*>(part), static_cast<float*>(out), splits,
                       (size_t)Lf, s);
}

// how many blocks of the coordinate kernel reading L lanes (1 to 128) fit
// the card at once (the wrapper's splits, as glt_recompute_slots); a
// negative value is a cudaError, 0 an unsupported L
int glt_coord_slots(int L) {
  if (L < 1 || L > CT_LMAX) return 0;
  const int rc = coord_opt_in();
  if (rc != 0) return -rc;
  int n = 0;
  const int e = slots_of(coord_tile_kernel, CT_THREADS, ct_smem_bytes(L), &n);
  return e != 0 ? -e : n;
}

// out[f] = sum_s w_s k(f, s) on coordinate features (the IEEE f32 cross)
// over the first L lanes (1 to 128; the layout's others zero) of k-major
// f32 layouts, fixed (>= L, Lf) and streamed (>= L, Ls) with row strides
// Lf and Ls: Lf % 128 == 0, Ls % 128 == 0, 16-byte aligned bases; first
// every entry's norm into norms (Lf + Ls floats of scratch), then a grid
// of (Lf / 128, splits); part and out as glt_recompute_sum's.
int glt_coord_sum(const void* fixed_t, const void* strm_t, const void* w, void* norms,
                  void* part, void* out, int Lf, int Ls, int splits, int L, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (Lf % CT_FT || Ls % CT_ST || splits < 1 || L < 1 || L > CT_LMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = coord_opt_in();
  if (rc != 0) return rc;
  const int ntiles = Ls / CT_ST, per = (ntiles + splits - 1) / splits;
  const float* fx = static_cast<const float*>(fixed_t);
  const float* st = static_cast<const float*>(strm_t);
  float* nf = static_cast<float*>(norms);
  float* pp = static_cast<float*>(part);
  coord_norms_kernel<<<(Lf + Ls + 255) / 256, 256, 0, s>>>(fx, st, nf, nf + Lf, Lf, Ls, L);
  int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  coord_tile_kernel<<<dim3(Lf / CT_FT, splits), CT_THREADS, ct_smem_bytes(L), s>>>(
      fx, st, static_cast<const float*>(w), nf, nf + Lf, pp, Lf, Ls, L, per);
  e = static_cast<int>(cudaGetLastError());
  if (e != 0 || splits == 1) return e;
  return launch_reduce(pp, static_cast<float*>(out), splits, (size_t)Lf, s);
}

// out[x] = the aug entry's bf16 bits at bf16(d2) pattern x, every x of
// 65536: route 0 kb_aug evaluated, route 1 the aug kernel's table lookup (a
// check on no path: chip_smoke.py requires them equal)
int glt_aug_entries(void* out, int route, void* stream) {
  const size_t smem = TAB_BYTES;
  cudaError_t e = cudaFuncSetAttribute(aug_entries_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  aug_entries_kernel<<<1, 1024, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(out), route);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
