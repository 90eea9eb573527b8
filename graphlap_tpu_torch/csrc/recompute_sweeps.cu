// K7, K8 — the recompute-streaming kernels of the fused finish's first sweep
// and of its Nystrom cross: every kernel tile k(p, j) = exp(-d2(f_Ap, f_j))
// is recomputed from the bf16 features, never stored in device memory.
//
// Replaces graphlap_tpu/ops/pallas_streaming.py
//   K7  kb_strip_pallas     (_kb_emit_kernel), looped by gram_pallas
//         out[p, j] = bf16(bf16(exp(-bf16(max(d2_aug, 0)))) * bf16(cols_j))
//   K8  ext2_matvec_pallas  (_ext2_matvec_kernel), aug layout
//         kbt_j = k_j^T bf16([t_r, t_c]);  s_j = bm_j / sqrt(max(kbt_r kbt_c, 1e-30))
//         u    += k_j s_j                          (k_j: bf16, s_j: f32)
// with the Pallas rounding points. d2 comes from the augmented bf16 x bf16
// product with f32 accumulation (mma.sync m16n8k16); the feature depth is 32
// (aug_d_pad_of of NLM d=25), 64, 96 or 128 (of NLM d=49, 81 or 121: a 7 x
// 7, 9 x 9 or 11 x 11 patch), a template parameter of each kernel. K9
// (finish_colstats) shares K10's kernel in colstats_v.cu. The f32 layouts
// (the bilateral recipes, spatial_h > 0) take kernels of their own, K7's
// store tile (glt_kb_strip_f32, coord_store.cu, with K1's coordinate cross)
// and ext2_f32_tile_kernel below, at the same four depths:
// the reference's f32 _kb_tile class, an IEEE f32 FFMA cross over the live
// lanes, f32 norms and expf, no bf16 rounding point.
//
// What bounds them on an H100. K8 at the 8 MP shape (p_pad 4096, N 8388608)
// forms 3.4e10 tile entries. Evaluated one exp each, the MUFU ex2 rate (16 a
// clock an SM) would give 8.2 ms at 132 SMs and 1.98 GHz; the entry needs
// no exp (the table below), and one shared-memory load an entry (32 lanes
// a clock an SM, without bank conflicts) gives 4.1 ms, as do 8 f32
// operations an entry at the f32 peak; the tensor-core work (d2, kbt and u,
// 2.2 TFLOP at K = 32 plus two K = 16 products) ~3 ms; the features 0.5 GB
// ~0.2 ms. Measured, it runs latency-bound: the 128-register budget of 16
// warps holds two tiles' fragments and u, and little else. At 64 lanes the
// d2 product doubles (4.4 TFLOP, 4.45 ms at the bf16 peak, the bound), the
// sample rows take 72 KB of shared memory, and the f_t fragments of lanes
// 32-63 are read again from shared memory for each 16-row block. K7 at the 8 MP
// gram shape (p_pad 4096, 131072 columns) emits 1.07 GB of bf16 (0.32 ms
// at 3.35 TB/s) for 5.4e8 entries: bound by its store.
//
// Design of K8. Each column needs kbt over the whole p before s, and s
// before its u term, so the kernel runs in thread-block clusters of 8
// (Hopper distributed shared memory), block r owning sample rows
// [r P/8, (r+1) P/8) with their features in shared memory for the whole
// run:
//   * the entry bf16(exp(-bf16(max(d2, 0)))) depends on bf16(d2) alone, so
//     each block first fills a 128 KB shared-memory table of all 65536 bf16
//     patterns with the same expf; an entry is then one rounding of d2 (two
//     at a time) and one table load, bit-identical to evaluating it;
//   * 16 warps a block: 4 column groups of 16 columns x 4 row groups of
//     P/32 rows of a 64-column tile. A warp computes its slice of d2 (A =
//     the tile's f_t columns by ldmatrix.trans from a cp.async double
//     buffer, B = fa rows by ldmatrix) and keeps the entries in registers as
//     packed bf16 A fragments — the tile is never written to shared memory;
//   * kbt is one more mma a 16-row block at 32 lanes (the fragments times
//     [t_r, t_c] as a zero-padded B operand, each block from a zero
//     accumulator, added in f32), past 32 lanes f32 FMA chains of each
//     lane's entries on the FP32 pipe and a shuffle tree over the quad (the
//     mma's truncating alignment of products that span orders of magnitude
//     left kbt low and s high there); the four row groups' partials meet in
//     shared memory in order, and the 8 ranks' through distributed shared
//     memory, every rank summing them in the same fixed tree, so all 8 get
//     the same s;
//   * u is an mma too: the fragments, transposed in registers by movmatrix,
//     times s split into three bf16 terms (hi + mid + lo = s to f32
//     precision, so every product is exact in f32, as k_j * s_j is) in B
//     columns 0-2. The mma starts each tile from zero and its result is
//     added to the warp's u rows in registers by a rounding f32 add: the
//     tensor core's own f32 accumulation rounds toward zero, and carried
//     over the ~8192 tiles a cluster walks at 8 MP it put every row of the
//     all-positive u 8e-4 low; the three terms are added once at the end;
//   * the cluster barrier is split and overlapped: a rank arrives (release)
//     once tile i's partial is out, and while it computes tile i + 1 it
//     waits (acquire) halfway through and issues its loads of tile i's
//     remote partials, which land behind the second half; then s, one block
//     barrier, and tile i's u. Two tiles' fragments are alive, the rank
//     partials triple-buffered, the per-warp partials and s double-buffered;
//   * the kernel is a template on the warp's 16-row block count (P = 512 NB),
//     so its register arrays and loops are fixed at compile time;
//   * clusters walk the column tiles in a fixed stride order, and the
//     cross-cluster u sum goes through per-cluster partials and a
//     fixed-order reduction kernel — no float atomics, so runs repeat bit
//     for bit.
//
// Design of K7, persistent (as K1 in affinity_strip.cu). The first port
// ran one block a 128 x 128 tile (32768 short-lived blocks, each staging
// its sample rows and f_t columns again with 2-byte loads), an IEEE expf a
// tile entry, and the store after the math, overlapped only by other
// blocks. Now:
//   * 256-thread blocks, two an SM at 32 lanes and one at 64 (its f_t ring
//     and B fragments double; the occupancy API sizes the grid), walk
//     64 x 256 output units (512 contiguous bytes a row) dealt round-robin:
//     unit q of block b is b + q G, so the G blocks store neighbouring
//     column tiles of one row slice at a time; a warp holds its 32 sample
//     rows x FD aug lanes as A fragments in registers, reloaded when its
//     next unit lies in another row slice;
//   * a unit's (FD, 256) f_t tile arrives by four TMA boxes (128-byte
//     swizzle) into a 2-stage ring, issued a unit ahead; the warp's 64
//     columns come as B fragments by ldmatrix.trans (conflict-free);
//   * d2 is two (four at 64 lanes) m16n8k16 bf16 mma a 16 x 8 sub-tile, one
//     chain from zero; the entry is kexp on
//     bf16(d2) (one FMUL, one MUFU ex2: 16 a clock an SM, 5.4e8 entries
//     ~0.13 ms at config 4, under the store), equal to kb_aug at every one
//     of the 65536 bf16(d2) patterns (chip_smoke.py checks it through
//     glt_kb_entries), then the one bf16 rounding of entry x bf16(col);
//   * the packed words go into the 128-byte-swizzled layout of the TMA
//     boxes (no bank conflicts) in one of two staging buffers; thread 0
//     drains the unit by four TMA stores, tagged L2 evict-first, while the
//     block computes the next unit, so the store overlaps the math of the
//     same block.
// Measured at the 8 MP gram shape on an H100 80GB HBM3 (700 W) by
// scripts/kb_designs.py, which rebuilds each variant named here: the store
// holds it. The stores alone (no product, no entry) take about as long as
// the kernel, the math alone (no store) ~0.35 ms, torch's fill_ of the
// same bytes 0.33 ms. Without the evict-first policy, as 128 x 128 units,
// or in contiguous ranges a block it runs slower; an IEEE expf entry, the
// 65536-pattern table (one block an SM), one block an SM, rows padded off
// a power of two, st.global stores from the staging and a warp-specialized
// kernel (a producer warp, six staging buffers) were each no faster.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).
// Every entry point returns cudaGetLastError() (or the first error) after
// its launches.

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The bf16 aug kernels (K7, K8) take the feature depth FD as a template
// parameter: 32 (aug_d_pad_of of NLM d 25), 64, 96 or 128 (of NLM d 49, 81
// or 121: a 7 x 7, 9 x 9 or 11 x 11 patch). The f32 K8 reads the live lanes
// at run time (the f32 K7 too, in coord_store.cu), so every layout takes the
// same chains.

// ---------------------------------------------------------------------------
// K7: the column-scaled tile emitter (aug layout), persistent blocks
// ---------------------------------------------------------------------------

constexpr int E_THREADS = 256;  // 8 warps: 4 column groups x 2 row halves of a unit
constexpr int E_TM = 64;        // rows a unit
constexpr int E_TN = 256;       // columns a unit: 512 contiguous bytes a row
constexpr int E_WM = E_TM / 2, E_WN = E_TN / 4;   // rows, columns a warp
constexpr int E_MT = E_WM / 16, E_NT = E_WN / 8;  // its m16 and n8 tiles
constexpr int E_STAGES = 2;     // f_t ring (3 stages would not let two blocks fit an SM)
constexpr int E_BOX = 64;       // columns a TMA box (128 bytes of bf16)
constexpr int E_BOXES = E_TN / E_BOX;          // TMA boxes a unit, f_t and output
constexpr int E_OUT_BYTES = E_TM * E_TN * 2;   // a unit's output: boxes of E_TM rows
static_assert(E_WM % 16 == 0 && E_WN % 16 == 0 && E_TN % E_BOX == 0, "K7 unit shape");
// a unit's f_t tile: boxes of FD k rows (16 KB at 32 lanes, 32 KB at 64)
template <int FD>
constexpr int E_FT_BYTES_OF = FD * E_TN * 2;
// alignment slack, two staging buffers, the ring, its barriers: 97 KB at
// 32 lanes (two blocks an SM), 129 KB at 64 (one), 161 and 193 KB at 96 and
// 128 (one)
template <int FD>
constexpr size_t e_smem() {
  return 1024 + 2 * (size_t)E_OUT_BYTES + (size_t)E_STAGES * E_FT_BYTES_OF<FD> + 8 * E_STAGES;
}
static_assert(e_smem<96>() == 164880 && e_smem<128>() == 197648, "K7 past 64 lanes");
// pairs of n8 tiles whose B fragments a warp holds at once
template <int FD>
constexpr int E_NPB = FD <= 64 ? E_NT / 2 : 1;

// an L2 policy that evicts first what it tags: the emitted tile streams
// through L2 once (1.07 GB at 8 MP, 21 times L2), so its lines should not
// push out the f_t tiles and sample rows every block reads again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// tma_store (mma_common.cuh) with an L2 cache policy
__device__ __forceinline__ void tma_store_hint(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], "
      "%4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src), "l"(pol)
      : "memory");
}

// bf16(entry * col) of a packed entry pair and two f32 columns (exact bf16
// values): the product is exact in f32, so this is the one rounding
__device__ __forceinline__ uint32_t scale_pair(uint32_t e, float c0, float c1) {
  return pack2(__uint_as_float(e << 16) * c0, __uint_as_float(e & 0xFFFF0000u) * c1);
}

template <int FD>
__global__ __launch_bounds__(E_THREADS, FD == 32 ? 2 : 1) void kb_emit_kernel(
    const __grid_constant__ CUtensorMap ft_map,   // (FD, S) aug f_t, 64 x FD boxes
    const __grid_constant__ CUtensorMap out_map,  // (P, S) out, 64 x E_TM boxes
    const bf16* __restrict__ fa,                  // (P, FD) aug
    const bf16* __restrict__ cols,                // (S)
    int nrb, int nct, int S) {
  constexpr int KS = FD / 16, E_FT_BYTES = E_FT_BYTES_OF<FD>, NPB = E_NPB<FD>;
  extern __shared__ unsigned char e_raw[];
  unsigned char* smem = e_raw + ((1024 - (smem_u32(e_raw) & 1023)) & 1023);
  unsigned char* ring = smem + 2 * E_OUT_BYTES;
  const uint32_t bar0 = smem_u32(ring + E_STAGES * E_FT_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wc = warp & 3, wr = warp >> 2;   // columns E_WN wc.., rows E_WM wr..
  const int box = wc * E_WN / E_BOX;          // its TMA box and first 16-byte chunk there
  const int chunk0 = wc * E_WN % E_BOX / 8;
  // the block's units, dealt round-robin over the row-major unit order:
  // unit q of block b is b + q G, so the G blocks store neighbouring column
  // tiles of one row slice at a time
  const long long units = (long long)nrb * nct;
  const int n = (int)((units - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto unit = [&](int q) { return (int)blockIdx.x + q * (int)gridDim.x; };
  // the f_t tile of unit t into ring stage st
  auto load = [&](int t, int st) {
    const uint32_t bar = bar0 + 8 * st, dst = smem_u32(ring + st * E_FT_BYTES);
    mbar_expect_tx(bar, E_FT_BYTES);
    for (int bx = 0; bx < E_BOXES; ++bx)
      tma_box(dst + bx * (E_FT_BYTES / E_BOXES), &ft_map, (t % nct) * E_TN + bx * E_BOX, 0, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < E_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < min(E_STAGES, n); ++q) load(unit(q), q);
  }
  __syncthreads();

  uint32_t A[E_MT][KS][4];   // the warp's sample rows: [m16 tile][k16 step] fragments
  int rb_held = -1;
  for (int q = 0; q < n; ++q) {
    const int t = unit(q), rb = t / nct, ct = t % nct, st = q % E_STAGES;
    if (rb != rb_held) {   // a new row slice: its A fragments from device memory
      rb_held = rb;
#pragma unroll
      for (int mt = 0; mt < E_MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const bf16* p = fa + (size_t)(rb * E_TM + wr * E_WM + mt * 16 + g) * FD + 16 * ks + 2 * tq;
          A[mt][ks][0] = ld32(p);
          A[mt][ks][1] = ld32(p + 8 * FD);
          A[mt][ks][2] = ld32(p + 8);
          A[mt][ks][3] = ld32(p + 8 * FD + 8);
        }
    }
    // this lane's columns 2 tq, 2 tq + 1 of each n8 tile, as f32
    float cs[E_NT][2];
#pragma unroll
    for (int nt = 0; nt < E_NT; ++nt) {
      const int j = ct * E_TN + E_WN * wc + 8 * nt + 2 * tq;   // past S: stored nowhere
      const float2 c = j < S ? unpack2(ld32(cols + j)) : make_float2(0.f, 0.f);
      cs[nt][0] = c.x;
      cs[nt][1] = c.y;
    }
    unsigned char* stage = smem + (q & 1) * E_OUT_BYTES;
    if (tid == 0) bulk_wait_read<1>();   // the store of unit q - 2 has left this buffer
    mbar_wait(bar0 + 8 * st, (q / E_STAGES) & 1);
    __syncthreads();

    // B fragments of the warp's 32 columns ([n8 tile][k16 step]) by
    // ldmatrix.trans from the swizzled boxes: matrix l / 8 of a load is
    // (k rows 16 ks + 8 (l / 8 % 2) .., chunk chunk0 + 2 np + l / 16); all
    // of them at once up to 64 lanes, past it one pair of n8 tiles at a
    // time (E_NPB), so B takes 32 registers at 128 lanes, not 128
    const unsigned char* fb = ring + st * E_FT_BYTES + box * (E_FT_BYTES / E_BOXES);
#pragma unroll
    for (int np0 = 0; np0 < E_NT / 2; np0 += NPB) {
      uint32_t B[2 * NPB][KS][2];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < NPB; ++j) {
          const int k = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int ch = chunk0 + 2 * (np0 + j) + (lane >> 4);
          uint32_t r[4];
          ldsm_x4_trans(r, reinterpret_cast<const bf16*>(fb + k * 128 + ((ch ^ (k & 7)) << 4)));
          B[2 * j][ks][0] = r[0];
          B[2 * j][ks][1] = r[1];
          B[2 * j + 1][ks][0] = r[2];
          B[2 * j + 1][ks][1] = r[3];
        }
#pragma unroll
      for (int mt = 0; mt < E_MT; ++mt) {
        const int r0 = wr * E_WM + mt * 16 + g;   // rows r0, r0 + 8; r0 & 7 == g
#pragma unroll
        for (int jn = 0; jn < 2 * NPB; ++jn) {
          const int nt = 2 * np0 + jn;
          float c[4] = {0.f, 0.f, 0.f, 0.f};   // d2: one chain over the k16 steps
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) mma16816(c, A[mt][ks], B[jn][ks]);
          // staged in the TMA box's 128-byte-swizzled layout: the 8 rows a
          // warp writes at once land in 8 distinct 16-byte chunks
          unsigned char* o = stage + (box + (chunk0 + nt) / 8) * (E_OUT_BYTES / E_BOXES) +
                             ((((chunk0 + nt) % 8) ^ g) << 4) + tq * 4;
          *reinterpret_cast<uint32_t*>(o + r0 * 128) =
              scale_pair(kb_pair(c[0], c[1]), cs[nt][0], cs[nt][1]);
          *reinterpret_cast<uint32_t*>(o + (r0 + 8) * 128) =
              scale_pair(kb_pair(c[2], c[3]), cs[nt][0], cs[nt][1]);
        }
      }
    }
    fence_async_smem();
    __syncthreads();   // the unit is staged; its ring stage is free
    if (tid == 0) {
      const uint64_t pol = l2_evict_first();
      for (int bx = 0; bx < E_BOXES; ++bx)
        tma_store_hint(&out_map, smem_u32(stage + bx * (E_OUT_BYTES / E_BOXES)),
                       ct * E_TN + bx * E_BOX, rb * E_TM, pol);
      bulk_commit();
      if (q + E_STAGES < n) load(unit(q + E_STAGES), st);
    }
  }
  if (tid == 0) bulk_wait_all();
}

// every bf16 pattern x (as d2) -> K7's entry bits, kb_pair's route: two
// patterns a thread, 256 x 128 threads
__global__ void kb_entries_kernel(unsigned short* out) {
  const uint32_t x = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const uint32_t r = kb_pair(__uint_as_float(x << 16), __uint_as_float((x + 1) << 16));
  out[x] = (unsigned short)(r & 0xFFFF);
  out[x + 1] = (unsigned short)(r >> 16);
}

// ---------------------------------------------------------------------------
// K8: extension + polish matvec (aug layout), clusters of 8
// ---------------------------------------------------------------------------

constexpr int CL = 8;                    // blocks a cluster (sample-row slices)
constexpr int X_THREADS = 512;
constexpr int X_TN = 64;                 // columns a tile
constexpr int X_CG = X_TN / 16;          // column groups of 16 (one warp each)
constexpr int X_RG = X_THREADS / 32 / X_CG;  // row groups of a slice
constexpr int X_LDT = X_TN + 8;          // ft_s row stride (bf16): conflict-free ldmatrix
constexpr int X_LPP = X_THREADS / (2 * X_TN);  // threads a (column, r | c) pair of a tile
static_assert(X_CG == 4 && X_RG == 4 && X_LPP * 2 == CL,
              "the fixed-order sums below are written out for this shape");

// the (FD, X_TN) f_t tile at column j0 -> dst[k][j], stride X_LDT; one
// cp.async commit group
template <int FD>
__device__ __forceinline__ void load_ft(bf16* dst, const bf16* __restrict__ ft, size_t ld,
                                        int j0) {
  // one 16-byte copy a thread up to 64 lanes, two past it
  for (int c = threadIdx.x; c < FD * (X_TN / 8); c += X_THREADS) {
    const int k = c / (X_TN / 8), q = c % (X_TN / 8);
    cp_async16(dst + k * X_LDT + q * 8, ft + (size_t)k * ld + j0 + q * 8);
  }
  cp_async_commit();
}

constexpr int KT_N = 65536;              // the entry table: every bf16 bit pattern of d2
// the entry from the table up to 64 lanes; past it from kb_pair (K7's
// entry: kexp on bf16(d2), equal to the table's at all 65536 patterns,
// which chip_smoke.py requires), since at P 4096 the sample rows of 96 or
// 128 lanes (106 or 139 KB) leave no room for the table's 128 KB
template <int FD>
constexpr bool X_TABLE = FD <= 64;

// K8's shared row stride of the sample rows (bf16): conflict-free ldmatrix
template <int FD>
constexpr int X_LDF = FD + 8;

// shared memory of a block holding rb = P / 8 sample rows: the table (up
// to 64 lanes), the rows, two f_t tiles (the u rows' column-group sums
// reuse them once the walk is done), t2, s, the partials. At P 4096 and 64
// lanes 231680 bytes, inside the 232448 a block may take (with the u sums
// apart it would be 239872); at 96 and 128 lanes, without the table,
// 142592 and 184576
template <int FD>
size_t ext2_smem(int P) {
  const size_t rb = P / CL;
  return (X_TABLE<FD> ? sizeof(unsigned short) * KT_N : 0) +
         sizeof(bf16) * (rb * X_LDF<FD> + 2 * FD * X_LDT + 2 * rb + 2 * 3 * X_TN) +
         sizeof(float) * ((size_t)2 * X_RG * 2 * X_TN + 3 * 2 * X_TN);
}

template <int NB, int FD>   // 16-row blocks a warp (P = 512 NB), feature depth
__global__ __launch_bounds__(X_THREADS, 1) void ext2_matvec_kernel(
    const bf16* __restrict__ fa,   // (P, FD) aug
    const bf16* __restrict__ ft,   // (FD, N) aug
    const bf16* __restrict__ t2,   // (2, P), bf16-rounded
    const float* __restrict__ bm,  // (N)
    float* __restrict__ s_out,     // (N)
    float* __restrict__ u_part,    // (clusters, P)
    int P, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL, ncl = gridDim.x / CL;
  const int rb = P / CL, r0 = rank * rb;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* kt_s = reinterpret_cast<unsigned short*>(smem);   // [KT_N] entry table
  constexpr int LDF = X_LDF<FD>;
  static_assert(2 * FD * X_LDT * sizeof(bf16) >= X_CG * 512 * sizeof(float),
                "the u sums of P = 4096 fit the f_t tiles");
  bf16* fa_s = reinterpret_cast<bf16*>(kt_s + (X_TABLE<FD> ? KT_N : 0));   // [rb][LDF]
  bf16* ft_s = fa_s + rb * LDF;                          // [2][FD][X_LDT]
  bf16* t2_s = ft_s + 2 * FD * X_LDT;                    // [2][rb] bf16(t_r | t_c)
  bf16* s3_s = t2_s + 2 * rb;                            // [2 bufs][3][X_TN] s = hi + mid + lo
  float* wq_s = reinterpret_cast<float*>(s3_s + 2 * 3 * X_TN);  // [2 bufs][X_RG][2][X_TN]
  float* part_s = wq_s + 2 * X_RG * 2 * X_TN;            // [3 bufs][2][X_TN] rank partials
  float* uw_s = reinterpret_cast<float*>(ft_s);          // [X_CG][rb], after the walk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int cgi = warp % X_CG, jb = cgi * 16;   // this warp's 16 columns of a tile
  const int rg = warp / X_CG, rw = rg * NB * 16;  // and its first row of the slice

  // the tile entry bf16(exp(-bf16(max(d2, 0)))) is a function of bf16(d2)
  // alone: one table of all 65536 bit patterns (NaN patterns unused),
  // computed with the same expf, so a lookup is bit-identical to kb_aug
  if constexpr (X_TABLE<FD>) {
    for (int i = tid; i < KT_N; i += X_THREADS) {
      const float d = __uint_as_float((uint32_t)i << 16);
      kt_s[i] = (unsigned short)(__float_as_uint(d != d ? 0.f : kb_aug(d)) >> 16);
    }
  }
  for (int v = tid; v < rb * (FD / 8); v += X_THREADS) {
    const int r = v / (FD / 8), q = v % (FD / 8);
    *reinterpret_cast<uint4*>(fa_s + r * LDF + q * 8) =
        *reinterpret_cast<const uint4*>(fa + (size_t)(r0 + r) * FD + q * 8);
  }
  for (int i = tid; i < rb; i += X_THREADS) {
    t2_s[i] = t2[r0 + i];
    t2_s[rb + i] = t2[P + r0 + i];
  }
  const int ntiles = N / X_TN;
  const int mine = (ntiles - cid + ncl - 1) / ncl;   // this cluster's tiles (>= 1)
  auto col0 = [&](int i) { return (cid + i * ncl) * X_TN; };
  // the entries of two d2 (lo, hi), packed: the table's at bf16(d2), or
  // kb_pair's
  auto kent2 = [&](float lo, float hi) -> uint32_t {
    if constexpr (X_TABLE<FD>) {
      const uint32_t w = pack2(lo, hi);
      return (uint32_t)kt_s[w & 0xFFFFu] | ((uint32_t)kt_s[w >> 16] << 16);
    } else {
      return kb_pair(lo, hi);
    }
  };

  // the warp's slice of tile i -> packed bf16 A fragments (16 columns x
  // 16 rows a block), and its kbt partial into wq_s; halfway runs once,
  // halfway through the blocks
  // The f_t fragments of lanes 0-31 stay in registers over the walk; at 64
  // lanes those of lanes 32-63 are read again from shared memory for each
  // 16-row block, past 64 those of lanes 32.. for each 8-row half of it
  // (the registers hold two tiles' fragments and u, little else). d2 is one
  // mma chain over the k16 steps from zero.
  auto tile = [&](uint32_t (&F)[NB][4], int i, auto&& halfway) {
    const bf16* fts = ft_s + (i & 1) * FD * X_LDT;
    uint32_t a0[4], a1[4];
    const bf16* ap = fts + ((lane & 7) + 8 * (lane >> 4)) * X_LDT + jb + 8 * ((lane >> 3) & 1);
    ldsm_x4_trans(a0, ap);
    ldsm_x4_trans(a1, ap + 16 * X_LDT);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b == NB / 2) halfway();
      [[maybe_unused]] uint32_t a2[4], a3[4];   // lanes 32-63 (FD 64)
      if constexpr (FD == 64) {
        ldsm_x4_trans(a2, ap + 32 * X_LDT);
        ldsm_x4_trans(a3, ap + 48 * X_LDT);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* bp = fa_s + (rw + 16 * b + 8 * h + (lane & 7)) * LDF + 8 * (lane >> 3);
        uint32_t bq[4];
        ldsm_x4(bq, bp);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c, a0, bq);
        mma16816(c, a1, bq + 2);
        if constexpr (FD == 64) {
          ldsm_x4(bq, bp + 32);
          mma16816(c, a2, bq);
          mma16816(c, a3, bq + 2);
        } else if constexpr (FD > 64) {
#pragma unroll
          for (int kk = 1; kk < FD / 32; ++kk) {
            uint32_t ax[4], ay[4];
            ldsm_x4_trans(ax, ap + 32 * kk * X_LDT);
            ldsm_x4_trans(ay, ap + (32 * kk + 16) * X_LDT);
            ldsm_x4(bq, bp + 32 * kk);
            mma16816(c, ax, bq);
            mma16816(c, ay, bq + 2);
          }
        }
        F[b][2 * h] = kent2(c[0], c[1]);
        F[b][2 * h + 1] = kent2(c[2], c[3]);
      }
    }
    // kbt, after the d2 loop, whose fragments and accumulators are dead by
    // then: (column g | g + 8) x (t_r | t_c). At 32 lanes one more mma a
    // 16-row block (the fragments times [t_r, t_c] as a zero-padded B
    // operand), each from a zero accumulator, added in f32. Past 32 lanes
    // on the FP32 pipe: each lane's entries (rows 2tq, 2tq + 1, 2tq + 8,
    // 2tq + 9 of each block) times bf16(t_r), bf16(t_c), exact products in
    // f32 FMA chains, then the quad's four lanes by a fixed shuffle tree.
    // There the entries of one block span more orders of magnitude, and an
    // mma aligns its products to the largest and truncates the rest: kbt
    // ended low and s above its f64 evaluation on 0.62 of the columns at 64
    // lanes, 0.72 at 96 and 0.81 at 128 (synthetic features; 0.52 at 32;
    // the plain version 0.49-0.51; scripts/k8_lean.py); it took K8 15%
    // longer at 32 lanes (where the mma's lean is slight), 14% at 64 and
    // 96, 7% at 128
    float kt[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (FD == 32) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int p0 = rw + 16 * b + 2 * tq;
        uint32_t tb[2];
        tb[0] = g < 2 ? ld32(t2_s + g * rb + p0) : 0u;
        tb[1] = g < 2 ? ld32(t2_s + g * rb + p0 + 8) : 0u;
        float kb[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(kb, F[b], tb);
#pragma unroll
        for (int e = 0; e < 4; ++e) kt[e] += kb[e];
      }
    } else {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p0 = rw + 16 * b + 8 * h + 2 * tq;
          const float2 tr = unpack2(ld32(t2_s + p0)), tc = unpack2(ld32(t2_s + rb + p0));
          const float2 e0 = unpack2(F[b][2 * h]), e8 = unpack2(F[b][2 * h + 1]);
          kt[0] = fmaf(e0.y, tr.y, fmaf(e0.x, tr.x, kt[0]));
          kt[1] = fmaf(e0.y, tc.y, fmaf(e0.x, tc.x, kt[1]));
          kt[2] = fmaf(e8.y, tr.y, fmaf(e8.x, tr.x, kt[2]));
          kt[3] = fmaf(e8.y, tc.y, fmaf(e8.x, tc.x, kt[3]));
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kt[e] += __shfl_xor_sync(0xffffffffu, kt[e], 1);
        kt[e] += __shfl_xor_sync(0xffffffffu, kt[e], 2);
      }
    }
    if (tq == 0) {
      float* w = wq_s + ((i & 1) * X_RG + rg) * 2 * X_TN;
      w[jb + g] = kt[0];
      w[X_TN + jb + g] = kt[1];
      w[jb + g + 8] = kt[2];
      w[X_TN + jb + g + 8] = kt[3];
    }
  };
  // the row groups' partials in order -> this rank's partial of tile i
  auto combine = [&](int i) {
    if (tid < 2 * X_TN) {
      const float* w = wq_s + (i & 1) * X_RG * 2 * X_TN + tid;
      part_s[(i % 3) * 2 * X_TN + tid] =
          ((w[0] + w[2 * X_TN]) + w[4 * X_TN]) + w[6 * X_TN];
    }
  };
  // tile i's partials of a rank pair (every thread: a column, r | c, and
  // ranks 2 sub, 2 sub + 1), loaded after the cluster wait and used later
  const int q = tid / X_LPP, sub = tid % X_LPP;
  const int off = (q & 1) * X_TN + (q >> 1);
  auto fetch = [&](int i, float& v0, float& v1) {
    cluster_wait();                      // every rank's partial of tile i is in
    const float* pk = part_s + (i % 3) * 2 * X_TN + off;
    v0 = *cluster.map_shared_rank(pk, 2 * sub);
    v1 = *cluster.map_shared_rank(pk, 2 * sub + 1);
  };
  // kbt over the 8 ranks in a fixed tree (the same on every rank), s, and
  // its bf16 split into s3_s[i & 1]
  auto scales = [&](int i, float v0, float v1, float bmv) {
    float v = v0 + v1;
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const float o = __shfl_xor_sync(0xffffffffu, v, X_LPP);   // the other of r | c
    if (tid % (2 * X_LPP) == 0) {
      const int col = q >> 1;
      const float s = bmv / sqrtf(fmaxf(v * o, EPS));
      if (rank == 0) s_out[col0(i) + col] = s;
      bf16* s3 = s3_s + (i & 1) * 3 * X_TN;
      const bf16 hi = __float2bfloat16_rn(s);
      const float r1 = s - __bfloat162float(hi);
      const bf16 mid = __float2bfloat16_rn(r1);
      s3[col] = hi;
      s3[X_TN + col] = mid;
      s3[2 * X_TN + col] = __float2bfloat16_rn(r1 - __bfloat162float(mid));
    }
  };
  float U[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) U[b][e] = 0.f;
  // u += the fragments transposed in registers . [s_hi, s_mid, s_lo, 0..]:
  // the tile's 16 products a row from a zero accumulator, then added to U
  // with a rounding f32 add (the mma's own accumulation truncates, which
  // over thousands of tiles biases an all-positive u low)
  auto umma = [&](const uint32_t (&F)[NB][4], int i) {
    const bf16* s3 = s3_s + (i & 1) * 3 * X_TN;
    uint32_t sb[2];
    sb[0] = g < 3 ? ld32(s3 + g * X_TN + jb + 2 * tq) : 0u;
    sb[1] = g < 3 ? ld32(s3 + g * X_TN + jb + 8 + 2 * tq) : 0u;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const uint32_t at[4] = {movt(F[b][0]), movt(F[b][2]), movt(F[b][1]), movt(F[b][3])};
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma16816(c, at, sb);
#pragma unroll
      for (int e = 0; e < 4; ++e) U[b][e] += c[e];
    }
  };
  // finish tile i (fragments Fc): its remote partials load while the warp
  // computes the second half of tile i + 1 into Fn
  auto step = [&](uint32_t (&Fc)[NB][4], uint32_t (&Fn)[NB][4], int i) {
    const bool next = i + 1 < mine;
    const float bmv = tid % (2 * X_LPP) == 0 ? bm[col0(i) + (q >> 1)] : 0.f;
    float v0, v1;
    if (next) {
      if (i + 2 < mine) load_ft<FD>(ft_s + (i & 1) * FD * X_LDT, ft, (size_t)N, col0(i + 2));
      tile(Fn, i + 1, [&] { fetch(i, v0, v1); });
    } else {
      fetch(i, v0, v1);
    }
    scales(i, v0, v1, bmv);
    cp_async_wait_all();
    __syncthreads();                     // wq_s, s3_s and the next f_t tile in
    if (next) {
      combine(i + 1);
      cluster_arrive();                  // tile i + 1's partial is out
    }
    umma(Fc, i);
  };

  uint32_t F0[NB][4], F1[NB][4];
  load_ft<FD>(ft_s, ft, (size_t)N, col0(0));
  cp_async_wait_all();
  __syncthreads();                       // the table, fa_s, t2_s, the first f_t tile in
  if (mine > 1) load_ft<FD>(ft_s + FD * X_LDT, ft, (size_t)N, col0(1));
  tile(F0, 0, [] {});
  cp_async_wait_all();
  __syncthreads();
  combine(0);
  cluster_arrive();
  for (int i = 0; i < mine; i += 2) {
    step(F0, F1, i);
    if (i + 1 < mine) step(F1, F0, i + 1);
  }

  // u rows: hi + (mid + lo) (lo in the tq = 1 lane), column groups in order
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float lo0 = __shfl_down_sync(0xffffffffu, U[b][0], 1);
    const float lo8 = __shfl_down_sync(0xffffffffu, U[b][2], 1);
    if (tq == 0) {
      float* w = uw_s + cgi * rb + rw + 16 * b + g;
      w[0] = U[b][0] + (U[b][1] + lo0);
      w[8] = U[b][2] + (U[b][3] + lo8);
    }
  }
  __syncthreads();
  if (tid < rb)
    u_part[(size_t)cid * P + r0 + tid] =
        ((uw_s[tid] + uw_s[rb + tid]) + uw_s[2 * rb + tid]) + uw_s[3 * rb + tid];
  cluster.sync();                        // no block leaves while read remotely
}

// ---------------------------------------------------------------------------
// K8, f32 layout: a register tile over the live lanes, clusters of 8 or 16
// ---------------------------------------------------------------------------
//
// kbt_j = k_j^T [t_r, t_c], s_j = bm_j / sqrt(max(kbt_r kbt_c, 1e-30)), u +=
// k_j s_j with the f32 entry (kf32) and f32 FMAs throughout, the
// reference's "highest" class. The kernel reads the L = _lanes(live, fd)
// live lanes (4, 28, 52, 84 or 124 on the recipes' 32- to 128-lane layouts;
// any multiple of 4 up to the layout's depth): each entry's cross an f32
// FFMA chain over them in lane order, its norms the same chain over its
// own lanes, so every tile entry is the bits of the design it replaced (the
// pad lanes are zero: a chain over them would add exact zeros).
//
// What bounds it at 8 MP (p_pad 4096, N 2^23, 3.44e10 entries): the cross,
// 2 L flop an entry, and the kbt and u FMAs, 6 more: 130.3 ms at 124 lanes
// at the f32 peak (89.2 at 84, 56.4 at 52); beside them each entry's
// epilogue (the norms' add, d2, the clamp, expf) is ~10 FP32-pipe
// instructions, and at 4 lanes the epilogue and one MUFU ex2 an entry (8.2
// ms) are all of it. The features are read once from device memory (the
// ranks' and clusters' re-reads of the column tiles come from L2).
//
// Design (ext2_f32_tile_kernel). A column needs kbt over the whole p before
// its s, and s before its u term, so a cluster of P / RB blocks shares each
// column tile, rank r holding sample rows [r RB, (r+1) RB) in shared memory
// for the whole run, k-major over the live lanes: RB = 512 up to 96 lanes
// (clusters of 8 at p_pad 4096, 15 resident: 120 SMs), 256 at 128 lanes,
// where 512 rows of 124 lanes would take 254 KB (clusters of 16, a size the
// H100 allows as non-portable; 7 resident, 112 SMs):
//   * an SGEMM's register tile: 256 threads, each XF_R = 8 rows by XF_C =
//     16 columns (float4 groups of four consecutive, 4 TY and 4 TX apart),
//     so a tile is TN = 16 TX columns (64, or 128 at 128 lanes) and a lane
//     of the cross is 6 float4 loads of shared memory for 128 FFMA (the
//     design it replaced: 12 for 128 FFMA and 32 FFMA of column norms at
//     128 lanes, 16 for 256 and 32 below);
//   * the column tiles arrive by cp.async double buffering in chunks of at
//     most XF_KC = 32 lanes (L split evenly in multiples of 4: 4 chunks at
//     124 lanes, 3 at 84, 2 at 52), the tile's column norms and bm with its
//     last chunk, so the stages stay small beside the rows (227 KB a block,
//     all a block may take, at 96 lanes with all of them live; 203 KB at
//     84);
//   * the norms come from a pre-pass (ext2_norms_kernel: one thread an
//     entry, the same chain), each formed once and not in every row group;
//   * a tile's exchange: each thread's row sums of its columns' kbt (chains
//     over its 8 rows from the first term), a shuffle tree over the warp's
//     row threads, the 8 warps in order in shared memory; each rank pushes
//     its partials into every rank's shared memory (distributed shared
//     memory stores, which the cluster barrier's release and acquire order)
//     and after one cluster barrier sums the ranks' partials in rank order
//     from its own shared memory, so every rank computes the same s with
//     no remote load on the critical path. The pushes are double-buffered:
//     a rank rewrites a slot two tiles later, after the barrier that shows
//     every rank has read it. The tile's fixed costs (three block barriers,
//     the cluster barrier, the s step) are paid once every 64 or 128
//     columns, not every 32;
//   * u: a tile's row sums of a thread's columns (chains from the first
//     term), added to a span's sum from zero, which joins the thread's
//     running sum by one f32 add every XF_SPAN tiles; at the end the TX
//     threads of a row join by a fixed shuffle tree;
//   * a last tile past N (N % TN == 64 at 128 lanes) reads zero columns
//     and bm = 0, so its s is 0 there and adds exact zeros to u;
//   * clusters walk the tiles in a fixed stride order and the cross-cluster
//     u goes through per-cluster partials and the fixed-order reduction:
//     runs repeat bit for bit.
// Measured: PERF.md (scripts/ext2_f32_designs.py, the designs and the one
// it replaced, timed in turns on one card).
constexpr int XF_THREADS = 256;
constexpr int XF_WARPS = XF_THREADS / 32;
constexpr int XF_R = 8;              // rows a thread
constexpr int XF_C = 16;             // columns a thread
constexpr int XF_KC = 32;            // lanes a column stage holds at most
constexpr int XF_SPAN = 64;          // tiles a span of u
static_assert(XF_R % 4 == 0 && XF_C % 4 == 0, "ext2 f32: float4 groups of rows and columns");

// sample rows a block at depth fd: 512, or 256 at 128 lanes
__host__ __device__ constexpr int xf_rb(int fd) { return fd == 128 ? 256 : 512; }

// columns a tile of a block of rb rows
__host__ __device__ constexpr int xf_tn(int rb) { return XF_THREADS / (rb / XF_R) * XF_C; }

// the thread grid of a block of RB rows: TY threads along the rows, TX
// along the columns (a warp holds all TX of its rows), TN columns a tile
template <int RB>
struct XfGrid {
  static constexpr int TY = RB / XF_R;
  static constexpr int TX = XF_THREADS / TY;
  static constexpr int TN = xf_tn(RB);
  static constexpr int XCL_MAX = 4096 / RB;   // ranks at p_pad 4096
  static_assert(TX <= 32 && 32 % TX == 0 && TY * TX == XF_THREADS, "ext2 f32: the grid");
};

// floats a column stage of TN columns: XF_KC lanes, then the tile's column
// norms and bm (s after the exchange)
__host__ __device__ constexpr int xf_stage(int tn) { return (XF_KC + 2) * tn; }

// dynamic shared memory at L lanes (bytes): the rank's rows, their norms and
// t2, two column stages, the warps' kbt partials, every rank's partials
// (double-buffered)
__host__ __device__ constexpr size_t xf_smem(int L, int rb) {
  return sizeof(float) * ((size_t)L * rb + 3 * (size_t)rb + 2 * (size_t)xf_stage(xf_tn(rb)) +
                          (size_t)XF_WARPS * 2 * xf_tn(rb) +
                          2 * (size_t)(4096 / rb) * 2 * xf_tn(rb));
}
static_assert(xf_smem(96, xf_rb(96)) <= 232448 && xf_smem(128, xf_rb(128)) <= 232448,
              "ext2 f32: a block fits the SM's shared memory at every depth");

__device__ __forceinline__ float f4at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one lane's products into a thread's crosses: its XF_R rows (float4
// groups of a k-major row of the rank's rows at fa) by its XF_C columns
// (fb); START: a chain's first lane, its products alone (an FMA onto zero
// but for the sign of a zero cross, which moves no entry)
template <int TY, int TX, bool START>
__device__ __forceinline__ void xf_lane(float (&cr)[XF_R][XF_C], const float* fa,
                                        const float* fb) {
  float4 a[XF_R / 4], b[XF_C / 4];
#pragma unroll
  for (int g = 0; g < XF_R / 4; ++g) a[g] = *reinterpret_cast<const float4*>(fa + 4 * TY * g);
#pragma unroll
  for (int g = 0; g < XF_C / 4; ++g) b[g] = *reinterpret_cast<const float4*>(fb + 4 * TX * g);
#pragma unroll
  for (int r = 0; r < XF_R; ++r) {
    const float x = f4at(a[r / 4], r & 3);
#pragma unroll
    for (int c = 0; c < XF_C; ++c) {
      const float y = f4at(b[c / 4], c & 3);
      cr[r][c] = START ? x * y : fmaf(x, y, cr[r][c]);
    }
  }
}

// XF_C values of a thread's columns (float4 groups 4 TX apart) at v
template <int TX>
__device__ __forceinline__ void xf_cols(float (&out)[XF_C], const float* v) {
#pragma unroll
  for (int g = 0; g < XF_C / 4; ++g) {
    const float4 q = *reinterpret_cast<const float4*>(v + 4 * TX * g);
    out[4 * g] = q.x, out[4 * g + 1] = q.y, out[4 * g + 2] = q.z, out[4 * g + 3] = q.w;
  }
}

template <int RB>
__global__ __launch_bounds__(XF_THREADS, 1) void ext2_f32_tile_kernel(
    const float* __restrict__ fa,    // (P, fd) row-major
    const float* __restrict__ ft,    // (fd, N) k-major
    const float* __restrict__ t2,    // (2, P)
    const float* __restrict__ bm,    // (N)
    const float* __restrict__ nrm,   // (P + N) the norms (ext2_norms_kernel)
    float* __restrict__ s_out,       // (N)
    float* __restrict__ u_part,      // (clusters, P)
    int P, int N, int fd, int L) {
  using G = XfGrid<RB>;
  constexpr int TY = G::TY, TX = G::TX, TN = G::TN, STAGE = xf_stage(TN);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), xcl = (int)cluster.num_blocks();
  const int cid = blockIdx.x / xcl, ncl = gridDim.x / xcl;
  const int r0 = rank * RB;
  extern __shared__ __align__(16) float xf_smem_f[];
  float* fa_s = xf_smem_f;                      // [L][RB] the rank's rows, k-major
  float* rv_s = fa_s + (size_t)L * RB;          // [3][RB] their norms, t_r, t_c
  float* stg = rv_s + 3 * RB;                   // [2][STAGE] lanes of a tile; its norms, bm
  float* wq_s = stg + 2 * STAGE;                // [XF_WARPS][2][TN] the warps' kbt partials
  float* part_s = wq_s + XF_WARPS * 2 * TN;     // [2][XCL_MAX][2][TN] every rank's partials
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = lane % TX, ty = warp * (32 / TX) + lane / TX;
  const int ntiles = (N + TN - 1) / TN;
  const int mine = (ntiles - cid + ncl - 1) / ncl;   // >= 1: clusters <= tiles
  // a tile's lanes in nch chunks of kc (a multiple of 4, at most XF_KC)
  const int nch = (L + XF_KC - 1) / XF_KC;
  const int kc = ((L + nch - 1) / nch + 3) / 4 * 4;
  const int steps = mine * nch;
  auto col0 = [&](int i) { return (cid + i * ncl) * TN; };
  // step st (tile st / nch, chunk st % nch) into stage st % 2, with the
  // tile's norms and bm on its last chunk; columns past N read as zero.
  // One cp.async group (empty past the walk)
  auto load_step = [&](int st) {
    if (st < steps) {
      const int i = st / nch, ch = st % nch, k0 = ch * kc, nk = min(kc, L - k0);
      float* d = stg + (st & 1) * STAGE;
      const int c0 = col0(i);
      for (int c = tid; c < nk * (TN / 4); c += XF_THREADS) {
        const int k = c / (TN / 4), q = c % (TN / 4);
        if (c0 + 4 * q < N)
          cp_async16(d + k * TN + 4 * q, ft + (size_t)(k0 + k) * N + c0 + 4 * q);
        else
          *reinterpret_cast<float4*>(d + k * TN + 4 * q) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (ch == nch - 1 && tid < TN / 4) {
        if (c0 + 4 * tid < N) {
          cp_async16(d + XF_KC * TN + 4 * tid, nrm + P + c0 + 4 * tid);
          cp_async16(d + (XF_KC + 1) * TN + 4 * tid, bm + c0 + 4 * tid);
        } else {
          *reinterpret_cast<float4*>(d + XF_KC * TN + 4 * tid) = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(d + (XF_KC + 1) * TN + 4 * tid) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    cp_async_commit();
  };

  load_step(0);
  // the rank's rows, k-major over the live lanes, their norms and t2
  for (int c = tid; c < RB * (L / 4); c += XF_THREADS) {
    const int r = c % RB, q = c / RB;
    const float4 v = *reinterpret_cast<const float4*>(fa + (size_t)(r0 + r) * fd + 4 * q);
    float* d = fa_s + (size_t)(4 * q) * RB + r;
    d[0] = v.x, d[RB] = v.y, d[2 * RB] = v.z, d[3 * RB] = v.w;
  }
  for (int r = tid; r < RB; r += XF_THREADS) {
    rv_s[r] = nrm[r0 + r];
    rv_s[RB + r] = t2[r0 + r];
    rv_s[2 * RB + r] = t2[P + r0 + r];
  }
  cluster_arrive();              // every rank runs before the first push
  cluster_wait();

  float U[XF_R], span[XF_R];     // a thread's running sums of its rows' u, and a span's
#pragma unroll
  for (int r = 0; r < XF_R; ++r) U[r] = span[r] = 0.f;
  float e[XF_R][XF_C];           // a tile's crosses over the chunks so far, then its entries
  for (int st = 0; st < steps; ++st) {
    const int i = st / nch, ch = st % nch, k0 = ch * kc, nk = min(kc, L - k0);
    cp_async_wait_all();
    __syncthreads();             // step st in (the rows too); everyone done with st - 1's stage
    load_step(st + 1);
    float* d = stg + (st & 1) * STAGE;
    // the cross: each entry one FFMA chain over the lanes in order
    const float* fa_t = fa_s + (size_t)k0 * RB + 4 * ty;
    const float* fb_t = d + 4 * tx;
    if (ch == 0) xf_lane<TY, TX, true>(e, fa_t, fb_t);
#pragma unroll 2
    for (int k = ch == 0 ? 1 : 0; k < nk; ++k)
      xf_lane<TY, TX, false>(e, fa_t + k * RB, fb_t + k * TN);
    if (ch < nch - 1) continue;

    // tile i's entries, and this thread's kbt partials of its columns
    // (chains over its rows from the first term)
    float* sb = d + (XF_KC + 1) * TN;           // the tile's bm, then its s
    float pr[XF_C], pc[XF_C];
    {
      float nb[XF_C];
      xf_cols<TX>(nb, d + XF_KC * TN + 4 * tx);
#pragma unroll
      for (int g = 0; g < XF_R / 4; ++g) {
        const float4 na4 = *reinterpret_cast<const float4*>(rv_s + 4 * ty + 4 * TY * g);
        const float4 tr4 = *reinterpret_cast<const float4*>(rv_s + RB + 4 * ty + 4 * TY * g);
        const float4 tc4 = *reinterpret_cast<const float4*>(rv_s + 2 * RB + 4 * ty + 4 * TY * g);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int r = 4 * g + h;
          const float na = f4at(na4, h), tr = f4at(tr4, h), tc = f4at(tc4, h);
#pragma unroll
          for (int c = 0; c < XF_C; ++c) {
            e[r][c] = kf32(na + nb[c], e[r][c]);
            pr[c] = r == 0 ? tr * e[r][c] : fmaf(tr, e[r][c], pr[c]);
            pc[c] = r == 0 ? tc * e[r][c] : fmaf(tc, e[r][c], pc[c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < XF_C; ++c)   // over the warp's row threads: a fixed tree
#pragma unroll
      for (int off = TX; off < 32; off <<= 1) {
        pr[c] += __shfl_xor_sync(0xffffffffu, pr[c], off);
        pc[c] += __shfl_xor_sync(0xffffffffu, pc[c], off);
      }
    if (lane < TX) {
#pragma unroll
      for (int c = 0; c < XF_C; ++c) {
        const int j = 4 * tx + (c & 3) + 4 * TX * (c >> 2);
        wq_s[warp * 2 * TN + j] = pr[c];
        wq_s[warp * 2 * TN + TN + j] = pc[c];
      }
    }
    __syncthreads();             // the warps' partials in
    if (tid < 2 * TN) {
      // the warps in order, pushed into every rank's slot (i % 2, this
      // rank), which every rank read before the last cluster barrier
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < XF_WARPS; ++w) v += wq_s[w * 2 * TN + tid];
      float* dst = part_s + ((i & 1) * G::XCL_MAX + rank) * 2 * TN + tid;
#pragma unroll
      for (int q = 0; q < G::XCL_MAX; ++q)
        if (q < xcl) *cluster.map_shared_rank(dst, q) = v;
    }
    cluster_arrive();            // every rank's partials of tile i in
    cluster_wait();
    if (tid < TN) {              // the ranks in order, the same on every rank
      const float* pk = part_s + (i & 1) * G::XCL_MAX * 2 * TN + tid;
      float kbr = 0.f, kbc = 0.f;
#pragma unroll
      for (int q = 0; q < G::XCL_MAX; ++q)
        if (q < xcl) {
          kbr += pk[q * 2 * TN];
          kbc += pk[q * 2 * TN + TN];
        }
      const int j = col0(i) + tid;
      const float s = sb[tid] / sqrtf(fmaxf(kbr * kbc, EPS));
      sb[tid] = s;
      if (rank == 0 && j < N) s_out[j] = s;
    }
    __syncthreads();             // s in
    // tile i's u terms
    float sv[XF_C];
    xf_cols<TX>(sv, sb + 4 * tx);
#pragma unroll
    for (int r = 0; r < XF_R; ++r) {
      float tu = e[r][0] * sv[0];
#pragma unroll
      for (int c = 1; c < XF_C; ++c) tu = fmaf(e[r][c], sv[c], tu);
      span[r] += tu;
    }
    if ((i + 1) % XF_SPAN == 0 || i + 1 == mine) {
#pragma unroll
      for (int r = 0; r < XF_R; ++r) {
        U[r] += span[r];
        span[r] = 0.f;
      }
    }
  }
  // no remote access is left: every push into this block's shared memory
  // came before the last cluster barrier
  // the TX threads of a row: a fixed tree
#pragma unroll
  for (int r = 0; r < XF_R; ++r)
#pragma unroll
    for (int off = 1; off < TX; off <<= 1) U[r] += __shfl_xor_sync(0xffffffffu, U[r], off);
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < XF_R; ++r)
      u_part[(size_t)cid * P + r0 + 4 * ty + (r & 3) + 4 * TY * (r >> 2)] = U[r];
  }
}

typedef void (*ext2_f32_fn)(const float*, const float*, const float*, const float*,
                            const float*, float*, float*, int, int, int, int);

// K8 f32's kernel for an fd-lane layout (32, 64, 96 or 128), with its
// shared memory opted in at the layout's widest L and, for clusters of 16,
// the non-portable cluster size allowed
cudaError_t ext2_f32_tile_of(int fd, ext2_f32_fn* kernel) {
  const int rb = xf_rb(fd);
  *kernel = rb == 256 ? ext2_f32_tile_kernel<256> : ext2_f32_tile_kernel<512>;
  cudaError_t e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)xf_smem(fd, rb));
  if (e == cudaSuccess && 4096 / rb > CL)
    e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// the shapes K8 f32 takes: P % 512 == 0 in [512, 4096], fd 32, 64, 96 or
// 128, N % 64 == 0 (a last column tile may pass N)
bool ext2_f32_shape_ok(int P, int N, int fd) {
  return (fd == 32 || fd == 64 || fd == 96 || fd == 128) && P >= 512 && P <= 4096 &&
         P % 512 == 0 && N > 0 && N % 64 == 0;
}

// K8's kernel for P sample rows (P = 512 NB, NB in 1..8) of FD lanes, or null
typedef void (*ext2_fn)(const bf16*, const bf16*, const bf16*, const float*, float*, float*,
                        int, int);
template <int FD>
ext2_fn ext2_kernel_fd(int P) {
  switch (P / (CL * X_RG * 16)) {
    case 1: return ext2_matvec_kernel<1, FD>;
    case 2: return ext2_matvec_kernel<2, FD>;
    case 3: return ext2_matvec_kernel<3, FD>;
    case 4: return ext2_matvec_kernel<4, FD>;
    case 5: return ext2_matvec_kernel<5, FD>;
    case 6: return ext2_matvec_kernel<6, FD>;
    case 7: return ext2_matvec_kernel<7, FD>;
    case 8: return ext2_matvec_kernel<8, FD>;
    default: return nullptr;
  }
}
ext2_fn ext2_kernel(int P, int fd) {
  return fd == 32    ? ext2_kernel_fd<32>(P)
         : fd == 64  ? ext2_kernel_fd<64>(P)
         : fd == 96  ? ext2_kernel_fd<96>(P)
         : fd == 128 ? ext2_kernel_fd<128>(P)
                     : nullptr;
}
size_t ext2_smem(int P, int fd) {
  return fd == 32 ? ext2_smem<32>(P) : fd == 64 ? ext2_smem<64>(P) : fd == 96 ? ext2_smem<96>(P)
                                                                             : ext2_smem<128>(P);
}

// K7's launch at feature depth FD
template <int FD>
int launch_kb_strip(const void* fa, const void* ft, const void* cols, void* out, int P, int S,
                    cudaStream_t s) {
  constexpr size_t smem = e_smem<FD>();
  CUtensorMap ft_map, out_map;
  if (!tile_map(&ft_map, ft, false, S, FD, S, E_BOX, FD) ||
      !tile_map(&out_map, out, false, S, P, S, E_BOX, E_TM))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaFuncSetAttribute(kb_emit_kernel<FD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kb_emit_kernel<FD>, E_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // a last column tile past S reads zero f_t columns and its store is clipped
  const int nrb = P / E_TM, nct = (S + E_TN - 1) / E_TN;
  const long long units = (long long)nrb * nct;
  const int grid = (int)((long long)occ * sms < units ? (long long)occ * sms : units);
  kb_emit_kernel<FD><<<grid, E_THREADS, smem, s>>>(ft_map, out_map, static_cast<const bf16*>(fa),
                                                   static_cast<const bf16*>(cols), nrb, nct, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K7. P % 128 == 0, S % 128 == 0, fd 32, 64, 96 or 128 aug lanes, fa, ft,
// cols and out 16-byte aligned (the wrapper checks). Persistent blocks, as
// many as fit the card at once (the occupancy API), at most one an E_TM x
// E_TN unit.
int glt_kb_strip(const void* fa, const void* ft, const void* cols, void* out, int P, int S,
                 int fd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (P < E_TM || S < 128 || P % E_TM || S % 128 ||
      (fd != 32 && fd != 64 && fd != 96 && fd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return fd == 32   ? launch_kb_strip<32>(fa, ft, cols, out, P, S, s)
         : fd == 64 ? launch_kb_strip<64>(fa, ft, cols, out, P, S, s)
         : fd == 96 ? launch_kb_strip<96>(fa, ft, cols, out, P, S, s)
                    : launch_kb_strip<128>(fa, ft, cols, out, P, S, s);
}

// how many f32 K8 clusters to launch for P sample rows of fd lanes (32, 64,
// 96 or 128) and N columns: as many as fit the card at once (P / 512 blocks
// each, P / 256 at 128 lanes), at most one a column tile (64 columns, 128
// at 128 lanes); a negative value is a cudaError
int glt_ext2_f32_clusters(int P, int fd, int N) {
  if (!ext2_f32_shape_ok(P, N, fd)) return -static_cast<int>(cudaErrorInvalidValue);
  ext2_f32_fn kernel;
  cudaError_t e = ext2_f32_tile_of(fd, &kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int rb = xf_rb(fd);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(P / rb, 1, XF_THREADS, xf_smem(fd, rb), nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int tiles = (N + xf_tn(rb) - 1) / xf_tn(rb);
  return n < tiles ? n : tiles;
}

// K8, f32 layout of fd lanes (32, 64, 96 or 128). P % 512 == 0 in [512,
// 4096], N % 64 == 0, live % 4 == 0 in [4, fd], 1 <= clusters <= the
// column tiles (64 columns, 128 at 128 lanes; glt_ext2_f32_clusters), fa, ft,
// t2, bm and nrm 16-byte aligned (the wrapper checks); nrm holds P + N
// floats of scratch, u_part (clusters, P). The norms' pre-pass, the
// kernel, then the fixed-order reduction of u_part into u.
int glt_ext2_matvec_f32(const void* fa, const void* ft, const void* t2, const void* bm,
                        void* s_out, void* u_part, void* u, void* nrm, int P, int N,
                        int clusters, int live, int fd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int rb = xf_rb(fd);
  if (!ext2_f32_shape_ok(P, N, fd) || live < 4 || live > fd || live % 4 || clusters < 1 ||
      clusters > (N + xf_tn(rb) - 1) / xf_tn(rb))
    return static_cast<int>(cudaErrorInvalidValue);
  ext2_f32_fn kernel;
  cudaError_t e = ext2_f32_tile_of(fd, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* a = static_cast<const float*>(fa);
  const float* b = static_cast<const float*>(ft);
  float* nm = static_cast<float*>(nrm);
  ext2_norms_kernel<<<(P + N + 255) / 256, 256, 0, s>>>(a, b, nm, P, N, fd, live);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(P / rb, clusters, XF_THREADS, xf_smem(live, rb), s,
                                             attr);
  e = cudaLaunchKernelEx(&cfg, kernel, a, b, static_cast<const float*>(t2),
                         static_cast<const float*>(bm), static_cast<const float*>(nm),
                         static_cast<float*>(s_out), static_cast<float*>(u_part), P, N, fd, live);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(u_part), static_cast<float*>(u), clusters,
                       (size_t)P, s);
}

// K7's entry (kb_pair) at every one of the 65536 bf16(d2) patterns: out
// holds 65536 bf16 bit patterns (chip_smoke.py compares them with kb_aug's)
int glt_kb_entries(void* out, void* stream) {
  kb_entries_kernel<<<256, 128, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(out));
  return static_cast<int>(cudaGetLastError());
}

// how many 8-block K8 clusters for P sample rows of fd lanes fit the card
// at once; a negative value is a cudaError
int glt_ext2_clusters(int P, int fd) {
  const ext2_fn kernel = ext2_kernel(P, fd);
  if (kernel == nullptr || P % (CL * X_RG * 16)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ext2_smem(P, fd);
  cudaError_t e = cudaFuncSetAttribute(kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(CL, 1, X_THREADS, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// K8. P % 512 == 0, P <= 4096, N % 64 == 0, 1 <= clusters <= N / 64, fd
// 32, 64, 96 or 128 aug lanes (the wrapper checks); u_part holds
// (clusters, P) floats.
int glt_ext2_matvec(const void* fa, const void* ft, const void* t2, const void* bm,
                    void* s_out, void* u_part, void* u, int P, int N, int clusters, int fd,
                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const ext2_fn kernel = ext2_kernel(P, fd);
  if (kernel == nullptr || P % (CL * X_RG * 16)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ext2_smem(P, fd);
  cudaError_t e = cudaFuncSetAttribute(kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(CL, clusters, X_THREADS, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(fa),
                         static_cast<const bf16*>(ft), static_cast<const bf16*>(t2),
                         static_cast<const float*>(bm), static_cast<float*>(s_out),
                         static_cast<float*>(u_part), P, N);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_reduce(static_cast<const float*>(u_part), static_cast<float*>(u), clusters,
                       (size_t)P, s);
}

}  // extern "C"
