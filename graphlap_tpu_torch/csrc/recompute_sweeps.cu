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
// (the bilateral recipes, spatial_h > 0) take kernels of their own,
// kb_f32_kernel and ext2_f32_kernel below, at the same four depths: the
// reference's f32 _kb_tile class, an IEEE f32 FFMA cross over the live
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
// parameter: 32 (aug_d_pad_of of NLM d 25) or 64 (of NLM d 49, a 7 x 7
// patch). So do the f32 kernels (K7 f32, K8 f32): 32 (a 5 x 5 patch and
// the coordinates, or gaussian + coordinates) or 64 (a 7 x 7 patch and the
// coordinates, 52 live lanes); their arithmetic runs over the live lanes,
// so a 32-lane layout takes the same chains in either instantiation.

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
// K7, f32 layout: the column-scaled f32 tile
// ---------------------------------------------------------------------------
//
// out[p, j] = exp(-max((na_p + nb_j) - 2 cross, 0)) * cols_j in f32, the
// reference's f32 class (kf32): the cross an f32 FFMA chain over the live
// lanes, the norms f32 FFMA chains over the same lanes, no bf16 rounding
// point. At the 8 MP gram shape (p_pad 4096, 131072 columns) it stores 2.15
// GB of f32 (0.64 ms at 3.35 TB/s) for 5.4e8 entries (their exps 0.13 ms):
// bound by the store; at 52 live lanes the cross, 2 live flop an entry,
// is 5.6e10 flop (0.84 ms at the 67 TFLOP/s f32 peak), the bound. A
// 256-thread block owns a 32 x 256 unit, its rows and f_t columns in
// shared memory; a thread computes 8 rows by 4 adjacent columns and writes
// each row's four as one streamed (evict-first) 16-byte store, so a warp
// writes 512 contiguous bytes a row. The kernel is a template on the
// layout's depth FD (32, 64, 96 or 128): at 64 the f_t columns take 66.5
// KB, past the 48 KB of static shared memory, so every depth keeps its
// rows and columns in dynamic shared memory (kb_f32_smem: 112,640 and
// 150,016 bytes at 96 and 128, one block an SM); at 84 and 124 live lanes
// (an NLM 9 x 9 or 11 x 11 patch and the coordinates) the cross is 2 live
// flop an entry, 9.1e10 and 1.3e11 flop at the gram shape, 1.35 and 1.99
// ms at the f32 peak, the bound beside the store's 0.64.
constexpr int EF_THREADS = 256;
constexpr int EF_TM = 32, EF_TN = 256;
template <int FD>
constexpr int EF_LDA_OF = FD + 4;   // fa_s row stride (floats)
constexpr int EF_LDB = EF_TN + 4;   // ft_s row stride (floats)
template <int FD>
constexpr size_t kb_f32_smem() {
  return sizeof(float) * ((size_t)EF_TM * EF_LDA_OF<FD> + (size_t)FD * EF_LDB);
}

template <int FD>
__global__ __launch_bounds__(EF_THREADS) void kb_f32_kernel(
    const float* __restrict__ fa,    // (P, FD)
    const float* __restrict__ ft,    // (FD, S)
    const float* __restrict__ cols,  // (S)
    float* __restrict__ out,         // (P, S)
    int S, int live) {
  constexpr int EF_LDA = EF_LDA_OF<FD>;
  extern __shared__ __align__(16) float ef_smem[];
  float* fa_s = ef_smem;                      // [EF_TM][EF_LDA]
  float* ft_s = ef_smem + EF_TM * EF_LDA;     // [FD][EF_LDB]
  __shared__ __align__(16) float na_s[EF_TM], nb_s[EF_TN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * EF_TM, c0 = blockIdx.x * EF_TN;
  const int wcols = min(EF_TN, S - c0);   // S % 128 == 0: 128 or 256
  const int l4 = live / 4;
  for (int i = tid; i < EF_TM * l4; i += EF_THREADS) {
    const int r = i / l4, q = i % l4;
    *reinterpret_cast<float4*>(fa_s + r * EF_LDA + 4 * q) =
        *reinterpret_cast<const float4*>(fa + (size_t)(r0 + r) * FD + 4 * q);
  }
  for (int i = tid; i < live * (wcols / 4); i += EF_THREADS) {
    const int k = i / (wcols / 4), q = i % (wcols / 4);
    *reinterpret_cast<float4*>(ft_s + k * EF_LDB + 4 * q) =
        *reinterpret_cast<const float4*>(ft + (size_t)k * S + c0 + 4 * q);
  }
  __syncthreads();
  if (tid < wcols) {
    float s = 0.f;
    for (int k = 0; k < live; ++k) s = fmaf(ft_s[k * EF_LDB + tid], ft_s[k * EF_LDB + tid], s);
    nb_s[tid] = s;
  }
  if (tid < EF_TM) {
    float s = 0.f;
    for (int k = 0; k < live; ++k) s = fmaf(fa_s[tid * EF_LDA + k], fa_s[tid * EF_LDA + k], s);
    na_s[tid] = s;
  }
  __syncthreads();
  const int rw = (warp >> 1) * 8, jl = (warp & 1) * 128 + 4 * lane;   // 8 rows, 4 columns
  if (jl >= wcols) return;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int k = 0; k < live; k += 4) {
    float4 bq[4];   // lanes k..k+3 of the 4 columns
#pragma unroll
    for (int q = 0; q < 4; ++q) bq[q] = *reinterpret_cast<const float4*>(ft_s + (k + q) * EF_LDB + jl);
    const float4 b0 = make_float4(bq[0].x, bq[1].x, bq[2].x, bq[3].x);
    const float4 b1 = make_float4(bq[0].y, bq[1].y, bq[2].y, bq[3].y);
    const float4 b2 = make_float4(bq[0].z, bq[1].z, bq[2].z, bq[3].z);
    const float4 b3 = make_float4(bq[0].w, bq[1].w, bq[2].w, bq[3].w);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(fa_s + (rw + i) * EF_LDA + k);
      acc[i][0] = dot4(av, b0, acc[i][0]);
      acc[i][1] = dot4(av, b1, acc[i][1]);
      acc[i][2] = dot4(av, b2, acc[i][2]);
      acc[i][3] = dot4(av, b3, acc[i][3]);
    }
  }
  const float4 nb = *reinterpret_cast<const float4*>(nb_s + jl);
  const float4 cs = *reinterpret_cast<const float4*>(cols + c0 + jl);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float na = na_s[rw + i];
    __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + rw + i) * S + c0 + jl),
           make_float4(kf32(na + nb.x, acc[i][0]) * cs.x, kf32(na + nb.y, acc[i][1]) * cs.y,
                       kf32(na + nb.z, acc[i][2]) * cs.z, kf32(na + nb.w, acc[i][3]) * cs.w));
  }
}

// ---------------------------------------------------------------------------
// K8, f32 layout: clusters of 8, the tile in registers
// ---------------------------------------------------------------------------
//
// kbt_j = k_j^T [t_r, t_c], s_j = bm_j / sqrt(max(kbt_r kbt_c, 1e-30)), u +=
// k_j s_j with the f32 entry (kf32) and f32 FMAs throughout, the
// reference's "highest" class. At 8 MP (p_pad 4096, N 8388608) it forms
// 3.4e10 entries, one exp each: 8.2 ms of MUFU ex2 at 132 SMs, the bound;
// the live-lane cross (4 lanes) ~4 ms of FFMA; at 52 live lanes (a 7 x 7
// patch and the coordinates) the cross and the six FMAs of kbt and u, 110
// flop an entry, take 56 ms at the f32 peak, the bound. The kernel is a
// template on the layout's depth FD (32, 64, 96 or 128: the sample rows'
// stride in shared memory, 158 KB of it at p_pad 4096 and 64 lanes, 232,064
// bytes at 96, one block an SM); its loops run over the live lanes. As the
// bf16 kernel, a column needs kbt over the whole p before its s and s
// before its u term, so a cluster of XCL blocks shares each 32-column tile,
// rank r owning sample rows [r P/XCL, (r+1) P/XCL) in shared memory; the
// tile never leaves registers. XCL is 8 up to 96 lanes; at 128, 8 ranks'
// rows (512 x 132 floats at p_pad 4096, 270 KB) pass a block's 227 KB,
// and a row stride of the live lanes alone would not save it (262 KB), so
// the cluster takes 16 blocks (a size the H100 allows as non-portable;
// 170,624 bytes a block), its partials still summed in rank order. A
// 16-rank slice of P rows need not be a multiple of the 64 row groups
// (p_pad 512, 1536, ...): a thread's rows past the slice are masked to
// zero entries. Sample rows streamed through a block in parts would need
// the tile's entries of every part at once (kbt before s before u), or a
// second recompute of the tile:
//   * 256 threads a block, each NR = P / (64 XCL) rows (rg + 64 i; rounded
//     up) by 8 columns (a lane is 8 row groups x 4 column groups), so a
//     thread holds 8 NR entries;
//     the tile's f_t columns arrive by cp.async double buffering;
//   * kbt: each thread's row sums, a shuffle tree over the warp's row
//     groups, the 8 warps in order in shared memory, then the XCL ranks'
//     partials in rank order through distributed shared memory after one
//     cluster barrier a tile (partials double-buffered), so every rank
//     computes the same s;
//   * u: a tile's row sums from zero (8 columns a thread, then a shuffle
//     over the 4 column groups), added to a span's sum from zero, which
//     joins the running u by one f32 add every XF_SPAN tiles: no f32 chain
//     runs over more than a few hundred terms;
//   * clusters walk the tiles in a fixed stride order and the cross-cluster
//     u goes through per-cluster partials and the fixed-order reduction:
//     runs repeat bit for bit.
constexpr int XF_THREADS = 256;
constexpr int XF_TN = 32;         // columns a tile
template <int FD>
constexpr int XF_LDA_OF = FD + 4;   // fa_s row stride (floats)
constexpr int XF_SPAN = 64;       // tiles a span of u

// blocks a cluster at depth fd: 8, or 16 at 128 lanes (see above)
__host__ __device__ constexpr int ext2_f32_cl(int fd) { return fd == 128 ? 2 * CL : CL; }

size_t ext2_f32_smem(int P, int fd) {
  return sizeof(float) * ((size_t)(P / ext2_f32_cl(fd)) * (fd + 4) + 2 * (size_t)fd * XF_TN +
                          8 * 2 * XF_TN + 2 * 2 * XF_TN + XF_TN);
}

// rows a thread: NR = ceil(P / (XCL 64)); the layout's depth
template <int NR, int FD>
__global__ __launch_bounds__(XF_THREADS, 1) void ext2_f32_kernel(
    const float* __restrict__ fa,   // (P, FD)
    const float* __restrict__ ft,   // (FD, N)
    const float* __restrict__ t2,   // (2, P)
    const float* __restrict__ bm,   // (N)
    float* __restrict__ s_out,      // (N)
    float* __restrict__ u_part,     // (clusters, P)
    int P, int N, int live) {
  constexpr int XCL = ext2_f32_cl(FD);
  constexpr bool RAGGED = XCL != CL;     // rb may end inside a thread's last row
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / XCL, ncl = gridDim.x / XCL;
  const int rb = P / XCL, r0 = rank * rb;   // rb == 64 NR, or in (64 (NR - 1), 64 NR]
  constexpr int XF_LDA = XF_LDA_OF<FD>;
  extern __shared__ __align__(16) float xf_smem[];
  float* fa_s = xf_smem;                     // [rb][XF_LDA]
  float* ft_s = fa_s + rb * XF_LDA;          // [2][FD][XF_TN]
  float* wq_s = ft_s + 2 * FD * XF_TN;       // [8 warps][2][XF_TN]
  float* part_s = wq_s + 8 * 2 * XF_TN;      // [2][2][XF_TN] this rank's kbt partials
  float* s_s = part_s + 2 * 2 * XF_TN;       // [XF_TN]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp * 8 + (lane >> 2), cgi = lane & 3;   // row group, column group
  const int l4 = live / 4;
  const int ntiles = N / XF_TN;
  const int mine = (ntiles - cid + ncl - 1) / ncl;   // >= 1: clusters <= tiles
  auto col0 = [&](int i) { return (cid + i * ncl) * XF_TN; };
  auto load_ft = [&](int i, int buf) {
    for (int c = tid; c < live * (XF_TN / 4); c += XF_THREADS) {
      const int k = c / (XF_TN / 4), q = c % (XF_TN / 4);
      cp_async16(ft_s + (buf * FD + k) * XF_TN + 4 * q, ft + (size_t)k * N + col0(i) + 4 * q);
    }
    cp_async_commit();
  };

  for (int c = tid; c < rb * l4; c += XF_THREADS) {
    const int r = c / l4, q = c % l4;
    cp_async16(fa_s + r * XF_LDA + 4 * q, fa + (size_t)(r0 + r) * FD + 4 * q);
  }
  load_ft(0, 0);
  cp_async_wait_all();
  __syncthreads();
  float na[NR], tr[NR], tc[NR], U[NR], span[NR];
  bool ok[NR];   // the row lies in this rank's slice
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = rg + 64 * i;
    ok[i] = !RAGGED || r < rb;
    float s = 0.f;
    if (ok[i])
      for (int k = 0; k < live; ++k) s = fmaf(fa_s[r * XF_LDA + k], fa_s[r * XF_LDA + k], s);
    na[i] = s;
    tr[i] = ok[i] ? t2[r0 + r] : 0.f;
    tc[i] = ok[i] ? t2[P + r0 + r] : 0.f;
    U[i] = span[i] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    const int buf = i & 1;
    if (i > 0) {
      cp_async_wait_all();
      __syncthreads();     // tile i in; everyone done with tile i - 1's s_s and wq_s
    }
    if (i + 1 < mine) load_ft(i + 1, buf ^ 1);
    const float* fb = ft_s + buf * FD * XF_TN + cgi * 8;
    float nb[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) nb[c] = 0.f;
    float e[NR][8];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) e[r][c] = 0.f;
    for (int k = 0; k < live; k += 4) {
      float bq[4][8];   // lanes k..k+3 of the thread's 8 columns
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 lo = *reinterpret_cast<const float4*>(fb + (k + q) * XF_TN);
        const float4 hi = *reinterpret_cast<const float4*>(fb + (k + q) * XF_TN + 4);
        bq[q][0] = lo.x, bq[q][1] = lo.y, bq[q][2] = lo.z, bq[q][3] = lo.w;
        bq[q][4] = hi.x, bq[q][5] = hi.y, bq[q][6] = hi.z, bq[q][7] = hi.w;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 b = make_float4(bq[0][c], bq[1][c], bq[2][c], bq[3][c]);
        nb[c] = dot4(b, b, nb[c]);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(fa_s + (rg + 64 * r) * XF_LDA + k);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          e[r][c] = dot4(av, make_float4(bq[0][c], bq[1][c], bq[2][c], bq[3][c]), e[r][c]);
      }
    }
    // the entries, and this thread's kbt partials of its 8 columns
    float pr[8], pc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) pr[c] = pc[c] = 0.f;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // a masked row read past the slice, still inside the block's
        // shared memory: its entries are zero
        e[r][c] = ok[r] ? kf32(na[r] + nb[c], e[r][c]) : 0.f;
        pr[c] = fmaf(tr[r], e[r][c], pr[c]);
        pc[c] = fmaf(tc[r], e[r][c], pc[c]);
      }
#pragma unroll
    for (int c = 0; c < 8; ++c)   // over the warp's 8 row groups: a fixed tree
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        pr[c] += __shfl_xor_sync(0xffffffffu, pr[c], off);
        pc[c] += __shfl_xor_sync(0xffffffffu, pc[c], off);
      }
    if (lane < 4) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        wq_s[(warp * 2) * XF_TN + cgi * 8 + c] = pr[c];
        wq_s[(warp * 2 + 1) * XF_TN + cgi * 8 + c] = pc[c];
      }
    }
    __syncthreads();
    if (tid < 2 * XF_TN) {   // the warps in order
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) v += wq_s[w * 2 * XF_TN + tid];
      part_s[buf * 2 * XF_TN + tid] = v;
    }
    cluster.sync();          // every rank's partials of tile i are in
    if (tid < XF_TN) {       // the ranks in order, the same on every rank
      float kr = 0.f, kc = 0.f;
      float* pk = part_s + buf * 2 * XF_TN + tid;
#pragma unroll
      for (int q = 0; q < XCL; ++q) {
        kr += *cluster.map_shared_rank(pk, q);
        kc += *cluster.map_shared_rank(pk + XF_TN, q);
      }
      const int j = col0(i) + tid;
      const float s = bm[j] / sqrtf(fmaxf(kr * kc, EPS));
      s_s[tid] = s;
      if (rank == 0) s_out[j] = s;
    }
    __syncthreads();         // s_s in
    float sv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) sv[c] = s_s[cgi * 8 + c];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float tu = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) tu = fmaf(e[r][c], sv[c], tu);
      tu += __shfl_xor_sync(0xffffffffu, tu, 1);   // the 4 column groups
      tu += __shfl_xor_sync(0xffffffffu, tu, 2);
      span[r] += tu;
    }
    if ((i + 1) % XF_SPAN == 0 || i + 1 == mine) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        U[r] += span[r];
        span[r] = 0.f;
      }
    }
  }
  if (cgi == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (ok[r]) u_part[(size_t)cid * P + r0 + rg + 64 * r] = U[r];
  }
  cluster.sync();            // no block leaves while read remotely
}

typedef void (*ext2_f32_fn)(const float*, const float*, const float*, const float*, float*,
                            float*, int, int, int);
template <int FD>
ext2_f32_fn ext2_f32_kernel_fd(int P) {
  constexpr int rows = ext2_f32_cl(FD) * 64;   // a cluster's rows of one row a thread
  const int nr = (P + rows - 1) / rows;
  if constexpr (ext2_f32_cl(FD) > CL) {        // P <= 4096: at most 4 rows a thread
    switch (nr) {
      case 1: return ext2_f32_kernel<1, FD>;
      case 2: return ext2_f32_kernel<2, FD>;
      case 3: return ext2_f32_kernel<3, FD>;
      case 4: return ext2_f32_kernel<4, FD>;
      default: return nullptr;
    }
  } else {
    switch (nr) {
      case 1: return ext2_f32_kernel<1, FD>;
      case 2: return ext2_f32_kernel<2, FD>;
      case 3: return ext2_f32_kernel<3, FD>;
      case 4: return ext2_f32_kernel<4, FD>;
      case 5: return ext2_f32_kernel<5, FD>;
      case 6: return ext2_f32_kernel<6, FD>;
      case 7: return ext2_f32_kernel<7, FD>;
      case 8: return ext2_f32_kernel<8, FD>;
      default: return nullptr;
    }
  }
}
// K8 f32's kernel for P sample rows of an fd-lane layout (32, 64, 96 or
// 128), or null
ext2_f32_fn ext2_f32_kernel_for(int P, int fd) {
  return fd == 32    ? ext2_f32_kernel_fd<32>(P)
         : fd == 64  ? ext2_f32_kernel_fd<64>(P)
         : fd == 96  ? ext2_f32_kernel_fd<96>(P)
         : fd == 128 ? ext2_f32_kernel_fd<128>(P)
                     : nullptr;
}

// K8 f32's kernel attributes: its shared memory, and clusters of 16
// (non-portable) at 128 lanes
cudaError_t ext2_f32_attrs(ext2_f32_fn kernel, int P, int fd) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)ext2_f32_smem(P, fd));
  if (e == cudaSuccess && ext2_f32_cl(fd) > CL)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// K7 f32's launch at depth FD: a grid of 32 x 256 units
template <int FD>
int launch_kb_f32(const float* fa, const float* ft, const float* cols, float* out, int P, int S,
                  int live, cudaStream_t s) {
  constexpr size_t smem = kb_f32_smem<FD>();
  const cudaError_t e = cudaFuncSetAttribute(
      kb_f32_kernel<FD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + EF_TN - 1) / EF_TN, P / EF_TM);
  kb_f32_kernel<FD><<<grid, EF_THREADS, smem, s>>>(fa, ft, cols, out, S, live);
  return static_cast<int>(cudaGetLastError());
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

// K7, f32 layout of fd lanes (32, 64, 96 or 128). P % 32 == 0, S % 128 ==
// 0, live % 4 == 0 in [4, fd], fa, ft, cols and out 16-byte aligned (the
// wrapper checks); a grid of 32 x 256 units.
int glt_kb_strip_f32(const void* fa, const void* ft, const void* cols, void* out, int P, int S,
                     int live, int fd, void* stream) {
  if (P < EF_TM || S < 128 || P % EF_TM || S % 128 ||
      (fd != 32 && fd != 64 && fd != 96 && fd != 128) || live < 4 || live > fd || live % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(fa);
  const float* b = static_cast<const float*>(ft);
  const float* c = static_cast<const float*>(cols);
  float* o = static_cast<float*>(out);
  return fd == 32   ? launch_kb_f32<32>(a, b, c, o, P, S, live, s)
         : fd == 64 ? launch_kb_f32<64>(a, b, c, o, P, S, live, s)
         : fd == 96 ? launch_kb_f32<96>(a, b, c, o, P, S, live, s)
                    : launch_kb_f32<128>(a, b, c, o, P, S, live, s);
}

// how many f32 K8 clusters (8 blocks, 16 at 128 lanes) for P sample rows
// of fd lanes (32, 64, 96 or 128) fit the card at once; a negative value
// is a cudaError
int glt_ext2_f32_clusters(int P, int fd) {
  const ext2_f32_fn kernel = ext2_f32_kernel_for(P, fd);
  if (kernel == nullptr || P % (CL * 64)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ext2_f32_smem(P, fd);
  cudaError_t e = ext2_f32_attrs(kernel, P, fd);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(ext2_f32_cl(fd), 1, XF_THREADS, smem, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : n;
}

// K8, f32 layout of fd lanes (32, 64, 96 or 128). P % 512 == 0, P <= 4096,
// N % 64 == 0, live % 4 == 0 in [4, fd], 1 <= clusters <= N / 32 (the
// wrapper checks); u_part holds (clusters, P) floats.
int glt_ext2_matvec_f32(const void* fa, const void* ft, const void* t2, const void* bm,
                        void* s_out, void* u_part, void* u, int P, int N, int clusters, int live,
                        int fd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const ext2_f32_fn kernel = ext2_f32_kernel_for(P, fd);
  if (kernel == nullptr || P % (CL * 64) || N % XF_TN || live < 4 || live > fd || live % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ext2_f32_smem(P, fd);
  cudaError_t e = ext2_f32_attrs(kernel, P, fd);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_cfg(ext2_f32_cl(fd), clusters, XF_THREADS, smem, s, attr);
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(fa),
                         static_cast<const float*>(ft), static_cast<const float*>(t2),
                         static_cast<const float*>(bm), static_cast<float*>(s_out),
                         static_cast<float*>(u_part), P, N, live);
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
