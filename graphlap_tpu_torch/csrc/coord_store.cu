// K1 on coordinate features and the f32 K7 — one IEEE f32 store tile.
//
// Replaces graphlap_tpu/ops/pallas_affinity.py:affinity_strip_pallas where
// the features carry coordinates (the config's spatial_h > 0), and
// graphlap_tpu/ops/pallas_streaming.py:kb_strip_pallas on the f32 layout
// (the bilateral recipes' gram sweep). Both write every entry of a kernel
// tile, row-major, from an f32 cross in the reference's f32 class (kf32,
// mma_common.cuh):
//   K1, bf16 store   out[i, j] = bf16(kexp((|a_i|^2 - a_i.b_j) + (|b_j|^2 - a_i.b_j)))
//   K1, f32 store    out[i, j] = expf(-max((|a_i|^2 - a_i.b_j) + (|b_j|^2 - a_i.b_j), 0))
//   K7, f32 layout   out[p, j] = kf32(|fa_p|^2 + |f_j|^2, fa_p.f_j) * cols_j
// each cross an f32 FFMA chain over the L lanes in lane order from the first
// lane's product, each norm the same chain over its own lanes. L is a
// run-time argument: d rounded up to 4 for K1 (3, 27, 51, 83, 123 raw lanes:
// 4, 28, 52, 84, 124), the live lanes for K7 (_lanes(live, fd)); the pad
// lanes are zero, so a chain over them would add exact zeros, and every
// entry is the bits of the depth-templated kernels this one replaced
// (scripts/f32_same_bits.py). K1's d2 keeps the form (|a|^2 - a.b) + (|b|^2
// - a.b): where the entry lives each difference is exact, so d2 loses no
// rounding of |a|^2 + |b|^2 (an ulp of |f|^2 ~ 3e5 on 2048 x 4096
// coordinates; tests/test_torch_bilateral.py holds it against f64).
// Coordinates take the f32 cross because the split-fp16 cross's small part
// loses about four times the f32 product's error at that norm.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W: 67 TFLOP/s f32,
// 3.35 TB/s). The cross, 2 L flop an entry: at 124 lanes 5.09 ms for K1 at
// 5248 x 262144 (4.99 at the dense K_AB, 5243 x 256901) and 1.99 ms for K7 at
// the gram shape 4096 x 131072; 3.45 / 3.38 / 1.35 ms at 84 lanes, 2.13 /
// 0.83 at 52. Beside it each entry's epilogue is ~6-10 FP32-pipe
// instructions and one MUFU ex2. At 4 lanes the store bounds it: K1's bf16
// strip at 2688 x 262144 is 1.41 GB (0.42 ms), K7's f32 tile 2.15 GB (0.64
// ms).
//
// Design (coord_store_kernel), an SGEMM's register tile as the coordinate
// K5/K6's (recompute_matvec.cu coord_tile_kernel):
//   * a block of CS_THREADS threads owns CS_FT sample rows, staged once for
//     its walk k-major over the L lanes (a transpose of the row-major rows in
//     shared memory), and walks the CS_ST-column tiles of its split of the
//     columns, which arrive k-major by cp.async double buffering in chunks
//     of at most CS_KC lanes (L split evenly: 4 chunks of 31 lanes at 124, 3
//     of 28 at 84, 2 of 26 at 52), each tile's column norms (and K7's column
//     scales) with its last chunk; up to 32 lanes a stage holds up to
//     CS_TPS whole tiles (4 at 4 lanes);
//   * a thread holds CS_R rows x CS_C columns of crosses in registers (two
//     float4 groups of four consecutive on each side, 4 CS_TY and 4 CS_TX
//     apart) and, a lane at a time, reads both sides as float4 loads of
//     shared memory: 4 loads for 64 FFMA (the kernels it replaced: 12 for
//     128, every block's 256 columns of all lanes in shared memory, one
//     block an SM at 128 lanes);
//   * the norms come from a pre-pass (ext2_norms_kernel, mma_common.cuh: one
//     thread an entry, the same chain), so each column's norm is formed once
//     a launch and not once a 32-row unit; K1's row-major features (d not a
//     multiple of 4, rows not 16-byte aligned) are first written by
//     coord_pack_kernel into scratch as the K7 layouts lie: the rows
//     row-major over L lanes, the pixels k-major, pad lanes and pixels zero;
//   * after a tile's last chunk each entry's epilogue runs on its cross
//     register and the thread stores each row's four consecutive entries as
//     one streamed (evict-first) 16-byte (f32) or 8-byte (bf16) vector; a
//     warp is 2 x 16 threads, so a store writes 2 rows of 64 consecutive
//     entries; rows past p and entries past n masked (K1's rows padded to
//     256 bytes, ld);
//   * two blocks an SM (16 warps; at most 128 registers a thread; 104.5 KB
//     of shared memory at 128 lanes), the grid (row blocks, column splits)
//     with the splits planned by the wrapper to fill whole waves of the
//     resident blocks (ops/cuda_affinity.store_plan).
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) by
// scripts/coord_store_designs.py, in turns with the kernels it replaced
// (affinity_coord_kernel<C1FD, ·> and kb_f32_kernel<FD>: a 256-thread
// block a 32 x 256 unit, 4 entries a thread's row, every lane of its 256
// columns in shared memory, one block an SM at 128 lanes), ms at 124 / 84 /
// 52 / 28 / 4 live lanes (PERF.md):
//   K1 bf16 store, 5248 x 262144: 8.91 / 6.35 / 4.24 / 2.59 / 1.07 (were
//     17.4-20.3 / 8.41 / 5.05 / 3.05 / 1.17); at 2688 x 262144, 4 lanes,
//     0.59-0.64 (0.61);
//   K1 f32 store, 5243 x 256901: 8.94 / 6.36 / 4.30 / 2.66 / 1.80-1.83
//     (were 20.03 / 9.20 / 5.33 / 3.12 / 1.76-1.87);
//   K7, 4096 x 131072: 3.66 / 2.62 / 1.78 / 1.10 / 0.74 (were 8.70 / 4.02 /
//     2.32 / 1.38 / 0.70): at 4 lanes, the store alone, 5-7% slower.
// Beside it: warps of 4 x 8 threads (a store 4 rows of 32 entries) equal
// past 4 lanes and 4-5% slower at 4 (K7, K1's f32 store); the warp's
// halves swapping 64 entries by shuffles (a store one row of 128) 1-4%
// slower past 4 lanes and no faster at 4; 1 x 32 warps on 64-row,
// 256-column tiles 5-7% slower past 4 lanes, 0-2% faster at 4; each split a
// contiguous range of the tiles up to 3% slower; 8 x 16 entries a thread
// (one block an SM) 1-3% faster for K7 at 124 and 4 lanes and the f32
// store at 124, 1-12% slower elsewhere past 4 lanes and 25-28% slower for
// K1's bf16 store at 4; 8 x 4 entries (three blocks an SM at few lanes)
// 1-22% slower; one block an SM within 1%; one tile a stage within 1%, but
// 7-9% slower for K1's bf16 store at 4 lanes; the stores without the
// evict-first hint within 2% past 4 lanes, 3% slower at 4 (K7, K1's f32
// store); K1 by 4-byte cp.async from the row-major features, without the
// transposing pre-pass, 15-31% slower past 4 lanes; the grid columns first
// (one group of tiles a block at 4 lanes) within 1% past 4 lanes, -1 to
// +3% at 4. At 4 lanes K7 without its stores takes 0.33 ms, without its
// exp 0.72-0.73: the store path itself sets it.
//
// Plain C interface, bound with ctypes (graphlap_tpu_torch/ops/_build.py).

#include "mma_common.cuh"

namespace {

constexpr int CS_R = 8;                 // rows a thread
constexpr int CS_C = 8;                 // columns a thread
constexpr int CS_TY = 16;               // threads along the rows
constexpr int CS_TX = 16;               // threads along the columns
constexpr int CS_THREADS = CS_TY * CS_TX;
constexpr int CS_BLOCKS_SM = 2;         // blocks an SM (launch bounds: registers)
constexpr int CS_FT = CS_TY * CS_R;     // rows a block
constexpr int CS_ST = CS_TX * CS_C;     // columns a tile
constexpr int CS_KC = 32;               // lanes a column stage holds at most
constexpr int CS_TPS = 4;               // column tiles a stage holds at most
constexpr int CS_STAGES = 2;
constexpr int CS_LMAX = 128;            // lanes read at most (the widest layout)
constexpr int CS_STAGE = (CS_KC + 2 * CS_TPS) * CS_ST;   // floats a stage: lanes, norms, scales
constexpr int CS_PAD = 128;             // K1's scratch rounds p and n up to it
static_assert(CS_R % 4 == 0 && CS_C % 4 == 0 && CS_TX == 16 && CS_TY == CS_THREADS / 16,
              "coord store: float4 groups, warps of 2 x 16 threads");

// the epilogues
constexpr int CS_BF16 = 0;     // K1, bf16 store
constexpr int CS_F32 = 1;      // K1, f32 store
constexpr int CS_SCALED = 2;   // K7, f32 layout: the column-scaled f32 entry

// dynamic shared memory at L lanes (bytes): the rows, the stages, the rows'
// norms
__host__ __device__ constexpr size_t cs_smem_bytes(int L) {
  return sizeof(float) * ((size_t)L * CS_FT + (size_t)CS_STAGES * CS_STAGE + CS_FT);
}
static_assert(cs_smem_bytes(CS_LMAX) + 1024 <= 233472 / CS_BLOCKS_SM,
              "coord store: the blocks an SM fit its shared memory");

// a block's walk over its split's column tiles: steps of tps tiles (a
// group) by nch lane chunks of at most kc lanes (as the coordinate K5/K6's
// walk); split y of the gridDim.y takes groups y, y + gridDim.y, ..., so
// the splits of a row block store neighbouring groups at once
struct CsWalk {
  int L, nch, kc, tps, ntile, steps;
  __device__ CsWalk(int lanes, int tiles) : L(lanes), ntile(tiles) {
    nch = (L + CS_KC - 1) / CS_KC;
    kc = (L + nch - 1) / nch;
    tps = nch > 1 ? 1 : min(CS_TPS, CS_KC / L);
    const int groups = (tiles + tps - 1) / tps, y = blockIdx.y, ys = gridDim.y;
    steps = (y < groups ? (groups - y + ys - 1) / ys : 0) * nch;
  }
  // step i's first tile, and its tiles
  __device__ int tile0(int i) const { return ((int)blockIdx.y + i / nch * (int)gridDim.y) * tps; }
  __device__ int tiles(int i) const { return min(tps, ntile - tile0(i)); }
};

// step i of the walk into stage i % CS_STAGES: the chunk's rows of the
// step's columns of the k-major st (row stride lds; row stride tps CS_ST in
// the stage; columns past lds zero), and with the last chunk their norms
// and (SCALED) scales; one cp.async commit group (empty past the walk)
template <bool SCALED>
__device__ __forceinline__ void cs_load_stage(float* stg, const float* __restrict__ st,
                                              const float* __restrict__ ns,
                                              const float* __restrict__ cs, int lds,
                                              const CsWalk& wk, int i) {
  if (i < wk.steps) {
    const int ch = i % wk.nch, k0 = ch * wk.kc, nk = min(wk.kc, wk.L - k0);
    const int rs = wk.tps * CS_ST, q4 = wk.tiles(i) * (CS_ST / 4);   // 16-byte chunks a row
    float* d = stg + (i % CS_STAGES) * CS_STAGE;
    const int c0 = wk.tile0(i) * CS_ST;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = threadIdx.x; c < nk * q4; c += CS_THREADS) {
      const int k = c / q4, q = c % q4;
      if (c0 + 4 * q < lds)
        cp_async16(d + k * rs + 4 * q, st + (size_t)(k0 + k) * lds + c0 + 4 * q);
      else
        *reinterpret_cast<float4*>(d + k * rs + 4 * q) = zero;
    }
    if (ch == wk.nch - 1)
      for (int q = threadIdx.x; q < q4; q += CS_THREADS) {
        float* dn = d + CS_KC * CS_ST + 4 * q;
        float* dc = dn + CS_TPS * CS_ST;
        if (c0 + 4 * q < lds) {
          cp_async16(dn, ns + c0 + 4 * q);
          if (SCALED) cp_async16(dc, cs + c0 + 4 * q);
        } else {
          *reinterpret_cast<float4*>(dn) = zero;
          if (SCALED) *reinterpret_cast<float4*>(dc) = zero;
        }
      }
  }
  cp_async_commit();
}

// the block's CS_FT rows from r0 of the row-major fx (row stride ldf, 16-byte
// aligned; rows past p zero) k-major over the L lanes into fx_s, and their
// norms into nf_s
__device__ __forceinline__ void cs_load_rows(float* fx_s, float* nf_s, const float* __restrict__ fx,
                                             const float* __restrict__ nf, int r0, int p, int ldf,
                                             int L) {
  for (int c = threadIdx.x; c < CS_FT * (L / 4); c += CS_THREADS) {
    const int r = c % CS_FT, q = c / CS_FT;
    const float4 v = r0 + r < p
                         ? *reinterpret_cast<const float4*>(fx + (size_t)(r0 + r) * ldf + 4 * q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = fx_s + (size_t)(4 * q) * CS_FT + r;
    d[0] = v.x, d[CS_FT] = v.y, d[2 * CS_FT] = v.z, d[3 * CS_FT] = v.w;
  }
  for (int r = threadIdx.x; r < CS_FT; r += CS_THREADS) nf_s[r] = r0 + r < p ? nf[r0 + r] : 0.f;
}

// one lane's products into a thread's crosses: its CS_R rows (two float4
// of a row of the staged rows at fa) by its CS_C columns (fb); START: a
// chain's first lane, its products alone (an FMA onto zero but for the sign
// of a zero cross, which moves no entry)
template <bool START>
__device__ __forceinline__ void cs_lane(float (&cr)[CS_R][CS_C], const float* fa,
                                        const float* fb) {
  float4 a[CS_R / 4], b[CS_C / 4];
#pragma unroll
  for (int g = 0; g < CS_R / 4; ++g) a[g] = *reinterpret_cast<const float4*>(fa + 4 * CS_TY * g);
#pragma unroll
  for (int g = 0; g < CS_C / 4; ++g) b[g] = *reinterpret_cast<const float4*>(fb + 4 * CS_TX * g);
#pragma unroll
  for (int r = 0; r < CS_R; ++r) {
    const float4 ar = a[r / 4];
    const float x = (r & 3) == 0 ? ar.x : (r & 3) == 1 ? ar.y : (r & 3) == 2 ? ar.z : ar.w;
#pragma unroll
    for (int c = 0; c < CS_C; ++c) {
      const float4 bc = b[c / 4];
      const float y = (c & 3) == 0 ? bc.x : (c & 3) == 1 ? bc.y : (c & 3) == 2 ? bc.z : bc.w;
      cr[r][c] = START ? x * y : fmaf(x, y, cr[r][c]);
    }
  }
}

// an entry from its row's norm, its column's, its cross and (K7) its
// column's scale
template <int EPI>
__device__ __forceinline__ float cs_entry(float na, float nb, float x, float sc) {
  if (EPI == CS_SCALED) return kf32(na + nb, x) * sc;
  const float d2 = fmaxf((na - x) + (nb - x), 0.f);
  return EPI == CS_BF16 ? kexp(d2) : expf(-d2);
}

// four consecutive entries from entry o of out (T: four bf16 packed in a
// uint2, or four f32 in a float4), streamed (evict-first)
template <typename T>
__device__ __forceinline__ void cs_put(void* out, size_t o, T v) {
  __stcs(reinterpret_cast<T*>(static_cast<char*>(out) + o * (sizeof(T) / 4)), v);
}

template <int EPI>
__global__ __launch_bounds__(CS_THREADS, CS_BLOCKS_SM) void coord_store_kernel(
    const float* __restrict__ fx,    // (p, ldf) row-major sample rows
    const float* __restrict__ st,    // (>= L, lds) k-major columns
    const float* __restrict__ nf,    // (p) the rows' norms (ext2_norms_kernel)
    const float* __restrict__ ns,    // (lds) and the columns'
    const float* __restrict__ cs,    // (lds) K7's column scales (else unused)
    void* __restrict__ out,          // (p, ld) row-major, bf16 (CS_BF16) or f32
    int p, int n, int ld, int ldf, int lds, int L) {
  extern __shared__ __align__(16) float cs_smem[];
  float* fx_s = cs_smem;                             // [L][CS_FT]
  float* stg = fx_s + (size_t)L * CS_FT;             // [CS_STAGES][CS_STAGE]
  float* nf_s = stg + CS_STAGES * CS_STAGE;          // [CS_FT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp is 2 x 16 threads: ty along the rows, tx the columns
  const int ty = warp * 2 + lane / 16, tx = lane % 16;
  const int r0 = blockIdx.x * CS_FT;
  const CsWalk wk(L, (lds + CS_ST - 1) / CS_ST);

  // the first column stages in flight, then the rows and their norms, once
  // for the walk
#pragma unroll
  for (int i = 0; i < CS_STAGES - 1; ++i)
    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, wk, i);
  cs_load_rows(fx_s, nf_s, fx, nf, r0, p, ldf, L);

  float cr[CS_R][CS_C];                 // a tile's crosses, over the chunks so far
  for (int i = 0; i < wk.steps; ++i) {
    const int ch = i % wk.nch, nt = wk.tiles(i);
    cp_async_wait_pending<CS_STAGES - 2>();
    __syncthreads();                    // step i in (the rows too); everyone done with i - 1
    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, wk, i + CS_STAGES - 1);
    const float* d = stg + (i % CS_STAGES) * CS_STAGE;
    const int rs = wk.tps * CS_ST, k0 = ch * wk.kc, nk = min(wk.kc, L - k0);
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      // the cross: each entry one FFMA chain over the lanes in order
      const float* fa = fx_s + (size_t)k0 * CS_FT + 4 * ty;
      const float* fb = d + j * CS_ST + 4 * tx;
      if (ch == 0) cs_lane<true>(cr, fa, fb);
#pragma unroll 2
      for (int k = ch == 0 ? 1 : 0; k < nk; ++k) cs_lane<false>(cr, fa + k * CS_FT, fb + k * rs);
      if (ch == wk.nch - 1) {           // tile j's entries, stored
        const float* nt_s = d + CS_KC * CS_ST + j * CS_ST;
        const float* sc_s = nt_s + CS_TPS * CS_ST;
        const int c0 = (wk.tile0(i) + j) * CS_ST;
#pragma unroll
        for (int g = 0; g < CS_C / 4; ++g) {
          const int col = c0 + 4 * tx + 4 * CS_TX * g;
          if (col >= n) continue;
          const float4 nb = *reinterpret_cast<const float4*>(nt_s + 4 * tx + 4 * CS_TX * g);
          const float4 sc = EPI == CS_SCALED
                                ? *reinterpret_cast<const float4*>(sc_s + 4 * tx + 4 * CS_TX * g)
                                : make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
          for (int r = 0; r < CS_R; ++r) {
            const int rl = 4 * ty + (r & 3) + 4 * CS_TY * (r >> 2);
            if (r0 + rl >= p) continue;
            const float na = nf_s[rl];
            const float v0 = cs_entry<EPI>(na, nb.x, cr[r][4 * g], sc.x);
            const float v1 = cs_entry<EPI>(na, nb.y, cr[r][4 * g + 1], sc.y);
            const float v2 = cs_entry<EPI>(na, nb.z, cr[r][4 * g + 2], sc.z);
            const float v3 = cs_entry<EPI>(na, nb.w, cr[r][4 * g + 3], sc.w);
            const size_t o = (size_t)(r0 + rl) * ld + col;
            if (EPI == CS_BF16)
              cs_put(out, o, make_uint2(pack2(v0, v1), pack2(v2, v3)));
            else
              cs_put(out, o, make_float4(v0, v1, v2, v3));
          }
        }
      }
    }
  }
  cp_async_wait_all();                  // (an empty split's walk waited for nothing)
}

// K1's pre-pass: the row-major a (p, d) and b (n, d) as the store tile reads
// them, over L = d rounded up to 4 lanes with the pad lanes zero: a_pad
// (p_pad, L) row-major (rows past p zero), b_t (L, n_pad) k-major (pixels
// past n zero). Blocks [0, n_pad / PK_PX) each transpose PK_PX pixels
// through shared memory (their span of b read contiguously); the rest fill
// a_pad
constexpr int PK_PX = 64;
constexpr int PK_THREADS = 256;
constexpr int PK_ROW_BLOCKS = 64;
__global__ __launch_bounds__(PK_THREADS) void coord_pack_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ a_pad,
    float* __restrict__ b_t, int p, int n, int d, int L, int p_pad, int n_pad) {
  __shared__ float px_s[CS_LMAX * (PK_PX + 1)];   // [lane][pixel]
  const int bblocks = n_pad / PK_PX;
  if ((int)blockIdx.x >= bblocks) {
    for (size_t i = (size_t)(blockIdx.x - bblocks) * PK_THREADS + threadIdx.x;
         i < (size_t)p_pad * L; i += (size_t)(gridDim.x - bblocks) * PK_THREADS) {
      const int r = (int)(i / L), k = (int)(i % L);
      a_pad[i] = r < p && k < d ? a[(size_t)r * d + k] : 0.f;
    }
    return;
  }
  const int c0 = blockIdx.x * PK_PX;
  const int span = max(0, min(PK_PX, n - c0)) * d;
  for (int i = threadIdx.x; i < span; i += PK_THREADS) {
    const int px = i / d;
    px_s[(i - px * d) * (PK_PX + 1) + px] = b[(size_t)c0 * d + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * PK_PX; i += PK_THREADS) {
    const int k = i / PK_PX, px = i % PK_PX;
    b_t[(size_t)k * n_pad + c0 + px] = k < d && c0 + px < n ? px_s[k * (PK_PX + 1) + px] : 0.f;
  }
}

__host__ __device__ constexpr int cs_round(int x, int q) { return (x + q - 1) / q * q; }

typedef void (*cs_fn)(const float*, const float*, const float*, const float*, const float*,
                      void*, int, int, int, int, int, int);

// the epilogue's kernel with its dynamic shared memory opted in for the
// widest L (past 48 KB it takes no other way)
cudaError_t cs_kernel(int epi, cs_fn* kernel) {
  *kernel = epi == CS_BF16 ? coord_store_kernel<CS_BF16>
            : epi == CS_F32 ? coord_store_kernel<CS_F32>
                            : coord_store_kernel<CS_SCALED>;
  return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)cs_smem_bytes(CS_LMAX));
}

// the store tile over p sample rows and the first n of lds columns: a grid
// of (p / CS_FT row blocks, splits)
int cs_launch(int epi, const float* fx, const float* st, const float* nf, const float* ns,
              const float* cs, void* out, int p, int n, int ld, int ldf, int lds, int L,
              int splits, cudaStream_t s) {
  cs_fn kernel;
  cudaError_t e = cs_kernel(epi, &kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((p + CS_FT - 1) / CS_FT, splits), CS_THREADS, cs_smem_bytes(L), s>>>(
      fx, st, nf, ns, cs, out, p, n, ld, ldf, lds, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// how many blocks of the store tile with epilogue epi (0: K1 bf16 store, 1:
// K1 f32 store, 2: K7 f32) at L lanes (1 to 128) fit the card at once (the
// wrapper plans the column splits from it); a negative value is a
// cudaError, 0 an unsupported L or epi
int glt_coord_store_slots(int epi, int L) {
  if (L < 1 || L > CS_LMAX || epi < 0 || epi > 2) return 0;
  cs_fn kernel;
  cudaError_t e = cs_kernel(epi, &kernel);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, CS_THREADS, cs_smem_bytes(L));
  return e != cudaSuccess ? -static_cast<int>(e) : occ * sms;
}

// K1 on coordinate features (the IEEE f32 cross). a (p, d) and b (n, d)
// row-major f32, 1 <= d <= 128; out (p, ld) bf16 (out_bf16) or f32, ld >= n
// a multiple of 4 (the wrapper pads rows to 256 bytes), 16-byte aligned;
// scratch 16-byte aligned, p_pad L + L n_pad + p_pad + n_pad floats (L = d
// rounded up to 4, p_pad and n_pad p and n rounded up to 128): the pre-pass's
// a_pad and b_t, then their norms. splits >= 1 column splits of the store
// tile's grid.
int glt_affinity_coord(const void* a, const void* b, void* scratch, void* out, int p, int n,
                       int d, int ld, int out_bf16, int splits, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p < 1 || n < 1 || d < 1 || d > CS_LMAX || ld < n || ld % 4 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = cs_round(d, 4), p_pad = cs_round(p, CS_PAD), n_pad = cs_round(n, CS_PAD);
  float* a_pad = static_cast<float*>(scratch);
  float* b_t = a_pad + (size_t)p_pad * L;
  float* nrm = b_t + (size_t)L * n_pad;
  coord_pack_kernel<<<n_pad / PK_PX + PK_ROW_BLOCKS, PK_THREADS, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), a_pad, b_t, p, n, d, L, p_pad,
      n_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ext2_norms_kernel<<<(p_pad + n_pad + 255) / 256, 256, 0, s>>>(a_pad, b_t, nrm, p_pad, n_pad,
                                                                 L, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return cs_launch(out_bf16 ? CS_BF16 : CS_F32, a_pad, b_t, nrm, nrm + p_pad, nullptr, out, p,
                   n, ld, L, n_pad, L, splits, s);
}

// K7, f32 layout of fd lanes (32, 64, 96 or 128): fa (P, fd) row-major, ft
// (fd, S) k-major, cols (S), out (P, S) f32. P % 32 == 0, S % 128 == 0,
// live % 4 == 0 in [4, fd] (the lanes read), 16-byte aligned bases (the
// wrapper checks); norms P + S floats of scratch. The norms' pre-pass, then
// the store tile over (P / 128 row blocks, splits).
int glt_kb_strip_f32(const void* fa, const void* ft, const void* cols, void* norms, void* out,
                     int P, int S, int live, int fd, int splits, void* stream) {
  if (P < 32 || S < 128 || P % 32 || S % 128 ||
      (fd != 32 && fd != 64 && fd != 96 && fd != 128) || live < 4 || live > fd || live % 4 ||
      splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(fa);
  const float* b = static_cast<const float*>(ft);
  float* nrm = static_cast<float*>(norms);
  ext2_norms_kernel<<<(P + S + 255) / 256, 256, 0, s>>>(a, b, nrm, P, S, fd, live);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return cs_launch(CS_SCALED, a, b, nrm, nrm + P, static_cast<const float*>(cols), out, P, S, S,
                   fd, S, live, splits, s);
}

}  // extern "C"
