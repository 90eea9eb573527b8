"""K1's coordinate cross and the f32 K7 (csrc/coord_store.cu
coord_store_kernel: one register-tiled IEEE f32 FFMA store kernel over the
live lanes) as shipped and in other designs, at the paths' shapes, on one
CUDA card.

    python3 scripts/coord_store_designs.py [--only NAMES] [--lanes L,...]
                                           [--cases NAMES] [--reps N]
                                           [--parent DIR] [--out FILE] [--dry]

Variants, each a copy of coord_store.cu with its constants or a loader
edited, built alone under build/coord_store_designs/<variant>/ (one nvcc a
variant, all at once; its registers and spills printed from -Xptxas -v)
and put in front of the package's library while it runs
(scripts/finish_repairs.Overlay):

* ``shipped`` — 256 threads of 8 rows x 8 columns, 128-row blocks, 128-column
  tiles in stages of at most 32 lanes (up to 4 tiles a stage), two blocks
  an SM, the column splits strided over the tiles, warps of 2 x 16
  threads (a store: 2 rows of 64 consecutive entries), the norms by a
  pre-pass, K1's features laid out by a transposing pre-pass;
* ``warps 4x8`` — as shipped with warps of 4 x 8 threads (a store: 4 rows
  of 32);
* ``row exchange`` — as shipped, the warp's two halves swapping 64 entries
  a row index by shuffles, so a store writes one row's 128;
* ``warps 1x32`` — a warp of 1 x 32 threads (a store: one row of 128),
  blocks of 8 x 32 threads, 64 rows by 256-column tiles;
* ``contiguous splits`` — as shipped, each column split a contiguous range
  of the tiles (the shipped walk deals the splits every gridDim.y-th group
  of tiles, so a row block's splits store neighbouring columns at once);
* ``8x16`` — 8 x 16 entries a thread (256-column tiles, warps of 4 x 8),
  one block an SM (its 128 crosses take past 128 registers);
* ``8x4`` — 8 x 4 entries a thread (64-column tiles, warps of 4 x 8), three
  blocks an SM where shared memory allows (at most 85 registers);
* ``one block`` — as shipped, one block an SM (up to 255 registers);
* ``one tile a stage`` — as shipped, one column tile a stage at every
  lane count (at 4 lanes: four);
* ``plain stores`` — as shipped, the stores without the evict-first hint;
* ``cp.async 4`` — K1 only: no transposing pre-pass; the pixels stream
  from their row-major (n, d) layout by 4-byte cp.async, the rows load by
  scalar loads, the norms by the same pre-pass on the row-major features.
* ``columns first`` — as shipped with the grid's blocks (splits, row
  blocks), x fastest, and at 4 lanes one group of 4 tiles a block: the
  blocks in flight store a few row blocks' whole rows, as the kernel it
  replaced did (past 4 lanes the blocks of a row block no longer share a
  column tile's reads from L2);
* ``no stores``, ``no exp``, ``no pre-pass`` (timing only) — as shipped
  without its stores (one that never happens keeps the entries live),
  without the exp (the entry d2, times K7's scale), or without K7's norms
  pre-pass: what each costs. Their outputs are wrong and not checked.

With ``--parent DIR`` (another checkout, e.g. the parent commit unpacked
with ``git archive``), that checkout's wrappers run in a child process
through its own package and library on the same inputs: the kernels this
one replaced, timed in turns (parent, designs, designs reversed, parent).

Cases (``--cases``), each at the lanes of ``--lanes`` it runs at:
``k1_bf16`` K1 with the bf16 store at recipe A's 5248 x 262144;
``k1_f32`` K1 with the f32 store at the dense route's K_AB, 5243 x 256901
(rows of 256901 padded to 256 bytes); ``k1_4`` K1 at config 1 fast's 2688
x 262144 (bf16, 4 lanes only); ``k7`` the f32 K7 at the gram shape 4096 x
131072. The features are made on the card from a seed as the bilateral
recipes build them: d - 2 value lanes in [0, 5), then row / 8 and col / 8
of a 2048 x 4096 image; the pixels a random sample row's features moved by
up to 0.5 / sqrt(d - 2) a value lane and 32 px (d = 3, 27, 51, 83, 123 for
4, 28, 52, 84, 124 lanes). For each case, width and design: the time
(CUDA events over the wrapper, chip_smoke.cuda_ms), on the first turn
whether its output equals the shipped design's bit for bit and repeats
bit for bit, and the bound (the cross's 2 L flop an entry at 67 TFLOP/s,
or the output's bytes at 3.35 TB/s); on the shipped design's second turn
at 124 lanes, the card's SM clock and power draw while it runs
(nvidia-smi every 50 ms). --dry writes the variant sources and checks the
edits without a card. Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
OUT = ROOT / "build" / "coord_store_designs"
sys.path.insert(0, str(Path(__file__).resolve().parent))
import coord_matvec_designs as cmd  # noqa: E402  (sampled, load_chip_smoke)

D_OF = {4: 3, 28: 27, 52: 51, 84: 83, 124: 123}
# name -> (p, n, store or "k7", lanes it runs at (None: all of --lanes))
CASES = {
    "k1_bf16": (5248, 1 << 18, torch.bfloat16, None),
    "k1_f32": (5243, 256901, torch.float32, None),
    "k1_4": (2688, 1 << 18, torch.bfloat16, (4,)),
    "k7": (4096, 1 << 17, "k7", None),
}

_CP4 = '''__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

'''
# K1 without the transposing pre-pass: the pixels by 4-byte cp.async from
# their row-major layout (row stride ldf = d; lanes past d and pixels past
# lds = n zero), the rows by scalar loads, the norms from the row-major
# features
_NO_PACK = [
    ("// step i of the walk into stage i % CS_STAGES", _CP4 + "// step i of the walk into stage i % CS_STAGES"),
    ("""                                              const float* __restrict__ cs, int lds,
                                              const CsWalk& wk, int i) {""",
     """                                              const float* __restrict__ cs, int lds,
                                              int ldf, const CsWalk& wk, int i) {"""),
    ("""    for (int c = threadIdx.x; c < nk * q4; c += CS_THREADS) {
      const int k = c / q4, q = c % q4;
      if (c0 + 4 * q < lds)""",
     """    if (!SCALED) {
      const int qn = wk.tiles(i) * CS_ST;
      for (int c = threadIdx.x; c < nk * qn; c += CS_THREADS) {
        const int k = c / qn, q = c % qn;
        if (c0 + q < lds && k0 + k < ldf)
          cp_async4(d + k * rs + q, st + (size_t)(c0 + q) * ldf + k0 + k);
        else
          d[k * rs + q] = 0.f;
      }
    } else
    for (int c = threadIdx.x; c < nk * q4; c += CS_THREADS) {
      const int k = c / q4, q = c % q4;
      if (c0 + 4 * q < lds)"""),
    ("""  for (int c = threadIdx.x; c < CS_FT * (L / 4); c += CS_THREADS) {
    const int r = c % CS_FT, q = c / CS_FT;
    const float4 v = r0 + r < p
                         ? *reinterpret_cast<const float4*>(fx + (size_t)(r0 + r) * ldf + 4 * q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = fx_s + (size_t)(4 * q) * CS_FT + r;
    d[0] = v.x, d[CS_FT] = v.y, d[2 * CS_FT] = v.z, d[3 * CS_FT] = v.w;
  }""",
     """  for (int c = threadIdx.x; c < CS_FT * L; c += CS_THREADS) {
    const int r = c % CS_FT, k = c / CS_FT;
    fx_s[(size_t)k * CS_FT + r] = r0 + r < p && k < ldf ? fx[(size_t)(r0 + r) * ldf + k] : 0.f;
  }"""),
    ("    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, wk, i);",
     "    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, ldf, wk, i);"),
    ("    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, wk, i + CS_STAGES - 1);",
     "    cs_load_stage<EPI == CS_SCALED>(stg, st, ns, cs, lds, ldf, wk, i + CS_STAGES - 1);"),
    ("""  float* a_pad = static_cast<float*>(scratch);
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
                   n, ld, L, n_pad, L, splits, s);""",
     """  (void)n_pad;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* nrm = static_cast<float*>(scratch);
  ext2_norms_kernel<<<(p + 255) / 256, 256, 0, s>>>(af, nullptr, nrm, p, 0, d, d);
  ext2_norms_kernel<<<(n + 255) / 256, 256, 0, s>>>(bf, nullptr, nrm + p_pad, n, 0, d, d);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return cs_launch(out_bf16 ? CS_BF16 : CS_F32, af, bf, nrm, nrm + p_pad, nullptr, out, p, n, ld,
                   d, n, L, splits, s);"""),
]
_BLOCKS1 = ("constexpr int CS_BLOCKS_SM = 2;", "constexpr int CS_BLOCKS_SM = 1;")
# each split a contiguous range of the column tiles
_CONTIGUOUS = ("""  int L, nch, kc, tps, ntile, steps;
  __device__ CsWalk(int lanes, int tiles) : L(lanes), ntile(tiles) {
    nch = (L + CS_KC - 1) / CS_KC;
    kc = (L + nch - 1) / nch;
    tps = nch > 1 ? 1 : min(CS_TPS, CS_KC / L);
    const int groups = (tiles + tps - 1) / tps, y = blockIdx.y, ys = gridDim.y;
    steps = (y < groups ? (groups - y + ys - 1) / ys : 0) * nch;
  }
  // step i's first tile, and its tiles
  __device__ int tile0(int i) const { return ((int)blockIdx.y + i / nch * (int)gridDim.y) * tps; }
  __device__ int tiles(int i) const { return min(tps, ntile - tile0(i)); }""",
               """  int L, nch, kc, tps, t0, ntile, steps;
  __device__ CsWalk(int lanes, int tiles) : L(lanes) {
    nch = (L + CS_KC - 1) / CS_KC;
    kc = (L + nch - 1) / nch;
    tps = nch > 1 ? 1 : min(CS_TPS, CS_KC / L);
    const int per = (tiles + gridDim.y - 1) / gridDim.y;
    t0 = blockIdx.y * per;
    ntile = max(0, min(tiles, t0 + per) - t0);
    steps = (ntile + tps - 1) / tps * nch;
  }
  __device__ int tile0(int i) const { return t0 + i / nch * tps; }
  __device__ int tiles(int i) const { return min(tps, ntile - i / nch * tps); }""")
_MAPPING = """  const int ty = warp * 2 + lane / 16, tx = lane % 16;"""
_ASSERT = ("""static_assert(CS_R % 4 == 0 && CS_C % 4 == 0 && CS_TX == 16 && CS_TY == CS_THREADS / 16,""",
           """static_assert(CS_R % 4 == 0 && CS_C % 4 == 0 && CS_TY % 4 == 0 && CS_TX % 8 == 0,""")
# warps of 4 x 8 threads (a store: 4 rows of 32 consecutive entries)
_WARP4x8 = [_ASSERT, (_MAPPING, """  const int ty = (warp / (CS_TX / 8)) * 4 + lane / 8;
  const int tx = (warp % (CS_TX / 8)) * 8 + lane % 8;""")]
# a warp 1 x 32 threads (a store: one row of 128 consecutive entries):
# blocks of 8 x 32 threads, 64 rows by 256-column tiles
_WARP1x32 = [_ASSERT, ("constexpr int CS_TY = 16;", "constexpr int CS_TY = 8; "),
             ("constexpr int CS_TX = 16;", "constexpr int CS_TX = 32;"),
             (_MAPPING, "  const int ty = warp, tx = lane;")]
# the warp's halves swap 64 entries a row index by shuffles, so a store
# writes one row's 128 consecutive entries
_EXCHANGE = [(_MAPPING, _MAPPING + "\n  const bool hi = lane >= 16;"),
             ("""        const int c0 = (wk.tile0(i) + j) * CS_ST;
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
        }""",
              """        const int c = (wk.tile0(i) + j) * CS_ST + 4 * tx;
        float4 nb[2], sc[2];
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          nb[g] = *reinterpret_cast<const float4*>(nt_s + 4 * tx + 4 * CS_TX * g);
          sc[g] = EPI == CS_SCALED
                      ? *reinterpret_cast<const float4*>(sc_s + 4 * tx + 4 * CS_TX * g)
                      : make_float4(1.f, 1.f, 1.f, 1.f);
        }
#pragma unroll
        for (int r = 0; r < CS_R; ++r) {
          const int rl = 4 * ty + (r & 3) + 4 * CS_TY * (r >> 2);
          const float na = nf_s[rl];
          float v[2][4];
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            v[g][0] = cs_entry<EPI>(na, nb[g].x, cr[r][4 * g], sc[g].x);
            v[g][1] = cs_entry<EPI>(na, nb[g].y, cr[r][4 * g + 1], sc[g].y);
            v[g][2] = cs_entry<EPI>(na, nb[g].z, cr[r][4 * g + 2], sc[g].z);
            v[g][3] = cs_entry<EPI>(na, nb[g].w, cr[r][4 * g + 3], sc[g].w);
          }
          if (EPI == CS_BF16) {
            const uint2 e[2] = {make_uint2(pack2(v[0][0], v[0][1]), pack2(v[0][2], v[0][3])),
                                make_uint2(pack2(v[1][0], v[1][1]), pack2(v[1][2], v[1][3]))};
            cs_store_row(out, e, r0 + rl, c, p, n, ld, hi);
          } else {
            const float4 e[2] = {make_float4(v[0][0], v[0][1], v[0][2], v[0][3]),
                                 make_float4(v[1][0], v[1][1], v[1][2], v[1][3])};
            cs_store_row(out, e, r0 + rl, c, p, n, ld, hi);
          }
        }"""),
             ("template <int EPI>\n__global__ __launch_bounds__",
              """__device__ __forceinline__ uint2 shfl16(uint2 v) {
  return make_uint2(__shfl_xor_sync(0xffffffffu, v.x, 16), __shfl_xor_sync(0xffffffffu, v.y, 16));
}

__device__ __forceinline__ float4 shfl16(float4 v) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, 16), __shfl_xor_sync(0xffffffffu, v.y, 16),
                     __shfl_xor_sync(0xffffffffu, v.z, 16), __shfl_xor_sync(0xffffffffu, v.w, 16));
}

// lanes 0-15 hold row ra, lanes 16-31 (hi) row ra + 4: lane l < 16 gives
// its columns c + 4 CS_TX.. to lane l + 16 for that lane's columns c..
template <typename T>
__device__ __forceinline__ void cs_store_row(void* out, const T (&e)[2], int row, int c, int p,
                                             int n, int ld, bool hi) {
  const T got = shfl16(hi ? e[0] : e[1]);
  const int ra = hi ? row - 4 : row, col = hi ? c + 4 * CS_TX : c;
  if (col < n) {
    if (ra < p) cs_put(out, (size_t)ra * ld + col, hi ? got : e[0]);
    if (ra + 4 < p) cs_put(out, (size_t)(ra + 4) * ld + col, hi ? e[1] : got);
  }
}

template <int EPI>
__global__ __launch_bounds__""")]
# 8 x 4 entries a thread (64-column tiles), three blocks an SM where shared
# memory allows (at most 85 registers)
_C4 = [("constexpr int CS_C = 8; ", "constexpr int CS_C = 4; "),
       ("constexpr int CS_BLOCKS_SM = 2;", "constexpr int CS_BLOCKS_SM = 3;"),
       ("static_assert(cs_smem_bytes(CS_LMAX) + 1024 <= 233472 / CS_BLOCKS_SM,",
        "static_assert(cs_smem_bytes(CS_LMAX) + 1024 <= 233472 / 2,")]
_PUT = "  __stcs(reinterpret_cast<T*>(static_cast<char*>(out) + o * (sizeof(T) / 4)), v);"
# the stores without the streaming (evict-first) hint
_PLAIN_ST = (_PUT, "  *reinterpret_cast<T*>(static_cast<char*>(out) + o * (sizeof(T) / 4)) = v;")
# timing only: no store (one that never happens keeps the entries live), no
# exp in the entry, no norms' pre-pass for K7
_NO_STORES = (_PUT, "  if (*reinterpret_cast<const unsigned*>(&v) == 0x7fc01234u)\n" + _PUT)
_NO_EXP = ("""  if (EPI == CS_SCALED) return kf32(na + nb, x) * sc;
  const float d2 = fmaxf((na - x) + (nb - x), 0.f);
  return EPI == CS_BF16 ? kexp(d2) : expf(-d2);""",
           """  if (EPI == CS_SCALED) return d2f32(na + nb, x) * sc;
  return fmaxf((na - x) + (nb - x), 0.f);""")
_NO_PREPASS = ("""  ext2_norms_kernel<<<(P + S + 255) / 256, 256, 0, s>>>(a, b, nrm, P, S, fd, live);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
""", "")
# the grid columns first: blocks (splits, row blocks), x fastest, and at
# 4 lanes one group of tiles a block, so the blocks in flight store a few
# row blocks' whole rows (the kernel it replaced ran so)
_COLS_FIRST = [
    ("const int groups = (tiles + tps - 1) / tps, y = blockIdx.y, ys = gridDim.y;",
     "const int groups = (tiles + tps - 1) / tps, y = blockIdx.x, ys = gridDim.x;"),
    ("  __device__ int tile0(int i) const { return ((int)blockIdx.y + i / nch * (int)gridDim.y) * tps; }",
     "  __device__ int tile0(int i) const { return ((int)blockIdx.x + i / nch * (int)gridDim.x) * tps; }"),
    ("  const int r0 = blockIdx.x * CS_FT;", "  const int r0 = blockIdx.y * CS_FT;"),
    ("  kernel<<<dim3((p + CS_FT - 1) / CS_FT, splits), CS_THREADS, cs_smem_bytes(L), s>>>(",
     "  if (L <= 4) splits = (lds + 4 * CS_ST - 1) / (4 * CS_ST);\n"
     "  kernel<<<dim3(splits, (p + CS_FT - 1) / CS_FT), CS_THREADS, cs_smem_bytes(L), s>>>("),
]
# name -> (source edits, cases it runs in (None: all), what)
VARIANTS = {
    "shipped": ([], None, "256 threads of 8 x 8 entries, 128 x 128 tiles, stages of <= 32 lanes "
                          "(up to 4 tiles), two blocks an SM, strided column splits, warps of 2 "
                          "x 16 threads (a store: 2 rows of 64), norms and K1's layout by "
                          "pre-passes"),
    "warps 4x8": (_WARP4x8, None, "as shipped, warps of 4 x 8 threads: a store 4 rows of 32"),
    "row exchange": (_EXCHANGE, None, "as shipped, the warp's halves swapping 64 entries a row "
                                      "index by shuffles: a store one row of 128"),
    "warps 1x32": (_WARP1x32, None, "a warp 1 x 32 threads, a store one row of 128: blocks of "
                                    "8 x 32 threads, 64 rows by 256 columns"),
    "contiguous splits": ([_CONTIGUOUS], None,
                          "as shipped, each column split a contiguous range of the tiles"),
    "8x16": ([("constexpr int CS_C = 8; ", "constexpr int CS_C = 16;"), _BLOCKS1], None,
             "8 x 16 entries a thread (256-column tiles), one block an SM"),
    "8x4": (_C4, None, "8 x 4 entries a thread (64-column tiles), three blocks an SM where "
                       "shared memory allows"),
    "one block": ([_BLOCKS1], None, "as shipped, one block an SM (up to 255 registers)"),
    "one tile a stage": ([("constexpr int CS_TPS = 4;", "constexpr int CS_TPS = 1;")], None,
                         "as shipped, one column tile a stage at every lane count"),
    "plain stores": ([_PLAIN_ST], None, "as shipped, the stores without the evict-first hint"),
    "cp.async 4": (_NO_PACK, ("k1_bf16", "k1_f32", "k1_4"),
                   "K1 without the transposing pre-pass: the pixels by 4-byte cp.async from "
                   "their row-major layout, the rows by scalar loads"),
    "columns first": (_COLS_FIRST, None, "as shipped, the grid columns first (blocks of a row "
                                         "block in flight together), one group a block at 4 "
                                         "lanes"),
    "no stores (timing only)": ([_NO_STORES], None, "as shipped without its stores"),
    "no exp (timing only)": ([_NO_EXP], None, "as shipped, the entry d2 (times K7's scale): "
                                              "no exp"),
    "no pre-pass (timing only)": ([_NO_PREPASS], ("k7",), "as shipped without K7's norms "
                                                          "pre-pass (its norms unset)"),
}


def variant_sources(out: Path, only=None) -> dict:
    """{variant: its coord_store.cu} under ``out``; exits naming the first
    edit that does not match its source exactly once."""
    src = (CSRC / "coord_store.cu").read_text()
    files = {}
    for name, (edits, _, _) in VARIANTS.items():
        if only and name not in only:
            continue
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"coord_store_designs: {name}: an edit does not match once:\n{old}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_").replace(".", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "coord_store.cu").write_text(text)
        files[name] = d / "coord_store.cu"
    return files


def inputs(case: str, lanes: int, dev):
    """The seeded inputs of a case at ``lanes`` lanes: K1's (a (p, d), b
    (n, d)) row-major features, or K7's (fa (p, fd), f_t (fd, n), cols)."""
    p, n, store, _ = CASES[case]
    d = D_OF[lanes]
    rows = min(p, 4000) if store == "k7" else p
    g = torch.Generator(device=dev).manual_seed(1000 * lanes + p)
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    a = torch.empty((rows, d), device=dev)
    a[:, :d - 2] = rnd(rows, d - 2) * 5
    a[:, d - 2] = torch.floor(rnd(rows) * 2048) / 8.0
    a[:, d - 1] = torch.floor(rnd(rows) * 4096) / 8.0
    b = a[torch.floor(rnd(n) * rows).long()]
    b[:, :d - 2] += (2 * rnd(n, d - 2) - 1) * (0.5 / (d - 2) ** 0.5)
    b[:, d - 2:] += torch.floor(rnd(n, 2) * 65 - 32) / 8.0
    if store != "k7":
        return a, b
    fd = -(-d // 32) * 32
    fa = torch.zeros((p, fd), device=dev)
    fa[:rows, :d] = a
    f_t = torch.zeros((fd, n), device=dev)
    f_t[:d] = b.T
    return fa, f_t, 0.5 + rnd(n)


def call(case: str, lanes: int, x):
    """The case's launch through the imported package's wrapper."""
    from graphlap_tpu_torch.ops import cuda_affinity as k1
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    store = CASES[case][2]
    if store == "k7":
        return lambda: k79.kb_strip_cuda(*x, False, lanes)
    return lambda: k1.affinity_strip_cuda(*x, torch.float32, store, True)


def bound_ms(case: str, lanes: int) -> float:
    """The larger of the cross (2 L flop an entry at the f32 peak) and the
    bytes (inputs read once, the output written once) over 3.35 TB/s."""
    p, n, store, _ = CASES[case]
    d = D_OF[lanes]
    if store == "k7":
        nbytes = 4 * (p * n + (p + n) * (-(-d // 32) * 32) + n)
    else:
        nbytes = store.itemsize * p * n + 4 * (p + n) * d
    return 1e3 * max(2.0 * lanes * p * n / 67e12, nbytes / 3.35e12)


def build(files: dict, bld, fr, cs):
    """({variant: fr.Overlay}, {variant: the kernel's register and spill
    lines}): one nvcc a variant, all started together."""
    nvcc = bld._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *bld.NVCC_FLAGS, "-shared", "-o", str(f.with_suffix(".so")), str(f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, f in files.items()}
    base = bld.lib()
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"coord_store_designs: {name}: nvcc failed:\n{log[-4000:]}")
        libs[name] = fr.Overlay(ctypes.CDLL(str(files[name].with_suffix(".so"))), base, bld)
        ptxas[name] = [f"{kn[:40]}: {ln.strip()}" for kn, ln in cs.ptxas_lines(log)
                       if "coord_store_kernel" in kn and ("Used" in ln or "spill" in ln)]
    return libs, ptxas


def plan(cases, lanes):
    """[(case, lanes)] in run order."""
    return [(c, lv) for c in cases for lv in lanes
            if CASES[c][3] is None or lv in CASES[c][3]]


def child(root: str, cases, lanes, reps: int) -> None:
    """Time another checkout's wrappers (its package first on the path)."""
    sys.path.insert(0, root)
    cs = cmd.load_chip_smoke()
    dev = torch.device("cuda", 0)
    from graphlap_tpu_torch.ops import _build
    _build.lib()
    got = {}
    for case, lv in plan(cases, lanes):
        x = inputs(case, lv, dev)
        got[f"{case} {lv}"] = cs.cuda_ms(call(case, lv, x), reps)
        del x
        torch.cuda.empty_cache()
    print("CHILD " + json.dumps(got), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--lanes", default="124,84,52,28,4")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    lanes = [int(x) for x in args.lanes.split(",")]
    cases = [c for c in args.cases.split(",") if c]
    if args.child:
        child(args.child, cases, lanes, args.reps)
        return
    only = [s.strip() for s in args.only.split(",") if s.strip()] or None
    files = variant_sources(OUT, only)
    if args.dry:
        print(f"coord_store_designs: {len(files)} variant sources under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("coord_store_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    cs = cmd.load_chip_smoke()
    spec = importlib.util.spec_from_file_location("finish_repairs",
                                                  ROOT / "scripts" / "finish_repairs.py")
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    from graphlap_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs, ptxas = build(files, _build, fr, cs)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, lines in ptxas.items():
        print(f"ptxas [{name}]: {lines}", flush=True)

    def parent_turn():
        if not args.parent:
            return None
        proc = subprocess.run([sys.executable, __file__, "--child", str(Path(args.parent).resolve()),
                               "--cases", args.cases, "--lanes", args.lanes,
                               "--reps", str(args.reps)], capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD ")]
        if proc.returncode or not line:
            sys.exit(f"coord_store_designs: the parent's turn failed:\n{proc.stderr[-3000:]}")
        got = json.loads(line[0][6:])
        print(f"parent: {got}", flush=True)
        return got

    rows = {}
    parents = [parent_turn()]
    saved = _build._LIB
    try:
        for case, lv in plan(cases, lanes):
            key = f"{case} {lv}"
            row = rows[key] = dict(bound_ms=bound_ms(case, lv), designs={})
            x = inputs(case, lv, dev)
            fn = call(case, lv, x)
            names = [n for n in libs if VARIANTS[n][1] is None or case in VARIANTS[n][1]]
            ref = None
            for rep in range(2):
                for name in (names if rep == 0 else names[::-1]):
                    _build._LIB = libs[name]
                    rec = row["designs"].setdefault(name, dict(what=VARIANTS[name][2], ms=[]))
                    if rep == 0 and not name.endswith("(timing only)"):
                        rec["slots"] = _build.lib().glt_coord_store_slots(
                            2 if CASES[case][2] == "k7" else
                            int(CASES[case][2] == torch.float32), lv)
                        got, again = fn(), fn()
                        rec["repeat_bits"] = bool(torch.equal(got, again))
                        if name == "shipped":
                            ref = got.clone()
                        elif ref is not None:
                            rec["shipped_bits"] = bool(torch.equal(got, ref))
                        del got, again
                    if rep == 1 and name == "shipped" and lv == 124:
                        ms, rec["card_while_timed"] = cmd.sampled(lambda: cs.cuda_ms(fn, args.reps))
                        rec["ms"].append(ms)
                    else:
                        rec["ms"].append(cs.cuda_ms(fn, args.reps))
                    print(f"{key} [{name}]: {json.dumps(rec)}", flush=True)
            del x, fn, ref
            torch.cuda.empty_cache()
    finally:
        _build._LIB = saved
    parents.append(parent_turn())
    for key in rows:
        if parents[0] is not None:
            rows[key]["parent_ms"] = [x[key] for x in parents]
    out = dict(card=card, cases={c: CASES[c][:2] for c in cases}, ptxas=ptxas, rows=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
