"""K5/K6 in the bf16 aug layout (csrc/recompute_matvec.cu) in the designs its
source notes compare, for the graphlap_tpu_torch of any checkout: time at
config 3's and the staged config 4's shapes, and error against the plain
version.

    python3 scripts/matvec_designs.py [--repo DIR] [--only NAME,...]
                                      [--reps N] [--out FILE] [--dry]

The script copies the checkout's csrc/recompute_matvec.cu and its header into
build/matvec_designs/<checkout>/<variant>/, rewrites the text a variant
changes, builds each copy alone with the checkout's nvcc flags (all copies
at once, one nvcc each) and loads it in place of the checkout's kernel
library, so the checkout's own wrappers (matvec_cuda, rmatvec_cuda) and
launch plan drive it (a variant with its own work-item and stage sizes sets
them in the wrapper's plan while it runs). A variant applies where each of
its edits matches the checkout's source exactly once; the others are listed
as not applying: the first port's kernel (PR 3 to PR 8, an IEEE expf an
entry) and the table kernel have different variants, and ``no loads``,
``16x2``, ``12x1`` and ``2 stages`` edit the table kernel as it was before
its template on the feature depth (run them with ``--repo`` on such a
checkout). Variants:

* every checkout: ``shipped``, ``no w`` (timing only: the w product
  dropped, the entries folded by XOR);
* the first port: ``first no exp`` (timing only: the entry is bf16(d2)'s
  bits), ``first no loads`` (timing only: the first tile stays in
  shared memory), ``first k8 table`` (the entry from K8's 128 KB table of
  all 65536 patterns, one copy: one block an SM);
* the table kernel (mma.sync, 16 consumer warps of 64 rows, one 128 KB
  table of all 65536 patterns): ``no lookup`` (timing only: the entry is
  bf16(max(d2, 0))'s bits), ``signed`` (the pair rounded without relu, the
  high pattern's address masked), ``no loads`` (timing only: stages
  completed without copies); copies of the 1979 live patterns only,
  bf16(d2) clamped to them by two bf16x2 min/max a pair: ``16 copies`` (a
  4-byte slot each, lanes l and l + 16 share a bank), ``32 copies`` (one a
  bank, two patterns a word, the half picked by a byte permute), ``1
  copy`` (2-byte entries); ``kexp`` (one FMUL and one MUFU ex2 an entry,
  K10's exp: chip_smoke.py counts the patterns where it differs from the
  table), ``16x2`` and ``12x1`` (16 warps of 32 rows, 12 of 16), ``2
  stages`` (the ring's depth; 8 stages do not fit beside the table),
  ``unroll 1`` and ``unroll 4`` (the column loop; 2 shipped), ``unpacked``
  (each entry its own A-fragment register, two w-product mma a block);
* the wgmma design, dropped: ``wgmma`` (three consumer warpgroups of one
  m64 tile each, d2 by wgmma from a TMA ring, the w product by mma.sync),
  ``wgmma no d2`` (timing only: d2 once an item, its entries looked up at
  every stage: the entry path alone), ``wgmma no lookup``.

Shapes: config 3's channel 0 (chip_smoke.make_workload_cfg3: p_pad 4096, N
1048576) and config 4 at 8 MP (chip_smoke.make_workload_8mp: N 8388608, the
staged schedule's polish), the vectors as chip_smoke.matvec_cases makes
them; with ``--patch 7`` both at an NLM 7 x 7 patch, the 64-lane kernel
(variant ``d64 4x128``: 4 ring stages of 128 streamed entries, in place of
the shipped 2 of 256); with ``--patch 9`` or ``11`` at 9 x 9 or 11 x 11,
the 96- or 128-lane kernel (variants ``wide table``: the entry table at
128 lanes too, beside 2 stages of 128 streamed entries; ``wide no
table``: kb_pair's entries at 96 lanes too, no table, 4 stages of 256;
``d96 3x128``: 3 stages of 128 beside the table at 96 lanes). At every
patch ``mma w``: the w product by mma (B column 0 = bf16(w)) in place of
the FP32 pipe, the earlier design up to 64 lanes. Times are
CUDA-event means (chip_smoke.cuda_ms); each variant runs --reps times in
turn (default 2). The error is the largest |kernel - plain|
over max |plain| at config 3 (meaningless for the timing-only variants).
--dry writes the variant sources here and checks the edits without a card.
Prints the card line and one JSON line; --out writes the JSON.

To time a parent and a change in turns on one card: unpack the parent with
``git archive`` into a git-ignored directory and run, in one command,
``--repo <parent> --only shipped``, ``--only shipped``, ``--only shipped``,
``--repo <parent> --only shipped``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# --- edits of the first port's aug kernel (PR 3 to PR 8) --------------------
_FIRST_KB = """        kb[0] = pack2(kexp_aug(d0[0]), kexp_aug(d0[1]));
        kb[1] = pack2(kexp_aug(d0[2]), kexp_aug(d0[3]));
        kb[2] = pack2(kexp_aug(d1[0]), kexp_aug(d1[1]));
        kb[3] = pack2(kexp_aug(d1[2]), kexp_aug(d1[3]));"""
FIRST_NOEXP = [(_FIRST_KB, """        kb[0] = pack2(d0[0], d0[1]);
        kb[1] = pack2(d0[2], d0[3]);
        kb[2] = pack2(d1[0], d1[1]);
        kb[3] = pack2(d1[2], d1[3]);""")]
FIRST_NOLOADS = [("    if (tile + 1 < t1)\n      load_tile<THREADS>(&s_s[buf ^ 1][0][0]",
                  "    if (tile < 0)\n      load_tile<THREADS>(&s_s[buf ^ 1][0][0]")]
_K8_TAB = 131072      # bytes: one bf16 entry for every one of 65536 patterns
FIRST_K8TABLE = [
    ("""  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = Ls / A_ST;""",
     """  const int g = lane >> 2, tq = lane & 3;
  const int ntiles = Ls / A_ST;
  extern __shared__ unsigned short kt_s[];
  for (int i = tid; i < 65536; i += THREADS) {
    const float d = __uint_as_float((uint32_t)i << 16);
    kt_s[i] = (unsigned short)(__float_as_uint(d != d ? 0.f : kb_aug(d)) >> 16);
  }
  __syncthreads();
  auto kent2 = [&](uint32_t x) -> uint32_t {
    return (uint32_t)kt_s[x & 0xFFFFu] | ((uint32_t)kt_s[x >> 16] << 16);
  };"""),
    (_FIRST_KB, """        kb[0] = kent2(pack2(d0[0], d0[1]));
        kb[1] = kent2(pack2(d0[2], d0[3]));
        kb[2] = kent2(pack2(d1[0], d1[1]));
        kb[3] = kent2(pack2(d1[2], d1[3]));"""),
    ("slots_of(aug_sum_kernel, THREADS, 0, &n)",
     f"slots_of(aug_sum_kernel, THREADS, {_K8_TAB}, &n)"),
    ("    aug_sum_kernel<<<grid, THREADS, 0, s>>>(",
     f"    cudaFuncSetAttribute(aug_sum_kernel, "
     f"cudaFuncAttributeMaxDynamicSharedMemorySize, {_K8_TAB});\n"
     f"    aug_sum_kernel<<<grid, THREADS, {_K8_TAB}, s>>>("),
]

# the w product on the FP32 pipe (8 FMAs a lane), up to the loop over the
# fixed tiles' span sums, which the edits below keep
_WPROD = ("              // the w product on the FP32 pipe, each product exact",
          "          for (int r = 0; r < RT; ++r) {   // rows g and g + 8")
_WPROD_TAIL = "            }\n          }\n#pragma unroll\n"
# the entries folded by XOR in place of the w product (timing only)
NO_W = [(_WPROD, "              tacc[r][0] += __uint_as_float((kb[0] ^ kb[1] ^ kb[2] ^ kb[3]) "
                 "& 0x00FF00FFu);\n" + _WPROD_TAIL)]
# the w product by mma at every depth (B column 0 = bf16(w), the quad's
# shuffles dropped), the earlier design up to 64 lanes: its sums lean low
MMA_W = [
    ("            wb[0] = ld32(ws + c + 2 * tq);",
     "            wb[0] = g == 0 ? ld32(ws + c + 2 * tq) : 0u;"),
    ("            wb[1] = ld32(ws + c + 8 + 2 * tq);",
     "            wb[1] = g == 0 ? ld32(ws + c + 8 + 2 * tq) : 0u;"),
    (_WPROD, "              mma16816(tacc[r], kb, wb);\n" + _WPROD_TAIL),
    ("    if (live) {   // the quad's partial sums", "    if (false) {   // the quad's partial sums")]

# --- edits of the table kernel (PR 9) ----------------------------------------
_ENTRY2 = "__device__ __forceinline__ uint32_t entry2(float lo, float hi, uint32_t tl) {\n"
_BITS = '  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(w) : "f"(hi), "f"(lo));\n'
_TAB = ("// the entry table: the bf16 entry of every one of the 65536 bf16(d2)",
        "// the table, the ring, 2 barriers a stage")
_HELPERS = ("// the entry table, from kb_aug: one 2-byte entry a pattern",
            "__global__ __launch_bounds__(A_THREADS, 1) void aug_sum_kernel(")
TAB_NOLOOKUP = [(_BITS, _BITS + "  return w + 0 * tl;\n")]
TAB_NOLOADS = [("""          mbar_expect_tx(full, A_STAGE_BYTES - 2 * FD * (A_LDS - A_ST));
          for (int kk = 0; kk < FD; ++kk)
            bulk_copy(dst + 2 * kk * A_LDS, strm_t + (size_t)kk * Ls + c0, 2 * A_ST, full);
          bulk_copy(dst + 2 * FD * A_LDS, w + c0, 2 * A_ST, full);""",
                "          mbar_arrive(full + 0 * (dst + (uint32_t)c0));")]
TAB_KEXP = [(_ENTRY2, _ENTRY2 + "  return pack2(kexp(rbf(lo)), kexp(rbf(hi))) + 0 * tl;\n")]

# copies of the live patterns only: bf16(d2) clamped to [TAB_LO, TAB_HI]
# (below, and every negative pattern, the entry is 1.0; above, 0) by two
# bf16x2 min/max a pair
_LIVE = """// the live patterns: at or below TAB_LO (and every negative one) the entry
// is 1.0, at or above TAB_HI 0
constexpr uint32_t TAB_LO = 0x3B00, TAB_HI = 0x42BA;
constexpr int TAB_N = TAB_HI - TAB_LO + 1;
"""
_CLAMP = """__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];\\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u16 %0, [%1];\\n" : "=r"(v) : "r"(a));
  return v;
}

// the pair rounded to bf16 and clamped to the live patterns
__device__ __forceinline__ uint32_t clamped(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const uint32_t lo2 = TAB_LO | (TAB_LO << 16), hi2 = TAB_HI | (TAB_HI << 16);
  h = __hmin2(__hmax2(h, *reinterpret_cast<const __nv_bfloat162*>(&lo2)),
              *reinterpret_cast<const __nv_bfloat162*>(&hi2));
  return *reinterpret_cast<uint32_t*>(&h);
}

"""
# 16 copies: a 64-byte row a pattern, lane l's word in it (copy l % 16) the
# entry in both halves; lanes l and l + 16 share a bank
TAB_COPIES16 = [
    (_TAB, _LIVE + "constexpr size_t TAB_BYTES = (size_t)TAB_N * 64;\n"),
    (_HELPERS, _CLAMP + """__device__ void build_table(unsigned char* tab, int tid, int nthreads) {
  for (int r = tid; r < TAB_N; r += nthreads) {
    const uint32_t wd = entry_bits(TAB_LO + r) * 0x10001u;
    uint4* row = reinterpret_cast<uint4*>(tab + (size_t)r * 64);
    for (int q = 0; q < 4; ++q) row[q] = make_uint4(wd, wd, wd, wd);
  }
}

__device__ __forceinline__ uint32_t table_base(const unsigned char* tab) {
  uint32_t a = smem_u32(tab) + 4u * (threadIdx.x % 16) - TAB_LO * 64u;
  asm volatile("" : "+r"(a)::"memory");
  return a;
}

__device__ __forceinline__ uint32_t entry2(float lo, float hi, uint32_t tl) {
  const uint32_t w = clamped(lo, hi);
  return __byte_perm(lds32(tl + ((w & 0xFFFFu) << 6)), lds32(tl + ((w & 0xFFFF0000u) >> 10)),
                     0x7610);
}

"""),
]
# 32 copies, one a bank: two patterns a word (128-byte rows), the half
# picked by a byte permute on the pattern's low bit
TAB_COPIES32 = [
    (_TAB, _LIVE + "constexpr size_t TAB_BYTES = (size_t)(TAB_N / 2 + 1) * 128;\n"),
    (_HELPERS, _CLAMP + """__device__ void build_table(unsigned char* tab, int tid, int nthreads) {
  for (int r = tid; r < TAB_N / 2 + 1; r += nthreads) {
    const uint32_t wd = entry_bits(TAB_LO + 2 * r) | (entry_bits(TAB_LO + 2 * r + 1) << 16);
    uint4* row = reinterpret_cast<uint4*>(tab + (size_t)r * 128);
    for (int q = 0; q < 8; ++q) row[q] = make_uint4(wd, wd, wd, wd);
  }
}

__device__ __forceinline__ uint32_t table_base(const unsigned char* tab) {
  uint32_t a = smem_u32(tab) + 4u * (threadIdx.x % 32) - TAB_LO * 64u;
  asm volatile("" : "+r"(a)::"memory");
  return a;
}

__device__ __forceinline__ uint32_t half_of(uint32_t x, uint32_t c) {
  uint32_t d;
  asm("prmt.b32.rc16 %0, %1, %2, %3;\\n" : "=r"(d) : "r"(x), "r"(0u), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t entry2(float lo, float hi, uint32_t tl) {
  const uint32_t w = clamped(lo, hi);
  const uint32_t a = lds32(tl + ((w & 0xFFFEu) << 6));
  const uint32_t b = lds32(tl + ((w & 0xFFFE0000u) >> 10));
  return __byte_perm(half_of(a, w), half_of(b, w >> 16), 0x7610);
}

"""),
]
# one copy of the live patterns, 2 bytes each
TAB_COPY1 = [
    (_TAB, _LIVE + "constexpr size_t TAB_BYTES = 4096;\n"),
    (_HELPERS, _CLAMP + """__device__ void build_table(unsigned char* tab, int tid, int nthreads) {
  for (int r = tid; r < TAB_N; r += nthreads)
    reinterpret_cast<unsigned short*>(tab)[r] = (unsigned short)entry_bits(TAB_LO + r);
}

__device__ __forceinline__ uint32_t table_base(const unsigned char* tab) {
  uint32_t a = smem_u32(tab) - 2u * TAB_LO;
  asm volatile("" : "+r"(a)::"memory");
  return a;
}

__device__ __forceinline__ uint32_t entry2(float lo, float hi, uint32_t tl) {
  const uint32_t w = clamped(lo, hi);
  return lds16(tl + 2u * (w & 0xFFFFu)) | (lds16(tl + ((w >> 15) & 0x1FFFEu)) << 16);
}

"""),
]
# the entries unpacked: each 2-byte load, zero-extended, is an A-fragment
# register (entry, 0) of its own, so the w product takes two mma a 16 x 16
# block, the second against w shifted down a lane pair (no byte permute)
TAB_UNPACKED = [
    (_ENTRY2, """__device__ __forceinline__ void entry2u(float lo, float hi, uint32_t tl, uint32_t& a,
                                        uint32_t& b) {
  uint32_t w;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(w) : "f"(hi), "f"(lo));
  a = lds16(tl + 2u * (w & 0xFFFFu));
  b = lds16(tl + (w >> 15));
}

""" + _ENTRY2),
    ("""              uint32_t kb[4];
              kb[0] = entry2(d0[0], d0[1], tl);
              kb[1] = entry2(d0[2], d0[3], tl);
              kb[2] = entry2(d1[0], d1[1], tl);
              kb[3] = entry2(d1[2], d1[3], tl);
              mma16816(tacc[r], kb, wb);""",
     """              uint32_t ka[4], kh[4];
              entry2u(d0[0], d0[1], tl, ka[0], kh[0]);
              entry2u(d0[2], d0[3], tl, ka[1], kh[1]);
              entry2u(d1[0], d1[1], tl, ka[2], kh[2]);
              entry2u(d1[2], d1[3], tl, ka[3], kh[3]);
              mma16816(tacc[r], ka, wb);
              mma16816(tacc[r], kh, wh);"""),
    ("""            wb[1] = g == 0 ? ld32(ws + c + 8 + 2 * tq) : 0u;""",
     """            wb[1] = g == 0 ? ld32(ws + c + 8 + 2 * tq) : 0u;
            const uint32_t wh[2] = {wb[0] >> 16, wb[1] >> 16};"""),
]
# the pair rounded without relu (a negative d2 keeps its sign bit, so the
# high pattern's address needs a mask)
TAB_SIGNED = [(_ENTRY2 + """  uint32_t w;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(w) : "f"(hi), "f"(lo));
  return lds16(tl + 2u * (w & 0xFFFFu)) | (lds16(tl + (w >> 15)) << 16);""",
               _ENTRY2 + """  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
  return lds16(tl + 2u * (w & 0xFFFFu)) | (lds16(tl + ((w >> 15) & 0x1FFFEu)) << 16);""")]
_RT4 = "constexpr int A_RT = 4;                 // aug: fixed 16-tiles a warp"
TAB_16X2 = [(_RT4, _RT4.replace("4;", "2;"))]
TAB_12X1 = [(_RT4, _RT4.replace("4;", "1;")),
            ("constexpr int A_WARPS = 16;", "constexpr int A_WARPS = 12;")]
_UNROLL = "#pragma unroll 2\n          for (int c = sp; c < sp + A_SPAN; c += 16) {"
TAB_UNROLL1 = [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))]
TAB_UNROLL4 = [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))]
TAB_STAGES2 = [("constexpr int A_STAGES = 4;             // aug: ring depth",
                "constexpr int A_STAGES = 2;             // aug: ring depth")]

# --- the kernel templated on its feature depth ---------------------------------
# at 64 lanes, 4 stages of 128 streamed entries in place of 2 of 256: the
# other fit of the ring beside the table
D64_STAGES4 = [
    ("constexpr int A_ST_OF = FD == 96 ? 128 : 256;",
     "constexpr int A_ST_OF = FD == 32 || FD == 128 ? 256 : 128;"),
    ("constexpr int A_STAGES_OF = FD == 32 ? 4 : FD == 128 ? 3 : 2;",
     "constexpr int A_STAGES_OF = FD <= 64 ? 4 : FD == 128 ? 3 : 2;"),
    ("A_SMEM_OF<64> == 199712", "A_SMEM_OF<64> == 201792")]

# past 64 lanes, the shipped routes swapped or widened: the entry table at
# 128 lanes too (2 stages of 128 beside it, 201,248 bytes); kb_pair's
# entries (K7's and K8's: kexp on bf16(d2), one FMUL and one MUFU ex2 an
# entry) with no table at 96 lanes too (4 stages of 256, 204,864 bytes);
# the table at 96 lanes beside 3 stages of 128 (210,224 bytes); and the w
# product by mma as up to 64 lanes (its sums lean low)
_ROUTE = "constexpr bool A_TABLE_OF = FD <= 96;   // aug: the entry from the table, else kb_pair"
_ST = "constexpr int A_ST_OF = FD == 96 ? 128 : 256;   // aug: streamed entries a ring stage"
_STAGES = "constexpr int A_STAGES_OF = FD == 32 ? 4 : FD == 128 ? 3 : 2;   // aug: ring depth"
WIDE_TABLE = [
    (_ROUTE, _ROUTE.replace("FD <= 96", "FD <= 128")),
    (_ST, _ST.replace("FD == 96 ? 128 : 256", "FD <= 64 ? 256 : 128")),
    (_STAGES, _STAGES.replace("FD == 128 ? 3 : 2", "2")),
    ("A_SMEM_OF<128> == 204336", "A_SMEM_OF<128> == 201248")]
WIDE_NO_TABLE = [
    (_ROUTE, _ROUTE.replace("FD <= 96", "FD <= 64")),
    (_ST, _ST.replace("FD == 96 ? 128 : 256", "256")),
    (_STAGES, _STAGES.replace("FD == 128 ? 3 : 2", "FD == 64 ? 2 : FD == 96 ? 4 : 3")),
    ("A_SMEM_OF<96> == 183840", "A_SMEM_OF<96> == 204864")]
D96_STAGES3 = [
    (_STAGES, _STAGES.replace("FD == 128 ? 3 : 2", "FD >= 96 ? 3 : 2")),
    ("A_SMEM_OF<96> == 183840", "A_SMEM_OF<96> == 210224")]

# --- the wgmma design (dropped) ----------------------------------------------
# three consumer warpgroups (160 registers each after setmaxnreg), one m64
# tile of fixed rows each; a producer warpgroup keeps a ring of 128-entry
# stages in flight by TMA (64 x 32 boxes, 128-byte swizzle) and bulk copies;
# d2 by wgmma m64n64k16 with A (the fixed features) from registers, two
# 64-entry halves a stage in two groups (the second runs while the first
# half's entries are looked up); the entries in place as mma.sync A
# fragments and the w product by mma.sync (the wgmma form, eight dependent
# m64n8k16 a tile, ran at 1.8 ms)
_WG_CONSTS = """constexpr int A_CONSUMERS = 384;       // aug: three consumer warpgroups
constexpr int A_THREADS = A_CONSUMERS + 128;    // aug: + the producer warpgroup
constexpr int A_PRODUCER_REGS = 24;     // aug: setmaxnreg, the producer gives registers
constexpr int A_CONSUMER_REGS = 160;    // to the consumers (3 x 128 x 160 + 128 x 24)
constexpr int A_FT = 192;               // aug: fixed entries a work item, an m64 tile a warpgroup
constexpr int A_ST = 128;               // aug: streamed entries a stage (a tile sum's span)
constexpr int A_STAGES = 4;             // aug: ring depth
constexpr int A_BOX = 64 * FD * 2;      // one TMA box: 64 streamed x 32 deep (4 KB)
constexpr int A_B_BYTES = 2 * A_BOX;    // the stage's streamed features, d2's B operand
constexpr int A_STAGE_BYTES = A_B_BYTES + 1024;  // + bf16(w) of the stage (256 B), padded
"""
_WG_KERNEL = r"""// shared-memory matrix descriptor, 128-byte swizzle: the operand starts at
// `addr` (its 1024-byte swizzle atoms aligned); lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

#define GLT_D32(c)                                                                          \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),   \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),          \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),          \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define GLT_OUT(x) "=f"(x)
#define GLT_INOUT(x) "+f"(x)
#define GLT_N64_ASM                                                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "         \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"

// d = A (64 x 16, registers) B (16 x 64, shared, MN-major), from zero: d is
// written only, so it holds no value across the loop that reuses it
__device__ __forceinline__ void wgmma_rs_n64_first(float d[32], const uint32_t a[4],
                                                   uint64_t db) {
  asm volatile(GLT_N64_ASM
               : GLT_D32(GLT_OUT)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// d += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float d[32], const uint32_t a[4], uint64_t db) {
  asm volatile(GLT_N64_ASM
               : GLT_D32(GLT_INOUT)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keep the compiler from moving reads of an accumulator across a wgmma wait
__device__ __forceinline__ void fence_regs32(float d[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one m64 x 64 half-stage's entries: the d2 accumulator (fixed rows g | g + 8
// by streamed 8i + 2tq, +1 in d[4i..4i+3]) in place as the A fragments of
// the w product's four k16 steps (the accumulator layout is the register-A
// layout)
__device__ __forceinline__ void half_entries(uint32_t e[4][4], const float d[32], uint32_t tl) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) e[j][q] = entry2(d[8 * j + 2 * q], d[8 * j + 2 * q + 1], tl);
}

// the w product of a warp's 16 rows of a half-stage: t = entries (16 x 64)
// [bf16(w), 0, ...] (64 x 8) by four mma.sync m16n8k16, each from zero
// (independent: their latencies overlap), added in f32 in a fixed tree;
// column 0 lands in t[0] (row g) and t[1] (row g + 8). wb: the steps' B
// fragments
__device__ __forceinline__ void w_product(float t[2], const uint32_t e[4][4],
                                          const uint32_t wb[4][2]) {
  float u[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[j][i] = 0.f;
    mma16816(u[j], e[j], wb[j]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    t[h] = (u[0][2 * h] + u[1][2 * h]) + (u[2][2 * h] + u[3][2 * h]);
}

__global__ __launch_bounds__(A_THREADS, 1) void aug_sum_kernel(
    const __grid_constant__ CUtensorMap s_map,   // streamed (32, Ls) k-major, 64 x 32 boxes
    const bf16* __restrict__ fixed_t,   // (32, Lf) k-major aug
    const bf16* __restrict__ w,         // (Ls) bf16-rounded
    float* __restrict__ part,           // (splits, Lf)
    int Lf, int Ls, int splits, int tiles_per_split) {
  extern __shared__ unsigned char a_raw[];
  unsigned char* smem = a_raw + ((1024 - (smem_u32(a_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  unsigned char* tab = smem + A_STAGES * A_STAGE_BYTES;
  const uint32_t full0 = smem_u32(tab + TAB_BYTES), empty0 = full0 + 8 * A_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int items = (Lf + A_FT - 1) / A_FT * splits;
  const int ntiles = Ls / A_ST;

  build_table(tab, tid, A_THREADS);
  if (tid == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, A_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= A_CONSUMERS / 32) {
    // producer: one lane keeps the ring full, item after item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(A_PRODUCER_REGS));
    if (tid == A_CONSUMERS) {
      uint32_t k = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int t0 = (it % splits) * tiles_per_split;
        const int t1 = min(ntiles, t0 + tiles_per_split);
        for (int t = t0; t < t1; ++t, ++k) {
          const uint32_t st = k % A_STAGES;
          mbar_wait(empty0 + 8 * st, ((k / A_STAGES) & 1) ^ 1);
          const uint32_t full = full0 + 8 * st, base = ring + st * A_STAGE_BYTES;
          const int c0 = t * A_ST;
          mbar_expect_tx(full, A_B_BYTES + 2 * A_ST);
          tma_box(base, &s_map, c0, 0, full);
          tma_box(base + A_BOX, &s_map, c0 + 64, 0, full);
          bulk_copy(base + A_B_BYTES, w + c0, 2 * A_ST, full);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns fixed entries 64 cw .. 64 cw + 63 of each
  // item, an m64 tile; this thread rows 16 (warp % 4) + g, + 8
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(A_CONSUMER_REGS));
  const int cw = warp / 4, g = lane >> 2, tq = lane & 3;
  const uint32_t tl = table_base(tab);
  const unsigned short* fx = reinterpret_cast<const unsigned short*>(fixed_t);
  uint32_t k = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int split = it % splits;
    const int t0 = split * tiles_per_split, t1 = min(ntiles, t0 + tiles_per_split);
    const int f0 = (it / splits) * A_FT + 64 * cw;   // the warpgroup's tile
    const bool live = f0 < Lf;          // a last item may hold fewer tiles
    const int fr = f0 + 16 * (warp % 4);
    uint32_t a[2][4];
    if (live) {
      frag_a_kmajor(a[0], fx, (size_t)Lf, fr, 0, g, tq);
      frag_a_kmajor(a[1], fx, (size_t)Lf, fr, 16, g, tq);
    }
    float acc[2] = {0.f, 0.f};
    for (int t = t0; t < t1; ++t, ++k) {
      const uint32_t st = k % A_STAGES;
      mbar_wait(full0 + 8 * st, (k / A_STAGES) & 1);
      if (live) {
        const uint32_t base = ring + st * A_STAGE_BYTES;
        // d2 of the stage's two 64-entry halves, two groups: the second runs
        // while the first half's entries are looked up
        float d0[32], d1[32];
        wgmma_fence();
        wgmma_rs_n64_first(d0, a[0], sw128_desc(base, A_BOX, 1024));
        wgmma_rs_n64(d0, a[1], sw128_desc(base + 2048, A_BOX, 1024));
        wgmma_commit();
        wgmma_rs_n64_first(d1, a[0], sw128_desc(base + A_BOX, A_BOX, 1024));
        wgmma_rs_n64(d1, a[1], sw128_desc(base + A_BOX + 2048, A_BOX, 1024));
        wgmma_commit();
        // the w product's B fragments: bf16(w) of streamed 16j + 2tq, +1 and
        // 16j + 8 + 2tq, +1 in column 0 (lanes g == 0)
        const bf16* ws = reinterpret_cast<const bf16*>(smem + st * A_STAGE_BYTES + A_B_BYTES);
        uint32_t wb[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wb[j][0] = g == 0 ? ld32(ws + 16 * j + 2 * tq) : 0u;
          wb[j][1] = g == 0 ? ld32(ws + 16 * j + 8 + 2 * tq) : 0u;
        }
        // each half's w sums start from zero (the tensor core's accumulation
        // truncates: a running sum carried through every stage would end
        // low) and join the running sums by an f32 add
        float s[2];
        uint32_t e[4][4];
        wgmma_wait1();
        fence_regs32(d0);
        half_entries(e, d0, tl);
        w_product(s, e, wb);
        acc[0] += s[0];
        acc[1] += s[1];
        wgmma_wait0();
        fence_regs32(d1);
        half_entries(e, d1, tl);
        w_product(s, e, wb + 4);
        acc[0] += s[0];
        acc[1] += s[1];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    if (live && tq == 0) {   // column 0: rows g, g + 8
      float* o = part + (size_t)split * Lf + fr;
      o[g] = acc[0];
      o[g + 8] = acc[1];
    }
  }
}

"""
WGMMA = [
    (("constexpr int A_WARPS = 16;", "// the entry table: the bf16 entry of every one"), _WG_CONSTS),
    ("constexpr size_t A_SMEM = TAB_BYTES + (size_t)A_STAGES * A_STAGE_BYTES + 16 * A_STAGES;",
     "constexpr size_t A_SMEM = 1024 + (size_t)A_STAGES * A_STAGE_BYTES + TAB_BYTES + 16 * A_STAGES;"),
    ('static_assert(A_ST % A_SPAN == 0 && A_SPAN % 16 == 0, "aug spans");\n', ""),
    (("__global__ __launch_bounds__(A_THREADS, 1) void aug_sum_kernel(",
      "// every bf16 pattern x (as d2) -> the aug entry's bf16 bits"), _WG_KERNEL),
    ("""    aug_sum_kernel<<<blocks, A_THREADS, A_SMEM, s>>>(
        static_cast<const bf16*>(fixed_t), static_cast<const bf16*>(strm_t),
        static_cast<const bf16*>(w), static_cast<float*>(part), Lf, Ls, splits, per);""",
     """    CUtensorMap map;
    if (!tile_map(&map, strm_t, false, Ls, FD, Ls, 64, FD))
      return static_cast<int>(cudaErrorInvalidValue);
    aug_sum_kernel<<<blocks, A_THREADS, A_SMEM, s>>>(
        map, static_cast<const bf16*>(fixed_t), static_cast<const bf16*>(w),
        static_cast<float*>(part), Lf, Ls, splits, per);"""),
]
# timing only: d2 once an item (the first stage's), its entries looked up
# again at every stage
WGMMA_NOD2 = WGMMA + [
    ("    float acc[2] = {0.f, 0.f};\n    for (int t = t0; t < t1; ++t, ++k) {",
     "    float acc[2] = {0.f, 0.f};\n    float d0[32], d1[32];\n    for (int t = t0; t < t1; ++t, ++k) {"),
    ("        float d0[32], d1[32];\n        wgmma_fence();", "        if (t == t0) {\n        wgmma_fence();"),
    ("        wgmma_commit();\n        // the w product's B fragments",
     "        wgmma_commit();\n        }\n        // the w product's B fragments"),
]
_WG_TILES = {32: (192, 128)}

# name -> (edits of recompute_matvec.cu, design, timing only[, (fixed,
# streamed) entries of the variant's work item and stage, which the
# wrapper's plan then takes]); an edit is (old, new), or ((start, end), new)
# for the text from start up to end; edits apply in order
VARIANTS = {
    "shipped": ([], "shipped", False),
    "first no exp": (FIRST_NOEXP, "the entry is bf16(d2)'s bits, no exp", True),
    "first no loads": (FIRST_NOLOADS, "the streamed loads dropped", True),
    "first k8 table": (FIRST_K8TABLE, "the entry from K8's 65536-pattern table", False),
    "no lookup": (TAB_NOLOOKUP, "the entry is bf16(d2)'s bits", True),
    "no w": (NO_W, "the w product dropped", True),
    "no loads": (TAB_NOLOADS, "stages completed without copies", True),
    "16 copies": (TAB_COPIES16, "16 copies of the live patterns, clamped", False),
    "32 copies": (TAB_COPIES32, "32 copies of the live patterns, clamped", False),
    "1 copy": (TAB_COPY1, "one copy of the live patterns, clamped", False),
    "kexp": (TAB_KEXP, "the entry by one FMUL and one MUFU ex2 (K10's exp)", True),
    "16x2": (TAB_16X2, "16 consumer warps of 32 rows", False, {32: (512, 256)}),
    "12x1": (TAB_12X1, "12 consumer warps of 16 rows", False, {32: (192, 256)}),
    "2 stages": (TAB_STAGES2, "a 2-stage ring", False),
    "d64 4x128": (D64_STAGES4, "at 64 lanes a 4-stage ring of 128-entry stages", False,
                  {64: (512, 128)}),
    "wide table": (WIDE_TABLE, "the entry table at 128 lanes too, 2 stages of 128", False,
                   {128: (256, 128)}),
    "wide no table": (WIDE_NO_TABLE, "kb_pair's entries at 96 lanes too, no table, 4 stages "
                      "of 256", False, {96: (512, 256)}),
    "d96 3x128": (D96_STAGES3, "at 96 lanes 3 stages of 128 beside the table", False),
    "mma w": (MMA_W, "the w product by mma (its sums lean low)", False),
    "unpacked": (TAB_UNPACKED, "entries unpacked, two w-product mma a block", False),
    "signed": (TAB_SIGNED, "the pair rounded without relu, the high address masked", False),
    "unroll 1": (TAB_UNROLL1, "the 16-entry column loop not unrolled", False),
    "unroll 4": (TAB_UNROLL4, "the 16-entry column loop unrolled by 4", False),
    "wgmma": (WGMMA, "three wgmma consumer warpgroups, a TMA ring", False, _WG_TILES),
    "wgmma no d2": (WGMMA_NOD2, "wgmma, d2 once an item: the entry path alone", True,
                    _WG_TILES),
    "wgmma no lookup": (WGMMA + TAB_NOLOOKUP, "wgmma, the entry the clamped bf16(d2)'s bits",
                        True, _WG_TILES),
}


def variant_sources(repo: Path, out: Path) -> dict:
    """{variant: its directory} for the variants whose edits all match the
    checkout's recompute_matvec.cu once, each written under ``out``; the
    others map to None."""
    csrc = repo / "graphlap_tpu_torch" / "csrc"
    src = (csrc / "recompute_matvec.cu").read_text()
    headers = {f.name: f.read_text() for f in csrc.glob("*.cuh")}
    dirs = {}
    for name, (edits, *_) in VARIANTS.items():
        text = src
        for old, new in edits:
            marks = old if isinstance(old, tuple) else (old,)
            if not all(text.count(m) == 1 for m in marks):
                text = None
                break
            if isinstance(old, tuple):
                i, j = text.index(old[0]), text.index(old[1])
                text = text[:i] + new + text[j:]
            else:
                text = text.replace(old, new)
        if text is None:
            dirs[name] = None
            continue
        d = out / name.strip().replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "recompute_matvec.cu").write_text(text)
        for fname, h in headers.items():
            (d / fname).write_text(h)
        dirs[name] = d
    return dirs


def build_all(dirs: dict, build) -> dict:
    """Each variant's recompute_matvec.cu into its own shared library, one
    nvcc a variant, all started together: {variant: (library, ptxas log)}."""
    nvcc = build._nvcc()
    procs = {}
    for name, d in dirs.items():
        if d is not None:
            procs[name] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
                 str(d / "recompute_matvec.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"matvec_designs: {name}: nvcc failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(dirs[name] / "lib.so"))
        for fn in ("glt_recompute_slots", "glt_recompute_sum"):
            args, res = build._SIGNATURES[fn]
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res
        built[name] = (lib, log)
    return built


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--only", default="")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--patch", type=int, default=5, choices=(5, 7, 9, 11),
                    help="the NLM patch of the shapes: 7, 9 and 11 time the 64-, "
                    "96- and 128-lane kernels")
    args = ap.parse_args()
    repo = Path(args.repo).resolve()
    out = ROOT / "build" / "matvec_designs" / (repo.name or "repo")
    dirs = variant_sources(repo, out)
    if args.only:
        keep = {n.strip() for n in args.only.split(",")}
        dirs = {n: d for n, d in dirs.items() if n.strip() in keep}
    if args.dry:
        print(f"matvec_designs: {repo}: applies {[n for n, d in dirs.items() if d]}, "
              f"not {[n for n, d in dirs.items() if d is None]}; sources under {out}")
        return
    if not torch.cuda.is_available():
        sys.exit("matvec_designs: no CUDA card")
    sys.path.insert(0, str(repo))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    if repo not in Path(gt.__file__).resolve().parents:
        sys.exit(f"matvec_designs: imported {gt.__file__}, not from {repo}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    shapes = {}
    for tag, make in (("cfg3", cs.make_workload_cfg3), ("8mp", cs.make_workload_8mp)):
        cfg, _, noisy, plan = make(gt, patch=args.patch)
        img = torch.as_tensor(noisy, device=dev)
        if img.ndim == 3:
            img = img[..., 0].contiguous()
        ctx = ms._strip_ctx(img, torch.as_tensor(plan.idx_a.astype(np.int64), device=dev),
                            cfg)
        fa, f_t = ctx.fa_aug, ctx.f_t
        gen = torch.Generator(device=dev).manual_seed(1)
        v = 0.5 + torch.rand(f_t.shape[1], generator=gen, device=dev)
        t = torch.zeros(fa.shape[0], device=dev)
        t[:ctx.p] = 0.5 + torch.rand(ctx.p, generator=gen, device=dev)
        shapes[tag] = dict(fa=fa, f_t=f_t, v=v, t=t, p=ctx.p, p_pad=int(fa.shape[0]),
                           n=int(f_t.shape[1]))
        del ctx, img
    c3 = shapes["cfg3"]
    refs = (k56.matvec_plain(c3["fa"], c3["f_t"], c3["v"], True),
            k56.rmatvec_plain(c3["fa"], c3["f_t"], c3["t"], True))
    built = build_all(dirs, _build)

    def err(got, ref):
        return float((got - ref).abs().max() / ref.abs().max())

    saved = _build._LIB, k56.FIXED_TILE, k56.STREAM_TILE
    rows = {name: dict(design=VARIANTS[name][1], applies=False)
            for name, d in dirs.items() if d is None}
    try:
        for rep in range(args.reps):
            for name, (lib, log) in built.items():
                _build._LIB = lib
                k56.FIXED_TILE, k56.STREAM_TILE = saved[1:]
                for fd, (fixed, streamed) in (VARIANTS[name][3] if len(VARIANTS[name]) > 3
                                               else {}).items():
                    # keyed by (dtype, depth), or by dtype before the 64-lane kernels
                    key = ((torch.bfloat16, fd) if (torch.bfloat16, fd) in saved[1]
                           else torch.bfloat16)
                    k56.FIXED_TILE = {**k56.FIXED_TILE, key: fixed}
                    k56.STREAM_TILE = {**k56.STREAM_TILE, key: streamed}
                row = rows.setdefault(name, dict(
                    design=VARIANTS[name][1], applies=True,
                    timing_only=VARIANTS[name][2], ms={}, ptxas=[
                        ln.strip() for ln in log.splitlines()
                        if "aug_sum_kernel" in ln or "registers" in ln or "spill" in ln]))
                try:
                    if rep == 0:
                        got = (k56.matvec_cuda(c3["fa"], c3["f_t"], c3["v"], True),
                               k56.rmatvec_cuda(c3["fa"], c3["f_t"], c3["t"], True))
                        row["err"] = [err(got[0][:c3["p"]], refs[0][:c3["p"]]),
                                      err(got[1], refs[1])]
                        del got
                    for tag, x in shapes.items():
                        reps = 10 if tag == "cfg3" else 3
                        for kname, fn, vec in (("matvec", k56.matvec_cuda, x["v"]),
                                               ("rmatvec", k56.rmatvec_cuda, x["t"])):
                            ms_ = cs.cuda_ms(lambda: fn(x["fa"], x["f_t"], vec, True), reps)
                            row["ms"].setdefault(f"{tag} {kname}", []).append(ms_)
                except RuntimeError as exc:   # a launch the variant's plan refuses
                    row["failed"] = str(exc)
                    print(f"{name}: failed: {exc}", flush=True)
                    continue
                print(f"{name} ({row['design']}): "
                      f"{ {k: round(v[-1], 4) for k, v in row['ms'].items()} } ms, "
                      f"err {row['err']}", flush=True)
    finally:
        _build._LIB, k56.FIXED_TILE, k56.STREAM_TILE = saved
    result = dict(card=card, repo=str(repo),
                  shapes={k: dict(p_pad=x["p_pad"], n=x["n"]) for k, x in shapes.items()},
                  variants=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
