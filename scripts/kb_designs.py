"""K7, the gram emitter (csrc/recompute_sweeps.cu kb_emit_kernel), in the
designs its source notes compare: time at config 4's gram shape and error
against the plain version.

    python3 scripts/kb_designs.py [--parent DIR] [--only NAME,...]
                                  [--reps N] [--out FILE] [--dry]

The script copies this checkout's csrc/recompute_sweeps.cu and its header
into build/kb_designs/<variant>/, rewrites the text a variant changes,
builds each copy alone with the package's nvcc flags (all copies at once,
one nvcc each) and loads it in place of the kernel library, so the
package's own wrapper (cuda_recompute.kb_strip_cuda) drives it. Variants:

* ``shipped``: two 8-warp blocks an SM, 64 x 256 output units dealt
  round-robin over the blocks (unit q of block b is b + q G), two staging
  buffers, a 2-stage f_t ring, kexp on bf16(d2), the TMA stores tagged L2
  evict-first;
* ``ranges``: each block on a contiguous range of units instead;
  ``128x128``, ``128x128 ranges``: 128 x 128 units (3-stage ring);
* ``no hint``: the TMA stores without the evict-first policy;
  ``128x128 ranges no hint``: the design before the policy;
* ``table``: the entry from a 128 KB shared-memory table of all 65536
  bf16(d2) patterns, filled with kb_aug's expf, as K8 reads it (one block
  an SM: the table does not fit twice);
* ``expf``: the entry by kb_aug's IEEE expf (the first port's entry);
* ``hmul2``: the scale by bf16(cols) as one bf16x2 multiply of the packed
  entries (rounded once, as the f32 product then the bf16 cast, but for
  subnormal products);
* ``one block``: shared memory padded so one block runs an SM;
* ``stg``, ``stg cs``: the unit leaves by 16-byte coalesced st.global
  (plain, or .cs: evict-first) from the staging in place of the TMA store;
* ``pad rows``: the output's rows 64 columns longer than S (the script
  hands the kernel such a buffer), so that rows are not a power of two of
  bytes apart;
* ``bulk rows``: each row of a unit leaves by one 1-D bulk copy (512
  contiguous bytes, L2 evict-first) from a row-major staging padded to
  528-byte rows, in place of the TMA tensor stores of 128-byte box rows;
* ``producer warp``: a warp-specialized design, dropped: one 544-thread
  block an SM, a producer warp feeding the ring and draining six staging
  buffers by TMA store (up to five in flight), 16 consumer warps that wait
  only on mbarriers, 128 x 128 units in ranges;
* timing only: ``no entry`` (the entry is bf16(d2)'s bits), ``no store``
  (the TMA stores dropped), ``store only`` (no product and no entry: the
  staging holds the column scales) and the store alone in ranges, as
  128 x 128 units in ranges, without the policy, by st.global, or by a
  bulk copy a row.

Beside them, ``fill_ms``: torch's fill_ of a bf16 tensor of the output's
shape, the card's rate for plain stores of the same bytes (a yardstick for
the store, not a kernel of the port).

``--parent DIR`` adds ``parent``: DIR's recompute_sweeps.cu as it is (e.g.
the parent commit unpacked with ``git archive``), timed in turns with the
others. Shapes: chip_smoke.make_workload_8mp's features and gram columns
(p_pad 4096, 131072 columns), cols from a seeded generator, as
chip_smoke.config4 makes them. Times are CUDA-event means
(chip_smoke.cuda_ms, 10 launches); every variant runs --reps times in turn
(default 2). The error is the largest |kernel - plain| (meaningless for the
timing-only variants), and ``same`` says whether its output equals the
shipped kernel's bit for bit. --dry writes the variant sources here and
checks the edits without a card. Prints the card line and one JSON line;
--out writes the JSON.
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
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
SRC = "recompute_sweeps.cu"

_PAIR = """  const uint32_t w = pack2(lo, hi);
  return pack2(kexp(__uint_as_float(w << 16)), kexp(__uint_as_float(w & 0xFFFF0000u)));"""
_TAB = 131072   # bytes: one bf16 entry for each of the 65536 patterns
# the shipped shared-memory size of a K7 block (at FD lanes); the variants
# measure the 32-lane kernel at config 4's 8 MP gram shape
_E_SMEM = """template <int FD>
constexpr size_t e_smem() {
  return 1024 + 2 * (size_t)E_OUT_BYTES + (size_t)E_STAGES * E_FT_BYTES_OF<FD> + 8 * E_STAGES;
}
"""
_KERNEL = ("template <int FD>\n"
           "__global__ __launch_bounds__(E_THREADS, FD == 32 ? 2 : 1) void kb_emit_kernel(")
TABLE = [
    ("__device__ __forceinline__ uint32_t kb_pair(float lo, float hi) {\n" + _PAIR,
     "__device__ __forceinline__ uint32_t kb_pair(float lo, float hi) {\n"
     "  extern __shared__ unsigned char e_raw[];\n"
     "  const unsigned short* kt = reinterpret_cast<const unsigned short*>(\n"
     "      e_raw + ((1024 - (smem_u32(e_raw) & 1023)) & 1023) + E_SMEM - 1024);\n"
     "  const uint32_t w = pack2(lo, hi);\n"
     "  return (uint32_t)kt[w & 0xFFFFu] | ((uint32_t)kt[w >> 16] << 16);"),
    ("  if (tid == 0) {\n    for (int s = 0; s < E_STAGES; ++s) mbar_init(",
     "  {\n"
     "    unsigned short* kt = reinterpret_cast<unsigned short*>(smem + E_SMEM - 1024);\n"
     "    for (int i = tid; i < 65536; i += E_THREADS) {\n"
     "      const float d = __uint_as_float((uint32_t)i << 16);\n"
     "      kt[i] = (unsigned short)(__float_as_uint(d != d ? 1.f : kb_aug(d)) >> 16);\n"
     "    }\n"
     "  }\n"
     "  if (tid == 0) {\n    for (int s = 0; s < E_STAGES; ++s) mbar_init("),
    (_E_SMEM, _E_SMEM + "constexpr size_t E_SMEM = e_smem<32>();   // the 32-lane kernel's\n"),
    ("  constexpr size_t smem = e_smem<FD>();",
     f"  constexpr size_t smem = e_smem<FD>() + {_TAB};"),
]
EXPF = [(_PAIR, "  return pack2(kb_aug(lo), kb_aug(hi));")]
HMUL2 = [("  return pack2(__uint_as_float(e << 16) * c0, __uint_as_float(e & 0xFFFF0000u) * c1);",
          "  const uint32_t c = pack2(c0, c1);\n"
          "  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&e),\n"
          "                                  *reinterpret_cast<const __nv_bfloat162*>(&c));\n"
          "  return *reinterpret_cast<const uint32_t*>(&r);")]
NO_ENTRY = [(_PAIR, "  return pack2(fmaxf(lo, 0.f), fmaxf(hi, 0.f));")]
ONE_BLOCK = [("  return 1024 + 2 * (size_t)E_OUT_BYTES + (size_t)E_STAGES",
              "  return 65536 + 1024 + 2 * (size_t)E_OUT_BYTES + (size_t)E_STAGES")]
# each block on a contiguous range of the unit order, staying on one row
# slice (its A fragments) for most of its run
RANGES = [("  const int n = (int)((units - blockIdx.x + gridDim.x - 1) / gridDim.x);\n"
           "  auto unit = [&](int q) { return (int)blockIdx.x + q * (int)gridDim.x; };",
           "  const int t0 = (int)(blockIdx.x * units / gridDim.x);\n"
           "  const int n = (int)((blockIdx.x + 1) * units / gridDim.x) - t0;\n"
           "  auto unit = [&](int q) { return t0 + q; };")]
# 128 x 128 units (256 contiguous bytes a row a unit) with a 3-stage ring
SQUARE = [("constexpr int E_TM = 64;        // rows a unit\nconstexpr int E_TN = 256;",
           "constexpr int E_TM = 128;        // rows a unit\nconstexpr int E_TN = 128;"),
          ("constexpr int E_STAGES = 2;     // f_t ring (3 stages would not let two blocks fit an SM)",
           "constexpr int E_STAGES = 3;     // f_t ring")]
NO_STORE = [
    ("        tma_store_hint(&out_map, smem_u32(stage + bx * (E_OUT_BYTES / E_BOXES)),\n"
     "                       ct * E_TN + bx * E_BOX, rb * E_TM, pol);\n",
     "        (void)bx, (void)pol;\n"),
]
STORE_ONLY = [
    ("#pragma unroll\n        for (int ks = 0; ks < KS; ++ks) mma16816(c, A[mt][ks], B[nt][ks]);\n",
     ""),
    ("            scale_pair(kb_pair(c[0], c[1]), cs[nt][0], cs[nt][1]);",
     "            pack2(cs[nt][0], cs[nt][1]);"),
    ("            scale_pair(kb_pair(c[2], c[3]), cs[nt][0], cs[nt][1]);",
     "            pack2(cs[nt][1], cs[nt][0]);"),
]
# the unit leaves by 16-byte coalesced st.global from the staging (the
# path torch's fill_ takes) in place of the TMA store: one block barrier a
# unit; the stores retire while the block computes the next unit
_STG_COPY = """    __syncthreads();   // the unit is staged; its ring stage is free
    if (tid == 0 && q + E_STAGES < n) load(unit(q + E_STAGES), st);
    for (int v = tid; v < E_TM * (E_TN / 8); v += E_THREADS) {
      const int r = v / (E_TN / 8), c = v % (E_TN / 8), cc = c % 8;
      const uint4 w = *reinterpret_cast<const uint4*>(stage + (c / 8) * (E_OUT_BYTES / E_BOXES) +
                                                      r * 128 + ((cc ^ (r & 7)) << 4));
      const int col = ct * E_TN + c * 8;
      if (col < S) STG(out + (size_t)(rb * E_TM + r) * S + col, w);
    }
  }
"""
STG = [
    ("    if (tid == 0) bulk_wait_read<1>();   // the store of unit q - 2 has left this buffer\n", ""),
    (("    fence_async_smem();\n    __syncthreads();   // the unit is staged",
      "  if (tid == 0) bulk_wait_all();"), _STG_COPY),
    ("    int nrb, int nct, int S) {", "    int nrb, int nct, int S, bf16* __restrict__ out) {"),
    ("static_cast<const bf16*>(cols), nrb, nct, S);",
     "static_cast<const bf16*>(cols), nrb, nct, S,\n"
     "                                                 static_cast<bf16*>(out));"),
    (_KERNEL, "#define STG(p, w) (*reinterpret_cast<uint4*>(p) = (w))\n" + _KERNEL),
]
# the same with the streaming (evict-first) store st.global.cs
STG_CS = STG[:-1] + [
    (_KERNEL,
     "#define STG(p, w) asm volatile(\"st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\" :: \"l\"(p), "
     "\"r\"((w).x), \"r\"((w).y), \"r\"((w).z), \"r\"((w).w) : \"memory\")\n" + _KERNEL),
]

# the output's rows 64 columns longer than S (not a power of two of bytes
# apart); the script hands the kernel such a buffer
PAD = 64
PAD_ROWS = [("      !tile_map(&out_map, out, false, S, P, S, E_BOX, E_TM))",
             f"      !tile_map(&out_map, out, false, S, P, S + {PAD}, E_BOX, E_TM))")]
# the TMA stores without the L2 evict-first policy
NO_HINT = [("        tma_store_hint(&out_map, smem_u32(stage + bx * (E_OUT_BYTES / E_BOXES)),\n"
            "                       ct * E_TN + bx * E_BOX, rb * E_TM, pol);",
            "        tma_store(&out_map, smem_u32(stage + bx * (E_OUT_BYTES / E_BOXES)),\n"
            "                  ct * E_TN + bx * E_BOX, rb * E_TM);\n        (void)pol;")]

# each row of a unit leaves by one 1-D bulk copy (512 contiguous bytes,
# L2 evict-first) from a row-major staging whose rows lie 528 bytes apart
# (16 more than a row: the 8 rows a warp writes at once fall in distinct
# banks), in place of the TMA tensor stores of 128-byte box rows
BULK_ROWS = [
    ("    int nrb, int nct, int S) {", "    int nrb, int nct, int S, bf16* __restrict__ out) {"),
    ("static_cast<const bf16*>(cols), nrb, nct, S);",
     "static_cast<const bf16*>(cols), nrb, nct, S,\n"
     "                                                 static_cast<bf16*>(out));"),
    (_E_SMEM, "constexpr int E_PITCH = E_TN * 2 + 16;\n"
     "constexpr int E_STG_BYTES = E_TM * E_PITCH;\n"
     + _E_SMEM.replace("2 * (size_t)E_OUT_BYTES", "2 * (size_t)E_STG_BYTES")),
    ("  unsigned char* ring = smem + 2 * E_OUT_BYTES;", "  unsigned char* ring = smem + 2 * E_STG_BYTES;"),
    ("    unsigned char* stage = smem + (q & 1) * E_OUT_BYTES;",
     "    unsigned char* stage = smem + (q & 1) * E_STG_BYTES;"),
    ("    if (tid == 0) bulk_wait_read<1>();", "    if (tid < E_TM) bulk_wait_read<1>();"),
    ("  if (tid == 0) bulk_wait_all();", "  if (tid < E_TM) bulk_wait_all();"),
    ("""        unsigned char* o = stage + (box + (chunk0 + nt) / 8) * (E_OUT_BYTES / E_BOXES) +
                           ((((chunk0 + nt) % 8) ^ g) << 4) + tq * 4;
        *reinterpret_cast<uint32_t*>(o + r0 * 128) =""",
     """        unsigned char* o = stage + (E_WN * wc + 8 * nt + 2 * tq) * 2;
        *reinterpret_cast<uint32_t*>(o + r0 * E_PITCH) ="""),
    ("        *reinterpret_cast<uint32_t*>(o + (r0 + 8) * 128) =",
     "        *reinterpret_cast<uint32_t*>(o + (r0 + 8) * E_PITCH) ="),
    ("""    if (tid == 0) {
      const uint64_t pol = l2_evict_first();
      for (int bx = 0; bx < E_BOXES; ++bx)
        tma_store_hint(&out_map, smem_u32(stage + bx * (E_OUT_BYTES / E_BOXES)),
                       ct * E_TN + bx * E_BOX, rb * E_TM, pol);
      bulk_commit();
      if (q + E_STAGES < n) load(unit(q + E_STAGES), st);
    }""",
     """    if (tid < E_TM) {   // row tid of the unit
      const int w = min(E_TN, S - ct * E_TN) * 2;
      const uint64_t pol = l2_evict_first();
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\\n" ::"l"(
              out + (size_t)(rb * E_TM + tid) * S + ct * E_TN),
          "r"(smem_u32(stage + tid * E_PITCH)), "r"(w), "l"(pol)
          : "memory");
      bulk_commit();
    }
    if (tid == 0 && q + E_STAGES < n) load(unit(q + E_STAGES), st);"""),
]

# a warp-specialized design, dropped: one 544-thread block an SM, a producer
# warp feeding the ring and draining six staging buffers by TMA store (up to
# five in flight), 16 consumer warps synchronized by mbarriers only
_WS_CONSTS = r"""// ---------------------------------------------------------------------------
// K7: the column-scaled tile emitter (aug layout), persistent and
// warp-specialized
// ---------------------------------------------------------------------------

constexpr int E_WARPS = 16;     // consumers: 4 column groups of 32 x 4 row groups of 32
constexpr int E_THREADS = 32 * (E_WARPS + 1);   // and one producer warp
constexpr int E_TM = 128;       // rows a unit
constexpr int E_TN = 128;       // columns a unit
constexpr int E_STAGES = 3;     // f_t ring
constexpr int E_BUFS = 6;       // staging buffers: up to E_BUFS - 1 stores in flight
constexpr int E_BOX = 64;       // columns a TMA box (128 bytes of bf16)
constexpr int E_FT_BYTES = 32 * E_TN * 2;      // a unit's f_t tile: 2 boxes of 32 k rows
constexpr int E_OUT_BYTES = E_TM * E_TN * 2;   // a unit's output: 2 boxes of 128 rows
// alignment slack, the staging buffers, the ring, its full barriers and
// the staging buffers' staged and freed barriers
constexpr size_t E_SMEM = 1024 + (size_t)E_BUFS * E_OUT_BYTES +
                          (size_t)E_STAGES * E_FT_BYTES + 8 * (E_STAGES + 2 * E_BUFS);
// the shipped launcher's names for them (this design is 32 lanes deep)
template <int FD>
constexpr int E_FT_BYTES_OF = E_FT_BYTES;
template <int FD>
constexpr size_t e_smem() {
  return E_SMEM;
}

"""
_WS_KERNEL = r"""template <int FD>
__global__ __launch_bounds__(E_THREADS, 1) void kb_emit_kernel(
    const __grid_constant__ CUtensorMap ft_map,   // (32, S) aug f_t, 64 x 32 boxes
    const __grid_constant__ CUtensorMap out_map,  // (P, S) out, 64 x 128 boxes
    const bf16* __restrict__ fa,                  // (P, 32) aug
    const bf16* __restrict__ cols,                // (S)
    int nrb, int nct, int S) {
  extern __shared__ unsigned char e_raw[];
  unsigned char* smem = e_raw + ((1024 - (smem_u32(e_raw) & 1023)) & 1023);
  unsigned char* ring = smem + E_BUFS * E_OUT_BYTES;
  const uint32_t full0 = smem_u32(ring + E_STAGES * E_FT_BYTES);  // [E_STAGES] ring stage in
  const uint32_t staged0 = full0 + 8 * E_STAGES;   // [E_BUFS] unit staged by every consumer
  const uint32_t freed0 = staged0 + 8 * E_BUFS;    // [E_BUFS] its store has left the buffer
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long units = (long long)nrb * nct;
  const int t0 = (int)(blockIdx.x * units / gridDim.x);
  const int n = (int)((blockIdx.x + 1) * units / gridDim.x) - t0;   // this block's units
  if (tid == 0) {
    for (int s = 0; s < E_STAGES; ++s) mbar_init(full0 + 8 * s, 1);
    for (int b = 0; b < E_BUFS; ++b) {
      mbar_init(staged0 + 8 * b, E_WARPS);
      mbar_init(freed0 + 8 * b, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == E_WARPS) {
    // the producer: one lane keeps the ring E_STAGES units ahead and drains
    // each staged unit by two TMA stores, at most E_BUFS - 1 in flight
    if (lane == 0) {
      auto load = [&](int q) {   // the f_t tile of the block's unit q
        const int st = q % E_STAGES, col = ((t0 + q) % nct) * E_TN;
        const uint32_t bar = full0 + 8 * st, dst = smem_u32(ring + st * E_FT_BYTES);
        mbar_expect_tx(bar, E_FT_BYTES);
        tma_box(dst, &ft_map, col, 0, bar);
        tma_box(dst + E_FT_BYTES / 2, &ft_map, col + E_BOX, 0, bar);
      };
      for (int q = 0; q < min(E_STAGES, n); ++q) load(q);
      for (int q = 0; q < n; ++q) {
        const int t = t0 + q, b = q % E_BUFS;
        mbar_wait(staged0 + 8 * b, (q / E_BUFS) & 1);   // and its ring stage is read
        const uint32_t src = smem_u32(smem + b * E_OUT_BYTES);
        tma_store(&out_map, src, (t % nct) * E_TN, (t / nct) * E_TM);
        tma_store(&out_map, src + E_OUT_BYTES / 2, (t % nct) * E_TN + E_BOX, (t / nct) * E_TM);
        bulk_commit();
        if (q + E_STAGES < n) load(q + E_STAGES);
        bulk_wait_read<E_BUFS - 2>();   // the stores up to unit q - (E_BUFS - 2) have left
        if (q >= E_BUFS - 2) mbar_arrive(freed0 + 8 * ((q - (E_BUFS - 2)) % E_BUFS));
      }
      bulk_wait_all();
    }
    return;
  }

  // the consumers: warp (wc, wr) forms columns 32 wc .. and rows 32 wr ..
  // of every unit
  const int g = lane >> 2, tq = lane & 3;
  const int wc = warp & 3, wr = warp >> 2;
  const int box = wc >> 1, chunk0 = (wc & 1) * 4;   // its TMA box, first 16-byte chunk
  uint32_t A[2][2][4];   // its 32 sample rows: [m16 tile][k16 step] fragments
  int rb_held = -1;
  for (int q = 0; q < n; ++q) {
    const int t = t0 + q, rb = t / nct, ct = t % nct;
    const int st = q % E_STAGES, b = q % E_BUFS;
    if (rb != rb_held) {   // a new row slice: its A fragments from device memory
      rb_held = rb;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const bf16* p = fa + (size_t)(rb * E_TM + wr * 32 + mt * 16 + g) * FD + 16 * ks + 2 * tq;
          A[mt][ks][0] = ld32(p);
          A[mt][ks][1] = ld32(p + 8 * FD);
          A[mt][ks][2] = ld32(p + 8);
          A[mt][ks][3] = ld32(p + 8 * FD + 8);
        }
    }
    // this lane's columns 2 tq, 2 tq + 1 of each n8 tile, as f32
    float cs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 c = unpack2(ld32(cols + (size_t)ct * E_TN + 32 * wc + 8 * nt + 2 * tq));
      cs[nt][0] = c.x;
      cs[nt][1] = c.y;
    }
    mbar_wait(full0 + 8 * st, (q / E_STAGES) & 1);
    // B fragments of the warp's 32 columns ([n8 tile][k16 step]) by
    // ldmatrix.trans from the swizzled boxes: matrix l / 8 of a load is
    // (k rows 16 ks + 8 (l / 8 % 2) .., chunk chunk0 + 2 np + l / 16)
    uint32_t B[4][2][2];
    const unsigned char* fb = ring + st * E_FT_BYTES + box * (E_FT_BYTES / 2);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int k = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int ch = chunk0 + 2 * np + (lane >> 4);
        uint32_t r[4];
        ldsm_x4_trans(r, reinterpret_cast<const bf16*>(fb + k * 128 + ((ch ^ (k & 7)) << 4)));
        B[2 * np][ks][0] = r[0];
        B[2 * np][ks][1] = r[1];
        B[2 * np + 1][ks][0] = r[2];
        B[2 * np + 1][ks][1] = r[3];
      }
    mbar_wait(freed0 + 8 * b, ((q / E_BUFS) & 1) ^ 1);   // buffer b's last store has left
    unsigned char* stage = smem + b * E_OUT_BYTES + box * (E_OUT_BYTES / 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = wr * 32 + mt * 16 + g;   // rows r0, r0 + 8; r0 & 7 == g
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(c, A[mt][0], B[nt][0]);
        mma16816(c, A[mt][1], B[nt][1]);
        // staged in the TMA box's 128-byte-swizzled layout: the 8 rows a
        // warp writes at once land in 8 distinct 16-byte chunks
        unsigned char* o = stage + (((chunk0 + nt) ^ g) << 4) + tq * 4;
        *reinterpret_cast<uint32_t*>(o + r0 * 128) =
            scale_pair(kb_pair(c[0], c[1]), cs[nt][0], cs[nt][1]);
        *reinterpret_cast<uint32_t*>(o + (r0 + 8) * 128) =
            scale_pair(kb_pair(c[2], c[3]), cs[nt][0], cs[nt][1]);
      }
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) mbar_arrive(staged0 + 8 * b);   // the producer may store it
  }
}

"""
PRODUCER_WARP = [
    (("// ---------------------------------------------------------------------------\n// K7: the column-scaled",
      "// the aug entries of two d2,"), _WS_CONSTS),
    ((_KERNEL, "// every bf16 pattern x (as d2) -> K7's entry bits"), _WS_KERNEL),
]

# name -> (edits of recompute_sweeps.cu, design, timing only); an edit is
# (old, new), or ((start, end), new) for the text from start up to end, and
# must match the source exactly once
VARIANTS = {
    "shipped": ([], "shipped: two 8-warp blocks an SM, 64 x 256 units dealt "
                "round-robin, two staging buffers, a 2-stage ring, kexp on bf16(d2), "
                "TMA stores with an L2 evict-first policy", False),
    "ranges": (RANGES, "each block on a contiguous range of units", False),
    "128x128": (SQUARE, "128 x 128 units, a 3-stage ring", False),
    "128x128 ranges": (SQUARE + RANGES, "128 x 128 units in ranges, a 3-stage ring",
                       False),
    "no hint": (NO_HINT, "the TMA stores without the evict-first policy", False),
    "128x128 ranges no hint": (SQUARE + RANGES + NO_HINT, "the design before the policy",
                               False),
    "table": (TABLE, "the entry from a 65536-pattern table (one block an SM)", False),
    "expf": (EXPF, "the entry by kb_aug's IEEE expf", False),
    "hmul2": (HMUL2, "the scale by one bf16x2 multiply", False),
    "one block": (ONE_BLOCK, "one block an SM", False),
    "stg": (STG, "16-byte st.global from the staging in place of the TMA store", False),
    "stg cs": (STG_CS, "the same with st.global.cs (evict-first)", False),
    "pad rows": (PAD_ROWS, f"the output's rows {PAD} columns longer", False, PAD),
    "bulk rows": (BULK_ROWS, "a 1-D bulk copy a row (512 bytes) from a padded staging, "
                  "in place of the TMA tensor stores", False),
    "store only bulk rows": (STORE_ONLY + BULK_ROWS, "the store alone, a bulk copy a row",
                             True),
    "producer warp": (PRODUCER_WARP, "warp-specialized: a producer warp, 16 consumer "
                      "warps, six staging buffers, 128 x 128 units in ranges, one block "
                      "an SM", False),
    "no entry": (NO_ENTRY, "the entry is bf16(d2)'s bits", True),
    "no store": (NO_STORE, "the TMA stores dropped", True),
    "store only": (STORE_ONLY, "no product, no entry: the store alone", True),
    "store only ranges": (STORE_ONLY + RANGES, "the store alone, units in ranges", True),
    "store only 128x128": (STORE_ONLY + SQUARE + RANGES,
                           "the store alone, 128 x 128 units in ranges", True),
    "store only no hint": (STORE_ONLY + NO_HINT, "the store alone, no policy", True),
    "store only stg": (STORE_ONLY + STG, "the store alone, by st.global", True),
}



def variant_sources(out: Path, parent: Path | None) -> dict:
    """{variant: its directory}, each written under ``out``; a variant whose
    edits do not all match this checkout's source once stops the run."""
    src = (CSRC / SRC).read_text()
    headers = {f.name: f.read_text() for f in CSRC.glob("*.cuh")}
    dirs = {}
    for name, (edits, *_) in VARIANTS.items():
        text = src
        for old, new in edits:
            marks = old if isinstance(old, tuple) else (old,)
            if not all(text.count(m) == 1 for m in marks):
                sys.exit(f"kb_designs: {name}: an edit does not match once")
            if isinstance(old, tuple):
                i, j = text.index(old[0]), text.index(old[1])
                text = text[:i] + new + text[j:]
            else:
                text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / SRC).write_text(text)
        for fname, h in headers.items():
            (d / fname).write_text(h)
        dirs[name] = d
    if parent is not None:
        pc = parent / "graphlap_tpu_torch" / "csrc"
        d = out / "parent"
        d.mkdir(parents=True, exist_ok=True)
        (d / SRC).write_text((pc / SRC).read_text())
        for f in pc.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        dirs["parent"] = d
    return dirs


def build_all(dirs: dict, build) -> dict:
    """Each variant's source into its own shared library, one nvcc a
    variant, all started together: {variant: (library, ptxas log)}."""
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, d in dirs.items()}
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"kb_designs: {name}: nvcc failed:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(dirs[name] / "lib.so"))
        args, res = build._SIGNATURES["glt_kb_strip"]
        lib.glt_kb_strip.argtypes = args
        lib.glt_kb_strip.restype = res
        built[name] = (lib, log)
    return built


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--only", default="")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    parent = Path(args.parent).resolve() if args.parent else None
    dirs = variant_sources(ROOT / "build" / "kb_designs", parent)
    if args.only:
        keep = {n.strip() for n in args.only.split(",")} | {"shipped"}
        dirs = {n: d for n, d in dirs.items() if n in keep}
    if args.dry:
        print(f"kb_designs: variants {list(dirs)}; sources under "
              f"{ROOT / 'build' / 'kb_designs'}")
        return
    if not torch.cuda.is_available():
        sys.exit("kb_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg, _, noisy, plan = cs.make_workload_8mp(gt)
    ctx = ms._strip_ctx(torch.as_tensor(noisy, device=dev),
                        torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg)
    jidx = torch.as_tensor(ms.gram_sample_idx(ctx.n_pad, cfg.gram_coarse,
                                              cfg.gram_jitter_seed),
                           dtype=torch.int64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    kargs = (ctx.fa_aug, ctx.f_t[:, jidx].contiguous(),
             torch.rand(jidx.numel(), generator=gen, device=dev), True)
    del ctx
    ref = k79.kb_strip_plain(*kargs)
    built = build_all(dirs, _build)
    saved = _build._LIB
    rows, shipped_out = {}, None
    try:
        for rep in range(args.reps):
            for name, (lib, log) in built.items():
                _build._LIB = lib
                design, timing_only, *pad = (VARIANTS[name][1:] if name in VARIANTS
                                             else ("the parent's kernel", False))

                def run():
                    if not pad:
                        return k79.kb_strip_cuda(*kargs)
                    fa, f_t, cols = kargs[0], kargs[1], kargs[2].to(torch.bfloat16)
                    p, s = fa.shape[0], f_t.shape[1]
                    o = torch.empty((p, s + pad[0]), dtype=torch.bfloat16, device=dev)
                    _build.check(lib.glt_kb_strip(fa.data_ptr(), f_t.data_ptr(),
                                                  cols.data_ptr(), o.data_ptr(), p, s,
                                                  f_t.shape[0], _build.stream_ptr(fa)),
                                 name)
                    return o[:, :s]

                row = rows.setdefault(name, dict(
                    design=design, timing_only=timing_only, ms=[],
                    ptxas=[ln.strip() for ln in log.splitlines()
                           if "kb_emit" in ln or "registers" in ln or "spill" in ln]))
                if rep == 0:
                    got = run()
                    row["err"] = float((got.float() - ref.float()).abs().max())
                    if name == "shipped":
                        shipped_out = got
                    row["same"] = (None if shipped_out is None
                                   else bool(torch.equal(got, shipped_out)))
                    del got
                row["ms"].append(cs.cuda_ms(run, 10))
                print(f"{name} ({design}): {row['ms'][-1]:.4f} ms, err "
                      f"{row['err']:.3e}, same as shipped {row['same']}", flush=True)
    finally:
        _build._LIB = saved
    out = torch.empty((kargs[0].shape[0], kargs[1].shape[1]), dtype=torch.bfloat16,
                      device=dev)
    fill_ms = [cs.cuda_ms(lambda: out.fill_(1.0), 10) for _ in range(args.reps)]
    print(f"fill_ of the output's shape: {fill_ms} ms", flush=True)
    result = dict(card=card, shape=dict(p_pad=int(kargs[0].shape[0]),
                                        columns=int(kargs[1].shape[1])),
                  fill_ms=fill_ms, variants=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
