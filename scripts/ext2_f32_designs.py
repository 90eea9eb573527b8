"""The f32 K8 (csrc/recompute_sweeps.cu ext2_f32_tile_kernel: the fused
Sinkhorn extension and polish matvec on the f32 layout, an IEEE f32 FFMA
register tile over the live lanes in clusters) as shipped and in other
designs, at the bilateral recipes' 8 MP shapes, on one CUDA card.

    python3 scripts/ext2_f32_designs.py [--only NAMES] [--lanes L,...]
                                        [--reps N] [--parent DIR]
                                        [--out FILE] [--dry]

Variants, each a copy of recompute_sweeps.cu with its constants or a loop
edited, built alone under build/ext2_f32_designs/<variant>/ (one nvcc a
variant, all at once; its registers and spills printed from -Xptxas -v)
and put in front of the package's library while it runs
(scripts/finish_repairs.Overlay):

* ``shipped`` — 256 threads of 8 rows x 16 columns, 64-column tiles in
  clusters of 8 (128 columns in clusters of 16 at 128 lanes), the column
  stages in chunks of at most 32 lanes, each rank's kbt partials pushed
  into every rank's shared memory, one cluster barrier a tile, the norms
  from a pre-pass;
* ``8x8`` — 8 x 8 entries a thread (32-column tiles, 64 at 128 lanes):
  twice the exchanges a column;
* ``8x8 split`` — 8 x 8 entries with the cluster barrier split around the
  next tile's cross (arrive after a tile's partials, wait after the next
  tile's entries: two tiles' entries in registers);
* ``unroll 1``, ``unroll 4`` — as shipped with the cross's lane loop
  not unrolled, or unrolled 4 times (2 shipped);
* ``pull`` — as shipped, each rank reading the others' partials through
  distributed shared memory after the barrier (remote loads on the
  critical path);
* ``no barrier (timing only)``, ``no exchange (timing only)`` — as
  shipped without the cluster barrier a tile, and without the pushes
  too (each rank's s from its own partials; one cluster barrier before
  the exit): what the exchange costs. Their outputs are wrong and not
  checked;
* ``L2 rows`` — at 128 lanes only, clusters of 8 (15 resident: 120 SMs,
  not 112) with 64-column tiles: each rank's 512 rows keep lanes [0, 92)
  in shared memory and read lanes [92, 124) from device memory (L2) every
  tile, four lanes a float4.

With ``--parent DIR`` (another checkout, e.g. the parent commit unpacked
with ``git archive``), that checkout's ext2_matvec_cuda runs in a child
process through its own package and library on the same inputs: the design
this one replaced, timed in turns (parent, designs, designs reversed,
parent).

The inputs are made on the card from a seed
(scripts/coord_matvec_designs.layouts): the bilateral recipes' layouts,
4000 sample rows (p_pad 4096) and N 2^23 columns near them, at d = 3, 27,
51, 83 and 123 (4, 28, 52, 84 and 124 live lanes of 32, 32, 64, 96 and
128), t2 in [0.5, 1.5) on the sample rows, bm 0 on every 7th column. For
each width and design: K8's time (CUDA events, chip_smoke.cuda_ms); on the
first turn, u's and s's largest error over max |plain|, against their
sums in f64 (max and p99 relative error beside the plain f32 version's;
chip_smoke requires at most 1.5x), their shares below f64 (the plain
version's beside them), and a bit-for-bit repeat; once a width, the cuBLAS
composition's time (chip_smoke.k8_f32_composition) and the shipped
kernel's resident clusters x blocks; on the shipped design's second turn,
the card's SM clock and power draw while it runs (nvidia-smi every 50 ms).
--dry writes the variant sources and checks the edits without a card.
Prints the card line and one JSON line.
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
OUT = ROOT / "build" / "ext2_f32_designs"
sys.path.insert(0, str(Path(__file__).resolve().parent))
import coord_matvec_designs as cmd  # noqa: E402  (its seeded layouts)

_C8 = ("constexpr int XF_C = 16;", "constexpr int XF_C = 8;")
# the split cluster barrier (on 8 x 8 entries: two tiles' entries in
# registers): a rank pushes tile i's partials and arrives, forms tile i +
# 1's entries, then waits and adds tile i's u terms; s goes into the
# current stage's bm row, bm comes from device memory
_SPLIT = [
    ("  float e[XF_R][XF_C];           // a tile's crosses over the chunks so far, then its entries\n",
     """  float e[XF_R][XF_C], ep[XF_R][XF_C];   // tile i's crosses, then entries; tile i - 1's
  auto take_s = [&](int i, float* sb) {   // tile i's s into sb
    if (tid < TN) {
      const float* pk = part_s + (i & 1) * G::XCL_MAX * 2 * TN + tid;
      float kbr = 0.f, kbc = 0.f;
#pragma unroll
      for (int q = 0; q < G::XCL_MAX; ++q)
        if (q < xcl) {
          kbr += pk[q * 2 * TN];
          kbc += pk[q * 2 * TN + TN];
        }
      const int j = col0(i) + tid;
      const float s = (j < N ? bm[j] : 0.f) / sqrtf(fmaxf(kbr * kbc, EPS));
      sb[tid] = s;
      if (rank == 0 && j < N) s_out[j] = s;
    }
  };
  auto add_u = [&](int i, const float* sb) {   // tile i's u terms from ep
    float sv[XF_C];
    xf_cols<TX>(sv, sb + 4 * tx);
#pragma unroll
    for (int r = 0; r < XF_R; ++r) {
      float tu = ep[r][0] * sv[0];
#pragma unroll
      for (int c = 1; c < XF_C; ++c) tu = fmaf(ep[r][c], sv[c], tu);
      span[r] += tu;
    }
    if ((i + 1) % XF_SPAN == 0 || i + 1 == mine) {
#pragma unroll
      for (int r = 0; r < XF_R; ++r) {
        U[r] += span[r];
        span[r] = 0.f;
      }
    }
  };
"""),
    ("    __syncthreads();             // the warps' partials in\n",
     """    __syncthreads();             // the warps' partials in
    if (i > 0) {
      cluster_wait();            // every rank's partials of tile i - 1
      take_s(i - 1, sb);
    }
"""),
    ("""    cluster_arrive();            // every rank's partials of tile i in
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
""",
     """    cluster_arrive();            // this rank's partials of tile i out
    if (i > 0) {
      __syncthreads();           // s of tile i - 1 in
      add_u(i - 1, sb);
    }
#pragma unroll
    for (int r = 0; r < XF_R; ++r)
#pragma unroll
      for (int c = 0; c < XF_C; ++c) ep[r][c] = e[r][c];
  }
  cluster_wait();                // the last tile's partials
  __syncthreads();               // everyone done with the s before them
  {
    float* sb = stg + ((steps - 1) & 1) * STAGE + (XF_KC + 1) * TN;
    take_s(mine - 1, sb);
    __syncthreads();
    add_u(mine - 1, sb);
  }
"""),
]
# the partials pulled: each rank keeps its own, and every rank reads the
# others' through distributed shared memory after the barrier
_PULL = [
    ("""      float* dst = part_s + ((i & 1) * G::XCL_MAX + rank) * 2 * TN + tid;
#pragma unroll
      for (int q = 0; q < G::XCL_MAX; ++q)
        if (q < xcl) *cluster.map_shared_rank(dst, q) = v;
""", "      part_s[((i & 1) * G::XCL_MAX + rank) * 2 * TN + tid] = v;\n"),
    ("""          kbr += pk[q * 2 * TN];
          kbc += pk[q * 2 * TN + TN];
""", """          kbr += *cluster.map_shared_rank(pk + q * 2 * TN, q);
          kbc += *cluster.map_shared_rank(pk + q * 2 * TN + TN, q);
"""),
    ("""  // no remote access is left: every push into this block's shared memory
  // came before the last cluster barrier
""", """  cluster_arrive();              // no block leaves while read remotely
  cluster_wait();
"""),
]
# timing only (their outputs are wrong): the exchange's cost. Without the
# barrier a tile (one before the exit keeps the pushes inside live
# blocks), and without the pushes too (each rank's s from its own partials)
_BARRIER = ("""    cluster_arrive();            // every rank's partials of tile i in
    cluster_wait();
""", "")
_EXIT_SYNC = ("""  // no remote access is left: every push into this block's shared memory
  // came before the last cluster barrier
""", """  cluster_arrive();
  cluster_wait();
""")
_NO_PUSH = ("""#pragma unroll
      for (int q = 0; q < G::XCL_MAX; ++q)
        if (q < xcl) *cluster.map_shared_rank(dst, q) = v;
""", "      *dst = v;\n")
# the L2 variant: 512 rows a rank at every depth, lanes past XF_LS read
# from device memory in the cross
_LS = 92
_L2 = [
    ("__host__ __device__ constexpr int xf_rb(int fd) { return fd == 128 ? 256 : 512; }",
     f"__host__ __device__ constexpr int xf_rb(int fd) {{ return 512; }}\n"
     f"constexpr int XF_LS = {_LS};   // row lanes in shared memory"),
    ("  return sizeof(float) * ((size_t)L * rb + 3 * (size_t)rb",
     "  return sizeof(float) * ((size_t)(L < XF_LS ? L : XF_LS) * rb + 3 * (size_t)rb"),
    ("  float* rv_s = fa_s + (size_t)L * RB;          // [3][RB] their norms, t_r, t_c",
     "  const int LS = L < XF_LS ? L : XF_LS;\n"
     "  float* rv_s = fa_s + (size_t)LS * RB;         // [3][RB] their norms, t_r, t_c"),
    ("  for (int c = tid; c < RB * (L / 4); c += XF_THREADS) {",
     "  for (int c = tid; c < RB * (LS / 4); c += XF_THREADS) {"),
    ("""    for (int k = ch == 0 ? 1 : 0; k < nk; ++k)
      xf_lane<TY, TX, false>(e, fa_t + k * RB, fb_t + k * TN);
""", """    for (int k = ch == 0 ? 1 : 0; k < nk && k0 + k < LS; ++k)
      xf_lane<TY, TX, false>(e, fa_t + k * RB, fb_t + k * TN);
    for (int k = k0 < LS ? LS - k0 : 0; k < nk; k += 4) {   // the rows' last lanes from L2
      float4 ar[XF_R];
#pragma unroll
      for (int r = 0; r < XF_R; ++r)
        ar[r] = __ldg(reinterpret_cast<const float4*>(
            fa + (size_t)(r0 + 4 * ty + (r & 3) + 4 * TY * (r >> 2)) * fd + k0 + k));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 b[XF_C / 4];
#pragma unroll
        for (int g = 0; g < XF_C / 4; ++g)
          b[g] = *reinterpret_cast<const float4*>(fb_t + (k + q) * TN + 4 * TX * g);
#pragma unroll
        for (int r = 0; r < XF_R; ++r)
#pragma unroll
          for (int c = 0; c < XF_C; ++c)
            e[r][c] = fmaf(f4at(ar[r], q), f4at(b[c / 4], c & 3), e[r][c]);
      }
    }
"""),
]
# the cross's lane loop unrolled otherwise
_UNROLL = "#pragma unroll 2\n    for (int k = ch == 0 ? 1 : 0; k < nk; ++k)\n"
# name -> (source edits, lanes it runs at (None: all), what)
VARIANTS = {
    "shipped": ([], None, "256 threads of 8 x 16 entries, 64-column tiles (128 at 128 lanes), "
                          "partials pushed to every rank, one cluster barrier a tile"),
    "8x8": ([_C8], None, "8 x 8 entries a thread: 32-column tiles (64 at 128 lanes)"),
    "8x8 split": ([_C8] + _SPLIT, None,
                  "8 x 8 entries, the cluster barrier split around the next tile's cross"),
    "unroll 1": ([(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))], None,
                 "as shipped, the cross's lane loop not unrolled"),
    "unroll 4": ([(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))], None,
                 "as shipped, the cross's lane loop unrolled 4 times"),
    "pull": (_PULL, None, "as shipped, each rank reading the others' partials through "
                          "distributed shared memory after the barrier"),
    "no barrier (timing only)": ([_BARRIER, _EXIT_SYNC], None,
                                 "as shipped without the cluster barrier a tile: its s "
                                 "reads partials that may not have arrived"),
    "no exchange (timing only)": ([_BARRIER, _EXIT_SYNC, _NO_PUSH], None,
                                  "as shipped without the pushes and the barrier: each "
                                  "rank's s from its own partials"),
    "L2 rows": (_L2, (124,), f"clusters of 8 at 128 lanes (64-column tiles): lanes [0, {_LS}) "
                             f"of a rank's 512 rows in shared memory, the rest read from L2 "
                             f"every tile"),
}


def variant_sources(out: Path, only=None) -> dict:
    """{variant: its recompute_sweeps.cu} under ``out``; exits naming the
    first edit that does not match its source exactly once."""
    src = (CSRC / "recompute_sweeps.cu").read_text()
    files = {}
    for name, (edits, _, _) in VARIANTS.items():
        if only and name not in only:
            continue
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"ext2_f32_designs: {name}: an edit does not match once:\n{old}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_").replace(".", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "recompute_sweeps.cu").write_text(text)
        files[name] = d / "recompute_sweeps.cu"
    return files


def inputs(live: int, dev):
    """The seeded 8 MP layouts at ``live`` lanes and K8's vectors: (fa,
    f_t, t2, bm)."""
    fa, f_t, _, _ = cmd.layouts(live, dev)
    g = torch.Generator(device=dev).manual_seed(100 + live)
    t2 = torch.zeros((2, fa.shape[0]), device=dev)
    t2[:, :4000] = 0.5 + torch.rand(2, 4000, generator=g, device=dev)
    bm = torch.ones(f_t.shape[1], device=dev)
    bm[::7] = 0.0
    return fa, f_t, t2, bm


def timed(live: int, x, reps: int, cs) -> float:
    """K8 f32's ms through the imported package's wrapper."""
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    return cs.cuda_ms(lambda: k79.ext2_matvec_cuda(*x, False, live), reps)


def checks(live: int, x, refs, cs) -> dict:
    """The first turn's checks of the package's K8 f32 at ``live``."""
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    got = k79.ext2_matvec_cuda(*x, False, live)
    again = k79.ext2_matvec_cuda(*x, False, live)
    out = dict(repeat_bits=all(torch.equal(a, b) for a, b in zip(got, again)))
    for i, what, keep in ((0, "u", 4000), (1, "s", x[1].shape[1])):
        plain, r64 = refs[0][i][:keep].double(), refs[1][i][:keep]
        g = got[i][:keep].double()

        def stats(y):
            e = ((y - r64).abs() / r64.abs())[r64 != 0]
            return [float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))]
        out[what] = dict(
            vs_plain=float((g - plain).abs().max() / plain.abs().max()),
            f64=stats(g), f64_plain=stats(plain),
            share_below_f64=cs.signed_stats(g, r64, True)["share_below"],
            plain_share_below_f64=cs.signed_stats(plain, r64, True)["share_below"])
    del got, again
    return out


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
            sys.exit(f"ext2_f32_designs: {name}: nvcc failed:\n{log[-4000:]}")
        libs[name] = fr.Overlay(ctypes.CDLL(str(files[name].with_suffix(".so"))), base, bld)
        ptxas[name] = [ln.strip() for kn, ln in cs.ptxas_lines(log)
                       if "ext2_f32_tile_kernel" in kn and ("Used" in ln or "spill" in ln)]
    return libs, ptxas


def child(root: str, lanes, reps: int) -> None:
    """Time another checkout's f32 K8 (its package first on the path)."""
    sys.path.insert(0, root)
    cs = cmd.load_chip_smoke()
    dev = torch.device("cuda", 0)
    from graphlap_tpu_torch.ops import _build
    _build.lib()
    got = {}
    for lv in lanes:
        x = inputs(lv, dev)
        got[str(lv)] = timed(lv, x, reps, cs)
        del x
        torch.cuda.empty_cache()
    print("CHILD " + json.dumps(got), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--lanes", default="124,84,52,28,4")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--parent", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    lanes = [int(x) for x in args.lanes.split(",")]
    if args.child:
        child(args.child, lanes, args.reps)
        return
    only = [s.strip() for s in args.only.split(",") if s.strip()] or None
    files = variant_sources(OUT, only)
    if args.dry:
        print(f"ext2_f32_designs: {len(files)} variant sources under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("ext2_f32_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    cs = cmd.load_chip_smoke()
    spec = importlib.util.spec_from_file_location("finish_repairs",
                                                  ROOT / "scripts" / "finish_repairs.py")
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_recompute as k79

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
                               "--lanes", args.lanes, "--reps", str(args.reps)],
                              capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD ")]
        if proc.returncode or not line:
            sys.exit(f"ext2_f32_designs: the parent's turn failed:\n{proc.stderr[-3000:]}")
        got = json.loads(line[0][6:])
        print(f"parent: {got}", flush=True)
        return got

    rows = {str(lv): dict(designs={}) for lv in lanes}
    parents = [parent_turn()]
    saved = _build._LIB
    try:
        for lv in lanes:
            row = rows[str(lv)]
            x = inputs(lv, dev)
            fd = x[0].shape[1]
            row["resident"] = dict(clusters=_build.lib().glt_ext2_f32_clusters(4096, fd, 1 << 30),
                                   blocks=4096 // (256 if fd == 128 else 512))
            refs = (k79.ext2_matvec_plain(*x), cs.f64_sums(x[0], x[1], "ext2", x[2], x[3]))
            row["library_ms"] = cs.cuda_ms(lambda: cs.k8_f32_composition(*x), 2)
            print(f"{lv} lanes: resident {row['resident']}, library {row['library_ms']:.3f} ms",
                  flush=True)
            names = [n for n in libs if VARIANTS[n][1] is None or lv in VARIANTS[n][1]]
            for rep in range(2):
                for name in (names if rep == 0 else names[::-1]):
                    _build._LIB = libs[name]
                    rec = row["designs"].setdefault(name, dict(what=VARIANTS[name][2], ms=[]))
                    if rep == 0 and not name.endswith("(timing only)"):
                        rec.update(checks(lv, x, refs, cs))
                    if rep == 1 and name == "shipped":   # the clock while it runs
                        ms, rec["card_while_timed"] = cmd.sampled(
                            lambda: timed(lv, x, args.reps, cs))
                        rec["ms"].append(ms)
                    else:
                        rec["ms"].append(timed(lv, x, args.reps, cs))
                    print(f"{lv} lanes [{name}]: {json.dumps(rec)}", flush=True)
            del x, refs
            torch.cuda.empty_cache()
    finally:
        _build._LIB = saved
    parents.append(parent_turn())
    for lv in lanes:
        if parents[0] is not None:
            rows[str(lv)]["parent_ms"] = [x[str(lv)] for x in parents]
    out = dict(card=card, shapes=dict(p_pad=4096, n=2048 * 4096), ptxas=ptxas, rows=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
