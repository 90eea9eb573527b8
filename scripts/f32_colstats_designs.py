"""The f32 K9 / K10 (csrc/colstats_v.cu colstats_tc_kernel: each tile entry
formed once, an FFMA cross, V and K9's ks on the tensor cores in three bf16
parts) as shipped and in other designs, at the bilateral recipes' 8 MP
shapes, on one CUDA card.

    python3 scripts/f32_colstats_designs.py [--only NAMES] [--lanes L,...]
                                            [--reps N] [--parent DIR]
                                            [--out FILE] [--dry]

Variants, each a copy of colstats_v.cu with its text edited, built alone
under build/f32_colstats_designs/<variant>/ (one nvcc a variant, all at
once, scripts/finish_repairs.build_all) and put in front of the package's
library while it runs:

* ``pipelined`` — stage s - 1's V and ks products in one basic block with
  stage s's cross (B's parts in a ring of three stages), for the compiler
  to interleave the HMMA and the FFMA (the shipped kernel runs a stage's
  products after its own entries);
* ``one tile`` — one 16-column tile a warp, not two (a thread's 16 entries
  a stage, not 32; 128-column block tiles);
* ``split cross`` — the cross on the tensor cores too: fa split by a
  pre-pass and each tile's f_t columns when the tile begins into three bf16
  parts on the grid of each row / column over its lanes, six part products
  (a0 b0 in 32-lane chains, exact); the f32 section of
  scripts/f32_colstats_split_cross.cu in place of the shipped one;
* ``split cross 8`` — the same keeping a1 b2 and a2 b1 (eight products);
* ``no cross`` (timing only) — no cross (the entries exp(-(na + nb))): V,
  ks, the exp and the split as shipped.

With ``--parent DIR`` (another checkout, e.g. the parent commit unpacked
with ``git archive``), that checkout's finish_colstats_cuda and
colstats_v_cuda run in a child process through its own package and
library, on the same inputs: the design this one replaced, timed in turns
(parent, shipped, ..., shipped, parent).

The inputs are made on the card from a seed (``layouts``): the
bilateral recipes' layouts, 4000 sample rows (p_pad 4096) and N 2^23
columns near them, at d = 3, 27, 51, 83 and 123 (4, 28, 52, 84 and 124 live lanes of 32, 32, 64, 96 and 128). For
each width and design: K9's and K10's times (CUDA events,
chip_smoke.cuda_ms); on the first turn, over an even subset of 2^18
columns, V's largest error over max |plain V| (the kernels' bar is 2e-4),
V against the sums in f64 relative to the f64 sum of its terms'
magnitudes (max and p99, beside the plain f32 version's) and its share
below f64, K9's s against f64 likewise, the tile against f64 (K10 with a
one-hot gr, so V_jm = k(row_m, j), on 64 sample rows: max and p99 |dK|
over the entries with f64 K > 1e-6, beside the plain version's), and a
bit-for-bit repeat. --dry writes the variant sources and checks the edits
without a card. Prints the card line and one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
OUT = ROOT / "build" / "f32_colstats_designs"
SPLIT = ROOT / "scripts" / "f32_colstats_split_cross.cu"
SECTION = ("// ---------------------------------------------------------------------------\n"
           "// f32 layouts")
SECTION_END = "// how many V-pass blocks for width MP and fd lanes fit the card at once"
D_OF = {4: 3, 28: 27, 52: 51, 84: 83, 124: 123}

_CHAIN8 = ("              mma_tc(corr[i], af[0], b20, b21);\n")
SPLIT8 = [(_CHAIN8, _CHAIN8 + "              mma_tc(corr[i], af[1], b20, b21);\n"
           "              mma_tc(corr[i], af[2], b10, b11);\n")]
_LOOP_OLD = """    int er[VT_CT][2];   // the running sums' exponents
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
"""
# stage s - 1's products before stage s's cross, in one basic block (B's
# parts in a ring of 3 stages; the ring's third stage zeroed, as it is read
# times zero before its first load)
_LOOP_PIPE = """    int er[VT_CT][2], es[VT_CT][2];
    uint32_t kp[VT_CT][3][2][4];
#pragma unroll
    for (int ct = 0; ct < VT_CT; ++ct) {
      er[ct][0] = er[ct][1] = es[ct][0] = es[ct][1] = -126;
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) kp[ct][p][k][r] = 0u;
    }
    for (int s = 0; s < nst; ++s, ++step) {
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < nst)
        vt_load_stage<LV, KS>(vt_smem, a, step + 1, (s + 1) * VT_TP);
      else if (tile + (int)gridDim.x < ntiles)
        vt_load_stage<LV, KS>(vt_smem, a, step + 1, 0);
      vt_products<NB>(run, er, kp, es, b_lane + ((step + 2) % 3) * (S::B_STAGE / 2));
      float cr[VT_CT][4][4];
      vt_cross<LV>(cr, reinterpret_cast<const float*>(vt_smem + S::OFF_FA +
                                                      (step & 1) * S::FA_STAGE),
                   ft_s, fcol, c0, tq);
#pragma unroll
      for (int ct = 0; ct < VT_CT; ++ct)
        vt_entries(kp[ct], es[ct], cr[ct], na_s + (step & 1) * VT_TP, nbv[ct], tq);
    }
    vt_products<NB>(run, er, kp, es, b_lane + ((step + 2) % 3) * (S::B_STAGE / 2));
"""
PIPELINED = [
    (_LOOP_OLD, _LOOP_PIPE),
    ("  static constexpr size_t OFF_NA = OFF_B + 2 * B_STAGE;",
     "  static constexpr size_t OFF_NA = OFF_B + 3 * B_STAGE;"),
    ("  float* d = reinterpret_cast<float*>(smem + S::OFF_FA + buf * S::FA_STAGE);",
     "  float* d = reinterpret_cast<float*>(smem + S::OFF_FA + (buf & 1) * S::FA_STAGE);"),
    ("  bf16* bd = reinterpret_cast<bf16*>(smem + S::OFF_B + buf * S::B_STAGE);",
     "  bf16* bd = reinterpret_cast<bf16*>(smem + S::OFF_B + (buf % 3) * S::B_STAGE);"),
    ("    float* nd = reinterpret_cast<float*>(smem + S::OFF_NA) + buf * VT_TP;",
     "    float* nd = reinterpret_cast<float*>(smem + S::OFF_NA) + (buf & 1) * VT_TP;"),
    ("  for (int i = tid; i < VT_WARPS * 2 * VF_MP; i += VT_THREADS) wp_s[i] = 0.f;\n",
     "  for (int i = tid; i < VT_WARPS * 2 * VF_MP; i += VT_THREADS) wp_s[i] = 0.f;\n"
     "  for (int i = tid; i < (int)(S::B_STAGE / 16); i += VT_THREADS)\n"
     "    reinterpret_cast<uint4*>(vt_smem + S::OFF_B + 2 * S::B_STAGE)[i] = make_uint4(0, 0, 0, 0);\n"),
]
NO_CROSS = [("""      vt_cross<LV>(cr, reinterpret_cast<const float*>(vt_smem + S::OFF_FA + buf * S::FA_STAGE),
                   ft_s, fcol, c0, tq);
""", "      for (auto& q : cr) for (auto& r : q) for (float& x : r) x = 0.f;\n")]

# name -> (edits, whether on the split-cross section, what)
VARIANTS = {
    "shipped": ([], False, "shipped: the FFMA cross, then V and ks as six bf16 part "
                           "products"),
    "pipelined": (PIPELINED, False, "a stage's products beside the next stage's cross"),
    "one tile": ([("constexpr int VT_CT = 2;", "constexpr int VT_CT = 1;")], False,
                 "one 16-column tile a warp (128-column block tiles)"),
    "split cross": ([], True, "the cross on the tensor cores too, six part products"),
    "split cross 8": (SPLIT8, True, "the split cross keeping a1 b2 and a2 b1 (eight products)"),
    "no cross": (NO_CROSS, False, "timing only: no cross"),
}


def variant_sources(out: Path, only=None) -> dict:
    """{variant: its colstats_v.cu} under ``out``; exits naming the first
    edit that does not match its source exactly once."""
    src = (CSRC / "colstats_v.cu").read_text()
    a, b = src.index(SECTION), src.index(SECTION_END)
    split = src[:a] + SPLIT.read_text() + "\n" + src[b:]
    files = {}
    for name, (edits, on_split, _) in VARIANTS.items():
        if only and name not in only:
            continue
        text = split if on_split else src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"f32_colstats_designs: {name}: an edit does not match once:\n{old}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "mma_common.cuh").write_text((CSRC / "mma_common.cuh").read_text())
        (d / "colstats_v.cu").write_text(text)
        files[name] = d / "colstats_v.cu"
    return files


def layouts(live: int, dev):
    """The seeded 8 MP inputs at ``live`` lanes: (fa, f_t, K9's args, K10's
    args). Sample rows: d - 2 value lanes in [0, 5), then row / 8 and col /
    8 of a 2048 x 4096 image; columns: a random sample row's features with
    its value lanes moved by up to 0.5 / sqrt(d - 2) and its pixel by up to
    32 in each direction (so tiles live, as tests/test_torch_bilateral.py's
    _card_layouts makes them)."""
    from graphlap_tpu_torch.ops import recompute_layout as rl

    d = D_OF[live]
    p, n = 4000, 2048 * 4096
    fd, p_pad = rl.d_pad_of(d), rl.p_tiling(p)[1]
    g = torch.Generator(device=dev).manual_seed(live)
    rnd = lambda *s: torch.rand(*s, generator=g, device=dev)  # noqa: E731
    fa = torch.zeros((p_pad, fd), device=dev)
    fa[:p, :d - 2] = rnd(p, d - 2) * 5
    fa[:p, d - 2] = torch.floor(rnd(p) * 2048) / 8.0
    fa[:p, d - 1] = torch.floor(rnd(p) * 4096) / 8.0
    f_t = torch.zeros((fd, n), device=dev)
    base = torch.floor(rnd(n) * p).long()
    f_t[:d] = fa[base, :d].T
    f_t[:d - 2] += (2 * rnd(d - 2, n) - 1) * (0.5 / (d - 2) ** 0.5)
    f_t[d - 2:d] += torch.floor(rnd(2, n) * 65 - 32) / 8.0
    del base
    gr = torch.zeros((p_pad, 64), device=dev)
    gr[:p, :50] = (rnd(p, 50) - 0.5) * 0.02
    y, cols, s_pre = rnd(n), 0.5 + rnd(n), 0.5 + rnd(n)
    bm = (rnd(n) > 0.1).float()
    na, nb = (fa * fa).sum(1), (f_t * f_t).sum(0)
    tv = torch.zeros(p_pad, device=dev)
    tv[:p] = 0.5 + rnd(p)
    return (fa, f_t, (fa, f_t, tv, s_pre * bm, bm, gr, y, na, nb),
            (fa, f_t, gr, y, cols, na, nb))


def timed(live: int, reps: int, dev, cs) -> dict:
    """K9's and K10's ms through the imported package's wrappers."""
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    _, _, a9, a10 = layouts(live, dev)
    out = {}
    for name, fn, a in (("k9", k79.finish_colstats_cuda, a9),
                        ("k10", k79.colstats_v_cuda, a10)):
        out[name] = cs.cuda_ms(lambda: fn(*a, live=live), reps)
    del a9, a10
    torch.cuda.empty_cache()
    return out


def checks(live: int, dev, cs, sub_cols: int = 1 << 18) -> dict:
    """The first turn's checks of the package's K9 / K10 at ``live``."""
    from graphlap_tpu_torch.ops import cuda_recompute as k79

    fa, f_t, a9, a10 = layouts(live, dev)
    n = f_t.shape[1]
    cols = torch.arange(0, n, n // sub_cols, device=dev)
    out = {}
    for name, fn, pl, a in (("k9", k79.finish_colstats_cuda, k79.finish_colstats_plain, a9),
                            ("k10", k79.colstats_v_cuda, k79.colstats_v_plain, a10)):
        got = fn(*a, live=live)
        again = fn(*a, live=live)
        rec = dict(repeat_bits=all(torch.equal(x, y) for x, y in zip(got, again)))
        del again
        # the same function on the column subset (columns are independent)
        sub = list(a)
        sub[1] = f_t[:, cols].contiguous()
        col_args = (3, 4, 6, 8) if name == "k9" else (3, 4, 6)
        for i in col_args:
            sub[i] = a[i][cols]
        ref = pl(*sub)
        v, vr = got[0][cols][:, :50], ref[0][:, :50]
        rec["v_err"] = float((v - vr).abs().max() / vr.abs().max())
        if name == "k9":
            v64, terms, s64 = cs.f64_sums(fa, sub[1], "finish", a[5], a[2], sub[3], sub[4])
        else:
            v64, terms = cs.f64_sums(fa, sub[1], "colstats", a[2], sub[4])
            s64 = None

        def stats(x, r64, sc):
            keep = sc > 0
            e = ((x.double() - r64).abs() / sc)[keep]
            return [float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))]
        rec["v_f64"] = stats(v, v64[:, :50], terms[:, :50])
        rec["v_f64_plain"] = stats(vr, v64[:, :50], terms[:, :50])
        rec["v_share_below_f64"] = cs.signed_stats(v, v64[:, :50], False)["share_below"]
        if s64 is not None:
            s, sr = got[3][cols], ref[3]
            rec["s_f64"] = stats(s, s64, s64.abs())
            rec["s_f64_plain"] = stats(sr, s64, s64.abs())
            rec["s_share_below_f64"] = cs.signed_stats(s, s64, True)["share_below"]
        out[name] = rec
        del got, ref, v64, terms, s64, sub
        torch.cuda.empty_cache()
    # the tile: K10 with a one-hot gr and c = 1 writes V_jm = k(row_m, j)
    p_pad = fa.shape[0]
    rows = torch.linspace(0, 3999, 64, device=dev).long()
    gr = torch.zeros((p_pad, 64), device=dev)
    gr[rows, torch.arange(64, device=dev)] = 1.0
    one = torch.ones(n, device=dev)
    na, nb = a10[5], a10[6]
    got = k79.colstats_v_cuda(fa, f_t, gr, one, one, na, nb, live=live)[0][cols].T
    ft_c = f_t[:, cols].contiguous()
    pl = k79.colstats_v_plain(fa, ft_c, gr, one[cols], one[cols], na, nb[cols])[0].T
    ref64 = cs.f64_tile(fa, ft_c, rows)
    live_k = ref64 > 1e-6

    def tstats(x):
        e = (x.double() - ref64)[live_k].abs()
        return [float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))]
    out["tile_f64"], out["tile_f64_plain"] = tstats(got), tstats(pl)
    out["tile_live"] = int(live_k.sum())
    del fa, f_t, a9, a10, got, pl, ref64
    torch.cuda.empty_cache()
    return out


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def child(root: str, lanes, reps: int) -> None:
    """Time another checkout's K9 / K10 (its package first on the path)."""
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    dev = torch.device("cuda", 0)
    from graphlap_tpu_torch.ops import _build
    _build.lib()
    print("CHILD " + json.dumps({str(lv): timed(lv, reps, dev, cs) for lv in lanes}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--lanes", default="4,28,52,84,124")
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
        print(f"f32_colstats_designs: {len(files)} variant sources under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("f32_colstats_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    cs = load_chip_smoke()
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
    libs = fr.build_all(files, _build)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def parent_turn():
        if not args.parent:
            return None
        proc = subprocess.run([sys.executable, __file__, "--child", str(Path(args.parent).resolve()),
                               "--lanes", args.lanes, "--reps", str(args.reps)],
                              capture_output=True, text=True)
        line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD ")]
        if proc.returncode or not line:
            sys.exit(f"f32_colstats_designs: the parent's turn failed:\n{proc.stderr[-3000:]}")
        got = json.loads(line[0][6:])
        print(f"parent: {got}", flush=True)
        return got

    rows = {str(lv): dict(designs={}) for lv in lanes}
    parents = [parent_turn()]
    saved = _build._LIB
    try:
        for rep in range(2):
            for name in (list(libs) if rep == 0 else list(libs)[::-1]):
                _build._LIB = libs[name]
                for lv in lanes:
                    row = rows[str(lv)]["designs"].setdefault(
                        name, dict(what=VARIANTS[name][2], ms=[]))
                    if rep == 0 and not name.startswith("no "):
                        row.update(checks(lv, dev, cs))
                    row["ms"].append(timed(lv, args.reps, dev, cs))
                    print(f"{lv} lanes [{name}]: {json.dumps(row)}", flush=True)
    finally:
        _build._LIB = saved
    parents.append(parent_turn())
    for lv in lanes:
        if parents[0] is not None:
            rows[str(lv)]["parent_ms"] = [x[str(lv)] for x in parents]
    out = dict(card=card, shapes=dict(p_pad=4096, n=2048 * 4096), rows=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
