"""The coordinate K5/K6 (csrc/recompute_matvec.cu coord_tile_kernel: the
IEEE f32 FFMA cross as an SGEMM-like register tile over the live lanes) as
shipped and in other designs, at the bilateral recipes' 8 MP shapes, on one
CUDA card.

    python3 scripts/coord_matvec_designs.py [--only NAMES] [--lanes L,...]
                                            [--reps N] [--parent DIR]
                                            [--out FILE] [--dry]

Variants, each a copy of recompute_matvec.cu with its constants edited,
built alone under build/coord_matvec_designs/<variant>/ (one nvcc a
variant, all at once, scripts/finish_repairs.build_all) and put in front of
the package's library while it runs (the wrapper's constants set to the
variant's):

* ``shipped`` — 256 threads, a thread 8 fixed x 8 streamed entries (128 x
  128 block tiles), two blocks an SM, up to 4 tiles a stage at 4 lanes, the
  norms from a pre-pass;
* ``8x4`` — 8 fixed x 4 streamed entries a thread (128 x 64 tiles: 3
  float4 loads for 32 FFMA a lane, the f32 K9's cross);
* ``128 threads`` — 8 x 8 entries a thread in 64 x 128 tiles, three
  blocks an SM (12 warps, up to 170 registers);
* ``narrow`` — 4 x 4 entries a thread in 64 x 64 tiles, four blocks an
  SM (32 warps, up to 64 registers);
* ``16x8`` — 16 fixed x 8 streamed entries a thread, 128 threads, 128 x
  128 tiles, two blocks an SM (8 warps, up to 255 registers; 6 float4
  loads for 128 FFMA a lane);
* ``one block`` — as shipped, one block an SM (8 warps, up to 255
  registers);
* ``one tile a step`` — as shipped with one streamed tile a stage at every
  width (the barriers a tile at 4 and 28 lanes);
* ``epilogue by row`` — as shipped with the epilogue one fixed entry's sum
  at a time (the same order of terms; the shipped one advances a
  thread's 8 sums together);
* ``one wave`` — as shipped with the K5 splits filling one wave of the
  resident blocks (8 of the 8 MP K5's 264 slots idle), not four whole
  ones.

With ``--parent DIR`` (another checkout, e.g. the parent commit unpacked
with ``git archive``), that checkout's matvec_cuda and rmatvec_cuda with
``coords`` run in a child process through its own package and library, on
the same inputs: the design this one replaced, timed in turns (parent,
designs, designs reversed, parent).

The inputs are made on the card from a seed (``layouts``): the bilateral
recipes' layouts, 4000 sample rows (p_pad 4096) and N 2^23 columns near
them, at d = 3, 27, 51, 83 and 123 (4, 28, 52, 84 and 124 live lanes of 32,
32, 64, 96 and 128). For each width and design: K5's and K6's times (CUDA
events, chip_smoke.cuda_ms); on the first turn, each output's largest
error over max |plain| (chip_smoke's bar for these rows is 0.1), against
its sum in f64 (max and p99 relative error beside the plain f32
version's; chip_smoke requires at most 1.5x), its share below f64 (the
plain version's beside it), and a bit-for-bit repeat; once a width, the
cuBLAS composition's time (chip_smoke.k56_f32_composition); on the shipped
design's second turn, the card's SM clock and power draw while it runs
(nvidia-smi every 50 ms). --dry writes
the variant sources and checks the edits without a card. Prints the card
line and one JSON line.
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
OUT = ROOT / "build" / "coord_matvec_designs"
D_OF = {4: 3, 28: 27, 52: 51, 84: 83, 124: 123}

_EPI = """        float tacc[CT_R];
#pragma unroll
        for (int r = 0; r < CT_R; ++r) tacc[r] = kf32(nfv[r] + nsv[0], cr[r][0]) * wv[0];
#pragma unroll
        for (int c = 1; c < CT_C; ++c)
#pragma unroll
          for (int r = 0; r < CT_R; ++r)
            tacc[r] = fmaf(kf32(nfv[r] + nsv[c], cr[r][c]), wv[c], tacc[r]);
#pragma unroll
        for (int r = 0; r < CT_R; ++r) acc[r] += tacc[r];
"""
# a fixed entry's sum at a time (the same order of terms)
_EPI_ROW = """#pragma unroll
        for (int r = 0; r < CT_R; ++r) {
          float tacc = kf32(nfv[r] + nsv[0], cr[r][0]) * wv[0];
#pragma unroll
          for (int c = 1; c < CT_C; ++c)
            tacc = fmaf(kf32(nfv[r] + nsv[c], cr[r][c]), wv[c], tacc);
          acc[r] += tacc;
        }
"""
# name -> (source edits, the wrapper's constants, what)
VARIANTS = {
    "shipped": ([], {}, "256 threads of 8 x 8 entries, 128 x 128 tiles, two blocks an "
                        "SM, the K5 splits in whole waves"),
    "8x4": ([("constexpr int CT_C = 8;", "constexpr int CT_C = 4;")], {"COORD_STREAM": 64},
            "8 x 4 entries a thread, 128 x 64 tiles"),
    "128 threads": ([("constexpr int CT_TY = 16;", "constexpr int CT_TY = 8;"),
                     ("constexpr int CT_BLOCKS_SM = 2;", "constexpr int CT_BLOCKS_SM = 3;")],
                    {"COORD_FIXED": 64}, "128 threads of 8 x 8 entries, 64 x 128 tiles, "
                                         "three blocks an SM"),
    "narrow": ([("constexpr int CT_R = 8;", "constexpr int CT_R = 4;"),
                ("constexpr int CT_C = 8;", "constexpr int CT_C = 4;"),
                ("constexpr int CT_BLOCKS_SM = 2;", "constexpr int CT_BLOCKS_SM = 4;")],
               {"COORD_FIXED": 64, "COORD_STREAM": 64},
               "256 threads of 4 x 4 entries, 64 x 64 tiles, four blocks an SM"),
    "16x8": ([("constexpr int CT_R = 8;", "constexpr int CT_R = 16;"),
              ("constexpr int CT_TY = 16;", "constexpr int CT_TY = 8;")],
             {}, "128 threads of 16 x 8 entries, 128 x 128 tiles, two blocks an SM (6 "
                 "float4 loads for 128 FFMA a lane)"),
    "one block": ([("constexpr int CT_BLOCKS_SM = 2;", "constexpr int CT_BLOCKS_SM = 1;")],
                  {}, "as shipped, one block an SM (up to 255 registers)"),
    "one tile a step": ([("constexpr int CT_TPS = 4;", "constexpr int CT_TPS = 1;")],
                        {}, "as shipped, one streamed tile a stage"),
    "epilogue by row": ([(_EPI, _EPI_ROW)], {},
                        "as shipped, the epilogue a fixed entry's sum at a time"),
    "one wave": ([], {"COORD_WAVES": 1}, "as shipped, the K5 splits in one wave (8 of "
                                         "the 8 MP K5's 264 slots idle)"),
}


def variant_sources(out: Path, only=None) -> dict:
    """{variant: its recompute_matvec.cu} under ``out``; exits naming the
    first edit that does not match its source exactly once."""
    src = (CSRC / "recompute_matvec.cu").read_text()
    files = {}
    for name, (edits, _, _) in VARIANTS.items():
        if only and name not in only:
            continue
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"coord_matvec_designs: {name}: an edit does not match once:\n{old}")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "mma_common.cuh").write_text((CSRC / "mma_common.cuh").read_text())
        (d / "recompute_matvec.cu").write_text(text)
        files[name] = d / "recompute_matvec.cu"
    return files


def layouts(live: int, dev):
    """The seeded 8 MP inputs at ``live`` lanes: (fa, f_t, v, t). Sample
    rows: d - 2 value lanes in [0, 5), then row / 8 and col / 8 of a 2048 x
    4096 image; columns: a random sample row's features with its value
    lanes moved by up to 0.5 / sqrt(d - 2) and its pixel by up to 32 in
    each direction (scripts/f32_colstats_designs.py's layouts)."""
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
    v = 0.5 + rnd(n)
    t = torch.zeros(p_pad, device=dev)
    t[:p] = 0.5 + rnd(p)
    return fa, f_t, v, t


def timed(live: int, x, reps: int, cs) -> dict:
    """K5's and K6's ms through the imported package's wrappers."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    fa, f_t, v, t = x
    return {"k5": cs.cuda_ms(lambda: k56.matvec_cuda(fa, f_t, v, False, live, True), reps),
            "k6": cs.cuda_ms(lambda: k56.rmatvec_cuda(fa, f_t, t, False, live, True), reps)}


def sampled(fn):
    """fn()'s result and the card's SM clock (MHz) and power draw (W)
    sampled every 50 ms while it runs (nvidia-smi): (result, dict of
    their mean, min and max)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
    rows = []
    for ln in proc.communicate()[0].splitlines():
        try:
            rows.append([float(v) for v in ln.split(",")])
        except ValueError:
            pass
    stats = {}
    for i, key in enumerate(("sm_mhz", "power_w")):
        vals = [r[i] for r in rows]
        if vals:
            stats[key] = dict(mean=sum(vals) / len(vals), min=min(vals), max=max(vals),
                              samples=len(vals))
    return out, stats


def references(x, cs) -> dict:
    """Per kernel: (plain f32 output, f64 sums, kept outputs)."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    fa, f_t, v, t = x
    return {"k5": (k56.matvec_plain(fa, f_t, v), cs.f64_sums(fa, f_t, "matvec", v), 4000),
            "k6": (k56.rmatvec_plain(fa, f_t, t), cs.f64_sums(fa, f_t, "rmatvec", t),
                   f_t.shape[1])}


def checks(live: int, x, refs: dict, cs) -> dict:
    """The first turn's checks of the package's K5/K6 at ``live``."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    fa, f_t, v, t = x
    out = {}
    for name, fn, vec in (("k5", k56.matvec_cuda, v), ("k6", k56.rmatvec_cuda, t)):
        got = fn(fa, f_t, vec, False, live, True)
        again = fn(fa, f_t, vec, False, live, True)
        plain, r64, keep = refs[name]
        g, pl, r = got[:keep].double(), plain[:keep].double(), r64[:keep]

        def stats(y):
            e = ((y - r).abs() / r.abs())[r != 0]
            return [float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))]
        out[name] = dict(
            repeat_bits=bool(torch.equal(got, again)),
            vs_plain=float((g - pl).abs().max() / pl.abs().max()),
            f64=stats(g), f64_plain=stats(pl),
            share_below_f64=cs.signed_stats(g, r, True)["share_below"],
            plain_share_below_f64=cs.signed_stats(pl, r, True)["share_below"])
        del got, again
    return out


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def child(root: str, lanes, reps: int) -> None:
    """Time another checkout's coordinate K5/K6 (its package first on the
    path)."""
    sys.path.insert(0, root)
    cs = load_chip_smoke()
    dev = torch.device("cuda", 0)
    from graphlap_tpu_torch.ops import _build
    _build.lib()
    got = {}
    for lv in lanes:
        x = layouts(lv, dev)
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
        print(f"coord_matvec_designs: {len(files)} variant sources under {OUT}")
        return
    if not torch.cuda.is_available():
        sys.exit("coord_matvec_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    cs = load_chip_smoke()
    spec = importlib.util.spec_from_file_location("finish_repairs",
                                                  ROOT / "scripts" / "finish_repairs.py")
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_matvec as k56

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
            sys.exit(f"coord_matvec_designs: the parent's turn failed:\n{proc.stderr[-3000:]}")
        got = json.loads(line[0][6:])
        print(f"parent: {got}", flush=True)
        return got

    rows = {str(lv): dict(designs={}) for lv in lanes}
    parents = [parent_turn()]
    consts = ("COORD_FIXED", "COORD_STREAM", "COORD_WAVES")
    saved = _build._LIB, {c: getattr(k56, c) for c in consts}
    try:
        for lv in lanes:
            row = rows[str(lv)]
            x = layouts(lv, dev)
            refs = references(x, cs)
            row["library_ms"] = {
                "k5": cs.cuda_ms(lambda: cs.k56_f32_composition(*x[:3], False), 2),
                "k6": cs.cuda_ms(lambda: cs.k56_f32_composition(x[0], x[1], x[3], True), 2)}
            print(f"{lv} lanes: library {row['library_ms']}", flush=True)
            for rep in range(2):
                for name in (list(libs) if rep == 0 else list(libs)[::-1]):
                    _build._LIB = libs[name]
                    for c, val in {**saved[1], **VARIANTS[name][1]}.items():
                        setattr(k56, c, val)
                    rec = row["designs"].setdefault(name, dict(what=VARIANTS[name][2], ms=[]))
                    if rep == 0 and not name.startswith("no "):
                        rec.update(checks(lv, x, refs, cs))
                    if rep == 1 and name == "shipped":   # the clock while it runs
                        ms, rec["card_while_timed"] = sampled(
                            lambda: timed(lv, x, args.reps, cs))
                        rec["ms"].append(ms)
                    else:
                        rec["ms"].append(timed(lv, x, args.reps, cs))
                    print(f"{lv} lanes [{name}]: {json.dumps(rec)}", flush=True)
            del x, refs
            torch.cuda.empty_cache()
    finally:
        _build._LIB = saved[0]
        for c, val in saved[1].items():
            setattr(k56, c, val)
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
