"""The f32 K5/K6 (csrc/recompute_matvec.cu f32_sum_kernel, the split-fp16
cross) as shipped and in other designs, at the 8 MP matvec denoise's
shapes with NLM 5 x 5 and 7 x 7 patches (32 and 64 feature lanes), on one
CUDA card, with a probe of the entry of a pixel with itself.

    python3 scripts/f32_matvec_designs.py [--reps N] [--out FILE] [--dry]
                                          [--parent DIR]

The shipped kernel splits each scaled feature in three fp16 parts (big,
mid, lo: split3), forms each norm as an f64 sum rounded once to f32, and
adds each tile's sums into its running sums by a compensated (Kahan) add.
The variants:

* ``plain add`` — the shipped kernel with a plain f32 add a tile;
* ``chain norms`` — the shipped split with each norm a sequential f32 FMA
  chain, as before;
* ``ffma cross`` — the IEEE f32 FFMA cross of the coordinate kernel
  (coord_tile_kernel over the layout's depth, its norms FMA chains; the
  shipped library called with ``coords``);
* ``two-part split`` and ``two-part split, f64 norms`` (with ``--parent
  DIR``, a checkout unpacked there whose kernel splits in two, big + fp16
  small, with FMA-chain norms) — that checkout's recompute_matvec.cu, as
  it is and with the shipped norms.

K5 fixes the sample rows and streams every pixel, so each row holds its
own sample pixel's column, whose entry is the largest of the row (d2 =
0, k = 1), where max(d2, 0) would turn any error of d2 one way; and each
row runs 8192 tiles a split, most of them far from the row's few live
entries. The probes tell the two apart: K5 with v = 1 on the sample
pixels' own columns and 0 elsewhere (each row's sum is then its own
entry plus its entries at the other samples' columns), against the plain
version and the f64 sums; and K5's leans with v zeroed on those columns.
Each variant is a copy of recompute_matvec.cu with its text edited,
built alone under build/f32_matvec_designs/<variant>/
(finish_repairs.py's build_all: one nvcc a variant, all at once), in
front of the package's library while it runs. For each variant, patch
and turn (--reps, default 2, variants in turn): K5's and K6's times
(CUDA events, chip_smoke.cuda_ms) and, on the first turn, their largest
error over max |plain|, their leans (chip_smoke.signed_stats) against
the plain version and against the f64 sums (chip_smoke.f64_sums), their
and the plain version's max and p99 relative error against those sums,
on the vectors chip_smoke.matvec_cases makes, and the two probes. --dry
writes the variant sources and checks the edits without a card. Prints
the card line and one JSON line; --out writes the JSON.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "graphlap_tpu_torch" / "csrc"
_KAHAN = ("""      for (int h = 0; h < 2; ++h) {   // compensated (Kahan) add
        const float y = tacc[r][h] - cmp[r][h];
        const float s = acc[r][h] + y;
        cmp[r][h] = (s - acc[r][h]) - y;
        acc[r][h] = s;
      }""", """      for (int h = 0; h < 2; ++h) acc[r][h] += tacc[r][h];""")
_FOLD = ("""      acc[r][h] -= cmp[r][h];
""", "")
# the norms: f64 sums rounded once (shipped) -> sequential f32 FMA chains
_NF = ("""      double s = 0.0;                   // the norm, rounded once (f64 sum)
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const double v = col[(size_t)k * Lf + 8 * h];
        s = fma(v, v, s);
      }
      nf[r][h] = (float)s;""", """      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const float v = col[(size_t)k * Lf + 8 * h];
        s = fmaf(v, v, s);
      }
      nf[r][h] = s;""")
_NS = ("""      float m = 0.f;
      double s = 0.0;
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const float x = raw[k * T_LDS + tid];
        m = fmaxf(m, fabsf(x));
        s = fma((double)x, (double)x, s);
      }
      const int e = vec_exp(m);
      ns_s[tid] = (float)s;""", """      float m = 0.f, s = 0.f;
#pragma unroll 8
      for (int k = 0; k < FD; ++k) {
        const float x = raw[k * T_LDS + tid];
        m = fmaxf(m, fabsf(x));
        s = fmaf(x, x, s);
      }
      const int e = vec_exp(m);
      ns_s[tid] = s;""")
# the same, the other way, on the two-part checkout (its raw stage S)
_PNF = (_NF[1], _NF[0])
_PNS = (_NS[1].replace("raw[k * T_LDS", "S[k * T_LDS"),
        _NS[0].replace("raw[k * T_LDS", "S[k * T_LDS"))
# {variant: ([(old, new)], what)}
VARIANTS = {
    "shipped": ([], "as shipped: the three-part split, each tile's sums join "
                    "the running sums by a compensated add"),
    "plain add": ([_KAHAN, _FOLD], "the three-part split, a plain f32 add a "
                                   "tile"),
    "chain norms": ([_NF, _NS], "the three-part split, each norm a "
                                "sequential f32 FMA chain"),
}
FFMA = "ffma cross"        # the shipped library's coordinate kernel
# --parent's recompute_matvec.cu, as it is and with the shipped norms
PARENTS = {"two-part split": [],
           "two-part split, f64 norms": [_PNF, _PNS]}
DESIGNS = {FFMA: "the IEEE f32 FFMA cross (coord_tile_kernel over the "
                 "layout's depth), FMA-chain norms, plain tile adds",
           "two-part split": "the two-part split (big + fp16 small), "
                             "FMA-chain norms, the design before the "
                             "three-part split",
           "two-part split, f64 norms": "the two-part split with the "
                                        "shipped f64-sum norms"}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_stats(got, ref, r64) -> dict:
    """A probe's K5 rows: the kernel's and the plain version's relative
    error against the f64 sums (mean, and its share below), and the
    kernel's share below the plain version."""
    def rel(x):
        return (x.double() - r64) / r64.abs()
    k, p = rel(got), rel(ref)
    return dict(kernel_mean=float(k.mean()), kernel_below_f64=float((k < 0).double().mean()),
                kernel_max=float(k.abs().max()), plain_mean=float(p.mean()),
                plain_below_f64=float((p < 0).double().mean()), plain_max=float(p.abs().max()),
                kernel_below_plain=float((got < ref).double().mean()),
                kernel_vs_plain=cs_signed(got, ref), kernel_vs_f64=cs_signed(got, r64),
                plain_vs_f64=cs_signed(ref, r64))


def rel_stats(got, r64) -> list:
    """[max, p99] of |got - r64| / |r64| over the outputs (chip_smoke's
    sums_f64_check measure)."""
    d = ((got.double() - r64).abs() / r64.abs())[r64 != 0]
    return [float(d.max()), float(torch.quantile(d[::max(1, d.numel() >> 22)], 0.99))]


def cs_signed(got, ref) -> float:
    """chip_smoke.signed_stats' share below (per entry)."""
    return _CS.signed_stats(got, ref, True)["share_below"]


_CS = None


def variant_sources(out: Path, parent: str = "") -> dict:
    """{variant: its recompute_matvec.cu} under ``out`` (and the parent's,
    from ``parent``'s csrc); exits naming the first edit that does not
    match once."""
    files = {}
    sets = {name: (CSRC, edits) for name, (edits, _) in VARIANTS.items()}
    if parent:
        src = Path(parent) / "graphlap_tpu_torch" / "csrc"
        sets.update({name: (src, edits) for name, edits in PARENTS.items()})
    for name, (csrc, edits) in sets.items():
        text = (csrc / "recompute_matvec.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"f32_matvec_designs: {name}: an edit matches {text.count(old)} times")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_").replace(",", "")
        d.mkdir(parents=True, exist_ok=True)
        for h in csrc.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "recompute_matvec.cu").write_text(text)
        files[name] = d / "recompute_matvec.cu"
    return files


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--parent", default="")
    args = ap.parse_args()
    files = variant_sources(ROOT / "build" / "f32_matvec_designs", args.parent)
    if args.dry:
        print(f"f32_matvec_designs: every edit applies: {list(files)}")
        return
    if not torch.cuda.is_available():
        sys.exit("f32_matvec_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    global _CS
    cs = _CS = _load("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs.EXP_RATE = float("inf")   # chip_smoke.bound's exp rate: bounds unused here
    fr = _load("finish_repairs", ROOT / "scripts" / "finish_repairs.py")

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build
    from graphlap_tpu_torch.ops import cuda_matvec as k56

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = fr.build_all(files, _build)
    libs[FFMA] = libs["shipped"]
    saved = _build._LIB
    rows = {}
    try:
        for patch in (5, 7):
            cfg, _, noisy, plan = cs.make_workload_8mp_matvec(gt, patch)
            ctx = ms._strip_ctx(torch.as_tensor(noisy, device=dev),
                                torch.as_tensor(plan.idx_a.astype(np.int64), device=dev), cfg)
            cases = cs.matvec_cases(ctx, dev, ("matvec", "rmatvec"), {})[0]
            keep = {"matvec": ctx.p, "rmatvec": ctx.n}
            refs = {}
            for name, (_, plain, a, _) in cases.items():
                what = "matvec" if name == "matvec" else "rmatvec"
                refs[name] = (plain(*a)[:keep[name]],
                              cs.f64_sums(a[0], a[1], what, a[2])[:keep[name]])
            # the probes' vectors: 1 on the sample pixels' own columns; the
            # path's v zeroed there
            fa, f_t, v = cases["matvec"][2][:3]
            v_self = torch.zeros_like(v)
            v_self[ctx.idx_a] = 1.0
            v_zero = v.clone()
            v_zero[ctx.idx_a] = 0.0
            probes = {}
            for pname, pv in (("self", v_self), ("zeroed", v_zero)):
                probes[pname] = (pv, k56.matvec_plain(fa, f_t, pv, False)[:ctx.p],
                                 cs.f64_sums(fa, f_t, "matvec", pv)[:ctx.p])
            for rep in range(args.reps):
                for vname, lib in libs.items():
                    _build._LIB = lib
                    coords = vname == FFMA
                    row = rows.setdefault(f"{vname}, patch {patch}", dict(
                        design=VARIANTS[vname][1] if vname in VARIANTS else DESIGNS[vname],
                        lanes=int(ctx.f_t.shape[0]), ms={}))
                    for name, (kern0, _, a, _) in cases.items():
                        kern = (lambda *x, k=kern0: k(*x, None, True)) if coords else kern0
                        row["ms"].setdefault(name, []).append(cs.cuda_ms(lambda: kern(*a), 3))
                        if rep == 0:
                            got = kern(*a)[:keep[name]]
                            ref, r64 = refs[name]
                            row[name] = dict(
                                err=float((got - ref).abs().max() / ref.abs().max()),
                                vs_plain=cs.signed_stats(got, ref, True)["share_below"],
                                vs_f64=cs.signed_stats(got, r64, True)["share_below"],
                                plain_vs_f64=cs.signed_stats(ref, r64, True)["share_below"],
                                f64_rel=rel_stats(got, r64), plain_f64_rel=rel_stats(ref, r64))
                    if rep == 0:
                        for pname, (pv, ref, r64) in probes.items():
                            got = k56.matvec_cuda(fa, f_t, pv, False, None, coords)[:ctx.p]
                            row[f"matvec {pname}"] = probe_stats(got, ref, r64)
                    print(f"{vname}, patch {patch}: {row}", flush=True)
            del ctx, cases, refs, probes, v_self, v_zero
            torch.cuda.empty_cache()
    finally:
        _build._LIB = saved
    result = dict(card=card, variants=rows)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
