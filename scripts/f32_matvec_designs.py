"""The f32 K5/K6 (csrc/recompute_matvec.cu f32_sum_kernel, the split-fp16
cross) as shipped and with the small.small product of the split kept, at
the 8 MP matvec denoise's shapes with NLM 5 x 5 and 7 x 7 patches (32 and
64 feature lanes), on one CUDA card.

    python3 scripts/f32_matvec_designs.py [--reps N] [--out FILE] [--dry]

The shipped cross is big.big + big.small + small.big of features split
into fp16 big and small parts (each vector scaled by 2^-E); it drops
small.small, about 2^-22 of 2^(Ea + Eb) a lane. On a sample's own column
(a pixel against itself) that term is a sum of squares, never negative, so
the kernel's d2 there is above zero and the entry below one: a lean low in
K5's rows, which hold those columns, and not in K6's. The variant ``small
small`` adds the term back (one more mma a k16 step into the corrections'
chain). Each variant is a copy of recompute_matvec.cu with its text edited,
built alone under build/f32_matvec_designs/<variant>/ (finish_repairs.py's
build_all: one nvcc a variant, all at once), in front of the package's
library while it runs. For each variant, patch and turn (--reps, default 2,
variants in turn): K5's and K6's times (CUDA events, chip_smoke.cuda_ms)
and, on the first turn, their largest error over max |plain| and their
leans (chip_smoke.signed_stats) against the plain version and against the
f64 sums (chip_smoke.f64_sums), on the vectors chip_smoke.matvec_cases
makes. --dry writes the variant sources and checks the edits without a
card. Prints the card line and one JSON line; --out writes the JSON.
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
_CORR = """          mma16816h(cr, ab[r][ks], b[ks].z, b[ks].w);
          mma16816h(cr, as[r][ks], b[ks].x, b[ks].y);"""
# {variant: ([(old, new)], what)}
VARIANTS = {
    "shipped": ([], "as shipped"),
    "small small": ([(_CORR, _CORR + "\n          mma16816h(cr, as[r][ks], b[ks].z, b[ks].w);")],
                    "the small.small product kept in the corrections' chain"),
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def variant_sources(out: Path) -> dict:
    """{variant: its recompute_matvec.cu} under ``out``; exits naming the
    first edit that does not match once."""
    files = {}
    text0 = (CSRC / "recompute_matvec.cu").read_text()
    for name, (edits, _) in VARIANTS.items():
        text = text0
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"f32_matvec_designs: {name}: an edit matches {text.count(old)} times")
            text = text.replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "recompute_matvec.cu").write_text(text)
        files[name] = d / "recompute_matvec.cu"
    return files


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    files = variant_sources(ROOT / "build" / "f32_matvec_designs")
    if args.dry:
        print(f"f32_matvec_designs: every edit applies: {list(files)}")
        return
    if not torch.cuda.is_available():
        sys.exit("f32_matvec_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    cs = _load("chip_smoke_checks", ROOT / "chip_smoke.py")
    cs.EXP_RATE = float("inf")   # chip_smoke.bound's exp rate: bounds unused here
    fr = _load("finish_repairs", ROOT / "scripts" / "finish_repairs.py")

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms
    from graphlap_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    libs = fr.build_all(files, _build)
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
            for rep in range(args.reps):
                for vname, lib in libs.items():
                    _build._LIB = lib
                    row = rows.setdefault(f"{vname}, patch {patch}", dict(
                        design=VARIANTS[vname][1], lanes=int(ctx.f_t.shape[0]), ms={}))
                    for name, (kern, _, a, _) in cases.items():
                        row["ms"].setdefault(name, []).append(cs.cuda_ms(lambda: kern(*a), 3))
                        if rep == 0:
                            got = kern(*a)[:keep[name]]
                            ref, r64 = refs[name]
                            row[name] = dict(
                                err=float((got - ref).abs().max() / ref.abs().max()),
                                vs_plain=cs.signed_stats(got, ref, True)["share_below"],
                                vs_f64=cs.signed_stats(got, r64, True)["share_below"],
                                plain_vs_f64=cs.signed_stats(ref, r64, True)["share_below"])
                    print(f"{vname}, patch {patch}: {row}", flush=True)
            del ctx, cases, refs
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
