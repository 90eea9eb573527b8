"""The V pass of K9/K10 (csrc/colstats_v.cu) at other span lengths, at the
8 MP turbo recipe's shapes: time, error and lean against the plain version.

    python3 scripts/v_designs.py [--out build/v_designs.json] [--seeds 1 2 3]

V sums over p on the tensor cores, whose f32 accumulation rounds toward
zero, so the pass sums in spans of V_FLUSH stages (64 rows each) from a zero
accumulator and adds each span to a running V in shared memory. The kernel
library holds one span length. This script copies the sources into
build/v_designs/span_<k>/, rewrites that one constant to 2, 4 (the shipped
value), 8 and 4096 (one span over all of p: the numerics before spans),
builds each copy with the package's own nvcc recipe and loads it in place
of the package's library. For each span and seed it runs K10 (colstats_v)
and K9 (finish_colstats, whose V pass is K10's) on the turbo path's strip
layouts, with V's eigenvector block and the column scales from a seeded
generator: the time (CUDA events, chip_smoke.cuda_ms), V's largest error
over max |V|, V's share below its plain version (chip_smoke.signed_stats;
chip_smoke.py requires it in (0.25, 0.75)), and whether two launches agree
bit for bit. Prints the card line and one JSON line.
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
SPANS = {2: "spans of 2 stages", 4: "spans of 4 stages (shipped)",
         8: "spans of 8 stages", 4096: "one span over all of p"}
FLUSH_LINE = "constexpr int V_FLUSH = 4;"


def variant_lib(build, span: int):
    """The kernel library built from the sources with V_FLUSH = span."""
    src = ROOT / "graphlap_tpu_torch" / "csrc"
    text = (src / "colstats_v.cu").read_text()
    if text.count(FLUSH_LINE) != 1:
        sys.exit(f"v_designs: '{FLUSH_LINE}' not found once in colstats_v.cu")
    out = ROOT / "build" / "v_designs" / f"span_{span}"
    (out / "csrc").mkdir(parents=True, exist_ok=True)
    for f in [*src.glob("*.cu"), *src.glob("*.cuh")]:
        (out / "csrc" / f.name).write_text(f.read_text())
    (out / "csrc" / "colstats_v.cu").write_text(
        text.replace(FLUSH_LINE, f"constexpr int V_FLUSH = {span};"))
    build.CSRC, build.BUILD_DIR, build._LIB = out / "csrc", out, None
    return build.lib()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "v_designs.json"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("v_designs: no CUDA card")
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks",
                                                  ROOT / "chip_smoke.py")
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
    cfg, _, noisy, plan = cs.make_workload_8mp_turbo(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    p, n = ctx.p, ctx.n_pad
    pp, nk = ctx.fa_pad.shape[0], ctx.f_t.shape[1]
    mk = ms._m_kernel(cfg.num_eigvecs)
    na, nb = ms._sq_norms_pad(ctx)
    y = torch.zeros(nk, device=dev)
    y[:ctx.n] = img_d.reshape(-1)
    bm = torch.zeros(nk, device=dev)
    bm[:n] = ctx.b_mask

    cases = {}                 # (kernel, seed) -> (cuda fn, args, plain V)
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        rand = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
        gr = torch.zeros((pp, mk), device=dev)
        gr[:p, :cfg.num_eigvecs] = (rand(p, cfg.num_eigvecs) - 0.5) * 0.02
        cols = (0.5 + rand(nk)) * bm
        tv = torch.zeros(pp, device=dev)
        tv[:p] = 0.5 + rand(p)
        s_pre = (0.5 + rand(nk)) * bm
        k10 = (ctx.fa_pad, ctx.f_t, gr, y, cols, na, nb)
        k9 = (ctx.fa_pad, ctx.f_t, tv, s_pre, bm, gr, y, na, nb)
        cases["colstats_v", seed] = (
            k79.colstats_v_cuda, k10, k79.colstats_v_plain(*k10)[0][:n])
        cases["finish_colstats", seed] = (
            k79.finish_colstats_cuda, k9, k79.finish_colstats_plain(*k9)[0][:n])

    saved = _build.CSRC, _build.BUILD_DIR, _build._LIB
    rows = {}
    try:
        for span, what in SPANS.items():
            lib = variant_lib(_build, span)
            for (name, seed), (kern, kargs, ref) in cases.items():
                got, again = kern(*kargs), kern(*kargs)
                row = dict(
                    ms=cs.cuda_ms(lambda: kern(*kargs), 5),
                    v_rel=float((got[0][:n] - ref).abs().max()
                                / ref.abs().max()),
                    repeats=all(torch.equal(a, b) for a, b in zip(got, again)),
                    **cs.signed_stats(got[0][:n], ref, False))
                rows.setdefault(str(span), dict(
                    design=what, blocks=lib.glt_colstats_v_blocks(mk, 32),
                    runs={}))["runs"][f"{name} seed {seed}"] = row
                print(f"span {span} ({what}) {name} seed {seed}: {row}",
                      flush=True)
                del got, again
    finally:
        _build.CSRC, _build.BUILD_DIR, _build._LIB = saved
    out = dict(card=card, shapes=dict(p_pad=pp, n=nk, width=mk), spans=rows)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
