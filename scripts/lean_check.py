"""Which side of their plain versions the recompute kernels' sums lean to,
for the graphlap_tpu_torch of any checkout, with this checkout's checks.

    python3 scripts/lean_check.py [--repo DIR]

Runs chip_smoke.py's kernel cases (kernel against plain version, then both
timed) with its signed lines, printed and not required, for K1-K4 at
config 2's shapes (K3/K4's lean against chip_smoke's f64 reference), K5/K6
in the aug layout at config 3's channel-0 shapes, K5/K6 in the f32 layout
at the 8 MP matvec denoise's shapes, and K10 at the 8 MP turbo recipe's
shapes.
--repo names the checkout whose package (and kernels) run, e.g. a parent
commit unpacked with ``git archive`` beside this one: the lean of a
kernel before and after a change, measured by one script on one card.
Prints one JSON line with the signed statistics.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(ROOT))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lean_check: no CUDA card")
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    spec = importlib.util.spec_from_file_location("chip_smoke_checks",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms

    if repo not in Path(gt.__file__).resolve().parents:
        sys.exit(f"lean_check: imported {gt.__file__}, not from {repo}")
    cs.EXP_RATE = 1e12            # the bounds are not reported here
    dev = torch.device("cuda", 0)
    rows = {}
    for make, names in ((cs.make_workload, "strip"),
                        (cs.make_workload_cfg3, ("matvec", "rmatvec")),
                        (cs.make_workload_8mp_matvec,
                         ("matvec_f32", "rmatvec_f32")),
                        (cs.make_workload_8mp_turbo, None)):
        cfg, _, noisy, plan = make(gt)
        img_d = torch.as_tensor(noisy, device=dev)
        if img_d.ndim == 3:
            img_d = img_d[..., 0].contiguous()
        idx_d = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
        ctx = ms._strip_ctx(img_d, idx_d, cfg)
        if names == "strip":
            cases, signed, _ = cs.strip_cases(ctx, cfg, dev)
        elif names:
            cases, _, signed = cs.matvec_cases(ctx, dev, names, rows)
        else:
            cases, _, signed = cs.colstats_v_cases(ctx, cfg, img_d, dev,
                                                   rows)
        cs.run_cases(cases, rows, {k: [(*v[:3], False, *v[4:])
                                       for v in cs.lean_specs(spec)]
                                   for k, spec in signed.items()})
        del ctx, cases
        torch.cuda.empty_cache()
    print(json.dumps(dict(repo=str(repo), signed=rows["signed"],
                          signed_plain=rows.get("signed_plain"),
                          ms={k: r["ms"] for k, r in rows.items()
                              if "ms" in r})), flush=True)


if __name__ == "__main__":
    main()
