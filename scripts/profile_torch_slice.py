"""Where the time of graphlap_tpu_torch's config-2 slice goes, on one CUDA card.

    python3 scripts/profile_torch_slice.py [--out DIR]

Runs chip_smoke.make_workload's recipe through filter_image once to warm
up, then:

* stage walls (host clock around work ending in torch.cuda.synchronize):
  strip context (features, K_AA + its Cholesky, the K1 strip), the coarse
  Sinkhorn loop, and the whole filter_image call;
* one filter_image call under torch.profiler: device time summed by kernel
  name, the device-busy share of the call's wall, and the full table in
  <out>/profile_table.txt (the Chrome trace in <out>/profile_trace.json).

Prints one JSON line with the numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _wall(fn, reps: int = 3) -> float:
    """Min seconds of fn() over ``reps`` synchronized runs."""
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import chip_smoke
    import graphlap_tpu_torch as gt
    from graphlap_tpu_torch.models import streaming as ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg, img, noisy, plan = chip_smoke.make_workload(gt)
    img_d = torch.as_tensor(noisy, device=dev)
    idx_d = torch.as_tensor(plan.idx_a.astype("int64"), device=dev)
    gt.filter_image(noisy, cfg, plan=plan, device=dev)          # warm-up

    stages = {}
    ctx = ms._strip_ctx(img_d, idx_d, cfg)
    stages["strip_ctx_s"] = _wall(lambda: ms._strip_ctx(img_d, idx_d, cfg))
    stages["coarse_sinkhorn_s"] = _wall(
        lambda: ms._coarse_sinkhorn_state(ctx, cfg))
    stages["filter_image_s"] = _wall(
        lambda: gt.filter_image(noisy, cfg, plan=plan, device=dev))
    del ctx

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gt.filter_image(noisy, cfg, plan=plan, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
            else "cuda_time_total")
    by_kernel = sorted(((e.key, getattr(e, attr) / 1e3) for e in ka
                        if getattr(e, attr) > 0 and e.device_type is not None
                        and "cuda" in str(e.device_type).lower()),
                       key=lambda kv: -kv[1])
    device_ms = sum(ms_ for _, ms_ in by_kernel)
    (out / "profile_table.txt").write_text(
        ka.table(sort_by=attr, row_limit=60))
    prof.export_chrome_trace(str(out / "profile_trace.json"))
    print(json.dumps(dict(
        card=card, stages=stages, profiled_wall_s=wall,
        device_kernel_ms=device_ms,
        device_busy_share=device_ms / 1e3 / wall if wall else None,
        top_kernels_ms=by_kernel[:15])), flush=True)


if __name__ == "__main__":
    main()
