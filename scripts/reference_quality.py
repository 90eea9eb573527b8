"""The JAX reference's denoise quality on the NLM 7 x 7 bilateral recipes,
on the CPU, at sizes the CPU reaches.

    JAX_PLATFORMS=cpu python scripts/reference_quality.py [--recipes A B C]

Each recipe is resolved by ``tuned_config`` at its full size, as
``chip_smoke.py`` builds it, and run by ``graphlap_tpu.filter_image`` on a
smaller test image (sigma 0.1, seed 1):

* A — config 2 with an NLM 7 x 7 patch and a spatial term, resolved at
  512^2 (strip_cache, bf16 store, coarse Sinkhorn 1/16 + 1 polish, sketch),
  run at 256^2;
* B — the 8 MP spectral bilateral recipe (f32 tiles, h 0.15, coarse 1/64 x
  6 + 1 polish, gram 1/64, fused finish, LOBPCG), run at 256 x 512;
* C — B through ``denoise_tuned(0.1)``: the 8 MP matvec recipe, run at 256
  x 512.

Prints one JSON line a recipe: its size, p, PSNR in and out and the top
eigenvalues, so that a recipe that degenerates in the reference (as the
gaussian bilateral 8 MP recipe does, ROADMAP Queue 3) is told apart from a
port fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import graphlap_tpu as gl  # noqa: E402
import graphlap_tpu_torch as gt  # noqa: E402
from graphlap_tpu.config import PipelineConfig as JaxConfig  # noqa: E402

MP8 = 2048 * 4096


def recipes() -> dict:
    """{name: (the port's config, (h, w) run here)}."""
    base = gt.CONFIG2.replace(patch_size=7, spatial_h=8.0)
    b = gt.tuned_config(base.replace(streaming=True, sample_cap=4096), MP8,
                        "fast")
    c = gt.tuned_config(gt.denoise_tuned(
        base.replace(streaming=True, sample_cap=4096), 0.1), MP8, "fast")
    return {"A": (gt.tuned_config(base, 512 * 512, "fast"), (256, 256)),
            "B": (b, (256, 512)), "C": (c, (256, 512))}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipes", nargs="+", default=["A", "B", "C"])
    args = ap.parse_args()
    for name in args.recipes:
        cfg, (h, w) = recipes()[name]
        img = gt.make_test_image(h, w)
        noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0,
                        1).astype(np.float32)
        plan = gt.make_plan(noisy, cfg)
        res = gl.filter_image(noisy, JaxConfig(**cfg.to_dict()), plan=plan)
        vals = np.sort(np.asarray(res.eigvals).ravel())[::-1]
        print(json.dumps(dict(
            recipe=name, size=[h, w], p=int(plan.p),
            psnr_in=float(gt.psnr(img, noisy)),
            psnr_out=float(gt.psnr(img, np.asarray(res.image))),
            top_eigvals=vals[:3].tolist(), config=cfg.to_dict())), flush=True)


if __name__ == "__main__":
    main()
