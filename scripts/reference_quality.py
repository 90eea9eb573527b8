"""The JAX reference's denoise and sharpen quality on the NLM bilateral
recipes (7 x 7, and A, B and C at 9 x 9 and 11 x 11) and on configs 2, 3 and
4 and the 8 MP matvec denoise at NLM 9 x 9 and 11 x 11, on the CPU, at
sizes the CPU reaches.

    JAX_PLATFORMS=cpu python scripts/reference_quality.py [--recipes A B C]
    JAX_PLATFORMS=cpu python scripts/reference_quality.py --recipes Bp9 Bp11 Cp9 Cp11
    JAX_PLATFORMS=cpu python scripts/reference_quality.py --recipes Ap9 Ap11
    JAX_PLATFORMS=cpu python scripts/reference_quality.py --recipes 2p9 2p11 4p9 4p11 4tp9 4tp11
    JAX_PLATFORMS=cpu python scripts/reference_quality.py --recipes 3p9 3p11 4qp9 4qp11

Each recipe is resolved by ``tuned_config`` at its full size, as
``chip_smoke.py`` builds it, and run by ``graphlap_tpu.filter_image`` on a
smaller test image (sigma 0.1, seed 1):

* A — config 2 with an NLM 7 x 7 patch and a spatial term, resolved at
  512^2 (strip_cache, bf16 store, coarse Sinkhorn 1/16 + 1 polish, sketch),
  run at 256^2;
* B — the 8 MP spectral bilateral recipe (f32 tiles, h 0.15, coarse 1/64 x
  6 + 1 polish, gram 1/64, fused finish, LOBPCG), run at 256 x 512;
* C — B through ``denoise_tuned(0.1)``: the 8 MP matvec recipe, run at 256
  x 512;
* Ap9, Ap11 — A with an NLM 9 x 9 or 11 x 11 patch
  (``chip_smoke.make_workload_cfg2_bilateral`` at those patches: 84 and 124
  live lanes, the CLI's ``-patch`` with ``-spatial_h 8 -preset fast``), run
  at 256^2;
* Bp9, Bp11, Cp9, Cp11 — B and C with an NLM 9 x 9 or 11 x 11 patch
  (``chip_smoke.make_workload_8mp_nlm_bilateral`` and
  ``make_workload_8mp_nlm_bilateral_matvec`` at those patches: 84 and 124
  live lanes), run at 256 x 512;
* 2p9, 2p11 — config 2's strip_cache recipe (``chip_smoke.make_workload``)
  with an NLM 9 x 9 or 11 x 11 patch (the CLI's ``-patch``), run at 256^2;
* 4p9, 4p11 — config 4's fused 8 MP recipe (``chip_smoke.make_workload_8mp``)
  with the same patches, run at 256 x 512;
* 4tp9, 4tp11 — the 8 MP turbo recipe (``chip_smoke.make_workload_8mp_turbo``)
  with the same patches, run at 256 x 512;
* 3p9, 3p11 — config 3's per-channel sharpen (``chip_smoke.make_workload_cfg3``:
  resolved at 1024^2 RGB, bf16 aug tiles, exact matvecs) with the same
  patches, run at 256^2 RGB on its own noise (sigma 0.03, seed 3);
* 4qp9, 4qp11 — the 8 MP matvec denoise (``chip_smoke.make_workload_8mp_matvec``:
  f32 tiles, exact matvecs) with the same patches, run at 256 x 512.

Prints one JSON line a recipe: its size, p, PSNR in and out, the
gradient-energy ratio (to the clean image's) in and out, SSIM out and the
top eigenvalues, so that a recipe that degenerates in the reference (as the
gaussian bilateral 8 MP recipe does, ROADMAP Queue 3) is told apart from a
port fault, and config 3's three sharpen bars (chip_smoke.py's, from
tests/test_quality.py) can be read off: ratio out > in + 0.05, SSIM > 0.75,
PSNR out > in - 3 dB.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import graphlap_tpu as gl  # noqa: E402
import graphlap_tpu_torch as gt  # noqa: E402
from graphlap_tpu.config import PipelineConfig as JaxConfig  # noqa: E402

MP8 = 2048 * 4096
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_recipes",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def recipes() -> dict:
    """{name: (the port's config, (h, w[, channels]) run here[, (noise
    sigma, seed)])}; the noise is sigma 0.1, seed 1 where not given."""
    base = gt.CONFIG2.replace(patch_size=7, spatial_h=8.0)
    b = gt.tuned_config(base.replace(streaming=True, sample_cap=4096), MP8,
                        "fast")
    c = gt.tuned_config(gt.denoise_tuned(
        base.replace(streaming=True, sample_cap=4096), 0.1), MP8, "fast")
    out = {"A": (gt.tuned_config(base, 512 * 512, "fast"), (256, 256)),
           "B": (b, (256, 512)), "C": (c, (256, 512))}
    cs = _chip_smoke()
    for patch in (9, 11):
        bp = base.replace(patch_size=patch, streaming=True, sample_cap=4096)
        out[f"Ap{patch}"] = (cs.make_workload_cfg2_bilateral(gt, patch)[0],
                             (256, 256))
        out[f"Bp{patch}"] = (gt.tuned_config(bp, MP8, "fast"), (256, 512))
        out[f"Cp{patch}"] = (gt.tuned_config(gt.denoise_tuned(bp, 0.1), MP8,
                                             "fast"), (256, 512))
        out[f"2p{patch}"] = (cs.make_workload(gt, patch)[0], (256, 256))
        out[f"4p{patch}"] = (cs.make_workload_8mp(gt, 256, 512, patch)[0],
                             (256, 512))
        out[f"4tp{patch}"] = (cs.make_workload_8mp_turbo(gt, patch)[0],
                              (256, 512))
        out[f"3p{patch}"] = (cs.make_workload_cfg3(gt, patch)[0],
                             (256, 256, 3), (0.03, 3))
        out[f"4qp{patch}"] = (cs.make_workload_8mp_matvec(gt, patch)[0],
                              (256, 512))
    return out


def grad_energy(a) -> float:
    return float((np.diff(a, axis=0) ** 2).sum()
                 + (np.diff(a, axis=1) ** 2).sum())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipes", nargs="+", default=["A", "B", "C"])
    args = ap.parse_args()
    table = recipes()
    for name in args.recipes:
        cfg, shape, *noise = table[name]
        sigma, seed = noise[0] if noise else (0.1, 1)
        img = gt.make_test_image(*shape)
        noisy = np.clip(gt.add_gaussian_noise(img, sigma, seed=seed), 0,
                        1).astype(np.float32)
        plan = gt.make_plan(noisy, cfg)
        res = gl.filter_image(noisy, JaxConfig(**cfg.to_dict()), plan=plan)
        out = np.asarray(res.image)
        vals = np.sort(np.asarray(res.eigvals).ravel())[::-1]
        print(json.dumps(dict(
            recipe=name, size=list(shape), p=int(plan.p),
            psnr_in=float(gt.psnr(img, noisy)),
            psnr_out=float(gt.psnr(img, out)),
            grad_ratio_in=grad_energy(noisy) / grad_energy(img),
            grad_ratio_out=grad_energy(out) / grad_energy(img),
            ssim_out=float(gt.ssim(img, out)),
            top_eigvals=vals[:3].tolist(), config=cfg.to_dict())), flush=True)


if __name__ == "__main__":
    main()
