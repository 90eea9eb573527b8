"""End-to-end entry point of the port (``graphlap_tpu/models/pipeline.py``:
``FilterResult``, ``make_plan`` :210 and the streaming branches of
``filter_image`` :289-353, grayscale and per-channel RGB).

PyTorch runs eagerly, so there is no jitted program: ``filter_image`` moves
the image and the sample indices to ``device`` once, runs the streaming
slice there (strip_cache, recompute with the fused finish, or recompute
with an operator filter) and copies the filtered image back. RGB in
``rgb_mode="per_channel"`` runs the channels one after another through the
same slice (the reference vmaps them; each channel's pipeline is
independent). ``filter_image_staged``, ``luma_basis`` RGB, the dense path,
the unfused spectral sweeps and the sharded builders wait for their
ROADMAP.md items and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..utils.sampling import SamplePlan, random_sample, uniform_grid_sample
from .streaming import check_slice, filter_channel_streaming


class FilterResult(NamedTuple):
    image: np.ndarray          # filtered image, clipped to [0, 1]
    eigvals: np.ndarray        # (m,) eigenvalues of the filter matrix
    timings: dict              # per-stage seconds (staged mode only)


def make_plan(image: np.ndarray, cfg: PipelineConfig) -> SamplePlan:
    h, w = image.shape[:2]
    p = cfg.num_samples(h * w)
    if cfg.sample_mode == "random":
        return random_sample(h, w, p, seed=cfg.sample_seed)
    return uniform_grid_sample(h, w, p)


def _filter_channel(img2d: torch.Tensor, idx_a: torch.Tensor,
                    cfg: PipelineConfig, omega: torch.Tensor | None = None,
                    plain: bool = False, x0: torch.Tensor | None = None):
    """One grayscale channel on its device. Returns (z2d, vals).
    ``omega`` / ``x0`` inject the sketch's test matrix / LOBPCG's start
    block (parity tests); ``plain`` runs the kernels' PyTorch versions
    (the on-card comparison)."""
    return filter_channel_streaming(img2d, idx_a, cfg, omega, plain, x0)


def filter_image(image: np.ndarray, cfg: PipelineConfig,
                 plan: SamplePlan | None = None, mesh=None,
                 device: str | torch.device = "cuda") -> FilterResult:
    """Filter a (H, W) or (H, W, C) float [0, 1] image on ``device``.

    ``device`` defaults to the GPU: on a machine without CUDA the call
    raises instead of running somewhere else; pass ``device="cpu"`` for the
    plain-PyTorch versions of the kernels."""
    image = np.asarray(image)
    if mesh is not None:
        raise NotImplementedError("graphlap_tpu_torch: sharded filtering "
                                  "waits for ROADMAP.md Queue 1 M9")
    if image.ndim == 3 and cfg.rgb_mode == "luma_basis":
        raise NotImplementedError("graphlap_tpu_torch: rgb_mode='luma_basis' "
                                  "waits for ROADMAP.md Queue 1 M7")
    check_slice(cfg)
    if plan is None:
        plan = make_plan(image, cfg)
    dev = torch.device(device)
    img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    idx_a = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    if image.ndim == 2:
        z, vals = _filter_channel(img, idx_a, cfg)
        return FilterResult(image=z.cpu().numpy(),
                            eigvals=vals.cpu().numpy(), timings={})
    outs = [_filter_channel(img[..., c].contiguous(), idx_a, cfg)
            for c in range(image.shape[-1])]
    return FilterResult(
        image=torch.stack([z for z, _ in outs], dim=-1).cpu().numpy(),
        eigvals=torch.stack([v for _, v in outs]).cpu().numpy(), timings={})
