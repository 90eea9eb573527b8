"""End-to-end entry points of the port (``graphlap_tpu/models/pipeline.py``:
``FilterResult``, ``make_plan`` :210, the streaming branches of
``filter_image`` :289-353, grayscale and per-channel RGB, and
``filter_image_staged`` :611 with ``_filter_streaming_staged`` :562).

PyTorch runs eagerly, so there is no jitted program: ``filter_image`` moves
the image and the sample indices to ``device`` once, runs the streaming
model there (models/streaming: a fused schedule where its gate admits the
recipe, else the unfused one) and copies the filtered image back. RGB in
``rgb_mode="per_channel"`` runs the channels one after another (the
reference vmaps them; each channel's pipeline is independent).
``filter_image_staged`` runs the unfused schedule stage by stage with a
wall per stage. ``luma_basis`` RGB, the dense path and the sharded
builders wait for their ROADMAP.md items and raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..utils.sampling import SamplePlan, random_sample, uniform_grid_sample
from .streaming import (check_slice, filter_channel_streaming,
                        stage_apply_streaming, stage_factor_streaming,
                        stage_matvec_streaming, stage_scales_streaming)


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


def _check_image(image: np.ndarray, cfg: PipelineConfig) -> None:
    if image.ndim == 3 and cfg.rgb_mode == "luma_basis":
        raise NotImplementedError("graphlap_tpu_torch: rgb_mode='luma_basis' "
                                  "waits for ROADMAP.md Queue 1 M7")
    check_slice(cfg)


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
    _check_image(image, cfg)
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


def _filter_streaming_staged(image: np.ndarray, cfg: PipelineConfig,
                             plan: SamplePlan, device: str | torch.device,
                             omega: torch.Tensor | None = None,
                             x0: torch.Tensor | None = None) -> FilterResult:
    """The streaming model in three timed stages a channel: the scales
    ("normalize", the Sinkhorn wall, tiles recomputed or the strip emitted
    inside), the Nystrom factor ("eigensolve": cross or sketch, p x p
    solve, colstats) and the O(N m) apply ("filter"); an operator filter
    has no eigensolve stage. Every recipe runs the unfused schedule here (a
    fused one has no stage boundary to time), the same estimator. Each
    stage wall ends in a device sync. ``omega`` / ``x0`` as in
    ``_filter_channel``."""
    dev = torch.device(device)
    idx_a = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    h, w = image.shape[:2]

    def now():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    timings = {k: 0.0 for k in ("normalize", "eigensolve", "filter")}
    channels = [image] if image.ndim == 2 else [
        image[..., c] for c in range(image.shape[-1])]
    outs, all_vals = [], []
    for ch in channels:
        img2d = torch.as_tensor(np.ascontiguousarray(ch, np.float32),
                                device=dev)
        t0 = now()
        s = stage_scales_streaming(img2d, idx_a, cfg)
        t1 = now()
        if cfg.operator_filter():
            z, vals = stage_matvec_streaming(img2d, idx_a, s, cfg)
            t2 = t1
        else:
            fac = stage_factor_streaming(img2d, idx_a, s, cfg, omega, x0)
            t2 = now()
            z, vals = stage_apply_streaming(fac, idx_a, cfg, h, w)
        t3 = now()
        timings["normalize"] += t1 - t0
        timings["eigensolve"] += t2 - t1
        timings["filter"] += t3 - t2
        outs.append(z.cpu().numpy())
        all_vals.append(vals.cpu().numpy())
    if image.ndim == 2:
        return FilterResult(image=outs[0], eigvals=all_vals[0],
                            timings=timings)
    return FilterResult(image=np.stack(outs, axis=-1),
                        eigvals=np.stack(all_vals), timings=timings)


def filter_image_staged(image: np.ndarray, cfg: PipelineConfig,
                        plan: SamplePlan | None = None,
                        device: str | torch.device = "cuda") -> FilterResult:
    """Like ``filter_image`` but per-stage timed, one channel at a time:
    ``timings`` holds the seconds of "normalize", "eigensolve" and
    "filter" (summed over channels). Defaults to the GPU as
    ``filter_image`` does; the first call of a shape includes the kernels'
    build, so warm up first for steady-state walls."""
    image = np.asarray(image)
    _check_image(image, cfg)
    if plan is None:
        plan = make_plan(image, cfg)
    return _filter_streaming_staged(image, cfg, plan, device)
