"""End-to-end entry points of the port (``graphlap_tpu/models/pipeline.py``:
``FilterResult``, ``_solve_basis`` :46, the dense ``_filter_channel_impl``
:63 with ``_dense_wapply`` :96, ``make_plan`` :210,
``DENSE_STRIP_BYTES_LIMIT`` / ``check_dense_feasible`` :270, the
single-device branches of ``filter_image`` :289-353, grayscale and
per-channel RGB, and ``filter_image_staged`` :611 with the dense stages
:396-461 and ``_filter_streaming_staged`` :562).

PyTorch runs eagerly, so there is no jitted program: ``filter_image`` moves
the image and the plan's indices to ``device`` once, runs one channel at a
time there and copies the filtered image back. RGB in
``rgb_mode="per_channel"`` runs the channels one after another (the
reference vmaps them; each channel's pipeline is independent, so the result
is the same).

* Streaming configs run models/streaming (a fused schedule where its gate
  admits the recipe, else the unfused one).
* Non-streaming configs run the dense path: ``affinity_blocks`` (K_AA and
  the materialized (p, N-p) strip K_AB, from the K1 emitter under
  ``use_pallas``) -> ``normalize_blocks`` -> the Nystrom eigensolve
  (``_solve_basis``) -> ``apply_spectral_filter``, or an operator filter
  through ``_dense_wapply``. Pixels run in permuted [A; B] order: y is
  gathered by ``perm`` and z scattered back by ``inv_perm``.

``filter_image_staged`` runs the same schedules with a wall per stage.
``luma_basis`` RGB and the sharded builders wait for their ROADMAP.md items
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.affinity import affinity_blocks
from ..ops.filters import apply_operator_filter, apply_spectral_filter
from ..ops.nystrom import (EigenBasis, nystrom_eigh, nystrom_eigh_chol,
                           nystrom_eigh_sketch)
from ..ops.sinkhorn import (_make_kaa_solve, normalize_blocks,
                            normalize_scales, nystrom_matvec)
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


# the reference's dense-path guard, kept with its bound and message so both
# packages accept the same configs (not re-derived for the H100's memory)
DENSE_STRIP_BYTES_LIMIT = 8e9


def check_dense_feasible(cfg: PipelineConfig, plan: SamplePlan) -> None:
    """Raise if the dense (non-streaming) path would materialize a K strip
    beyond DENSE_STRIP_BYTES_LIMIT. No-op for streaming configs."""
    if cfg.streaming:
        return
    itemsize = 2 if cfg.affinity_dtype == "bfloat16_store" else 4
    strip = plan.p * plan.n * itemsize
    if strip > DENSE_STRIP_BYTES_LIMIT:
        raise ValueError(
            f"dense K strip would be {strip / 1e9:.1f} GB "
            f"(p={plan.p}, N={plan.n}) — past the "
            f"{DENSE_STRIP_BYTES_LIMIT / 1e9:.0f} GB single-chip bound. "
            f"Use cfg.replace(streaming=True) (CLI: -streaming), which "
            f"recomputes K tiles blockwise and needs only O(N*d) memory.")


def _solve_basis(waa: torch.Tensor, wab: torch.Tensor, cfg: PipelineConfig,
                 omega: torch.Tensor | None = None,
                 x0: torch.Tensor | None = None) -> EigenBasis:
    """The Nystrom eigensolve on the scaled blocks, by ``cfg.solver``:
    sketch (``omega`` its test matrix), chol / LOBPCG on the cross GEMM in
    ``gram_gemm_dtype`` (``x0`` LOBPCG's start block), else the one-shot."""
    m = cfg.num_eigvecs
    if cfg.solver == "sketch":
        return nystrom_eigh_sketch(waa, wab, m, cfg.eig_tol,
                                   cfg.sketch_oversample, cfg.sketch_power,
                                   omega)
    if cfg.solver in ("chol", "lobpcg"):
        method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
        gdt = (torch.bfloat16 if cfg.gram_gemm_dtype() == "bfloat16"
               else torch.float32)
        return nystrom_eigh_chol(waa, wab, m, cfg.eig_tol, method, gdt,
                                 cfg.lobpcg_iters, x0)
    return nystrom_eigh(waa, wab, m, cfg.eig_tol)


def _dense_wapply(kaa, kab, s_a, s_b, cfg: PipelineConfig):
    """x -> W x = s * K~(s * x): the scaled completion, with the K_AA solve
    built from the UNSCALED K_AA as Sinkhorn's (building it from W_AA
    shifts the ridge, and the paths diverge)."""
    solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)
    p = kaa.shape[0]

    def wapply(x):
        top, bottom = nystrom_matvec(kaa, kab, solve, s_a * x[:p],
                                     s_b * x[p:])
        return torch.cat([s_a * top, s_b * bottom])

    return wapply


def _y_perm(img2d: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The pixels in [A; B] order, f32."""
    return img2d.to(torch.float32).reshape(-1)[perm]


class _StageClock:
    """Adds each stage's seconds to ``walls`` (when given), each wall ending
    in a device sync; without ``walls`` it neither syncs nor reads a
    clock."""

    def __init__(self, device: torch.device, walls: dict | None):
        self.device, self.walls = device, walls
        self.t = self._now() if walls is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str) -> None:
        if self.walls is not None:
            t = self._now()
            self.walls[stage] += t - self.t
            self.t = t


def _filter_channel_dense(img2d: torch.Tensor, idx_a: torch.Tensor,
                          perm: torch.Tensor, inv_perm: torch.Tensor,
                          cfg: PipelineConfig,
                          omega: torch.Tensor | None = None,
                          plain: bool = False,
                          x0: torch.Tensor | None = None,
                          walls: dict | None = None):
    """One grayscale channel through the dense path. Returns (z2d, vals).
    ``walls``: a dict whose "affinity", "normalize", "eigensolve" and
    "filter" entries gain the stages' seconds (an operator filter has no
    eigensolve stage). Each large buffer is released once its last
    consumer has run (K_AB after the scaling; W_AB after the eigensolve)."""
    clock = _StageClock(img2d.device, walls)
    kaa, kab = affinity_blocks(img2d, idx_a, perm, cfg, plain=plain)
    clock("affinity")
    norm = (cfg.normalization, cfg.sinkhorn_iters, cfg.eig_tol, cfg.solver,
            cfg.sinkhorn_coarse, cfg.sinkhorn_polish)
    if cfg.operator_filter():
        s_a, s_b = normalize_scales(kaa, kab, *norm)
        clock("normalize")
        z_perm = apply_operator_filter(_dense_wapply(kaa, kab, s_a, s_b, cfg),
                                       _y_perm(img2d, perm), cfg.filter_name,
                                       cfg.filter_param, cfg.filter_mode,
                                       cfg.cheb_degree)
        vals = torch.zeros((0,), dtype=torch.float32, device=img2d.device)
    else:
        waa, wab, _, _ = normalize_blocks(kaa, kab, *norm)
        del kab
        clock("normalize")
        basis = _solve_basis(waa, wab, cfg, omega, x0)
        del waa, wab
        clock("eigensolve")
        z_perm = apply_spectral_filter(_y_perm(img2d, perm), basis.vals,
                                       basis.vecs, cfg.filter_name,
                                       cfg.filter_param)
        vals = basis.vals
    z = torch.clamp(z_perm[inv_perm].reshape(img2d.shape), 0.0, 1.0)
    clock("filter")
    return z, vals


def _filter_channel(img2d: torch.Tensor, idx_a: torch.Tensor,
                    cfg: PipelineConfig, omega: torch.Tensor | None = None,
                    plain: bool = False, x0: torch.Tensor | None = None,
                    perm: torch.Tensor | None = None,
                    inv_perm: torch.Tensor | None = None):
    """One grayscale channel on its device. Returns (z2d, vals).
    ``omega`` / ``x0`` inject the sketch's test matrix / LOBPCG's start
    block (parity tests); ``plain`` runs the kernels' PyTorch versions
    (the on-card comparison). The dense path needs the plan's ``perm`` /
    ``inv_perm`` (int64 on the device); the streaming paths never read
    them."""
    if cfg.streaming:
        return filter_channel_streaming(img2d, idx_a, cfg, omega, plain, x0)
    if perm is None or inv_perm is None:
        raise ValueError("the dense path needs the plan's perm and inv_perm")
    return _filter_channel_dense(img2d, idx_a, perm, inv_perm, cfg, omega,
                                 plain, x0)


def _check_image(image: np.ndarray, cfg: PipelineConfig) -> None:
    if image.ndim == 3 and cfg.rgb_mode == "luma_basis":
        raise NotImplementedError("graphlap_tpu_torch: rgb_mode='luma_basis' "
                                  "waits for ROADMAP.md Queue 1 M7")
    check_slice(cfg)


def _plan_to(plan: SamplePlan, cfg: PipelineConfig, dev: torch.device):
    """(idx_a, perm, inv_perm) as int64 on ``dev``; the streaming paths
    run in natural pixel order and get (idx_a, None, None)."""
    idx_a = torch.as_tensor(plan.idx_a.astype(np.int64), device=dev)
    if cfg.streaming:
        return idx_a, None, None
    return (idx_a, torch.as_tensor(plan.perm.astype(np.int64), device=dev),
            torch.as_tensor(plan.inv_perm.astype(np.int64), device=dev))


def _channels(image: np.ndarray) -> list:
    return [image] if image.ndim == 2 else [
        image[..., c] for c in range(image.shape[-1])]


def _result(image: np.ndarray, outs: list, all_vals: list,
            timings: dict) -> FilterResult:
    if image.ndim == 2:
        return FilterResult(image=outs[0], eigvals=all_vals[0],
                            timings=timings)
    return FilterResult(image=np.stack(outs, axis=-1),
                        eigvals=np.stack(all_vals), timings=timings)


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
    check_dense_feasible(cfg, plan)
    dev = torch.device(device)
    idx_a, perm, inv_perm = _plan_to(plan, cfg, dev)
    # one upload and one copy back: the channels queue on the device
    # without a host sync between them
    img = torch.as_tensor(np.asarray(image, np.float32), device=dev)
    if image.ndim == 2:
        z, vals = _filter_channel(img, idx_a, cfg, perm=perm,
                                  inv_perm=inv_perm)
        return FilterResult(image=z.cpu().numpy(),
                            eigvals=vals.cpu().numpy(), timings={})
    outs = [_filter_channel(img[..., c].contiguous(), idx_a, cfg, perm=perm,
                            inv_perm=inv_perm)
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
    timings = {k: 0.0 for k in ("normalize", "eigensolve", "filter")}
    outs, all_vals = [], []
    for ch in _channels(image):
        img2d = torch.as_tensor(np.ascontiguousarray(ch, np.float32),
                                device=dev)
        clock = _StageClock(dev, timings)
        s = stage_scales_streaming(img2d, idx_a, cfg)
        clock("normalize")
        if cfg.operator_filter():
            z, vals = stage_matvec_streaming(img2d, idx_a, s, cfg)
        else:
            fac = stage_factor_streaming(img2d, idx_a, s, cfg, omega, x0)
            clock("eigensolve")
            z, vals = stage_apply_streaming(fac, idx_a, cfg, h, w)
        clock("filter")
        outs.append(z.cpu().numpy())
        all_vals.append(vals.cpu().numpy())
    return _result(image, outs, all_vals, timings)


def _filter_dense_staged(image: np.ndarray, cfg: PipelineConfig,
                         plan: SamplePlan,
                         device: str | torch.device) -> FilterResult:
    """The dense path in four timed stages a channel ("affinity",
    "normalize", "eigensolve", "filter"; an operator filter has no
    eigensolve stage), each wall ending in a device sync: the schedule of
    ``filter_image``, so the image is the same."""
    dev = torch.device(device)
    idx_a, perm, inv_perm = _plan_to(plan, cfg, dev)
    timings = {k: 0.0 for k in ("affinity", "normalize", "eigensolve",
                                "filter")}
    outs, all_vals = [], []
    for ch in _channels(image):
        img2d = torch.as_tensor(np.ascontiguousarray(ch, np.float32),
                                device=dev)
        z, vals = _filter_channel_dense(img2d, idx_a, perm, inv_perm, cfg,
                                        walls=timings)
        outs.append(z.cpu().numpy())
        all_vals.append(vals.cpu().numpy())
    return _result(image, outs, all_vals, timings)


def filter_image_staged(image: np.ndarray, cfg: PipelineConfig,
                        plan: SamplePlan | None = None,
                        device: str | torch.device = "cuda") -> FilterResult:
    """Like ``filter_image`` but per-stage timed, one channel at a time:
    ``timings`` holds the seconds of each stage (summed over channels) —
    "affinity", "normalize", "eigensolve" and "filter" on the dense path,
    the last three on the streaming paths. Defaults to the GPU as
    ``filter_image`` does; the first call of a shape includes the kernels'
    build, so warm up first for steady-state walls."""
    image = np.asarray(image)
    _check_image(image, cfg)
    if plan is None:
        plan = make_plan(image, cfg)
    check_dense_feasible(cfg, plan)
    if cfg.streaming:
        return _filter_streaming_staged(image, cfg, plan, device)
    return _filter_dense_staged(image, cfg, plan, device)
