"""Nystrom pixel sampling and the [A; B] permutation — a verbatim copy of
``graphlap_tpu/utils/sampling.py``.

Host-side numpy: sample indices depend only on the image shape and the
config, so the port and the reference draw bit-identical ``idx_a``
(tests/test_torch_config.py pins it). Edit only together with the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SamplePlan:
    """Index bookkeeping for the Nystrom split.

    perm lists sample pixels first then the rest: ``flat_permuted = flat[perm]``.
    ``inv_perm`` undoes it at reconstruction (SURVEY.md §1.2 Stage 6).
    """

    idx_a: np.ndarray      # (p,)  int32, flat indices of sampled pixels (sorted)
    perm: np.ndarray       # (N,)  int32, [A; B] ordering
    inv_perm: np.ndarray   # (N,)  int32, inverse permutation
    height: int
    width: int

    @property
    def p(self) -> int:
        return int(self.idx_a.shape[0])

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])


def uniform_grid_sample(height: int, width: int, p_target: int) -> SamplePlan:
    """Spatially uniform sample of ~p_target pixels on a regular grid.

    Matches the reference's every-k-th-pixel strategy (SURVEY.md §1.2 Stage 1
    [R]) but guarantees an exact count: choose a gh x gw grid with
    gh*gw >= p_target, place points at evenly spaced coordinates, then trim
    deterministically to exactly p_target.
    """
    n = height * width
    p_target = int(min(max(p_target, 1), n))

    aspect = height / width
    gh = max(1, int(round(np.sqrt(p_target * aspect))))
    gw = max(1, int(np.ceil(p_target / gh)))
    gh = min(gh, height)
    gw = min(gw, width)
    while gh * gw < p_target:  # grid clipped by image dims; grow the other axis
        if gw < width:
            gw += 1
        elif gh < height:
            gh += 1
        else:
            break

    rows = np.round((np.arange(gh) + 0.5) * height / gh - 0.5).astype(np.int64)
    cols = np.round((np.arange(gw) + 0.5) * width / gw - 0.5).astype(np.int64)
    rows = np.clip(rows, 0, height - 1)
    cols = np.clip(cols, 0, width - 1)
    rr, cc = np.meshgrid(rows, cols, indexing="ij")
    idx = np.unique(rr.ravel() * width + cc.ravel())

    if idx.size > p_target:
        # trim evenly across the grid, keeping spatial uniformity
        keep = np.round(np.linspace(0, idx.size - 1, p_target)).astype(np.int64)
        idx = idx[keep]
    elif idx.size < p_target:
        # rounding collisions ate some points; backfill with unused pixels
        mask = np.ones(n, dtype=bool)
        mask[idx] = False
        pool = np.flatnonzero(mask)
        extra = pool[np.round(np.linspace(0, pool.size - 1,
                                          p_target - idx.size)).astype(np.int64)]
        idx = np.sort(np.concatenate([idx, extra]))

    return _plan_from_idx(idx, height, width)


def random_sample(height: int, width: int, p_target: int,
                  seed: int = 0) -> SamplePlan:
    """Uniform random sample of exactly p_target distinct pixels.

    The GLIDE papers' sampling variant (Talebi & Milanfar 2014 use random
    pixel subsets; the reference's grid is the spatially-stratified cousin).
    Deterministic per seed — the plan stays a compile-time constant, so
    changing the seed recompiles (by design: index sets are static shapes).
    """
    n = height * width
    p_target = int(min(max(p_target, 1), n))
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=p_target, replace=False)
    return _plan_from_idx(idx, height, width)


def _plan_from_idx(idx: np.ndarray, height: int, width: int) -> SamplePlan:
    n = height * width
    idx_a = np.sort(np.asarray(idx)).astype(np.int32)
    mask = np.ones(n, dtype=bool)
    mask[idx_a] = False
    idx_b = np.flatnonzero(mask).astype(np.int32)
    perm = np.concatenate([idx_a, idx_b]).astype(np.int32)
    inv_perm = np.empty(n, dtype=np.int32)
    inv_perm[perm] = np.arange(n, dtype=np.int32)
    return SamplePlan(idx_a=idx_a, perm=perm, inv_perm=inv_perm,
                      height=height, width=width)
