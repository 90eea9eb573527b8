"""State carried from the reference into the port.

The filter has no learned weights. What crosses between the packages is
the configuration, the sample plan's indices and the sketch's random test
matrix Omega (which torch cannot redraw from the reference's seed). Each
arrives as plain Python or numpy and becomes the port's object here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import PipelineConfig
from .sampling import SamplePlan, _plan_from_idx


def config_from_dict(d: dict) -> PipelineConfig:
    """The port's PipelineConfig from the reference's ``cfg.to_dict()``;
    ``config_hash()`` is then equal."""
    return PipelineConfig(**d)


def plan_from_idx(idx_a: np.ndarray, height: int, width: int) -> SamplePlan:
    """The port's SamplePlan from the reference plan's ``idx_a``."""
    return _plan_from_idx(np.asarray(idx_a), height, width)


def idx_to_device(idx_a: np.ndarray, device) -> torch.Tensor:
    """Sample indices as an int64 tensor on ``device``."""
    return torch.tensor(np.asarray(idx_a, np.int64), device=device)


def omega_to_device(omega: np.ndarray, device) -> torch.Tensor:
    """The reference's (p, k) sketch test matrix as f32 on ``device``."""
    return torch.tensor(np.asarray(omega, np.float32), device=device)
