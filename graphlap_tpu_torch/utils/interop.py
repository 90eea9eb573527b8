"""State carried from the reference into the port.

The filter has no learned weights. What crosses between the packages is
the configuration, the sample plan's indices, the sketch's random test
matrix Omega and LOBPCG's random start block X0 (torch cannot redraw
either from the reference's seed). Each arrives as plain Python or numpy
and becomes the port's object here.
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


def block_to_device(block: np.ndarray, device) -> torch.Tensor:
    """A random block the reference drew, as f32 on ``device``: the (p, k)
    sketch test matrix Omega or the (p, m) LOBPCG start block X0."""
    return torch.tensor(np.asarray(block, np.float32), device=device)
