"""Spectral filter functions f(lambda) (port of ``graphlap_tpu/ops/filters.py``).

Pure functions on the eigenvalue vector, registered by name. Each works on
torch tensors and numpy arrays alike. Projection filters (``affine=False``)
give z = V f(L) V^T y; affine filters give z = y + V (f(L) - 1) V^T y. The
operator (matvec / Chebyshev) application modes wait for their port
(ROADMAP.md Queue 1, M7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class SpectralFilter(NamedTuple):
    fn: Callable          # (vals, param) -> filtered vals  (torch or np alike)
    affine: bool
    doc: str


def _mod(lam):
    return torch if isinstance(lam, torch.Tensor) else np


def _identity(lam, param):
    return lam


def _power(lam, param):
    # integer k: the true power (the reference's sign-safe form would flip
    # even powers of slightly negative tail eigenvalues)
    if float(param) == int(param):
        return lam ** int(param)
    mod = _mod(lam)
    return mod.sign(lam) * mod.abs(lam) ** param


def _lowpass(lam, param):
    return _mod(lam).ones_like(lam)


def _sharpen(lam, param):
    return 1.0 + param * (1.0 - lam)


def _exp_decay(lam, param):
    return _mod(lam).exp(-param * (1.0 - lam))


def _twicing(lam, param):
    r = 1.0 - lam
    if float(param) == int(param):
        return 1.0 - r ** int(param)
    mod = _mod(lam)
    return 1.0 - mod.sign(r) * mod.abs(r) ** param


FILTER_REGISTRY: dict[str, SpectralFilter] = {
    "identity": SpectralFilter(_identity, False, "f(l)=l: one application of W (GLIDE denoise)"),
    "power": SpectralFilter(_power, False, "f(l)=l^k: k-step diffusion"),
    "lowpass": SpectralFilter(_lowpass, False, "f(l)=1: rank-m projection"),
    "sharpen": SpectralFilter(_sharpen, True, "f(l)=1+b(1-l): detail boost, f>1 on low l"),
    "exp_decay": SpectralFilter(_exp_decay, False, "f(l)=exp(-t(1-l)): heat kernel"),
    "twicing": SpectralFilter(_twicing, True, "f(l)=1-(1-l)^k: residual add-back (boosting)"),
}
