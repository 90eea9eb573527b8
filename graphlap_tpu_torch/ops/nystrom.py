"""Nystrom helpers of the sketch eigensolve (port of
``graphlap_tpu/ops/nystrom.py``: ``_ridge_eps`` :116, ``_orthonormalize``
:195, ``_LIVE_NORM2``).

The strip_cache path inlines the randomized sketch solve into its fused
strip sweeps (models/streaming._factor_strip_fused), so only these pieces
are needed here. ``nystrom_sketch_factor``, ``nystrom_chol_factor`` and the
one-shot solver wait for the dense-path port (ROADMAP.md Queue 1, M5).
"""

from __future__ import annotations

import torch

# columns whose true squared norm falls below this are spurious (live
# columns sit at ~1, truncation-killed at 0)
_LIVE_NORM2 = 0.25


def _ridge_eps(mat: torch.Tensor, rel: float) -> torch.Tensor:
    return rel * torch.max(torch.sum(torch.abs(mat), dim=1))


def _orthonormalize(y: torch.Tensor, rel: float = 1e-6) -> torch.Tensor:
    """Two-round orthonormalization of the sketch block: rank-safe eigh
    whitening (floors collapsed directions instead of NaN-ing a Cholesky of
    an ill-conditioned Gram), then one CholQR polish whose Gram is ~I."""
    k = y.shape[1]
    g = y.T @ y
    g = 0.5 * (g + g.T)
    w, s = torch.linalg.eigh(g)                         # ascending
    w = torch.maximum(w, rel * w[-1])
    y = y @ (s * (w ** -0.5)[None, :]) @ s.T            # Y G^{-1/2}, sym
    g = y.T @ y
    g = 0.5 * (g + g.T)
    eye = torch.eye(k, dtype=g.dtype, device=g.device)
    r = torch.linalg.cholesky(g + 1e-7 * eye)
    return torch.linalg.solve_triangular(r, y.T, upper=False).T   # Y L^{-T}
