"""The K_AA solve of the Nystrom completion (port of
``graphlap_tpu/ops/sinkhorn.py:_make_kaa_solve``).

The completion K~ = [K_AA K_AB; K_BA K_BA K_AA^+ K_AB] needs u -> K_AA^+ u
inside every Sinkhorn step. The dense Sinkhorn loops of the reference
(``sinkhorn_scaling``, ``sinkhorn_scaling_coarse``, ``normalize_blocks``)
wait for the dense-path port (ROADMAP.md Queue 1, M5).
"""

from __future__ import annotations

import torch

from .linalg import psd_pinv


def _make_kaa_solve(kaa: torch.Tensor, eig_tol: float, solver: str):
    """u -> K_AA^+ u (truncated pinv) or (K_AA + eps I)^{-1} u (ridge chol).

    eps is relative to the max row sum (an upper bound on lambda_max)."""
    if solver in ("chol", "lobpcg", "sketch"):
        eps = eig_tol * torch.max(torch.sum(torch.abs(kaa), dim=1))
        eye = torch.eye(kaa.shape[0], dtype=kaa.dtype, device=kaa.device)
        l = torch.linalg.cholesky(kaa + eps * eye)

        def solve(u: torch.Tensor) -> torch.Tensor:
            col = u.ndim == 1
            out = torch.cholesky_solve(u[:, None] if col else u, l)
            return out[:, 0] if col else out
        return solve
    pinv = psd_pinv(kaa, eig_tol)
    return lambda u: pinv @ u
