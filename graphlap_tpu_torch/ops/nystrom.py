"""Nystrom eigensolve pieces (port of ``graphlap_tpu/ops/nystrom.py``:
``_ridge_eps`` :116, ``nystrom_chol_factor`` :120, ``_orthonormalize``
:195, ``nystrom_sketch_factor`` :225, ``_LIVE_NORM2``).

The fused strip_cache path inlines the randomized sketch solve into its
strip sweeps (models/streaming._factor_strip_fused); the unfused one calls
``nystrom_sketch_factor`` with a sandwich over the strip; the recompute
path solves its p x p problem with ``nystrom_chol_factor``. The
materialized-``wab`` sketch and the one-shot solver wait for the dense-path
port (ROADMAP.md Queue 1, M5 / M2).
"""

from __future__ import annotations

import torch

from .linalg import trunc_inv_sqrt_vals
from .lobpcg import lobpcg_standard

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


def sketch_omega(p: int, k: int, device) -> torch.Tensor:
    """The sketch's (p, k) Gaussian test matrix, from a seed-0 generator on
    ``device`` (the reference draws jax.random.normal(PRNGKey(0)), which
    torch cannot reproduce: parity tests pass that matrix in instead)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((p, k), generator=gen, dtype=torch.float32,
                       device=device)


def lobpcg_x0(p: int, m: int, device) -> torch.Tensor:
    """LOBPCG's (p, m) start block, from a seed-0 generator on ``device``
    (the reference draws jax.random.normal(PRNGKey(0)), which torch cannot
    reproduce: parity tests pass that block in instead)."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn((p, m), generator=gen, dtype=torch.float32,
                       device=device)


def nystrom_chol_factor(waa: torch.Tensor, cross: torch.Tensor, m: int,
                        eig_tol: float, method: str = "eigh",
                        lobpcg_iters: int = 60,
                        x0: torch.Tensor | None = None):
    """(vals (m,) descending, factor X (p, m)) with V = C X, from the ridge
    Cholesky A = W_AA + eps I = L L^T and M = L^-1 (W_AA^2 + cross) L^-T:
    "eigh" takes the top m of a dense eigh of M; "lobpcg" runs
    ``lobpcg_standard`` from ``x0`` (default ``lobpcg_x0``) for at most
    ``lobpcg_iters`` iterations, and falls back to eigh where 5 m >= p
    (LOBPCG's search-dimension bound)."""
    p = waa.shape[0]
    eye = torch.eye(p, dtype=waa.dtype, device=waa.device)
    l = torch.linalg.cholesky(waa + _ridge_eps(waa, eig_tol) * eye)
    g = waa @ waa + cross
    t1 = torch.linalg.solve_triangular(l, g, upper=False)       # L^-1 G
    m_mat = torch.linalg.solve_triangular(l, t1.T, upper=False)
    m_mat = 0.5 * (m_mat + m_mat.T)
    if method == "lobpcg" and 5 * m >= p:
        method = "eigh"
    if method == "lobpcg":
        x = lobpcg_x0(p, m, waa.device) if x0 is None else x0.to(waa)
        if x.shape != (p, m):
            raise ValueError(f"x0 shape {tuple(x.shape)} != {(p, m)}")
        vals_m, y_m, _ = lobpcg_standard(lambda v: m_mat @ v, x,
                                         m=lobpcg_iters)
        order = torch.argsort(vals_m, descending=True)
        vals_m, y_m = vals_m[order], y_m[:, order]
    else:
        vals, y = torch.linalg.eigh(m_mat)
        vals_m = torch.flip(vals, (0,))[:m]
        y_m = torch.flip(y, (1,))[:, :m]
    inv_sqrt = trunc_inv_sqrt_vals(vals_m, eig_tol)
    x = torch.linalg.solve_triangular(l.T, y_m * inv_sqrt[None, :],
                                      upper=True)
    return vals_m, x


def nystrom_sketch_factor(waa: torch.Tensor, sandwich, m: int, eig_tol: float,
                          oversample: int = 78, power: int = 2,
                          omega: torch.Tensor | None = None):
    """(vals (m,) descending, factor X (p, m)) with V = C X, by randomized
    subspace iteration on M = L^-1 (W_AA^2 + W_AB W_AB^T) L^-T without
    forming the cross: ``sandwich`` maps t (p, k) to W_AB W_AB^T t (the
    strip_cache caller folds the Sinkhorn scales into its thin passes).
    ``omega``: the (p, k) test matrix, k = min(m + oversample, p) (default
    ``sketch_omega``); then ``power`` re-orthonormalized applies, a
    Rayleigh-Ritz step on the (k, k) projection, and the top m."""
    p = waa.shape[0]
    k = min(m + oversample, p)
    eye = torch.eye(p, dtype=waa.dtype, device=waa.device)
    l = torch.linalg.cholesky(waa + _ridge_eps(waa, eig_tol) * eye)

    def m_apply(v):                                    # (p, k) -> M v
        t = torch.linalg.solve_triangular(l.T, v, upper=True)
        u = waa @ (waa @ t) + sandwich(t)
        return torch.linalg.solve_triangular(l, u, upper=False)

    om = sketch_omega(p, k, waa.device) if omega is None else omega.to(waa)
    if om.shape != (p, k):
        raise ValueError(f"omega shape {tuple(om.shape)} != {(p, k)}")
    y = m_apply(om)
    for _ in range(power):
        y = m_apply(_orthonormalize(y))
    q = _orthonormalize(y)
    b = q.T @ m_apply(q)                               # Rayleigh-Ritz (k, k)
    b = 0.5 * (b + b.T)
    vals, svecs = torch.linalg.eigh(b)                 # ascending
    vals_m = torch.flip(vals, (0,))[:m]
    y_m = q @ torch.flip(svecs, (1,))[:, :m]
    inv_sqrt = trunc_inv_sqrt_vals(vals_m, eig_tol)
    x = torch.linalg.solve_triangular(l.T, y_m * inv_sqrt[None, :],
                                      upper=True)
    return vals_m, x
