"""Nystrom eigensolve (port of ``graphlap_tpu/ops/nystrom.py``:
``EigenBasis`` :60, ``nystrom_eigh`` :72 (the one-shot solver),
``_ridge_eps`` :116, ``nystrom_chol_factor`` :120, ``_orthonormalize``
:195, ``_strip_sandwich`` :210, ``nystrom_sketch_factor`` :225,
``nystrom_eigh_sketch`` :270, ``_cross_gemm`` :280, ``nystrom_eigh_chol``
:292, ``_LIVE_NORM2`` :57).

The fused strip_cache path inlines the randomized sketch solve into its
strip sweeps (models/streaming._factor_strip_fused); the unfused one calls
``nystrom_sketch_factor`` with a sandwich over the strip; the recompute
path solves its p x p problem with ``nystrom_chol_factor``. The dense path
(models/pipeline) calls ``nystrom_eigh``, ``nystrom_eigh_chol`` or
``nystrom_eigh_sketch`` on the scaled blocks (W_AA, W_AB).

Rounding of a bf16-stored W_AB follows the reference product by product:
the sketch sandwich and the bf16 cross round the thin operand to bf16
(bf16 in, f32 out); the f32-typed cross of a bf16 strip is jnp's bf16
product, rounded to bf16; the extension W_AB^T X promotes the strip to f32
(``ops/linalg.strip_t_mm``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .linalg import (mm_f32, psd_pinv_sqrt, strip_t_mm,
                     trunc_inv_sqrt_vals)
from .lobpcg import lobpcg_standard

# columns whose true squared norm falls below this are spurious (live
# columns sit at ~1, truncation-killed at 0)
_LIVE_NORM2 = 0.25


class EigenBasis(NamedTuple):
    """Top-m approximate eigenpairs of the scaled filter matrix W~: ``vecs``
    rows in permuted [A; B] pixel order, descending eigenvalues."""

    vals: torch.Tensor    # (m,)
    vecs: torch.Tensor    # (N, m)


def nystrom_eigh(waa: torch.Tensor, wab: torch.Tensor, m: int,
                 eig_tol: float) -> EigenBasis:
    """The one-shot solver: Whalf = W_AA^{-1/2}, S = W_AA + Whalf (W_AB
    W_AB^T) Whalf, top-m of eigh(S), the extension [W_AA; W_AB^T] Whalf
    U_m L^{-1/2}, then each column rescaled to unit norm, or zeroed where
    its squared norm is at most ``_LIVE_NORM2`` (the f32 safety net; see
    the reference's module docstring)."""
    whalf = psd_pinv_sqrt(waa, eig_tol)
    cross = _cross_gemm(wab, torch.float32)             # jnp's wab @ wab.T
    s_mat = waa + whalf @ cross @ whalf
    s_mat = 0.5 * (s_mat + s_mat.T)
    vals, vecs = torch.linalg.eigh(s_mat)               # ascending
    vals_m = torch.flip(vals, (0,))[:m]
    vecs_m = torch.flip(vecs, (1,))[:, :m]
    basis0 = whalf @ (vecs_m * trunc_inv_sqrt_vals(vals_m, eig_tol)[None, :])
    v_a = waa @ basis0
    v_b = strip_t_mm(wab, basis0)
    d = torch.sum(v_a * v_a, dim=0) + torch.sum(v_b * v_b, dim=0)
    live = d > _LIVE_NORM2
    scale = torch.where(live, 1.0 / torch.sqrt(torch.where(live, d, 1.0)),
                        0.0)
    return EigenBasis(vals=vals_m,
                      vecs=torch.cat([v_a, v_b], dim=0) * scale[None, :])


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


def _strip_sandwich(wab: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """W_AB (W_AB^T t), two thin strip passes: a bf16 strip takes bf16
    operands (the thin f32 ones rounded) with f32 accumulate and output,
    an f32 strip full-f32 products."""
    if wab.dtype == torch.bfloat16:
        u = mm_f32(wab.T, t.to(torch.bfloat16))
        return mm_f32(wab, u.to(torch.bfloat16))
    return wab @ (wab.T @ t)


def nystrom_eigh_sketch(waa: torch.Tensor, wab: torch.Tensor, m: int,
                        eig_tol: float, oversample: int = 78, power: int = 2,
                        omega: torch.Tensor | None = None) -> EigenBasis:
    """The randomized sketch on the materialized W_AB (``omega`` its test
    matrix, default ``sketch_omega``), V = [W_AA X; W_AB^T X]."""
    vals_m, x = nystrom_sketch_factor(waa, lambda t: _strip_sandwich(wab, t),
                                      m, eig_tol, oversample, power, omega)
    return EigenBasis(vals=vals_m,
                      vecs=torch.cat([waa @ x, strip_t_mm(wab, x)], dim=0))


def _cross_gemm(wab: torch.Tensor, gemm_dtype: torch.dtype) -> torch.Tensor:
    """W_AB W_AB^T: bf16 inputs with f32 accumulate and output for a bf16
    ``gemm_dtype``; else the product in the strip's own type — full f32 for
    an f32 strip, and for a bf16 strip jnp's bf16 product (f32 accumulate,
    the result rounded to bf16), returned as f32."""
    if gemm_dtype == torch.bfloat16:
        wb = wab.to(torch.bfloat16)
        return mm_f32(wb, wb.T)
    if wab.dtype == torch.bfloat16:
        return mm_f32(wab, wab.T).to(torch.bfloat16).to(torch.float32)
    return wab @ wab.T


def nystrom_eigh_chol(waa: torch.Tensor, wab: torch.Tensor, m: int,
                      eig_tol: float, method: str = "eigh",
                      gemm_dtype: torch.dtype = torch.float32,
                      lobpcg_iters: int = 60,
                      x0: torch.Tensor | None = None) -> EigenBasis:
    """The Cholesky / ridge solver on the dense cross (``x0``: LOBPCG's
    start block, default ``lobpcg_x0``), V = [W_AA X; W_AB^T X]."""
    vals_m, x = nystrom_chol_factor(waa, _cross_gemm(wab, gemm_dtype), m,
                                    eig_tol, method, lobpcg_iters, x0)
    return EigenBasis(vals=vals_m,
                      vecs=torch.cat([waa @ x, strip_t_mm(wab, x)], dim=0))
