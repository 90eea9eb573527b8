"""Spectral filter functions f(lambda) (port of ``graphlap_tpu/ops/filters.py``).

Pure functions on the eigenvalue vector, registered by name. Each works on
torch tensors and numpy arrays alike. Projection filters (``affine=False``)
give z = V f(L) V^T y; affine filters give z = y + V (f(L) - 1) V^T y
(``apply_spectral_filter`` :257).

The eigensolve-free operator modes apply f(W) y through repeated
applications of ``wapply`` (x -> W x): exactly for polynomial filters
(``apply_matvec_filter`` :122), or by a Chebyshev series
(``apply_chebyshev_filter`` :229, coefficients from host numpy);
``apply_operator_filter`` :248 dispatches. See the reference's comments for
why the polynomial form is preferred for affine filters on collapsed
spectra.
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


# Polynomials in W: applied exactly by repeated matvecs (filter_mode="matvec")
MATVEC_FILTERS = ("identity", "power", "sharpen", "twicing")


def check_matvec_filter(name: str, param: float) -> None:
    """Raise unless (name, param) admits exact polynomial application."""
    if name not in MATVEC_FILTERS:
        raise ValueError(
            f"filter_mode='matvec' supports polynomial filters "
            f"{MATVEC_FILTERS}, got {name!r} (use filter_mode='spectral')")
    if name in ("power", "twicing") and (param != int(param) or param < 1):
        raise ValueError(
            f"filter_mode='matvec' needs an integer filter_param >= 1 for "
            f"{name!r} (W^k by k matvecs), got {param!r}")


def apply_matvec_filter(wapply, y, name: str, param: float):
    """z = f(W) y by repeated applications of ``wapply`` (x -> W x)."""
    check_matvec_filter(name, param)
    if name == "identity":
        return wapply(y)                       # z = W y
    if name == "power":
        z = y
        for _ in range(int(param)):
            z = wapply(z)                      # z = W^k y
        return z
    if name == "sharpen":
        # f(l) = 1 + b(1 - l)  =>  z = (1 + b) y - b W y
        return (1.0 + param) * y - param * wapply(y)
    # twicing: f(l) = 1 - (1 - l)^k  =>  z = y - (I - W)^k y
    r = y
    for _ in range(int(param)):
        r = r - wapply(r)
    return y - r


# Chebyshev operator filtering (Hammond, Vandergheynst & Gribonval 2011):
# f on [-1, 1] by a degree-K series through the three-term recurrence
# T_{k+1}(W) y = 2 W T_k(W) y - T_{k-1}(W) y, K matvecs and no eigensolve.
CHEBYSHEV_FILTERS = ("identity", "power", "sharpen", "exp_decay", "twicing")


def check_chebyshev_filter(name: str, param: float) -> None:
    """Raise unless f(lambda) is a scalar function a series can fit
    ('lowpass' is an index-set projection with no operator form)."""
    if name not in CHEBYSHEV_FILTERS:
        raise ValueError(
            f"filter_mode='chebyshev' needs a lambda-function filter "
            f"{CHEBYSHEV_FILTERS}, got {name!r} (lowpass is an index-set "
            f"projection; use filter_mode='spectral')")
    if name in ("power", "twicing") and param < 0:
        raise ValueError(f"{name!r} needs filter_param >= 0, got {param!r}")


def chebyshev_coeffs(name: str, param: float, degree: int) -> np.ndarray:
    """(degree+1,) float64 Chebyshev coefficients of f on [-1, 1] by
    Chebyshev-Gauss quadrature at the degree+1 nodes (host numpy)."""
    check_chebyshev_filter(name, param)
    n = degree + 1
    theta = np.pi * (np.arange(n) + 0.5) / n
    x = np.cos(theta)                       # Chebyshev nodes in (-1, 1)
    fx = np.asarray(FILTER_REGISTRY[name].fn(x, param), np.float64)
    k = np.arange(n)
    t = np.cos(np.outer(k, theta))          # T_k(x_i)
    c = (2.0 / n) * t @ fx
    c[0] *= 0.5
    return c


# tails are fit this far past the degree they certify: quadrature
# coefficients near the fit's end alias
_TAIL_FIT_MARGIN = 64


def chebyshev_tail_bound(name: str, param: float, degree: int) -> float:
    """Sup-norm error bound of the degree-``degree`` series on [-1, 1]:
    sum_{k > K} |c_k| from a fit _TAIL_FIT_MARGIN terms longer."""
    c = chebyshev_coeffs(name, param, degree + _TAIL_FIT_MARGIN)
    return float(np.sum(np.abs(c[degree + 1:])))


def chebyshev_auto_degree(name: str, param: float, tol: float = 1e-6,
                          max_degree: int = 64) -> int:
    """The smallest degree whose tail bound is <= tol (cheb_degree=0),
    clamped to max_degree where f converges only algebraically."""
    c = chebyshev_coeffs(name, param, max_degree + _TAIL_FIT_MARGIN)
    tails = np.cumsum(np.abs(c[::-1]))[::-1]      # tails[k] = sum_{j>=k} |c_j|
    ok = np.nonzero(tails[1:max_degree + 1] <= tol)[0]   # degree k <-> tail k+1
    return max(1, int(ok[0])) if ok.size else max_degree


def apply_chebyshev_filter(wapply, y, name: str, param: float, degree: int):
    """z ~= f(W) y by the three-term recurrence: ``degree`` applications of
    ``wapply``; degree=0 means the auto degree (tail bound <= 1e-6)."""
    if degree == 0:
        degree = chebyshev_auto_degree(name, param)
    c = [float(v) for v in chebyshev_coeffs(name, param, degree)]
    t_prev = y
    z = c[0] * y
    t_cur = wapply(y)
    z = z + c[1] * t_cur
    for j in range(2, degree + 1):
        t_prev, t_cur = t_cur, 2.0 * wapply(t_cur) - t_prev
        z = z + c[j] * t_cur
    return z


def apply_operator_filter(wapply, y, name: str, param: float, mode: str,
                          degree: int = 12):
    """The eigensolve-free modes: 'matvec' (exact polynomial) or
    'chebyshev' (series approximation)."""
    if mode == "chebyshev":
        return apply_chebyshev_filter(wapply, y, name, param, degree)
    return apply_matvec_filter(wapply, y, name, param)


def apply_spectral_filter(y_perm: torch.Tensor, vals: torch.Tensor,
                          vecs: torch.Tensor, name: str,
                          param: float) -> torch.Tensor:
    """z_perm = filter(y_perm) in the eigenbasis, O(N m)."""
    filt = FILTER_REGISTRY[name]
    fvals = filt.fn(vals, param)
    coeffs = vecs.T @ y_perm                     # (m,)
    if filt.affine:
        return y_perm + vecs @ ((fvals - 1.0) * coeffs)
    return vecs @ (fvals * coeffs)
