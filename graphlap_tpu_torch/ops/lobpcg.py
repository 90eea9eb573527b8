"""Top-k standard eigenpairs by LOBPCG: a port of JAX's
``jax.experimental.sparse.linalg.lobpcg_standard`` (jax/experimental/
sparse/linalg.py, JAX 0.9; Apache License 2.0, Copyright The JAX Authors),
which the reference's ``nystrom_chol_factor`` calls with ``m=lobpcg_iters``.

The same algorithm, step for step: an orthonormal basis kept for X, P and
R; the Rayleigh-Ritz on [X, P, R]; SVQB orthonormalization (twice) with
rank truncation; the "twice is enough" projection of R against [X, P]; the
P update orthogonalized in the Ritz basis through a QR; the same stopping
rule (every residual below tol * 10 * n * (|A x| + theta), tol = f32 eps)
and the same iteration cap. ``torch.lobpcg`` is another variant (another
basis update and stopping rule) and computes something else at a fixed
cap, so it is not used. Matrix products run at full f32 precision (the
reference's ``Precision.HIGHEST``; the package pins TF32 off).
"""

from __future__ import annotations

from typing import Callable

import torch


def _norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, ord=2, dim=0, keepdim=True)


def _eigh_descending(a: torch.Tensor):
    w, v = torch.linalg.eigh(a)
    return torch.flip(w, (0,)), torch.flip(v, (1,))


def _svqb(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of span(x), trailing columns zeroed where x is
    numerically rank-deficient."""
    norms = _norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The component of u orthogonal to the (orthonormal, zero columns
    allowed) basis; nonzero columns orthonormal."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_norms(u) >= 0.99).to(u.dtype)


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
    """m further orthonormal directions to the orthonormal x, by a block
    Householder reflector (deterministic, unlike a random draw)."""
    n, k = x.shape
    xu, xl = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(xu)
    y = torch.cat([xu + u @ vt, xl], dim=0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype,
                                   device=x.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(a: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, m: int = 100, tol: float | None = None):
    """(theta (k,), U (n, k), iterations) for the top-k eigenpairs of the
    symmetric operator ``a``, from the start block x (n, k); 0 < 5 k < n."""
    n, k = x.shape
    if k == 0 or 5 * k >= n:
        raise ValueError(f"expected 0 < search dim * 5 < matrix dim (got "
                         f"{k * 5}, {n})")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a(x)
    theta = torch.sum(x * ax, dim=0, keepdim=True)
    r = ax - theta * x
    i, converged = 0, 0
    while i < m and converged < k:
        r = _project_out(torch.cat([x, p], dim=1), r)
        xpr = torch.cat([x, p, r], dim=1)
        theta_all, q = _eigh_descending(xpr.T @ a(xpr))
        b = q[:, :k]
        b = b / _norms(b)
        x = xpr @ b
        x = x / _norms(x)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = _norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a(x)
        r = ax - theta_all[None, :k] * x
        resid = torch.linalg.vector_norm(r, ord=2, dim=0)
        reltol = (torch.linalg.vector_norm(ax, ord=2, dim=0)
                  + theta_all[:k]) * n * 10
        converged = int(torch.sum(resid < tol * reltol))
        theta = theta_all[None, :k]
        i += 1
    return theta[0], x, i
