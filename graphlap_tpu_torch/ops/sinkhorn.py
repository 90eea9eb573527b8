"""Sinkhorn balancing of the Nystrom completion (port of
``graphlap_tpu/ops/sinkhorn.py``: ``_make_kaa_solve`` :34,
``nystrom_matvec`` :59, ``sinkhorn_scaling`` :71,
``sinkhorn_scaling_coarse`` :93, ``normalize_blocks`` :179, ``_EPS``).

The completion K~ = [K_AA K_AB; K_BA K_BA K_AA^+ K_AB] is applied through
the stored (p, N-p) strip and one K_AA solve, two strip products an
application. The symmetric update s <- sqrt(s / K~ s) (Knight 2008) runs a
fixed number of iterations, as the reference's ``fori_loop`` does.

A bf16-stored strip meets f32 vectors here, and jnp promotes the strip to
f32 inside each product: the thin operand stays unrounded f32
(``ops/linalg.strip_mm``), unlike the sketch and cross GEMMs of
``ops/nystrom``, which round it to bf16.
"""

from __future__ import annotations

import torch

from .linalg import PROMOTE_CHUNK, psd_pinv, strip_mm, strip_t_mm

_EPS = 1e-30


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


def nystrom_matvec(kaa, kab, kaa_solve, v_a, v_b):
    """(K~ v) for v = [v_a; v_b] as (top (p,), bottom (N-p,)), through the
    strip only: two strip products and one K_AA solve."""
    u = strip_mm(kab, v_b)                             # (p,)
    top = kaa @ v_a + u
    t = v_a + kaa_solve(u)
    return top, strip_t_mm(kab, t)


def sinkhorn_scaling(kaa, kab, iters: int, eig_tol: float,
                     solver: str = "oneshot"):
    """Scaling vector s with diag(s) K~ diag(s) ~ doubly stochastic, as
    (s_a (p,), s_b (N-p,))."""
    p = kaa.shape[0]
    kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
    s = torch.ones(p + kab.shape[1], dtype=kaa.dtype, device=kaa.device)
    for _ in range(iters):
        top, bottom = nystrom_matvec(kaa, kab, kaa_solve, s[:p], s[p:])
        ks = torch.clamp(torch.cat([top, bottom]), min=_EPS)  # K_BB can dip
        s = torch.sqrt(s / ks)
    return s[:p], s[p:]


def sinkhorn_scaling_coarse(kaa, kab, iters: int, coarse: int, polish: int,
                            eig_tol: float, solver: str = "oneshot"):
    """Alternating Sinkhorn against every ``coarse``-th strip column, one
    full-resolution extension of s_B (a two-vector strip pass), then
    ``polish`` symmetric full-resolution iterations. The decimated strip is
    materialized once, as XLA does with ``kab[:, ::coarse]`` (a strided
    view would be copied again by every product)."""
    p, nb = kaa.shape[0], kab.shape[1]
    dev = kaa.device
    kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
    kab_c = kab[:, ::coarse].contiguous()
    ratio = (torch.tensor(nb, dtype=torch.float32, device=dev)
             / torch.tensor(kab_c.shape[1], dtype=torch.float32, device=dev))

    def coarse_u(t):
        y = strip_t_mm(kab_c, t)                       # (nc,) coarse K_BA t
        return ratio * strip_mm(kab_c, 1.0 / torch.clamp(y, min=_EPS))

    r_a = c_a = torch.ones(p, dtype=torch.float32, device=dev)
    u_r = ratio * strip_mm(kab_c, torch.ones(kab_c.shape[1],
                                             dtype=torch.float32, device=dev))
    t_r = t_c = torch.zeros(p, dtype=torch.float32, device=dev)
    for _ in range(iters):
        c_a = 1.0 / torch.clamp(kaa @ r_a + u_r, min=_EPS)
        t_r = r_a + kaa_solve(u_r)
        u_c = coarse_u(t_r)
        r_a = 1.0 / torch.clamp(kaa @ c_a + u_c, min=_EPS)
        t_c = c_a + kaa_solve(u_c)
        u_r = coarse_u(t_c)
    del kab_c
    s_a = torch.sqrt(torch.clamp(r_a * c_a, min=0.0))
    kbt = strip_t_mm(kab, torch.stack([t_r, t_c], dim=1))  # one strip pass
    s_b = 1.0 / torch.sqrt(torch.clamp(kbt[:, 0] * kbt[:, 1], min=_EPS))

    if polish > 0:
        s = torch.cat([s_a, s_b])
        for _ in range(polish):
            top, bottom = nystrom_matvec(kaa, kab, kaa_solve, s[:p], s[p:])
            s = torch.sqrt(s / torch.clamp(torch.cat([top, bottom]),
                                           min=_EPS))
        s_a, s_b = s[:p], s[p:]
    return s_a, s_b


def scale_strip(kab: torch.Tensor, s_a: torch.Tensor,
                s_b: torch.Tensor) -> torch.Tensor:
    """W_AB = (K_AB * (s_a s_b^T)) in the strip's storage dtype, with the
    reference's rounding order: the f32 outer product first, then the
    product with k, then the cast. Column chunks keep that order without
    the (p, N-p) f32 outer product a literal expression would allocate."""
    out = torch.empty(kab.shape, dtype=kab.dtype, device=kab.device)
    for j in range(0, kab.shape[1], PROMOTE_CHUNK):
        sl = slice(j, j + PROMOTE_CHUNK)
        out[:, sl] = kab[:, sl] * (s_a[:, None] * s_b[None, sl])
    return out


def normalize_scales(kaa, kab, normalization: str, iters: int,
                     eig_tol: float, solver: str = "oneshot", coarse: int = 1,
                     polish: int = 0):
    """The scales (s_a (p,), s_b (N-p,)) of ``normalize_blocks`` alone (the
    operator-filter route needs no scaled blocks; XLA drops them there)."""
    p = kaa.shape[0]
    nb = kab.shape[1]
    if normalization == "sinkhorn" and coarse > 1:
        return sinkhorn_scaling_coarse(kaa, kab, iters, coarse, polish,
                                       eig_tol, solver)
    if normalization == "sinkhorn":
        return sinkhorn_scaling(kaa, kab, iters, eig_tol, solver)
    if normalization == "symmetric":
        kaa_solve = _make_kaa_solve(kaa, eig_tol, solver)
        top, bottom = nystrom_matvec(
            kaa, kab, kaa_solve,
            torch.ones(p, dtype=kaa.dtype, device=kaa.device),
            torch.ones(nb, dtype=kaa.dtype, device=kaa.device))
        return (torch.rsqrt(torch.clamp(top, min=_EPS)),
                torch.rsqrt(torch.clamp(bottom, min=_EPS)))
    return (torch.ones(p, dtype=kaa.dtype, device=kaa.device),
            torch.ones(nb, dtype=kaa.dtype, device=kaa.device))


def normalize_blocks(kaa, kab, normalization: str, iters: int, eig_tol: float,
                     solver: str = "oneshot", coarse: int = 1,
                     polish: int = 0):
    """Scaled blocks (W_AA, W_AB, s_a, s_b) per the normalization:
    sinkhorn (doubly stochastic; ``coarse > 1`` runs the decimated loop
    with ``polish`` full-resolution iterations), symmetric
    (s = 1/sqrt(K~ 1)) or none (s = 1). W_AB keeps the strip's storage
    dtype (the bfloat16_store policy)."""
    s_a, s_b = normalize_scales(kaa, kab, normalization, iters, eig_tol,
                                solver, coarse, polish)
    waa = kaa * (s_a[:, None] * s_a[None, :])
    return waa, scale_strip(kab, s_a, s_b), s_a, s_b
