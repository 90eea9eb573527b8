"""Small dense-linalg helpers at p x p scale (port of
``graphlap_tpu/ops/linalg.py``), and the strip products of the dense path.

Soft spectral truncation at a relative cutoff (a linear ramp over
[tol, 2 tol] * lambda_max): a hard step lets near-degenerate eigenvalue
clusters straddling the cutoff rotate kept mass into killed mass between
precisions, while the ramp gives cluster members nearly equal weights. The
reference's docstring records the measurements behind this choice.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


# column chunk of the promoting strip products: one chunk's f32 copy of a
# p = 5243-row bf16 strip is 344 MB
PROMOTE_CHUNK = 16384


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 operands with an f32 result and no output rounding.
    ``torch.matmul`` on bf16 returns bf16. On CUDA, cuBLAS writes f32
    directly (aten::mm.dtype); the CPU has no such kernel, so there the
    operands are upcast — products of bf16 values are exact in f32, so
    both forms are bf16-in / f32-out."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def _eigh_sym(mat: torch.Tensor):
    return torch.linalg.eigh(0.5 * (mat + mat.T))


def _soft_gate(vals: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    """Linear ramp 0 -> 1 over [cutoff, 2 * cutoff]."""
    return torch.clamp(vals / cutoff - 1.0, 0.0, 1.0)


def _cutoff(vals: torch.Tensor, rel_tol: float) -> torch.Tensor:
    return rel_tol * torch.clamp(torch.max(vals), min=_TINY)


def trunc_inv_sqrt_vals(vals: torch.Tensor, rel_tol: float) -> torch.Tensor:
    """Elementwise lambda^{-1/2}, softly gated to 0 below the relative cutoff."""
    cutoff = _cutoff(vals, rel_tol)
    safe = torch.maximum(vals, cutoff)
    return _soft_gate(vals, cutoff) * safe ** -0.5


def trunc_inv_vals(vals: torch.Tensor, rel_tol: float) -> torch.Tensor:
    """Elementwise 1/lambda, softly gated to 0 below the relative cutoff."""
    cutoff = _cutoff(vals, rel_tol)
    safe = torch.maximum(vals, cutoff)
    return _soft_gate(vals, cutoff) / safe


def psd_pinv(mat: torch.Tensor, rel_tol: float) -> torch.Tensor:
    """Truncated pseudo-inverse of a symmetric PSD matrix."""
    vals, vecs = _eigh_sym(mat)
    return (vecs * trunc_inv_vals(vals, rel_tol)[None, :]) @ vecs.T


def psd_pinv_sqrt(mat: torch.Tensor, rel_tol: float) -> torch.Tensor:
    """Truncated pseudo inverse square root M^{-1/2}."""
    vals, vecs = _eigh_sym(mat)
    return (vecs * trunc_inv_sqrt_vals(vals, rel_tol)[None, :]) @ vecs.T


def strip_mm(strip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """strip @ x as jnp writes it for an f32 ``x``: a bf16 strip is promoted
    to f32 inside the product and x stays unrounded f32. torch has no
    bf16 x f32 product and ``strip.float()`` would copy the whole strip, so
    a bf16 strip is upcast one column chunk at a time, each chunk's f32
    product added in f32. f32 strips take one full-f32 product."""
    x = x.to(torch.float32)
    if strip.dtype != torch.bfloat16:
        return strip @ x
    out = None
    for j in range(0, strip.shape[1], PROMOTE_CHUNK):
        part = strip[:, j:j + PROMOTE_CHUNK].to(torch.float32) @ x[
            j:j + PROMOTE_CHUNK]
        out = part if out is None else out + part
    return out


def strip_t_mm(strip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """strip.T @ x with the promotion of ``strip_mm``: each column chunk of
    a bf16 strip gives its own rows of the result."""
    x = x.to(torch.float32)
    if strip.dtype != torch.bfloat16:
        return strip.T @ x
    return torch.cat([strip[:, j:j + PROMOTE_CHUNK].to(torch.float32).T @ x
                      for j in range(0, strip.shape[1], PROMOTE_CHUNK)])
