"""Small dense-linalg helpers at p x p scale (port of
``graphlap_tpu/ops/linalg.py``).

Soft spectral truncation at a relative cutoff (a linear ramp over
[tol, 2 tol] * lambda_max): a hard step lets near-degenerate eigenvalue
clusters straddling the cutoff rotate kept mass into killed mass between
precisions, while the ramp gives cluster members nearly equal weights. The
reference's docstring records the measurements behind this choice.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


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
