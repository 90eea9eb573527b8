"""Blockwise streaming operators: the K strip is recomputed, never stored
(port of ``graphlap_tpu/ops/streaming.py``: ``matvec`` :78, ``rmatvec`` :93,
``gram`` :106, ``rmatmat_colstats`` :121, ``rmatmat_colstats_v`` :144,
``rmatmat`` :170, ``sinkhorn_coarse_step`` :190, ``rmatvec2`` :216,
``rmat_apply`` :229).

Every product walks the columns in chunks and recomputes each (p, chunk)
kernel tile from the features: f32 distances and exp, the tile rounded to
``dtype``, then a dot with bf16 (or f32) operands and f32 accumulation —
the reference's ``lax.scan`` bodies as Python loops. ``block`` is the
chunk width: the reference's column block on the CPU; on the card the
callers may pass a wider chunk (fewer launches), which changes only the
order of the f32 sums across chunks.

Column scale vectors must be 0 on padding; zero columns vanish exactly.
"""

from __future__ import annotations

import torch

from .affinity import affinity_strip
from .linalg import mm_f32

_EPS = 1e-30


def _kernel_blk(feats_a: torch.Tensor, fb: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """(p, chunk) kernel tile; f32 distances and exp, rounded to dtype."""
    return affinity_strip(feats_a, fb, dtype).to(dtype)


def _dot(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands in the tile dtype, f32 accumulate and out."""
    col = b.ndim == 1
    b2 = b[:, None] if col else b
    if dtype == torch.bfloat16:
        out = mm_f32(a.to(dtype), b2.to(dtype))
    else:
        out = a.to(torch.float32) @ b2.to(torch.float32)
    return out[:, 0] if col else out


def _chunks(n: int, block: int):
    for c0 in range(0, n, block):
        yield slice(c0, min(n, c0 + block))


def matvec(feats_a, feats_pad, v, row_scale, col_scale, block, dtype):
    """(D_r C D_c) v -> (p,)."""
    vs = v * col_scale
    acc = torch.zeros(feats_a.shape[0], dtype=torch.float32,
                      device=feats_a.device)
    for sl in _chunks(feats_pad.shape[0], block):
        kb = _kernel_blk(feats_a, feats_pad[sl], dtype)
        acc = acc + _dot(kb, vs[sl], dtype)
    return acc * row_scale


def rmatvec(feats_a, feats_pad, t, row_scale, col_scale, block, dtype):
    """(D_r C D_c)^T t -> (n_pad,)."""
    tr = t * row_scale
    out = [_dot(_kernel_blk(feats_a, feats_pad[sl], dtype).T, tr, dtype)
           for sl in _chunks(feats_pad.shape[0], block)]
    return torch.cat(out) * col_scale


def gram(feats_a, feats_pad, row_scale, col_scale, block, dtype):
    """(D_r C D_c)(D_r C D_c)^T -> (p, p): the one-shot cross, the XLA
    branch of ``_stream_cross`` where the K7 emitter's tiling does not
    fit."""
    p = feats_a.shape[0]
    cs = col_scale.to(dtype)
    acc = torch.zeros((p, p), dtype=torch.float32, device=feats_a.device)
    for sl in _chunks(feats_pad.shape[0], block):
        kb = _kernel_blk(feats_a, feats_pad[sl], dtype) * cs[None, sl]
        acc = acc + _dot(kb, kb.T, dtype)
    return acc * (row_scale[:, None] * row_scale[None, :])


def _scaled_blk(feats_a, fb, cs, dtype):
    """The column-scaled tile bf16(k * bf16(c)) (or f32) of the colstats
    passes: ``cs`` already in the tile dtype."""
    return _kernel_blk(feats_a, fb, dtype) * cs[None, :]


def rmatmat_colstats(feats_a, feats_pad, g, y, row_scale, col_scale, block,
                     dtype):
    """One pass over V = (D_c C^T D_r) G (n_pad, m) -> (column sq-norms
    (m,), V^T y (m,)), V never materialized."""
    cs = col_scale.to(dtype)
    gr = g * row_scale[:, None]
    m = g.shape[1]
    norms = torch.zeros(m, dtype=torch.float32, device=feats_a.device)
    coeffs = torch.zeros_like(norms)
    for sl in _chunks(feats_pad.shape[0], block):
        vb = _dot(_scaled_blk(feats_a, feats_pad[sl], cs[sl], dtype).T, gr,
                  dtype)
        norms = norms + torch.sum(vb * vb, dim=0)
        coeffs = coeffs + vb.T @ y[sl]
    return norms, coeffs


def rmatmat_colstats_v(feats_a, feats_pad, g, y, row_scale, col_scale,
                       block, dtype):
    """``rmatmat_colstats`` that also returns V (n_pad, m) f32: the plain
    version, at the model level, of the colstats+V kernel (K10)."""
    cs = col_scale.to(dtype)
    gr = g * row_scale[:, None]
    m = g.shape[1]
    v = torch.empty((feats_pad.shape[0], m), dtype=torch.float32,
                    device=feats_a.device)
    norms = torch.zeros(m, dtype=torch.float32, device=feats_a.device)
    coeffs = torch.zeros_like(norms)
    for sl in _chunks(feats_pad.shape[0], block):
        vb = _dot(_scaled_blk(feats_a, feats_pad[sl], cs[sl], dtype).T, gr,
                  dtype)
        v[sl] = vb
        norms = norms + torch.sum(vb * vb, dim=0)
        coeffs = coeffs + vb.T @ y[sl]
    return norms, coeffs, v


def rmatmat(feats_a, feats_pad, g, row_scale, col_scale, block, dtype):
    """(D_c C^T D_r) G -> (n_pad, m), materialized chunk by chunk."""
    cs = col_scale.to(dtype)
    gr = g * row_scale[:, None]
    return torch.cat([
        _dot(_scaled_blk(feats_a, feats_pad[sl], cs[sl], dtype).T, gr, dtype)
        for sl in _chunks(feats_pad.shape[0], block)])


def rmat_apply(feats_a, feats_pad, g, w, row_scale, col_scale, block, dtype):
    """(D_r C D_c)^T (G w) -> (n_pad,): the extension apply of the V-free
    factor."""
    gw = (g @ w) * row_scale
    return torch.cat([
        _dot(_kernel_blk(feats_a, feats_pad[sl], dtype).T, gw, dtype)
        * col_scale[sl] for sl in _chunks(feats_pad.shape[0], block)])


def sinkhorn_coarse_step(feats_a, feats_c, t, mask_c, ratio, block, dtype):
    """One coarse Sinkhorn contraction u = ratio * K_c (mask_c / (K_c^T t)),
    each tile computed once and used by both dots."""
    acc = torch.zeros(feats_a.shape[0], dtype=torch.float32,
                      device=feats_a.device)
    for sl in _chunks(feats_c.shape[0], block):
        kb = _kernel_blk(feats_a, feats_c[sl], dtype)
        y = _dot(kb.T, t, dtype)
        r = mask_c[sl] / torch.clamp(y, min=_EPS)
        acc = acc + _dot(kb, r, dtype)
    return acc * ratio


def rmatvec2(feats_a, feats_pad, t2, col_scale, block, dtype):
    """K^T [t1 t2] -> (n_pad, 2) in one pass over shared tiles (the
    full-resolution Sinkhorn extension needs K_BA t for two vectors). Each
    column's output sums over p only, so the chunk width changes nothing
    but the GEMM's blocking."""
    out = [_dot(_kernel_blk(feats_a, feats_pad[sl], dtype).T, t2, dtype)
           for sl in _chunks(feats_pad.shape[0], block)]
    return torch.cat(out) * col_scale[:, None]
