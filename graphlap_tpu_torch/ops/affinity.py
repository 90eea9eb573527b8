"""Pixel-affinity construction: features, the K strip and the dense path's
blocks (port of ``graphlap_tpu/ops/affinity.py``; ``affinity_blocks`` :196).

The image is unfolded once into an (N, d) feature tensor with the bandwidth
folded in (feats = raw / h), so every kernel evaluation is the GEMM trick
``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b`` and the kernel is uniformly
``K = exp(-|f_i - f_j|^2)``. The f32 GEMMs run at full f32 precision (the
package pins TF32 off): the distance cancellation is what the reference
pins "highest" for.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import PipelineConfig
from . import cuda_affinity as k1


def feature_dim(cfg: PipelineConfig) -> int:
    d = cfg.patch_size * cfg.patch_size if cfg.kernel == "nlm" else 1
    if cfg.spatial_h > 0.0:
        d += 2
    return d


def _tile_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _unfold_patches(img: torch.Tensor, patch: int) -> torch.Tensor:
    """(H, W) -> (H*W, patch*patch) reflect-padded neighbourhoods, in the
    reference's (dy, dx) lane order."""
    r = patch // 2
    h, w = img.shape
    padded = F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]
    views = [padded[dy:dy + h, dx:dx + w]
             for dy in range(patch) for dx in range(patch)]
    return torch.stack(views, dim=-1).reshape(h * w, patch * patch)


def _coords(h_img: int, w_img: int, cfg: PipelineConfig,
            device) -> torch.Tensor:
    yy, xx = torch.meshgrid(
        torch.arange(h_img, dtype=torch.float32, device=device),
        torch.arange(w_img, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=-1) / cfg.spatial_h


def extract_features(img: torch.Tensor, cfg: PipelineConfig,
                     h=None) -> torch.Tensor:
    """(H, W) image -> (N, d) feature rows with bandwidths folded in.

    gaussian: f_i = y_i / h;  nlm: f_i = P_i / (h * patch);  spatial_h > 0
    appends (row, col) / spatial_h. ``h`` overrides cfg.h. The features stay
    on ``img``'s device."""
    h_img, w_img = img.shape
    img = img.to(torch.float32)
    h = cfg.h if h is None else h
    if cfg.kernel == "nlm":
        d = cfg.patch_size * cfg.patch_size
        feats = _unfold_patches(img, cfg.patch_size) / (h * math.sqrt(d))
    else:
        feats = (img / h).reshape(-1, 1)
    if cfg.spatial_h > 0.0:
        feats = torch.cat([feats, _coords(h_img, w_img, cfg, img.device)],
                          dim=-1)
    if cfg.feature_dtype == "bfloat16":
        feats = feats.to(torch.bfloat16)
    return feats


def extract_features_padded(img: torch.Tensor, cfg: PipelineConfig,
                            n_pad: int, h=None) -> torch.Tensor:
    """Features written into a zero-padded (n_pad, d) buffer; padding rows
    stay exactly zero. The reference unfolds in row chunks to bound its
    peak memory at 64 MP; the slice's images are far below that, so the
    port unfolds in one piece (the values are bit-identical either way)."""
    n = img.shape[0] * img.shape[1]
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < N {n}")
    feats = extract_features(img, cfg, h=h)
    out = torch.zeros((n_pad, feats.shape[1]), dtype=feats.dtype,
                      device=feats.device)
    out[:n] = feats
    return out


def affinity_strip(feats_a: torch.Tensor, feats_all: torch.Tensor,
                   dtype: torch.dtype = torch.float32,
                   store_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K strip (p, N): K[i, j] = exp(-|f_Ai - f_j|^2) via the GEMM trick.

    The GEMM inputs round to ``dtype`` (bf16 allowed; products of bf16
    values are exact in f32, so an f32 GEMM on the rounded values is the
    reference's bf16-in / f32-accumulate dot). Norms come from the f32
    features, distances clamp at 0, and ``store_dtype`` narrows only the
    stored output (the bfloat16_store policy)."""
    a = feats_a.to(dtype).to(torch.float32)
    b = feats_all.to(dtype).to(torch.float32)
    cross = a @ b.T
    fa = feats_a.to(torch.float32)
    fb = feats_all.to(torch.float32)
    na = torch.sum(fa * fa, dim=1)
    nb = torch.sum(fb * fb, dim=1)
    d2 = torch.clamp(na[:, None] + nb[None, :] - 2.0 * cross, min=0.0)
    out = torch.exp(-d2)
    return out if store_dtype is None else out.to(store_dtype)


def affinity_blocks(img: torch.Tensor, idx_a: torch.Tensor,
                    perm: torch.Tensor, cfg: PipelineConfig, h=None,
                    plain: bool = False):
    """The dense path's (K_AA (p, p), K_AB (p, N-p)) for one channel, in
    permuted [A; B] order (``perm`` int64 on ``img``'s device).

    K_AA is always the f32-stored ``affinity_strip`` (it feeds the p x p
    solves); K_AB comes from K1 (``affinity_strip_cuda``, or with ``plain``
    its PyTorch version) with ``use_pallas``, else from ``affinity_strip``.
    The GEMM inputs round to bf16 under ``affinity_dtype="bfloat16"``, and
    only the K_AB store narrows under ``"bfloat16_store"``. On the card K1
    may return a view over padded rows (a ragged N - p), and on features
    with coordinates (``spatial_h > 0``) takes its IEEE f32 cross."""
    feats_perm = extract_features(img, cfg, h=h)[perm]
    p = idx_a.shape[0]
    feats_a = feats_perm[:p]
    dtype = _tile_dtype(cfg.affinity_dtype)
    store = (torch.bfloat16 if cfg.affinity_dtype == "bfloat16_store"
             else None)
    kaa = affinity_strip(feats_a, feats_a, dtype)
    if cfg.use_pallas:
        emit = k1.affinity_strip_plain if plain else k1.affinity_strip_cuda
        kab = emit(feats_a, feats_perm[p:], dtype, store,
                   coords=cfg.spatial_h > 0.0)
    else:
        kab = affinity_strip(feats_a, feats_perm[p:], dtype, store)
    return kaa, kab
