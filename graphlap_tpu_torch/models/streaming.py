"""The streaming model (port of ``graphlap_tpu/models/streaming.py``) on
its kernel paths:

* strip_cache (config 2): affinity strip -> coarse Sinkhorn -> fused strip
  sweeps with the inlined sketch eigensolve -> spectral filter. The
  (p, n_pad) strip is materialized once by the K1 emitter (ops/cuda_affinity)
  at p_pad rows with poisoned padding features, so its padding rows and
  columns are exactly zero, and every strip product afterwards is either a
  fused sweep (K2-K4, ops/cuda_strip) or a bf16-in / f32-out GEMM on it.
* recompute streaming with the fused finish (config 4, 8 MP): no strip.
  The coarse Sinkhorn recomputes decimated tiles (ops/streaming), sweep 1
  is K8, the decimated gram is K7 plus one GEMM, the p x p solve is the
  Cholesky ridge with LOBPCG, and sweep 2 (polish rmatvec + V) is K9
  (ops/cuda_recompute), all on the reference's padded layouts
  (ops/recompute_layout).
* recompute streaming with an operator filter (config 3 sharpen, the 8 MP
  matvec denoise): coarse Sinkhorn, the full-resolution extension
  (ops/streaming.rmatvec2), the polish, and f(W) y by repeated
  W x = s K~(s x), each K~ application one K5 matvec and one K6 rmatvec
  (ops/cuda_matvec) on the bf16 aug or f32 plain layout. No eigensolve.
* the unfused spectral schedule (``_normalize_streaming`` +
  ``_eigensolve_streaming``): every spectral recipe outside the two fused
  gates (the 8 MP turbo recipe, p_pad past the whole-p tile) and every
  ``filter_image_staged`` call. Recompute: coarse Sinkhorn, the extension
  rmatvec2, the polish through K5/K6, the cross through K7, the p x p
  solve, and colstats + V through K10 (ops/cuda_recompute), or without V
  (``rmatmat_colstats``, the apply then ``rmat_apply``) past
  ``_V_BYTES_CAP``. strip_cache: strip GEMMs for the extension, the polish
  and the colstats, and the randomized sketch (``nystrom_sketch_factor``)
  on the strip; K1 emits the strip.

Pixels stay in NATURAL order; only p-sized index ops touch pixels (gather
the sample rows, scatter the p-sized results back).

Ported here: ``gram_sample_idx``, ``sinkhorn_sample_idx``, ``_strip_dot`` /
``_strip_dot_t``, ``StreamFactor``, ``_StripCtx`` with the strip_cache +
kernel and the recompute + kernel branches of ``_strip_ctx``, both kernel
branches of ``_coarse_sinkhorn_state``, ``_stream_cross``, the chol/lobpcg
branch of ``_solve_pxp``, ``_fused_finish_ok``,
``_factor_streaming_fused``, ``_strip_fused_ok``, ``_factor_strip_fused``,
``_normalize_streaming``, ``_eigensolve_streaming``, ``_factor_streaming``,
``_apply_factor``, the closures ``strip_matvec`` / ``strip_rmatvec`` /
``ktilde_apply`` of both contexts, ``_apply_matvec_streaming``,
``filter_channel_streaming`` and the ``stage_*`` functions. Every other
streaming recipe raises ``NotImplementedError`` naming the ROADMAP.md item
that ports it (``check_slice``); non-streaming configs take the dense path
(models/pipeline).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.affinity import affinity_strip, extract_features_padded
from ..ops import cuda_affinity as k1
from ..ops import cuda_matvec as k56
from ..ops import cuda_recompute as k79
from ..ops import cuda_strip as k24
from ..ops import recompute_layout as rl
from ..ops import streaming as st
from ..ops.cuda_strip import P_QUANTUM
from ..ops.filters import FILTER_REGISTRY, apply_operator_filter
from ..ops.linalg import mm_f32, trunc_inv_sqrt_vals
from ..ops.nystrom import (_LIVE_NORM2, _orthonormalize, _ridge_eps,
                           nystrom_chol_factor, nystrom_sketch_factor,
                           sketch_omega)
from ..ops.sinkhorn import _make_kaa_solve

_EPS = 1e-30
# the reference's single-chip strip bound, kept so both packages accept the
# same configs (not re-derived for the H100's memory)
_STRIP_BYTES_LIMIT = 8e9
# the reference's budget for the materialized V buffer (its fused-finish
# gate and its unfused colstats + V), kept for the same reason
_V_BYTES_CAP = 6e9
# column chunk of the recomputing loops (ops/streaming) on the card: wider
# than the reference's block, for fewer launches; only the order of the f32
# sums across chunks changes
CUDA_CHUNK = 32768
# strided gram sample below this decimation, jittered from it on (the
# reference's measured crossover)
GRAM_JITTER_MIN = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kernels(plain: bool):
    """(K1, K2, K3, K4) callables: the kernel wrappers, or with ``plain``
    their PyTorch versions (the same slice on any device, with no kernel —
    the on-card comparison of chip_smoke.py runs both)."""
    if plain:
        return (k1.affinity_strip_plain, k24.strip_ext2_plain,
                k24.strip_sandwich_spost_plain, k24.strip_sandwich_plain)
    return (k1.affinity_strip_cuda, k24.strip_ext2_cuda,
            k24.strip_sandwich_spost_cuda, k24.strip_sandwich_cuda)


def _recompute_kernels(plain: bool):
    """(K7 gram, K8, K9, K10) callables, kernel wrappers or plain
    versions."""
    if plain:
        return (k79.gram_plain, k79.ext2_matvec_plain,
                k79.finish_colstats_plain, k79.colstats_v_plain)
    return (k79.gram_cuda, k79.ext2_matvec_cuda, k79.finish_colstats_cuda,
            k79.colstats_v_cuda)


def _matvec_kernels(plain: bool):
    """(K5 matvec, K6 rmatvec) callables, kernel wrappers or plain versions."""
    if plain:
        return k56.matvec_plain, k56.rmatvec_plain
    return k56.matvec_cuda, k56.rmatvec_cuda


_ONESHOT_TODO = ("the one-shot p x p solve on the streaming paths waits "
                 "for ROADMAP.md Queue 1 M2")


def _strip_fused_recipe(cfg: PipelineConfig) -> bool:
    """The recipe half of the fused-sweep gate: coarse Sinkhorn + one
    polish, sketch power 0, a spectral filter."""
    return (cfg.normalization == "sinkhorn"
            and cfg.sinkhorn_coarse > 1 and cfg.sinkhorn_polish == 1
            and cfg.solver == "sketch" and cfg.sketch_power == 0
            and not cfg.operator_filter())


def check_slice(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError, before any work, unless ``cfg`` is a
    recipe the port runs: any non-streaming config (the dense path,
    models/pipeline); streaming with the kernels (``use_pallas``) —
    strip_cache with a spectral filter and the sketch solver; recompute
    with an operator filter (any normalization) or a spectral filter and
    the chol or LOBPCG solver, fused finish or not, with bf16 aug or f32
    tiles."""
    todo = None
    spectral = not cfg.operator_filter()
    if not cfg.streaming:
        return
    if cfg.strip_cache:
        if not spectral:
            todo = ("operator filter modes (matvec/chebyshev) on strip_cache "
                    "recipes wait for ROADMAP.md Queue 1 M3 / M7")
        elif not cfg.use_pallas:
            todo = ("strip_cache without use_pallas (the XLA strip emitter) "
                    "waits for ROADMAP.md Queue 1 M3")
        elif cfg.solver != "sketch":
            todo = ("strip_cache with the chol, LOBPCG or one-shot solver "
                    "(the strip gram of the unfused eigensolve) waits for "
                    "ROADMAP.md Queue 1 M3")
    elif cfg.feature_dtype == "bfloat16":
        todo = ("bf16 feature storage on the recompute path waits for "
                "ROADMAP.md Queue 1 M6")
    elif not cfg.use_pallas:
        todo = ("the XLA-scan closures of the recompute path "
                "(use_pallas=False) wait for ROADMAP.md Queue 1 M6")
    elif spectral and cfg.solver not in ("chol", "lobpcg"):
        todo = _ONESHOT_TODO
    if todo:
        raise NotImplementedError(f"graphlap_tpu_torch: {todo}")


def gram_sample_idx(n_pad: int, k: int, seed: int = 0) -> np.ndarray:
    """Static column sample of the coarse gram, one per k-slot: the plain
    stride for k < 16, else one seeded uniform column in each slot (the
    stride aliases with the raster; see the reference's docstring for the
    measurements). Indices may land in the zero padding, where the column
    scales are zero too."""
    slots = np.arange(0, n_pad, k)[: n_pad // k]
    if k < GRAM_JITTER_MIN:
        return slots.astype(np.int32)
    off = np.random.default_rng(seed).integers(0, k, n_pad // k)
    return (slots + off).astype(np.int32)


def sinkhorn_sample_idx(n_pad: int, k: int, w: int,
                        mode: str = "diag") -> np.ndarray:
    """Static column sample for the coarse Sinkhorn, one per k-slot: a
    stride whose in-slot offset rotates by a k-coprime step per image row
    (``mode="diag"``), or the plain ::k stride (``"stride"``). The rotation
    removes the natural-order raster alias of a plain stride; see the
    reference's docstring for the measurements behind it."""
    slots = np.arange(0, n_pad, k)[: n_pad // k]
    if mode == "stride":
        return slots.astype(np.int32)
    q = 7 if k % 7 else 5
    off = (q * (slots // w)) % k
    return (slots + off).astype(np.int32)


class StreamFactor(NamedTuple):
    """The streaming eigensolve's output, pre-filter."""

    vals: torch.Tensor       # (m,) eigenvalues, descending
    basis0: torch.Tensor     # (p, m) factor
    v_a: torch.Tensor        # (p, m) A-rows of V (pre column-rescale)
    scale: torch.Tensor      # (m,) unit-norm column rescale (0 = dead col)
    coeffs: torch.Tensor     # (m,) scale * V^T y
    s_a: torch.Tensor        # (p,) Sinkhorn scale at samples
    s_b_cols: torch.Tensor   # (n_pad,) column scales (0 on A cols + padding)
    feats_a: torch.Tensor    # (p, d)
    feats_pad: torch.Tensor  # (n_pad, d)
    y_pad: torch.Tensor      # (n_pad,) input pixels, zero-padded
    v_b: torch.Tensor | None  # (n_pad, m) pre-rescale V; None past
                              # _V_BYTES_CAP (the apply then recomputes)
    n: int                   # true pixel count
    block: int               # column-block width


def _strip_dot(strip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """strip @ x: bf16 strips take bf16 operands with f32 accumulate and
    output; f32 strips run full-f32 GEMMs."""
    col = x.ndim == 1
    x2 = x[:, None] if col else x
    if strip.dtype == torch.bfloat16:
        out = mm_f32(strip, x2.to(torch.bfloat16))
    else:
        out = strip @ x2.to(torch.float32)
    return out[:, 0] if col else out


def _strip_dot_t(strip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """strip.T @ x (a transposed view: no copy)."""
    return _strip_dot(strip.T, x)


class _StripCtx(NamedTuple):
    """Features, masks, the exact (p, p) block, its solve, and either the
    strip (strip_cache) or the kernels' padded layouts (recompute)."""

    n: int
    p: int
    n_pad: int
    block: int
    w: int                     # image width (the coarse sample's raster)
    dtype: torch.dtype         # tile dtype
    idx_a: torch.Tensor
    feats_a: torch.Tensor
    feats_pad: torch.Tensor
    valid: torch.Tensor                     # (n_pad,) 1 on real pixels
    b_mask: torch.Tensor
    kaa: torch.Tensor
    kaa_solve: object
    plain: bool                             # kernels' plain versions
    strip: torch.Tensor | None = None       # (p, n_pad) view of strip_pad
    strip_pad: torch.Tensor | None = None   # (p_pad, n_pad), zero padding
    fa_pad: torch.Tensor | None = None      # recompute: (p_pad, dp) plain
    f_t: torch.Tensor | None = None         # (dp, n_pad_k), aug superset
                                            # when fa_aug is set
    fa_aug: torch.Tensor | None = None      # bf16: (p_pad, dp) augmented
    live: int = 32                          # feature lanes d, rounded up to 4
    coords: bool = False                    # the features carry (row, col)


def _strip_ctx(img2d: torch.Tensor, idx_a: torch.Tensor,
               cfg: PipelineConfig, plain: bool = False) -> _StripCtx:
    h, w = img2d.shape
    n = h * w
    p = idx_a.shape[0]
    dev = img2d.device
    dtype = torch.bfloat16 if cfg.affinity_dtype == "bfloat16" else torch.float32
    block = min(cfg.block_cols, n)
    n_pad = _cdiv(n, block) * block
    bf16_store = cfg.affinity_dtype in ("bfloat16", "bfloat16_store")
    strip_bytes = p * n_pad * (2 if bf16_store else 4)
    if cfg.strip_cache and strip_bytes > _STRIP_BYTES_LIMIT:
        raise ValueError(
            f"strip_cache strip would be {strip_bytes / 1e9:.1f} GB "
            f"(p={p}, n_pad={n_pad}) — past the single-device bound")

    feats_pad = extract_features_padded(img2d, cfg, n_pad)
    feats_a = feats_pad[idx_a]                        # p-row gather only
    d = feats_pad.shape[1]

    valid = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
    a_mask = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    a_mask[idx_a] = 1.0
    b_mask = valid * (1.0 - a_mask)                   # 1 on B columns only

    kaa = affinity_strip(feats_a, feats_a, dtype)     # exact (p, p)
    kaa_solve = _make_kaa_solve(kaa, cfg.eig_tol, cfg.solver)
    base = dict(n=n, p=p, n_pad=n_pad, block=block, w=w, dtype=dtype,
                idx_a=idx_a, feats_a=feats_a, feats_pad=feats_pad,
                valid=valid, b_mask=b_mask, kaa=kaa, kaa_solve=kaa_solve,
                plain=plain, live=_cdiv(d, 4) * 4,
                coords=cfg.spatial_h > 0.0)
    if not cfg.strip_cache:
        return _StripCtx(**base, **_recompute_layouts(feats_a, feats_pad,
                                                      n_pad, dtype))

    store = torch.bfloat16 if bf16_store else None
    # poison the padding feature rows: d2 >= (1e3 - |f|)^2 >> 88 there, so
    # exp underflows to exactly 0 and the padded strip rows and columns are
    # exact zeros. Rows and columns take opposite signs so a padding row
    # meets a padding column at d2 = d (2e3)^2 too (the reference poisons
    # both with +1e3 and leaves exp(0) = 1 there, where every operand of
    # the sweeps is zero anyway).
    feats_strip = feats_pad
    if n_pad != n:
        feats_strip = feats_pad.clone()
        feats_strip[n:] = -1e3
    p_pad = _cdiv(p, P_QUANTUM) * P_QUANTUM
    feats_a_pois = torch.full((p_pad, d), 1e3, dtype=feats_a.dtype, device=dev)
    feats_a_pois[:p] = feats_a
    # K1 returns a view over padded rows where n_pad is ragged; the sweeps
    # take a contiguous strip
    strip_pad = _kernels(plain)[0](feats_a_pois, feats_strip, dtype, store,
                                   coords=cfg.spatial_h > 0.0).contiguous()
    return _StripCtx(**base, strip=strip_pad[:p], strip_pad=strip_pad)


def _recompute_layouts(feats_a: torch.Tensor, feats_pad: torch.Tensor,
                       n_pad: int, dtype: torch.dtype) -> dict:
    """The recompute kernels' operands, padded as the reference pads them:
    p to the 512-aligned p_tiling, n to the _tile_n quantum, features to 32
    lanes. bf16 tiles use the augmented layout (fa_aug, and f_t the aug
    superset the plain-class K9 reads too); f32 tiles the plain one."""
    p, d = feats_a.shape
    aug = dtype == torch.bfloat16
    _, p_pad = rl.p_tiling(p)
    tn = rl._tile_n(dtype)
    n_pad_k = _cdiv(n_pad, tn) * tn
    dp = rl.aug_d_pad_of(d) if aug else rl.d_pad_of(d)
    fa_pad = torch.zeros((p_pad, dp), dtype=dtype, device=feats_a.device)
    fa_pad[:p, :d] = feats_a.to(dtype)
    if aug:
        fa_aug, f_t = rl.aug_pads(feats_a, feats_pad, n_pad_k)
    else:
        fa_aug = None
        f_t = torch.zeros((dp, n_pad_k), dtype=dtype, device=feats_a.device)
        f_t[:d, :n_pad] = feats_pad.to(dtype).T
    return dict(fa_pad=fa_pad, f_t=f_t, fa_aug=fa_aug)


def _mv_layout(ctx: _StripCtx):
    """(fa, aug): the sample-row layout K5/K6 take (aug for bf16 tiles)."""
    aug = ctx.fa_aug is not None
    return (ctx.fa_aug if aug else ctx.fa_pad), aug


def strip_matvec(ctx: _StripCtx, v_scaled: torch.Tensor) -> torch.Tensor:
    """K v_scaled -> (p,): a GEMM on the strip, or K5 on the recompute
    layouts with v zero-padded to n_pad_k (the reference's Pallas
    closure)."""
    if ctx.strip is not None:
        return _strip_dot(ctx.strip, v_scaled)
    fa, aug = _mv_layout(ctx)
    vv = torch.zeros(ctx.f_t.shape[1], dtype=torch.float32,
                     device=v_scaled.device)
    vv[:ctx.n_pad] = v_scaled
    return _matvec_kernels(ctx.plain)[0](fa, ctx.f_t, vv, aug, ctx.live,
                                         ctx.coords)[:ctx.p]


def strip_rmatvec(ctx: _StripCtx, t_scaled: torch.Tensor) -> torch.Tensor:
    """K^T t_scaled -> (n_pad,): a GEMM on the strip, or K6 with t
    zero-padded to p_pad."""
    if ctx.strip is not None:
        return _strip_dot_t(ctx.strip, t_scaled)
    fa, aug = _mv_layout(ctx)
    tt = torch.zeros(fa.shape[0], dtype=torch.float32, device=t_scaled.device)
    tt[:ctx.p] = t_scaled
    return _matvec_kernels(ctx.plain)[1](fa, ctx.f_t, tt, aug, ctx.live,
                                         ctx.coords)[:ctx.n_pad]


def ktilde_apply(ctx: _StripCtx, s: torch.Tensor) -> torch.Tensor:
    """K~ s in natural order: the Nystrom completion's matvec, two strip
    GEMMs or one K5 and one K6 (the B rows from K_BA t, the A rows from
    the exact K_AA)."""
    s_a = s[ctx.idx_a]                                # p gather
    u = strip_matvec(ctx, s * ctx.b_mask)
    top = ctx.kaa @ s_a + u
    t = s_a + ctx.kaa_solve(u)
    bottom = strip_rmatvec(ctx, t) * ctx.b_mask
    bottom[ctx.idx_a] = top                           # p scatter
    return bottom


def _chunk(ctx: _StripCtx, block: int) -> int:
    """Column chunk of the recomputing loops: the reference's block on the
    CPU, at least CUDA_CHUNK on the card."""
    return max(block, CUDA_CHUNK) if ctx.b_mask.is_cuda else block


def _coarse_sinkhorn_state(ctx: _StripCtx, cfg: PipelineConfig):
    """Decimated alternating Sinkhorn fixed point against every k-th strip
    column. Returns (s_a_coarse (p,), t_r (p,), t_c (p,)): the A scales and
    the two extension vectors the full-resolution sweeps consume."""
    k = cfg.sinkhorn_coarse
    if ctx.block % k != 0:
        raise ValueError(
            f"sinkhorn_coarse={k} must divide the active "
            f"block width min(block_cols, N)={ctx.block}")
    kaa, kaa_solve = ctx.kaa, ctx.kaa_solve
    dev = ctx.b_mask.device
    jidx = torch.as_tensor(
        sinkhorn_sample_idx(ctx.n_pad, k, ctx.w, cfg.resolved_sinkhorn_sample()),
        dtype=torch.int64, device=dev)
    mask_c = ctx.b_mask[jidx]
    ratio = torch.sum(ctx.b_mask) / torch.clamp(torch.sum(mask_c), min=1.0)
    if ctx.strip is not None:
        strip_c = ctx.strip[:, jidx]                  # (p, n_pad / k), once
        u0 = ratio * _strip_dot(strip_c, mask_c)

        def coarse_step(t):
            y = _strip_dot_t(strip_c, t)
            return ratio * _strip_dot(strip_c,
                                      mask_c / torch.clamp(y, min=_EPS))
    else:
        # recompute: decimated tiles from the sampled columns' features
        feats_c = ctx.feats_pad[jidx]
        chunk = _chunk(ctx, ctx.block // k)
        ones_p = torch.ones(ctx.p, dtype=torch.float32, device=dev)
        u0 = ratio * st.matvec(ctx.feats_a, feats_c, mask_c, ones_p,
                               torch.ones_like(mask_c), chunk, ctx.dtype)

        def coarse_step(t):
            return st.sinkhorn_coarse_step(ctx.feats_a, feats_c, t, mask_c,
                                           ratio, chunk, ctx.dtype)

    r_a = c_a = torch.ones(ctx.p, dtype=torch.float32, device=dev)
    u_r = u0
    t_r = t_c = torch.zeros(ctx.p, dtype=torch.float32, device=dev)
    for _ in range(cfg.sinkhorn_iters):
        c_a = 1.0 / torch.clamp(kaa @ r_a + u_r, min=_EPS)
        t_r = r_a + kaa_solve(u_r)
        u_c = coarse_step(t_r)
        r_a = 1.0 / torch.clamp(kaa @ c_a + u_c, min=_EPS)
        t_c = c_a + kaa_solve(u_c)
        u_r = coarse_step(t_c)
    s_a_coarse = torch.sqrt(torch.clamp(r_a * c_a, min=0.0))
    return s_a_coarse, t_r, t_c


def _normalize_streaming(ctx: _StripCtx, cfg: PipelineConfig) -> torch.Tensor:
    """Streaming Sinkhorn / symmetric normalization -> column scales s
    (n_pad,), zero on padding: coarse Sinkhorn, the full-resolution
    extension (a strip GEMM, or rmatvec2) and ``sinkhorn_polish``
    completion passes; or full-resolution Sinkhorn; or symmetric; or
    none."""
    valid, b_mask = ctx.valid, ctx.b_mask
    if cfg.normalization == "sinkhorn" and cfg.sinkhorn_coarse > 1:
        s_a_coarse, t_r, t_c = _coarse_sinkhorn_state(ctx, cfg)
        t2 = torch.stack([t_r, t_c], dim=1)
        if ctx.strip is not None:
            kbt = _strip_dot_t(ctx.strip, t2) * b_mask[:, None]
        else:
            # each column sums over p only, so on the card any chunk gives
            # the same values; CUDA_CHUNK bounds the f32 tile temps
            chunk = CUDA_CHUNK if b_mask.is_cuda else ctx.block
            kbt = st.rmatvec2(ctx.feats_a, ctx.feats_pad, t2, b_mask, chunk,
                              ctx.dtype)
        prod = torch.clamp(kbt[:, 0] * kbt[:, 1], min=_EPS)
        s = b_mask / torch.sqrt(prod)
        s[ctx.idx_a] = s_a_coarse
        s = s * valid
        for _ in range(cfg.sinkhorn_polish):
            ks = torch.clamp(ktilde_apply(ctx, s), min=_EPS)
            s = torch.sqrt(s / ks) * valid
    elif cfg.normalization == "sinkhorn":
        s = valid
        for _ in range(cfg.sinkhorn_iters):
            ks = torch.clamp(ktilde_apply(ctx, s), min=_EPS)
            s = torch.sqrt(s / ks) * valid
    elif cfg.normalization == "symmetric":
        ks = torch.clamp(ktilde_apply(ctx, valid), min=_EPS)
        s = torch.rsqrt(ks) * valid
    else:
        s = valid
    return s


def _strip_fused_ok(ctx: _StripCtx, cfg: PipelineConfig) -> bool:
    """Gate of the fused strip sweeps: the padded strip exists and the
    recipe is the coarse + one-polish sketch pipeline they fuse."""
    return ctx.strip_pad is not None and _strip_fused_recipe(cfg)


def _solve_lt(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L^T x = b (L lower triangular)."""
    return torch.linalg.solve_triangular(l.T, b, upper=True)


def _solve_l(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L x = b (L lower triangular)."""
    return torch.linalg.solve_triangular(l, b, upper=False)


def _factor_strip_fused(img2d: torch.Tensor, ctx: _StripCtx,
                        cfg: PipelineConfig,
                        omega: torch.Tensor | None = None,
                        plain: bool = False) -> StreamFactor:
    """Four-sweep fused strip_cache factor:

        sweep 1  K2 strip_ext2:           kbt + s_pre + polish matvec
        sweep 2  K3 strip_sandwich_spost: polish rmatvec + s_post +
                                          sketch sandwich pass 1
        sweep 3  K4 strip_sandwich:       sketch sandwich pass 2
        sweep 4  colstats GEMM:           V + norms + coeffs

    with the randomized sketch solve (power 0) inlined so its two M-applies
    ride sweeps 2 and 3. ``omega``: optional (p, k) test matrix; default
    ``sketch_omega``; ``plain`` runs the kernels' PyTorch versions."""
    _, strip_ext2, strip_sandwich_spost, strip_sandwich = _kernels(plain)
    p, n_pad = ctx.p, ctx.n_pad
    strip_pad = ctx.strip_pad
    p_pad = strip_pad.shape[0]
    m = cfg.num_eigvecs
    dev = strip_pad.device
    f32 = dict(dtype=torch.float32, device=dev)

    s_a_pre, t_r, t_c = _coarse_sinkhorn_state(ctx, cfg)

    # sweep 1: extension rmatvec2 + pre-polish scales + polish matvec
    t2 = torch.zeros((2, p_pad), **f32)
    t2[0, :p] = t_r
    t2[1, :p] = t_c
    u_pad, s_pre = strip_ext2(strip_pad, t2, ctx.b_mask)
    u = u_pad[:p]

    # p-side polish update (the completion matvec's top and t)
    top = ctx.kaa @ s_a_pre + u
    t_vec = s_a_pre + ctx.kaa_solve(u)
    s_a = torch.sqrt(s_a_pre / torch.clamp(top, min=_EPS))  # post-polish

    # inlined randomized sketch (power 0), A scales folded into the operand
    waa = ctx.kaa * (s_a[:, None] * s_a[None, :])
    k = min(m + cfg.sketch_oversample, p)
    kp = _cdiv(k, 128) * 128
    eps = _ridge_eps(waa, cfg.eig_tol)
    l = torch.linalg.cholesky(waa + eps * torch.eye(p, **f32))

    def pad_ta(tmat):                   # (p, k) -> (p_pad, kp), A-scaled
        out = torch.zeros((p_pad, kp), **f32)
        out[:p, :k] = tmat * s_a[:, None]
        return out

    om = sketch_omega(p, k, dev) if omega is None else omega.to(**f32)
    if om.shape != (p, k):
        raise ValueError(f"omega shape {tuple(om.shape)} != {(p, k)}")
    t1 = _solve_lt(l, om)
    t_pad = torch.zeros(p_pad, **f32)
    t_pad[:p] = t_vec
    # sweep 2: polish rmatvec + post-polish scales + sandwich(t1)
    u1, s_post = strip_sandwich_spost(strip_pad, pad_ta(t1), t_pad,
                                      s_pre, ctx.b_mask)
    sb1 = u1[:p, :k] * s_a[:, None]
    y = _solve_l(l, waa @ (waa @ t1) + sb1)
    q = _orthonormalize(y)
    tq = _solve_lt(l, q)
    # sweep 3: sandwich(tq) with the known post-polish scales
    u2 = strip_sandwich(strip_pad, pad_ta(tq), s_post * s_post)
    b = q.T @ _solve_l(l, waa @ (waa @ tq) + u2[:p, :k] * s_a[:, None])
    b = 0.5 * (b + b.T)
    vals, svecs = torch.linalg.eigh(b)
    vals_m = torch.flip(vals, (0,))[:m]
    y_m = q @ torch.flip(svecs, (1,))[:, :m]
    basis0 = _solve_lt(l, y_m * trunc_inv_sqrt_vals(vals_m, cfg.eig_tol)[None, :])

    # sweep 4: strip-backed colstats
    s_b_cols = s_post[:n_pad]
    y_pad = _y_pad(img2d, n_pad)
    return _factor_out(ctx, vals_m, basis0, waa, s_a, s_b_cols, y_pad,
                       _strip_colstats(ctx, basis0 * s_a[:, None], s_b_cols,
                                       y_pad))


def _stream_cross(ctx: _StripCtx, cfg: PipelineConfig, s_a: torch.Tensor,
                  s_b_cols: torch.Tensor,
                  s_sampled: torch.Tensor | None = None,
                  plain: bool = False) -> torch.Tensor:
    """The (p, p) cross (D C D)(D C D)^T from recomputed tiles: full, or
    the decimated-column estimate of gram_coarse with the energy ratio
    sum c^2 / sum_S c^2 from the full (pre-polish) ``s_b_cols``.
    ``s_sampled``: the column scales to use AT the gram-sample columns (the
    fused finish's post-polish values there); see the reference's
    docstring for why the ratio stays pre-polish."""
    p, n_pad = ctx.p, ctx.n_pad
    gram_k7 = _recompute_kernels(plain)[0]

    def stream_gram(cols, blk, jidx):
        if ctx.f_t.shape[1] == n_pad and blk % rl.EMIT_TN == 0:
            # the K7 branch (the reference's shape gate, kept)
            ft = ctx.f_t[:, jidx] if jidx is not None else ctx.f_t
            aug = ctx.fa_aug is not None
            g = gram_k7(ctx.fa_aug if aug else ctx.fa_pad, ft, cols, aug,
                        ctx.live)[:p, :p]
            return g * (s_a[:, None] * s_a[None, :])
        fp = ctx.feats_pad[jidx] if jidx is not None else ctx.feats_pad
        return st.gram(ctx.feats_a, fp, s_a, cols, _chunk(ctx, blk),
                       ctx.dtype)

    if cfg.gram_coarse > 1:
        kg = cfg.gram_coarse
        if ctx.block % kg != 0:
            raise ValueError(
                f"gram_coarse={kg} must divide the active block "
                f"width min(block_cols, N)={ctx.block}")
        jidx = torch.as_tensor(gram_sample_idx(n_pad, kg,
                                               cfg.gram_jitter_seed),
                               dtype=torch.int64, device=s_a.device)
        pre_g = s_b_cols[jidx]
        ratio_g = (torch.sum(s_b_cols * s_b_cols)
                   / torch.clamp(torch.sum(pre_g * pre_g), min=_EPS))
        cols_g = pre_g if s_sampled is None else s_sampled
        return ratio_g * stream_gram(cols_g, ctx.block // kg, jidx)
    if s_sampled is not None:
        raise ValueError("s_sampled requires gram_coarse > 1")
    return stream_gram(s_b_cols, ctx.block, None)


def _solve_pxp(cfg: PipelineConfig, waa: torch.Tensor, cross: torch.Tensor,
               x0: torch.Tensor | None = None):
    """The p x p Nystrom factor solve -> (vals_m (m,), basis0 (p, m)).
    ``x0``: LOBPCG's start block (default ``ops.nystrom.lobpcg_x0``)."""
    if cfg.solver not in ("chol", "lobpcg"):
        raise NotImplementedError(f"graphlap_tpu_torch: {_ONESHOT_TODO}")
    method = "lobpcg" if cfg.solver == "lobpcg" else "eigh"
    return nystrom_chol_factor(waa, cross, cfg.num_eigvecs, cfg.eig_tol,
                               method, cfg.lobpcg_iters, x0)


def _y_pad(img2d: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The input pixels, natural order, zero-padded to n_pad."""
    y = torch.zeros(n_pad, dtype=torch.float32, device=img2d.device)
    y[:img2d.numel()] = img2d.to(torch.float32).reshape(-1)
    return y


def _gr_pad(ctx: _StripCtx, g: torch.Tensor) -> torch.Tensor:
    """(p, m) row-scaled factor -> the K9 / K10 operand (p_pad, m padded to
    16), zero outside."""
    p, m = g.shape
    gr = torch.zeros((ctx.fa_pad.shape[0], _m_kernel(m)), dtype=torch.float32,
                     device=g.device)
    gr[:p, :m] = g
    return gr


def _sq_norms_pad(ctx: _StripCtx):
    """(na (p_pad,), nb (n_pad_k,)): the f32 squared feature norms K9 / K10
    take (only the cross GEMM inputs round to the tile dtype)."""
    fa32 = ctx.feats_a.to(torch.float32)
    fp32 = ctx.feats_pad.to(torch.float32)
    na = torch.zeros(ctx.fa_pad.shape[0], dtype=torch.float32,
                     device=fa32.device)
    na[:ctx.p] = torch.sum(fa32 * fa32, dim=1)
    nb = torch.zeros(ctx.f_t.shape[1], dtype=torch.float32, device=fa32.device)
    nb[:ctx.n_pad] = torch.sum(fp32 * fp32, dim=1)
    return na, nb


def _strip_colstats(ctx: _StripCtx, gr: torch.Tensor, s_b_cols: torch.Tensor,
                    y_pad: torch.Tensor):
    """(norms, coeffs, V) against the strip: one thin GEMM materializes V
    (the strip already bounds N, so the O(Nm) buffer always fits)."""
    v_b = _strip_dot_t(ctx.strip, gr) * s_b_cols[:, None]
    return torch.sum(v_b * v_b, dim=0), v_b.T @ y_pad, v_b


def _recompute_colstats(ctx: _StripCtx, gr: torch.Tensor,
                        s_b_cols: torch.Tensor, y_pad: torch.Tensor):
    """(norms, coeffs, V) from recomputed tiles: K10 on the padded layouts
    while V (n_pad, m) f32 stays within _V_BYTES_CAP, else one pass without
    V (``rmatmat_colstats``; V is None and the apply recomputes)."""
    n_pad, m = ctx.n_pad, gr.shape[1]
    if n_pad * m * 4 > _V_BYTES_CAP:
        norms, coeffs = st.rmatmat_colstats(
            ctx.feats_a, ctx.feats_pad, gr, y_pad,
            torch.ones(ctx.p, dtype=torch.float32, device=gr.device),
            s_b_cols, _chunk(ctx, ctx.block), ctx.dtype)
        return norms, coeffs, None
    nk = ctx.f_t.shape[1]
    y_k = torch.zeros(nk, dtype=torch.float32, device=gr.device)
    y_k[:n_pad] = y_pad
    c_k = torch.zeros_like(y_k)
    c_k[:n_pad] = s_b_cols
    v, norms, coeffs = _recompute_kernels(ctx.plain)[3](
        ctx.fa_pad, ctx.f_t, _gr_pad(ctx, gr), y_k, c_k, *_sq_norms_pad(ctx),
        live=ctx.live)
    return norms[:m], coeffs[:m], v[:n_pad, :m]


def _factor_out(ctx: _StripCtx, vals_m, basis0, waa, s_a, s_b_cols, y_pad,
                colstats) -> StreamFactor:
    """The factor from the p x p solve and the pixel side's (norms, coeffs,
    V): unit-norm column rescale (0 on dead columns) and the coefficients
    scale * V^T y."""
    norms_b, coeffs_b, v_b = colstats
    v_a = waa @ basis0
    dnorm = torch.sum(v_a * v_a, dim=0) + norms_b
    live = dnorm > _LIVE_NORM2
    scale = torch.where(live, 1.0 / torch.sqrt(torch.where(live, dnorm, 1.0)),
                        0.0)
    coeffs = scale * (v_a.T @ y_pad[ctx.idx_a] + coeffs_b)
    return StreamFactor(vals=vals_m, basis0=basis0, v_a=v_a, scale=scale,
                        coeffs=coeffs, s_a=s_a, s_b_cols=s_b_cols,
                        feats_a=ctx.feats_a, feats_pad=ctx.feats_pad,
                        y_pad=y_pad, v_b=v_b, n=ctx.n, block=ctx.block)


def _eigensolve_streaming(img2d: torch.Tensor, ctx: _StripCtx,
                          s: torch.Tensor, cfg: PipelineConfig,
                          omega: torch.Tensor | None = None,
                          x0: torch.Tensor | None = None) -> StreamFactor:
    """The unfused schedule's Nystrom eigensolve from the scales ``s``:
    strip_cache + sketch runs the randomized sketch on thin strip passes
    (the Sinkhorn scales folded into the sandwich, never a scaled strip
    copy; ``omega`` its test matrix); recompute runs the cross (K7) and the
    chol / LOBPCG solve (``x0`` its start block). Then the colstats: a
    strip GEMM, K10, or the V-free pass."""
    s_a = s[ctx.idx_a]
    s_b_cols = s * ctx.b_mask                         # 0 on A columns + pads
    waa = ctx.kaa * (s_a[:, None] * s_a[None, :])
    m = cfg.num_eigvecs
    if cfg.solver == "sketch" and ctx.strip is not None:
        s_b2 = s_b_cols * s_b_cols

        def sandwich(t):
            u = _strip_dot_t(ctx.strip, t * s_a[:, None]) * s_b2[:, None]
            return _strip_dot(ctx.strip, u) * s_a[:, None]

        vals_m, basis0 = nystrom_sketch_factor(
            waa, sandwich, m, cfg.eig_tol, cfg.sketch_oversample,
            cfg.sketch_power, omega)
    else:
        cross = _stream_cross(ctx, cfg, s_a, s_b_cols, plain=ctx.plain)
        vals_m, basis0 = _solve_pxp(cfg, waa, cross, x0)
    y_pad = _y_pad(img2d, ctx.n_pad)
    gr = basis0 * s_a[:, None]
    colstats = (_strip_colstats if ctx.strip is not None
                else _recompute_colstats)(ctx, gr, s_b_cols, y_pad)
    return _factor_out(ctx, vals_m, basis0, waa, s_a, s_b_cols, y_pad,
                       colstats)


def _fused_finish_ok(ctx: _StripCtx, cfg: PipelineConfig) -> bool:
    """Shape gate of the fused finish, with the reference's quanta: whole-p
    tiles (p_pad <= MAX_TILE_P from the 512-aligned p_tiling), m within
    M_PAD, and the M_PAD-wide V buffer within the reference's budget."""
    if not (cfg.fused_finish and ctx.fa_pad is not None):
        return False
    if (ctx.fa_pad.shape[0] > rl.MAX_TILE_P
            or cfg.num_eigvecs > rl.M_PAD):
        return False
    return (ctx.f_t.shape[1] * rl.m_pad_of(cfg.num_eigvecs) * 4
            <= _V_BYTES_CAP)


def _m_kernel(m: int) -> int:
    """V width of the port's K9: m padded to 16 (the mma tile), where the
    reference pads to its TPU lane width M_PAD = 128; zero columns stay
    exact zeros and are sliced off either way."""
    return _cdiv(m, 16) * 16


def _factor_streaming_fused(img2d: torch.Tensor, ctx: _StripCtx,
                            cfg: PipelineConfig,
                            x0: torch.Tensor | None = None,
                            plain: bool = False) -> StreamFactor:
    """Two-sweep fused finish of the recompute path:

        sweep 1  K8 ext2_matvec:      kbt + s_pre + polish matvec
        (decimated rmatvec: post-polish scales at the gram columns)
        cross    K7 + one GEMM:       the decimated gram
        p x p    nystrom_chol_factor: ridge Cholesky + LOBPCG
        sweep 2  K9 finish_colstats:  polish rmatvec + s_post + V, norms,
                                      coeffs

    The spectrum uses post-polish scales at just the gram-sample columns
    (the reference's docstring records why); everything that touches pixels
    is at post-polish scales. ``x0``: LOBPCG's start block; ``plain`` runs
    the kernels' PyTorch versions."""
    _, ext2_matvec, finish_colstats, _ = _recompute_kernels(plain)
    p, n_pad = ctx.p, ctx.n_pad
    fa_pad, f_t = ctx.fa_pad, ctx.f_t
    p_pad, n_pad_k = fa_pad.shape[0], f_t.shape[1]
    dev = fa_pad.device
    f32 = dict(dtype=torch.float32, device=dev)

    s_a_pre, t_r, t_c = _coarse_sinkhorn_state(ctx, cfg)

    # sweep 1: b_mask is 0 on A columns and padding, so s_pre is 0 there
    bm_k = torch.zeros(n_pad_k, **f32)
    bm_k[:n_pad] = ctx.b_mask
    t2 = torch.zeros((2, p_pad), **f32)
    t2[0, :p] = t_r
    t2[1, :p] = t_c
    aug = ctx.fa_aug is not None
    u_pad, s_pre_k = ext2_matvec(ctx.fa_aug if aug else fa_pad, f_t, t2,
                                 bm_k, aug, ctx.live)
    u = u_pad[:p]

    # p-side polish update (the completion matvec's top and t)
    top = ctx.kaa @ s_a_pre + u
    t_vec = s_a_pre + ctx.kaa_solve(u)
    s_a = torch.sqrt(s_a_pre / torch.clamp(top, min=_EPS))  # post-polish

    # post-polish scales at the gram-sample columns, from a decimated
    # rmatvec against the same t_vec sweep 2 consumes
    s_pre = s_pre_k[:n_pad]
    kg = cfg.gram_coarse
    jidx = torch.as_tensor(gram_sample_idx(n_pad, kg, cfg.gram_jitter_seed),
                           dtype=torch.int64, device=dev)
    ks_j = st.rmatvec(ctx.feats_a, ctx.feats_pad[jidx], t_vec,
                      torch.ones(p, **f32), torch.ones(jidx.shape[0], **f32),
                      _chunk(ctx, ctx.block // kg), ctx.dtype)
    s_pre_j = s_pre[jidx]
    s_post_j = torch.where(
        s_pre_j > 0.0, torch.sqrt(s_pre_j / torch.clamp(ks_j, min=_EPS)),
        0.0)
    waa = ctx.kaa * (s_a[:, None] * s_a[None, :])
    cross = _stream_cross(ctx, cfg, s_a, s_pre, s_sampled=s_post_j,
                          plain=plain)
    vals_m, basis0 = _solve_pxp(cfg, waa, cross, x0)

    # sweep 2: polish rmatvec + scale update + colstats + V
    y_pad = _y_pad(img2d, n_pad)
    y_k = torch.zeros(n_pad_k, **f32)
    y_k[:n_pad] = y_pad
    t_pad = torch.zeros(p_pad, **f32)
    t_pad[:p] = t_vec
    v, norms, coeffs_b, s_new_k = finish_colstats(
        fa_pad, f_t, t_pad, s_pre_k, bm_k, _gr_pad(ctx, basis0 * s_a[:, None]),
        y_k, *_sq_norms_pad(ctx), live=ctx.live)
    m = cfg.num_eigvecs
    return _factor_out(ctx, vals_m, basis0, waa, s_a, s_new_k[:n_pad], y_pad,
                       (norms[:m], coeffs_b[:m], v[:n_pad, :m]))


def _factor_streaming(img2d: torch.Tensor, idx_a: torch.Tensor,
                      cfg: PipelineConfig,
                      omega: torch.Tensor | None = None,
                      plain: bool = False,
                      x0: torch.Tensor | None = None) -> StreamFactor:
    """Affinity -> normalization -> Nystrom eigensolve: a fused schedule
    where its gate admits the recipe and shapes, else the unfused one.
    ``omega``: the sketch's test matrix (strip_cache); ``x0``: LOBPCG's
    start block."""
    check_slice(cfg)
    ctx = _strip_ctx(img2d, idx_a, cfg, plain)
    if _fused_finish_ok(ctx, cfg):
        return _factor_streaming_fused(img2d, ctx, cfg, x0, plain)
    if _strip_fused_ok(ctx, cfg):
        return _factor_strip_fused(img2d, ctx, cfg, omega, plain)
    s = _normalize_streaming(ctx, cfg)
    return _eigensolve_streaming(img2d, ctx, s, cfg, omega, x0)


def _apply_factor(fac: StreamFactor, idx_a: torch.Tensor,
                  cfg: PipelineConfig, h: int, w: int):
    """Spectral filter through the factor: the materialized V, or without
    it one recomputing pass (``rmat_apply``). Returns (z2d, vals)."""
    filt = FILTER_REGISTRY[cfg.filter_name]
    fvals = filt.fn(fac.vals, cfg.filter_param)
    g = (fvals - 1.0) if filt.affine else fvals
    wvec = fac.scale * g * fac.coeffs                 # (m,)
    if fac.v_b is not None:
        z_full = fac.v_b @ wvec                       # one skinny GEMM
    else:
        dtype = (torch.bfloat16 if cfg.affinity_dtype == "bfloat16"
                 else torch.float32)
        block = (max(fac.block, CUDA_CHUNK) if fac.y_pad.is_cuda
                 else fac.block)
        z_full = st.rmat_apply(fac.feats_a, fac.feats_pad, fac.basis0, wvec,
                               fac.s_a, fac.s_b_cols, block, dtype)
    z_full[idx_a] = fac.v_a @ wvec                    # p scatter
    if filt.affine:
        z_full = z_full + fac.y_pad
    z = z_full[:fac.n].reshape(h, w)
    return torch.clamp(z, 0.0, 1.0), fac.vals


def _apply_matvec_streaming(img2d: torch.Tensor, ctx: _StripCtx,
                            s: torch.Tensor, cfg: PipelineConfig,
                            h: int, w: int):
    """f(W) y by repeated W x = s K~(s x) (the operator filter modes): no
    gram, no eigensolve. Returns (z2d, empty eigvals)."""
    n, n_pad = ctx.n, ctx.n_pad
    y_pad = torch.zeros(n_pad, dtype=torch.float32, device=img2d.device)
    y_pad[:n] = img2d.to(torch.float32).reshape(-1)

    def wapply(x):
        return s * ktilde_apply(ctx, s * x)

    z_full = apply_operator_filter(wapply, y_pad, cfg.filter_name,
                                   cfg.filter_param, cfg.filter_mode,
                                   cfg.cheb_degree)
    z = torch.clamp(z_full[:n].reshape(h, w), 0.0, 1.0)
    return z, torch.zeros((0,), dtype=torch.float32, device=img2d.device)


def filter_channel_streaming(img2d: torch.Tensor, idx_a: torch.Tensor,
                             cfg: PipelineConfig,
                             omega: torch.Tensor | None = None,
                             plain: bool = False,
                             x0: torch.Tensor | None = None):
    """One grayscale channel through any of the streaming slices. Returns
    (z2d, vals) on ``img2d``'s device. The reference's perm / inv_perm
    parameters are never read there, so the port does not take them."""
    h, w = img2d.shape
    if cfg.operator_filter():
        check_slice(cfg)
        ctx = _strip_ctx(img2d, idx_a, cfg, plain)
        s = _normalize_streaming(ctx, cfg)
        return _apply_matvec_streaming(img2d, ctx, s, cfg, h, w)
    fac = _factor_streaming(img2d, idx_a, cfg, omega, plain, x0)
    return _apply_factor(fac, idx_a, cfg, h, w)


# staged variants (the reference's separate jits, here plain functions): the
# context is rebuilt per stage, as there, so the stage walls attribute the
# work and the fused ``filter_image`` wall stays the headline

def stage_scales_streaming(img2d: torch.Tensor, idx_a: torch.Tensor,
                           cfg: PipelineConfig):
    """Stage 1: normalization scales s (n_pad,) — the Sinkhorn wall."""
    return _normalize_streaming(_strip_ctx(img2d, idx_a, cfg), cfg)


def stage_matvec_streaming(img2d: torch.Tensor, idx_a: torch.Tensor,
                           s: torch.Tensor, cfg: PipelineConfig):
    """The operator-filter apply after the scales (no eigensolve stage in
    that mode). Returns (z2d, empty eigvals)."""
    h, w = img2d.shape
    return _apply_matvec_streaming(img2d, _strip_ctx(img2d, idx_a, cfg), s,
                                   cfg, h, w)


def stage_factor_streaming(img2d: torch.Tensor, idx_a: torch.Tensor,
                           s: torch.Tensor, cfg: PipelineConfig,
                           omega: torch.Tensor | None = None,
                           x0: torch.Tensor | None = None) -> StreamFactor:
    """Stage 2: the Nystrom eigensolve (cross or sketch, p x p solve,
    colstats) — the eigensolve wall."""
    return _eigensolve_streaming(img2d, _strip_ctx(img2d, idx_a, cfg), s,
                                 cfg, omega, x0)


def stage_apply_streaming(fac: StreamFactor, idx_a: torch.Tensor,
                          cfg: PipelineConfig, h: int, w: int):
    """Stage 3: the O(N m) filter apply. Returns (z2d, vals)."""
    return _apply_factor(fac, idx_a, cfg, h, w)
