"""Host-side layout of the recompute-streaming kernels (port of the helpers
in ``graphlap_tpu/ops/pallas_streaming.py``: ``d_pad_of`` :53, ``p_tiling``
:77, ``_tile_p_of`` :88, ``_tile_n`` :92, ``_pick_tn`` :121, ``aug_d_pad_of``
:191, ``aug_pads`` :210, ``m_pad_of`` :497, ``_require_whole_p`` :514 and
their constants).

These quanta are the reference's. The port keeps them so that both
packages route a config down the same branch and pad its operands the same
way (the fused-finish gate, the K7 gate, n_pad_k); the CUDA kernels choose
their own tiles inside those pads (ops/cuda_recompute.py).
"""

from __future__ import annotations

import torch

D_PAD = 128          # widest feature pad the reference's kernels take
MAX_TILE_P = 4096    # whole-p tile bound of the fused-finish gate
M_PAD = 128          # the reference's eigvec-axis pad of the V buffer
EMIT_TN = 512        # column quantum of the reference's K7 emitter
MATVEC_TN_CAP = 4096  # widest column tile of the reference's K5/K6
FINISH_EPS = 1e-30   # the Sinkhorn floor inside the fused kernels
AUG_LANES = 6        # three compensated norm lanes per side


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def d_pad_of(d: int) -> int:
    """Feature width padded to 32 (one layout for f32 and bf16 tiles)."""
    if d > D_PAD:
        raise ValueError(f"feature dim {d} > {D_PAD}; add a k-loop")
    return max(32, _cdiv(d, 32) * 32)


def aug_d_pad_of(d: int) -> int:
    return d_pad_of(d + AUG_LANES)


def p_tiling(p: int) -> tuple[int, int]:
    """(tile, p_pad): the fewest equal 512-aligned tiles of at most
    MAX_TILE_P rows that cover p."""
    k = _cdiv(p, MAX_TILE_P)
    tp = _cdiv(_cdiv(p, k), 512) * 512
    return tp, tp * k


def _tile_p_of(p_pad: int) -> int:
    """The reference's K5/K6 p tile: p_pad in equal tiles of <= MAX_TILE_P
    (the port's K5/K6 hold no p tile; p_pad 5120 is two of them)."""
    return p_pad // _cdiv(p_pad, MAX_TILE_P)


def _tile_n(dtype: torch.dtype) -> int:
    """The n-axis pad quantum: n_pad_k is a multiple of it."""
    return 1024 if dtype == torch.bfloat16 else 256


def _pick_tn(n_pad: int, dtype: torch.dtype, cap: int) -> int:
    """The reference's column tile: the _tile_n quantum doubled while it
    divides n_pad, up to ``cap`` (a schedule choice of its kernels; the
    port's kernels choose their own)."""
    t = _tile_n(dtype)
    while t * 2 <= cap and n_pad % (t * 2) == 0:
        t *= 2
    return t


def m_pad_of(m: int) -> int:
    """The reference's V-buffer width (its gate sizes V with it)."""
    return M_PAD


def _require_whole_p(p_pad: int, name: str) -> None:
    """The reference's whole-p bound of the fused finish: its kernels, and
    the port's K8 (its cluster holds every sample row of a column tile, so
    the tile's two consumers share it without recomputing it), take
    p_pad <= MAX_TILE_P."""
    if p_pad > MAX_TILE_P:
        raise ValueError(
            f"{name} needs p_pad <= {MAX_TILE_P} (whole-p tile), got "
            f"{p_pad} — use the unfused sweeps for larger p")


def _split3(x: torch.Tensor):
    """x (f32) as three bf16 lanes hi + mid + lo (a compensated split)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _sq_norms(fr: torch.Tensor) -> torch.Tensor:
    """Row sums of squares of bf16 features, in f32, lane after lane."""
    f = fr.to(torch.float32)
    acc = f[:, 0] * f[:, 0]
    for i in range(1, f.shape[1]):
        acc = acc + f[:, i] * f[:, i]
    return acc


def aug_pads(feats_a: torch.Tensor, feats_n: torch.Tensor, n_pad: int):
    """Augmented bf16 layouts: ((p, d) features, (n, d) features, n_pad) ->
    (fa_aug (p_pad, dp), f_t_aug (dp, n_pad)), so that one bf16 GEMM with
    f32 accumulation gives the squared distance directly:

        fa' = [-2 f_r, na_hi, na_mid, na_lo, 1, 1, 1, 0...]
        ft' = [ f_r,   1,     1,      1, nb_hi, nb_mid, nb_lo, 0...]

    f_r are the bf16-rounded features and na / nb their f32 square norms,
    each carried as three compensated bf16 lanes. The ft rows [0:d] are the
    plain bf16 layout, so ft' also serves the plain-class K9. Every bf16
    rounding is an explicit ``.to(bfloat16)``: PyTorch runs eagerly, so no
    compiler can elide the round trips (the reference needed optimization
    barriers for that; ``tests/test_torch_recompute.py`` pins the nonzero
    compensation lanes)."""
    p, d = feats_a.shape
    n = feats_n.shape[0]
    dp = aug_d_pad_of(d)
    _, p_pad = p_tiling(p)
    dev = feats_a.device
    bf = torch.bfloat16
    fr_a = feats_a.to(bf)
    fr_n = feats_n.to(bf)
    na_hi, na_mid, na_lo = _split3(_sq_norms(fr_a))
    nb_hi, nb_mid, nb_lo = _split3(_sq_norms(fr_n))
    fa = torch.zeros((p_pad, dp), dtype=bf, device=dev)
    fa[:p, :d] = -2.0 * fr_a                 # exact: a bf16 times -2
    fa[:p, d] = na_hi
    fa[:p, d + 1] = na_mid
    fa[:p, d + 2] = na_lo
    fa[:p, d + 3:d + 6] = 1.0
    ft = torch.zeros((dp, n_pad), dtype=bf, device=dev)
    ft[:d, :n] = fr_n.T
    ft[d:d + 3, :n] = 1.0
    ft[d + 3, :n] = nb_hi
    ft[d + 4, :n] = nb_mid
    ft[d + 5, :n] = nb_lo
    return fa, ft
