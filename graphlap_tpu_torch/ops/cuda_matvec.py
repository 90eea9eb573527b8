"""K5 / K6 — the recompute matvecs of the operator-filter route (port of
``graphlap_tpu/ops/pallas_streaming.py``: ``matvec_pallas`` :397 with
``_matvec_kernel`` :265, ``rmatvec_pallas`` :447 with ``_rmatvec_kernel``
:284).

Both recompute every kernel tile from the padded feature layouts
(ops/recompute_layout: fa (p_pad, 32) rows, f_t (32, n) transposed
features), never storing it:

* ``matvec_cuda`` (K5): K v -> (p_pad,) f32. v rounds to the layout dtype
  first (the reference's wrapper, :442), then an f32 multiply and row sum.
* ``rmatvec_cuda`` (K6): K^T t -> (n,) f32. t rounds to the layout dtype
  first (:490), then a dot with f32 accumulation.

The tile is bf16(exp(-bf16(max(d2, 0)))) with d2 straight from the
augmented product (bf16 aug layout), or exp(-max(na + nb - 2 cross, 0)) in
f32 with the norms summed from the tile values (f32 plain layout); the
plain bf16 layout has the reference's bf16 rounding of the plain d2. On
the f32 layout the kernel forms the "highest" cross as a split-fp16
tensor-core product, or, for features that carry coordinates
(``coords``: the config's ``spatial_h > 0``), as an IEEE f32 FFMA chain
over the ``live`` lanes (``coord_sum_kernel``): (row, col) / spatial_h
reach |f|^2 ~ 3e5 at 8 MP, where the split's fp16 small part loses about
four times the f32 product's error.

CPU tensors take the ``*_plain`` versions (PyTorch ops with the Pallas
bodies' rounding points, over column chunks so that they also run at 8 MP
on the card); CUDA tensors launch ``csrc/recompute_matvec.cu``, which takes
the two layouts the presets reach: bf16 aug and f32 plain, at 32 feature
lanes. Wider layouts (a 7 x 7 patch's 64 lanes and past) raise
``NotImplementedError`` naming ROADMAP.md Queue 2b, and the plain bf16
layout (the reference's ``GLT_AUG_DISABLE`` lever) raises it too; there is
no fallback from a kernel to its
plain version. Unlike K8/K9, the kernels take any p_pad on the 512 quantum
and any n on the 256 one: they hold no whole-p tile. The aug kernel runs
persistent blocks over work items (1024 fixed entries by a split of the
streamed axis, ``_plan``) and reads its tile entries from a table of every
bf16(d2) pattern, built on the card with the same entry function
(``aug_entries`` checks every pattern).
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_affinity import _device_kind
from .cuda_recompute import PLAIN_CHUNK, _r, _tile_plain, coord_lanes
from .streaming import _chunks

FD = 32                   # feature depth of the kernels
P_QUANTUM = 512           # p_pad: the reference's p_tiling quantum
N_QUANTUM = 256           # n: the f32 _tile_n (the bf16 one, 1024, is a multiple)
# streamed entries a tile, fixed entries a block (f32) or work item (aug)
STREAM_TILE = {torch.bfloat16: 256, torch.float32: 128}
FIXED_TILE = {torch.bfloat16: 1024, torch.float32: 128}
COORD_FIXED = 256         # fixed entries a block of the coordinate kernel
_F32 = torch.float32


# --- plain versions -------------------------------------------------------

def matvec_plain(fa, f_t, v, aug: bool = False, live=None, coords=False):
    """((p_pad, dp), (dp, n), (n,)) -> (p_pad,) f32. ``live`` and
    ``coords`` choose the kernel's cross and change no step here."""
    vr = _r(v, fa.dtype)
    out = torch.zeros(fa.shape[0], dtype=_F32, device=fa.device)
    for sl in _chunks(f_t.shape[1], PLAIN_CHUNK):
        kb = _tile_plain(fa, f_t[:, sl], aug).to(_F32)
        out = out + torch.sum(kb * vr[None, sl], dim=1)
    return out


def rmatvec_plain(fa, f_t, t, aug: bool = False, live=None, coords=False):
    """((p_pad, dp), (dp, n), (p_pad,)) -> (n,) f32."""
    tr = _r(t, fa.dtype)
    out = torch.empty(f_t.shape[1], dtype=_F32, device=fa.device)
    for sl in _chunks(f_t.shape[1], PLAIN_CHUNK):
        out[sl] = tr @ _tile_plain(fa, f_t[:, sl], aug).to(_F32)
    return out


# --- kernel wrappers --------------------------------------------------------

def _check(fa, f_t, aug: bool, what: str) -> None:
    dtype = fa.dtype
    if f_t.dtype != dtype or dtype not in FIXED_TILE:
        raise ValueError(f"{what}: fa and f_t must share a bf16 or f32 dtype, "
                         f"got {fa.dtype} and {f_t.dtype}")
    if aug != (dtype == torch.bfloat16):
        raise NotImplementedError(
            f"{what}: the CUDA kernels take the bf16 aug layout and the f32 "
            f"plain layout; the {'f32 aug' if aug else 'plain bf16'} layout "
            f"waits for ROADMAP.md Queue 2 (K5/K6, other layouts)")
    p, n = fa.shape[0], f_t.shape[1]
    fd = fa.shape[1]
    if f_t.shape[0] == fd and fd % 32 == 0 and FD < fd <= 128:
        raise NotImplementedError(
            f"{what}: {fd} feature lanes: the CUDA kernels take {FD} "
            f"(ROADMAP.md Queue 2b)")
    if fd != FD or f_t.shape[0] != FD:
        raise ValueError(f"{what}: the kernels take {FD} feature lanes, got "
                         f"{fa.shape[1]} and {f_t.shape[0]}")
    if p % P_QUANTUM or n % N_QUANTUM:
        raise ValueError(f"{what}: p_pad {p} must be a multiple of "
                         f"{P_QUANTUM} and n {n} of {N_QUANTUM}")


def _splits(aug: bool, fixed_blocks: int, tiles: int) -> int:
    """Streamed-axis splits: where the fixed side's blocks alone leave the
    card's resident slots for the kernel (``glt_recompute_slots``, from the
    occupancy the compiled kernel really has) short, as many splits as fit
    those slots in one wave, none empty."""
    slots = _build.lib().glt_recompute_slots(int(aug))
    if slots <= 0:
        _build.check(-slots if slots < 0 else 1, "recompute_sum: no block fits "
                     "the card")
    splits = max(1, min(tiles, slots // fixed_blocks))
    return -(-tiles // -(-tiles // splits))       # no empty split


def _plan(aug: bool, lf: int, ls: int) -> tuple[int, int]:
    """(splits, blocks) of a launch over k-major (32, lf) fixed and (32, ls)
    streamed layouts: the streamed axis split as ``_splits`` says; the aug
    kernel's persistent blocks, at most one a resident slot and one a work
    item (ceil(lf / 1024) fixed slices by the splits); the f32 kernel's grid
    is its own (blocks 0, unused)."""
    dtype = torch.bfloat16 if aug else _F32
    fixed = -(-lf // FIXED_TILE[dtype])
    splits = _splits(aug, fixed, ls // STREAM_TILE[dtype])
    if not aug:
        return splits, 0
    return splits, min(fixed * splits, _build.lib().glt_recompute_slots(1))


def _recompute_sum(fixed_t, strm_t, w, coord_lv=None):
    """out[f] = sum_s w_s k(f, s) over k-major (32, Lf) / (32, Ls) layouts,
    launched as ``_plan`` says; ``coord_lv``: the coordinate kernel on f32
    layouts, reading that many lanes."""
    aug = fixed_t.dtype == torch.bfloat16
    lf, ls = fixed_t.shape[1], strm_t.shape[1]
    dev = fixed_t.device
    lib = _build.lib()
    if coord_lv is None:
        splits, blocks = _plan(aug, lf, ls)
    else:
        if lf % COORD_FIXED:
            raise ValueError(f"recompute_sum: the coordinate kernel takes "
                             f"{COORD_FIXED}-entry fixed tiles, got {lf}")
        slots = lib.glt_coord_slots(coord_lv)
        if slots <= 0:
            _build.check(-slots if slots < 0 else 1, "coord_sum: no block "
                         "fits the card")
        tiles = ls // STREAM_TILE[_F32]
        splits = max(1, min(tiles, slots // (lf // COORD_FIXED)))
        splits = -(-tiles // -(-tiles // splits))   # no empty split
    out = torch.empty(lf, dtype=_F32, device=dev)
    part = out if splits == 1 else torch.empty((splits, lf), dtype=_F32,
                                               device=dev)
    if coord_lv is None:
        rc = lib.glt_recompute_sum(
            int(aug), fixed_t.data_ptr(), strm_t.data_ptr(), w.data_ptr(),
            part.data_ptr(), out.data_ptr(), lf, ls, splits, blocks,
            _build.stream_ptr(fixed_t))
    else:
        rc = lib.glt_coord_sum(
            fixed_t.data_ptr(), strm_t.data_ptr(), w.data_ptr(),
            part.data_ptr(), out.data_ptr(), lf, ls, splits, coord_lv,
            _build.stream_ptr(fixed_t))
    _build.check(rc, "recompute_sum")
    return out


def _coord_lv(fa, coords, live):
    """The coordinate kernel's lanes where the f32 layout carries
    coordinates, else None (the layout's own kernel)."""
    return coord_lanes(live) if coords and fa.dtype == _F32 else None


def matvec_cuda(fa, f_t, v, aug: bool = False, live=None, coords=False):
    """K v: ((p_pad, 32), (32, n), (n,)) -> (p_pad,) f32 (``matvec_pallas``).
    ``coords``: the f32 layout's features carry coordinates, ``live`` of
    their lanes are nonzero (None: all 32)."""
    if _device_kind(fa, f_t, v) == "cpu":
        return matvec_plain(fa, f_t, v, aug)
    _check(fa, f_t, aug, "matvec")
    if tuple(v.shape) != (f_t.shape[1],):
        raise ValueError(f"matvec: v shape {tuple(v.shape)} != "
                         f"({f_t.shape[1]},)")
    out = _recompute_sum(fa.T.contiguous(), f_t.contiguous(),
                         v.to(fa.dtype).contiguous(),
                         _coord_lv(fa, coords, live))
    matvec_cuda.launches += 1
    return out


def rmatvec_cuda(fa, f_t, t, aug: bool = False, live=None, coords=False):
    """K^T t: ((p_pad, 32), (32, n), (p_pad,)) -> (n,) f32
    (``rmatvec_pallas``); ``live`` and ``coords`` as ``matvec_cuda``."""
    if _device_kind(fa, f_t, t) == "cpu":
        return rmatvec_plain(fa, f_t, t, aug)
    _check(fa, f_t, aug, "rmatvec")
    if tuple(t.shape) != (fa.shape[0],):
        raise ValueError(f"rmatvec: t shape {tuple(t.shape)} != "
                         f"({fa.shape[0]},)")
    out = _recompute_sum(f_t.contiguous(), fa.T.contiguous(),
                         t.to(fa.dtype).contiguous(),
                         _coord_lv(fa, coords, live))
    rmatvec_cuda.launches += 1
    return out


matvec_cuda.launches = 0
rmatvec_cuda.launches = 0


def aug_entries(route: int, device) -> torch.Tensor:
    """The aug tile entry's bf16 bits at every one of the 65536 bf16(d2)
    patterns, (65536,) int32, on the card: route 0 evaluates the entry
    (``kb_aug``, as the plain route does), route 1 takes the aug kernel's
    table lookup. No path calls it: ``chip_smoke.py`` requires the two
    equal."""
    out = torch.empty(65536, dtype=torch.int16, device=device)
    _build.check(_build.lib().glt_aug_entries(out.data_ptr(), int(route),
                                              _build.stream_ptr(out)),
                 "aug_entries")
    return out.to(torch.int32) & 0xFFFF
