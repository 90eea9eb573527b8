"""K5 / K6 — the recompute matvecs of the operator-filter route (port of
``graphlap_tpu/ops/pallas_streaming.py``: ``matvec_pallas`` :397 with
``_matvec_kernel`` :265, ``rmatvec_pallas`` :447 with ``_rmatvec_kernel``
:284).

Both recompute every kernel tile from the padded feature layouts
(ops/recompute_layout: fa (p_pad, dp) rows, f_t (dp, n) transposed
features, dp 32, 64, 96 or 128 lanes), never storing it:

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
over the ``live`` lanes (``coord_tile_kernel``, an SGEMM-like register
tile): (row, col) / spatial_h reach |f|^2 ~ 3e5 at 8 MP, where the split's
fp16 small part loses about four times the f32 product's error.

CPU tensors take the ``*_plain`` versions (PyTorch ops with the Pallas
bodies' rounding points, over column chunks so that they also run at 8 MP
on the card); CUDA tensors launch ``csrc/recompute_matvec.cu``, which takes
the two layouts the presets reach: bf16 aug and f32 plain, at 32, 64, 96
or 128 feature lanes (an NLM 5 x 5, 7 x 7, 9 x 9 or 11 x 11 patch: each
kernel is a template on its depth). The coordinate kernel takes the same
layouts and reads only their first ``_lanes(live, fd)`` lanes (4, 28, 52,
84 or 124 on the recipes' layouts; the pad lanes are zero), 128 fixed
entries a block by 128-entry streamed tiles, each entry's norm from a
pre-pass into a scratch vector (``coord_norms_kernel``).
The plain bf16 layout (the reference's ``GLT_AUG_DISABLE`` lever) and an
f32 aug layout raise ``NotImplementedError``: no preset builds them, and
no ROADMAP.md queue ports them. There is no fallback from a kernel to its
plain version. Unlike K8/K9, the kernels
take any p_pad on the 512 quantum and any n on the 256 one: they hold no
whole-p tile. The aug kernel runs persistent blocks over work items (1024
fixed entries at 32 lanes, 512 at 64 and 96, 256 at 128, by a split of the
streamed axis, ``_plan``) and reads its tile entries from a table of every
bf16(d2) pattern, built on the card with the same entry function
(``aug_entries`` checks every pattern), or at 128 lanes evaluates them as
K7 does (kb_pair, which ``kb_entries`` checks at every pattern).
"""

from __future__ import annotations

import math

import torch

from . import _build
from .cuda_affinity import _device_kind
from .cuda_recompute import PLAIN_CHUNK, _aligned, _lanes, _r, _tile_plain
from .streaming import _chunks

P_QUANTUM = 512           # p_pad: the reference's p_tiling quantum
N_QUANTUM = 256           # n: the f32 _tile_n (the bf16 one, 1024, is a multiple)
# by (layout dtype, feature depth): streamed entries a tile, fixed entries a
# block (f32) or work item (aug); the keys are the kernels' instantiations
# (csrc template FD)
STREAM_TILE = {(torch.bfloat16, 32): 256, (torch.bfloat16, 64): 256,
               (torch.bfloat16, 96): 128, (torch.bfloat16, 128): 256,
               (torch.float32, 32): 128, (torch.float32, 64): 128,
               (torch.float32, 96): 128, (torch.float32, 128): 128}
FIXED_TILE = {(torch.bfloat16, 32): 1024, (torch.bfloat16, 64): 512,
              (torch.bfloat16, 96): 512, (torch.bfloat16, 128): 256,
              (torch.float32, 32): 128, (torch.float32, 64): 128,
              (torch.float32, 96): 128, (torch.float32, 128): 128}
D_PAD = 128               # the reference's widest feature layout
COORD_FIXED = 128         # the coordinate kernel's fixed entries a block (csrc CT_FT)
COORD_STREAM = 128        # and streamed entries a tile (CT_ST)
COORD_WAVES = 4           # its splits fill at most this many waves exactly
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
    """Raise unless a kernel takes the layout."""
    dtype = fa.dtype
    if f_t.dtype != dtype or dtype not in (torch.bfloat16, _F32):
        raise ValueError(f"{what}: fa and f_t must share a bf16 or f32 dtype, "
                         f"got {fa.dtype} and {f_t.dtype}")
    if aug != (dtype == torch.bfloat16):
        raise NotImplementedError(
            f"{what}: the CUDA kernels take the bf16 aug layout and the f32 "
            f"plain layout; no preset builds the "
            f"{'f32 aug' if aug else 'plain bf16'} layout, and no ROADMAP.md "
            f"queue ports it")
    p, n = fa.shape[0], f_t.shape[1]
    fd = fa.shape[1]
    if f_t.shape[0] != fd or fd % 32 or not 0 < fd <= D_PAD:
        raise ValueError(f"{what}: the layouts take a multiple of 32 feature "
                         f"lanes up to {D_PAD}, alike in fa and f_t, got "
                         f"{fa.shape[1]} and {f_t.shape[0]}")
    if p % P_QUANTUM or n % N_QUANTUM:
        raise ValueError(f"{what}: p_pad {p} must be a multiple of "
                         f"{P_QUANTUM} and n {n} of {N_QUANTUM}")


def _slots(aug: bool, fd: int) -> int:
    """Blocks of the layout's kernel at depth ``fd`` resident on the card at
    once (``glt_recompute_slots``, from the occupancy the compiled kernel
    really has)."""
    slots = _build.lib().glt_recompute_slots(int(aug), fd)
    if slots <= 0:
        _build.check(-slots if slots < 0 else 1, "recompute_sum: no block fits "
                     "the card")
    return slots


def _splits(aug: bool, fixed_blocks: int, tiles: int, fd: int) -> int:
    """Streamed-axis splits: where the fixed side's blocks alone leave the
    card's resident slots for the kernel (``_slots``) short, as many splits
    as fit those slots in one wave, none empty."""
    splits = max(1, min(tiles, _slots(aug, fd) // fixed_blocks))
    return -(-tiles // -(-tiles // splits))       # no empty split


def _plan(aug: bool, lf: int, ls: int, fd: int) -> tuple[int, int]:
    """(splits, blocks) of a launch over k-major (fd, lf) fixed and (fd, ls)
    streamed layouts: the streamed axis split as ``_splits`` says; the aug
    kernel's persistent blocks, at most one a resident slot and one a work
    item (ceil(lf / FIXED_TILE) fixed slices by the splits); the f32
    kernel's grid is its own (blocks 0, unused)."""
    key = (torch.bfloat16 if aug else _F32, fd)
    fixed = -(-lf // FIXED_TILE[key])
    splits = _splits(aug, fixed, ls // STREAM_TILE[key], fd)
    if not aug:
        return splits, 0
    return splits, min(fixed * splits, _slots(True, fd))


def _coord_plan(lf: int, ls: int, lv: int) -> int:
    """Streamed-axis splits of a coordinate-kernel launch over (lv, lf)
    fixed and (lv, ls) streamed layouts, where the fixed side's blocks
    alone leave the card's resident slots at lv lanes (``glt_coord_slots``)
    short: as many as fill whole waves of them exactly, in at most
    COORD_WAVES waves (the 8 MP K5: 32 fixed blocks on 264 slots, 33
    splits in 4 waves, where 8 would leave 8 slots idle), else as many as
    fill one wave; none empty."""
    if lf % COORD_FIXED or ls % COORD_STREAM:
        raise ValueError(f"recompute_sum: the coordinate kernel takes "
                         f"{COORD_FIXED}-entry fixed and {COORD_STREAM}-entry "
                         f"streamed tiles, got {lf} and {ls}")
    slots = _build.lib().glt_coord_slots(lv)
    if slots <= 0:
        _build.check(-slots if slots < 0 else 1, "coord_sum: no block fits "
                     "the card")
    tiles, fixed = ls // COORD_STREAM, lf // COORD_FIXED
    waves = fixed // math.gcd(fixed, slots)
    splits = (slots * waves // fixed if fixed < slots and waves <= COORD_WAVES
              else slots // fixed)
    splits = max(1, min(tiles, splits))
    return -(-tiles // -(-tiles // splits))       # no empty split


def _recompute_sum(fixed_t, strm_t, w, coord_lv=None):
    """out[f] = sum_s w_s k(f, s) over k-major (fd, Lf) / (fd, Ls) layouts,
    launched as ``_plan`` says; ``coord_lv``: the coordinate kernel on f32
    layouts, reading their first that many lanes (``_coord_plan``)."""
    aug = fixed_t.dtype == torch.bfloat16
    fd, lf, ls = fixed_t.shape[0], fixed_t.shape[1], strm_t.shape[1]
    dev = fixed_t.device
    lib = _build.lib()
    if coord_lv is None:
        splits, blocks = _plan(aug, lf, ls, fd)
    else:
        splits = _coord_plan(lf, ls, coord_lv)
        fixed_t, strm_t, w = _aligned(fixed_t, strm_t, w)
    out = torch.empty(lf, dtype=_F32, device=dev)
    part = out if splits == 1 else torch.empty((splits, lf), dtype=_F32,
                                               device=dev)
    if coord_lv is None:
        rc = lib.glt_recompute_sum(
            int(aug), fd, fixed_t.data_ptr(), strm_t.data_ptr(), w.data_ptr(),
            part.data_ptr(), out.data_ptr(), lf, ls, splits, blocks,
            _build.stream_ptr(fixed_t))
    else:
        norms = torch.empty(lf + ls, dtype=_F32, device=dev)
        rc = lib.glt_coord_sum(
            fixed_t.data_ptr(), strm_t.data_ptr(), w.data_ptr(),
            norms.data_ptr(), part.data_ptr(), out.data_ptr(), lf, ls, splits,
            coord_lv, _build.stream_ptr(fixed_t))
    _build.check(rc, "recompute_sum")
    return out


def _coord_lv(fa, coords, live):
    """The coordinate kernel's lanes where the f32 layout carries
    coordinates (its live lanes rounded up to 4), else None (the layout's
    own kernel)."""
    if not (coords and fa.dtype == _F32):
        return None
    return _lanes(live, fa.shape[1])


def matvec_cuda(fa, f_t, v, aug: bool = False, live=None, coords=False):
    """K v: ((p_pad, dp), (dp, n), (n,)) -> (p_pad,) f32
    (``matvec_pallas``), dp 32, 64, 96 or 128. ``coords``: the f32 layout's
    features carry coordinates, ``live`` of their dp lanes are nonzero
    (None: all dp)."""
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
    """K^T t: ((p_pad, dp), (dp, n), (p_pad,)) -> (n,) f32
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
