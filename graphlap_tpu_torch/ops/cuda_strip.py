"""K2-K4 — the fused strip sweeps of the strip_cache factor (port of
``graphlap_tpu/ops/pallas_streaming.py:898-1152``).

Each wrapper consumes a materialized (P, N) strip whose padding rows and
columns are exactly zero (the K1 emitter poisons the padding features so
exp underflows to 0):

* ``strip_ext2_cuda`` (K2, ``strip_ext2_pallas``): Sinkhorn extension +
  polish matvec — kbt = K^T [t_r, t_c], s = bm / sqrt(max(kbt_r kbt_c,
  eps)), u = K s.
* ``strip_sandwich_spost_cuda`` (K3, ``strip_sandwich_spost_pallas``):
  polish rmatvec + post-polish scales + first sketch sandwich —
  ks = K^T t, s_post = sqrt(s_pre / max(ks, eps)) bm,
  u = K r((K^T ta) s_post^2).
* ``strip_sandwich_cuda`` (K4, ``strip_sandwich_pallas``):
  u = K r((K^T ta) s2).

Rounding points are the Pallas bodies' (``_strip_prec``): t2, t and ta
round to the strip dtype before the products, products accumulate in f32,
and the sandwich's ws rounds to the strip dtype (r above) before the second
product. A bf16 strip (bfloat16_store) takes bf16 operands; an f32 strip
(affinity_dtype float32) is the reference's "highest" class: every operand
and ws stay f32 and every product is f32-accurate (never plain TF32; the
kernel runs it as six products of bf16 parts). CPU tensors take
the ``*_plain`` versions (PyTorch ops with those rounding points); CUDA
tensors launch ``csrc/strip_sweeps.cu`` on a bf16 or an f32 strip, whose
row count must be a multiple of ``P_QUANTUM``; any other strip dtype
raises. There is no fallback from a kernel to its plain version.

Strip reads a call on CUDA: K2 1, K3 2, K4 2 (the Pallas kernels read it
once each). K2 runs in thread-block clusters that share slabs of 128-byte
rows (64 bf16 or 32 f32 columns, ``ext2_plan``): each block holds its slice
of the slab's rows in shared memory, the blocks push their column-sum
partials into each other's shared memory, and the row sums K s are formed
from the same staged rows. K3/K4 are two launches of one kernel a strip
dtype, both on wgmma with a TMA ring and two consumer warpgroups (bf16: a
producer warpgroup; f32: a converter warpgroup that splits each f32 strip
tile into three bf16 parts in shared memory, ta and ws split by small
passes, the six part products that keep the product f32-exact, 32-deep
stages summed from zero): W = K^T ta with the ws epilogue, then U = K ws
split over N into fixed-order partials (``sandwich_splits``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build
from .cuda_affinity import _device_kind

EPS = 1e-30
P_QUANTUM = 128          # strip rows per sandwich tile (csrc SW_BM, SS_BM)
KP_QUANTUM = 256         # sketch columns per bf16 sandwich tile (csrc SW_BN)
KP_QUANTUM_F32 = 256     # sketch columns per f32 sandwich tile (csrc SS_BN)
F32_BLOCKS_PER_SM = 1    # f32 sandwich blocks an SM (csrc SS_SMEM, 212 KB)
F32_STAGE_DEPTH = 32     # strip columns per f32 phase-2 stage (csrc SS_BK)
F32_PARTS = 3            # bf16 parts of each f32 sandwich operand (split3_grid)
EXT2_ROW = 128           # bytes of a K2 slab row (csrc X2_ROW)
EXT2_SLAB = 64           # K2's columns a bf16 slab (32 on an f32 strip)
EXT2_MAX_P = 8192        # the largest P the path gives (config sample_cap)
SMEM_CAP = 232448        # an H100 block's shared memory (227 KB)
STRIP_DTYPES = (torch.bfloat16, torch.float32)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the strip dtype, carried in f32."""
    return x.to(dtype).to(torch.float32)


# --- plain versions -------------------------------------------------------

def strip_ext2_plain(strip, t2, b_mask):
    kb = strip.to(torch.float32)
    kbt = _rounded(t2, strip.dtype) @ kb                    # (2, N)
    prod = torch.clamp(kbt[0] * kbt[1], min=EPS)
    s = b_mask.to(torch.float32) / torch.sqrt(prod)
    return kb @ s, s


def _sandwich_plain(kb, ta, s2, dtype):
    w = kb.T @ _rounded(ta, dtype)                          # (N, kp)
    ws = _rounded(w * s2[:, None], dtype)
    return kb @ ws


def strip_sandwich_spost_plain(strip, ta, t, s_pre, b_mask):
    kb = strip.to(torch.float32)
    ks = _rounded(t, strip.dtype) @ kb
    s_post = (torch.sqrt(s_pre.to(torch.float32) / torch.clamp(ks, min=EPS))
              * b_mask.to(torch.float32))
    return _sandwich_plain(kb, ta, s_post * s_post, strip.dtype), s_post


def strip_sandwich_plain(strip, ta, s2):
    kb = strip.to(torch.float32)
    return _sandwich_plain(kb, ta, s2.to(torch.float32), strip.dtype)


# --- kernel wrappers --------------------------------------------------------

def _check_strip(strip: torch.Tensor, what: str) -> None:
    if strip.dtype not in STRIP_DTYPES:
        raise ValueError(f"{what}: the CUDA sweep kernels take a bf16 strip "
                         f"(bfloat16_store) or an f32 one, not {strip.dtype}")
    if not strip.is_contiguous():
        raise ValueError(f"{what}: strip must be contiguous")


def _sms(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


@dataclass(frozen=True)
class Ext2Plan:
    """K2's launch plan for P strip rows: clusters of ``cluster`` blocks,
    each block ``rows`` = P / cluster of the rows, ``stages`` 64-column slabs
    of them in flight, ``smem`` shared bytes a block."""
    cluster: int
    rows: int
    stages: int
    smem: int


def ext2_smem(rows: int, stages: int, cluster: int,
              width: int = EXT2_SLAB) -> int:
    """csrc ``x2_smem``: alignment slack, the slabs (128 bytes a row),
    tr and tc of the rows, 16 warps' kbt partials, the block's partial, the
    partials received from the cluster (two slabs), s, and the barriers (one
    a stage, two for the received partials); ``width`` columns a slab."""
    return (1024 + stages * rows * EXT2_ROW
            + 4 * (2 * rows + 16 * 2 * width + 2 * width
                   + 2 * cluster * 2 * width + width)
            + 8 * (stages + 2))


def ext2_plan(p: int, itemsize: int = 2) -> Ext2Plan:
    """The plan csrc ``glt_strip_ext2`` (bf16, ``itemsize`` 2) or
    ``glt_strip_ext2_f32`` (4) takes for P rows (a positive multiple of 128
    up to 8192): clusters of 8 (portable) with the most slabs in flight (up
    to 4) that fit, at least 2 so the next slab loads while one is summed;
    past that (bf16 P > 6400, f32 P > 6656) clusters of 16. Raises for a P
    outside that range."""
    if p <= 0 or p % P_QUANTUM or p > EXT2_MAX_P:
        raise ValueError(f"strip_ext2: strip rows {p} must be a positive "
                         f"multiple of {P_QUANTUM} up to {EXT2_MAX_P}")
    width = EXT2_ROW // itemsize
    for cluster in (8, 16):
        rows = p // cluster
        for stages in (4, 3, 2):
            smem = ext2_smem(rows, stages, cluster, width)
            if smem <= SMEM_CAP:
                return Ext2Plan(cluster, rows, stages, smem)
    raise ValueError(f"strip_ext2: no plan fits P={p}")


def _aligned(x: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0


def _tma_strip(strip: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(strip, ld): the kernels read rows a multiple of 16 bytes apart from
    a 16-byte aligned base, so a strip whose rows are not (N % 8 != 0 in
    bf16, N % 4 != 0 in f32) is copied once into zero-padded rows."""
    p, n = strip.shape
    per = 16 // strip.element_size()
    ld = math.ceil(n / per) * per
    if ld != n or not _aligned(strip):
        padded = torch.zeros((p, ld), dtype=strip.dtype, device=strip.device)
        padded[:, :n] = strip
        strip = padded
    return strip, ld


def strip_ext2_cuda(strip, t2, b_mask):
    """((P, N) strip, (2, P), (N,)) -> (u (P,) f32, s (N,) f32)."""
    if _device_kind(strip, t2, b_mask) == "cpu":
        return strip_ext2_plain(strip, t2, b_mask)
    _check_strip(strip, "strip_ext2")
    p, n = strip.shape
    if t2.shape != (2, p) or b_mask.shape != (n,):
        raise ValueError(f"strip_ext2: shapes {tuple(t2.shape)}, "
                         f"{tuple(b_mask.shape)} do not fit strip {(p, n)}")
    if n == 0:
        raise ValueError("strip_ext2: empty strip")
    f32 = strip.dtype == torch.float32
    plan = ext2_plan(p, strip.element_size())
    lib = _build.lib()
    occupancy, launch = ((lib.glt_strip_ext2_f32_clusters,
                          lib.glt_strip_ext2_f32) if f32 else
                         (lib.glt_ext2_strip_clusters, lib.glt_strip_ext2))
    clusters = occupancy(plan.cluster, plan.rows, plan.stages)
    _build.check(-min(clusters, 0), "strip_ext2 (cluster occupancy)")
    if clusters == 0:
        raise RuntimeError(f"strip_ext2: no cluster of {plan.cluster} blocks "
                           f"with {plan.smem} B each fits the card")
    clusters = min(clusters,
                   math.ceil(n / (EXT2_ROW // strip.element_size())))
    strip, ld = _tma_strip(strip)
    t2k = t2.to(strip.dtype).contiguous()      # bf16 strip: t2 rounded
    bm = _f32(b_mask)
    s = torch.empty(n, dtype=torch.float32, device=strip.device)
    u_part = torch.empty((clusters, p), dtype=torch.float32,
                         device=strip.device)
    u = torch.empty(p, dtype=torch.float32, device=strip.device)
    rc = launch(strip.data_ptr(), t2k.data_ptr(), bm.data_ptr(),
                s.data_ptr(), u_part.data_ptr(), u.data_ptr(), p, n, ld,
                plan.cluster, plan.stages, clusters,
                _build.stream_ptr(strip))
    _build.check(rc, "strip_ext2")
    strip_ext2_cuda.launches += 1
    return u, s


def sandwich_splits(p: int, n: int, kp: int, sms: int,
                    tile_n: int = KP_QUANTUM, per_sm: int = 1,
                    depth: int = 64) -> int:
    """Phase 2's split of the N columns: the count S of slices (each a
    whole number of ``depth``-column stages) whose (P / 128) x (kp /
    ``tile_n``) x S blocks, ``per_sm`` an SM, fill their last wave best;
    ties take the fewer. The defaults are the bf16 kernel's (one 128 x 256
    tile an SM, 64-deep stages); the f32 kernel runs one 128 x 256 tile an
    SM in 32-deep stages."""
    tiles = (p // P_QUANTUM) * (kp // tile_n)
    slots = sms * per_sm
    top = min(4 * math.ceil(slots / tiles), math.ceil(n / depth))
    best, best_eff = 1, 0.0
    for s in range(1, max(1, top) + 1):
        eff = tiles * s / (math.ceil(tiles * s / slots) * slots)
        if eff > best_eff + 1e-9:
            best, best_eff = s, eff
    return best


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as a contiguous ``dtype`` tensor on a 16-byte boundary (TMA's and
    cp.async's)."""
    x = x.to(dtype).contiguous()
    return x if _aligned(x) else x.clone()


def _sandwich_launch(strip, ta, t, s_pre, b_mask, s2, what):
    _check_strip(strip, what)
    p, n = strip.shape
    kp = ta.shape[1]
    if ta.shape[0] != p:
        raise ValueError(f"{what}: ta rows {ta.shape[0]} != strip rows {p}")
    for name, x, size in (("t", t, p), ("s_pre", s_pre, n),
                          ("b_mask", b_mask, n), ("s2", s2, n)):
        if x is not None and x.shape != (size,):
            raise ValueError(f"{what}: {name} shape {tuple(x.shape)} != "
                             f"{(size,)}")
    if p % P_QUANTUM or p == 0:
        raise ValueError(f"{what}: strip rows {p} must be a positive "
                         f"multiple of {P_QUANTUM}")
    if n == 0 or kp == 0:
        raise ValueError(f"{what}: empty strip or ta ({n} columns, kp {kp})")
    dev, dt = strip.device, strip.dtype
    f32 = dt == torch.float32
    strip, ld = _tma_strip(strip)
    quantum = KP_QUANTUM_F32 if f32 else KP_QUANTUM
    kp2 = math.ceil(kp / quantum) * quantum
    if kp2 == kp:                     # the callers' kp: no zero padding
        tab = _operand(ta, dt)
    else:
        tab = torch.zeros((p, kp2), dtype=dt, device=dev)
        tab[:, :kp] = ta.to(dt)
    splits = (sandwich_splits(p, n, kp2, _sms(strip), KP_QUANTUM_F32,
                              F32_BLOCKS_PER_SM, F32_STAGE_DEPTH) if f32 else
              sandwich_splits(p, n, kp2, _sms(strip)))
    ws = torch.empty((n, kp2), dtype=dt, device=dev)
    # on an f32 strip ta and ws run as their three bf16 parts
    scratch = ([torch.empty((F32_PARTS, p, kp2), dtype=torch.bfloat16,
                            device=dev),
                torch.empty((F32_PARTS, n, kp2), dtype=torch.bfloat16,
                            device=dev)] if f32 else [])
    part = torch.empty((splits, p, kp2), dtype=torch.float32, device=dev)
    u = torch.empty((p, kp2), dtype=torch.float32, device=dev)
    s_post = torch.empty(n, dtype=torch.float32, device=dev)
    # K4 passes None for t, s_pre and b_mask; K3 for s2 (NULL in C)
    tb = None if t is None else _operand(t, dt)
    vecs = [None if x is None else _f32(x) for x in (s_pre, b_mask, s2)]
    ptrs = [None if x is None else x.data_ptr() for x in (tb, *vecs)]
    lib = _build.lib()
    launch = lib.glt_strip_sandwich_f32 if f32 else lib.glt_strip_sandwich
    rc = launch(strip.data_ptr(), tab.data_ptr(), *ptrs, s_post.data_ptr(),
                ws.data_ptr(), *(x.data_ptr() for x in scratch),
                part.data_ptr(), u.data_ptr(), p, n, ld, kp2, splits,
                _build.stream_ptr(strip))
    _build.check(rc, what)
    return u[:, :kp], s_post


def strip_sandwich_spost_cuda(strip, ta, t, s_pre, b_mask):
    """((P, N) strip, (P, kp), (P,), (N,), (N,)) ->
    (u (P, kp) f32, s_post (N,) f32)."""
    if _device_kind(strip, ta, t, s_pre, b_mask) == "cpu":
        return strip_sandwich_spost_plain(strip, ta, t, s_pre, b_mask)
    out = _sandwich_launch(strip, ta, t, s_pre, b_mask, None,
                           "strip_sandwich_spost")
    strip_sandwich_spost_cuda.launches += 1
    return out


def strip_sandwich_cuda(strip, ta, s2):
    """((P, N) strip, (P, kp), (N,) squared column scales) -> u (P, kp)."""
    if _device_kind(strip, ta, s2) == "cpu":
        return strip_sandwich_plain(strip, ta, s2)
    u, _ = _sandwich_launch(strip, ta, None, None, None, s2, "strip_sandwich")
    strip_sandwich_cuda.launches += 1
    return u


strip_ext2_cuda.launches = 0
strip_sandwich_spost_cuda.launches = 0
strip_sandwich_cuda.launches = 0
