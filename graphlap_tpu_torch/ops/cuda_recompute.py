"""K7-K10 — the recompute-streaming kernels of the spectral paths (port of
``graphlap_tpu/ops/pallas_streaming.py``: ``kb_strip_pallas`` :319 with
``gram_pallas`` :369 around it, ``ext2_matvec_pallas`` :554,
``finish_colstats_pallas`` :677, ``colstats_v_pallas`` :817).

Each recomputes kernel tiles from padded feature layouts
(ops/recompute_layout: fa (p_pad, dp) rows, f_t (dp, n) transposed
features):

* ``kb_strip_cuda`` (K7): the column-scaled tile bf16(k * bf16(cols)),
  (p_pad, S), which ``gram_cuda`` turns into the (p_pad, p_pad) gram with
  one bf16-in / f32-out GEMM per superblock of ``GRAM_SUPER`` columns.
* ``ext2_matvec_cuda`` (K8): kbt = k^T bf16([t_r, t_c]), s = bm /
  sqrt(max(kbt_r kbt_c, eps)), u = K s.
* ``finish_colstats_cuda`` (K9): ks = k^T bf16(t), s = sqrt(s_pre /
  max(ks, eps)) bm, V = bf16(k bf16(s))^T bf16(gr), norms = sum V^2,
  coeffs = V^T y; the tile is the plain class (f32 norms passed in, f32
  exp, then bf16).
* ``colstats_v_cuda`` (K10): K9 without ks and the scale update, for the
  unfused eigensolve: V = bf16(k bf16(c))^T bf16(gr), norms, coeffs, with
  the same plain-class tile (``csrc/colstats_v.cu``).

Tile precision: with bf16 layouts and ``aug`` the tile is
bf16(exp(-bf16(max(d2, 0)))) with d2 straight from the augmented product;
without ``aug`` (K7/K8 plain layout) d2 = na + nb - 2 cross from the tile
values; f32 layouts keep f32 throughout (the reference's "highest" class:
no bf16 rounding point, f32 products).

CPU tensors take the ``*_plain`` versions (PyTorch ops with the Pallas
bodies' rounding points, over column chunks so that they also run at 8 MP
on the card); CUDA tensors launch ``csrc/recompute_sweeps.cu`` (K7, K8) or
``csrc/colstats_v.cu`` (K10's V pass; the bf16 K9 is a ks pass over all of
p, then the same V pass with c = s; the f32 K9 forms each entry once, with
ks from the same sums as V) on the two layouts the presets build, each
with 32, 64, 96 or 128 feature lanes (the bf16 kernels are templates on
their depth): bf16 (aug for K7/K8, plain for K9/K10; an NLM 5 x 5, 7 x 7, 9 x 9
or 11 x 11 patch), and f32 plain (the bilateral recipes, ``spatial_h >
0``: gaussian or an NLM 5 x 5 patch with the coordinates, 4 or 28 live
lanes of 32, or an NLM 7 x 7, 9 x 9 or 11 x 11 patch with them, 52, 84 or
124 live lanes of 64, 96 or 128), whose kernels form each entry with an
IEEE f32 FFMA cross over the ``live`` lanes (the caller's feature width
rounded up to 4; None reads all of them) and expf (the f32 K7 in the
register-tiled store kernel it shares with K1's coordinate cross,
``csrc/coord_store.cu``; the f32 K9 / K10 then
run V and ks on the tensor cores, each f32 operand in three bf16 parts:
f32-exact products, rounded to nearest). The plain-bf16 K7/K8
layout and an f32 aug layout raise ``NotImplementedError`` (no preset
builds either). There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_affinity import EPI_SCALED, _device_kind, store_plan
from .linalg import mm_f32
from .recompute_layout import FINISH_EPS, _require_whole_p
from .streaming import _chunks

PLAIN_CHUNK = 16384       # columns a step of the plain versions
P_QUANTUM = 512           # fa rows: K8's 8 cluster slices x 4 warp row groups x 16
D_PAD = 128               # the reference's widest feature layout: the
                          # kernels take every multiple of 32 up to it
X_TN = 64                 # K8 column tile (csrc); K8 holds p_pad <= 4096
E_TN = 128                # K7 width quantum (its 256-column units clip the last)
MP_MAX = 64               # widest V a K9 / K10 launch holds
C_TN = 256                # K9 / K10 column tile (csrc), both layouts
# K7 columns a launch: the kb buffer of one superblock is (p_pad, GRAM_SUPER)
# bf16, 1.07 GB at p_pad 4096, so the gc64 gram at 8 MP (131072 sampled
# columns) stays one launch and gram_coarse = 1 (8.4M columns) does not
# need a 68.7 GB buffer
GRAM_SUPER = 131072
_F32 = torch.float32


def _r(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype``, carried in f32."""
    return x.to(dtype).to(_F32)


def _tile_plain(a: torch.Tensor, bt: torch.Tensor, aug: bool) -> torch.Tensor:
    """(p, c) kernel tile in the layout dtype from (p, dp), (dp, c)."""
    dtype = a.dtype
    af, bf = a.to(_F32), bt.to(_F32)
    if aug:
        d2 = torch.clamp(af @ bf, min=0.0)
    else:
        cross = af @ bf
        na = torch.sum(af * af, dim=1)
        nb = torch.sum(bf * bf, dim=0)
        d2 = torch.clamp(na[:, None] + nb[None, :] - 2.0 * cross, min=0.0)
    if dtype == torch.bfloat16:
        return torch.exp(-_r(d2, dtype)).to(dtype)
    return torch.exp(-d2)


# --- plain versions -------------------------------------------------------

def kb_strip_plain(fa, f_t, cols, aug: bool = False, live=None):
    """(p_pad, dp), (dp, S), (S,) -> (p_pad, S) in fa's dtype. ``live``
    (the kernel's lane count) changes no step here."""
    dtype = fa.dtype
    out = torch.empty((fa.shape[0], f_t.shape[1]), dtype=dtype,
                      device=fa.device)
    for sl in _chunks(f_t.shape[1], PLAIN_CHUNK):
        kb = _tile_plain(fa, f_t[:, sl], aug).to(_F32)
        out[:, sl] = (kb * _r(cols[sl], dtype)[None, :]).to(dtype)
    return out


def ext2_matvec_plain(fa, f_t, t2, bm, aug: bool = False, live=None):
    """-> (u (p_pad,) f32, s (n,) f32)."""
    dtype = fa.dtype
    t2r = _r(t2, dtype)
    u = torch.zeros(fa.shape[0], dtype=_F32, device=fa.device)
    s = torch.empty(f_t.shape[1], dtype=_F32, device=fa.device)
    for sl in _chunks(f_t.shape[1], PLAIN_CHUNK):
        kb = _tile_plain(fa, f_t[:, sl], aug).to(_F32)
        kbt = t2r @ kb
        s[sl] = bm[sl].to(_F32) / torch.sqrt(
            torch.clamp(kbt[0] * kbt[1], min=FINISH_EPS))
        u = u + kb @ s[sl]
    return u, s


def _tile_colstats(af, ft, na, nb, dtype):
    """The plain-class tile of K9 / K10: the cross from the layouts' values,
    f32 norms passed in, f32 exp, then rounded to ``dtype`` (carried in
    f32)."""
    cross = af @ ft.to(_F32)
    d2 = torch.clamp(na[:, None] + nb[None, :] - 2.0 * cross, min=0.0)
    return _r(torch.exp(-d2), dtype)


def finish_colstats_plain(fa, f_t, t, s_pre, bm, gr, y, na, nb, live=None):
    """-> (V (n, m_pad) f32, norms (m_pad,), coeffs (m_pad,), s (n,))."""
    dtype = fa.dtype
    n, mp = f_t.shape[1], gr.shape[1]
    dev = fa.device
    af = fa.to(_F32)
    tr, grr = _r(t, dtype), _r(gr, dtype)
    v = torch.empty((n, mp), dtype=_F32, device=dev)
    s = torch.empty(n, dtype=_F32, device=dev)
    norms = torch.zeros(mp, dtype=_F32, device=dev)
    coeffs = torch.zeros(mp, dtype=_F32, device=dev)
    for sl in _chunks(n, PLAIN_CHUNK):
        kb = _tile_colstats(af, f_t[:, sl], na, nb[sl], dtype)
        ks = tr @ kb
        s[sl] = torch.sqrt(s_pre[sl] / torch.clamp(ks, min=FINISH_EPS)) * bm[sl]
        kbs = _r(kb * _r(s[sl], dtype)[None, :], dtype)
        vb = kbs.T @ grr
        v[sl] = vb
        norms = norms + torch.sum(vb * vb, dim=0)
        coeffs = coeffs + y[sl].to(_F32) @ vb
    return v, norms, coeffs, s


def colstats_v_plain(fa, f_t, gr, y, cols, na, nb, live=None):
    """-> (V (n, m_pad) f32, norms (m_pad,), coeffs (m_pad,))."""
    dtype = fa.dtype
    n, mp = f_t.shape[1], gr.shape[1]
    dev = fa.device
    af, grr = fa.to(_F32), _r(gr, dtype)
    v = torch.empty((n, mp), dtype=_F32, device=dev)
    norms = torch.zeros(mp, dtype=_F32, device=dev)
    coeffs = torch.zeros(mp, dtype=_F32, device=dev)
    for sl in _chunks(n, PLAIN_CHUNK):
        kb = _tile_colstats(af, f_t[:, sl], na, nb[sl], dtype)
        vb = _r(kb * _r(cols[sl], dtype)[None, :], dtype).T @ grr
        v[sl] = vb
        norms = norms + torch.sum(vb * vb, dim=0)
        coeffs = coeffs + y[sl].to(_F32) @ vb
    return v, norms, coeffs


# --- kernel wrappers --------------------------------------------------------

def _check_layout(fa, f_t, what: str, aug: bool | None) -> tuple[bool, int]:
    """Raise unless the kernels take the layout; (True for the f32 one,
    its feature depth)."""
    if fa.dtype != f_t.dtype or fa.dtype not in (torch.bfloat16, _F32):
        raise ValueError(f"{what}: fa and f_t must share a bf16 or f32 dtype, "
                         f"got {fa.dtype} and {f_t.dtype}")
    f32 = fa.dtype == _F32
    if f32 and aug:
        raise NotImplementedError(
            f"{what}: no preset builds an f32 aug layout, and no ROADMAP.md "
            f"queue ports it; the f32 kernels take the plain layout")
    if not f32 and aug is False:
        raise NotImplementedError(
            f"{what}: the CUDA kernel takes the bf16 aug layout; no preset "
            f"builds the plain bf16 one, and no ROADMAP.md queue ports it")
    fd = fa.shape[1]
    if f_t.shape[0] != fd or fd % 32 or not 0 < fd <= D_PAD:
        raise ValueError(f"{what}: the layouts take a multiple of 32 feature "
                         f"lanes up to {D_PAD}, alike in fa and f_t, got "
                         f"{fa.shape[1]} and {f_t.shape[0]}")
    if not (fa.is_contiguous() and f_t.is_contiguous()):
        raise ValueError(f"{what}: fa and f_t must be contiguous")
    if fa.shape[0] % P_QUANTUM:
        raise ValueError(f"{what}: fa rows {fa.shape[0]} must be a multiple "
                         f"of {P_QUANTUM}")
    return f32, fd


def _lanes(live, fd: int) -> int:
    """The f32 kernels' lanes on an ``fd``-lane layout: ``live`` rounded up
    to 4 (None: all fd)."""
    if live is None:
        return fd
    if not 0 < live <= fd:
        raise ValueError(f"live lanes {live} not in [1, {fd}]")
    return -(-live // 4) * 4


def coord_lanes(live, fd: int) -> int:
    """The lanes the K9 / K10 f32 kernels read for ``live`` feature lanes
    of an ``fd``-lane layout (the coordinate K5/K6 read ``_lanes``): 4 of a
    32-lane layout, else all fd (the layouts' pad lanes are zero, so the
    extra lanes add exact zeros). The 4-lane V pass takes fa rows at a 32-lane stride, so a
    wider layout is read whole."""
    return 4 if _lanes(live, fd) <= 4 and fd == 32 else fd


def _aligned(*ts):
    """The tensors with 16-byte aligned bases (TMA, cp.async and the
    vector loads take no other): a view that starts elsewhere is copied."""
    return [t if t.data_ptr() % 16 == 0 else t.clone() for t in ts]


def _check_vecs(what: str, **vecs) -> None:
    for name, (x, size) in vecs.items():
        if tuple(x.shape) != tuple(size):
            raise ValueError(f"{what}: {name} shape {tuple(x.shape)} != "
                             f"{tuple(size)}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F32).contiguous()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).contiguous()


def _clusters(p: int, fd: int, tiles: int) -> int:
    """K8's persistent grid: as many 8-block clusters as fit the card, at
    most one a column tile."""
    n = _build.lib().glt_ext2_clusters(p, fd)
    if n <= 0:
        _build.check(-n if n < 0 else 1, "ext2_matvec: no cluster fits the card")
    return min(n, tiles)


def kb_strip_cuda(fa, f_t, cols, aug: bool = False, live=None):
    """((p_pad, fd), (fd, S), (S,)) -> (p_pad, S) column-scaled tile, bf16
    (aug layout) or f32 (f32 layout, ``live`` lanes read); fd 32, 64, 96 or
    128."""
    if _device_kind(fa, f_t, cols) == "cpu":
        return kb_strip_plain(fa, f_t, cols, aug)
    f32, fd = _check_layout(fa, f_t, "kb_strip", aug)
    p, s = fa.shape[0], f_t.shape[1]
    _check_vecs("kb_strip", cols=(cols, (s,)))
    if p == 0 or s == 0 or s % E_TN:
        raise ValueError(f"kb_strip: takes a non-empty fa and a width that is "
                         f"a multiple of {E_TN}, got ({p}, {s})")
    out = torch.empty((p, s), dtype=fa.dtype, device=fa.device)
    # the f_t tiles arrive and the output leaves by TMA or vector loads,
    # which take 16-byte aligned bases
    lanes = _lanes(live, fd) if f32 else None
    fa, f_t, cb = _aligned(fa, f_t, _f32(cols) if f32 else _bf16(cols))
    lib = _build.lib()
    if f32:
        # the norms' pre-pass, then the coordinate store kernel
        # (csrc/coord_store.cu) over (p / 128 row blocks, splits)
        norms = torch.empty(p + s, dtype=_F32, device=fa.device)
        splits = store_plan(p, s, lanes, EPI_SCALED)
        rc = lib.glt_kb_strip_f32(fa.data_ptr(), f_t.data_ptr(), cb.data_ptr(),
                                  norms.data_ptr(), out.data_ptr(), p, s,
                                  lanes, fd, splits, _build.stream_ptr(fa))
    else:
        rc = lib.glt_kb_strip(fa.data_ptr(), f_t.data_ptr(), cb.data_ptr(),
                              out.data_ptr(), p, s, fd, _build.stream_ptr(fa))
    _build.check(rc, "kb_strip")
    kb_strip_cuda.launches += 1
    return out


def kb_entries(device) -> torch.Tensor:
    """K7's tile entry (``kb_pair`` in ``csrc/recompute_sweeps.cu``: kexp's
    one FMUL and one MUFU ex2 on bf16(d2)) at every one of the 65536
    bf16(d2) patterns, as bf16 bits, (65536,) int32, on the card. No path
    calls it: ``chip_smoke.py`` requires it equal to the evaluated entry
    (``cuda_matvec.aug_entries`` route 0, ``kb_aug``) at every pattern."""
    out = torch.empty(65536, dtype=torch.int16, device=device)
    _build.check(_build.lib().glt_kb_entries(out.data_ptr(),
                                             _build.stream_ptr(out)),
                 "kb_entries")
    return out.to(torch.int32) & 0xFFFF


def _gram(kb: torch.Tensor) -> torch.Tensor:
    return mm_f32(kb, kb.T) if kb.dtype == torch.bfloat16 else kb @ kb.T


def _gram_super(kb_strip, fa, f_t, cols, aug, live):
    """sum_j (c_j k_j)(c_j k_j)^T over superblocks of GRAM_SUPER columns,
    the f32 partial grams summed in column order (``gram_pallas`` loops
    superblocks of ``block`` columns; only the f32 summation order
    differs)."""
    g = None
    for sl in _chunks(f_t.shape[1], GRAM_SUPER):
        part = _gram(kb_strip(fa, f_t[:, sl].contiguous(), cols[sl], aug,
                              live))
        g = part if g is None else g + part
    return g


def gram_plain(fa, f_t, cols, aug: bool = False, live=None):
    return _gram_super(kb_strip_plain, fa, f_t, cols, aug, live)


def gram_cuda(fa, f_t, cols, aug: bool = False, live=None):
    """-> (p_pad, p_pad) f32: one K7 launch and one GEMM a superblock
    (bf16 in and f32 out, or f32 at full precision on the f32 layout)."""
    return _gram_super(kb_strip_cuda, fa, f_t, cols, aug, live)


def ext2_matvec_cuda(fa, f_t, t2, bm, aug: bool = False, live=None):
    """((p_pad, fd), (fd, n), (2, p_pad), (n,)) -> (u (p_pad,), s (n,)); fd
    32, 64, 96 or 128 on the bf16 aug layout and on the f32 one (``live``
    lanes read)."""
    if _device_kind(fa, f_t, t2, bm) == "cpu":
        return ext2_matvec_plain(fa, f_t, t2, bm, aug)
    f32, fd = _check_layout(fa, f_t, "ext2_matvec", aug)
    p, n = fa.shape[0], f_t.shape[1]
    _require_whole_p(p, "ext2_matvec")
    _check_vecs("ext2_matvec", t2=(t2, (2, p)), bm=(bm, (n,)))
    if n % X_TN:
        raise ValueError(f"ext2_matvec: n {n} must be a multiple of {X_TN}")
    if f32:
        return _ext2_matvec_f32(fa, f_t, t2, bm, _lanes(live, fd))
    dev = fa.device
    clusters = _clusters(p, fd, n // X_TN)
    t2b, bmf = _bf16(t2), _f32(bm)
    s = torch.empty(n, dtype=_F32, device=dev)
    u_part = torch.empty((clusters, p), dtype=_F32, device=dev)
    u = torch.empty(p, dtype=_F32, device=dev)
    rc = _build.lib().glt_ext2_matvec(
        fa.data_ptr(), f_t.data_ptr(), t2b.data_ptr(), bmf.data_ptr(),
        s.data_ptr(), u_part.data_ptr(), u.data_ptr(), p, n, clusters, fd,
        _build.stream_ptr(fa))
    _build.check(rc, "ext2_matvec")
    ext2_matvec_cuda.launches += 1
    return u, s


def _ext2_matvec_f32(fa, f_t, t2, bm, live):
    """K8 on the f32 layout: the norms' pre-pass, then clusters of p_pad /
    512 blocks (p_pad / 256 at 128 lanes) over 64-column tiles (128 at 128
    lanes, the last one masked where n % 128 == 64)."""
    (p, fd), n = fa.shape, f_t.shape[1]
    dev = fa.device
    lib = _build.lib()
    clusters = lib.glt_ext2_f32_clusters(p, fd, n)
    if clusters <= 0:
        _build.check(-clusters if clusters < 0 else 1,
                     "ext2_matvec: no cluster fits the card")
    fa, f_t, t2f, bmf = _aligned(fa.contiguous(), f_t.contiguous(),
                                 _f32(t2), _f32(bm))
    s = torch.empty(n, dtype=_F32, device=dev)
    u_part = torch.empty((clusters, p), dtype=_F32, device=dev)
    u = torch.empty(p, dtype=_F32, device=dev)
    norms = torch.empty(p + n, dtype=_F32, device=dev)
    rc = lib.glt_ext2_matvec_f32(
        fa.data_ptr(), f_t.data_ptr(), t2f.data_ptr(), bmf.data_ptr(),
        s.data_ptr(), u_part.data_ptr(), u.data_ptr(), norms.data_ptr(), p, n,
        clusters, live, fd, _build.stream_ptr(fa))
    _build.check(rc, "ext2_matvec")
    ext2_matvec_cuda.launches += 1
    return u, s


def finish_colstats_cuda(fa, f_t, t, s_pre, bm, gr, y, na, nb, live=None):
    """((p_pad, fd) plain, (fd, n) aug superset, (p_pad,), (n,), (n,),
    (p_pad, m_pad), (n,), (p_pad,), (n,)) -> (V (n, m_pad), norms (m_pad,),
    coeffs (m_pad,), s (n,)), all f32. A gr wider than MP_MAX runs one
    launch per MP_MAX columns, each recomputing the tile: the first sweeps
    p for ks and s, the others take bf16(s) from it, so s is computed
    once. Any p_pad that is a multiple of P_QUANTUM: no column needs the
    whole p in one block. fd is 32, 64, 96 or 128, on the bf16 layout or
    on the f32 one (f32 fa and f_t, ``live`` lanes read), where every
    operand stays f32."""
    if _device_kind(fa, f_t, t, s_pre, bm, gr, y, na, nb) == "cpu":
        return finish_colstats_plain(fa, f_t, t, s_pre, bm, gr, y, na, nb)
    f32, fd = _check_layout(fa, f_t, "finish_colstats", None)
    p, n = fa.shape[0], f_t.shape[1]
    mp = gr.shape[1]
    _check_vecs("finish_colstats", t=(t, (p,)), s_pre=(s_pre, (n,)),
                bm=(bm, (n,)), gr=(gr, (p, mp)), y=(y, (n,)), na=(na, (p,)),
                nb=(nb, (n,)))
    _check_v_shapes("finish_colstats", mp, n)
    y, na, nb = (_f32(x) for x in (y, na, nb))
    if f32:
        return _colstats_f32(fa, f_t, gr, y, na, nb, coord_lanes(live, fd),
                             finish=(_f32(t), _f32(s_pre), _f32(bm)))
    finish = (_bf16(t), _f32(s_pre), _f32(bm))
    grts = [_bf16(gr[:, m0:m0 + MP_MAX].T) for m0 in range(0, mp, MP_MAX)]
    v, norms, coeffs, s, cb = _v_launch(fa, f_t, grts[0], y, na, nb,
                                        finish=finish)
    finish_colstats_cuda.launches += 1
    outs = [(v, norms, coeffs)]
    for grt in grts[1:]:     # s once: the other V column blocks scale by it
        outs.append(_v_launch(fa, f_t, grt, y, na, nb, cb=cb)[:3])
        finish_colstats_cuda.launches += 1
    if len(outs) == 1:
        return v, norms, coeffs, s
    v, norms, coeffs = zip(*outs)
    return torch.cat(v, dim=1), torch.cat(norms), torch.cat(coeffs), s


def _check_v_shapes(what: str, mp: int, n: int) -> None:
    if mp % 16 or not 16 <= mp <= 2 * MP_MAX:
        raise ValueError(f"{what}: gr width {mp} must be a multiple of 16 in "
                         f"[16, {2 * MP_MAX}]")
    if n % C_TN:
        raise ValueError(f"{what}: n {n} must be a multiple of {C_TN}")


def colstats_v_cuda(fa, f_t, gr, y, cols, na, nb, live=None):
    """((p_pad, fd) plain, (fd, n) aug superset, (p_pad, m_pad) f32, (n,),
    (n,), (p_pad,), (n,)) -> (V (n, m_pad), norms (m_pad,), coeffs
    (m_pad,)), all f32. ``cols`` must be 0 on padding columns. A gr wider
    than MP_MAX runs one launch per MP_MAX columns (each recomputes the
    tile). fd is 32, 64, 96 or 128, on the bf16 layout or on the f32 one,
    where every operand stays f32 (``live`` lanes read)."""
    if _device_kind(fa, f_t, gr, y, cols, na, nb) == "cpu":
        return colstats_v_plain(fa, f_t, gr, y, cols, na, nb)
    f32, fd = _check_layout(fa, f_t, "colstats_v", None)
    p, n = fa.shape[0], f_t.shape[1]
    mp = gr.shape[1]
    _check_vecs("colstats_v", gr=(gr, (p, mp)), y=(y, (n,)),
                cols=(cols, (n,)), na=(na, (p,)), nb=(nb, (n,)))
    _check_v_shapes("colstats_v", mp, n)
    y, na, nb = (_f32(x) for x in (y, na, nb))
    if f32:
        return _colstats_f32(fa, f_t, gr, y, na, nb, coord_lanes(live, fd),
                             cols=_f32(cols))[:3]
    cb = _bf16(cols)
    outs = []
    for m0 in range(0, mp, MP_MAX):
        outs.append(_v_launch(fa, f_t, _bf16(gr[:, m0:m0 + MP_MAX].T), y, na,
                              nb, cb=cb)[:3])
        colstats_v_cuda.launches += 1
    if len(outs) == 1:
        return outs[0]
    v, norms, coeffs = zip(*outs)
    return torch.cat(v, dim=1), torch.cat(norms), torch.cat(coeffs)


def _v_launch(fa, f_t, grt, y, na, nb, cb=None, finish=None):
    """One launch of the V pass (``csrc/colstats_v.cu``) for a bf16(gr)^T
    block of at most MP_MAX rows: K10's with the column scale ``cb`` =
    bf16(c), or K9's with ``finish`` = (bf16(t), s_pre, bm), whose ks pass
    first sweeps p for s and bf16(s). -> (V, norms, coeffs, s, bf16(s)),
    the last two None for K10."""
    w, p = grt.shape
    fd, n = f_t.shape
    ks = finish is not None
    what = "finish_colstats" if ks else "colstats_v"
    lib = _build.lib()
    blocks = lib.glt_colstats_v_blocks(w, fd)
    if blocks <= 0:
        _build.check(-blocks if blocks < 0 else 1,
                     f"{what}: no block fits the card")
    blocks = min(blocks, n // C_TN)
    dev = fa.device
    v = torch.empty((n, w), dtype=_F32, device=dev)
    part = torch.empty((blocks, 2, w), dtype=_F32, device=dev)
    nc = torch.empty((2, w), dtype=_F32, device=dev)
    ptrs = [fa.data_ptr(), f_t.data_ptr(), grt.data_ptr()]
    vecs = [y.data_ptr(), na.data_ptr(), nb.data_ptr(), v.data_ptr()]
    tail = [part.data_ptr(), nc.data_ptr(), p, n, w, fd, blocks,
            _build.stream_ptr(fa)]
    s = None
    if ks:
        s = torch.empty(n, dtype=_F32, device=dev)
        cb = torch.empty(n, dtype=torch.bfloat16, device=dev)
        rc = lib.glt_finish_colstats(*ptrs, *[x.data_ptr() for x in finish],
                                     *vecs, s.data_ptr(), cb.data_ptr(), *tail)
    else:
        rc = lib.glt_colstats_v(*ptrs, cb.data_ptr(), *vecs, *tail)
        cb = None
    _build.check(rc, what)
    return v, nc[0], nc[1], s, cb


def _colstats_f32(fa, f_t, gr, y, na, nb, lv, cols=None, finish=None):
    """K10 (column scale ``cols``) or K9 (``finish`` = (t, s_pre, bm)) on the
    f32 layout, reading ``lv`` lanes (``coord_lanes``): one launch per
    MP_MAX columns of gr, each padded with zero columns to MP_MAX (the f32
    kernel is that wide). K9's first launch forms each tile entry once for
    ks (t as one more column of gr), s and V; the other launches are K10's
    with c = s. Each launch first splits its gr block (and K9's t) into
    three bf16 parts, into scratch made here. -> (V, norms, coeffs, s), s
    None for K10."""
    p, (fd, n) = fa.shape[0], f_t.shape
    mp = gr.shape[1]
    dev = fa.device
    lib = _build.lib()
    fa, f_t = _aligned(fa.contiguous(), f_t.contiguous())
    scratch = torch.empty(lib.glt_colstats_f32_scratch_bytes(p, fd, 1),
                          dtype=torch.uint8, device=dev)
    s = None
    outs = []
    for m0 in range(0, mp, MP_MAX):
        w = min(MP_MAX, mp - m0)
        ks = finish is not None and s is None
        what = "finish_colstats" if finish is not None else "colstats_v"
        blocks = lib.glt_colstats_f32_blocks(lv, int(ks))
        if blocks <= 0:
            _build.check(-blocks if blocks < 0 else 1,
                         f"{what}: no block fits the card")
        blocks = min(blocks, n // C_TN)
        g = torch.zeros((p, MP_MAX), dtype=_F32, device=dev)
        g[:, :w] = gr[:, m0:m0 + w]
        v = torch.empty((n, MP_MAX), dtype=_F32, device=dev)
        part = torch.empty((blocks, 2, MP_MAX), dtype=_F32, device=dev)
        nc = torch.empty((2, MP_MAX), dtype=_F32, device=dev)
        head = (fa.data_ptr(), f_t.data_ptr(), g.data_ptr())
        vecs = (y.data_ptr(), na.data_ptr(), nb.data_ptr(), v.data_ptr())
        tail = (part.data_ptr(), nc.data_ptr(), scratch.data_ptr(), p, n,
                lv, blocks, _build.stream_ptr(fa))
        if ks:
            s = torch.empty(n, dtype=_F32, device=dev)
            rc = lib.glt_finish_colstats_f32(
                *head, *(x.data_ptr() for x in finish), *vecs, s.data_ptr(),
                *tail)
        else:
            c = cols if s is None else s
            rc = lib.glt_colstats_v_f32(*head, c.data_ptr(), *vecs, *tail)
        _build.check(rc, what)
        (colstats_v_cuda if finish is None
         else finish_colstats_cuda).launches += 1
        outs.append((v[:, :w], nc[0, :w], nc[1, :w]))
    if len(outs) == 1:
        v, norms, coeffs = outs[0]
    else:
        v, norms, coeffs = (torch.cat(x, dim=x[0].dim() - 1)
                            for x in zip(*outs))
    return v.contiguous(), norms.contiguous(), coeffs.contiguous(), s


kb_strip_cuda.launches = 0
ext2_matvec_cuda.launches = 0
finish_colstats_cuda.launches = 0
colstats_v_cuda.launches = 0


def kexp_bf16_plain(d2):
    """bf16(exp(-max(d2, 0))) with torch's f32 exp: the K9 / K10 tile entry
    before its column scale, for f32 d2 of any shape."""
    return torch.exp(-torch.clamp(d2, min=0.0)).to(torch.bfloat16)


def kexp_bf16_cuda(d2):
    """The same entry with the exp K9 and K10 use on the card (``kexp`` in
    ``csrc/colstats_v.cu``: one FMUL by -log2(e), one MUFU ex2). No path
    calls it: ``chip_smoke.py`` counts the entries whose bf16 value differs
    from the plain version's."""
    if _device_kind(d2) == "cpu":
        return kexp_bf16_plain(d2)
    d2 = _f32(d2)
    out = torch.empty(d2.shape, dtype=torch.bfloat16, device=d2.device)
    rc = _build.lib().glt_kexp_bf16(d2.data_ptr(), out.data_ptr(), d2.numel(),
                                    _build.stream_ptr(d2))
    _build.check(rc, "kexp_bf16")
    return out
