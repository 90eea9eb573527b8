"""K1 — the fused strip emitter (port of
``graphlap_tpu/ops/pallas_affinity.py:affinity_strip_pallas``).

``affinity_strip_cuda`` computes the K strip (p, N) = exp(-|f_Ai - f_j|^2)
with the distance cross and the exp in one kernel, so the f32 distance
matrix never reaches device memory (``csrc/affinity_strip.cu``: the cross
at the reference's "highest" precision as a split-fp16 tensor-core product,
as the f32 K5/K6 form it; the bf16 entry's exp one MUFU ex2, the f32 one
IEEE expf; each 128 x 128 tile staged in shared memory and written by TMA).
The inputs round to ``dtype`` first and the norms come from those rounded
values, as in the Pallas body; ``store_dtype`` narrows only the stored
strip (the bfloat16_store policy). The split cross takes up to ``D_PAD``
feature lanes, the reference's widest layout, in four instantiations of
the kernel: 32 lanes (NLM patches up to 5 x 5), 64 (a 7 x 7 patch, 49
lanes), 96 (9 x 9, 81) and 128 (11 x 11, 121), both stores. Features that
carry coordinates (``coords``: the config's ``spatial_h > 0``) take an
IEEE f32 cross instead (an FFMA chain over d rounded up to 4 lanes, read at
run time: 4 for a gaussian, 28, 52, 84 or 124 for an NLM 5 x 5 to 11 x 11
patch and the coordinates), both stores, in the register-tiled store
kernel it shares with the f32 K7 (``csrc/coord_store.cu``, after a
pre-pass that lays the features out as K7's layouts lie): (row, col) /
spatial_h reach |f|^2 ~ 3e5 at 8 MP, where the split's fp16 small part
loses about four times the f32 product's error.

Dispatch: tensors on the CPU take ``affinity_strip_plain`` (the same
arithmetic in PyTorch ops); CUDA tensors launch the kernel; anything else
raises. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

import functools

import torch

from . import _build

D_PAD = 128              # the reference's widest feature layout (csrc FD 32,
                         # 64, 96, 128)
# row pitch of the kernel's output where N is ragged
ROW_BYTES = 256
STORE_ROWS = 128         # the coordinate store kernel's rows a block (csrc CS_FT)
STORE_COLS = 128         # and columns a tile (CS_ST)
STORE_KC = 32            # lanes a column stage holds at most (CS_KC)
STORE_TPS = 4            # and column tiles (CS_TPS)
# its epilogues (csrc CS_BF16, CS_F32, CS_SCALED): K1's two stores, the f32 K7
EPI_BF16, EPI_F32, EPI_SCALED = 0, 1, 2
# column chunk of the plain version: its f64 exp of a whole dense-path
# strip (5243 x 256901) would hold some 38 GB of transients
PLAIN_CHUNK = 65536


def _device_kind(*ts: torch.Tensor) -> str:
    """'cpu' or 'cuda' when every tensor lies there; raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return "cuda"
    raise ValueError(f"tensors on {sorted(str(t.device) for t in ts)}: the "
                     f"kernels take all-CPU (plain version) or one CUDA device")


def _out_dtype(store_dtype) -> torch.dtype:
    out = torch.float32 if store_dtype is None else store_dtype
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f"store_dtype must be None, float32 or bfloat16, "
                         f"got {store_dtype}")
    return out


@functools.lru_cache(maxsize=None)
def _waves_plan(blocks: int, groups: int, slots: int) -> int:
    """The column splits (none empty) that finish ``blocks`` row blocks of
    ``groups`` column groups soonest on ``slots`` resident blocks, counting
    whole waves of blocks of equal walks, each walk its groups plus one for
    staging its rows."""
    best = None
    for want in range(1, groups + 1):
        per = -(-groups // want)
        splits = -(-groups // per)
        cost = -(-blocks * splits // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def store_groups(cols: int, lanes: int) -> int:
    """The column groups of the coordinate store kernel's walk: its tiles
    of ``STORE_COLS`` columns, as many a group as one stage holds (up to
    ``STORE_TPS`` at ``STORE_KC`` lanes or fewer, else one)."""
    tiles = -(-cols // STORE_COLS)
    tps = min(STORE_TPS, STORE_KC // lanes) if lanes <= STORE_KC else 1
    return -(-tiles // tps)


def store_plan(rows: int, cols: int, lanes: int, epi: int) -> int:
    """Column splits of a coordinate store launch (``csrc/coord_store.cu``)
    over ``rows`` sample rows and ``cols`` columns at ``lanes`` lanes with
    epilogue ``epi``: whole waves of the kernel's resident blocks
    (``glt_coord_store_slots``) where they fit, else the fewest waves."""
    slots = _build.lib().glt_coord_store_slots(epi, lanes)
    if slots <= 0:
        _build.check(-slots if slots < 0 else 1,
                     "coord store: no block fits the card")
    return _waves_plan(-(-rows // STORE_ROWS), store_groups(cols, lanes),
                       slots)


def coord_scratch_floats(p: int, n: int, d: int) -> int:
    """Floats of K1's coordinate scratch: the pre-pass's rows (p_pad, L)
    and pixels (L, n_pad), then their norms, L = d rounded up to 4, p_pad
    and n_pad p and n rounded up to the store kernel's 128."""
    lanes = -(-d // 4) * 4
    p_pad = -(-p // STORE_ROWS) * STORE_ROWS
    n_pad = -(-n // STORE_COLS) * STORE_COLS
    return (p_pad + n_pad) * (lanes + 1)


def affinity_strip_plain(feats_a: torch.Tensor, feats_all: torch.Tensor,
                         dtype: torch.dtype = torch.float32,
                         store_dtype: torch.dtype | None = None,
                         coords: bool = False) -> torch.Tensor:
    """PyTorch version of K1 with the kernel's rounding points, in column
    chunks of ``PLAIN_CHUNK`` (each entry is computed alone, so the chunks
    change no value). The f32 entry is exp(-d2) rounded once to f32, the
    exp taken in f64: on the CPU the first f32 ``torch.exp`` of a process
    put a span of some 3600 entries up to 7.3e-5 off in about 2% of
    processes (the next call on the same input was right to 3e-8), while
    an f64 exp is right far below an f32 ulp. ``coords`` (the kernel's
    cross on coordinate features) changes no step here: the f32 product is
    the reference's."""
    a = feats_a.to(dtype).to(torch.float32)
    b = feats_all.to(dtype).to(torch.float32)
    na = torch.sum(a * a, dim=1)
    nb = torch.sum(b * b, dim=1)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=_out_dtype(store_dtype),
                      device=a.device)
    for j in range(0, b.shape[0], PLAIN_CHUNK):
        sl = slice(j, j + PLAIN_CHUNK)
        d2 = torch.clamp(na[:, None] + nb[None, sl] - 2.0 * (a @ b[sl].T),
                         min=0.0)
        out[:, sl] = torch.exp(-d2.to(torch.float64)).to(torch.float32)
    return out


def affinity_strip_cuda(feats_a: torch.Tensor, feats_all: torch.Tensor,
                        dtype: torch.dtype = torch.float32,
                        store_dtype: torch.dtype | None = None,
                        coords: bool = False) -> torch.Tensor:
    """K strip (p, N) = exp(-|f_Ai - f_j|^2) from (p, d) and (N, d)
    features. CPU tensors: the plain version; CUDA tensors: the kernel (its
    IEEE f32 cross where ``coords``), whose result is a view with its row
    stride padded to ``ROW_BYTES`` where a row of N entries is not a
    multiple of it."""
    if _device_kind(feats_a, feats_all) == "cpu":
        return affinity_strip_plain(feats_a, feats_all, dtype, store_dtype,
                                    coords)
    out_dtype = _out_dtype(store_dtype)
    p, d = feats_a.shape
    n, d2 = feats_all.shape
    if d2 != d:
        raise ValueError(f"feature dims differ: {d} vs {d2}")
    if not 0 < d <= D_PAD or p == 0 or n == 0:
        raise ValueError(f"affinity_strip: the kernel takes 1..{D_PAD} "
                         f"feature lanes and non-empty operands, got ({p}, "
                         f"{d}) x ({n}, {d2})")
    a = feats_a.to(dtype).to(torch.float32).contiguous()
    b = feats_all.to(dtype).to(torch.float32).contiguous()
    lib = _build.lib()
    # the TMA store needs rows 16 bytes apart, and stores fast only to rows
    # aligned to whole 128-byte lines (on an H100 at 5243 x 256901, rows
    # 16 bytes apart took 2.8 ms a bf16 store, rows 256 bytes apart 1.16):
    # a ragged N is written into rows padded to ROW_BYTES and returned as
    # the (p, n) view over them (torch's products take the row stride as
    # their leading dimension; a copy out would cost a second strip and its
    # round trip)
    per = ROW_BYTES // out_dtype.itemsize
    ld = -(-n // per) * per
    out = torch.empty((p, ld), dtype=out_dtype, device=feats_a.device)
    bf16_out = int(out_dtype == torch.bfloat16)
    if coords:
        scratch = torch.empty(coord_scratch_floats(p, n, d),
                              dtype=torch.float32, device=feats_a.device)
        splits = store_plan(p, n, -(-d // 4) * 4,
                            EPI_BF16 if bf16_out else EPI_F32)
        rc = lib.glt_affinity_coord(a.data_ptr(), b.data_ptr(),
                                    scratch.data_ptr(), out.data_ptr(), p, n,
                                    d, ld, bf16_out, splits,
                                    _build.stream_ptr(a))
    else:
        scratch = torch.empty(lib.glt_affinity_scratch_bytes(p, d),
                              dtype=torch.uint8, device=feats_a.device)
        rc = lib.glt_affinity_strip(
            a.data_ptr(), b.data_ptr(), scratch.data_ptr(), out.data_ptr(), p,
            n, d, ld, bf16_out, _build.stream_ptr(a))
    _build.check(rc, "affinity_strip")
    affinity_strip_cuda.launches += 1
    return out[:, :n] if ld != n else out


affinity_strip_cuda.launches = 0
