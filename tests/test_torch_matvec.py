"""The recompute matvec route of graphlap_tpu_torch (config 3 sharpen, the
8 MP matvec denoise) against graphlap_tpu: the K5/K6 plain versions against
``matvec_pallas`` / ``rmatvec_pallas`` (interpret mode on the CPU, as
tests/test_pallas.py runs them), ``rmatvec2``, the ``ktilde_apply`` closure,
``_normalize_streaming``'s scales, the operator filters, and the whole
filter on gray and per-channel RGB images; the aug kernel's entry table
(bf16(d2) clamped to its live patterns, then looked up), emulated, against
the plain tile bit for bit and against the Pallas kernels, and its launch
plan. On a CUDA card only (marker ``gpu``): K5/K6 against their plain
versions, two launches on the same inputs bit for bit, and the layout
guard. Each at an NLM 5 x 5 patch's feature width (25, the 32-lane
kernels) and a 7 x 7 one's (49, the 64-lane kernels).

Tolerances, relative to the largest reference magnitude unless stated:
* K5/K6, f32 plain layout: 1e-5 — the same f32 tile values, summed in
  another order (tests/test_pallas.py's f32 class for these kernels); the
  f32 kernel's split-fp16 cross against the f32 cross within L 2^-19 of
  2^(Ea + Eb) over its L lanes (32 or 64), plus an f32 ulp of the norms
  (tests/test_torch_kernels.py's bar for K1, whose cross is the same).
* K5/K6, bf16 aug layout: 1e-3 — a d2 that differs in its last f32 bits can
  round to the other bf16 neighbour and move one tile entry by one bf16 ulp
  (2^-8 relative); over hundreds of summed entries that is far below 1e-3,
  which leaves room for the f32 order (tests/test_pallas.py's bf16 class is
  1e-2).
* rmatvec2, ktilde_apply, scales: 2e-5 (f32) and 5e-3 (bf16), the bars of
  tests/test_torch_recompute.py's streaming operators; the scales after the
  coarse loop, the extension and the polish: 1e-4 (f32), 2e-2 (bf16).
* Whole filter: <= 0.05 dB and atol 2e-2 (bf16 tiles), <= 0.02 dB and atol
  2e-3 (f32) — PERF.md section 2, the reference's fused-vs-unfused bars.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.ops import cuda_matvec as k56
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_strip as k24
from graphlap_tpu_torch.ops import filters as tfl
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.ops import streaming as tst
from graphlap_tpu_torch.utils import interop

REL = {"float32": 1e-5, "bfloat16": 1e-3}
OP_REL = {"float32": 2e-5, "bfloat16": 5e-3}
SCALE_REL = {"float32": 1e-4, "bfloat16": 2e-2}
BARS = {"bfloat16": (0.05, 2e-2), "float32": (0.02, 2e-3)}
WRAPPERS = (k56.matvec_cuda, k56.rmatvec_cuda)
ALL_WRAPPERS = WRAPPERS + (k1.affinity_strip_cuda, k24.strip_ext2_cuda,
                           k24.strip_sandwich_spost_cuda,
                           k24.strip_sandwich_cuda, k79.kb_strip_cuda,
                           k79.ext2_matvec_cuda, k79.finish_colstats_cuda,
                           k79.colstats_v_cuda)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at module level: the
    card's machine has no JAX, so there these comparisons skip and the gpu
    tests of this file still collect and run."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import graphlap_tpu as gl
    from graphlap_tpu.config import PipelineConfig as JaxConfig
    from graphlap_tpu.models import streaming as jms
    from graphlap_tpu.ops import filters as jfl
    from graphlap_tpu.ops import pallas_streaming as pst
    from graphlap_tpu.ops import streaming as jst
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, jms=jms, jfl=jfl, pst=pst,
                           jst=jst, cfg=lambda c: JaxConfig(**c.to_dict()))


def T(x, dtype=None):
    t = torch.tensor(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


def N(x):
    """A jax or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def assert_rel(got, ref, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _counts():
    return [w.launches for w in ALL_WRAPPERS]

# the padded feature lanes of each case's d: an NLM 5 x 5, 7 x 7, 9 x 9 and
# 11 x 11 patch (the aug layout adds lanes: 25 -> 31, 49 -> 55, 81 -> 87,
# 121 -> 127, padded alike)
LANES = {25: 32, 49: 64, 81: 96, 121: 128}


# --- K5 / K6 plain versions against the Pallas kernels -----------------------

def _layouts(jx, dtype, p, n, seed=5, d=25):
    """The reference's own pads (aug for bf16, plain for f32) and positive
    vectors (scales and pixels, as the path feeds them)."""
    jnp, pst = jx.jnp, jx.pst
    rng = np.random.default_rng(seed)
    fa = rng.normal(0, 0.3, (p, d)).astype(np.float32)
    fp = rng.normal(0, 0.3, (n, d)).astype(np.float32)
    _, p_pad = pst.p_tiling(p)
    tn = pst._tile_n(jnp.dtype(dtype))
    n_pad = -(-n // tn) * tn
    aug = dtype == "bfloat16"
    if aug:
        fa_l, f_t = pst.aug_pads(jnp.asarray(fa), jnp.asarray(fp), n_pad)
    else:
        fa_l = jnp.zeros((p_pad, pst.d_pad_of(d)), jnp.float32).at[:p, :d].set(fa)
        f_t = jnp.zeros((pst.d_pad_of(d), n_pad), jnp.float32).at[:d, :n].set(fp.T)
    v = np.zeros(n_pad, np.float32)
    v[:n] = rng.uniform(0.5, 1.5, n)
    t = np.zeros(p_pad, np.float32)
    t[:p] = rng.uniform(0.5, 1.5, p)
    td = getattr(torch, dtype)
    return SimpleNamespace(fa=fa_l, f_t=f_t, v=v, t=t, aug=aug, p=p, n=n,
                           tfa=T(N(fa_l), td), tft=T(N(f_t), td))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p,n,d", [(277, 2000, 25), (4100, 1000, 25),
                                   (277, 2000, 49), (4100, 1000, 49),
                                   (277, 1000, 81), (277, 1000, 121)],
                         ids=["277-2000", "4100-1000", "277-2000-7x7",
                              "4100-1000-7x7", "277-1000-9x9",
                              "277-1000-11x11"])
def test_k5_k6_plain_match_pallas(jx, dtype, p, n, d):
    """p = 4100 pads to 5120: two reference p tiles of 2560 (_tile_p_of).
    d 49 (a 7 x 7 patch): 64 lanes, the aug layout's 55 padded to 64; d 81
    and 121 (9 x 9, 11 x 11): 96 and 128 lanes (aug 87 and 127)."""
    jnp, pst = jx.jnp, jx.pst
    x = _layouts(jx, dtype, p, n, d=d)
    assert x.tfa.shape[1] == LANES[d]
    if p > rl.MAX_TILE_P:
        assert rl._tile_p_of(x.fa.shape[0]) < x.fa.shape[0]
    mv_r = pst.matvec_pallas(x.fa, x.f_t, jnp.asarray(x.v), aug=x.aug)
    mv = k56.matvec_plain(x.tfa, x.tft, T(x.v), x.aug)
    assert_rel(N(mv)[:p], N(mv_r)[:p], REL[dtype])
    rmv_r = pst.rmatvec_pallas(x.fa, x.f_t, jnp.asarray(x.t), aug=x.aug)
    rmv = k56.rmatvec_plain(x.tfa, x.tft, T(x.t), x.aug)
    assert rmv.shape == (x.f_t.shape[1],)
    assert_rel(N(rmv)[:n], N(rmv_r)[:n], REL[dtype])


def _split2(x):
    """(M, L) f32 feature vectors -> (scale 2^E, big, small) as the f32
    kernel splits them (csrc/recompute_matvec.cu split2): x' = x 2^-E, E
    the exponent of the vector's largest |x_k| (< 2^E); big = x' on the grid
    2^-10; small = fp16(x' - big)."""
    m = np.abs(x).max(axis=1, keepdims=True).astype(np.float32)
    e = np.clip(((m.view(np.int32) >> 23) & 0xFF) - 126, -100, 100)
    xs = (x * np.ldexp(np.float32(1), -e)).astype(np.float32)
    big = (np.rint(xs * np.float32(1024)) / np.float32(1024)).astype(np.float32)
    assert np.array_equal(big.astype(np.float16).astype(np.float32), big)
    small = (xs - big).astype(np.float16).astype(np.float32)
    return np.ldexp(np.float64(1), e), big, small


def _join_steps(steps):
    """The f32 kernel's join of its k16 big.big steps (join_steps in
    csrc/recompute_matvec.cu), in f32: (h0 + h1) at 32 lanes, + (h2 + h3)
    at 64, + (h4 + h5) at 96, + ((h4 + h5) + (h6 + h7)) at 128."""
    big = steps[0] + steps[1]
    if len(steps) >= 4:
        big = big + (steps[2] + steps[3])
    if len(steps) == 6:
        big = big + (steps[4] + steps[5])
    if len(steps) == 8:
        big = big + ((steps[4] + steps[5]) + (steps[6] + steps[7]))
    return big


def _tc_cross(a, b):
    """The f32 kernel's cross of feature rows a (P, L) and b (C, L), L 32,
    64, 96 or 128 lanes, at its rounding points: each k16 step's big.big sum
    exact (asserted), the steps joined in f32 (``_join_steps``), then
    big.small + small.big (f32) added, small.small dropped, then scaled back
    by 2^(Ea + Eb)."""
    (sa, ab, as_), (sb, bb, bs) = _split2(a), _split2(b)
    f64, f32 = np.float64, np.float32
    steps = [ab[:, k:k + 16].astype(f64) @ bb[:, k:k + 16].astype(f64).T
             for k in range(0, a.shape[1], 16)]
    for hh in steps:                   # a sum of 16 big products is exact
        assert np.array_equal(hh.astype(f32).astype(f64), hh)
    big = _join_steps([hh.astype(f32) for hh in steps])
    corr = (ab.astype(f64) @ bs.astype(f64).T
            + as_.astype(f64) @ bb.astype(f64).T).astype(f32)
    cross = big + corr
    return (cross * (sa * sb.T)).astype(f32)     # exact: powers of 2


def _tc_tile(a, b):
    """The f32 kernel's tile exp(-max((na + nb) - 2 cross, 0)): the cross
    of ``_tc_cross``, norms as sequential f32 sums, d2 rounded once."""
    def norms(x):
        s = np.zeros(x.shape[0], np.float32)
        for k in range(x.shape[1]):
            s = (s + x[:, k] * x[:, k]).astype(np.float32)
        return s

    nn = norms(a)[:, None] + norms(b)[None, :]
    d2 = np.maximum((nn.astype(np.float64)
                     - 2.0 * _tc_cross(a, b).astype(np.float64))
                    .astype(np.float32), np.float32(0))
    return np.exp(-d2).astype(np.float32)


@pytest.mark.parametrize("p,n,d", [(277, 2000, 25), (4100, 1000, 25),
                                   (277, 2000, 49), (4100, 1000, 49),
                                   (277, 1000, 81), (277, 1000, 121)],
                         ids=["277-2000", "4100-1000", "277-2000-7x7",
                              "4100-1000-7x7", "277-1000-9x9",
                              "277-1000-11x11"])
def test_k5_k6_split_fp16_scheme_matches_pallas(jx, p, n, d):
    """The f32 kernel's split fp16 cross, emulated in numpy at its rounding
    points, holds the reference's f32 matvec_pallas / rmatvec_pallas
    (interpret mode) to REL["float32"]: the split scheme is inside the bar
    before any card runs it, over 32, 64, 96 and 128 lanes."""
    jnp, pst = jx.jnp, jx.pst
    x = _layouts(jx, "float32", p, n, d=d)
    tile = _tc_tile(N(x.fa), N(x.f_t).T)
    mv = tile @ x.v.astype(np.float32)
    rmv = x.t.astype(np.float32) @ tile
    mv_r = pst.matvec_pallas(x.fa, x.f_t, jnp.asarray(x.v), aug=False)
    rmv_r = pst.rmatvec_pallas(x.fa, x.f_t, jnp.asarray(x.t), aug=False)
    assert_rel(mv[:p], N(mv_r)[:p], REL["float32"])
    assert_rel(rmv[:n], N(rmv_r)[:n], REL["float32"])


@pytest.mark.parametrize("patch,h,w,kernel_h", [
    (5, 96, 96, 0.1),           # the 8 MP matvec denoise's h: 32 lanes
    (7, 96, 96, 0.1),           # at 7 x 7: 49 lanes, the 64-lane kernel
    (7, 256, 512, 0.1),         # 7 x 7 on a larger frame
], ids=["5x5-96", "7x7-96", "7x7-256x512"])
def test_k5_k6_split_fp16_cross_holds_the_f32_cross(patch, h, w, kernel_h):
    """The f32 kernel's cross, emulated (``_tc_cross``), on NLM features of
    the 8 MP matvec denoise's recipe (h 0.1) against the f32 cross, in d2.
    The bound, re-derived from the lane count L (32, or 64 past 32
    features) as K1's (tests/test_torch_kernels.py: its cross is the same
    split): the dropped small.small terms (L 2^-22 of 2^(Ea + Eb)), the
    fp16 rounding of the smalls (2 L 2^-22) and the f32 rounding of the
    plain cross (L 2^-24), 3.25 L 2^-22 in all, doubled in d2, are under L
    2^-19 2^(Ea + Eb) (2^-14 at 32 lanes, 2^-13 at 64); d2's own rounding
    adds an f32 ulp of na + nb."""
    from graphlap_tpu_torch.ops import affinity as taff

    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(h, w), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    cfg = PipelineConfig(kernel="nlm", h=kernel_h, patch_size=patch)
    f = taff.extract_features(T(img), cfg).numpy()
    lanes = rl.d_pad_of(f.shape[1])
    assert lanes == (64 if patch == 7 else 32)
    rng = np.random.default_rng(0)
    f = np.pad(f, ((0, 0), (0, lanes - f.shape[1])))
    a = f[rng.choice(f.shape[0], 200, replace=False)]
    b = f[rng.choice(f.shape[0], min(f.shape[0], 8192), replace=False)]
    sa, sb = _split2(a)[0], _split2(b)[0]
    f64 = np.float64
    nn = ((a.astype(f64) ** 2).sum(1)[:, None]
          + (b.astype(f64) ** 2).sum(1)[None, :])
    d2 = nn - 2.0 * _tc_cross(a, b).astype(f64)
    d2_plain = nn - 2.0 * (a @ b.T).astype(np.float32).astype(f64)
    bar = lanes * 2.0 ** -19 * (sa * sb.T) + 2.0 ** -22 * nn
    assert bool((np.abs(d2 - d2_plain) <= bar).all())


def test_streamed_axis_splits_fill_one_wave(monkeypatch):
    """Splits come from the kernel's resident slots (the occupancy the
    compiled kernel has), not from an assumed blocks-an-SM: the 8 MP f32 K5
    (32 fixed blocks, 65536 streamed tiles) on 396 slots splits 12 ways,
    384 blocks in one wave; a fixed side that fills the card does not
    split; no split is empty."""
    from graphlap_tpu_torch.ops import _build

    slots = {0: 396, 1: 264}
    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(
        glt_recompute_slots=lambda aug, fd: slots[aug]))
    assert k56._splits(False, 32, 65536, 32) == 12
    assert k56._splits(False, 65536, 32, 32) == 1
    assert k56._splits(True, 16, 8192, 32) == 16
    assert k56._splits(False, 66, 10, 32) == 5        # 6 asked, 2 tiles each
    assert k56._splits(False, 1, 3, 32) == 3
    slots[0] = -2
    with pytest.raises(RuntimeError, match="cudaError 2"):
        k56._splits(False, 32, 65536, 32)


def test_matvec_routing_quanta_match(jx):
    jnp, pst = jx.jnp, jx.pst
    assert rl.MATVEC_TN_CAP == pst.MATVEC_TN_CAP
    for p in (1, 277, 4096, 4100, 8192, 9000):
        p_pad = rl.p_tiling(p)[1]
        assert rl._tile_p_of(p_pad) == pst._tile_p_of(p_pad)
    assert rl._tile_p_of(5120) == 2560
    for n_pad in (1024, 3072, 10240, 1 << 20, 8388608, 256 * 33):
        for dt in ("bfloat16", "float32"):
            if n_pad % rl._tile_n(getattr(torch, dt)):
                continue
            for cap in (1024, rl.MATVEC_TN_CAP):
                assert rl._pick_tn(n_pad, getattr(torch, dt), cap) == (
                    pst._pick_tn(n_pad, jnp.dtype(dt), cap))


# --- the aug kernel's entry table, emulated ------------------------------------

_BF = torch.bfloat16


def _entry_plain(d2):
    """The plain route's aug entry of f32 d2 (``_tile_plain``'s epilogue):
    bf16(exp(-bf16(max(d2, 0))))."""
    return torch.exp(-k79._r(torch.clamp(d2, min=0.0), _BF)).to(_BF)


def _patterns(x):
    """bf16 bit patterns (int32, 0..65535) as the f32 values they hold."""
    return (x.to(torch.int32) << 16).view(torch.float32)


# the live bf16(d2) patterns: at or below LIVE_LO (and every negative one) the
# entry is 1.0, at or above LIVE_HI 0 (chip_smoke.py reads the same edges off
# the card's kb_aug; scripts/matvec_designs.py's clamped tables rely on them)
LIVE_LO, LIVE_HI = 0x3B00, 0x42BA


def _table():
    """The kernel's table, built by the plain entry function: the entry's
    bf16 bits at every one of the 65536 bf16(d2) patterns."""
    x = torch.arange(65536, dtype=torch.int32)
    return _entry_plain(_patterns(x)).view(torch.int16).to(torch.int32) & 0xFFFF


def _lookup(d2):
    """The aug kernel's entry route, emulated: bf16(max(d2, 0))'s bits (the
    kernel rounds with relu) index the table -> bf16 entries."""
    bits = torch.clamp(d2, min=0.0).to(_BF).view(torch.int16).to(torch.int32) & 0xFFFF
    return _table()[bits].to(torch.int16).view(_BF)


def _tile_lookup(a, bt, aug):
    """``_tile_plain`` of the aug layout with the entry from the table."""
    assert aug and a.dtype == _BF
    return _lookup(a.float() @ bt.float())


@pytest.mark.parametrize("p,n", [(277, 2000), (4100, 1000)])
def test_aug_entry_lookup_matches_tile_plain_bit_for_bit(jx, p, n):
    """On the reference's own aug_pads layouts, the table route gives the
    plain tile's every entry bit for bit (d2 both times the same f32
    product, so only the entry route differs)."""
    x = _layouts(jx, "bfloat16", p, n)
    got = _tile_lookup(x.tfa, x.tft, True)
    ref = k79._tile_plain(x.tfa, x.tft, True)
    assert got.dtype == ref.dtype == _BF
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("p,n,d", [(277, 2000, 25), (4100, 1000, 25),
                                   (277, 2000, 49), (4100, 1000, 49)],
                         ids=["277-2000", "4100-1000", "277-2000-7x7",
                              "4100-1000-7x7"])
def test_aug_entry_lookup_through_k5_k6_matches_pallas(jx, monkeypatch, p, n,
                                                       d):
    """K5/K6's plain versions with their tile entries from the table hold
    the reference's matvec_pallas / rmatvec_pallas (interpret mode) to the
    aug bar, REL["bfloat16"], at 32 lanes and at 64 (d 49: 55 aug lanes)."""
    jnp, pst = jx.jnp, jx.pst
    x = _layouts(jx, "bfloat16", p, n, d=d)
    monkeypatch.setattr(k56, "_tile_plain", _tile_lookup)
    mv = k56.matvec_plain(x.tfa, x.tft, T(x.v), True)
    rmv = k56.rmatvec_plain(x.tfa, x.tft, T(x.t), True)
    mv_r = pst.matvec_pallas(x.fa, x.f_t, jnp.asarray(x.v), aug=True)
    rmv_r = pst.rmatvec_pallas(x.fa, x.f_t, jnp.asarray(x.t), aug=True)
    assert_rel(N(mv)[:p], N(mv_r)[:p], REL["bfloat16"])
    assert_rel(N(rmv)[:n], N(rmv_r)[:n], REL["bfloat16"])


def test_aug_entry_table_edges():
    """Every pattern at or below LIVE_LO (as a non-negative value) has entry
    1.0, every one at or above LIVE_HI (through +inf) 0, every negative one
    (sign bit set, -0 included) 1.0; inside, the entry is neither. So a
    table of the live patterns only, with bf16(d2) clamped as signed 16-bit
    values to [LIVE_LO, LIVE_HI], gives the plain entry at every non-NaN
    pattern of the 65536, as the full table does."""
    x = torch.arange(65536, dtype=torch.int32)
    e = _table()
    one, lo, hi, inf = 0x3F80, LIVE_LO, LIVE_HI, 0x7F80
    assert bool((e[:lo + 1] == one).all())
    assert bool((e[hi:inf + 1] == 0).all())
    assert bool((e[0x8000:0xFF81] == one).all())
    live = e[lo + 1:hi]
    assert bool(((live != one) & (live != 0)).all())
    signed = torch.where(x >= 0x8000, x - 0x10000, x)
    clamped = e[torch.clamp(signed, lo, hi)]
    keep = ~torch.isnan(_patterns(x))
    assert torch.equal(clamped[keep], e[keep])
    d2 = _patterns(x)[keep]
    got = _lookup(d2).view(torch.int16).to(torch.int32) & 0xFFFF
    assert torch.equal(got, e[keep])


def _plan_lib(monkeypatch, slots):
    """The kernel library's slots query, stubbed: {(aug, fd): slots}."""
    from graphlap_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(
        glt_recompute_slots=lambda aug, fd: slots[aug, fd]))


def test_aug_launch_plan_serves_every_wrapper_shape(monkeypatch):
    """The aug kernel's plan takes every shape the wrappers pass (p_pad on
    512, n on 256; K5 fixes p_pad and streams n, K6 the reverse), at 32,
    64, 96 and 128 lanes: whole streamed stages (256 entries, 128 at 96
    lanes), no empty split, ceil(lf / 1024) fixed slices at
    32 lanes, ceil(lf / 512) at 64 and 96 and lf / 256 at 128 (a last one
    part full: lf is a multiple of 256, a warp's 64, 32 or 16 rows all in
    or all out), and at most one persistent block a resident slot and a
    work item. Config 3: K5 4 slices by 33 splits on all 132 blocks; K6
    1024 slices, unsplit, on all 132; at 7 x 7 K5 8 slices by 16 splits, at
    11 x 11 16 slices by 8."""
    _plan_lib(monkeypatch, {(1, 32): 132, (0, 32): 528, (1, 64): 132,
                            (0, 64): 264, (1, 96): 132, (0, 96): 132,
                            (1, 128): 132, (0, 128): 132})
    bf = torch.bfloat16
    for fd, fixed_tile, stream_tile in ((32, 1024, 256), (64, 512, 256),
                                        (96, 512, 128), (128, 256, 256)):
        key = (bf, fd)
        assert k56.FIXED_TILE[key] == fixed_tile
        assert k56.STREAM_TILE[key] == stream_tile
        for pp in (512, 1024, 4096, 5120, 8192):
            for n in (256, 768, 1024, 2560, 1 << 20, 8388608):
                for lf, ls in ((pp, n), (n, pp)):
                    assert ls % k56.STREAM_TILE[key] == 0 and lf % 256 == 0
                    tiles = ls // k56.STREAM_TILE[key]
                    fixed = -(-lf // k56.FIXED_TILE[key])
                    splits, blocks = k56._plan(True, lf, ls, fd)
                    per = -(-tiles // splits)
                    assert 1 <= splits <= tiles and per * (splits - 1) < tiles
                    assert 1 <= blocks <= min(132, fixed * splits)
    assert k56._plan(True, 4096, 1 << 20, 32) == (33, 132)
    assert k56._plan(True, 1 << 20, 4096, 32) == (1, 132)
    assert k56._plan(True, 4096, 1 << 20, 64) == (16, 128)
    assert k56._plan(True, 4096, 1 << 20, 128) == (8, 128)
    assert k56._plan(False, 4096, 8388608, 128)[0] == 4  # 132 // 32
    assert k56._plan(False, 4096, 8388608, 32)[0] == 16  # f32: 528 // 32
    assert k56._plan(False, 4096, 8388608, 64)[0] == 8   # 264 // 32


def test_k5_k6_round_their_vector_to_the_layout_dtype():
    """v (K5) and t (K6) round to bf16 before the tile products, as the
    reference's wrappers do: a vector and its bf16 rounding give the
    identical result."""
    fa, f_t, _, _ = _small()
    rng = np.random.default_rng(2)
    v = T(rng.uniform(0.5, 1.5, f_t.shape[1]))
    t = T(rng.uniform(0.5, 1.5, fa.shape[0]))
    for x in (v, t):
        assert not torch.equal(x, x.to(torch.bfloat16).float())
    assert torch.equal(k56.matvec_plain(fa, f_t, v, True),
                       k56.matvec_plain(fa, f_t, v.to(torch.bfloat16).float(),
                                        True))
    assert torch.equal(k56.rmatvec_plain(fa, f_t, t, True),
                       k56.rmatvec_plain(fa, f_t, t.to(torch.bfloat16).float(),
                                         True))


# --- rmatvec2, the ktilde_apply closure, the normalization --------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmatvec2_matches(jx, dtype):
    jnp, jst = jx.jnp, jx.jst
    rng = np.random.default_rng(4)
    p, n, d = 64, 1024, 25
    fa = rng.normal(0, 0.3, (p, d)).astype(np.float32)
    fp = rng.normal(0, 0.3, (n, d)).astype(np.float32)
    t2 = rng.uniform(0.5, 1.5, (p, 2)).astype(np.float32)
    cs = (rng.random(n) > 0.2).astype(np.float32)
    ref = jst.rmatvec2(jnp.asarray(fa), jnp.asarray(fp), jnp.asarray(t2),
                       jnp.asarray(cs), 256, jnp.dtype(dtype))
    got = tst.rmatvec2(T(fa), T(fp), T(t2), T(cs), 256, getattr(torch, dtype))
    assert_rel(N(got), N(ref), OP_REL[dtype])
    # any chunk: each column sums over p only
    wide = tst.rmatvec2(T(fa), T(fp), T(t2), T(cs), 1000, getattr(torch, dtype))
    assert_rel(N(wide), N(got), 1e-6)


def _cfg(**kw):
    cfg = dict(kernel="nlm", h=0.15, sample_rho=0.03, num_eigvecs=16,
               sinkhorn_iters=4, streaming=True, block_cols=2048,
               use_pallas=True, sinkhorn_coarse=4, sinkhorn_polish=1,
               filter_name="sharpen", filter_param=0.15, filter_mode="matvec",
               affinity_dtype="bfloat16")
    cfg.update(kw)
    return PipelineConfig(**cfg)


@pytest.fixture(scope="module")
def img_noisy():
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return img, noisy.astype(np.float32)


@pytest.fixture(scope="module")
def contexts(jx, img_noisy):
    """Both packages' recompute contexts on the 96x96 image, per dtype."""
    _, noisy = img_noisy
    out = {}
    for dt in ("bfloat16", "float32"):
        cfg = _cfg(affinity_dtype=dt)
        plan = gt.make_plan(noisy, cfg)
        jcfg = jx.cfg(cfg)
        jctx = jx.jms._strip_ctx(jx.jnp.asarray(noisy),
                                 jx.jnp.asarray(plan.idx_a), jcfg)
        tctx = tms._strip_ctx(T(noisy), interop.idx_to_device(plan.idx_a,
                                                              "cpu"), cfg)
        out[dt] = (cfg, jcfg, jctx, tctx)
    return out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ktilde_apply_matches(jx, contexts, dtype):
    cfg, _, jctx, tctx = contexts[dtype]
    assert (tctx.fa_aug is not None) == (dtype == "bfloat16")
    np.testing.assert_array_equal(N(tctx.valid), N(jctx.valid))
    rng = np.random.default_rng(8)
    s = rng.uniform(0.5, 1.5, tctx.n_pad).astype(np.float32) * N(tctx.valid)
    ref = jctx.ktilde_apply(jx.jnp.asarray(s))
    got = tms.ktilde_apply(tctx, T(s))
    assert_rel(N(got), N(ref), OP_REL[dtype])
    # the strip products alone
    u_r = jctx.strip_matvec(jx.jnp.asarray(s) * jctx.b_mask)
    assert_rel(N(tms.strip_matvec(tctx, T(s) * tctx.b_mask)), N(u_r),
               OP_REL[dtype])


@pytest.mark.parametrize("kw", [
    dict(),                                            # coarse + extension + polish
    dict(sinkhorn_coarse=1, sinkhorn_iters=3),         # full resolution
    dict(normalization="symmetric"),
    dict(normalization="none"),
    dict(sinkhorn_polish=2),
], ids=["coarse_polish", "full", "symmetric", "none", "polish2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normalize_streaming_scales_match(jx, img_noisy, contexts, dtype, kw):
    cfg0, _, jctx, tctx = contexts[dtype]
    cfg = cfg0.replace(**kw)
    ref = jx.jms._normalize_streaming(jctx, jx.cfg(cfg))
    got = tms._normalize_streaming(tctx, cfg)
    assert got.shape == (tctx.n_pad,)
    assert float(got[tctx.n:].abs().max()) == 0.0       # zero on padding
    assert_rel(N(got), N(ref), SCALE_REL[dtype])


# --- the operator filters ------------------------------------------------------

def _sym_operator(n=60, seed=3):
    """A symmetric operator with spectrum in [0, 1] (a doubly-stochastic W's
    range) and its numpy matvec."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.sort(rng.uniform(0.0, 1.0, n))[::-1]
    m = (q * lam) @ q.T
    return m, rng.normal(size=n)


@pytest.mark.parametrize("name,param", [
    ("identity", 1.0), ("power", 2.0), ("power", 3.0), ("sharpen", 0.15),
    ("twicing", 2.0)])
@pytest.mark.parametrize("mode,degree", [("matvec", 12), ("chebyshev", 12),
                                         ("chebyshev", 0)])
def test_operator_filter_matches(jx, name, param, mode, degree):
    assert name in tfl.MATVEC_FILTERS
    m, y = _sym_operator()
    ref = jx.jfl.apply_operator_filter(lambda x: m @ x, y, name, param, mode,
                                       degree)
    got = tfl.apply_operator_filter(lambda x: m @ x, y, name, param, mode,
                                    degree)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    # on torch tensors through a torch matvec: the same up to f64 order
    mt = torch.tensor(m)
    got_t = tfl.apply_operator_filter(lambda x: mt @ x, torch.tensor(y),
                                      name, param, mode, degree)
    np.testing.assert_allclose(got_t.numpy(), ref, rtol=1e-10, atol=1e-10)


def test_chebyshev_helpers_match(jx):
    for name, param in (("exp_decay", 2.0), ("power", 2.5), ("sharpen", 0.3),
                        ("twicing", 1.5)):
        np.testing.assert_allclose(tfl.chebyshev_coeffs(name, param, 20),
                                   jx.jfl.chebyshev_coeffs(name, param, 20),
                                   rtol=0, atol=1e-14)
        assert (tfl.chebyshev_auto_degree(name, param)
                == jx.jfl.chebyshev_auto_degree(name, param))
        assert tfl.chebyshev_tail_bound(name, param, 8) == pytest.approx(
            jx.jfl.chebyshev_tail_bound(name, param, 8), rel=1e-12)
    assert tfl.CHEBYSHEV_FILTERS == jx.jfl.CHEBYSHEV_FILTERS
    assert tfl.MATVEC_FILTERS == jx.jfl.MATVEC_FILTERS


@pytest.mark.parametrize("name,param", [("lowpass", 1.0), ("exp_decay", 1.0),
                                        ("power", 2.5), ("twicing", 0.0)])
def test_matvec_filter_refuses_non_polynomials(name, param):
    with pytest.raises(ValueError, match="filter_mode='matvec'"):
        tfl.apply_matvec_filter(lambda x: x, np.ones(3), name, param)
    with pytest.raises(ValueError, match="lowpass"):
        tfl.apply_chebyshev_filter(lambda x: x, np.ones(3), "lowpass", 1.0, 4)


# --- the whole filter ------------------------------------------------------------

SLICE_CASES = {
    "gray_sharpen_bf16": dict(),
    "gray_identity_bf16": dict(filter_name="identity", filter_param=1.0,
                               h=0.1),
    "gray_identity_f32": dict(filter_name="identity", filter_param=1.0,
                              h=0.1, affinity_dtype="float32"),
    # the recipes at an NLM 7 x 7 patch: the aug layout's 55 lanes and the
    # f32 layout's 49, each padded to 64
    "gray_sharpen_bf16_p7": dict(patch_size=7),
    "gray_identity_f32_p7": dict(filter_name="identity", filter_param=1.0,
                                 h=0.1, affinity_dtype="float32",
                                 patch_size=7),
}


@pytest.fixture(scope="module")
def rgb_noisy():
    img = gt.make_test_image(48, 48, channels=3)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.03, seed=3), 0, 1)
    return img, noisy.astype(np.float32)


def _rgb_cfg():
    """Config 3's routed recipe (tuned_config of CONFIG3 at 1024^2) at 48^2:
    bf16 aug tiles, coarse Sinkhorn 1/4 + one polish, sharpen 0.15, per
    channel."""
    full = gt.tuned_config(gt.CONFIG3.replace(streaming=True,
                                              block_cols=131072),
                           1024 * 1024, "fast")
    return full.replace(sample_rho=0.05, block_cols=1152, sinkhorn_coarse=4)


@pytest.mark.parametrize("case", sorted(SLICE_CASES) + ["rgb_sharpen_bf16"])
def test_slice_matches_reference(jx, img_noisy, rgb_noisy, case):
    if case.startswith("rgb"):
        img, noisy = rgb_noisy
        cfg = _rgb_cfg()
        assert (cfg.rgb_mode, cfg.filter_mode, cfg.affinity_dtype) == (
            "per_channel", "matvec", "bfloat16")
    else:
        img, noisy = img_noisy
        cfg = _cfg(**SLICE_CASES[case])
    plan = gt.make_plan(noisy, cfg)
    before = _counts()
    res = gt.filter_image(noisy, cfg, plan=plan, device="cpu")
    assert _counts() == before                       # no launch on the CPU
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    db, atol = BARS["float32" if "_f32" in case else "bfloat16"]
    assert res.image.shape == ref.image.shape == noisy.shape
    assert np.isfinite(res.image).all()
    assert res.eigvals.shape == np.asarray(ref.eigvals).shape
    np.testing.assert_allclose(res.image, ref.image, atol=atol)
    d = abs(gt.psnr(img, res.image) - gt.psnr(img, ref.image))
    assert d <= db, f"port vs reference PSNR delta {d:.5f} dB"


def test_config3_sharpen_enhances(rgb_noisy):
    """The reference's config-3 quality bars (tests/test_quality.py), on the
    port at 48^2: a real detail boost, structure kept."""
    img, noisy = rgb_noisy
    res = gt.filter_image(noisy, _rgb_cfg(), device="cpu")

    def ge(a):
        return float((np.diff(a, axis=0) ** 2).sum()
                     + (np.diff(a, axis=1) ** 2).sum())

    assert ge(res.image) / ge(img) > ge(noisy) / ge(img) + 0.05
    assert gt.ssim(img, res.image) > 0.75
    assert gt.psnr(img, res.image) > gt.psnr(img, noisy) - 3.0


def test_recipes_route_to_the_matvec_layouts():
    """Both recipes of the slice, built as the reference's benchmarks build
    them, reach the operator route on the layouts the kernels take."""
    c3 = gt.tuned_config(gt.CONFIG3.replace(streaming=True, block_cols=131072),
                         1024 * 1024, "fast")
    base = PipelineConfig(kernel="nlm", h=0.25, sample_rho=0.01,
                          sample_cap=4096, num_eigvecs=50, sinkhorn_iters=10,
                          filter_name="identity", streaming=True,
                          block_cols=131072, affinity_dtype="bfloat16")
    c4 = gt.tuned_config(gt.denoise_tuned(base, 0.1), 2048 * 4096, "fast")
    for cfg, dtype, k in ((c3, "bfloat16", 8), (c4, "float32", 64)):
        assert cfg.operator_filter() and cfg.use_pallas and cfg.streaming
        assert not (cfg.strip_cache or cfg.fused_finish)
        assert cfg.affinity_dtype == dtype and cfg.feature_dtype == "float32"
        assert (cfg.sinkhorn_coarse, cfg.sinkhorn_polish) == (k, 1)
        tms.check_slice(cfg)
    assert c3.filter_name == "sharpen" and c4.filter_name == "identity"


# --- dispatch and guards ----------------------------------------------------------

def _small(dtype=torch.bfloat16, aug=True):
    rng = np.random.default_rng(9)
    fa = T(rng.normal(0, 0.3, (100, 25)))
    fp = T(rng.normal(0, 0.3, (1000, 25)))
    if aug:
        fa_l, f_t = rl.aug_pads(fa, fp, 1024)
    else:
        fa_l = torch.zeros((512, 32), dtype=dtype)
        fa_l[:100, :25] = fa.to(dtype)
        f_t = torch.zeros((32, 1024), dtype=dtype)
        f_t[:25, :1000] = fp.T.to(dtype)
    return fa_l, f_t, torch.ones(1024), torch.ones(fa_l.shape[0])


@pytest.mark.parametrize("layout", ["aug", "f32", "plain_bf16"])
def test_cpu_tensors_take_the_plain_versions_without_a_launch(layout):
    """Every layout, the plain bf16 one included, runs plain on the CPU."""
    dtype = torch.float32 if layout == "f32" else torch.bfloat16
    aug = layout == "aug"
    fa, f_t, v, t = _small(dtype, aug)
    before = _counts()
    assert torch.equal(k56.matvec_cuda(fa, f_t, v, aug),
                       k56.matvec_plain(fa, f_t, v, aug))
    assert torch.equal(k56.rmatvec_cuda(fa, f_t, t, aug),
                       k56.rmatvec_plain(fa, f_t, t, aug))
    assert _counts() == before


def test_cuda_branch_raises_instead_of_falling_back(monkeypatch):
    """Where the kernel cannot run, the CUDA branch raises: unsupported
    layouts and shapes before any launch, and no path returns the plain
    version's result for a CUDA tensor."""
    from graphlap_tpu_torch.ops import _build

    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k56, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    before = _counts()
    fa, f_t, v, t = _small()
    with pytest.raises(RuntimeError, match="unavailable"):
        k56.matvec_cuda(fa, f_t, v, True)
    with pytest.raises(RuntimeError, match="unavailable"):
        k56.rmatvec_cuda(fa, f_t, t, True)
    fa, f_t, v, t = _small(torch.bfloat16, aug=False)
    for fn, x in ((k56.matvec_cuda, v), (k56.rmatvec_cuda, t)):
        with pytest.raises(NotImplementedError,
                           match="no ROADMAP.md queue ports it"):
            fn(fa, f_t, x, False)
    fa32, ft32 = fa.float(), f_t.float()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k56.matvec_cuda(fa32, ft32, v, True)
    with pytest.raises(ValueError, match="multiple of 512"):
        k56.matvec_cuda(fa32[:256], ft32, v, False)
    with pytest.raises(ValueError, match="n 896 of 256"):
        k56.matvec_cuda(fa, f_t[:, :896], v[:896], True)
    with pytest.raises(ValueError, match="shape"):
        k56.rmatvec_cuda(fa32, ft32, v, False)
    assert _counts() == before


@pytest.mark.parametrize("layout", ["plain_bf16", "f32_aug"])
def test_unported_layouts_say_no_queue_ports_them(monkeypatch, layout):
    """The plain bf16 layout (only GLT_AUG_DISABLE reaches it) and an f32
    aug layout (no preset builds one) raise NotImplementedError saying that
    no ROADMAP.md queue ports them, as K7-K10's guard says
    (ops/cuda_recompute._check_layout), before any launch."""
    monkeypatch.setattr(k56, "_device_kind", lambda *ts: "cuda")
    fa, f_t, v, t = _small(torch.bfloat16, aug=False)
    aug = layout == "f32_aug"
    if aug:
        fa, f_t = fa.float(), f_t.float()
    name = "f32 aug" if aug else "plain bf16"
    before = _counts()
    for fn, x, what in ((k56.matvec_cuda, v, "matvec"),
                        (k56.rmatvec_cuda, t, "rmatvec")):
        with pytest.raises(NotImplementedError) as err:
            fn(fa, f_t, x, aug)
        msg = str(err.value)
        assert msg.startswith(f"{what}: ")
        assert f"no preset builds the {name} layout" in msg
        assert msg.endswith("and no ROADMAP.md queue ports it")
        assert "Queue 2" not in msg
    assert _counts() == before


def test_lib_path_follows_the_shared_header(monkeypatch, tmp_path):
    """csrc/*.cuh is compiled into every source that includes it, so an
    edit there names a new library (a rebuild), though only *.cu compile."""
    from graphlap_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources()] == ["k.cu"]
    first = _build.lib_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.lib_path() != first


def test_wrappers_refuse_devices_they_cannot_serve():
    fa, f_t, v, t = _small()
    meta = torch.empty(fa.shape, dtype=fa.dtype, device="meta")
    with pytest.raises(ValueError, match="device"):
        k56.matvec_cuda(meta, f_t, v, True)
    with pytest.raises(ValueError, match="device"):
        k56.rmatvec_cuda(meta, f_t, t, True)


@pytest.mark.parametrize("kw,item", [
    (dict(strip_cache=True), "M3 / M7"),
    (dict(use_pallas=False), "M6"),
    (dict(feature_dtype="bfloat16"), "M6"),
])
def test_operator_route_outside_the_slice_raises(img_noisy, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        gt.filter_image(img_noisy[1], _cfg(**kw), device="cpu")


def test_strip_cache_context_normalization_raises(img_noisy):
    """A strip_cache context serves the unfused normalization's products
    from the strip (GEMMs, no recomputed tiles and no K5/K6 launch), while
    the operator filters on strip_cache still raise before any work."""
    cfg = _cfg(strip_cache=True, affinity_dtype="bfloat16_store")
    noisy = img_noisy[1]
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(T(noisy), interop.idx_to_device(plan.idx_a, "cpu"),
                         cfg)
    assert ctx.strip is not None
    before = _counts()
    s = tms._normalize_streaming(ctx, cfg)
    assert _counts() == before
    assert s.shape == (ctx.n_pad,) and bool(torch.isfinite(s).all())
    assert float(s[ctx.n:].abs().max()) == 0.0 and float(s[:ctx.n].min()) > 0
    # the polish's completion matvec is the strip's: K~ s from two GEMMs
    ks = tms.ktilde_apply(ctx, s)
    b = ctx.b_mask
    t = s[ctx.idx_a] + ctx.kaa_solve(tms._strip_dot(ctx.strip, s * b))
    torch.testing.assert_close(ks * b, tms._strip_dot_t(ctx.strip, t) * b)
    with pytest.raises(NotImplementedError, match="M3 / M7"):
        gt.filter_image(noisy, cfg, device="cpu")


def test_luma_basis_rgb_raises(rgb_noisy):
    with pytest.raises(NotImplementedError, match="M7"):
        gt.filter_image(rgb_noisy[1], _rgb_cfg().replace(rgb_mode="luma_basis"),
                        device="cpu")


def test_filter_image_without_cuda_raises(rgb_noisy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    before = _counts()
    with pytest.raises((RuntimeError, AssertionError)):
        gt.filter_image(rgb_noisy[1], _rgb_cfg())
    assert _counts() == before


# --- on the card: kernel against plain version ----------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _card_layouts(dev, p, n, d, aug, seed):
    """Layouts on the card for normal(0, 0.3) features of d lanes: the aug
    pads, or the plain f32 layout of d_pad_of(d) lanes."""
    rng = np.random.default_rng(seed)
    fa = torch.tensor(rng.normal(0, 0.3, (p, d)).astype(np.float32), device=dev)
    fp = torch.tensor(rng.normal(0, 0.3, (n, d)).astype(np.float32), device=dev)
    if aug:
        fa_l, f_t = rl.aug_pads(fa, fp, n)
    else:
        _, p_pad = rl.p_tiling(p)
        dp = rl.d_pad_of(d)
        fa_l = torch.zeros((p_pad, dp), device=dev)
        fa_l[:p, :d] = fa
        f_t = torch.zeros((dp, n), device=dev)
        f_t[:d] = fp.T
    assert fa_l.shape[1] == f_t.shape[0] == LANES[d]
    return fa_l, f_t, rng


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p,n,d", [(277, 10240, 25), (4100, 16384, 25),
                                   (277, 10240, 49), (4100, 16384, 49),
                                   (4100, 16384, 81), (4100, 16384, 121)],
                         ids=["277-10240", "4100-16384", "277-10240-7x7",
                              "4100-16384-7x7", "4100-16384-9x9",
                              "4100-16384-11x11"])
def test_k5_k6_kernels_match_plain(cuda_device, dtype, p, n, d):
    """Card kernels against their plain versions on the card, at 32 lanes
    and at 64, 96 and 128 (d 49, 81, 121: a 7 x 7, 9 x 9, 11 x 11 patch);
    p = 4100 pads to 5120 (two reference p tiles). There the aug layout's
    outputs are also held against the f64 sums of the same bf16 entries
    and bf16 vector: their share below in (0.25, 0.75) (the w product's
    mma put K6's columns below on 0.88 of config 3's at 32 and 64 lanes)."""
    dev = cuda_device
    aug = dtype == "bfloat16"
    fa_l, f_t, rng = _card_layouts(dev, p, n, d, aug, seed=p)
    v = torch.tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    t = torch.zeros(fa_l.shape[0], device=dev)
    t[:p] = torch.tensor(rng.uniform(0.5, 1.5, p).astype(np.float32), device=dev)
    before = [w.launches for w in WRAPPERS]
    mv = k56.matvec_cuda(fa_l, f_t, v, aug)
    rmv = k56.rmatvec_cuda(fa_l, f_t, t, aug)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(WRAPPERS, before)] == [1, 1]
    mv_p = k56.matvec_plain(fa_l, f_t, v, aug)
    rmv_p = k56.rmatvec_plain(fa_l, f_t, t, aug)
    assert _rel_err(mv[:p], mv_p[:p]) <= REL[dtype]
    assert _rel_err(rmv, rmv_p) <= REL[dtype]
    if p > 4096:
        # neither layout leans: the tensor core's accumulation truncates,
        # so a sum carried in it would put nearly every output below its
        # plain version (the outputs are all positive)
        for got, ref in ((mv[:p], mv_p[:p]), (rmv, rmv_p)):
            below = float((got < ref).float().mean())
            assert 0.05 < below < 0.95, below
        if aug:
            k = k79._tile_plain(fa_l, f_t, True).double()
            for got, ref in ((mv[:p], (k @ v.bfloat16().double())[:p]),
                             (rmv, t.bfloat16().double() @ k)):
                below = float((got.double() < ref).float().mean())
                assert 0.25 < below < 0.75, below
            del k
    # deterministic: no float atomics
    assert torch.equal(mv, k56.matvec_cuda(fa_l, f_t, v, aug))
    assert torch.equal(rmv, k56.rmatvec_cuda(fa_l, f_t, t, aug))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [("bfloat16", 25), ("float32", 25),
                                     ("bfloat16", 49), ("float32", 49),
                                     ("bfloat16", 81), ("float32", 81),
                                     ("bfloat16", 121), ("float32", 121)],
                         ids=["bfloat16", "float32", "bfloat16-7x7",
                              "float32-7x7", "bfloat16-9x9", "float32-9x9",
                              "bfloat16-11x11", "float32-11x11"])
def test_k5_k6_repeat_bit_for_bit(cuda_device, dtype, d):
    """Two launches of each wrapper on the same inputs agree bit for bit at
    a shape whose streamed axis splits (K5: 8 fixed slices of 4096 samples,
    262144 columns) and whose fixed side needs many items (K6): the
    per-split partials go through the fixed-order reduction, no float
    atomics; at 32, 64, 96 and 128 lanes."""
    dev = cuda_device
    p, n = 4096, 262144
    aug = dtype == "bfloat16"
    fa_l, f_t, rng = _card_layouts(dev, p, n, d, aug, seed=11)
    v = torch.tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    t = torch.tensor(rng.uniform(0.5, 1.5, p).astype(np.float32), device=dev)
    for fn, x in ((k56.matvec_cuda, v), (k56.rmatvec_cuda, t)):
        first = fn(fa_l, f_t, x, aug)
        assert bool(torch.isfinite(first).all())
        assert torch.equal(first, fn(fa_l, f_t, x, aug))


@pytest.mark.gpu
def test_plain_bf16_layout_raises_on_cuda(cuda_device):
    fa, f_t, v, t = (x.to(cuda_device) for x in _small(torch.bfloat16, False))
    before = [w.launches for w in WRAPPERS]
    with pytest.raises(NotImplementedError, match="no ROADMAP.md queue"):
        k56.matvec_cuda(fa, f_t, v, False)
    with pytest.raises(NotImplementedError, match="no ROADMAP.md queue"):
        k56.rmatvec_cuda(fa, f_t, t, False)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.gpu
def test_rgb_sharpen_on_card_matches_cpu_plain(cuda_device, rgb_noisy):
    img, noisy = rgb_noisy
    cfg = _rgb_cfg()
    before = [w.launches for w in WRAPPERS]
    z_gpu = gt.filter_image(noisy, cfg, device=cuda_device).image
    assert [w.launches - b for w, b in zip(WRAPPERS, before)] == [6, 6]
    z_cpu = gt.filter_image(noisy, cfg, device="cpu").image
    np.testing.assert_allclose(z_gpu, z_cpu, atol=2e-2)
    assert abs(gt.psnr(img, z_gpu) - gt.psnr(img, z_cpu)) <= 0.05
