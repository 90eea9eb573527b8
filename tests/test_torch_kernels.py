"""K1-K4 of graphlap_tpu_torch: the plain PyTorch versions against the JAX
package's Pallas wrappers (interpret mode on the CPU, the reference's own
CPU route), the wrappers' device dispatch, and — on a CUDA card only
(marker ``gpu``) — each hand-written kernel against its plain version.

Tolerances, relative to the largest reference magnitude:
* f32 outputs: 1e-5 — the same arithmetic summed in another order.
* bf16-stored strips: one bf16 ulp (2^-8 below 1.0), where an f32 value
  sits on a rounding boundary.
* sandwich outputs (K3/K4) on a bf16 strip: 2e-3 — ws is re-rounded to
  bf16 inside the sweep, so a sum that lands on the other side of a
  rounding boundary moves one ws entry by 2^-8 relative.
* the kernels on an f32 strip (card only): 1e-4 — f32 sums of up to 65536
  terms in another order, with no rounding point to flip.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.ops import _build
from graphlap_tpu_torch.ops import affinity as taff
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_strip as k24

BF16_ULP = 2.0 ** -8
REL_F32 = 1e-5
REL_SANDWICH_BF16 = 2e-3
WRAPPERS = (k1.affinity_strip_cuda, k24.strip_ext2_cuda,
            k24.strip_sandwich_spost_cuda, k24.strip_sandwich_cuda)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at module level: the
    card's machine has no JAX, so there these comparisons skip and the gpu
    tests of this file still collect and run."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from graphlap_tpu.ops import pallas_affinity as pa
    from graphlap_tpu.ops import pallas_streaming as ps
    return SimpleNamespace(jnp=jnp, affinity=pa.affinity_strip_pallas,
                           ext2=ps.strip_ext2_pallas,
                           spost=ps.strip_sandwich_spost_pallas,
                           sandwich=ps.strip_sandwich_pallas)


def T(x, dtype=None):
    t = torch.tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def assert_rel(got, ref, rel):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _feats(p=40):
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(24, 30), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    f = taff.extract_features(T(img), gt.CONFIG2).numpy()
    return f[::f.shape[0] // p][:p], f


def _strip_inputs(dtype, p=96, n=2048, kp=128, seed=0):
    """A strip with exact-zero padding rows and columns, and the sweep
    operands, all as numpy f32 (the strip already rounded to ``dtype``)."""
    rng = np.random.default_rng(seed)
    strip = rng.random((p, n), np.float32) ** 4
    strip[p - 16:] = 0.0                      # padding rows
    strip[:, n - 40:] = 0.0                   # padding columns
    strip = T(strip, dtype).float().numpy()
    bm = (rng.random(n) > 0.05).astype(np.float32)
    bm[n - 40:] = 0.0
    return dict(
        strip=strip, bm=bm,
        t2=(0.5 + rng.random((2, p))).astype(np.float32),
        t=(0.5 + rng.random(p)).astype(np.float32),
        ta=(rng.standard_normal((p, kp))).astype(np.float32),
        s_pre=((0.5 + rng.random(n)) * bm).astype(np.float32),
        s2=((0.5 + rng.random(n)) * bm).astype(np.float32))


DTYPES = {"bfloat16": ("bfloat16", torch.bfloat16),
          "float32": ("float32", torch.float32)}


# --- plain versions against the Pallas kernels ------------------------------

@pytest.mark.parametrize("gemm", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_k1_plain_matches_pallas(jx, gemm, store):
    jnp = jx.jnp
    fa, fall = _feats()
    fa = np.concatenate([fa, np.full((8, fa.shape[1]), 1e3, np.float32)])
    jg, tg = DTYPES[gemm]
    js, ts = DTYPES[store]
    jg, js = jnp.dtype(jg), jnp.dtype(js)
    ref = np.asarray(jx.affinity(
        jnp.asarray(fa), jnp.asarray(fall), dtype=jg,
        store_dtype=js if store == "bfloat16" else None).astype(jnp.float32))
    got = k1.affinity_strip_plain(T(fa), T(fall), tg,
                                  ts if store == "bfloat16" else None)
    assert got.dtype == ts
    # d2 from |a|^2 + |b|^2 - 2 a.b at norms ~40: a few f32 ulps of the
    # norms reach the entry (5e-5); a bf16 store adds one ulp
    atol = BF16_ULP if store == "bfloat16" else 5e-5
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)
    assert (got[-8:] == 0).all()              # poisoned rows: exact zeros


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k2_plain_matches_pallas(jx, dtype):
    jnp = jx.jnp
    x = _strip_inputs(DTYPES[dtype][1])
    jd, td = DTYPES[dtype]
    u_r, s_r = jx.ext2(jnp.asarray(x["strip"]).astype(jd),
                                 jnp.asarray(x["t2"]), jnp.asarray(x["bm"]))
    u, s = k24.strip_ext2_plain(T(x["strip"], td), T(x["t2"]), T(x["bm"]))
    assert_rel(u.numpy(), u_r, REL_F32)
    assert_rel(s.numpy(), s_r, REL_F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k3_plain_matches_pallas(jx, dtype):
    jnp = jx.jnp
    x = _strip_inputs(DTYPES[dtype][1])
    jd, td = DTYPES[dtype]
    u_r, s_r = jx.spost(
        jnp.asarray(x["strip"]).astype(jd), jnp.asarray(x["ta"]),
        jnp.asarray(x["t"]), jnp.asarray(x["s_pre"]), jnp.asarray(x["bm"]))
    u, s = k24.strip_sandwich_spost_plain(T(x["strip"], td), T(x["ta"]),
                                          T(x["t"]), T(x["s_pre"]),
                                          T(x["bm"]))
    assert_rel(s.numpy(), s_r, REL_F32)
    assert_rel(u.numpy(), u_r,
               REL_SANDWICH_BF16 if dtype == "bfloat16" else REL_F32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k4_plain_matches_pallas(jx, dtype):
    jnp = jx.jnp
    x = _strip_inputs(DTYPES[dtype][1])
    jd, td = DTYPES[dtype]
    u_r = jx.sandwich(jnp.asarray(x["strip"]).astype(jd),
                                jnp.asarray(x["ta"]), jnp.asarray(x["s2"]))
    u = k24.strip_sandwich_plain(T(x["strip"], td), T(x["ta"]), T(x["s2"]))
    assert_rel(u.numpy(), u_r,
               REL_SANDWICH_BF16 if dtype == "bfloat16" else REL_F32)


# --- dispatch ---------------------------------------------------------------

def _counts():
    return [w.launches for w in WRAPPERS]


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    x = _strip_inputs(torch.bfloat16, p=128, n=512)
    before = _counts()
    fa, fall = _feats()
    out = k1.affinity_strip_cuda(T(fa), T(fall), torch.float32,
                                 torch.bfloat16)
    assert torch.equal(out, k1.affinity_strip_plain(
        T(fa), T(fall), torch.float32, torch.bfloat16))
    s = T(x["strip"], torch.bfloat16)
    u, _ = k24.strip_ext2_cuda(s, T(x["t2"]), T(x["bm"]))
    assert torch.equal(u, k24.strip_ext2_plain(s, T(x["t2"]), T(x["bm"]))[0])
    k24.strip_sandwich_spost_cuda(s, T(x["ta"]), T(x["t"]), T(x["s_pre"]),
                                  T(x["bm"]))
    k24.strip_sandwich_cuda(s, T(x["ta"]), T(x["s2"]))
    assert _counts() == before


@pytest.mark.parametrize("which", range(4))
def test_wrappers_refuse_devices_they_cannot_serve(which):
    meta = torch.empty((128, 64), device="meta")
    cpu = torch.zeros((128, 64))
    args = [(meta, cpu), (meta, torch.empty((2, 128), device="meta"), cpu),
            (meta, meta, meta, meta, meta), (cpu, meta, cpu)][which]
    with pytest.raises(ValueError, match="device"):
        WRAPPERS[which](*args)


def test_cuda_branch_raises_instead_of_falling_back(monkeypatch):
    """Where the kernel cannot run, the CUDA branch raises: no path
    returns the plain version's result for a CUDA tensor."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k1, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    monkeypatch.setattr(k24, "_sms", lambda t: 132)
    x = _strip_inputs(torch.bfloat16, p=128, n=512)
    s = T(x["strip"], torch.bfloat16)
    fa, fall = _feats()
    before = _counts()
    calls = [lambda: k1.affinity_strip_cuda(T(fa), T(fall)),
             lambda: k24.strip_ext2_cuda(s, T(x["t2"]), T(x["bm"])),
             lambda: k24.strip_sandwich_spost_cuda(
                 s, T(x["ta"]), T(x["t"]), T(x["s_pre"]), T(x["bm"])),
             lambda: k24.strip_sandwich_cuda(s, T(x["ta"]), T(x["s2"]))]
    for call in calls:
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
    assert _counts() == before
    # an f32 strip reaches its own kernels in the library, never the plain
    # version; a strip of any other dtype raises before the library
    f = s.float()
    for call in (lambda: k24.strip_ext2_cuda(f, T(x["t2"]), T(x["bm"])),
                 lambda: k24.strip_sandwich_spost_cuda(
                     f, T(x["ta"]), T(x["t"]), T(x["s_pre"]), T(x["bm"])),
                 lambda: k24.strip_sandwich_cuda(f, T(x["ta"]), T(x["s2"]))):
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
    with pytest.raises(ValueError, match="bf16 strip"):
        k24.strip_ext2_cuda(s.half(), T(x["t2"]), T(x["bm"]))
    assert _counts() == before


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())
    # the library name follows the sources
    assert _build.lib_path().name.startswith("libglt_kernels_")
    assert {p.name for p in _build.sources()} == {"affinity_strip.cu",
                                                   "colstats_v.cu",
                                                   "coord_store.cu",
                                                   "recompute_matvec.cu",
                                                   "recompute_sweeps.cu",
                                                   "strip_sweeps.cu"}


@pytest.mark.parametrize("case", [
    "rows-not-quantum", "rows-zero", "ta-rows", "t-shape", "s2-shape",
    "f32-strip", "f16-strip"])
def test_sandwich_shape_guards_raise_before_a_launch(monkeypatch, case):
    """K3/K4's wrapper refuses what the wgmma kernel cannot take (strip rows
    not a positive multiple of its 128-row tile, mismatched operands, a
    strip neither bf16 nor f32) before it asks for the kernel library; an
    f32 strip passes the guards to its own kernel, so it asks."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    monkeypatch.setattr(k24, "_sms", lambda t: 132)
    p = {"rows-not-quantum": 192, "rows-zero": 0}.get(case, 256)
    x = _strip_inputs(torch.bfloat16, p=256, n=512)
    s = T(x["strip"], torch.bfloat16)[:p]
    ta, t, s2 = T(x["ta"])[:p], T(x["t"])[:p], T(x["s2"])
    ta = ta[:128] if case == "ta-rows" else ta
    t = t[:100] if case == "t-shape" else t
    s2 = s2[:500] if case == "s2-shape" else s2
    s = {"f32-strip": s.float(), "f16-strip": s.half()}.get(case, s)
    err = RuntimeError if case == "f32-strip" else ValueError
    k3 = lambda: k24.strip_sandwich_spost_cuda(  # noqa: E731
        s, ta, t, T(x["s_pre"]), T(x["bm"]))
    k4 = lambda: k24.strip_sandwich_cuda(s, ta, s2)  # noqa: E731
    calls = {"t-shape": [k3], "s2-shape": [k4]}.get(case, [k3, k4])
    before = _counts()
    for call in calls:
        with pytest.raises(err):
            call()
    assert _counts() == before


# the sandwich's tile plan by strip dtype: (sketch columns a tile, blocks an
# SM, columns a stage): one 128 x 256 wgmma tile an SM, in 64-column stages
# on a bf16 strip and in 32-column ones on f32 (its three bf16 parts)
SANDWICH_PLAN = {"bf16": (k24.KP_QUANTUM, 1, 64),
                 "f32": (k24.KP_QUANTUM_F32, k24.F32_BLOCKS_PER_SM,
                         k24.F32_STAGE_DEPTH)}


def _by_dtype(cases):
    """pytest params over (strip dtype name, *case): the bf16 cases keep
    their bare ids, the f32 ones are marked f32."""
    return [pytest.param(dt, *c, id=("f32-" if dt == "f32" else "")
                         + "-".join(map(str, c))) for dt, *c in cases]


@pytest.mark.parametrize("dtype,p,n,kp,sms,want", _by_dtype([
    ("bf16", 5248, 262144, 256, 132, 16),   # the main path: 41 x 16 blocks
    ("bf16", 128, 4100, 256, 132, 65),      # one tile: a slice a stage
    ("bf16", 256, 4096, 512, 132, 33),      # 4 tiles: one full wave of 132
    ("f32", 5248, 262144, 256, 132, 16),    # 41 x 16 blocks, as on bf16
    ("f32", 128, 4100, 256, 132, 129),      # one tile: a slice a stage
    ("f32", 256, 4096, 512, 132, 33),       # 4 x 33: one full wave of 132
]))
def test_sandwich_splits_fill_the_last_wave(dtype, p, n, kp, sms, want):
    """Phase 2's split over N: whole stages a slice (64 columns on a bf16
    strip, 32 on an f32 one), and the count whose blocks (one an SM) waste
    the least of their last wave."""
    tile_n, per_sm, depth = SANDWICH_PLAN[dtype]
    s = k24.sandwich_splits(p, n, kp, sms, tile_n, per_sm, depth)
    assert s == want
    tiles = (p // k24.P_QUANTUM) * (kp // tile_n)
    assert s <= -(-n // depth)
    slots = sms * per_sm
    waves = -(-tiles * s // slots)
    assert tiles * s / (waves * slots) >= 0.49


class _FakeLib:
    """A kernel library that records the entry points called and their
    arguments, and fails every launch with cudaError 1."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 16 if name.endswith("clusters") else 1
        return entry


@pytest.mark.parametrize("case", [
    "k2-rows-not-quantum", "k2-p-past-cap", "k2-t2-shape",
    "k3-rows-not-quantum", "k3-ta-rows", "k3-kp-zero",
    "k4-rows-not-quantum", "k4-s2-shape"])
def test_f32_sweeps_raise_before_a_launch_outside_their_plans(monkeypatch,
                                                              case):
    """The f32 K2-K4 refuse a strip outside their plans (rows not a
    multiple of 128, P past the 8192 cap, mismatched operands, no sketch
    columns) before they ask for the kernel library."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    p = {"rows-not-quantum": 192, "p-past-cap": 8320}.get(
        case.split("-", 1)[1], 256)
    n = 256
    s = torch.zeros((p, n))
    ta = torch.zeros((128 if case == "k3-ta-rows" else p,
                      0 if case == "k3-kp-zero" else 200))
    t2 = torch.ones((2, 100 if case == "k2-t2-shape" else p))
    t, vec = torch.ones(p), torch.ones(n)
    s2 = vec[:200] if case == "k4-s2-shape" else vec
    call = {"k2": lambda: k24.strip_ext2_cuda(s, t2, vec),
            "k3": lambda: k24.strip_sandwich_spost_cuda(s, ta, t, vec, vec),
            "k4": lambda: k24.strip_sandwich_cuda(s, ta, s2)}[case[:2]]
    before = _counts()
    with pytest.raises(ValueError):
        call()
    assert _counts() == before


def test_f32_strip_reaches_its_kernels_with_their_plans(monkeypatch):
    """On the CUDA branch an f32 strip launches the f32 entry points (never
    the bf16 ones, never the plain versions): K2 with its f32 plan (clusters
    of 8, two 32-column slabs in flight at P 5248) and t2 unrounded; K3/K4
    with kp zero-padded to the f32 tile's 256 columns, the f32 split, and
    scratch for ws and for ta's and ws's three bf16 parts. A failed launch
    raises and counts nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(k24, "_sms", lambda t: 132)
    before = _counts()
    p, n = 5248, 262
    s = torch.zeros((p, n))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        k24.strip_ext2_cuda(s, torch.full((2, p), 1.0 + 2.0 ** -20),
                            torch.ones(n))
    (occ, occ_args), (launch, args) = lib.calls
    assert occ == "glt_strip_ext2_f32_clusters" and occ_args == (8, 656, 2)
    assert launch == "glt_strip_ext2_f32"
    assert args[6:12] == (p, n, 264, 8, 2, 9)   # ld 264; ceil(262 / 32)
    for kp, kp2 in ((200, 256), (384, 512)):
        lib.calls.clear()
        ta = torch.zeros((p, kp))
        with pytest.raises(RuntimeError, match="cudaError 1"):
            k24.strip_sandwich_spost_cuda(s, ta, torch.ones(p),
                                          torch.ones(n), torch.ones(n))
        with pytest.raises(RuntimeError, match="cudaError 1"):
            k24.strip_sandwich_cuda(s, ta, torch.ones(n))
        assert [c[0] for c in lib.calls] == ["glt_strip_sandwich_f32"] * 2
        for _, args in lib.calls:
            splits = k24.sandwich_splits(p, n, kp2, 132, 256, 1, 32)
            assert args[12:17] == (p, n, 264, kp2, splits)
            # ws and ta's and ws's parts: scratch apart from ta
            assert len({args[1], *args[7:10]}) == 4
    assert lib.calls[1][1][2] is None            # K4 passes no t
    assert _counts() == before


def _k1_lanes(d):
    """The lanes of the K1 instantiation that takes d features: 32 or 64."""
    return 32 if d <= 32 else 64


def _split_fp16(x):
    """The kernel's split of f32 feature rows (csrc split2): each row scaled
    by 2^-E (its largest |x| < 2^E), big on the grid 2^-10 (exact in fp16),
    small = fp16(rest); both zero-padded to the kernel's 32 or 64 lanes."""
    m = x.abs().amax(1)
    e = torch.where(m > 0, torch.frexp(m).exponent,
                    torch.full_like(m, -100, dtype=torch.int32))
    e = e.clamp(-100, 100)
    xs = x * torch.exp2(-e.float())[:, None]
    big = torch.round(xs * 1024) / 1024              # rintf: half to even
    small = (xs - big).half().float()
    lanes = (0, _k1_lanes(x.shape[1]) - x.shape[1])
    return (torch.nn.functional.pad(big, lanes),
            torch.nn.functional.pad(small, lanes), e)


def _split_cross_d2(a, b):
    """K1's d2 emulated in torch: big.big a k16 step each (sums of 16
    products on the 2^-20 grid, exact in f32), added in pairs and the pairs
    in order as the kernel adds them, big.small + small.big in f32,
    small.small dropped, scaled back by 2^(Ea + Eb); d2 = (na + nb) - 2 cross
    rounded once (the kernel's FMA). Returns (d2, 2^(Ea + Eb))."""
    ab, as_, ea = _split_fp16(a)
    bb, bs, eb = _split_fp16(b)
    step = [ab[:, k:k + 16] @ bb[:, k:k + 16].T
            for k in range(0, ab.shape[1], 16)]
    big = step[0] + step[1]
    if len(step) == 4:
        big = big + (step[2] + step[3])
    cross = big + (ab @ bs.T + as_ @ bb.T)
    scale = torch.exp2((ea[:, None] + eb[None, :]).double())
    nn = (torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :])
    d2 = (nn.double() - 2.0 * scale * cross.double()).float()
    return d2.clamp(min=0.0), scale


@pytest.mark.parametrize("patch,h,w,cols", [
    (5, 96, 96, None),          # config 2's 25 lanes: the 32-lane kernel
    (7, 96, 96, None),          # a 7 x 7 patch, 49 lanes: the 64-lane one
    (7, 512, 1024, 16384),      # 7 x 7 at config 4's scale (h 0.25)
], ids=["5x5-96", "7x7-96", "7x7-512x1024"])
def test_k1_split_fp16_cross_holds_the_f32_cross(patch, h, w, cols):
    """The kernel's cross, emulated, on NLM features (config 2's at 96x96;
    config 4's at 512 x 1024, a seeded sample of ``cols`` pixel columns)
    with the strip path's poison rows (+1e3) and columns (-1e3), against
    the plain version's f32 cross. Bound, over the kernel's L lanes (32, or
    64 past 32 features): the dropped small.small terms (L x 2^-22 of
    2^(Ea + Eb)), the fp16 rounding of the smalls (2 x L x 2^-22) and the
    f32 rounding of the plain cross (L x 2^-24), 3.25 L 2^-22 in all,
    doubled in d2, are under L 2^-19 2^(Ea + Eb) (2^-14 at 32 lanes, 2^-13
    at 64); d2's own rounding adds an f32 ulp of na + nb."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(h, w), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    cfg = (gt.CONFIG2 if w == 96 else
           gt.PipelineConfig(kernel="nlm", h=0.25)).replace(patch_size=patch)
    rng = np.random.default_rng(0)
    f = taff.extract_features(T(img), cfg)
    if cols is not None:
        f = f[torch.tensor(rng.choice(h * w, cols, replace=False))]
    n = f.shape[0]
    f = torch.cat([f, torch.full((64, f.shape[1]), -1e3)])  # padding columns
    p = 184
    idx = torch.tensor(rng.choice(n, p, replace=False))
    a = torch.cat([f[idx], torch.full((256 - p, f.shape[1]), 1e3)])
    d2, scale = _split_cross_d2(a, f)
    nn = (torch.sum(a * a, 1)[:, None] + torch.sum(f * f, 1)[None, :])
    d2_plain = torch.clamp(nn - 2.0 * (a @ f.T), min=0.0)
    real = (slice(0, p), slice(0, n))
    lanes = _k1_lanes(f.shape[1])
    bar = lanes * 2.0 ** -19 * scale + 2.0 ** -22 * nn.double()
    assert bool(((d2 - d2_plain).abs().double() <= bar)[real].all())
    # the stored bf16 strip within one ulp of the plain version's
    strip = torch.exp(-d2).to(torch.bfloat16)
    plain = k1.affinity_strip_plain(a, f, torch.float32, torch.bfloat16)
    assert float((strip.float() - plain.float()).abs().max()) <= BF16_ULP
    # poison rows and columns: exactly zero
    assert bool((strip[p:] == 0).all())
    assert bool((strip[:, n:] == 0).all())


def _grid_exp(m):
    """csrc grid_exp: the E with m < 2^E, in [-100, 100] (-100 for 0)."""
    return torch.where(m > 0, torch.frexp(m).exponent,
                       torch.full_like(m, -100, dtype=torch.int32)
                       ).clamp(-100, 100)


def _parts3_bf16(x, e):
    """The kernel's split of an f32 operand (csrc split3_grid): b0 = x
    rounded to the grid 2^(e - 8), b1 = bf16(x - b0), b2 = bf16(x - b0 -
    b1), carried in f32."""
    q = torch.exp2(8.0 - e.float())
    b0 = torch.round(x * q) / q                      # rintf: half to even
    r = x - b0
    b1 = r.to(torch.bfloat16).float()
    return b0, b1, (r - b1).to(torch.bfloat16).float()


def _split_sum(a, b, lo, hi, depth=k24.F32_STAGE_DEPTH):
    """sum over k in [lo, hi) of a[:, k] b[k, :] (a the strip or its
    transpose, b ta or ws) as sandwich_split_kernel sums it: each
    ``depth``-deep stage splits a's rows and b's columns on their own grids
    (from their largest entries of the stage), sums the five correction
    products a1 b0, a0 b1, a1 b1, a2 b0, a0 b2 from zero (exact products,
    their sum rounded once to f32: the tensor core's truncation within them
    is not modelled) and adds them to the running f32 sum, then a0 b0
    (exact on the grids) from zero, added too."""
    run = torch.zeros((a.shape[0], b.shape[1]))
    for k in range(lo, hi, depth):
        s = slice(k, min(k + depth, hi))
        sa, sb = a[:, s], b[s]
        a0, a1, a2 = _parts3_bf16(sa, _grid_exp(sa.abs().amax(1))[:, None])
        b0, b1, b2 = _parts3_bf16(sb, _grid_exp(sb.abs().amax(0))[None, :])

        def mm(x, y):
            return x.double() @ y.double()
        big = mm(a0, b0).float()
        corr = (mm(a1, b0) + mm(a0, b1) + mm(a1, b1) + mm(a2, b0)
                + mm(a0, b2)).float()
        run = (run + corr) + big
    return run


def _ks_converter(strip, t):
    """K3's ks = K^T t as the kernel's converter warpgroup sums it on the
    FP32 pipe while it splits the strip: row group g holds the rows d with
    d mod 8 in {0, 1}, {4, 5}, {2, 3}, {6, 7} (g = 0 .. 3), FMA chains over
    spans of 8 32-row stages (256 rows) from zero added to its running
    sum, the 4 groups' sums as (g0 + g1) + (g2 + g3)."""
    p = strip.shape[0]
    groups = ((0, 1), (4, 5), (2, 3), (6, 7))
    run = torch.zeros((4, strip.shape[1]))
    for s0 in range(0, p, 256):
        for g, mods in enumerate(groups):
            span = torch.zeros(strip.shape[1], dtype=torch.float64)
            for d in range(s0, min(s0 + 256, p)):
                if d % 8 in mods:                      # one FMA a row
                    span = span + strip[d].double() * float(t[d])
                    span = span.float().double()
            run[g] = run[g] + span.float()
    return (run[0] + run[1]) + (run[2] + run[3])


def _sandwich_split(strip, ta, s2, sms=132):
    """K4's u by the kernel's scheme: phase 1 over all of P, ws = W s2 in
    f32, phase 2 over the slices of the f32 plan, the slice partials added
    in order (csrc reduce_partials)."""
    p, n = strip.shape
    ws = _split_sum(strip.T, ta, 0, p) * s2[:, None]
    kp2 = -(-ta.shape[1] // k24.KP_QUANTUM_F32) * k24.KP_QUANTUM_F32
    splits = k24.sandwich_splits(p, n, kp2, sms, k24.KP_QUANTUM_F32,
                                 k24.F32_BLOCKS_PER_SM, k24.F32_STAGE_DEPTH)
    chunk = -(-n // splits)
    chunk = -(-chunk // k24.F32_STAGE_DEPTH) * k24.F32_STAGE_DEPTH
    u = torch.zeros((p, ta.shape[1]))
    for z in range(splits):
        u = u + _split_sum(strip, ws, min(n, z * chunk), min(n, (z + 1) * chunk))
    return u


def _path_sandwich_operands(monkeypatch):
    """K3's and K4's operands on the real path: config 2's recipe with its
    f32 strip at 64x64 (p 245 of 256 rows, N 4096, kp 128 — sample_rho 0.06,
    sketch_oversample 80), recorded from the plain strip_cache factor: ta
    from the ridge Cholesky solve with the A scales folded in, t, s_pre,
    b_mask, s_post^2."""
    from graphlap_tpu_torch.config import PipelineConfig
    from graphlap_tpu_torch.models.pipeline import _filter_channel

    cfg = PipelineConfig(
        kernel="nlm", h=0.15, sample_rho=0.06, num_eigvecs=24,
        sinkhorn_iters=6, filter_name="identity", streaming=True,
        strip_cache=True, solver="sketch", sketch_oversample=80,
        sketch_power=0, sinkhorn_coarse=4, sinkhorn_polish=1,
        affinity_dtype="float32", use_pallas=True)
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(64, 64), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    plan = gt.make_plan(img, cfg)
    seen = {}

    def spost(strip, ta, t, s_pre, bm):
        seen["k3"] = (strip, ta, t, s_pre, bm)
        return k24.strip_sandwich_spost_plain(strip, ta, t, s_pre, bm)

    def sandwich(strip, ta, s2):
        seen["k4"] = (strip, ta, s2)
        return k24.strip_sandwich_plain(strip, ta, s2)
    monkeypatch.setattr(k24, "strip_sandwich_spost_cuda", spost)
    monkeypatch.setattr(k24, "strip_sandwich_cuda", sandwich)
    _filter_channel(torch.tensor(img),
                    torch.tensor(plan.idx_a.astype(np.int64)), cfg)
    return seen


@pytest.mark.parametrize("which", ["k3", "k4"])
def test_f32_sandwich_split_scheme_holds_the_f32_products(jx, monkeypatch,
                                                          which):
    """The f32 K3/K4's scheme (csrc sandwich_split_kernel), emulated in
    torch on the real path's operands (``_path_sandwich_operands``: ta's
    columns and rows span the path's octaves): every operand in three bf16
    parts, the first on a grid a row of A and a column of B each stage, the
    six kept part products, 32-deep stage sums from zero (the corrections,
    then a0 b0 exact) added in f32, phase 2's slices added in order; K3's
    ks as the converter sums it. Its u against the sums in f64, relative to the f64 sum of the
    magnitudes of u's terms (K ((K^T |ta|) s2): u's terms cancel, so |u|
    would measure the cancellation, not the sums): max and p99 within 1.5x
    the plain f32 version's. And against graphlap_tpu's Pallas kernel at
    f32 (interpret mode) within the f32 sweeps' 1e-4 bar."""
    jnp = jx.jnp
    ops = _path_sandwich_operands(monkeypatch)[which]
    strip, ta = ops[0], ops[1]
    p, n = strip.shape
    assert (p, n, ta.shape[1]) == (256, 4096, 128)
    if which == "k3":
        t, s_pre, bm = ops[2:]
        ks = _ks_converter(strip, t)
        s_post = torch.sqrt(s_pre / torch.clamp(ks, min=1e-30)) * bm
        s2 = s_post * s_post
        plain = k24.strip_sandwich_spost_plain(*ops)[0]
        ref = jx.spost(*(jnp.asarray(x.numpy()) for x in ops))[0]
        ks64 = t.double() @ strip.double()
        s2_64 = s_pre.double() / torch.clamp(ks64, min=1e-30) * bm.double()
    else:
        s2 = ops[2]
        plain = k24.strip_sandwich_plain(*ops)
        ref = jx.sandwich(*(jnp.asarray(x.numpy()) for x in ops))
        s2_64 = s2.double()
    got = _sandwich_split(strip, ta, s2)
    kb = strip.double()
    u64 = kb @ ((kb.T @ ta.double()) * s2_64[:, None])
    scale = kb @ ((kb.T @ ta.double().abs()) * s2_64[:, None])

    def err(x):
        e = ((x.double() - u64).abs() / scale.clamp_min(1e-300)).flatten()
        return float(e.max()), float(torch.quantile(e, 0.99))
    (g_max, g_p99), (p_max, p_p99) = err(got), err(plain)
    assert g_max <= 1.5 * p_max and g_p99 <= 1.5 * p_p99, (
        g_max, g_p99, p_max, p_p99)
    assert_rel(got.numpy(), np.asarray(ref), REL_F32_SWEEP)


@pytest.mark.parametrize("dtype,p,cluster,stages", _by_dtype([
    ("bf16", 128, 8, 4),      # the smallest strip: 16 rows a block
    ("bf16", 1024, 8, 4),
    ("bf16", 4096, 8, 3),
    ("bf16", 5248, 8, 2),     # the main path: 656 rows a block
    ("bf16", 6400, 8, 2),     # the largest P two 64-column slabs of 8 fit
    ("bf16", 6528, 16, 3),    # past it, clusters of 16
    ("bf16", 8192, 16, 3),    # the sample cap
    ("f32", 128, 8, 4),
    ("f32", 3456, 8, 3),
    ("f32", 5248, 8, 2),      # config 2 f32: two 84 KB slabs
    ("f32", 6528, 8, 2),      # past bf16's 6400: the f32 partials are smaller
    ("f32", 6784, 16, 3),     # past 6656, clusters of 16
    ("f32", 8192, 16, 3),
]))
def test_k2_plan_picks_the_cluster_and_stages(dtype, p, cluster, stages):
    """K2's launch plan (csrc glt_strip_ext2 / glt_strip_ext2_f32 refuse
    any other): portable 8-block clusters with the most slabs in flight (up
    to 4, at least 2) within 227 KB, else clusters of 16. A slab row is 128
    bytes on both strips: 64 bf16 columns or 32 f32 ones."""
    itemsize = {"bf16": 2, "f32": 4}[dtype]
    plan = k24.ext2_plan(p, itemsize)
    assert (plan.cluster, plan.stages) == (cluster, stages)
    assert plan.rows == p // cluster
    assert plan.smem == k24.ext2_smem(plan.rows, plan.stages, plan.cluster,
                                      k24.EXT2_ROW // itemsize)


def test_k2_plan_serves_every_p_of_the_path():
    """Every P the path gives (multiples of 128 up to the 8192 sample cap):
    the blocks of a cluster cover P, a block's rows are whole 8-row TMA
    boxes and at most 1024 (32 a thread of its 256), at least two slabs in
    flight, within the 227 KB a block can have; on a bf16 strip and an
    f32 one."""
    for itemsize, p in itertools.product(
            (2, 4), range(128, k24.EXT2_MAX_P + 1, k24.P_QUANTUM)):
        plan = k24.ext2_plan(p, itemsize)
        assert plan.cluster in (8, 16)
        assert plan.rows * plan.cluster == p
        assert plan.rows % 8 == 0 and plan.rows <= 1024
        assert 2 <= plan.stages <= 4
        assert plan.smem <= k24.SMEM_CAP
        # the slab ring is the bulk of it: 128 bytes a row a stage
        assert plan.smem >= plan.stages * plan.rows * k24.EXT2_ROW


@pytest.mark.parametrize("p", [64, 192, 8320])
def test_k2_raises_before_a_launch_for_p_outside_the_plan(monkeypatch, p):
    """A P that is not a multiple of 128 or is past the sample cap has no
    plan: the CUDA branch raises before it asks for the kernel library."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    s = torch.zeros((p, 256), dtype=torch.bfloat16)
    before = _counts()
    with pytest.raises(ValueError, match="multiple of 128"):
        k24.strip_ext2_cuda(s, torch.ones((2, p)), torch.ones(256))
    assert _counts() == before


def test_k1_raises_before_a_launch_past_its_feature_lanes(monkeypatch):
    """The emitter's split cross and its coordinate cross each take up to
    128 feature lanes, the reference's widest layout: 7 x 7, 9 x 9 and 11 x
    11 patches (49, 81 and 121 lanes; with two coordinates 51, 83 and 123)
    reach the kernel library; anything past 128 lanes raises ValueError,
    each before any launch."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k1, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    before = _counts()
    for d in (49, 65, 81, 121):
        with pytest.raises(RuntimeError, match="unavailable"):
            k1.affinity_strip_cuda(torch.zeros((8, d)), torch.zeros((16, d)))
    for d in (51, 65, 83, 123):
        with pytest.raises(RuntimeError, match="unavailable"):
            k1.affinity_strip_cuda(torch.zeros((8, d)), torch.zeros((16, d)),
                                   coords=True)
    for coords in (False, True):
        with pytest.raises(ValueError, match="feature lanes"):
            k1.affinity_strip_cuda(torch.zeros((8, 129)),
                                   torch.zeros((16, 129)), coords=coords)
    assert _counts() == before


# --- on the card: kernel against plain version ------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4100])      # 4100: the ragged paths
def test_k1_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(3)
    fa = torch.tensor(rng.random((200, 25), np.float32), device=cuda_device)
    fall = torch.tensor(rng.random((n, 25), np.float32), device=cuda_device)
    for store in (torch.bfloat16, None):
        before = k1.affinity_strip_cuda.launches
        got = k1.affinity_strip_cuda(fa, fall, torch.float32, store)
        assert k1.affinity_strip_cuda.launches == before + 1
        ref = k1.affinity_strip_plain(fa, fall, torch.float32, store)
        # absolute: strip entries lie in [0, 1]
        err = float((got.float() - ref.float()).abs().max())
        assert err <= (BF16_ULP if store else 5e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4100])
def test_k2_k4_kernels_match_plain(cuda_device, n):
    x = _strip_inputs(torch.bfloat16, p=256, n=n, kp=200)
    d = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    s = d["strip"].to(torch.bfloat16)
    got = k24.strip_ext2_cuda(s, d["t2"], d["bm"])
    ref = k24.strip_ext2_plain(s, d["t2"], d["bm"])
    assert max(map(_rel_err, got, ref)) <= 1e-4
    got = k24.strip_sandwich_spost_cuda(s, d["ta"], d["t"], d["s_pre"],
                                        d["bm"])
    ref = k24.strip_sandwich_spost_plain(s, d["ta"], d["t"], d["s_pre"],
                                         d["bm"])
    assert _rel_err(got[1], ref[1]) <= 1e-4
    assert _rel_err(got[0], ref[0]) <= REL_SANDWICH_BF16
    got = k24.strip_sandwich_cuda(s, d["ta"], d["s2"])
    ref = k24.strip_sandwich_plain(s, d["ta"], d["s2"])
    assert _rel_err(got, ref) <= REL_SANDWICH_BF16


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,kp", [
    (128, 4100, 128),     # P at the 128-row quantum, N not a 128 multiple
    (256, 1000, 384),     # a quantum above; kp over two 256-column tiles
    (256, 3000, 512),     # two full sketch tiles
    (384, 130, 256),      # N under one column tile
])
def test_k3_k4_tile_edges_match_plain(cuda_device, p, n, kp):
    """The wgmma sandwich at its tiles' edges: N not a multiple of the
    128-column output tile or of the 64-column stage (TMA reads zeros past
    N), kp padded to and over the 256-column sketch tile, P at the 128-row
    quantum and one quantum above."""
    x = _strip_inputs(torch.bfloat16, p=p, n=n, kp=kp, seed=p + n)
    d = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    s = d["strip"].to(torch.bfloat16)
    before = _counts()
    got = k24.strip_sandwich_spost_cuda(s, d["ta"], d["t"], d["s_pre"],
                                        d["bm"])
    ref = k24.strip_sandwich_spost_plain(s, d["ta"], d["t"], d["s_pre"],
                                         d["bm"])
    assert got[0].shape == (p, kp) and got[1].shape == (n,)
    assert _rel_err(got[1], ref[1]) <= 1e-4
    assert _rel_err(got[0], ref[0]) <= REL_SANDWICH_BF16
    got4 = k24.strip_sandwich_cuda(s, d["ta"], d["s2"])
    assert _rel_err(got4, k24.strip_sandwich_plain(s, d["ta"], d["s2"])) \
        <= REL_SANDWICH_BF16
    after = _counts()
    assert (after[2] - before[2], after[3] - before[3]) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k3_k4_repeat_bit_for_bit(cuda_device, dtype):
    """Phase 2's U sums through per-slice partials and a fixed-order
    reduction, no float atomics: two launches agree bit for bit."""
    x = _strip_inputs(STRIP_DTYPES[dtype], p=512, n=20000, kp=256, seed=5)
    d = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    s = d["strip"].to(STRIP_DTYPES[dtype])
    args = (s, d["ta"], d["t"], d["s_pre"], d["bm"])
    a, b = (k24.strip_sandwich_spost_cuda(*args) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    a, b = (k24.strip_sandwich_cuda(s, d["ta"], d["s2"]) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_k3_k4_do_not_lean(cuda_device):
    """u = K ws does not lean to either side of the plain version's sums in
    f64 (u takes both signs, so the lean is (kernel - ref) sign(ref)): the
    tensor core's f32 accumulation truncates, and a sum carried in it over
    the depth would shrink. A strip from the K1 emitter on a test image's
    patch features (p 768 samples, N 65536 pixels)."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(256, 256), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    f = taff.extract_features(torch.tensor(img, device=cuda_device),
                              gt.CONFIG2)
    rng = np.random.default_rng(7)
    p = 768
    idx = torch.tensor(rng.choice(f.shape[0], p, replace=False),
                       device=cuda_device)
    strip = k1.affinity_strip_cuda(f[idx], f, torch.float32, torch.bfloat16)
    ta = torch.tensor(rng.standard_normal((p, 256)).astype(np.float32),
                      device=cuda_device)
    t = torch.tensor((0.5 + rng.random(p)).astype(np.float32),
                     device=cuda_device)
    n = strip.shape[1]
    s_pre = torch.tensor((0.5 + rng.random(n)).astype(np.float32),
                         device=cuda_device)
    bm = torch.ones(n, device=cuda_device)
    # the plain versions' rounding points, their sums in f64
    kb = strip.double()
    ks = t.to(torch.bfloat16).double() @ kb
    sp2 = (torch.sqrt(s_pre.double() / ks.clamp_min(1e-30))) ** 2

    def sandwich64(s2):
        w = kb.T @ ta.to(torch.bfloat16).double()
        return kb @ (w * s2[:, None]).to(torch.bfloat16).double()

    for got, ref in (
            (k24.strip_sandwich_spost_cuda(strip, ta, t, s_pre, bm)[0],
             sandwich64(sp2)),
            (k24.strip_sandwich_cuda(strip, ta, s_pre),
             sandwich64(s_pre.double()))):
        ref = ref.float()
        keep = ref != 0
        lean = ((got - ref) * torch.sign(ref))[keep]
        below = float((lean < 0).float().mean())
        assert 0.25 < below < 0.75, below


def _device_strip(p, n, dev, seed, dtype=torch.bfloat16):
    """_strip_inputs' strip, t2 and b_mask made on the card (a P = 8192
    strip is too large to draw with numpy in a test)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    strip = torch.rand((p, n), generator=gen, device=dev) ** 4
    strip[p - 16:] = 0.0
    strip[:, n - 40:] = 0.0
    bm = (torch.rand(n, generator=gen, device=dev) > 0.05).float()
    bm[n - 40:] = 0.0
    t2 = 0.5 + torch.rand((2, p), generator=gen, device=dev)
    return strip.to(dtype), t2, bm


STRIP_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,p,n", _by_dtype([
    ("bf16", 8192, 65536),    # the sample cap: clusters of 16, 512 rows a block
    ("bf16", 8192, 65540),    # ... with a ragged N (a last, partial slab)
    ("bf16", 128, 4100),      # 16 rows a block, a ragged N
    ("f32", 8192, 65540),     # the sample cap: clusters of 16, a ragged N
    ("f32", 6528, 4100),      # clusters of 8 with two slabs, past bf16's 6400
    ("f32", 128, 4100),
]))
def test_k2_kernel_matches_plain_across_its_plans(cuda_device, dtype, p, n):
    strip, t2, bm = _device_strip(p, n, cuda_device, p + n,
                                  STRIP_DTYPES[dtype])
    before = k24.strip_ext2_cuda.launches
    got = k24.strip_ext2_cuda(strip, t2, bm)
    assert k24.strip_ext2_cuda.launches == before + 1
    ref = k24.strip_ext2_plain(strip, t2, bm)
    assert got[0].shape == (p,) and got[1].shape == (n,)
    assert max(map(_rel_err, got, ref)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(STRIP_DTYPES))
def test_k2_repeats_bit_for_bit(cuda_device, dtype):
    """kbt meets in a fixed tree (rank order through distributed shared
    memory) and u through per-cluster partials summed in a fixed order: two
    launches agree bit for bit."""
    strip, t2, bm = _device_strip(5248, 20000, cuda_device, 9,
                                  STRIP_DTYPES[dtype])
    a, b = (k24.strip_ext2_cuda(strip, t2, bm) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(STRIP_DTYPES))
def test_k2_plan_mirrors_the_library(cuda_device, dtype):
    """ext2_plan's shared bytes are the library's for every P of the path."""
    lib = _build.lib()
    smem = {"bf16": lib.glt_ext2_smem_bytes,
            "f32": lib.glt_strip_ext2_f32_smem_bytes}[dtype]
    for p in range(128, k24.EXT2_MAX_P + 1, k24.P_QUANTUM):
        plan = k24.ext2_plan(p, STRIP_DTYPES[dtype].itemsize)
        assert smem(plan.rows, plan.stages, plan.cluster) == plan.smem


# the f32 sweeps: f32 sums in another order (no rounding point to flip)
REL_F32_SWEEP = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,kp", [
    (256, 4096, 200),     # kp zero-padded to the 128-column f32 tile
    (128, 4100, 128),     # N not a multiple of the tiles or the slabs
    (128, 4102, 128),     # N % 4 != 0: the strip copied to rows of 4104
    (384, 130, 384),      # N under one output tile; three sketch tiles
    (256, 3000, 512),
])
def test_f32_sweeps_match_plain(cuda_device, p, n, kp):
    """K2-K4 on an f32 strip against their plain versions, at the tiles'
    and slabs' edges."""
    x = _strip_inputs(torch.float32, p=p, n=n, kp=kp, seed=p + n)
    d = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    s = d["strip"]
    before = _counts()
    got = k24.strip_ext2_cuda(s, d["t2"], d["bm"])
    ref = k24.strip_ext2_plain(s, d["t2"], d["bm"])
    assert got[0].shape == (p,) and got[1].shape == (n,)
    assert max(map(_rel_err, got, ref)) <= REL_F32_SWEEP
    got = k24.strip_sandwich_spost_cuda(s, d["ta"], d["t"], d["s_pre"],
                                        d["bm"])
    ref = k24.strip_sandwich_spost_plain(s, d["ta"], d["t"], d["s_pre"],
                                         d["bm"])
    assert got[0].shape == (p, kp) and got[1].shape == (n,)
    assert max(map(_rel_err, got, ref)) <= REL_F32_SWEEP
    got = k24.strip_sandwich_cuda(s, d["ta"], d["s2"])
    ref = k24.strip_sandwich_plain(s, d["ta"], d["s2"])
    assert _rel_err(got, ref) <= REL_F32_SWEEP
    after = _counts()
    assert [a - b for a, b in zip(after[1:], before[1:])] == [1, 1, 1]


@pytest.mark.gpu
def test_f32_sweeps_do_not_lean(cuda_device):
    """On an f32 strip from the K1 emitter (a 256x256 test image's patch
    features, p 768, N 65536), K2's u and s and K3/K4's u lean to neither
    side of the same sums in f64: the share of (kernel - f64) sign(f64)
    below zero lies in (0.25, 0.75). K2's u sums positive terms, where a
    running f32 sum too long for its terms drops their tails and leans
    low. K3/K4's u (each operand in three bf16 parts on the tensor cores)
    is also held to the f64 sums: max and p99 of |u - u64| over the f64
    sum of its terms' magnitudes within 1.5x the plain f32 version's, on
    ta and on ta with its columns scaled by 2^e (e in [-16, 16]) and its
    rows by 2^x (x in [-3, 3]), the octaves of the path's operands."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(256, 256), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    f = taff.extract_features(torch.tensor(img, device=cuda_device),
                              gt.CONFIG2)
    rng = np.random.default_rng(7)
    p = 768
    idx = torch.tensor(rng.choice(f.shape[0], p, replace=False),
                       device=cuda_device)
    strip = k1.affinity_strip_cuda(f[idx], f, torch.float32).contiguous()
    n = strip.shape[1]

    def vec(size, lo=0.5):
        return torch.tensor((lo + rng.random(size)).astype(np.float32),
                            device=cuda_device)

    ta = torch.tensor(rng.standard_normal((p, 256)).astype(np.float32),
                      device=cuda_device)
    t2, t, s_pre, bm = vec((2, p)), vec(p), vec(n), torch.ones(
        n, device=cuda_device)
    kb = strip.double()
    kbt = t2.double() @ kb
    s64 = bm.double() / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    sp2 = s_pre.double() / torch.clamp(t.double() @ kb, min=1e-30)

    def sandwich64(s2):
        return kb @ ((kb.T @ ta.double()) * s2[:, None])

    u, s = k24.strip_ext2_cuda(strip, t2, bm)
    pairs = [(u, kb @ s64), (s, s64),
             (k24.strip_sandwich_spost_cuda(strip, ta, t, s_pre, bm)[0],
              sandwich64(sp2)),
             (k24.strip_sandwich_cuda(strip, ta, s_pre),
              sandwich64(s_pre.double()))]
    for got, ref in pairs:
        keep = ref != 0
        lean = ((got.double() - ref) * torch.sign(ref))[keep]
        below = float((lean < 0).double().mean())
        assert 0.25 < below < 0.75, below

    def f64_err(x, ref, scale):
        e = ((x.double() - ref).abs() / scale).flatten()
        return float(e.max()), float(torch.quantile(e, 0.99))
    cols = torch.tensor(rng.integers(-16, 17, 256).astype(np.float32),
                        device=cuda_device)
    rows = torch.tensor((6 * rng.random(p) - 3).astype(np.float32),
                        device=cuda_device)
    for tx in (ta, ta * torch.exp2(rows)[:, None] * torch.exp2(cols)[None]):
        for s2, args in ((sp2, (strip, tx, t, s_pre, bm)),
                         (s_pre.double(), (strip, tx, s_pre))):
            kern, plain = ((k24.strip_sandwich_spost_cuda,
                            k24.strip_sandwich_spost_plain) if len(args) == 5
                           else (k24.strip_sandwich_cuda,
                                 k24.strip_sandwich_plain))
            got, ref = kern(*args), plain(*args)
            got, ref = ((got[0], ref[0]) if isinstance(got, tuple)
                        else (got, ref))
            u64 = kb @ ((kb.T @ tx.double()) * s2[:, None])
            scale = kb @ ((kb.T @ tx.double().abs()) * s2[:, None])
            k, pl = f64_err(got, u64, scale), f64_err(ref, u64, scale)
            assert k[0] <= 1.5 * pl[0] and k[1] <= 1.5 * pl[1], (k, pl)


def _config2_features(dev, p=300, seed=4):
    """Config-2 patch features (raw / (h 5), h = 0.15) of a noisy 96x96 test
    image: p sample rows and every pixel."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(96, 96), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    f = taff.extract_features(torch.tensor(img, device=dev), gt.CONFIG2)
    rng = np.random.default_rng(seed)
    idx = torch.tensor(rng.choice(f.shape[0], p, replace=False), device=dev)
    return f[idx].contiguous(), f


@pytest.mark.gpu
def test_k1_poison_rows_and_columns_store_exact_zeros(cuda_device):
    """The strip path's padding features (+1e3 rows, -1e3 columns) give
    exactly zero entries in both stores: the 2^-E scaling keeps them in
    fp16 range and d2 ~ 1e7 underflows the exp."""
    fa, f = _config2_features(cuda_device)
    d = f.shape[1]
    fa = torch.cat([fa, torch.full((84, d), 1e3, device=cuda_device)])
    fall = torch.cat([f, torch.full((120, d), -1e3, device=cuda_device)])
    for store in (torch.bfloat16, None):
        out = k1.affinity_strip_cuda(fa, fall, torch.float32, store)
        assert bool((out[300:] == 0).all())
        assert bool((out[:, -120:] == 0).all())
        assert bool((out[:300, :-120] > 0).any())


@pytest.mark.gpu
def test_k1_f32_store_at_config2_feature_scale(cuda_device):
    """The f32 store (IEEE expf) on config 2's features, whose entries reach
    1 on near-identical patches, within the f32 bar of the rand test; the
    bf16 store within one ulp."""
    fa, f = _config2_features(cuda_device)
    for store, bar in ((None, 5e-5), (torch.bfloat16, BF16_ULP)):
        got = k1.affinity_strip_cuda(fa, f, torch.float32, store)
        ref = k1.affinity_strip_plain(fa, f, torch.float32, store)
        assert got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= bar
