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
"""

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
    # an f32 strip has no CUDA sweep kernel yet: it raises, never runs plain
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k24.strip_ext2_cuda(s.float(), T(x["t2"]), T(x["bm"]))


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
                                                   "recompute_matvec.cu",
                                                   "recompute_sweeps.cu",
                                                   "strip_sweeps.cu"}


@pytest.mark.parametrize("case", [
    "rows-not-quantum", "rows-zero", "ta-rows", "t-shape", "s2-shape",
    "f32-strip"])
def test_sandwich_shape_guards_raise_before_a_launch(monkeypatch, case):
    """K3/K4's wrapper refuses what the wgmma kernel cannot take (strip rows
    not a positive multiple of its 128-row tile, mismatched operands, an
    f32 strip) before it asks for the kernel library."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k24, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    p = {"rows-not-quantum": 192, "rows-zero": 0}.get(case, 256)
    x = _strip_inputs(torch.bfloat16, p=256, n=512)
    s = T(x["strip"], torch.bfloat16)[:p]
    ta, t, s2 = T(x["ta"])[:p], T(x["t"])[:p], T(x["s2"])
    ta = ta[:128] if case == "ta-rows" else ta
    t = t[:100] if case == "t-shape" else t
    s2 = s2[:500] if case == "s2-shape" else s2
    s = s.float() if case == "f32-strip" else s
    err = NotImplementedError if case == "f32-strip" else ValueError
    k3 = lambda: k24.strip_sandwich_spost_cuda(  # noqa: E731
        s, ta, t, T(x["s_pre"]), T(x["bm"]))
    k4 = lambda: k24.strip_sandwich_cuda(s, ta, s2)  # noqa: E731
    calls = {"t-shape": [k3], "s2-shape": [k4]}.get(case, [k3, k4])
    before = _counts()
    for call in calls:
        with pytest.raises(err):
            call()
    assert _counts() == before


@pytest.mark.parametrize("p,n,kp,sms,want", [
    (5248, 262144, 256, 132, 16),     # the main path: 41 x 16 = 656 blocks
    (128, 4100, 256, 132, 65),        # one tile: a slice a 64-column stage
    (256, 4096, 512, 132, 33),        # 4 tiles: 132 blocks, one full wave
])
def test_sandwich_splits_fill_the_last_wave(p, n, kp, sms, want):
    """Phase 2's split over N: whole 64-column stages a slice, and the
    count whose one-an-SM blocks waste the least of their last wave."""
    s = k24.sandwich_splits(p, n, kp, sms)
    assert s == want
    tiles = (p // k24.P_QUANTUM) * (kp // k24.KP_QUANTUM)
    assert s <= -(-n // 64)
    waves = -(-tiles * s // sms)
    assert tiles * s / (waves * sms) >= 0.49


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
def test_k3_k4_repeat_bit_for_bit(cuda_device):
    """Phase 2's U sums through per-slice partials and a fixed-order
    reduction, no float atomics: two launches agree bit for bit."""
    x = _strip_inputs(torch.bfloat16, p=512, n=20000, kp=256, seed=5)
    d = {k: torch.tensor(v, device=cuda_device) for k, v in x.items()}
    s = d["strip"].to(torch.bfloat16)
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
