"""The 96- and 128-lane feature layouts of graphlap_tpu_torch: NLM 9 x 9
(81 lanes, d_pad 96; the aug layout's 87 lanes padded to 96) and 11 x 11
(121 lanes, d_pad 128; aug 127 padded to 128) through K1 and K7-K10 (their
bf16 layouts; the f32 and coordinate ones are in
tests/test_torch_bilateral.py) and K5/K6 (bf16 aug and f32). Each plain
version against its Pallas kernel (interpret mode on the CPU, the
reference's own CPU route; K5/K6's in tests/test_torch_matvec.py), config
2's strip_cache recipe at 9 x 9 and 11 x 11 (also with the spatial term:
recipe A, K1's coordinate cross) and config 4's fused recipe at
11 x 11 on a 96x96 frame against graphlap_tpu.filter_image with the
reference's random draws injected, config 3's sharpen at 9 x 9 (48x48x3)
and the 8 MP matvec denoise at 11 x 11 (96x96) against it too (exact
matvecs: no random draw), and, on a CUDA card only (marker ``gpu``), each
kernel at 96 and 128 lanes against its plain version, launched twice bit
for bit.

The bars are those of the 64-lane tests (tests/test_torch_wide.py):
* K1: 5e-5 absolute on the f32 store, one bf16 ulp (2^-8) on the bf16
  store; poison rows and columns exact zeros.
* K7: two bf16 ulps (2^-7) absolute, 99% of the entries equal; the gram to
  2e-2 of its max.
* K8: u and s to 2e-2 of their max; K9 and K10: every output to 5e-3 of
  its max.
* The slices: 0.05 dB, atol 2e-2, the top eigenvalue to rtol 1e-2; the
  f32 matvec denoise 0.02 dB, atol 2e-3 (the f32 slices' bars,
  tests/test_torch_matvec.py).
On the card: K1 one bf16 ulp / 5e-5, K7 1.5 x 2^-7, K8 2e-2 with u's and
s's leans in (0.25, 0.75) against f64 sums of the same bf16 entries, K9
5e-3 of max, K10 V 2^-7 of max |V| with its lean in (0.25, 0.75).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.models.pipeline import _filter_channel
from graphlap_tpu_torch.ops import affinity as taff
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_matvec as k56
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.utils import interop
from tests.test_torch_wide import (  # noqa: F401 (jx, cuda_device: fixtures)
    N, T, _bf, _rel_err, _twice, assert_rel, cuda_device, jx, torch_threads)

PATCHES = (9, 11)
LANES = {9: 96, 11: 128}          # d_pad_of and aug_d_pad_of of each patch
BF16_ULP = 2.0 ** -8
SLICE_BARS = (0.05, 2e-2)         # dB, atol: the bf16 slices' bars


def _features(patch, h=64, w=64, kernel_h=0.25):
    """``patch`` x ``patch`` NLM features of the noisy test image (config
    4's h), as f32 numpy (h w, patch^2)."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(h, w), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    cfg = PipelineConfig(kernel="nlm", patch_size=patch, h=kernel_h)
    f = taff.extract_features(torch.tensor(img), cfg).numpy()
    assert f.shape == (h * w, patch * patch)
    return f


# --- K1 at 81 and 121 lanes --------------------------------------------------

@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("patch", PATCHES)
def test_k1_plain_matches_pallas_at_81_and_121_lanes(jx, patch, store):
    """K1 on 9 x 9 and 11 x 11 features (config 2's h 0.15) with the strip
    path's poison rows (+1e3) and columns (-1e3): the entry to 5e-5 (f32
    store) or one bf16 ulp, and the poisoned rows and columns exactly
    zero."""
    jnp = jx.jnp
    d = patch * patch
    f = _features(patch, 24, 30, kernel_h=0.15)
    fa = np.concatenate([f[::18][:40], np.full((8, d), 1e3, np.float32)])
    fall = np.concatenate([f, np.full((16, d), -1e3, np.float32)])
    bf16 = store == "bfloat16"
    ref = np.asarray(jx.pa.affinity_strip_pallas(
        jnp.asarray(fa), jnp.asarray(fall), dtype=jnp.float32,
        store_dtype=jnp.bfloat16 if bf16 else None).astype(jnp.float32))
    got = k1.affinity_strip_plain(T(fa), T(fall), torch.float32,
                                  torch.bfloat16 if bf16 else None)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(N(got), ref, atol=BF16_ULP if bf16 else 5e-5,
                               rtol=0)
    assert (got[-8:] == 0).all() and (got[:, -16:] == 0).all()
    assert (ref[-8:] == 0).all() and (ref[:40, -16:] == 0).all()


# --- K7-K10 at the 96- and 128-lane layouts ----------------------------------

@pytest.fixture(scope="module", params=PATCHES, ids=lambda p: f"{p}x{p}")
def wider(jx, request):
    """The layouts of 9 x 9 or 11 x 11 features: p 500 sample rows (p_pad
    512) against 2048 pixel columns (the last 64 padding), the aug pair
    from the reference's aug_pads, the plain fa and f32 norms, and seeded
    vectors; handed to both packages bit for bit. The port's aug_pads gives
    the same feature and unit lanes bit for bit, and the same norms (hi +
    mid + lo) within the error bound of a d-term f32 sum of positive terms
    in another order (d x 2^-24 relative)."""
    jnp, pst = jx.jnp, jx.pst
    patch = request.param
    d, lanes = patch * patch, LANES[patch]
    f = _features(patch, 32, 64)
    rng = np.random.default_rng(patch)
    p, n = 500, f.shape[0]
    fa = f[rng.choice(n, p, replace=False)]
    _, p_pad = pst.p_tiling(p)
    assert (p_pad, pst.d_pad_of(d), pst.aug_d_pad_of(d)) == (512, lanes, lanes)
    fa_aug, f_t = pst.aug_pads(jnp.asarray(fa), jnp.asarray(f), n)
    ta, tt = rl.aug_pads(T(fa), T(f), n)
    assert tuple(ta.shape) == (512, lanes) and tuple(tt.shape) == (lanes, n)
    # fa's norm lanes are its columns d..d+2, f_t's its rows d+3..d+5
    for got, ref, norm in ((N(ta), N(fa_aug), slice(d, d + 3)),
                           (N(tt).T, N(f_t).T, slice(d + 3, d + 6))):
        keep = np.ones(got.shape[1], bool)
        keep[norm] = False
        np.testing.assert_array_equal(got[:, keep], ref[:, keep])
        np.testing.assert_allclose(got[:, norm].astype(np.float64).sum(1),
                                   ref[:, norm].astype(np.float64).sum(1),
                                   rtol=d * 2.0 ** -24, atol=0)
    fa_pad = np.zeros((p_pad, lanes), np.float32)
    fa_pad[:p, :d] = N(T(fa, torch.bfloat16))
    bm = (rng.random(n) > 0.2).astype(np.float32)
    bm[-64:] = 0.0                               # padding columns
    t2 = np.zeros((2, p_pad), np.float32)
    t2[:, :p] = rng.uniform(0.5, 1.5, (2, p))
    na = np.zeros(p_pad, np.float32)
    na[:p] = np.sum(fa * fa, axis=1)
    gr = np.zeros((p_pad, pst.M_PAD), np.float32)
    gr[:p, :20] = rng.normal(size=(p, 20))
    return SimpleNamespace(
        p=p, fa_aug=fa_aug, f_t=f_t, fa_pad=fa_pad, bm=bm, t2=t2,
        t=t2[0].copy(), na=na, nb=np.sum(f * f, axis=1).astype(np.float32),
        gr=gr, s_pre=(rng.uniform(0.0, 1.5, n) * bm).astype(np.float32),
        y=rng.normal(size=n).astype(np.float32),
        cols=rng.uniform(0.0, 1.5, n).astype(np.float32))


def test_k7_plain_matches_pallas_at_96_and_128_lanes(jx, wider):
    x = wider
    ft, cols = x.f_t[:, :1024], x.cols[:1024]
    ref = N(jx.pst.kb_strip_pallas(x.fa_aug, ft, jx.jnp.asarray(cols),
                                   aug=True))
    got = k79.kb_strip_plain(_bf(x.fa_aug), _bf(ft), T(cols), True)
    np.testing.assert_allclose(N(got), ref, atol=2.0 ** -7, rtol=0)
    assert np.mean(N(got) == ref) > 0.99
    g_ref = N(jx.pst.gram_pallas(x.fa_aug, ft, jx.jnp.asarray(cols), 512,
                                 aug=True))
    g = k79.gram_plain(_bf(x.fa_aug), _bf(ft), T(cols), True)
    assert_rel(N(g), g_ref, 2e-2)


def test_k8_plain_matches_pallas_at_96_and_128_lanes(jx, wider):
    jnp, x = jx.jnp, wider
    u_r, s_r = jx.pst.ext2_matvec_pallas(x.fa_aug, x.f_t, jnp.asarray(x.t2),
                                         jnp.asarray(x.bm), aug=True)
    u, s = k79.ext2_matvec_plain(_bf(x.fa_aug), _bf(x.f_t), T(x.t2), T(x.bm),
                                 True)
    assert_rel(N(u), N(u_r), 2e-2)
    assert_rel(N(s), N(s_r), 2e-2)
    assert (N(s)[x.bm == 0] == 0).all()


def test_k9_plain_matches_pallas_at_96_and_128_lanes(jx, wider):
    """K9 reads the plain fa with the aug f_t superset."""
    jnp, x = jx.jnp, wider
    ref = jx.pst.finish_colstats_pallas(
        jnp.asarray(x.fa_pad).astype(jnp.bfloat16), x.f_t,
        jnp.asarray(x.t), jnp.asarray(x.s_pre), jnp.asarray(x.bm),
        jnp.asarray(x.gr), jnp.asarray(x.y), jnp.asarray(x.na),
        jnp.asarray(x.nb))
    got = k79.finish_colstats_plain(
        T(x.fa_pad, torch.bfloat16), _bf(x.f_t), T(x.t), T(x.s_pre),
        T(x.bm), T(x.gr), T(x.y), T(x.na), T(x.nb))
    for g, r in zip(got, ref):
        assert_rel(N(g), N(r), 5e-3)
    assert float(got[0][:, 20:].abs().max()) == 0.0
    assert (N(got[3])[x.bm == 0] == 0).all()


def test_k10_plain_matches_pallas_at_96_and_128_lanes(jx, wider):
    jnp, x = jx.jnp, wider
    ref = jx.pst.colstats_v_pallas(
        jnp.asarray(x.fa_pad).astype(jnp.bfloat16), x.f_t, jnp.asarray(x.gr),
        jnp.asarray(x.y), jnp.asarray(x.cols), jnp.asarray(x.na),
        jnp.asarray(x.nb))
    got = k79.colstats_v_plain(
        T(x.fa_pad, torch.bfloat16), _bf(x.f_t), T(x.gr), T(x.y), T(x.cols),
        T(x.na), T(x.nb))
    for g, r in zip(got, ref):
        assert_rel(N(g), N(r), 5e-3)
    assert float(got[0][:, 20:].abs().max()) == 0.0


# --- the slices at 9 x 9 and 11 x 11 -----------------------------------------

@pytest.fixture(scope="module")
def img_noisy():
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return img, noisy.astype(np.float32)


def config2_wide(patch):
    """bench.make_workload's recipe (config 2: strip_cache, bf16 store,
    coarse Sinkhorn + one polish, sketch o206 p0) at ``patch`` x ``patch``,
    cut to 96x96 as chip_smoke.small_strip cuts it (block_cols the frame,
    coarse 1/4)."""
    return gt.CONFIG2.replace(
        patch_size=patch, streaming=True, strip_cache=True,
        block_cols=96 * 96, use_pallas=True,
        affinity_dtype="bfloat16_store", sinkhorn_iters=6, solver="sketch",
        sketch_oversample=206, sketch_power=0, sinkhorn_coarse=4,
        sinkhorn_polish=1)


def config4_wide(patch):
    """Config 4's fused recipe (bf16 tiles, coarse Sinkhorn and gram, one
    polish, fused finish, LOBPCG) at ``patch`` x ``patch``, on the 96x96
    shape of tests/test_torch_recompute.py's slice."""
    return PipelineConfig(
        kernel="nlm", patch_size=patch, h=0.25, sample_rho=0.03,
        num_eigvecs=16, sinkhorn_iters=4, streaming=True, block_cols=2048,
        use_pallas=True, sinkhorn_coarse=4, sinkhorn_polish=1, gram_coarse=4,
        fused_finish=True, affinity_dtype="bfloat16")


def _assert_slice(img, z, vals, ref):
    db, atol = SLICE_BARS
    assert z.shape == ref.image.shape and np.isfinite(z).all()
    np.testing.assert_allclose(z, ref.image, atol=atol)
    d = abs(gt.psnr(img, z) - gt.psnr(img, ref.image))
    assert d <= db, f"port vs reference PSNR delta {d:.4f} dB"
    np.testing.assert_allclose(vals[0], ref.eigvals[0], rtol=1e-2)


@pytest.mark.parametrize("spatial_h", [0.0, 8.0])
@pytest.mark.parametrize("patch", PATCHES)
def test_config2_slice_at_9x9_and_11x11_matches_reference(jx, img_noisy,
                                                          patch, spatial_h):
    """The strip_cache slice at 81 and 121 lanes, the reference's Omega
    injected: its strip is K1's 96- or 128-lane split cross, then K2-K4 (no
    feature axis). With spatial_h 8 it is recipe A at the patch
    (chip_smoke.make_workload_cfg2_bilateral(gt, patch)): 83 or 123 lanes,
    84 or 124 live, K1's 96- or 128-lane coordinate cross."""
    img, noisy = img_noisy
    cfg = config2_wide(patch).replace(spatial_h=spatial_h)
    plan = gt.make_plan(noisy, cfg)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
    om = np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0),
                                         (plan.p, k), jx.jnp.float32))
    with torch_threads(2):
        z, vals = _filter_channel(torch.tensor(noisy),
                                  interop.idx_to_device(plan.idx_a, "cpu"),
                                  cfg, interop.block_to_device(om, "cpu"))
    _assert_slice(img, z.numpy(), vals.numpy(), ref)


def test_config4_slice_at_11x11_matches_reference(jx, img_noisy):
    """The fused recompute slice at the 128-lane layouts (K7, K8, K9 on the
    card), the reference's LOBPCG start block injected."""
    img, noisy = img_noisy
    cfg = config4_wide(11)
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(torch.tensor(noisy),
                         interop.idx_to_device(plan.idx_a, "cpu"), cfg)
    assert (ctx.fa_aug.shape[1] == ctx.f_t.shape[0] == ctx.fa_pad.shape[1]
            == 128)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    x0 = np.asarray(jx.jax.random.normal(
        jx.jax.random.PRNGKey(0), (plan.p, cfg.num_eigvecs), jx.jnp.float32))
    z, vals = _filter_channel(torch.tensor(noisy),
                              interop.idx_to_device(plan.idx_a, "cpu"), cfg,
                              x0=interop.block_to_device(x0, "cpu"))
    _assert_slice(img, z.numpy(), vals.numpy(), ref)


def matvec_recipe(which, patch):
    """(config, clean image, noisy image) of a matvec recipe at ``patch`` x
    ``patch``, resolved at full size and cut as chip_smoke.py's small runs
    cut it: config 3's per-channel sharpen (tuned_config(CONFIG3) at 1024^2
    RGB: bf16 aug tiles) at 48x48x3, noise 0.03 seed 3; the 8 MP matvec
    denoise (tuned_config(denoise_tuned(., 0.1)) at 2048x4096: f32 tiles)
    at 96x96, noise 0.1 seed 1."""
    if which == "sharpen":
        full = gt.tuned_config(gt.CONFIG3.replace(
            streaming=True, block_cols=131072, patch_size=patch),
            1024 * 1024, "fast")
        img = gt.make_test_image(48, 48, channels=3)
        noisy = np.clip(gt.add_gaussian_noise(img, 0.03, seed=3), 0, 1)
        return (full.replace(sample_rho=0.05, block_cols=1152,
                             sinkhorn_coarse=4), img,
                noisy.astype(np.float32))
    base = PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=10, filter_name="identity",
        streaming=True, block_cols=131072, affinity_dtype="bfloat16",
        patch_size=patch)
    full = gt.tuned_config(gt.denoise_tuned(base, 0.1), 2048 * 4096, "fast")
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return (full.replace(sample_rho=0.05, block_cols=2048, sinkhorn_coarse=4),
            img, noisy.astype(np.float32))


@pytest.mark.parametrize("which,patch", [("sharpen", 9), ("denoise", 11)],
                         ids=["config3-9x9", "matvec-denoise-11x11"])
def test_matvec_slice_at_9x9_and_11x11_matches_reference(jx, which, patch):
    """The exact-matvec slices past 64 lanes: config 3's sharpen at 9 x 9
    (the 96-lane aug K5/K6, six each a call) and the 8 MP matvec denoise at
    11 x 11 (the 128-lane f32 K5/K6, two each) against
    graphlap_tpu.filter_image, on the CPU with no launch; the port on two
    threads (``torch_threads``)."""
    cfg, img, noisy = matvec_recipe(which, patch)
    aug = cfg.affinity_dtype == "bfloat16"
    assert cfg.filter_mode == "matvec" and aug == (which == "sharpen")
    plan = gt.make_plan(noisy, cfg)
    chan = noisy[..., 0] if noisy.ndim == 3 else noisy
    before = [k56.matvec_cuda.launches, k56.rmatvec_cuda.launches]
    with torch_threads(2):
        ctx = tms._strip_ctx(torch.tensor(chan),
                             interop.idx_to_device(plan.idx_a, "cpu"), cfg)
        res = gt.filter_image(noisy, cfg, plan=plan, device="cpu")
    assert ctx.f_t.shape[0] == LANES[patch] and (ctx.fa_aug is not None) == aug
    assert [k56.matvec_cuda.launches, k56.rmatvec_cuda.launches] == before
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    db, atol = SLICE_BARS if aug else (0.02, 2e-3)
    assert res.image.shape == ref.image.shape == noisy.shape
    assert np.isfinite(res.image).all()
    np.testing.assert_allclose(res.image, ref.image, atol=atol)
    d = abs(gt.psnr(img, res.image) - gt.psnr(img, ref.image))
    assert d <= db, f"port vs reference PSNR delta {d:.5f} dB"


# --- on the card: the 96- and 128-lane kernels against their plain versions --

@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4100])      # 4100: the ragged rows
@pytest.mark.parametrize("patch", PATCHES)
def test_k1_at_81_and_121_lanes_matches_plain(cuda_device, patch, n):
    """K1's 96- and 128-lane instantiations on NLM-scale features, p 200
    (two 128-row blocks, the second ragged), both stores, poison rows exact
    zeros."""
    d = patch * patch
    rng = np.random.default_rng(n + d)
    dev = cuda_device
    fa = torch.tensor(rng.random((200, d), np.float32) * 0.5, device=dev)
    fa[-8:] = 1e3
    fall = torch.tensor(rng.random((n, d), np.float32) * 0.5, device=dev)
    for store, tol in ((torch.bfloat16, BF16_ULP), (None, 5e-5)):
        before = k1.affinity_strip_cuda.launches
        got = _twice(k1.affinity_strip_cuda, fa, fall, torch.float32, store)
        assert k1.affinity_strip_cuda.launches == before + 2
        ref = k1.affinity_strip_plain(fa, fall, torch.float32, store)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= tol
        assert bool((got[-8:] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4100])      # 4100: the ragged rows
@pytest.mark.parametrize("patch", PATCHES)
def test_k1_coordinate_cross_at_83_and_123_lanes_matches_plain(cuda_device,
                                                               patch, n):
    """K1's 96- and 128-lane coordinate kernel (recipe A at 9 x 9 and 11 x
    11: the patch and (row, col) / 8, 84 and 124 live lanes) on p 200 rows
    (two 128-row blocks, the second ragged) and n pixels whose span of
    n x d floats is split among the loader's threads by its float quotient:
    both stores against the plain version, twice bit for bit, poison rows
    exact zeros. Bars: one bf16 ulp on the bf16 store (an entry flips where
    the two f32 values straddle a rounding boundary), 16 f32 ulps of max
    |f|^2 on the f32 store (the f32 tile bar of
    tests/test_torch_bilateral.py): the FFMA chain and the plain f32
    product round the cancellation apart."""
    d = patch * patch + 2
    rng = np.random.default_rng(n + d)
    dev = cuda_device

    def feats(k):
        # patch lanes close together (d2 under ~0.05 from them), pixels of
        # the grid's far corner, so entries near each sample row live
        f = np.empty((k, d), np.float32)
        f[:, :-2] = rng.random((k, d - 2)) * 0.05
        f[:, -2:] = rng.integers(448, 512, (k, 2)) / 8.0
        return torch.tensor(f, device=dev)
    fa, fall = feats(200), feats(n)
    fa[-8:] = 1e3
    f32_bar = 16 * 2.0 ** -23 * float((fall * fall).sum(1).max())
    for store, tol in ((torch.bfloat16, BF16_ULP), (None, f32_bar)):
        before = k1.affinity_strip_cuda.launches
        got = _twice(k1.affinity_strip_cuda, fa, fall, torch.float32, store,
                     True)
        assert k1.affinity_strip_cuda.launches == before + 2
        ref = k1.affinity_strip_plain(fa, fall, torch.float32, store, True)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert float(ref.float().max()) > 0.5          # live entries
        diff = float((got.float() - ref.float()).abs().max())
        print(f"K1 coordinate cross, d {d}, n {n}, store {store}: max |diff| "
              f"{diff:.3e} (bar {tol:.3e})")
        assert diff <= tol
        assert bool((got[-8:] == 0).all())


def _wider_case(dev, d, p, n, m, seed):
    """Layouts of d feature lanes on the card: normal features at the scale
    of the 32- and 64-lane gpu tests, and the fused finish's vectors."""
    rng = np.random.default_rng(seed)
    tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fa, fp = tt(rng.normal(0, 0.3, (p, d))), tt(rng.normal(0, 0.3, (n, d)))
    fa_aug, f_t = rl.aug_pads(fa, fp, n)
    p_pad = fa_aug.shape[0]
    assert fa_aug.shape[1] == f_t.shape[0] == (96 if d <= 90 else 128)
    fa_pad = torch.zeros_like(fa_aug)
    fa_pad[:p, :d] = fa.to(torch.bfloat16)
    bm = tt(rng.random(n) > 0.2)
    t2 = torch.zeros((2, p_pad), device=dev)
    t2[:, :p] = tt(rng.uniform(0.5, 1.5, (2, p)))
    gr = torch.zeros((p_pad, tms._m_kernel(m)), device=dev)
    gr[:p, :m] = tt(rng.normal(size=(p, m)))
    na = torch.zeros(p_pad, device=dev)
    na[:p] = torch.sum(fa * fa, dim=1)
    return SimpleNamespace(
        fa_aug=fa_aug, f_t=f_t, fa_pad=fa_pad, bm=bm, t2=t2, gr=gr, na=na,
        nb=torch.sum(fp * fp, dim=1), y=tt(rng.normal(size=n)),
        cols=tt(rng.uniform(0, 1.5, n)))


@pytest.mark.gpu
@pytest.mark.parametrize("p,s", [(500, 128 * 133), (4000, 16384)])
@pytest.mark.parametrize("d", [81, 121])
def test_k7_at_96_and_128_lanes_matches_plain(cuda_device, d, p, s):
    """K7's 96- and 128-lane instantiations where its units do not divide
    evenly over the resident blocks."""
    x = _wider_case(cuda_device, d, p, s, 16, seed=p + s + d)
    before = k79.kb_strip_cuda.launches
    got = _twice(k79.kb_strip_cuda, x.fa_aug, x.f_t, x.cols, True)
    assert k79.kb_strip_cuda.launches == before + 2
    ref = k79.kb_strip_plain(x.fa_aug, x.f_t, x.cols, True)
    assert float((got.float() - ref.float()).abs().max()) <= 1.5 * 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(4000, 77056), (1000, 33024)],
                         ids=["p4096", "p1024"])
@pytest.mark.parametrize("d", [81, 121])
def test_k8_at_96_and_128_lanes_matches_plain(cuda_device, d, p, n):
    """K8's 96- and 128-lane instantiations (their entries from kb_pair,
    not the table) at p_pad 4096 and 1024, column tiles that do not divide
    evenly over the clusters. u against the f64 sum of the same bf16 tile
    entries times the kernel's own s, and s against the f64 evaluation of
    its function on those entries, lean to neither side."""
    x = _wider_case(cuda_device, d, p, n, 16, seed=p + n + d)
    args = (x.fa_aug, x.f_t, x.t2, x.bm, True)
    before = k79.ext2_matvec_cuda.launches
    got = _twice(k79.ext2_matvec_cuda, *args)
    assert k79.ext2_matvec_cuda.launches == before + 2
    ref = k79.ext2_matvec_plain(*args)
    assert max(map(_rel_err, got, ref)) <= 2e-2
    u, s = got
    u64 = torch.zeros_like(u, dtype=torch.float64)
    t2r = x.t2.to(torch.bfloat16).double()
    kbt = torch.zeros((2, n), dtype=torch.float64, device=cuda_device)
    for j in range(0, n, 16384):
        kb = k79._tile_plain(x.fa_aug, x.f_t[:, j:j + 16384], True).double()
        u64 += kb @ s[j:j + 16384].double()
        kbt[:, j:j + 16384] = t2r @ kb
    below = float((u.double() - u64)[:p].lt(0).double().mean())
    assert 0.25 < below < 0.75, below
    s64 = x.bm.double() / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    d_s = (s.double() - s64)[x.bm > 0]
    d_s = d_s[d_s != 0]
    below = float((d_s < 0).double().mean())
    assert 0.25 < below < 0.75, below


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m", [(4000, 16384, 50), (1000, 33024, 128)])
@pytest.mark.parametrize("d", [81, 121])
def test_k9_k10_at_96_and_128_lanes_match_plain(cuda_device, d, p, n, m):
    """K9 (ks pass, then the V pass) and K10 (the V pass alone) at 96 and
    128 lanes, the fa stages in dynamic shared memory; m 128 is two V
    launches, s computed once."""
    x = _wider_case(cuda_device, d, p, n, m, seed=p + m + d)
    args = (x.fa_pad, x.f_t, x.t2[0].contiguous(), x.bm * 0.7, x.bm, x.gr,
            x.y, x.na, x.nb)
    got = _twice(k79.finish_colstats_cuda, *args)
    ref = k79.finish_colstats_plain(*args)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 5e-3
    args = (x.fa_pad, x.f_t, x.gr, x.y, x.cols, x.na, x.nb)
    v, norms, coeffs = _twice(k79.colstats_v_cuda, *args)
    v_r = k79.colstats_v_plain(*args)[0]
    assert float((v - v_r).abs().max()) <= 2.0 ** -7 * float(v_r.abs().max())
    keep = v_r != 0
    below = float((((v - v_r) * torch.sign(v_r))[keep] < 0).float().mean())
    assert 0.25 < below < 0.75, below
