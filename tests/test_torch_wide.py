"""The 64-lane feature layout of graphlap_tpu_torch: an NLM 7 x 7 patch
(49 lanes, d_pad 64; the aug layout's 55 lanes padded to 64) through K1
and K7-K10. Each plain version against its Pallas kernel (interpret mode
on the CPU, the reference's own CPU route), config 2's strip_cache recipe
and config 4's fused recipe at 7 x 7 on a 96x96 frame against
graphlap_tpu.filter_image with the reference's random draws injected
(torch cannot redraw jax.random.normal(PRNGKey(0))), and, on a CUDA card
only (marker ``gpu``), each 64-lane kernel against its plain version,
launched twice bit for bit.

The bars are those of the 32-lane tests of the same kernels and slices:
* K1 (tests/test_torch_kernels.py): 5e-5 absolute on the f32 store, one
  bf16 ulp (2^-8) on the bf16 store; poison rows and columns exact zeros.
* K7 (tests/test_torch_recompute.py): two bf16 ulps (2^-7) absolute, 99%
  of the entries equal; the gram to 2e-2 of its max.
* K8: u and s to 2e-2 of their max; K9: every output to 5e-3 of its max
  (tests/test_pallas.py's bf16 bars).
* K10: K9's bar, each output to 5e-3 of its max: its V pass is K9's. (The
  32-lane test's atol 2e-3 on V sits above its inputs' max |V|, 1.4e-4,
  and would check nothing on 7 x 7 features, where max |V| is ~50.)
* The slices: 0.05 dB, atol 2e-2, the top eigenvalue to rtol 1e-2
  (tests/test_torch_pipeline.py, tests/test_torch_recompute.py).
On the card (as the 32-lane gpu tests): K1 one bf16 ulp / 5e-5, K7 1.5 x
2^-7, K8 2e-2, K9 5e-3 of max, K10 V 2^-7 of max |V| with its lean in
(0.25, 0.75).
"""

from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.models.pipeline import _filter_channel
from graphlap_tpu_torch.ops import _build
from graphlap_tpu_torch.ops import affinity as taff
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_matvec as k56
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.utils import interop

PATCH = 7
D = PATCH * PATCH                 # 49 feature lanes
BF16_ULP = 2.0 ** -8
SLICE_BARS = (0.05, 2e-2)         # dB, atol: the bf16 slices' bars


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
    from graphlap_tpu.ops import pallas_affinity as pa
    from graphlap_tpu.ops import pallas_streaming as pst
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, pa=pa, pst=pst,
                           cfg=lambda c: JaxConfig(**c.to_dict()))


@contextmanager
def torch_threads(n):
    """torch's CPU ops on ``n`` threads for the block. Beside busy
    neighbours (the test workers share the box's cores) torch's default
    thread count, one a core, makes its LAPACK calls wait on one another:
    a 150 x 150 eigh took 1.2 s on 8 threads and 2 ms on 2, a Cholesky
    solve at p 4608 2.5 s and 0.05 s (five workers of matrix products
    beside them). Alone on the box, 2 threads cost the staged test's two
    port runs 22 s in place of 9 s on 8."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


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


def _features(h=64, w=64, kernel_h=0.25):
    """7 x 7 NLM features of the noisy test image (config 4's h), as f32
    numpy (h w, 49)."""
    img = np.clip(gt.add_gaussian_noise(gt.make_test_image(h, w), 0.1,
                                        seed=1), 0, 1).astype(np.float32)
    cfg = PipelineConfig(kernel="nlm", patch_size=PATCH, h=kernel_h)
    f = taff.extract_features(torch.tensor(img), cfg).numpy()
    assert f.shape == (h * w, D)
    return f


# --- K1 at 49 lanes ----------------------------------------------------------

@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_k1_plain_matches_pallas_at_49_lanes(jx, store):
    """K1 on 7 x 7 features (config 2's h 0.15) with the strip path's
    poison rows (+1e3) and columns (-1e3): the entry to 5e-5 (f32 store)
    or one bf16 ulp, and the poisoned rows and columns exactly zero."""
    jnp = jx.jnp
    f = _features(24, 30, kernel_h=0.15)
    fa = np.concatenate([f[::18][:40], np.full((8, D), 1e3, np.float32)])
    fall = np.concatenate([f, np.full((16, D), -1e3, np.float32)])
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


# --- K7-K10 at the 64-lane aug layout ----------------------------------------

@pytest.fixture(scope="module")
def wide(jx):
    """The 64-lane layouts of 7 x 7 features: p 500 sample rows (p_pad 512)
    against 4096 pixel columns (the last 64 padding), the aug pair from the
    reference's aug_pads, the plain fa and f32 norms, and seeded vectors;
    handed to both packages bit for bit. The port's aug_pads gives the same
    feature and unit lanes bit for bit, and the same norms (hi + mid + lo)
    within the error bound of a 49-term f32 sum of positive terms in
    another order (49 x 2^-24 relative): it sums the squares lane after
    lane, XLA in its own order."""
    jnp, pst = jx.jnp, jx.pst
    f = _features()
    rng = np.random.default_rng(7)
    p, n = 500, f.shape[0]
    fa = f[rng.choice(n, p, replace=False)]
    _, p_pad = pst.p_tiling(p)
    assert (p_pad, pst.d_pad_of(D), pst.aug_d_pad_of(D)) == (512, 64, 64)
    fa_aug, f_t = pst.aug_pads(jnp.asarray(fa), jnp.asarray(f), n)
    ta, tt = rl.aug_pads(T(fa), T(f), n)
    assert tuple(ta.shape) == (512, 64) and tuple(tt.shape) == (64, n)
    # fa's norm lanes are its columns d..d+2, f_t's its rows d+3..d+5
    for got, ref, lanes in ((N(ta), N(fa_aug), slice(D, D + 3)),
                            (N(tt).T, N(f_t).T, slice(D + 3, D + 6))):
        keep = np.ones(got.shape[1], bool)
        keep[lanes] = False
        np.testing.assert_array_equal(got[:, keep], ref[:, keep])
        np.testing.assert_allclose(got[:, lanes].astype(np.float64).sum(1),
                                   ref[:, lanes].astype(np.float64).sum(1),
                                   rtol=D * 2.0 ** -24, atol=0)
    fa_pad = np.zeros((p_pad, 64), np.float32)
    fa_pad[:p, :D] = N(T(fa, torch.bfloat16))
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


def _bf(x):
    return T(N(x), torch.bfloat16)


def test_k7_plain_matches_pallas_at_64_lanes(jx, wide):
    x = wide
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


def test_k8_plain_matches_pallas_at_64_lanes(jx, wide):
    jnp, x = jx.jnp, wide
    u_r, s_r = jx.pst.ext2_matvec_pallas(x.fa_aug, x.f_t, jnp.asarray(x.t2),
                                         jnp.asarray(x.bm), aug=True)
    u, s = k79.ext2_matvec_plain(_bf(x.fa_aug), _bf(x.f_t), T(x.t2), T(x.bm),
                                 True)
    assert_rel(N(u), N(u_r), 2e-2)
    assert_rel(N(s), N(s_r), 2e-2)
    assert (N(s)[x.bm == 0] == 0).all()


def test_k9_plain_matches_pallas_at_64_lanes(jx, wide):
    """K9 reads the plain 64-lane fa with the aug f_t superset."""
    jnp, x = jx.jnp, wide
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


def test_k10_plain_matches_pallas_at_64_lanes(jx, wide):
    jnp, x = jx.jnp, wide
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


# --- the two slices at 7 x 7 -------------------------------------------------

@pytest.fixture(scope="module")
def img_noisy():
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return img, noisy.astype(np.float32)


def config2_p7():
    """bench.make_workload's recipe (config 2: strip_cache, bf16 store,
    coarse Sinkhorn + one polish, sketch o206 p0) at 7 x 7, cut to 96x96 as
    chip_smoke.small_strip cuts it (block_cols the frame, coarse 1/4)."""
    return gt.CONFIG2.replace(
        patch_size=PATCH, streaming=True, strip_cache=True,
        block_cols=96 * 96, use_pallas=True,
        affinity_dtype="bfloat16_store", sinkhorn_iters=6, solver="sketch",
        sketch_oversample=206, sketch_power=0, sinkhorn_coarse=4,
        sinkhorn_polish=1)


def config4_p7():
    """Config 4's fused recipe (bf16 tiles, coarse Sinkhorn and gram, one
    polish, fused finish, LOBPCG) at 7 x 7, on the 96x96 shape of
    tests/test_torch_recompute.py's slice."""
    return PipelineConfig(
        kernel="nlm", patch_size=PATCH, h=0.25, sample_rho=0.03,
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
def test_config2_slice_at_7x7_matches_reference(jx, img_noisy, spatial_h):
    """The strip_cache slice at 49 lanes, the reference's Omega injected:
    its strip is K1's, then K2-K4 (no feature axis). With spatial_h 8 it is
    recipe A (tuned_config(CONFIG2.replace(patch_size=7, spatial_h=8.0),
    512*512, "fast"), chip_smoke.make_workload_cfg2_bilateral): 51 lanes,
    52 live, K1's coordinate cross; that recipe loses PSNR in the
    reference too (scripts/reference_quality.py), so only the slice
    without it is held to a gain."""
    img, noisy = img_noisy
    cfg = config2_p7().replace(spatial_h=spatial_h)
    plan = gt.make_plan(noisy, cfg)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
    om = np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0),
                                         (plan.p, k), jx.jnp.float32))
    z, vals = _filter_channel(torch.tensor(noisy),
                              interop.idx_to_device(plan.idx_a, "cpu"), cfg,
                              interop.block_to_device(om, "cpu"))
    _assert_slice(img, z.numpy(), vals.numpy(), ref)
    if spatial_h == 0.0:
        assert gt.psnr(img, z.numpy()) > gt.psnr(img, noisy) + 1.0


def test_config4_slice_at_7x7_matches_reference(jx, img_noisy):
    """The fused recompute slice at the 64-lane layouts (K7, K8, K9 on the
    card), the reference's LOBPCG start block injected."""
    img, noisy = img_noisy
    cfg = config4_p7()
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(torch.tensor(noisy),
                         interop.idx_to_device(plan.idx_a, "cpu"), cfg)
    assert ctx.fa_aug.shape[1] == ctx.f_t.shape[0] == ctx.fa_pad.shape[1] == 64
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    x0 = np.asarray(jx.jax.random.normal(
        jx.jax.random.PRNGKey(0), (plan.p, cfg.num_eigvecs), jx.jnp.float32))
    z, vals = _filter_channel(torch.tensor(noisy),
                              interop.idx_to_device(plan.idx_a, "cpu"), cfg,
                              x0=interop.block_to_device(x0, "cpu"))
    _assert_slice(img, z.numpy(), vals.numpy(), ref)


def test_config4_staged_at_7x7_matches_reference(jx):
    """The staged (unfused) schedule of config 4's 8 MP recipe at 7 x 7,
    on a 256 x 512 frame: the polish through the 64-lane aug K5/K6, the
    cross through K7, LOBPCG, colstats through K10, the reference's LOBPCG
    start block injected, against graphlap_tpu.filter_image_staged (the
    bf16 slice bars). At 7 x 7 the unfused schedule parts from the fused
    one in the reference as in the port (both gaps printed, ~0.27 dB here,
    ~0.01 at 5 x 5), so chip_smoke.py holds the staged run on the card to
    its own plain path, not to filter_image. The frame stays: on every
    smaller frame tried (128 x 256 to 256 x 448 and 240 x 480) the
    reference's 7 x 7 gap is at most 7.6x its 5 x 5 one (0.026-0.12 dB at
    5 x 5), where this frame parts them by 27x. The port's runs take two
    threads (``torch_threads``)."""
    from graphlap_tpu_torch.models.pipeline import _filter_streaming_staged

    img = gt.make_test_image(256, 512)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0,
                    1).astype(np.float32)
    cfg = PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=6, filter_name="identity",
        streaming=True, block_cols=65536, affinity_dtype="bfloat16",
        use_pallas=True, sinkhorn_coarse=64, gram_coarse=64,
        sinkhorn_polish=1, fused_finish=True, patch_size=PATCH)
    plan = gt.make_plan(noisy, cfg)
    x0 = np.asarray(jx.jax.random.normal(
        jx.jax.random.PRNGKey(0), (plan.p, cfg.num_eigvecs), jx.jnp.float32))
    ref = jx.gl.filter_image_staged(noisy, jx.cfg(cfg), plan=plan)
    with torch_threads(2):
        res = _filter_streaming_staged(noisy, cfg, plan, "cpu",
                                       x0=interop.block_to_device(x0, "cpu"))
        fused = _filter_channel(torch.tensor(noisy),
                                interop.idx_to_device(plan.idx_a, "cpu"), cfg,
                                x0=interop.block_to_device(x0, "cpu"))[0]
    _assert_slice(img, res.image, res.eigvals, ref)
    fused = fused.numpy()
    ref_fused = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan).image
    gaps = [abs(gt.psnr(img, a) - gt.psnr(img, b))
            for a, b in ((res.image, fused), (ref.image, ref_fused))]
    print(f"config 4 at 7x7, 256x512: staged vs fused {gaps[0]:.4f} dB in "
          f"the port, {gaps[1]:.4f} dB in the reference")
    assert abs(gaps[0] - gaps[1]) <= SLICE_BARS[0]


# --- the wrappers' widths ------------------------------------------------------

WRAPPERS = (k1.affinity_strip_cuda, k79.kb_strip_cuda, k79.ext2_matvec_cuda,
            k79.finish_colstats_cuda, k79.colstats_v_cuda, k56.matvec_cuda,
            k56.rmatvec_cuda)


def _recompute_call(which, lanes, dtype, live=None):
    """One wrapper of K7-K10 (``which``) on zero layouts of ``lanes`` feature
    lanes and ``dtype``, p_pad 512, 1024 columns, ``live`` lanes read."""
    p, n, aug = 512, 1024, dtype == torch.bfloat16
    fa = torch.zeros((p, lanes), dtype=dtype)
    f_t = torch.zeros((lanes, n), dtype=dtype)
    vp, vn, gr = torch.ones(p), torch.ones(n), torch.zeros((p, 64))
    calls = {
        "kb_strip": lambda: k79.kb_strip_cuda(fa, f_t, vn, aug, live),
        "ext2_matvec": lambda: k79.ext2_matvec_cuda(
            fa, f_t, torch.ones((2, p)), vn, aug, live),
        "finish_colstats": lambda: k79.finish_colstats_cuda(
            fa, f_t, vp, vn, vn, gr, vn, vp, vn, live=live),
        "colstats_v": lambda: k79.colstats_v_cuda(fa, f_t, gr, vn, vn, vp,
                                                  vn, live=live),
    }
    return calls[which]()


@pytest.mark.parametrize("which", ["kb_strip", "ext2_matvec",
                                   "finish_colstats", "colstats_v"])
def test_k7_k10_take_every_depth_on_both_layouts(monkeypatch, which):
    """On a CUDA tensor K7-K10 take 32, 64, 96 and 128 feature lanes (NLM
    5 x 5 to 11 x 11) on the bf16 layout and on the f32 one (with 52, 84
    and 124 live lanes: an NLM 7 x 7, 9 x 9 or 11 x 11 patch and the
    coordinates), which reach the kernel library (here missing); widths
    that are no layout, and live lanes past the layout's, raise ValueError;
    none launches."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k79, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    before = [w.launches for w in WRAPPERS]
    bf, f32 = torch.bfloat16, torch.float32
    for lanes, live in ((64, 52), (96, 84), (128, 124)):
        with pytest.raises(RuntimeError, match="unavailable"):
            _recompute_call(which, lanes, bf)
        with pytest.raises(RuntimeError, match="unavailable"):
            _recompute_call(which, lanes, f32, live=live)
    with pytest.raises(ValueError, match="feature lanes"):
        _recompute_call(which, 160, bf)
    with pytest.raises(ValueError, match="feature lanes"):
        _recompute_call(which, 160, f32)
    for lanes in (64, 128):
        with pytest.raises(ValueError, match="live lanes"):
            _recompute_call(which, lanes, f32, live=lanes + 1)
    assert [w.launches for w in WRAPPERS] == before


def test_k5_k6_take_128_lanes_on_every_layout(monkeypatch):
    """On a CUDA tensor K5/K6 take the bf16 aug and f32 layouts at 64, 96
    and 128 lanes (NLM 7 x 7, 9 x 9, 11 x 11: the aug layout's 55, 87 and
    127 lanes, the f32 one's 49, 81 and 121, each padded), and the
    coordinate kernel on the f32 layouts at 64, 96 and 128 lanes (52, 84
    and 124 live: a 7 x 7, 9 x 9 or 11 x 11 patch and the coordinates),
    which reach the kernel library (here missing); live lanes past the
    layout's raise ValueError, the plain-bf16 and f32-aug layouts
    NotImplementedError saying no queue ports them; none launches."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k56, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    before = [w.launches for w in WRAPPERS]
    for aug, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        for d, lanes in ((D, 64), (81, 96), (121, 128)):
            if aug:
                fa, f_t = rl.aug_pads(torch.zeros((100, d)),
                                      torch.zeros((1000, d)), 1024)
            else:
                fa = torch.zeros((512, rl.d_pad_of(d)))
                f_t = torch.zeros((rl.d_pad_of(d), 1024))
            assert fa.shape[1] == f_t.shape[0] == lanes and fa.dtype == dtype
            with pytest.raises(RuntimeError, match="unavailable"):
                k56.matvec_cuda(fa, f_t, torch.ones(1024), aug)
            with pytest.raises(RuntimeError, match="unavailable"):
                k56.rmatvec_cuda(fa, f_t, torch.ones(512), aug)
    for lanes, live in ((64, 51), (96, 83), (128, 123)):
        fa, f_t = torch.zeros((512, lanes)), torch.zeros((lanes, 1024))
        with pytest.raises(RuntimeError, match="unavailable"):
            k56.matvec_cuda(fa, f_t, torch.ones(1024), False, live=live,
                            coords=True)
        with pytest.raises(RuntimeError, match="unavailable"):
            k56.rmatvec_cuda(fa, f_t, torch.ones(512), False, live=live + 1,
                             coords=True)
        with pytest.raises(ValueError, match="live lanes"):
            k56.matvec_cuda(fa, f_t, torch.ones(1024), False,
                            live=lanes + 1, coords=True)
        # the plain bf16 and the f32 aug layouts: no queue ports them
        for dtype, aug in ((torch.bfloat16, False), (torch.float32, True)):
            with pytest.raises(NotImplementedError, match="no ROADMAP.md"):
                k56.matvec_cuda(fa.to(dtype), f_t.to(dtype),
                                torch.ones(1024), aug)
    assert [w.launches for w in WRAPPERS] == before


# --- on the card: the 64-lane kernels against their plain versions -----------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _twice(fn, *args):
    """Two launches on the same inputs, equal bit for bit; the first."""
    a, b = fn(*args), fn(*args)
    a_t, b_t = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    for x, y in zip(a_t, b_t):
        assert torch.equal(x, y)
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4096, 4100])      # 4100: the ragged rows
def test_k1_at_49_lanes_matches_plain(cuda_device, n):
    """K1's 64-lane instantiation on 7 x 7-scale features, p 200 (two
    128-row blocks, the second ragged), both stores, poison rows exact
    zeros."""
    rng = np.random.default_rng(n)
    dev = cuda_device
    fa = torch.tensor(rng.random((200, D), np.float32) * 0.5, device=dev)
    fa[-8:] = 1e3
    fall = torch.tensor(rng.random((n, D), np.float32) * 0.5, device=dev)
    for store, tol in ((torch.bfloat16, BF16_ULP), (None, 5e-5)):
        before = k1.affinity_strip_cuda.launches
        got = _twice(k1.affinity_strip_cuda, fa, fall, torch.float32, store)
        assert k1.affinity_strip_cuda.launches == before + 2
        ref = k1.affinity_strip_plain(fa, fall, torch.float32, store)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert float((got.float() - ref.float()).abs().max()) <= tol
        assert bool((got[-8:] == 0).all())


def _wide_case(dev, p, n, m, seed):
    """64-lane layouts on the card: normal features at the scale of the
    32-lane gpu tests, 49 lanes, and the fused finish's vectors."""
    rng = np.random.default_rng(seed)
    tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fa, fp = tt(rng.normal(0, 0.3, (p, D))), tt(rng.normal(0, 0.3, (n, D)))
    fa_aug, f_t = rl.aug_pads(fa, fp, n)
    p_pad = fa_aug.shape[0]
    assert fa_aug.shape[1] == f_t.shape[0] == 64
    fa_pad = torch.zeros_like(fa_aug)
    fa_pad[:p, :D] = fa.to(torch.bfloat16)
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
def test_k7_at_64_lanes_matches_plain(cuda_device, p, s):
    """K7's 64-lane instantiation where its units do not divide evenly over
    the resident blocks."""
    x = _wide_case(cuda_device, p, s, 16, seed=p + s)
    before = k79.kb_strip_cuda.launches
    got = _twice(k79.kb_strip_cuda, x.fa_aug, x.f_t, x.cols, True)
    assert k79.kb_strip_cuda.launches == before + 2
    ref = k79.kb_strip_plain(x.fa_aug, x.f_t, x.cols, True)
    assert float((got.float() - ref.float()).abs().max()) <= 1.5 * 2.0 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(4000, 77056), (1000, 33024)],
                         ids=["p4096", "p1024"])
def test_k8_at_64_lanes_matches_plain(cuda_device, p, n):
    """K8's 64-lane instantiation at p_pad 4096 (its shared memory at the
    limit) and 1024, column tiles that do not divide evenly over the
    clusters. u's sum does not lean to one side of the f64 sum of the same
    bf16 tile entries times the kernel's own s (against the plain version
    u carries the differences of the plain s too; s's own lean is held by
    test_k8_s_does_not_lean)."""
    x = _wide_case(cuda_device, p, n, 16, seed=p + n)
    args = (x.fa_aug, x.f_t, x.t2, x.bm, True)
    before = k79.ext2_matvec_cuda.launches
    got = _twice(k79.ext2_matvec_cuda, *args)
    assert k79.ext2_matvec_cuda.launches == before + 2
    ref = k79.ext2_matvec_plain(*args)
    assert max(map(_rel_err, got, ref)) <= 2e-2
    u, s = got
    u64 = torch.zeros_like(u, dtype=torch.float64)
    for j in range(0, n, 16384):
        kb = k79._tile_plain(x.fa_aug, x.f_t[:, j:j + 16384], True)
        u64 += kb.double() @ s[j:j + 16384].double()
    below = float((u.double() - u64)[:p].lt(0).double().mean())
    assert 0.25 < below < 0.75, below


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m", [(4000, 16384, 50), (1000, 33024, 128)])
def test_k9_k10_at_64_lanes_match_plain(cuda_device, p, n, m):
    """K9 (ks pass, then the V pass) and K10 (the V pass alone) at 64
    lanes; m 128 is two V launches, s computed once."""
    x = _wide_case(cuda_device, p, n, m, seed=p + m)
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


def _k8_synthetic(dev, d, p, n):
    """scripts/k8_lean.py's synthetic case: normal(0, 0.3) features of d
    lanes on the aug layouts, the fused finish's t2 and bm."""
    rng = np.random.default_rng(p + n)
    tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fa_aug, f_t = rl.aug_pads(tt(rng.normal(0, 0.3, (p, d))),
                              tt(rng.normal(0, 0.3, (n, d))), n)
    bm = tt(rng.random(n) > 0.2)
    t2 = torch.zeros((2, fa_aug.shape[0]), device=dev)
    t2[:, :p] = tt(rng.uniform(0.5, 1.5, (2, p)))
    return fa_aug, f_t, t2, bm


@pytest.mark.gpu
@pytest.mark.parametrize("d,p,n", [(25, 4000, 77056), (49, 4000, 77056),
                                   (49, 1000, 33024), (81, 4000, 77056),
                                   (121, 4000, 77056)],
                         ids=["32-p4096", "64-p4096", "64-p1024", "96-p4096",
                              "128-p4096"])
def test_k8_s_does_not_lean(cuda_device, d, p, n):
    """K8's s against the f64 evaluation of its function on the same bf16
    tile entries (bf16 t2, kbt and s in f64), on scripts/k8_lean.py's
    synthetic features at 32 to 128 lanes: the share of columns below lies
    in (0.4, 0.6), ties left out. One truncating mma chain over a warp's
    16-row blocks put it above on ~97% of the columns at p_pad 4096; one
    mma a 16-row block, whose products span orders of magnitude, still on
    0.52 to 0.81 from 32 to 128 lanes, until kbt moved to the FP32 pipe."""
    fa_aug, f_t, t2, bm = _k8_synthetic(cuda_device, d, p, n)
    _, s = k79.ext2_matvec_cuda(fa_aug, f_t, t2, bm, True)
    t2r = t2.to(torch.bfloat16).double()
    kbt = torch.zeros((2, n), dtype=torch.float64, device=cuda_device)
    for j in range(0, n, 16384):
        kb = k79._tile_plain(fa_aug, f_t[:, j:j + 16384], True).double()
        kbt[:, j:j + 16384] = t2r @ kb
    s64 = bm.double() / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    d_s = (s.double() - s64)[bm > 0]
    d_s = d_s[d_s != 0]
    below = float((d_s < 0).double().mean())
    assert 0.4 < below < 0.6, below


@pytest.mark.gpu
def test_k9_v_parts_at_64_lanes(cuda_device):
    """K9 at 64 lanes, its V error in two parts: the ks pass's s against
    the plain s (where bf16(s) lands on the other neighbour it scales a
    whole V row by one bf16 ulp), and the V pass against the plain V formed
    from the kernel's own s. Both printed; V within 2^-7 of max |V| (the
    bar of chip_smoke.py's K9 rows), the V pass alone within 5e-3."""
    x = _wide_case(cuda_device, 4000, 65536, 50, seed=4050)
    args = (x.fa_pad, x.f_t, x.t2[0].contiguous(), x.bm * 0.7, x.bm, x.gr,
            x.y, x.na, x.nb)
    v, _, _, s = k79.finish_colstats_cuda(*args)
    v_p, _, _, s_p = k79.finish_colstats_plain(*args)
    v_s = k79.colstats_v_plain(x.fa_pad, x.f_t, x.gr, x.y, s, x.na, x.nb)[0]
    vmax = float(v_p.abs().max())
    s_rel = _rel_err(s, s_p)
    flips = float((s.to(torch.bfloat16) != s_p.to(torch.bfloat16))
                  .float().mean())
    v_pass = float((v - v_s).abs().max()) / vmax
    v_rel = float((v - v_p).abs().max()) / vmax
    print(f"K9 at 64 lanes: s {s_rel:.3e} of max |s|, bf16(s) flips on "
          f"{flips:.3e} of the columns; V {v_rel:.3e} of max |V|, the V pass "
          f"on its own s {v_pass:.3e}")
    assert v_pass <= 5e-3
    assert v_rel <= 2.0 ** -7
