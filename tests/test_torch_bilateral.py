"""The bilateral 8 MP denoise of graphlap_tpu_torch against graphlap_tpu:
``tuned_config(CONFIG1.replace(streaming=True, sample_cap=4096), 2048*4096,
"fast")`` — a gaussian kernel with a spatial term (features y/h, row/8,
col/8: three live lanes of a 32-lane f32 layout), f32 tiles, coarse
Sinkhorn and gram, one polish, LOBPCG, the fused finish — at 96x96 with the
same recipe written out (the preset turns the decimations off at that
size), through ``filter_image`` (fused finish: K8, K7, K9) and through the
unfused schedule and ``filter_image_staged`` (the polish's f32 K5/K6 with
the coordinate cross, K7, K10), with the reference's LOBPCG start block
injected; the f32 K7-K10 plain versions on coordinate-scale features
against the Pallas kernels (interpret mode on the CPU, as
tests/test_pallas.py runs them); the context's live lanes and coordinate
flag and the wrappers' routing of them. On a CUDA card only (marker
``gpu``): each f32 kernel against its plain version and an f64 evaluation,
K1 and the f32 K5/K6 on coordinates against f64, and the 96x96 slice on
the card against the plain versions on the CPU.

Tolerances:
* Whole slice: <= 0.02 dB and atol 2e-3, the f32 bars (PERF.md section 2;
  tests/test_streaming.py:258).
* f32 tiles on coordinate-scale features (|f|^2 up to ~1.2e4 here): two
  correct f32 evaluations of na + nb - 2 cross in another order differ by
  a few ulps of |f|^2, and |dK/dd2| = K <= 1, so tile entries are held to
  F32_TILE = 16 ulps of max |f|^2 (times the largest column scale), and
  the sums to that bar relative to the sum of their terms' magnitudes.
* On the card, against an f64 evaluation of the same tile: the kernel's
  max and p99 |dK| at most 1.5x the plain f32 version's (the f32
  cancellation error itself is the scale; a kernel-vs-plain bar on tile
  entries would measure two roundings of it).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.models.pipeline import (_filter_channel,
                                                _filter_streaming_staged)
from graphlap_tpu_torch.ops import _build
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_matvec as k56
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.utils import interop
from tests.test_torch_wide import torch_threads

BARS = (0.02, 2e-3)
EPS32 = 2.0 ** -23
MP8 = 2048 * 4096


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
    from graphlap_tpu.ops import pallas_streaming as pst
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, pst=pst,
                           cfg=lambda c: JaxConfig(**c.to_dict()))


def T(x):
    return torch.tensor(np.asarray(x, np.float32))


def N(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype("float32"))


def _cfg(**kw):
    """The bilateral 8 MP recipe at 96x96: CONFIG1's kernel and bandwidths,
    f32 tiles, coarse Sinkhorn and gram 1/4, one polish, LOBPCG, m = 50."""
    cfg = dict(kernel="gaussian", h=0.2, spatial_h=8.0, sample_rho=0.05,
               num_eigvecs=50, sinkhorn_iters=6, filter_name="identity",
               streaming=True, block_cols=2048, use_pallas=True,
               affinity_dtype="float32", sinkhorn_coarse=4,
               sinkhorn_polish=1, gram_coarse=4, solver="lobpcg",
               fused_finish=True)
    cfg.update(kw)
    return PipelineConfig(**cfg)


@pytest.fixture(scope="module")
def img_noisy():
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return img, noisy.astype(np.float32)


def _x0(jx, p, m):
    return np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0), (p, m),
                                           jx.jnp.float32))


def assert_bars(img, got, ref):
    db, atol = BARS
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=atol)
    d = abs(gt.psnr(img, got) - gt.psnr(img, ref))
    assert d <= db, f"port vs reference PSNR delta {d:.4f} dB"


# --- the recipe ----------------------------------------------------------------

def test_preset_resolves_the_bilateral_recipe():
    """tuned_config sends the bilateral streaming config to f32 tiles at 8
    MP with the decimations, the polish and the fused finish this slice
    ports (tests/test_presets.py pins the f32 route in the reference)."""
    cfg = gt.tuned_config(gt.CONFIG1.replace(streaming=True,
                                             sample_cap=4096), MP8, "fast")
    assert (cfg.kernel, cfg.spatial_h) == ("gaussian", 8.0)
    assert cfg.affinity_dtype == cfg.feature_dtype == "float32"
    assert cfg.use_pallas and cfg.fused_finish and cfg.solver == "lobpcg"
    assert (cfg.sinkhorn_coarse, cfg.sinkhorn_iters, cfg.sinkhorn_polish,
            cfg.gram_coarse) == (64, 6, 1, 64)
    assert (cfg.num_eigvecs, cfg.filter_name) == (50, "identity")
    tms.check_slice(cfg)


def test_context_records_live_lanes_and_coordinates(img_noisy):
    _, noisy = img_noisy
    cfg = _cfg()
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(T(noisy), interop.idx_to_device(plan.idx_a, "cpu"),
                         cfg)
    assert (ctx.live, ctx.coords) == (4, True)
    assert ctx.fa_aug is None and ctx.f_t.dtype == torch.float32
    assert tuple(ctx.f_t.shape) == (32, ctx.n_pad)
    assert float(ctx.f_t[3:].abs().max()) == 0.0      # the pad lanes
    assert tms._fused_finish_ok(ctx, cfg)
    nlm = tms._strip_ctx(T(noisy), interop.idx_to_device(plan.idx_a, "cpu"),
                         cfg.replace(kernel="nlm", spatial_h=0.0, h=0.25))
    assert (nlm.live, nlm.coords) == (28, False)


# the recipes at 96x96, written out as the presets resolve them at 8 MP
# (the decimations cut to fit): the gaussian bilateral recipe; recipe B, an
# NLM 7 x 7 patch with the spatial term (h 0.15, 52 live lanes of 64,
# chip_smoke.make_workload_8mp_nlm_bilateral); recipe C, its matvec twin
# (denoise_tuned(0.1): h 0.1, the operator filter by K5/K6)
RECIPES = {
    "gaussian": dict(),
    "nlm7": dict(kernel="nlm", h=0.15, patch_size=7),
    "nlm7_matvec": dict(kernel="nlm", h=0.1, patch_size=7,
                        filter_mode="matvec", fused_finish=False),
}
# (live lanes, the matvec filter's K5/K6 calls a run) of each recipe
RECIPE_LANES = {"gaussian": 4, "nlm7": 52, "nlm7_matvec": 52}


@pytest.fixture(scope="module", params=list(RECIPES))
def reference(jx, img_noisy, request):
    """graphlap_tpu's fused and staged runs of a recipe, and its LOBPCG
    start block."""
    _, noisy = img_noisy
    cfg = _cfg(**RECIPES[request.param])
    plan = gt.make_plan(noisy, cfg)
    fused = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    unfused_cfg = cfg.replace(fused_finish=False)
    unfused = jx.gl.filter_image(noisy, jx.cfg(unfused_cfg), plan=plan)
    staged = jx.gl.filter_image_staged(noisy, jx.cfg(unfused_cfg), plan=plan)
    return SimpleNamespace(name=request.param, cfg=cfg, plan=plan,
                           fused=fused, unfused=unfused, staged=staged,
                           live=RECIPE_LANES[request.param],
                           x0=T(_x0(jx, plan.p, cfg.num_eigvecs)))


def _spy(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(module, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(module, name, spy)
    return calls


def _ktilde_seen(monkeypatch):
    """The (live lanes, coordinate flag) of each ktilde_apply call (the
    polish and the operator filter's K5 + K6)."""
    seen = []
    real = tms.ktilde_apply
    monkeypatch.setattr(tms, "ktilde_apply",
                        lambda ctx, s: seen.append((ctx.live, ctx.coords))
                        or real(ctx, s))
    return seen


def test_fused_recipe_matches_reference(img_noisy, reference, monkeypatch):
    """filter_image's schedule: K8, K7 + the f32 gram GEMM, LOBPCG, K9 on
    the spectral recipes; on recipe C (the matvec route) the polish and the
    filter, K5 + K6 twice, on the coordinate layout of 52 live lanes. The
    port's run takes two threads (``torch_threads``), as below."""
    img, noisy = img_noisy
    r = reference
    calls = _spy(monkeypatch, k79, ("ext2_matvec_plain", "kb_strip_plain",
                                    "finish_colstats_plain",
                                    "colstats_v_plain"))
    mv = _spy(monkeypatch, k56, ("matvec_plain", "rmatvec_plain"))
    seen = _ktilde_seen(monkeypatch)
    with torch_threads(2):
        z, vals = _filter_channel(T(noisy), interop.idx_to_device(
            r.plan.idx_a, "cpu"), r.cfg, x0=r.x0)
    if r.cfg.filter_mode == "matvec":
        assert calls == dict.fromkeys(calls, 0)
        assert mv == {"matvec_plain": 2, "rmatvec_plain": 2}
        assert seen == [(r.live, True)] * 2
    else:
        assert calls == {"ext2_matvec_plain": 1, "kb_strip_plain": 1,
                         "finish_colstats_plain": 1, "colstats_v_plain": 0}
        assert mv == {"matvec_plain": 0, "rmatvec_plain": 0} and seen == []
        np.testing.assert_allclose(vals[0].numpy(), r.fused.eigvals[0],
                                   rtol=1e-2)
    assert_bars(img, z.numpy(), r.fused.image)


@pytest.mark.parametrize("route", ["unfused", "staged"])
def test_unfused_recipe_matches_reference(img_noisy, reference, monkeypatch,
                                          route):
    """The unfused schedule (filter_image with fused_finish off, and
    filter_image_staged): the coarse loop, rmatvec2, the polish through
    K5 + K6 with the coordinate flag, K7, LOBPCG, K10; on recipe C the
    polish and the operator filter, K5 + K6 twice, and no K7-K10."""
    img, noisy = img_noisy
    r = reference
    cfg = r.cfg.replace(fused_finish=False)
    mv = _spy(monkeypatch, k56, ("matvec_plain", "rmatvec_plain"))
    calls = _spy(monkeypatch, k79, ("kb_strip_plain", "colstats_v_plain",
                                    "ext2_matvec_plain"))
    seen = _ktilde_seen(monkeypatch)
    with torch_threads(2):
        if route == "staged":
            res = _filter_streaming_staged(noisy, cfg, r.plan, "cpu",
                                           x0=r.x0)
            got, ref = res.image, r.staged.image
            assert set(res.timings) == {"normalize", "eigensolve", "filter"}
        else:
            z, _ = _filter_channel(T(noisy), interop.idx_to_device(
                r.plan.idx_a, "cpu"), cfg, x0=r.x0)
            got, ref = z.numpy(), r.unfused.image
    k56_calls = 2 if cfg.filter_mode == "matvec" else 1
    assert mv == {"matvec_plain": k56_calls, "rmatvec_plain": k56_calls}
    assert calls == {"kb_strip_plain": 2 - k56_calls,
                     "colstats_v_plain": 2 - k56_calls,
                     "ext2_matvec_plain": 0}
    assert seen == [(r.live, True)] * k56_calls
    assert_bars(img, got, ref)


# recipes B (fused) and C past 64 lanes at 96x96: an NLM 11 x 11 patch with
# the spatial term (124 live lanes of 128) and its 9 x 9 matvec twin (84 of
# 96), chip_smoke.make_workload_8mp_nlm_bilateral(gt, 11) and
# make_workload_8mp_nlm_bilateral_matvec(gt, 9) written out as above
WIDE_RECIPES = {
    "nlm11": (dict(kernel="nlm", h=0.15, patch_size=11), 124),
    "nlm9_matvec": (dict(kernel="nlm", h=0.1, patch_size=9,
                         filter_mode="matvec", fused_finish=False), 84),
}


@pytest.mark.parametrize("name", list(WIDE_RECIPES))
def test_wide_recipe_matches_reference(jx, img_noisy, monkeypatch, name):
    """filter_image on the 96- and 128-lane f32 coordinate layouts against
    graphlap_tpu.filter_image at the f32 bars: recipe B at 11 x 11 (K8, K7,
    LOBPCG, K9 once each), recipe C at 9 x 9 (the polish and the filter,
    K5 + K6 twice, with the coordinate cross); the reference's LOBPCG start
    block injected, the port's run on two threads (``torch_threads``)."""
    img, noisy = img_noisy
    kw, live = WIDE_RECIPES[name]
    cfg = _cfg(**kw)
    plan = gt.make_plan(noisy, cfg)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    calls = _spy(monkeypatch, k79, ("ext2_matvec_plain", "kb_strip_plain",
                                    "finish_colstats_plain",
                                    "colstats_v_plain"))
    mv = _spy(monkeypatch, k56, ("matvec_plain", "rmatvec_plain"))
    seen = _ktilde_seen(monkeypatch)
    with torch_threads(2):
        z, _ = _filter_channel(T(noisy), interop.idx_to_device(
            plan.idx_a, "cpu"), cfg, x0=T(_x0(jx, plan.p, cfg.num_eigvecs)))
    if cfg.filter_mode == "matvec":
        assert calls == dict.fromkeys(calls, 0)
        assert mv == {"matvec_plain": 2, "rmatvec_plain": 2}
        assert seen == [(live, True)] * 2
    else:
        assert calls == {"ext2_matvec_plain": 1, "kb_strip_plain": 1,
                         "finish_colstats_plain": 1, "colstats_v_plain": 0}
        assert mv == {"matvec_plain": 0, "rmatvec_plain": 0} and seen == []
    assert_bars(img, z.numpy(), ref.image)


# --- the f32 K7-K10 plain versions on coordinate-scale features --------------

def _coord_inputs(jx, seed=7, p=300, n=1024, m=50, kind="gaussian",
                  corner=(448, 448)):
    """Features as a bilateral recipe builds them, on coordinates in [448,
    512): |f|^2 up to ~1.2e4, neighbours within 64 px so most tile entries
    are live; the reference's f32 plain layout. ``kind`` "gaussian": (y/h,
    row/8, col/8), 3 lanes of 32; "nlm7": the reference's own features of
    recipe B (graphlap_tpu.ops.affinity.extract_features, an NLM 7 x 7
    patch at h 0.15 and row/8, col/8) on a 64 x 64 noisy image, its
    coordinates moved to the far corner of a 512 x 512 one: 51 lanes, 52
    live, of 64; "nlm11": the same with an NLM 11 x 11 patch, 123 lanes,
    124 live, of 128 ("nlm9": 9 x 9, 83 lanes, 84 live, of 96). ``corner``:
    where the NLM kinds' 64 x 64 image sits (its top-left pixel's row and
    column)."""
    jnp, pst = jx.jnp, jx.pst
    rng = np.random.default_rng(seed)
    if kind.startswith("nlm"):
        from graphlap_tpu.ops.affinity import extract_features
        patch = int(kind[3:])
        img = np.clip(gt.add_gaussian_noise(gt.make_test_image(64, 64), 0.1,
                                            seed=seed), 0, 1)
        cfg = jx.cfg(_cfg(**dict(RECIPES["nlm7"], patch_size=patch)))
        allf = np.asarray(extract_features(jnp.asarray(img, jnp.float32),
                                           cfg)).copy()
        allf[:, patch * patch:] += np.asarray(corner, np.float32) / 8.0
        fa = allf[rng.choice(allf.shape[0], p, replace=False)]
        fp = allf[rng.choice(allf.shape[0], n, replace=False)]
    else:
        def feats(k):
            rc = rng.uniform(448, 512, (k, 2)) / 8.0
            return np.concatenate([rng.uniform(0, 5, (k, 1)), rc],
                                  axis=1).astype(np.float32)
        fa, fp = feats(p), feats(n)
    d = fa.shape[1]
    dp = pst.d_pad_of(d)
    _, p_pad = pst.p_tiling(p)
    fa_pad = jnp.zeros((p_pad, dp), jnp.float32).at[:p, :d].set(fa)
    f_t = jnp.zeros((dp, n), jnp.float32).at[:d, :].set(fp.T)
    bm = (rng.random(n) > 0.2).astype(np.float32)
    t2 = np.zeros((2, p_pad), np.float32)
    t2[:, :p] = rng.uniform(0.5, 1.5, (2, p))
    t = np.zeros(p_pad, np.float32)
    t[:p] = rng.uniform(0.5, 1.5, p)
    na = np.zeros(p_pad, np.float32)
    na[:p] = np.sum(fa * fa, axis=1)
    nb = np.sum(fp * fp, axis=1).astype(np.float32)
    gr = np.zeros((p_pad, 128), np.float32)    # K10's Pallas block: M_PAD
    gr[:p, :m] = rng.normal(0, 0.05, (p, m))
    tol = 16 * EPS32 * float(max(na.max(), nb.max()))
    return SimpleNamespace(
        fa_pad=fa_pad, f_t=f_t, bm=bm, t2=t2, t=t, na=na, nb=nb, gr=gr,
        s_pre=(rng.uniform(0.5, 1.5, n) * bm).astype(np.float32),
        y=rng.uniform(0, 1, n).astype(np.float32),
        cols=rng.uniform(0.5, 1.5, n).astype(np.float32), p=p, tol=tol,
        live=-(-d // 4) * 4)


COORD_KINDS = pytest.mark.parametrize("kind", ["gaussian", "nlm7", "nlm11"])


def _sum_bar(got, ref, terms, tol):
    """|got - ref| <= tol * (the sum of the terms' magnitudes), per entry."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert (err <= tol * np.asarray(terms, np.float64) + 1e-30).all(), (
        float((err / (np.asarray(terms) + 1e-30)).max()), tol)


@COORD_KINDS
def test_k7_f32_plain_matches_pallas_on_coordinates(jx, kind):
    x = _coord_inputs(jx, kind=kind)
    ref = N(jx.pst.kb_strip_pallas(x.fa_pad, x.f_t[:, :512],
                                   jx.jnp.asarray(x.cols[:512])))
    got = k79.kb_strip_plain(T(N(x.fa_pad)), T(N(x.f_t[:, :512])),
                             T(x.cols[:512]), False, x.live)
    assert got.dtype == torch.float32
    assert np.abs(ref[:x.p]).max() > 0.5          # live entries
    np.testing.assert_allclose(N(got), ref, rtol=0, atol=1.5 * x.tol)
    g_ref = N(jx.pst.gram_pallas(x.fa_pad, x.f_t[:, :512],
                                 jx.jnp.asarray(x.cols[:512]), 512))
    g = k79.gram_plain(T(N(x.fa_pad)), T(N(x.f_t[:, :512])), T(x.cols[:512]),
                       False, x.live)
    kb = np.abs(ref).astype(np.float64)
    _sum_bar(N(g), g_ref, 2 * kb @ kb.T, x.tol)


@pytest.mark.parametrize("kind", ["gaussian", "nlm7", "nlm9", "nlm11"])
def test_k8_f32_plain_matches_pallas_on_coordinates(jx, kind):
    jnp = jx.jnp
    x = _coord_inputs(jx, kind=kind)
    u_r, s_r = jx.pst.ext2_matvec_pallas(x.fa_pad, x.f_t, jnp.asarray(x.t2),
                                         jnp.asarray(x.bm))
    u, s = k79.ext2_matvec_plain(T(N(x.fa_pad)), T(N(x.f_t)), T(x.t2),
                                 T(x.bm), False, x.live)
    # s = bm / sqrt(kbt_r kbt_c): each kbt sum moves by at most tol of its
    # terms' magnitudes (all positive), so s by at most ~tol relative
    np.testing.assert_allclose(N(s), N(s_r), rtol=4 * x.tol, atol=0)
    kb = N(k79.kb_strip_plain(T(N(x.fa_pad)), T(N(x.f_t)),
                              torch.ones(x.bm.shape[0]), False))
    _sum_bar(N(u), N(u_r), 3 * np.abs(kb) @ np.abs(N(s_r)), 4 * x.tol)
    assert (N(s)[x.bm == 0] == 0).all()


@COORD_KINDS
def test_k9_k10_f32_plain_match_pallas_on_coordinates(jx, kind):
    jnp = jx.jnp
    x = _coord_inputs(jx, kind=kind)
    args_r = (x.fa_pad, x.f_t)
    gr64 = x.gr[:, :64]
    ref9 = jx.pst.finish_colstats_pallas(
        *args_r, jnp.asarray(x.t), jnp.asarray(x.s_pre), jnp.asarray(x.bm),
        jnp.asarray(gr64), jnp.asarray(x.y), jnp.asarray(x.na),
        jnp.asarray(x.nb))
    got9 = k79.finish_colstats_plain(
        T(N(x.fa_pad)), T(N(x.f_t)), T(x.t), T(x.s_pre), T(x.bm), T(gr64),
        T(x.y), T(x.na), T(x.nb), x.live)
    ref10 = jx.pst.colstats_v_pallas(
        *args_r, jnp.asarray(x.gr), jnp.asarray(x.y), jnp.asarray(x.cols),
        jnp.asarray(x.na), jnp.asarray(x.nb))
    got10 = k79.colstats_v_plain(
        T(N(x.fa_pad)), T(N(x.f_t)), T(x.gr), T(x.y), T(x.cols), T(x.na),
        T(x.nb), x.live)
    kb = np.abs(N(k79.kb_strip_plain(T(N(x.fa_pad)), T(N(x.f_t)),
                                     torch.ones(x.bm.shape[0]), False)))
    for got, ref, c, g in ((got9, ref9, N(ref9[3]), gr64),
                           (got10, ref10, x.cols, x.gr)):
        # V_j = sum_p c_j k_pj gr_p: each entry within tol of its terms
        terms = (np.abs(c)[:, None] * kb.T) @ np.abs(g)
        _sum_bar(N(got[0]), N(ref[0]), 3 * terms, 4 * x.tol)
        v = np.abs(N(ref[0])).astype(np.float64)
        _sum_bar(N(got[1]), N(ref[1]), 2 * (v * (v + terms)).sum(0) + 1e-12,
                 4 * x.tol)
        _sum_bar(N(got[2]), N(ref[2]), np.abs(x.y) @ (v + terms) + 1e-12,
                 4 * x.tol)
        assert float(np.abs(N(got[0])[:, 50:]).max()) == 0.0
    np.testing.assert_allclose(N(got9[3]), N(ref9[3]), rtol=4 * x.tol, atol=0)


def _split3(x, e):
    """x (f32) as its three bf16 parts on the grid 2^(e - 8), e broadcast
    (csrc split3_grid): b0 = x on the grid, b1 = bf16(x - b0), b2 =
    bf16(x - b0 - b1), as f32."""
    q, qi = torch.pow(2.0, 8.0 - e), torch.pow(2.0, e - 8.0)
    b0 = torch.round(x * q) * qi
    b1 = (x - b0).to(torch.bfloat16).float()
    return b0, b1, (x - b0 - b1).to(torch.bfloat16).float()


def _exp_of(m, lo=-100, hi=100):
    """The E of values whose largest |x| is m (m < 2^E), clamped (csrc
    grid_exp; the entries' scale takes lo -126, hi 1)."""
    e = torch.where(m > 0, torch.frexp(m)[1].float(), torch.tensor(-126.0))
    return e.clamp(lo, hi)


def _split_products(a, b):
    """sum_k a_k b_k of (., K) x (K, .) operands as the f32 K9 / K10 run it
    on the tensor cores, each row of a and each column of b in three bf16
    parts on its grid: the corrections a1 b0, a0 b1, a1 b1, a2 b0, a0 b2 in
    one chain (summed in f64 and rounded once: the truncation of their
    chain is 2^-8 of theirs), plus a0 b0 (exact), added in f32."""
    a0, a1, a2 = _split3(a, _exp_of(a.abs().amax(1, keepdim=True)))
    b0, b1, b2 = _split3(b, _exp_of(b.abs().amax(0, keepdim=True)))
    d = lambda x, y: x.double() @ y.double()  # noqa: E731
    corr = (d(a1, b0) + d(a0, b1) + d(a1, b1) + d(a2, b0) + d(a0, b2)).float()
    return d(a0, b0).float() + corr


def _tc_colstats(fa, f_t, gr, y, na, nb, lv, cols=None, finish=None):
    """The f32 K9 (``finish`` = (t, s_pre, bm)) / K10 of csrc
    colstats_tc_kernel, emulated in torch: each entry's cross an FFMA
    chain over the ``lv`` lanes in order, d2 and expf in f32; per 32-row
    stage each column's entries times 2^-E (E: its largest's exponent) in
    three bf16 parts on the grid 2^-8, B = [gr | t] in three parts on the
    grid of each column a stage, the stage's six part products summed from
    zero and joined to the running f32 sum on the larger of their
    exponents; s from ks (B's column 64), then V = s W (K10: c W). gr of
    64 columns. -> (V, norms, coeffs, s)."""
    cross = torch.zeros((fa.shape[0], f_t.shape[1]))
    for k in range(lv):    # fmaf in lane order
        cross = (fa[:, k:k + 1].double() * f_t[k:k + 1].double()
                 + cross.double()).float()
    d2 = torch.clamp((na[:, None] + nb[None, :]) - 2.0 * cross, min=0.0)
    k = torch.exp(-d2)                                    # (P, N)
    b = torch.zeros((fa.shape[0], 72))
    b[:, :64] = gr
    if finish is not None:
        b[:, 64] = finish[0]
    w = torch.zeros((f_t.shape[1], 72))            # W 2^-er
    er = torch.full((f_t.shape[1], 1), -126.0)
    for r0 in range(0, fa.shape[0], 32):
        ex = _exp_of(k[r0:r0 + 32].amax(0), -126, 1)[:, None]
        st = _split_products(k[r0:r0 + 32].T * torch.pow(2.0, -ex),
                             b[r0:r0 + 32])
        en = torch.maximum(er, ex)
        w = (w.double() * torch.pow(2.0, er - en).double()
             + st.double() * torch.pow(2.0, ex - en).double()).float()
        er = en
    ws = torch.pow(2.0, er)[:, 0]
    if finish is not None:
        t, s_pre, bm = finish
        c = torch.sqrt(s_pre / torch.clamp(w[:, 64] * ws, min=1e-30)) * bm
    else:
        c = cols
    v = w[:, :64] * (c * ws)[:, None]
    return v, torch.sum(v * v, dim=0), y @ v, c


@pytest.mark.parametrize("kind,corner", [
    ("gaussian", (448, 448)), ("nlm7", (448, 448)), ("nlm11", (448, 448)),
    ("nlm11", (1984, 4032))])    # 8 MP's far corner: |f|^2 to 3.3e5
def test_f32_colstats_split_scheme_holds_the_f32_sums(jx, kind, corner):
    """The f32 K9 / K10's scheme (csrc colstats_tc_kernel, emulated by
    ``_tc_colstats``: V and ks as six bf16 part products a 32-row stage) on
    recipe B's features: V, s, norms and coeffs
    against their f64 evaluation from the same f32 inputs, relative to the
    f64 sum of each output's terms' magnitudes, max and p99 within 1.5x the
    plain f32 version's (the f32 cancellation error of d2 is the scale:
    the scheme must not add to it); and against graphlap_tpu's Pallas
    kernels at f32 (interpret mode) within the bars the plain versions meet
    (test_k9_k10_f32_plain_match_pallas_on_coordinates)."""
    jnp = jx.jnp
    x = _coord_inputs(jx, kind=kind, corner=corner)
    fa, f_t = T(N(x.fa_pad)), T(N(x.f_t))
    na, nb = T(x.na), T(x.nb)
    lv = k79.coord_lanes(x.live, fa.shape[1])
    assert lv == (4 if kind == "gaussian" else fa.shape[1])
    nf = float(max(x.na.max(), x.nb.max()))
    assert nf > (3e5 if corner[0] > 448 else 8e3)
    gr64 = T(x.gr[:, :64])
    fin = (T(x.t), T(x.s_pre), T(x.bm))
    got9 = _tc_colstats(fa, f_t, gr64, T(x.y), na, nb, lv, finish=fin)
    got10 = [_tc_colstats(fa, f_t, T(x.gr[:, m0:m0 + 64]), T(x.y), na, nb,
                          lv, cols=T(x.cols))[:3] for m0 in (0, 64)]
    got10 = tuple(torch.cat(z, dim=z[0].dim() - 1) for z in zip(*got10))
    pl9 = k79.finish_colstats_plain(fa, f_t, *fin, gr64, T(x.y), na, nb)
    pl10 = k79.colstats_v_plain(fa, f_t, T(x.gr), T(x.y), T(x.cols), na, nb)

    # f64 from the same f32 inputs
    a, bb = fa.double(), f_t.double()
    k64 = torch.exp(-torch.clamp(na.double()[:, None] + nb.double()[None]
                                 - 2.0 * a @ bb, min=0.0))
    ks64 = fin[0].double() @ k64
    s64 = torch.sqrt(fin[1].double() / ks64.clamp(min=1e-30)) * fin[2].double()

    def err(got, ref, terms):
        keep = terms > 0
        e = ((got.double() - ref).abs() / terms)[keep]
        return float(e.max()), float(torch.quantile(e, 0.99))

    for got, pl, c, g in ((got9, pl9, s64, gr64), (got10, pl10,
                                                   T(x.cols).double(),
                                                   T(x.gr))):
        kc = k64 * c[None]
        v64 = kc.T @ g.double()
        vt = kc.abs().T @ g.double().abs()
        yv = T(x.y).double()
        live = g.abs().sum(0) > 0
        outs = ((got[0][:, live], pl[0][:, live], v64[:, live], vt[:, live]),
                (got[1][live], pl[1][live], (v64 * v64).sum(0)[live],
                 (v64 * v64).sum(0)[live]),
                (got[2][live], pl[2][live], (yv @ v64)[live],
                 (yv.abs() @ v64.abs())[live]))
        if len(got) == 4:
            outs += ((got[3], pl[3], s64, s64.abs()),)
        for o, (gv, pv, r64, terms) in enumerate(outs):
            (g_max, g_p99), (p_max, p_p99) = err(gv, r64, terms), err(
                pv, r64, terms)
            assert g_max <= 1.5 * p_max and g_p99 <= 1.5 * p_p99, (
                len(got), o, g_max, g_p99, p_max, p_p99)

    # against the Pallas kernels, within the plain versions' bars
    args_r = (x.fa_pad, x.f_t)
    ref9 = jx.pst.finish_colstats_pallas(
        *args_r, jnp.asarray(x.t), jnp.asarray(x.s_pre), jnp.asarray(x.bm),
        jnp.asarray(x.gr[:, :64]), jnp.asarray(x.y), jnp.asarray(x.na),
        jnp.asarray(x.nb))
    ref10 = jx.pst.colstats_v_pallas(
        *args_r, jnp.asarray(x.gr), jnp.asarray(x.y), jnp.asarray(x.cols),
        jnp.asarray(x.na), jnp.asarray(x.nb))
    kb = np.abs(N(k79.kb_strip_plain(fa, f_t, torch.ones(x.bm.shape[0]),
                                     False)))
    tol = 16 * EPS32 * nf
    for got, ref, c, g in ((got9, ref9, N(ref9[3]), x.gr[:, :64]),
                           (got10, ref10, x.cols, x.gr)):
        terms = (np.abs(c)[:, None] * kb.T) @ np.abs(g)
        _sum_bar(N(got[0]), N(ref[0]), 3 * terms, 4 * tol)
        v = np.abs(N(ref[0])).astype(np.float64)
        _sum_bar(N(got[1]), N(ref[1]), 2 * (v * (v + terms)).sum(0) + 1e-12,
                 4 * tol)
        _sum_bar(N(got[2]), N(ref[2]), np.abs(x.y) @ (v + terms) + 1e-12,
                 4 * tol)
        assert float(np.abs(N(got[0])[:, 50:]).max()) == 0.0
    np.testing.assert_allclose(N(got9[3]), N(ref9[3]), rtol=4 * tol, atol=0)


def _pair_tree(x, dim):
    """A butterfly's sum over ``dim`` (a power of two), as the kernels'
    __shfl_xor_sync trees give it: pairs (2m, 2m + 1) first, then pairs of
    pairs, each an f32 add."""
    while x.shape[dim] > 1:
        x = x.unflatten(dim, (-1, 2))
        x = x.select(dim + 1, 0) + x.select(dim + 1, 1)
    return x.squeeze(dim)


def _fma(a, b, c):
    """fmaf(a, b, c) in f32: the product exact in f64, one rounding of the
    sum (a second one from f64 only at a rounding tie)."""
    return (a.double() * b.double() + c.double()).float()


def _ffma_cross(fa, f_t, lv, rows=256):
    """(P, N) f32: each entry's cross an f32 FMA chain over the ``lv``
    lanes in lane order (in f64, rounded to f32 after every lane; blocks of
    ``rows`` rows stay in cache)."""
    a, b = fa.double(), f_t.double()
    out = torch.empty((fa.shape[0], f_t.shape[1]))
    for i in range(0, fa.shape[0], rows):
        c = torch.zeros((min(rows, fa.shape[0] - i), f_t.shape[1]),
                        dtype=torch.float64)
        c32 = torch.empty(c.shape)
        for k in range(lv):
            c.addcmul_(a[i:i + rows, k:k + 1], b[k:k + 1])
            c32.copy_(c)
            c.copy_(c32)
        out[i:i + rows] = c32
    return out


def _k8_tile_scheme(fa, f_t, t2, bm, lv, resident):
    """The f32 K8 of csrc ext2_f32_tile_kernel, emulated in torch: each
    entry's cross and norms FMA chains over the ``lv`` lanes in lane order,
    d2 one FMA, exp; ranks of RB rows (512, 256 at 128 lanes), threads of 8
    rows (4 TY apart in groups of 4) by 16 columns (4 TX apart) on tiles of
    TN = 16 TX columns, ``resident`` clusters walking the tiles in stride
    order. kbt: a thread's chain over its 8 rows from the first product, a
    butterfly over the warp's row threads, the 8 warps in order, the ranks
    in order; s = bm / sqrt(max(kbt_r kbt_c, 1e-30)); u: a thread's chain
    over its 16 columns a tile, a span sum joining its running sum every 64
    tiles of its cluster, a butterfly over the TX threads of a row, the
    clusters in order. -> (u, s)."""
    p, fd = fa.shape
    n = f_t.shape[1]
    rb = 256 if fd == 128 else 512
    ty_n, xcl = rb // 8, p // rb
    tx_n = 256 // ty_n
    tn = 16 * tx_n
    na = fa[:, 0] * fa[:, 0]
    nb = f_t[0] * f_t[0]
    for k in range(1, lv):
        na = _fma(fa[:, k], fa[:, k], na)
        nb = _fma(f_t[k], f_t[k], nb)
    cross = _ffma_cross(fa, f_t, lv)
    nab = na[:, None] + nb[None, :]
    d2 = torch.clamp(_fma(torch.tensor(-2.0), cross, nab), min=0.0)
    e = torch.exp(-d2.double()).float()                  # (P, N)
    del cross, nab, d2
    # kbt: rows of rank q as (g, ty, h): row = q rb + 4 ty_n g + 4 ty + h
    ev = e.view(xcl, 2, ty_n, 4, n)
    kbt = []
    for t in t2:
        tv = t.view(xcl, 2, ty_n, 4, 1)
        acc = tv[:, 0, :, 0] * ev[:, 0, :, 0]
        for g in range(2):
            for h in range(4):
                if g or h:
                    acc = _fma(tv[:, g, :, h], ev[:, g, :, h], acc)
        x = _pair_tree(acc.view(xcl, 8, ty_n // 8, n), 2)   # (xcl, 8, n)
        v = torch.zeros((xcl, n))
        for w in range(8):
            v = v + x[:, w]
        k = torch.zeros(n)
        for q in range(xcl):
            k = k + v[q]
        kbt.append(k)
    s = bm / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    # u: a tile's columns as (g, tx, h): col = t tn + 4 tx_n g + 4 tx + h
    tiles = n // tn
    es = e.view(p, tiles, 4, tx_n, 4)
    sv = s.view(1, tiles, 4, tx_n, 4)
    tu = es[:, :, 0, :, 0] * sv[:, :, 0, :, 0]
    for g in range(4):
        for h in range(4):
            if g or h:
                tu = _fma(es[:, :, g, :, h], sv[:, :, g, :, h], tu)
    ncl = min(resident, tiles)
    u = torch.zeros(p)
    for cid in range(ncl):
        mine = list(range(cid, tiles, ncl))
        run, span = torch.zeros((p, tx_n)), torch.zeros((p, tx_n))
        for i, t in enumerate(mine):
            span = span + tu[:, t]
            if (i + 1) % 64 == 0 or i + 1 == len(mine):
                run, span = run + span, torch.zeros((p, tx_n))
        u = u + _pair_tree(run, 1)
    return u, s


@pytest.mark.parametrize("kind", ["gaussian", "nlm7", "nlm9", "nlm11"])
def test_k8_f32_tile_scheme_holds_the_f32_sums(jx, kind):
    """The f32 K8's sum order (csrc ext2_f32_tile_kernel, emulated by
    ``_k8_tile_scheme``) on recipe B's features at 4, 52, 84 and 124 live
    lanes, p_pad 4096 and 2048 columns, with the clusters the H100 holds
    (15 of 8 blocks, 7 of 16 at 128 lanes): u and s against their f64
    evaluation from the same f32 inputs, max and p99 relative error within
    1.5x the plain f32 version's, and each one's share below f64 in (0.25,
    0.75)."""
    x = _coord_inputs(jx, kind=kind, p=4000, n=2048)
    fa, f_t = T(N(x.fa_pad)), T(N(x.f_t))
    t2, bm = T(x.t2), T(x.bm)
    assert fa.shape[0] == 4096
    lv = k79._lanes(x.live, fa.shape[1])
    got = _k8_tile_scheme(fa, f_t, t2, bm, lv, 7 if fa.shape[1] == 128 else 15)
    pl = k79.ext2_matvec_plain(fa, f_t, t2, bm)
    a, b = fa.double(), f_t.double()
    k64 = torch.exp(-torch.clamp((a * a).sum(1)[:, None] + (b * b).sum(0)[None]
                                 - 2.0 * a @ b, min=0.0))
    kbt = t2.double() @ k64
    s64 = bm.double() / torch.sqrt(torch.clamp(kbt[0] * kbt[1], min=1e-30))
    u64 = k64 @ s64

    def err(y, r):
        e = ((y.double() - r).abs() / r.abs())[r != 0]
        return float(e.max()), float(torch.quantile(e, 0.99))

    for g, pv, r64 in ((got[0][:x.p], pl[0][:x.p], u64[:x.p]),
                       (got[1], pl[1], s64)):
        (g_max, g_p99), (p_max, p_p99) = err(g, r64), err(pv, r64)
        assert g_max <= 1.5 * p_max and g_p99 <= 1.5 * p_p99, (
            g_max, g_p99, p_max, p_p99)
        d = ((g.double() - r64) * torch.sign(r64))[(r64 != 0)
                                                   & (g.double() != r64)]
        assert 0.25 < float((d < 0).double().mean()) < 0.75


def _f64_strip(fa, fb):
    a, b = fa.astype(np.float64), fb.astype(np.float64)
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    return np.exp(-np.maximum(d2, 0.0))


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["nlm9", "nlm11"])
def test_k1_plain_matches_pallas_on_coordinates_past_64_lanes(jx, kind,
                                                               store):
    """K1 on recipe A's features at 9 x 9 and 11 x 11 (83 and 123 lanes, the
    coordinates at |f|^2 ~ 1.2e4): the bf16 store to one bf16 ulp of the
    Pallas kernel's; the f32 store to the file's f32 tile bar (16 ulps of
    max |f|^2), and against an f64 evaluation of the same f32 features the
    plain version's max and p99 |dK| over the live entries within 1.5x the
    Pallas kernel's, the max plus one f32 ulp of max |f|^2 (two correct
    f32 evaluations differ by the cancellation error itself, whose quantum
    is that ulp: the largest errors measured 2 ulps against 1)."""
    from graphlap_tpu.ops import pallas_affinity as pa

    jnp = jx.jnp
    x = _coord_inputs(jx, kind=kind)
    d = 83 if kind == "nlm9" else 123
    fa = N(x.fa_pad)[:x.p, :d]
    fb = np.ascontiguousarray(N(x.f_t)[:d].T)
    bf16 = store == "bfloat16"
    ref = np.asarray(pa.affinity_strip_pallas(
        jnp.asarray(fa), jnp.asarray(fb), dtype=jnp.float32,
        store_dtype=jnp.bfloat16 if bf16 else None).astype(jnp.float32))
    got = k1.affinity_strip_plain(T(fa), T(fb), torch.float32,
                                  torch.bfloat16 if bf16 else None, True)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    r64 = _f64_strip(fa, fb)
    live = r64 > 1e-6
    assert live.mean() > 0.1
    if bf16:
        np.testing.assert_allclose(N(got), ref, atol=2.0 ** -8, rtol=0)
        return

    np.testing.assert_allclose(N(got), ref, atol=x.tol, rtol=0)

    def stats(k):
        e = np.abs(k.astype(np.float64) - r64)[live]
        return e.max(), np.quantile(e, 0.99)
    plain, pallas = stats(N(got)), stats(ref)
    ulp = EPS32 * float(max(x.na.max(), x.nb.max()))
    assert (plain[0] <= 1.5 * pallas[0] + ulp
            and plain[1] <= 1.5 * pallas[1]), (plain, pallas, ulp)


# --- dispatch --------------------------------------------------------------------

def _f32_layouts(p=300, n=1024, d=3, fd=32):
    rng = np.random.default_rng(3)
    fa = torch.zeros((512, fd))
    fa[:p, :d] = T(rng.uniform(0, 60, (p, d)))
    f_t = torch.zeros((fd, n))
    f_t[:d] = T(rng.uniform(0, 60, (d, n)))
    return fa, f_t


def _f32_cases(fa, f_t, live, d):
    n, pp = f_t.shape[1], fa.shape[0]
    one = lambda k: torch.ones(k)  # noqa: E731
    return [
        (k79.kb_strip_cuda, (fa, f_t, one(n), False, live)),
        (k79.ext2_matvec_cuda, (fa, f_t, torch.ones((2, pp)), one(n), False,
                                live)),
        (k79.finish_colstats_cuda, (fa, f_t, one(pp), one(n), one(n),
                                    torch.ones((pp, 64)), one(n), one(pp),
                                    one(n), live)),
        (k79.colstats_v_cuda, (fa, f_t, torch.ones((pp, 64)), one(n), one(n),
                               one(pp), one(n), live)),
        (k56.matvec_cuda, (fa, f_t, one(n), False, live, True)),
        (k56.rmatvec_cuda, (fa, f_t, one(pp), False, live, True)),
        (k1.affinity_strip_cuda, (fa[:300, :d], f_t[:d].T.contiguous(),
                                  torch.float32, None, True)),
    ]


@pytest.mark.parametrize("d,fd", [(3, 32), (51, 64), (83, 96), (123, 128)])
def test_f32_cuda_layouts_reach_the_library(monkeypatch, d, fd):
    """On CUDA tensors the f32 layouts, with 4 live lanes of 32 (gaussian
    and the coordinates), or 52 of 64, 84 of 96 or 124 of 128 (an NLM 7 x
    7, 9 x 9 or 11 x 11 patch and the coordinates), go to the kernel
    library (here missing, so its RuntimeError), never to the plain
    versions: the f32 K7-K10, the coordinate K5/K6 and K1's coordinate
    cross at every depth; K5/K6 take the coordinate kernel only where
    asked. No plain version runs (each raises here if called). Coordinate
    features past 128 lanes raise ValueError in K1, and live lanes past the
    layout's in K7 and K5, all before any launch."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    def no_plain(*args, **kw):
        raise AssertionError("a CUDA wrapper took its plain version")

    for mod in (k79, k56, k1):
        monkeypatch.setattr(mod, "_device_kind", lambda *ts: "cuda")
        for name in dir(mod):
            if name.endswith("_plain"):
                monkeypatch.setattr(mod, name, no_plain)
    monkeypatch.setattr(_build, "lib", no_lib)
    fa, f_t = _f32_layouts(d=d, fd=fd)
    live = -(-d // 4) * 4
    cases = _f32_cases(fa, f_t, live, d)
    before = [fn.launches for fn, _ in cases]
    for fn, args in cases:
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(*args)
    with pytest.raises(ValueError, match="feature lanes"):
        k1.affinity_strip_cuda(torch.zeros((8, 129)), torch.zeros((16, 129)),
                               coords=True)
    assert [fn.launches for fn, _ in cases] == before
    with pytest.raises(ValueError, match="live lanes"):
        k79.kb_strip_cuda(fa, f_t, torch.ones(f_t.shape[1]), False, fd + 8)
    with pytest.raises(ValueError, match="live lanes"):
        k56.matvec_cuda(fa, f_t, torch.ones(f_t.shape[1]), False, fd + 1,
                        True)


def test_lane_counts():
    assert [k79._lanes(x, 32) for x in (None, 1, 3, 4, 5, 27, 32)] == [
        32, 4, 4, 4, 8, 28, 32]
    assert [k79._lanes(x, 64) for x in (None, 4, 33, 51, 52, 64)] == [
        64, 4, 36, 52, 52, 64]
    assert [k79._lanes(x, 96) for x in (None, 4, 65, 83, 84, 96)] == [
        96, 4, 68, 84, 84, 96]
    assert [k79._lanes(x, 128) for x in (None, 4, 97, 123, 124, 128)] == [
        128, 4, 100, 124, 124, 128]
    assert [k79.coord_lanes(x, 32) for x in (None, 3, 4, 5, 28)] == [
        32, 4, 4, 32, 32]
    # past 32 lanes the whole layout: the 4-lane V pass reads fa rows at a
    # 32-lane stride
    assert [k79.coord_lanes(x, 64) for x in (None, 4, 51, 52, 64)] == [
        64, 64, 64, 64, 64]
    assert [k79.coord_lanes(x, 96) for x in (None, 4, 83, 84, 96)] == [
        96, 96, 96, 96, 96]
    assert [k79.coord_lanes(x, 128) for x in (None, 4, 123, 124, 128)] == [
        128, 128, 128, 128, 128]
    # the coordinate K5/K6 read the live lanes rounded up to 4, in 128 x
    # 128 tiles at every width
    assert (k56.COORD_FIXED, k56.COORD_STREAM) == (128, 128)
    assert [k56._coord_lv(torch.zeros(1, fd), True, live)
            for fd, live in ((32, 3), (32, 27), (64, 51), (96, 83),
                             (128, 123), (128, None))] == [
        4, 28, 52, 84, 124, 128]
    for fd, live in ((32, 33), (64, 65), (96, 97), (128, 129)):
        with pytest.raises(ValueError, match="live lanes"):
            k79._lanes(live, fd)
        with pytest.raises(ValueError, match="live lanes"):
            k79.coord_lanes(live, fd)


def test_coord_launch_plan_serves_every_wrapper_shape(monkeypatch):
    """The coordinate kernel's plan (``_coord_plan``) takes every shape the
    recipes pass (K5 fixes p_pad, on 512, and streams n, on 256; K6 the
    reverse) at the lanes they read, ``_lanes(live, fd)`` (4, 28, 52, 84,
    124): 128-entry fixed and streamed tiles, as many splits as fill whole
    waves of the kernel's resident blocks at those lanes, in at most
    COORD_WAVES waves, none empty; the wrappers pass those lanes and that
    plan to ``glt_coord_sum``. At 8 MP (recipes B and C) K5 runs 32 fixed
    blocks by 33 splits on 264 slots, four whole waves (8 splits would
    leave 8 slots idle), K6 65536 blocks unsplit."""
    calls = []
    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(
        glt_coord_slots=lambda lv: 264,
        glt_coord_sum=lambda *a: calls.append(a[6:10]) or 0))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(k56, "_device_kind", lambda *ts: "cuda")
    for fd, d in ((32, 3), (32, 27), (64, 51), (96, 83), (128, 123)):
        live = -(-d // 4) * 4
        lv = k56._coord_lv(torch.zeros(1, fd), True, live)
        assert lv == k79._lanes(live, fd) == live
        for pp in (512, 1024, 4096, 5120):
            for n in (256, 768, 2560, 1 << 20, MP8):
                for lf, ls in ((pp, n), (n, pp)):
                    splits = k56._coord_plan(lf, ls, lv)
                    tiles = ls // k56.COORD_STREAM
                    per = -(-tiles // splits)
                    blocks = lf // k56.COORD_FIXED
                    assert 1 <= splits <= tiles and per * (splits - 1) < tiles
                    assert blocks * splits <= max(blocks,
                                                  k56.COORD_WAVES * 264)
        fa, f_t = torch.zeros((512, fd)), torch.zeros((fd, 1024))
        k56.matvec_cuda(fa, f_t, torch.ones(1024), False, live, True)
        k56.rmatvec_cuda(fa, f_t, torch.ones(512), False, live, True)
        assert calls[-2:] == [(512, 1024, 8, lv), (1024, 512, 4, lv)]
    assert k56._coord_plan(4096, MP8, 124) == 33
    assert k56._coord_plan(MP8, 4096, 124) == 1
    with pytest.raises(ValueError, match="128-entry"):
        k56._coord_plan(4096 + 64, MP8, 124)


def test_coord_store_plan_serves_every_wrapper_shape(monkeypatch):
    """K1's coordinate cross and the f32 K7 reach their entry points
    (``glt_affinity_coord``, ``glt_kb_strip_f32``: the coordinate store
    kernel) at every shape the paths pass, with the lanes they read (d
    rounded up to 4; ``_lanes(live, fd)``), the column splits of
    ``store_plan`` (whole waves of 264 resident blocks where they fit,
    none empty) and scratch of the size the kernel lays out: K1 at config 1
    fast's 2688 x 2^18, recipe A's 5248 x 2^18 and the dense route's K_AB
    5243 x 256901 (rows of 256901 padded to 256 bytes), both stores, at d =
    3, 27, 51, 83, 123; K7 at the gram shape 4096 x 131072 and at one
    128-column tile. Meta tensors: no memory, no card."""
    calls, slots_asked, empties = [], [], []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        empties.append(t.shape)
        return t

    monkeypatch.setattr(_build, "lib", lambda: SimpleNamespace(
        glt_coord_store_slots=lambda epi, lv: slots_asked.append(
            (epi, lv)) or 264,
        glt_affinity_coord=lambda *a: calls.append(("k1",) + a[4:10]) or 0,
        glt_kb_strip_f32=lambda *a: calls.append(("k7",) + a[5:10]) or 0))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    for mod in (k1, k79):
        monkeypatch.setattr(mod, "_device_kind", lambda *ts: "cuda")
    meta = torch.device("meta")
    for p, n in ((2688, 1 << 18), (5248, 1 << 18), (5243, 256901)):
        for d in (3, 27, 51, 83, 123):
            lv = -(-d // 4) * 4
            p_pad, n_pad = -(-p // 128) * 128, -(-n // 128) * 128
            for store, epi, per in ((torch.float32, k1.EPI_F32, 64),
                                    (torch.bfloat16, k1.EPI_BF16, 128)):
                del empties[:]
                out = k1.affinity_strip_cuda(
                    torch.zeros((p, d), device=meta),
                    torch.zeros((n, d), device=meta), torch.float32, store,
                    coords=True)
                ld = -(-n // per) * per
                assert out.shape == (p, n) and out.dtype == store
                assert out.stride(0) == ld and (ld * store.itemsize) % 256 == 0
                assert (p_pad + n_pad) * (lv + 1) in [e.numel()
                                                      for e in empties]
                assert slots_asked[-1] == (epi, lv)
                tag, gp, gn, gd, gld, gbf, splits = calls[-1]
                assert (tag, gp, gn, gd, gld, gbf) == (
                    "k1", p, n, d, ld, int(store == torch.bfloat16))
                groups = -(-(n_pad // 128) // (4 if lv == 4 else 1))
                per_split = -(-groups // splits)
                assert k1.store_groups(n, lv) == groups
                assert 1 <= splits <= groups
                assert per_split * (splits - 1) < groups    # none empty
                assert splits == k1._waves_plan(p_pad // 128, groups, 264)
    for fd, d, s in ((32, 3, 1 << 17), (32, 27, 1 << 17), (64, 51, 1 << 17),
                     (96, 83, 1 << 17), (128, 123, 1 << 17), (128, 123, 128)):
        live = -(-d // 4) * 4
        del empties[:]
        out = k79.kb_strip_cuda(torch.zeros((4096, fd), device=meta),
                                torch.zeros((fd, s), device=meta),
                                torch.ones(s, device=meta), False, live)
        assert out.shape == (4096, s) and out.dtype == torch.float32
        assert torch.Size([4096 + s]) in empties
        assert slots_asked[-1] == (k1.EPI_SCALED, k79._lanes(live, fd))
        tag, gp, gs, glive, gfd, splits = calls[-1]
        assert (tag, gp, gs, glive, gfd) == ("k7", 4096, s, live, fd)
        groups = -(-(s // 128) // (4 if live == 4 else 1))
        assert k1.store_groups(s, live) == groups
        assert 1 <= splits <= groups
        assert splits == k1._waves_plan(32, groups, 264)
    # the gram sweep fills one wave (32 row blocks x 8 splits on 264
    # slots); recipe A's K1 five (41 x 32), config 1 fast's (4 lanes: 4
    # tiles a group) one (21 x 12)
    assert k1._waves_plan(32, 1024, 264) == 8
    assert k1._waves_plan(41, 2048, 264) == 32
    assert k1._waves_plan(21, 512, 264) == 12
    assert k1._waves_plan(32, 1, 264) == 1


@pytest.mark.parametrize("kind", ["nlm9", "nlm11"])
def test_coord_k5_k6_plain_over_the_live_lanes(jx, kind):
    """The coordinate K5/K6 read only ``_lanes(live, fd)`` lanes (84 of 96,
    124 of 128) of recipe B's and C's features: the pad lanes are zero, so
    the plain versions over those lanes agree with the full-depth plain
    versions, and with graphlap_tpu's matvec_pallas / rmatvec_pallas
    (interpret mode), within the f32 bar of the coordinate tiles (16 ulps
    of max |f|^2 relative to the sum of the terms' magnitudes, as the K8
    test above holds its u); CPU matmuls of another depth sum in another
    order, so not bit for bit."""
    jnp = jx.jnp
    x = _coord_inputs(jx, kind=kind)
    fa, f_t = T(N(x.fa_pad)), T(N(x.f_t))
    lv = k56._coord_lv(fa, True, x.live)
    assert lv == x.live == {"nlm9": 84, "nlm11": 124}[kind] < fa.shape[1]
    assert not fa[:, lv:].any() and not f_t[lv:].any()
    fa_l, ft_l = fa[:, :lv].contiguous(), f_t[:lv].contiguous()
    v = T(np.random.default_rng(3).uniform(0.5, 1.5, f_t.shape[1]))
    t = T(x.t)
    kb = np.abs(N(k79.kb_strip_plain(fa, f_t, torch.ones(f_t.shape[1]),
                                     False))).astype(np.float64)
    for fn, ref_fn, vec, terms in (
            (k56.matvec_plain, jx.pst.matvec_pallas, v, kb @ N(v)),
            (k56.rmatvec_plain, jx.pst.rmatvec_pallas, t, N(t) @ kb)):
        full = fn(fa, f_t, vec)
        _sum_bar(N(fn(fa_l, ft_l, vec)), N(full), terms, x.tol)
        ref = ref_fn(x.fa_pad, x.f_t, jnp.asarray(N(vec)), aug=False)
        _sum_bar(N(full), N(ref), terms, x.tol)


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _card_layouts(dev, p, n, h_img, w_img, seed=1, d=3):
    """The bilateral recipe's f32 layouts for p sample pixels and n pixels
    of an h_img x w_img image, as the context builds them, on the card: d -
    2 value lanes in [0, 5) (y/0.2 for the gaussian kernel, d = 3; an NLM
    patch's pixels over h for d = 27 and 51, 5 x 5 and 7 x 7), then row/8,
    col/8, in a 32-, 64-, 96- or 128-lane layout (28, 52, 84 and 124 live
    lanes past 3: d 27, 51, 83, 123)."""
    rng = np.random.default_rng(seed)

    def feats(k):
        r = rng.integers(0, h_img, k)
        c = rng.integers(0, w_img, k)
        y = rng.uniform(0, 5, (k, d - 2))
        return np.concatenate([y, np.stack([r / 8.0, c / 8.0], axis=1)],
                              axis=1).astype(np.float32)
    fa3 = feats(p)
    # columns: neighbours of the sample rows (within 32 px, the value lanes
    # within 0.5 / sqrt(d - 2) a lane), so tiles live
    base = fa3[rng.integers(0, p, n)]
    jit = rng.uniform(-1, 1, (n, d - 2)) * 0.5 / np.sqrt(d - 2)
    fp3 = base + np.concatenate(
        [jit, np.stack([rng.integers(-32, 33, n) / 8.0,
                        rng.integers(-32, 33, n) / 8.0], axis=1)],
        axis=1).astype(np.float32)
    p_pad = rl.p_tiling(p)[1]
    fd = rl.d_pad_of(d)
    fa = torch.zeros((p_pad, fd), device=dev)
    fa[:p, :d] = torch.tensor(fa3, device=dev)
    f_t = torch.zeros((fd, n), device=dev)
    f_t[:d] = torch.tensor(fp3.T.copy(), device=dev)
    return fa, f_t


def _f64_tile(fa, f_t, rows, cols):
    a, b = fa[rows].double(), f_t[:, cols].double()
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(0)[None, :] - 2.0 * a @ b
    return torch.exp(-torch.clamp(d2, min=0.0))


def _err_stats(got, ref64):
    """(max, p99) of |got - ref64|; the p99 over an even subsample of at
    most 2^22 entries (torch.quantile's input bound)."""
    d = (got.double() - ref64).abs().flatten()
    sub = d[::max(1, d.numel() >> 22)]
    return float(d.max()), float(torch.quantile(sub, 0.99))


def _rel_stats(got, ref64):
    """(max, p99) of |got - ref64| / |ref64| over the entries ref64 != 0."""
    keep = ref64 != 0
    d = ((got.double() - ref64).abs() / ref64.abs())[keep]
    return float(d.max()), float(torch.quantile(d[::max(1, d.numel() >> 22)],
                                                0.99))


def _share_below(got, ref):
    """The lean of got against ref: the share of (got - ref) sign(ref) below
    zero among the entries where they differ (equal sums of the same few
    terms say nothing of a lean)."""
    d = ((got - ref) * torch.sign(ref))[(ref != 0) & (got != ref)]
    return float((d < 0).float().mean())


def _ext2_f64(fa, f_t, t2, bm, chunk=8192):
    """K8's function with the tile and the sums in f64, from the same f32
    features: (u, s)."""
    a = fa.double()
    na = (a * a).sum(1)
    u = torch.zeros(fa.shape[0], dtype=torch.float64, device=fa.device)
    s = torch.empty(f_t.shape[1], dtype=torch.float64, device=fa.device)
    for j in range(0, f_t.shape[1], chunk):
        b = f_t[:, j:j + chunk].double()
        k = torch.exp(-torch.clamp(na[:, None] + (b * b).sum(0)[None]
                                   - 2.0 * a @ b, min=0.0))
        kbt = t2.double() @ k
        s[j:j + chunk] = bm[j:j + chunk].double() / torch.sqrt(
            torch.clamp(kbt[0] * kbt[1], min=1e-30))
        u += k @ s[j:j + chunk]
    return u, s


def _colstats_f64(fa, f_t, gr, c=None, finish=None, chunk=8192):
    """K10's (column scale ``c``) or K9's (``finish`` = (t, s_pre, bm))
    function with the tile and the sums in f64, from the same f32
    features: (V, the sums of V's terms' magnitudes, s or None)."""
    a = fa.double()
    na = (a * a).sum(1)
    g = gr.double()
    n = f_t.shape[1]
    v = torch.empty((n, g.shape[1]), dtype=torch.float64, device=fa.device)
    terms = torch.empty_like(v)
    s = None if finish is None else torch.empty(n, dtype=torch.float64,
                                                device=fa.device)
    for j in range(0, n, chunk):
        b = f_t[:, j:j + chunk].double()
        k = torch.exp(-torch.clamp(na[:, None] + (b * b).sum(0)[None]
                                   - 2.0 * a @ b, min=0.0))
        if finish is None:
            cj = c[j:j + chunk].double()
        else:
            t, s_pre, bm = finish
            cj = torch.sqrt(s_pre[j:j + chunk].double() / torch.clamp(
                t.double() @ k, min=1e-30)) * bm[j:j + chunk].double()
            s[j:j + chunk] = cj
        k *= cj[None]
        v[j:j + chunk] = k.T @ g
        terms[j:j + chunk] = k.abs().T @ g.abs()
    return v, terms, s


def _sum_stats(got, ref64, scale):
    """(max, p99) of |got - ref64| / scale over the entries where scale >
    0."""
    keep = scale > 0
    d = ((got.double() - ref64).abs() / scale)[keep]
    return float(d.max()), float(torch.quantile(d[::max(1, d.numel() >> 22)],
                                                0.99))


def _within_plain(k, pl, floor=1e-12):
    """The kernel's max and p99 |dK| against f64 at most 1.5x the plain
    f32 version's, plus ``floor``."""
    assert k[0] <= 1.5 * pl[0] + floor and k[1] <= 1.5 * pl[1] + floor, (
        k, pl)


# NLM lanes (d 27 and 51): the tile entries of a test slab are small
# (k ~ 1e-5..1e-2: the columns lie within 32 px of one random sample), so
# both versions' errors against f64, of the tile and of K8's sums, sit at
# a few f32 ulps (expf's own 2 ulps, the rounding of k and of the sums)
# and their ratio is noise: the 1.5x rule gets a floor of 4 ulps, 2^-21
# (absolute on the tile, relative on the sums). And K8's s_j = bm_j /
# sqrt(kbt_r kbt_c) moves with its column's norm, which the kernel sums as
# an FMA chain and the plain version as rounded squares, by several % of
# s_j (chip_smoke.py's ext2_matvec_f32_d64 bar): a gross bar of 0.1 of
# max |s|
NLM_ULP_FLOOR = 2.0 ** -21
NLM_K8_GROSS = 0.1


LIVE_D = [3, 27, 51]    # raw lanes: gaussian, NLM 5x5, NLM 7x7 + (row, col)
WIDE_D = [83, 123]      # NLM 9x9 and 11x11 + (row, col)


@pytest.mark.gpu
@pytest.mark.parametrize("d", LIVE_D + WIDE_D)
@pytest.mark.parametrize("p,n,img", [(1000, 33024, (512, 512)),
                                     (4000, 65536, (2048, 4096))])
def test_f32_kernels_match_plain_and_f64(cuda_device, p, n, img, d):
    """K7-K10 f32 at splitting shapes (p_pad 1024 or 4096, column tiles that
    do not divide among the clusters or blocks) at 4, 28, 52, 84 and 124
    live lanes (32-, 32-, 64-, 96- and 128-lane layouts): K9's and K10's sums against the plain
    version to 2e-4 relative (the norms are passed in, so only the cross's
    order differs), K7's tile, K8's u and s and K9's and K10's V (over the
    sums of its terms' magnitudes) and K9's s against f64 under the 1.5x
    rule, two launches bit for bit, and the leans of u, s and V in (0.25,
    0.75)."""
    dev = cuda_device
    fa, f_t = _card_layouts(dev, p, n, *img, d=d)
    live = -(-d // 4) * 4
    p_pad = fa.shape[0]
    rng = np.random.default_rng(p)
    r = lambda *s: torch.tensor(rng.uniform(0.5, 1.5, s).astype(  # noqa: E731
        np.float32), device=dev)
    cols = r(n)
    # K7 on the first 16384 columns
    s7 = 16384
    args = (fa, f_t[:, :s7].contiguous(), cols[:s7], False, live)
    kb = k79.kb_strip_cuda(*args)
    assert torch.equal(kb, k79.kb_strip_cuda(*args))
    kb_p = k79.kb_strip_plain(*args)
    rows = torch.arange(0, p, 3, device=dev)
    cc = torch.arange(0, s7, 5, device=dev)
    t64 = _f64_tile(fa, f_t, rows, cc) * cols[cc].double()
    _within_plain(_err_stats(kb[rows][:, cc], t64),
                  _err_stats(kb_p[rows][:, cc], t64),
                  1e-12 if d == 3 else NLM_ULP_FLOOR)
    del kb, kb_p, t64
    # K8
    bm = torch.ones(n, device=dev)
    bm[::7] = 0.0
    t2 = torch.zeros((2, p_pad), device=dev)
    t2[:, :p] = r(2, p)
    args = (fa, f_t, t2, bm, False, live)
    u, s = k79.ext2_matvec_cuda(*args)
    u2, s2 = k79.ext2_matvec_cuda(*args)
    assert torch.equal(u, u2) and torch.equal(s, s2)
    u_p, s_p = k79.ext2_matvec_plain(*args)
    u64, s64 = _ext2_f64(fa, f_t, t2, bm)
    for got, ref, r64, keep in ((u, u_p, u64, p), (s, s_p, s64, n)):
        # K8's norms are FMA chains, the plain version's sums of rounded
        # squares: one ulp of |f|^2 moves a whole row's entries together,
        # so the sums are held to f64 (the 1.5x rule) and to the plain
        # version only for gross errors
        gross = 1e-2 if d == 3 else NLM_K8_GROSS
        assert float((got - ref).abs().max()) <= gross * float(
            ref.abs().max())
        _within_plain(_rel_stats(got[:keep], r64[:keep]),
                      _rel_stats(ref[:keep], r64[:keep]),
                      1e-12 if d == 3 else NLM_ULP_FLOOR)
        assert 0.25 < _share_below(got[:keep], ref[:keep]) < 0.75
    # K9 and K10
    gr = torch.zeros((p_pad, 64), device=dev)
    gr[:p, :50] = torch.tensor(rng.normal(0, 0.02, (p, 50)).astype(
        np.float32), device=dev)
    y = r(n)
    na = torch.sum(fa * fa, dim=1)
    nb = torch.sum(f_t * f_t, dim=0)
    tv = torch.zeros(p_pad, device=dev)
    tv[:p] = r(p)
    a9 = (fa, f_t, tv, r(n) * bm, bm, gr, y, na, nb)
    a10 = (fa, f_t, gr, y, cols, na, nb)
    for fn, pl, a in ((k79.finish_colstats_cuda, k79.finish_colstats_plain,
                       a9), (k79.colstats_v_cuda, k79.colstats_v_plain, a10)):
        got = fn(*a, live=live)
        again = fn(*a, live=live)
        assert all(torch.equal(g, h) for g, h in zip(got, again))
        ref = pl(*a)
        v, v_r = got[0], ref[0]
        assert float((v - v_r).abs().max()) <= 2e-4 * float(v_r.abs().max())
        assert float(v[:, 50:].abs().max()) == 0.0
        assert float(v_r.abs().max()) > 0.0
        # no lean where every entry equals the plain version's (all tied)
        share = _share_below(v, v_r)
        assert bool(torch.equal(v, v_r)) or 0.25 < share < 0.75
        scale_n = torch.sum(v_r * v_r, dim=0)[:50]
        scale_c = (torch.abs(y) @ torch.abs(v_r))[:50]
        for g_, r_, sc in ((got[1][:50], ref[1][:50], scale_n),
                           (got[2][:50], ref[2][:50], scale_c)):
            assert float(((g_ - r_).abs() / sc).max()) <= 2e-4
        if len(got) == 4:
            assert float((got[3] - ref[3]).abs().max()) <= 2e-4 * float(
                ref[3].abs().max())
        # against f64 on every 4th column: V over its terms' magnitudes,
        # K9's s over |s|
        cc = torch.arange(0, n, 4, device=dev)
        ft_c = f_t[:, cc].contiguous()
        if len(got) == 4:
            v64, terms, s64 = _colstats_f64(fa, ft_c, gr, finish=(
                tv, a9[3][cc], bm[cc]))
            _within_plain(_sum_stats(got[3][cc], s64, s64.abs()),
                          _sum_stats(ref[3][cc], s64, s64.abs()),
                          1e-12 if d == 3 else NLM_ULP_FLOOR)
        else:
            v64, terms, _ = _colstats_f64(fa, ft_c, gr, c=cols[cc])
        _within_plain(_sum_stats(v[cc][:, :50], v64[:, :50], terms[:, :50]),
                      _sum_stats(v_r[cc][:, :50], v64[:, :50],
                                 terms[:, :50]),
                      1e-12 if d == 3 else NLM_ULP_FLOOR)
        del v64, terms, ft_c


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 64 * 1031, 192])
@pytest.mark.parametrize("d", WIDE_D)
def test_k8_f32_past_64_lanes_repeats_and_takes_every_n(cuda_device, d, n):
    """K8 f32 at 84 and 124 live lanes (96- and 128-lane layouts) at p_pad
    4096: two launches bit for bit, on n = 2^16, on an n that is a multiple
    of 64 but not of the 128-column tile of the 128-lane layout (64 x
    1031: its last tile is masked), and on fewer column tiles than the card
    holds clusters (192): u and s against the plain version (the gross bar)
    and against f64 (the 1.5x rule with the 4-ulp floor), s zero where bm
    is."""
    dev = cuda_device
    fa, f_t = _card_layouts(dev, 4000, n, 2048, 4096, d=d)
    live = -(-d // 4) * 4
    rng = np.random.default_rng(n)
    bm = torch.ones(n, device=dev)
    bm[::7] = 0.0
    t2 = torch.zeros((2, fa.shape[0]), device=dev)
    t2[:, :4000] = torch.tensor(rng.uniform(0.5, 1.5, (2, 4000)).astype(
        np.float32), device=dev)
    args = (fa, f_t, t2, bm, False, live)
    u, s = k79.ext2_matvec_cuda(*args)
    u2, s2 = k79.ext2_matvec_cuda(*args)
    assert torch.equal(u, u2) and torch.equal(s, s2)
    u_p, s_p = k79.ext2_matvec_plain(*args)
    u64, s64 = _ext2_f64(fa, f_t, t2, bm)
    for got, ref, r64, keep in ((u, u_p, u64, 4000), (s, s_p, s64, n)):
        assert float((got - ref).abs().max()) <= NLM_K8_GROSS * float(
            ref.abs().max())
        _within_plain(_rel_stats(got[:keep], r64[:keep]),
                      _rel_stats(ref[:keep], r64[:keep]), NLM_ULP_FLOOR)
    assert float(s[bm == 0].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("d", LIVE_D + WIDE_D)
@pytest.mark.parametrize("img", [(512, 512), (2048, 4096)])
def test_coordinate_cross_against_f64(cuda_device, img, d):
    """K1 (both stores) and the f32 K5/K6 on coordinate features at 4, 28,
    52, 84 and 124 live lanes: the tile against f64, the kernel's max and
    p99 |dK| at most 1.5x the plain f32 version's, the bf16 store's max at
    most one bf16 ulp past the plain f32 version's. The split-fp16 cross
    (the NLM route) is printed beside."""
    dev = cuda_device
    fa, f_t = _card_layouts(dev, 512, 1 << 18, *img, d=d)
    live = -(-d // 4) * 4
    a3, b3 = fa[:512, :d].contiguous(), f_t[:d].T.contiguous()
    t64 = _f64_tile(fa, f_t, torch.arange(512, device=dev),
                    torch.arange(f_t.shape[1], device=dev))
    plain = _err_stats(k1.affinity_strip_plain(a3, b3), t64)
    coord = _err_stats(k1.affinity_strip_cuda(a3, b3, coords=True), t64)
    split = _err_stats(k1.affinity_strip_cuda(a3, b3), t64)
    print(f"K1 f32 store vs f64 (max, p99): plain {plain}, coordinate "
          f"cross {coord}, split cross {split}")
    _within_plain(coord, plain)
    bf = k1.affinity_strip_cuda(a3, b3, torch.float32, torch.bfloat16,
                                coords=True)
    assert float((bf.double() - t64).abs().max()) <= plain[0] + 2.0 ** -8
    _coord_k56_against_f64(fa, f_t, t64, live)


@pytest.mark.gpu
@pytest.mark.parametrize("d", LIVE_D + WIDE_D)
def test_coord_store_ragged_repeats_and_matches_the_padded_launch(
        cuda_device, d):
    """The coordinate store kernel at 4, 28, 52, 84 and 124 lanes on ragged
    shapes: K1 (both stores) at p = 300 sample rows (not a multiple of the
    block's 128) and n = 65499 pixels (its last tile part masked, rows
    padded to 256 bytes), K7 f32 at p_pad 512 and S = 128 x 131 columns
    (tiles that do not divide among the splits). Two launches agree bit for
    bit, and each entry equals the same entry of a launch on whole blocks
    and tiles (p 512, n 65536; S 2^17), whose rows, columns and splits
    differ: an entry depends on its row and column alone. That these
    shapes give the bits of the kernels the store kernel replaced is
    scripts/f32_same_bits.py's check (its ragged rows)."""
    dev = cuda_device
    fa, f_t = _card_layouts(dev, 512, 1 << 17, 2048, 4096, d=d)
    live = -(-d // 4) * 4
    p, n = 300, 65499
    for store in (None, torch.bfloat16):
        args = (torch.float32, store, True)
        got = k1.affinity_strip_cuda(fa[:p, :d].contiguous(),
                                     f_t[:d, :n].T.contiguous(), *args)
        again = k1.affinity_strip_cuda(fa[:p, :d].contiguous(),
                                       f_t[:d, :n].T.contiguous(), *args)
        whole = k1.affinity_strip_cuda(fa[:, :d].contiguous(),
                                       f_t[:d, :65536].T.contiguous(), *args)
        assert got.shape == (p, n)
        assert torch.equal(got, again)
        assert torch.equal(got, whole[:p, :n])
    cols = torch.rand(f_t.shape[1], device=dev) + 0.5
    s = 128 * 131
    got = k79.kb_strip_cuda(fa, f_t[:, :s].contiguous(), cols[:s], False,
                            live)
    again = k79.kb_strip_cuda(fa, f_t[:, :s].contiguous(), cols[:s], False,
                              live)
    whole = k79.kb_strip_cuda(fa, f_t, cols, False, live)
    assert torch.equal(got, again)
    assert torch.equal(got, whole[:, :s])


def _coord_k56_against_f64(fa, f_t, t64, live):
    """K5/K6 with the coordinate cross on 512 sample rows: the tile enters
    only through the sums, so each output is held against its f64
    evaluation (``t64``, the f64 tile), the kernel's error at most 1.5x the
    plain f32 version's; the split-fp16 cross printed beside."""
    dev = fa.device
    v = torch.rand(f_t.shape[1], device=dev) + 0.5
    t = torch.zeros(fa.shape[0], device=dev)
    t[:512] = torch.rand(512, device=dev) + 0.5
    for fn, pl, x, ref in (
            (k56.matvec_cuda, k56.matvec_plain, v, t64 @ v.double()),
            (k56.rmatvec_cuda, k56.rmatvec_plain, t,
             t[:512].double() @ t64)):
        keep = ref.shape[0]
        e_k = (fn(fa, f_t, x, False, live, True)[:keep].double()
               - ref).abs() / ref.abs()
        e_p = (pl(fa, f_t, x, False)[:keep].double() - ref).abs() / ref.abs()
        e_s = (fn(fa, f_t, x, False)[:keep].double() - ref).abs() / ref.abs()
        print(f"{fn.__name__} relative error vs f64 (max): plain "
              f"{float(e_p.max()):.3e}, coordinate {float(e_k.max()):.3e}, "
              f"split {float(e_s.max()):.3e}")
        assert float(e_k.max()) <= 1.5 * float(e_p.max()) + 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("img", [(512, 512), (2048, 4096)])
def test_coordinate_k5_k6_past_64_lanes_against_f64(cuda_device, img, d):
    """The coordinate K5/K6 at 84 and 124 live lanes (96- and 128-lane
    layouts; the register-tiled kernel reads those lanes alone): each
    output against its f64 evaluation within 1.5x the plain f32 version's
    error, as at 4 to 52 live lanes (test_coordinate_cross_against_f64),
    and K5's and K6's two launches each bit for bit."""
    dev = cuda_device
    fa, f_t = _card_layouts(dev, 512, 1 << 18, *img, d=d)
    live = -(-d // 4) * 4
    t64 = _f64_tile(fa, f_t, torch.arange(512, device=dev),
                    torch.arange(f_t.shape[1], device=dev))
    _coord_k56_against_f64(fa, f_t, t64, live)
    x = torch.rand(f_t.shape[1], device=dev) + 0.5
    got = k56.matvec_cuda(fa, f_t, x, False, live, True)
    assert torch.equal(got, k56.matvec_cuda(fa, f_t, x, False, live, True))
    t = torch.zeros(fa.shape[0], device=dev)
    t[:512] = torch.rand(512, device=dev) + 0.5
    got = k56.rmatvec_cuda(fa, f_t, t, False, live, True)
    assert torch.equal(got, k56.rmatvec_cuda(fa, f_t, t, False, live, True))


def _f32_sums_vs_f64(dev, patch, which):
    """The f32 K5 (``which`` "matvec") or K6 ("rmatvec"), the split cross
    without coordinates, on the 8 MP matvec denoise's own layouts
    (tuned_config(denoise_tuned(., 0.1), 2048*4096, "fast"), p 4096) over
    a 1024 x 2048 image, and its plain version, against their f64 sums:
    (the kernel's share of outputs below f64, the plain version's, the
    kernel's (max, p99) relative error, the plain version's)."""
    base = PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=10, filter_name="identity",
        streaming=True, block_cols=131072, affinity_dtype="bfloat16",
        patch_size=patch)
    cfg = gt.tuned_config(gt.denoise_tuned(base, 0.1), MP8, "fast")
    img = gt.make_test_image(1024, 2048)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0,
                    1).astype(np.float32)
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(T(noisy).to(dev), interop.idx_to_device(
        plan.idx_a, "cuda"), cfg)
    fa, f_t, p = ctx.fa_pad, ctx.f_t, ctx.p
    assert fa.dtype == torch.float32 and not ctx.coords
    assert f_t.shape[0] == {5: 32, 7: 64, 9: 96, 11: 128}[patch]
    gen = torch.Generator(device=dev).manual_seed(1)
    a = fa[:p].double()
    na = (a * a).sum(1)
    if which == "matvec":
        x = 0.5 + torch.rand(f_t.shape[1], device=dev, generator=gen)
        got = k56.matvec_cuda(fa, f_t, x, False)[:p].double()
        ref = k56.matvec_plain(fa, f_t, x, False)[:p].double()
        r64 = torch.zeros(p, dtype=torch.float64, device=dev)
    else:
        x = torch.zeros(fa.shape[0], device=dev)
        x[:p] = 0.5 + torch.rand(p, device=dev, generator=gen)
        got = k56.rmatvec_cuda(fa, f_t, x, False)[:ctx.n].double()
        ref = k56.rmatvec_plain(fa, f_t, x, False)[:ctx.n].double()
        r64 = torch.zeros(f_t.shape[1], dtype=torch.float64, device=dev)
    for j in range(0, f_t.shape[1], 16384):
        b = f_t[:, j:j + 16384].double()
        k = torch.exp(-(na[:, None] + (b * b).sum(0)[None]
                        - 2.0 * a @ b).clamp_(min=0.0))
        if which == "matvec":
            r64 += k @ x[j:j + 16384].double()
        else:
            r64[j:j + 16384] = x[:p].double() @ k
    r64 = r64[:got.shape[0]]

    def err(y):
        e = ((y - r64).abs() / r64)[r64 != 0]
        return float(e.max()), float(torch.quantile(e[::max(1, e.numel() >> 22)], 0.99))
    share = float(((got - r64) < 0).double().mean())
    share_p = float(((ref - r64) < 0).double().mean())
    e_k, e_p = err(got), err(ref)
    print(f"{which} f32 at {f_t.shape[0]} lanes: share below f64 "
          f"{share:.4f} (plain {share_p:.4f}); relative error vs f64 (max, "
          f"p99) kernel {e_k}, plain {e_p}")
    return share, share_p, e_k, e_p


@pytest.mark.gpu
@pytest.mark.parametrize("patch", [5, 7, 9, 11])
def test_k5_f32_does_not_lean(cuda_device, patch):
    """The f32 K5 at 32, 64, 96 and 128 lanes (_f32_sums_vs_f64): each row
    runs some
    2048 tiles a split, most far from its few live entries, whose sums fell
    below half an ulp of the running sum and were dropped, one way, until
    each tile joined it by a compensated add; its rows' share below their
    f64 sums lies in (0.35, 0.65). Its max and p99 error against f64 stay
    within 1.5x the plain version's, the f32 kernels' bar: with the
    two-part split cross (an fp16 small part keeping 11 of the residual's
    ~14 bits) and FMA-chain norms it sat at 1.3-1.9x; the three-part split
    with its norms f64 sums rounded once holds it (ROADMAP.md Queue 3;
    scripts/f32_matvec_designs.py)."""
    share, _, e_k, e_p = _f32_sums_vs_f64(cuda_device, patch, "matvec")
    assert 0.35 < share < 0.65
    assert e_k[0] <= 1.5 * e_p[0] + 1e-7 and e_k[1] <= 1.5 * e_p[1] + 1e-7


@pytest.mark.gpu
@pytest.mark.parametrize("patch", [5, 7, 9, 11])
def test_k6_f32_does_not_lean(cuda_device, patch):
    """The f32 K6 beside K5 (test_k5_f32_does_not_lean): its columns' share
    below their f64 sums in (0.35, 0.65), its max and p99 error against
    f64 within 1.5x the plain version's (the two-part split's sat at
    1.6-2.4x)."""
    share, _, e_k, e_p = _f32_sums_vs_f64(cuda_device, patch, "rmatvec")
    assert 0.35 < share < 0.65
    assert e_k[0] <= 1.5 * e_p[0] + 1e-7 and e_k[1] <= 1.5 * e_p[1] + 1e-7


@pytest.mark.gpu
def test_bilateral_slice_on_card_matches_cpu_plain(cuda_device, img_noisy):
    img, noisy = img_noisy
    for fused in (True, False):
        cfg = _cfg(fused_finish=fused)
        plan = gt.make_plan(noisy, cfg)
        x0 = torch.randn(plan.p, cfg.num_eigvecs,
                         generator=torch.Generator().manual_seed(0))
        z_gpu, _ = _filter_channel(T(noisy).cuda(),
                                   interop.idx_to_device(plan.idx_a, "cuda"),
                                   cfg, x0=x0.cuda())
        z_cpu, _ = _filter_channel(T(noisy), interop.idx_to_device(
            plan.idx_a, "cpu"), cfg, x0=x0)
        assert_bars(img, z_gpu.cpu().numpy(), z_cpu.numpy())
