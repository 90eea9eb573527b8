"""The unfused spectral schedule of graphlap_tpu_torch (the 8 MP turbo
recipe, every spectral recipe past the fused gates, filter_image_staged)
against graphlap_tpu: the K10 plain version against ``colstats_v_pallas``
(interpret mode on the CPU, as tests/test_pallas.py runs it), the remaining
streaming operators, ``nystrom_sketch_factor``, the superblocked K7 gram,
the unfused recompute slice, its V-free branch, and ``filter_image_staged``
on a recompute and a strip_cache recipe, with the reference's LOBPCG start
block X0 / sketch matrix Omega injected (torch cannot redraw
jax.random.normal(PRNGKey(0))). On a CUDA card only (marker ``gpu``): K10
against its plain version, and the unfused slice on the card against the
plain versions on the CPU.

Tolerances, relative to the largest reference magnitude unless stated:
* K10 against the Pallas kernel: tests/test_pallas.py's own bars for it —
  V to atol 1e-5 (f32) and 2e-3 (bf16), norms and coeffs to 100x that
  relative; the zero-padded V columns exactly 0.
* Streaming operators: 2e-5 (f32) and 5e-3 (bf16), the bars of
  tests/test_torch_recompute.py's operators (f32 sums in another order; a
  bf16 tile entry may land on the other neighbour).
* Sketch factor with the same Omega: eigenvalues 1e-4 relative, the
  factor's projector 1e-3 (f32 LAPACK against XLA's eigh and solves).
* Whole slice and staged runs: <= 0.05 dB and atol 2e-2 (bf16 tiles or
  strip), <= 0.02 dB and atol 2e-3 (f32) — PERF.md section 2, the
  reference's fused-vs-unfused bars (tests/test_strip_fused.py,
  tests/test_streaming.py:258). The V-free branch rounds the apply's tiles
  at other points than K10 (``rmat_apply`` against bf16(k bf16(c))), the
  same bf16 class: the bf16 bars.
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
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.ops import streaming as tst
from graphlap_tpu_torch.ops.nystrom import lobpcg_x0, nystrom_sketch_factor
from graphlap_tpu_torch.utils import interop

OP_REL = {"float32": 2e-5, "bfloat16": 5e-3}
BARS = {"bfloat16": (0.05, 2e-2), "float32": (0.02, 2e-3)}
STAGES = {"normalize", "eigensolve", "filter"}


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
    from graphlap_tpu.ops import nystrom as jny
    from graphlap_tpu.ops import pallas_streaming as pst
    from graphlap_tpu.ops import streaming as jst
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, jms=jms, jny=jny, pst=pst,
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


def assert_bars(img, z, ref, bars):
    db, atol = bars
    assert z.shape == ref.shape and np.isfinite(z).all()
    np.testing.assert_allclose(z, ref, atol=atol)
    d = abs(gt.psnr(img, z) - gt.psnr(img, ref))
    assert d <= db, f"PSNR delta {d:.4f} dB"


# --- K10 plain version against the Pallas kernel -----------------------------

@pytest.fixture(scope="module")
def k10_inputs(jx):
    """tests/test_pallas.py::test_colstats_v_pallas_matches_xla's inputs."""
    jnp, pst = jx.jnp, jx.pst
    rng = np.random.default_rng(3)
    p, n_pad, d, m = 512, 2048, 25, 20
    fa = rng.normal(size=(p, d)).astype(np.float32)
    fp = rng.normal(size=(n_pad, d)).astype(np.float32)
    g = rng.normal(size=(p, m)).astype(np.float32)
    y = rng.normal(size=(n_pad,)).astype(np.float32)
    rs = rng.uniform(0.5, 1.5, p).astype(np.float32)
    cs = rng.uniform(0.0, 1.5, n_pad).astype(np.float32)
    _, p_pad = pst.p_tiling(p)
    gr = np.zeros((p_pad, pst.M_PAD), np.float32)
    gr[:p, :m] = g * rs[:, None]
    na = np.zeros(p_pad, np.float32)
    na[:p] = np.sum(fa * fa, axis=1)
    nb = np.sum(fp * fp, axis=1).astype(np.float32)
    return SimpleNamespace(fa=fa, fp=fp, g=g, y=y, rs=rs, cs=cs, gr=gr, na=na,
                           nb=nb, p=p, d=d, m=m, p_pad=p_pad, n_pad=n_pad)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_k10_plain_matches_pallas(jx, k10_inputs, dtype, atol):
    jnp, pst = jx.jnp, jx.pst
    x = k10_inputs
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    fa_pad = (jnp.zeros((x.p_pad, pst.D_PAD), jd)
              .at[:x.p, :x.d].set(jnp.asarray(x.fa).astype(jd)))
    f_t = (jnp.zeros((pst.D_PAD, x.n_pad), jd)
           .at[:x.d, :].set(jnp.asarray(x.fp).astype(jd).T))
    v_r, ns_r, co_r = pst.colstats_v_pallas(
        fa_pad, f_t, jnp.asarray(x.gr), jnp.asarray(x.y), jnp.asarray(x.cs),
        jnp.asarray(x.na), jnp.asarray(x.nb))
    v, ns, co = k79.colstats_v_plain(
        T(N(fa_pad), td), T(N(f_t), td), T(x.gr), T(x.y), T(x.cs), T(x.na),
        T(x.nb))
    m = x.m
    np.testing.assert_allclose(N(v)[:, :m], N(v_r)[:, :m], atol=atol)
    np.testing.assert_allclose(N(ns)[:m], N(ns_r)[:m], rtol=100 * atol)
    np.testing.assert_allclose(N(co)[:m], N(co_r)[:m], rtol=100 * atol,
                               atol=10 * atol)
    assert float(v[:, m:].abs().max()) == 0.0           # pad columns exact 0
    assert float(ns[m:].abs().max()) == float(co[m:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_plain_is_the_model_level_colstats(k10_inputs, dtype):
    """On the port's padded layouts K10's plain version is
    ``rmatmat_colstats_v`` (the model-level colstats + V), the scales
    folded into gr and cols, up to the f32 summation order."""
    x = k10_inputs
    td = getattr(torch, dtype)
    fa_pad = torch.zeros((x.p_pad, 32), dtype=td)
    fa_pad[:x.p, :x.d] = T(x.fa, td)
    f_t = torch.zeros((32, x.n_pad), dtype=td)
    f_t[:x.d] = T(x.fp, td).T
    v, ns, co = k79.colstats_v_plain(fa_pad, f_t, T(x.gr[:, :32]), T(x.y),
                                     T(x.cs), T(x.na), T(x.nb))
    ns_m, co_m, v_m = tst.rmatmat_colstats_v(T(x.fa), T(x.fp), T(x.g),
                                             T(x.y), T(x.rs), T(x.cs), 512,
                                             td)
    rel = OP_REL[dtype]
    assert_rel(N(v)[:, :x.m], N(v_m), rel)
    assert_rel(N(ns)[:x.m], N(ns_m), rel)
    assert_rel(N(co)[:x.m], N(co_m), rel)


# --- the remaining streaming operators ---------------------------------------

def _op_inputs(seed=4, p=64, n=1024, d=25, m=12):
    rng = np.random.default_rng(seed)
    return dict(
        fa=rng.normal(0, 0.3, (p, d)).astype(np.float32),
        fp=rng.normal(0, 0.3, (n, d)).astype(np.float32),
        g=rng.normal(size=(p, m)).astype(np.float32),
        w=rng.normal(size=m).astype(np.float32),
        y=rng.normal(size=n).astype(np.float32),
        rs=rng.uniform(0.5, 1.5, p).astype(np.float32),
        cs=(rng.uniform(0.0, 1.5, n)
            * (rng.random(n) > 0.1)).astype(np.float32))


def test_kexp_check_is_the_plain_tile_entry_on_cpu():
    """The exp check of K9 / K10 (chip_smoke.py counts where the card's
    one-MUFU exp rounds to another bf16) takes the plain tile entry on CPU
    tensors: bf16(exp(-max(d2, 0))), as the plain K10 tile rounds it."""
    d2 = T(np.random.default_rng(4).uniform(-1.0, 90.0, (64, 300)))
    got = k79.kexp_bf16_cuda(d2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), k79._r(torch.exp(-d2.clamp(min=0.0)),
                                            torch.bfloat16))
    assert torch.equal(got, k79.kexp_bf16_plain(d2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colstats_operators_match(jx, dtype):
    jnp, jst = jx.jnp, jx.jst
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = _op_inputs()
    J = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: T(v) for k, v in x.items()}
    rel = OP_REL[dtype]
    block = 256
    args_t = (t["fa"], t["fp"], t["g"])
    args_j = (J["fa"], J["fp"], J["g"])
    for got, ref in zip(
            tst.rmatmat_colstats(*args_t, t["y"], t["rs"], t["cs"], block,
                                 td),
            jst.rmatmat_colstats(*args_j, J["y"], J["rs"], J["cs"], block,
                                 jd)):
        assert_rel(N(got), N(ref), rel)
    for got, ref in zip(
            tst.rmatmat_colstats_v(*args_t, t["y"], t["rs"], t["cs"], block,
                                   td),
            jst.rmatmat_colstats_v(*args_j, J["y"], J["rs"], J["cs"], block,
                                   jd)):
        assert_rel(N(got), N(ref), rel)
    assert_rel(N(tst.rmatmat(*args_t, t["rs"], t["cs"], block, td)),
               N(jst.rmatmat(*args_j, J["rs"], J["cs"], block, jd)), rel)
    assert_rel(N(tst.rmat_apply(*args_t, t["w"], t["rs"], t["cs"], block, td)),
               N(jst.rmat_apply(*args_j, J["w"], J["rs"], J["cs"], block, jd)),
               rel)
    # a wider chunk (the card's choice) changes the f32 sum order only
    assert_rel(N(tst.rmatmat_colstats(*args_t, t["y"], t["rs"], t["cs"], 1000,
                                      td)[0]),
               N(tst.rmatmat_colstats(*args_t, t["y"], t["rs"], t["cs"], block,
                                      td)[0]), 1e-5)


def test_sketch_factor_matches_reference(jx):
    jnp = jx.jnp
    rng = np.random.default_rng(8)
    p, n, m, over, power = 120, 900, 10, 30, 1
    fa = rng.normal(0, 0.4, (p, 6)).astype(np.float32)
    fb = rng.normal(0, 0.4, (n, 6)).astype(np.float32)
    waa = np.exp(-np.sum((fa[:, None] - fa[None]) ** 2, -1)).astype(np.float32)
    wab = np.exp(-np.sum((fa[:, None] - fb[None]) ** 2, -1)).astype(np.float32)
    k = m + over
    om = np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0), (p, k),
                                         jnp.float32))
    vals_r, x_r = jx.jny.nystrom_sketch_factor(jnp.asarray(waa),
                                               jnp.asarray(wab), m, 1e-6,
                                               over, power)
    wt = T(wab)
    vals, x = nystrom_sketch_factor(T(waa), lambda t: wt @ (wt.T @ t), m,
                                    1e-6, over, power, T(om))
    np.testing.assert_allclose(vals.numpy(), N(vals_r), rtol=1e-4)
    # the factor up to the free signs of its columns: its projector
    pr, pt = N(x_r) @ N(x_r).T, x.numpy() @ x.numpy().T
    assert np.abs(pr - pt).max() <= 1e-3 * np.abs(pr).max()
    with pytest.raises(ValueError, match="omega shape"):
        nystrom_sketch_factor(T(waa), lambda t: t, m, 1e-6, over, power,
                              T(om[:, :5]))


def test_superblocked_gram_matches_one_shot(monkeypatch):
    """K7 emits at most GRAM_SUPER columns a launch and sums the f32 partial
    grams in column order: equal to the one-shot gram up to that order."""
    rng = np.random.default_rng(12)
    fa = T(rng.normal(0, 0.3, (100, 25)))
    fp = T(rng.normal(0, 0.3, (2000, 25)))
    fa_aug, f_t = rl.aug_pads(fa, fp, 2048)
    cols = T(rng.uniform(0, 1.5, 2048))
    one_shot = k79._gram(k79.kb_strip_plain(fa_aug, f_t, cols, True))
    calls = []
    real = k79.kb_strip_plain
    monkeypatch.setattr(k79, "kb_strip_plain",
                        lambda *a: calls.append(a[1].shape[1]) or real(*a))
    monkeypatch.setattr(k79, "GRAM_SUPER", 768)
    g = k79.gram_plain(fa_aug, f_t, cols, True)
    assert calls == [768, 768, 512]
    torch.testing.assert_close(g, one_shot, rtol=1e-5, atol=1e-3)


# --- the unfused recompute slice ---------------------------------------------

def _cfg(**kw):
    """The 8 MP turbo recipe's shape at 96x96: bf16 aug tiles, coarse
    Sinkhorn and gram, no polish, LOBPCG — no fused finish."""
    cfg = dict(kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=16,
               sinkhorn_iters=4, streaming=True, block_cols=2048,
               use_pallas=True, sinkhorn_coarse=4, gram_coarse=4,
               affinity_dtype="bfloat16")
    cfg.update(kw)
    return PipelineConfig(**cfg)


def _cfg2(**kw):
    """tests/test_strip_fused.py's config-2 recipe (strip_cache, sketch)."""
    cfg = dict(kernel="nlm", h=0.15, sample_rho=0.02, num_eigvecs=24,
               sinkhorn_iters=6, filter_name="identity", streaming=True,
               strip_cache=True, solver="sketch", sketch_oversample=206,
               sketch_power=0, sinkhorn_coarse=4, sinkhorn_polish=1,
               affinity_dtype="bfloat16_store", use_pallas=True)
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


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_unfused_slice_matches_reference(jx, img_noisy, dtype):
    img, noisy = img_noisy
    cfg = _cfg(affinity_dtype=dtype)
    plan = gt.make_plan(noisy, cfg)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    z, vals = _filter_channel(T(noisy), interop.idx_to_device(plan.idx_a,
                                                              "cpu"),
                              cfg, x0=T(_x0(jx, plan.p, cfg.num_eigvecs)))
    assert_bars(img, z.numpy(), ref.image, BARS[dtype])
    np.testing.assert_allclose(vals[0].numpy(), ref.eigvals[0], rtol=1e-2)


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_unfused_slice_routes_through_k7_and_k10(img_noisy, dtype,
                                                 monkeypatch):
    """Outside the fused gates the factor takes the unfused schedule: the
    cross through K7 (its shape gate holds) and colstats + V through K10,
    once each."""
    _, noisy = img_noisy
    cfg = _cfg(affinity_dtype=dtype)
    plan = gt.make_plan(noisy, cfg)
    calls = {"kb_strip_plain": 0, "colstats_v_plain": 0}
    for name in calls:
        real = getattr(k79, name)

        def spy(*a, _name=name, _real=real):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(k79, name, spy)
    fac = tms._factor_streaming(T(noisy),
                                interop.idx_to_device(plan.idx_a, "cpu"), cfg)
    assert calls == {"kb_strip_plain": 1, "colstats_v_plain": 1}
    assert fac.v_b is not None and tuple(fac.v_b.shape) == (
        fac.y_pad.shape[0], cfg.num_eigvecs)


def test_v_free_branch_matches_v_branch(img_noisy, monkeypatch):
    """Past _V_BYTES_CAP (lowered here in the port only) colstats runs
    without V and the apply recomputes it (rmat_apply)."""
    img, noisy = img_noisy
    cfg = _cfg()
    plan = gt.make_plan(noisy, cfg)
    idx = interop.idx_to_device(plan.idx_a, "cpu")
    x0 = lobpcg_x0(plan.p, cfg.num_eigvecs, "cpu")
    z_v, _ = _filter_channel(T(noisy), idx, cfg, x0=x0)
    monkeypatch.setattr(tms, "_V_BYTES_CAP", 0)
    fac = tms._factor_streaming(T(noisy), idx, cfg, x0=x0)
    assert fac.v_b is None
    z_free, _ = _filter_channel(T(noisy), idx, cfg, x0=x0)
    assert_bars(img, z_free.numpy(), z_v.numpy(), BARS["bfloat16"])


# --- filter_image_staged -----------------------------------------------------

@pytest.mark.parametrize("route", ["recompute", "strip_cache",
                                   "strip_cache_f32"])
def test_staged_matches_reference(jx, img_noisy, route):
    """The staged schedule (unfused, even for a fused-finish recipe) on a
    recompute config and on config 2's strip_cache recipe, with its
    bfloat16_store strip or its f32 one (the f32 bars)."""
    img, noisy = img_noisy
    if route == "recompute":
        cfg = _cfg(sinkhorn_polish=1, fused_finish=True)
        plan = gt.make_plan(noisy, cfg)
        hooks = dict(x0=T(_x0(jx, plan.p, cfg.num_eigvecs)))
    else:
        cfg = (_cfg2(affinity_dtype="float32") if route == "strip_cache_f32"
               else _cfg2())
        plan = gt.make_plan(noisy, cfg)
        k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
        hooks = dict(omega=T(_x0(jx, plan.p, k)))
    ref = jx.gl.filter_image_staged(noisy, jx.cfg(cfg), plan=plan)
    res = _filter_streaming_staged(noisy, cfg, plan, "cpu", **hooks)
    assert set(res.timings) == set(ref.timings) == STAGES
    assert all(v >= 0.0 for v in res.timings.values())
    assert_bars(img, res.image, ref.image,
                BARS["float32" if route == "strip_cache_f32" else "bfloat16"])
    np.testing.assert_allclose(res.eigvals[0], ref.eigvals[0], rtol=1e-2)


def test_filter_image_staged_entry(img_noisy):
    img, noisy = img_noisy
    cfg = _cfg()
    res = gt.filter_image_staged(noisy, cfg, device="cpu")
    assert set(res.timings) == STAGES
    assert res.image.shape == noisy.shape and res.image.dtype == np.float32
    assert res.eigvals.shape == (cfg.num_eigvecs,)
    assert gt.psnr(img, res.image) > gt.psnr(img, noisy) + 0.5
    dense = gt.filter_image_staged(noisy, cfg.replace(streaming=False),
                                   device="cpu")
    assert set(dense.timings) == {"affinity"} | STAGES
    assert dense.image.shape == noisy.shape
    assert gt.psnr(img, dense.image) > gt.psnr(img, noisy) + 0.5
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 M7"):
        gt.filter_image_staged(np.zeros((16, 16, 3), np.float32),
                               cfg.replace(rgb_mode="luma_basis"),
                               device="cpu")
    if not torch.cuda.is_available():      # the default device is the GPU
        with pytest.raises((RuntimeError, AssertionError)):
            gt.filter_image_staged(noisy, cfg)


def test_staged_operator_filter_has_no_eigensolve_stage(img_noisy):
    _, noisy = img_noisy
    cfg = _cfg(filter_name="sharpen", filter_param=0.15, filter_mode="matvec",
               sinkhorn_polish=1)
    plan = gt.make_plan(noisy, cfg)
    res = gt.filter_image_staged(noisy, cfg, plan=plan, device="cpu")
    assert res.timings["eigensolve"] == 0.0
    np.testing.assert_allclose(
        res.image, gt.filter_image(noisy, cfg, plan=plan, device="cpu").image,
        atol=1e-6)


# --- the K10 wrapper ---------------------------------------------------------

def _k10_args():
    rng = np.random.default_rng(9)
    fa = T(rng.normal(0, 0.3, (100, 25)))
    fp = T(rng.normal(0, 0.3, (1000, 25)))
    _, f_t = rl.aug_pads(fa, fp, 1024)
    p = rl.p_tiling(100)[1]
    fa_pad = torch.zeros((p, 32), dtype=torch.bfloat16)
    fa_pad[:100, :25] = fa.to(torch.bfloat16)
    gr = torch.zeros((p, 16))
    gr[:100] = T(rng.normal(size=(100, 16)))
    cols = torch.zeros(1024)
    cols[:1000] = T(rng.uniform(0, 1.5, 1000))
    na = torch.zeros(p)
    na[:100] = torch.sum(fa * fa, dim=1)
    nb = torch.zeros(1024)
    nb[:1000] = torch.sum(fp * fp, dim=1)
    return [fa_pad, f_t, gr, T(rng.normal(size=1024)), cols, na, nb]


def test_k10_cpu_tensors_take_the_plain_version_without_a_launch():
    args = _k10_args()
    before = k79.colstats_v_cuda.launches
    for g, r in zip(k79.colstats_v_cuda(*args), k79.colstats_v_plain(*args)):
        assert torch.equal(g, r)
    assert k79.colstats_v_cuda.launches == before
    v, norms, _ = k79.colstats_v_plain(*args)
    assert float(v[1000:].abs().max()) == 0.0     # cols = 0 on padding
    torch.testing.assert_close(norms, torch.sum(v * v, dim=0))


def test_k10_cuda_branch_raises_instead_of_falling_back(monkeypatch):
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k79, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    args = _k10_args()
    before = k79.colstats_v_cuda.launches
    with pytest.raises(RuntimeError, match="unavailable"):
        k79.colstats_v_cuda(*args)
    # the f32 layout goes to its kernel in the library too, never runs plain
    f32 = [args[0].float(), args[1].float()] + args[2:]
    with pytest.raises(RuntimeError, match="unavailable"):
        k79.colstats_v_cuda(*f32)
    with pytest.raises(ValueError, match="multiple of 16"):
        k79.colstats_v_cuda(*args[:2], args[2][:, :10], *args[3:])
    with pytest.raises(ValueError, match="multiple of 256"):
        k79.colstats_v_cuda(args[0], args[1][:, :1000].contiguous(), args[2],
                            *(a[:1000] for a in args[3:5]), args[5],
                            args[6][:1000])
    assert k79.colstats_v_cuda.launches == before


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m", [(277, 10240, 16), (4000, 16384, 50),
                                   (600, 4096, 100)])
def test_k10_kernel_matches_plain(cuda_device, p, n, m):
    """K10 against its plain version on the card: V to 2^-7 of max |V| (a
    tile entry flips one bf16 ulp where the tensor-core cross sums in
    another f32 order, as K9), norms and coeffs to 5e-3 relative."""
    rng = np.random.default_rng(p)
    dev = cuda_device
    fa = torch.tensor(rng.normal(0, 0.3, (p, 25)).astype(np.float32),
                      device=dev)
    fp = torch.tensor(rng.normal(0, 0.3, (n, 25)).astype(np.float32),
                      device=dev)
    _, f_t = rl.aug_pads(fa, fp, n)
    p_pad = rl.p_tiling(p)[1]
    fa_pad = torch.zeros((p_pad, 32), dtype=torch.bfloat16, device=dev)
    fa_pad[:p, :25] = fa.to(torch.bfloat16)
    gr = torch.zeros((p_pad, tms._m_kernel(m)), device=dev)
    gr[:p, :m] = torch.tensor(rng.normal(size=(p, m)).astype(np.float32),
                              device=dev)
    na = torch.zeros(p_pad, device=dev)
    na[:p] = torch.sum(fa * fa, dim=1)
    nb = torch.sum(fp * fp, dim=1)
    y = torch.tensor(rng.normal(size=n).astype(np.float32), device=dev)
    cols = torch.tensor(rng.uniform(0, 1.5, n).astype(np.float32), device=dev)
    args = (fa_pad, f_t, gr, y, cols, na, nb)
    before = k79.colstats_v_cuda.launches
    v, norms, coeffs = k79.colstats_v_cuda(*args)
    assert k79.colstats_v_cuda.launches - before == -(-gr.shape[1] // 64)
    v_r, norms_r, coeffs_r = k79.colstats_v_plain(*args)
    assert float((v - v_r).abs().max()) <= 2.0 ** -7 * float(v_r.abs().max())
    if m < gr.shape[1]:                             # pad columns exact 0
        assert float(v[:, m:].abs().max()) == 0.0
    # V does not lean to either side of its plain version (V takes both
    # signs, so the lean is (kernel - plain) sign(plain)): the tensor core's
    # accumulation truncates, and V carried in it over p would shrink; V
    # sums in spans of 256 rows, each added to the running V in f32
    keep = v_r != 0
    lean = ((v - v_r) * torch.sign(v_r))[keep]
    below = float((lean < 0).float().mean())
    assert 0.25 < below < 0.75, below
    scale_n = torch.sum(v_r * v_r, dim=0)
    scale_c = torch.abs(y) @ torch.abs(v_r)
    for got, ref, scale in ((norms, norms_r, scale_n),
                            (coeffs, coeffs_r, scale_c)):
        err = (got - ref).abs() / scale.clamp_min(1e-30)
        assert float(err.max()) <= 5e-3
    # repeatable bit for bit: no float atomics
    assert torch.equal(k79.colstats_v_cuda(*args)[0], v)


@pytest.mark.gpu
def test_unfused_slice_on_card_matches_cpu_plain(img_noisy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    img, noisy = img_noisy
    cfg = _cfg()
    plan = gt.make_plan(noisy, cfg)
    x0 = lobpcg_x0(plan.p, cfg.num_eigvecs, "cpu")
    before = (k79.kb_strip_cuda.launches, k79.colstats_v_cuda.launches)
    z_gpu, _ = _filter_channel(T(noisy).cuda(),
                               interop.idx_to_device(plan.idx_a, "cuda"), cfg,
                               x0=x0.cuda())
    after = (k79.kb_strip_cuda.launches, k79.colstats_v_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    z_cpu, _ = _filter_channel(T(noisy), interop.idx_to_device(plan.idx_a,
                                                               "cpu"),
                               cfg, x0=x0)
    assert_bars(img, z_gpu.cpu().numpy(), z_cpu.numpy(), BARS["bfloat16"])
