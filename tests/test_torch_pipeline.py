"""The strip_cache slice of graphlap_tpu_torch against graphlap_tpu: the
streaming model's pieces and the whole filter, at 96x96 on the recipe of
tests/test_strip_fused.py (its ``_base`` with use_pallas=True), with the
reference's sketch matrix Omega injected (torch cannot redraw
jax.random.normal(PRNGKey(0))).

Whole-slice bars are the reference's own fused-vs-unfused bars
(tests/test_strip_fused.py): the port and the Pallas schedule share the
estimator and every rounding point and differ in summation order only —
<= 0.05 dB and atol 2e-2 with a bf16-stored strip (a changed bf16 rounding
of one strip or ws entry propagates through the eigensolve), <= 0.02 dB
and atol 2e-3 with an f32 strip."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.models.pipeline import _filter_channel
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import cuda_strip as k24
from graphlap_tpu_torch.utils import interop

BARS = {"bfloat16_store": (0.05, 2e-2), "float32": (0.02, 2e-3)}
WRAPPERS = (k1.affinity_strip_cuda, k24.strip_ext2_cuda,
            k24.strip_sandwich_spost_cuda, k24.strip_sandwich_cuda)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at module level: the
    card's machine has no JAX, so there these comparisons skip and the gpu
    test of this file still collects and runs."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import graphlap_tpu as gl
    from graphlap_tpu.config import PipelineConfig as JaxConfig
    from graphlap_tpu.models import streaming as jms
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, jms=jms,
                           cfg=lambda c: JaxConfig(**c.to_dict()))


def _base(**kw):
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


@pytest.fixture(scope="module")
def reference(jx, img_noisy):
    """graphlap_tpu.filter_image on the fused Pallas schedule, per dtype,
    and the reference's sketch matrix Omega."""
    _, noisy = img_noisy
    out = {}
    for dt in BARS:
        cfg = _base(affinity_dtype=dt)
        plan = gt.make_plan(noisy, cfg)
        res = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
        k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
        om = np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0),
                                             (plan.p, k), jx.jnp.float32))
        out[dt] = (cfg, plan, res, om)
    return out


def _port(noisy, cfg, plan, omega, device="cpu"):
    z, vals = _filter_channel(
        torch.tensor(noisy, device=device),
        interop.idx_to_device(plan.idx_a, device), cfg,
        interop.block_to_device(omega, device))
    return z.cpu().numpy(), vals.cpu().numpy()


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_slice_matches_reference(img_noisy, reference, dtype):
    img, noisy = img_noisy
    cfg, plan, ref, om = reference[dtype]
    z, vals = _port(noisy, cfg, plan, om)
    db, atol = BARS[dtype]
    assert z.shape == ref.image.shape and np.isfinite(z).all()
    np.testing.assert_allclose(z, ref.image, atol=atol)
    d = abs(gt.psnr(img, z) - gt.psnr(img, ref.image))
    assert d <= db, f"port vs reference PSNR delta {d:.4f} dB"
    # the top eigenvalue is well separated: same value to f32 + rounding
    np.testing.assert_allclose(vals[0], ref.eigvals[0], rtol=1e-2)


def test_filter_image_on_cpu_denoises_without_launching(img_noisy):
    img, noisy = img_noisy
    cfg = _base()
    before = [w.launches for w in WRAPPERS]
    res = gt.filter_image(noisy, cfg, device="cpu")
    assert [w.launches for w in WRAPPERS] == before
    assert isinstance(res, gt.FilterResult)
    assert res.image.shape == noisy.shape and res.image.dtype == np.float32
    assert res.eigvals.shape == (cfg.num_eigvecs,)
    assert gt.psnr(img, res.image) > gt.psnr(img, noisy) + 3.0


def test_filter_image_without_cuda_raises(img_noisy):
    """The default device is the GPU; without CUDA the call raises rather
    than running anywhere else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, noisy = img_noisy
    cfg = _base()
    before = [w.launches for w in WRAPPERS]
    with pytest.raises((RuntimeError, AssertionError)):
        gt.filter_image(noisy, cfg)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("kw", [
    dict(solver="lobpcg"),
    dict(strip_cache=False, solver="lobpcg", feature_dtype="bfloat16"),
    dict(filter_mode="matvec"),
    dict(solver="oneshot"),
    dict(use_pallas=False),
    dict(strip_cache=False, solver="lobpcg", use_pallas=False),
])
def test_outside_the_slice_raises(img_noisy, kw):
    _, noisy = img_noisy
    cfg = _base(**kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.filter_image(noisy, cfg, device="cpu")


def test_rgb_and_mesh_raise(img_noisy):
    """Per-channel RGB runs (tests/test_torch_matvec.py); the luma-basis
    mode and the mesh still raise."""
    cfg = _base()
    with pytest.raises(NotImplementedError, match="M7"):
        gt.filter_image(np.zeros((16, 16, 3), np.float32),
                        cfg.replace(rgb_mode="luma_basis"), device="cpu")
    with pytest.raises(NotImplementedError, match="M9"):
        gt.filter_image(img_noisy[1], cfg, mesh=object(), device="cpu")


@pytest.mark.parametrize("mode", ["diag", "stride"])
@pytest.mark.parametrize("n_pad,k,w", [(9216, 4, 96), (262144, 16, 512),
                                       (4096, 7, 64)])
def test_sinkhorn_sample_idx(jx, n_pad, k, w, mode):
    np.testing.assert_array_equal(
        tms.sinkhorn_sample_idx(n_pad, k, w, mode),
        jx.jms.sinkhorn_sample_idx(n_pad, k, w, mode))


@pytest.fixture(scope="module")
def contexts(jx, img_noisy):
    _, noisy = img_noisy
    pc = _base()
    cfg = jx.cfg(pc)
    plan = gt.make_plan(noisy, pc)
    jctx = jx.jms._strip_ctx(jx.jnp.asarray(noisy),
                             jx.jnp.asarray(plan.idx_a), cfg)
    tctx = tms._strip_ctx(torch.tensor(noisy),
                          interop.idx_to_device(plan.idx_a, "cpu"), pc)
    return cfg, pc, jctx, tctx


def test_strip_ctx_matches(jx, contexts):
    jnp = jx.jnp
    cfg, pc, jctx, tctx = contexts
    assert (tctx.n, tctx.p, tctx.n_pad, tctx.block, tctx.w) == (
        jctx.n, jctx.p, jctx.n_pad, jctx.block, jctx.w)
    np.testing.assert_array_equal(tctx.b_mask.numpy(), np.asarray(jctx.b_mask))
    np.testing.assert_allclose(tctx.feats_pad.numpy(),
                               np.asarray(jctx.feats_pad), atol=1e-6)
    np.testing.assert_allclose(tctx.kaa.numpy(), np.asarray(jctx.kaa),
                               atol=5e-5)
    # the bf16 strip: one bf16 ulp where an f32 value sits on a boundary
    np.testing.assert_allclose(
        tctx.strip.float().numpy(),
        np.asarray(jctx.strip.astype(jnp.float32)), atol=2.0 ** -8)
    assert tctx.strip_pad.shape[0] % k24.P_QUANTUM == 0
    pad = tctx.strip_pad[tctx.p:]
    assert pad.shape[0] > 0 and (pad == 0).all()   # exact-zero padding rows
    assert (tms._strip_fused_ok(tctx, pc)
            and jx.jms._strip_fused_ok(jctx, cfg))


def test_padding_rows_and_columns_exact_zero():
    """With padding on both sides (n_pad > N: a 40x48 image in 1024-wide
    blocks), every padding row and column of the strip is exactly 0."""
    cfg = _base(block_cols=1024)
    noisy = np.clip(gt.add_gaussian_noise(gt.make_test_image(40, 48), 0.1,
                                          seed=2), 0, 1).astype(np.float32)
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(torch.tensor(noisy),
                         interop.idx_to_device(plan.idx_a, "cpu"), cfg)
    assert ctx.n_pad > ctx.n and ctx.strip_pad.shape[0] > ctx.p
    assert (ctx.strip_pad[ctx.p:] == 0).all()
    assert (ctx.strip_pad[:, ctx.n:] == 0).all()
    assert (ctx.strip_pad[:ctx.p, :ctx.n] > 0).any()
    z, _ = _filter_channel(torch.tensor(noisy),
                           interop.idx_to_device(plan.idx_a, "cpu"), cfg)
    assert z.shape == noisy.shape and torch.isfinite(z).all()


def test_coarse_sinkhorn_state_matches(jx, contexts):
    cfg, pc, jctx, tctx = contexts
    ref = [np.asarray(a) for a in jx.jms._coarse_sinkhorn_state(jctx, cfg)]
    got = [a.numpy() for a in tms._coarse_sinkhorn_state(tctx, pc)]
    for g, r in zip(got, ref):
        # the same bf16 strip entries up to a rare one-ulp flip, f32 sums
        # in another order, six alternating iterations: 1e-3 relative
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-3 * np.abs(r).max())


@pytest.mark.gpu
def test_slice_on_card_matches_cpu_plain(img_noisy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    img, noisy = img_noisy
    cfg = _base()
    plan = gt.make_plan(noisy, cfg)
    k = min(cfg.num_eigvecs + cfg.sketch_oversample, plan.p)
    om = tms.sketch_omega(plan.p, k, "cpu").numpy()
    before = [w.launches for w in WRAPPERS]
    z_gpu, _ = _port(noisy, cfg, plan, om, device="cuda")
    assert all(w.launches > b for w, b in zip(WRAPPERS, before))
    z_cpu, _ = _port(noisy, cfg, plan, om, device="cpu")
    np.testing.assert_allclose(z_gpu, z_cpu, atol=2e-2)
    assert abs(gt.psnr(img, z_gpu) - gt.psnr(img, z_cpu)) <= 0.05
