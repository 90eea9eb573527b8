"""The recompute-streaming fused-finish slice of graphlap_tpu_torch (config 4)
against graphlap_tpu: the layout helpers, the streaming operators, the
K7-K9 plain versions against the Pallas kernels (interpret mode on the
CPU, as tests/test_pallas.py runs them), the port's LOBPCG against
jax's ``lobpcg_standard``, the wrappers' dispatch, and the whole 96x96
slice with the reference's LOBPCG start block injected (torch cannot
redraw jax.random.normal(PRNGKey(0))). On a CUDA card only (marker
``gpu``): each kernel against its plain version, and the slice on the card
against the plain versions on the CPU.

Tolerances, relative to the largest reference magnitude unless stated:
* f32 arithmetic in another summation order: 2e-5 (tests/test_pallas.py's
  own f32 bar for these kernels).
* bf16 tiles: 2e-2 for K8 and 5e-3 for K9 (tests/test_pallas.py's bars):
  a d2 that differs in its last f32 bits can round to the other bf16
  neighbour, moving that tile entry by one bf16 ulp (2^-8 relative).
* K7's bf16 output: two bf16 ulps (2^-7) absolute on entries <= 1, for
  the tile entry's flip and the product's own rounding.
* Whole slice: the bars of the config-2 slice (tests/test_strip_fused.py's
  fused-vs-unfused bars): <= 0.05 dB, atol 2e-2 (bf16 tiles); <= 0.02 dB,
  atol 2e-3 (f32), which is also the reference's own fused-vs-schedule
  bar (tests/test_streaming.py:258); scale vectors to 1e-5 (f32), as
  tests/test_streaming.py:252-255.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.config import PipelineConfig
from graphlap_tpu_torch.models import streaming as tms
from graphlap_tpu_torch.models.pipeline import _filter_channel
from graphlap_tpu_torch.ops import _build
from graphlap_tpu_torch.ops import cuda_recompute as k79
from graphlap_tpu_torch.ops import lobpcg as tlob
from graphlap_tpu_torch.ops.nystrom import lobpcg_x0
from graphlap_tpu_torch.ops import recompute_layout as rl
from graphlap_tpu_torch.ops import streaming as tst
from graphlap_tpu_torch.utils import interop
from tests.test_torch_wide import torch_threads

REL_F32 = 2e-5
WRAPPERS = (k79.kb_strip_cuda, k79.ext2_matvec_cuda, k79.finish_colstats_cuda)
BARS = {"bfloat16": (0.05, 2e-2), "float32": (0.02, 2e-3)}


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
    from graphlap_tpu.ops import pallas_streaming as pst
    from graphlap_tpu.ops import streaming as jst
    from jax.experimental.sparse.linalg import lobpcg_standard
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, jms=jms, pst=pst, jst=jst,
                           lobpcg=lobpcg_standard,
                           cfg=lambda c: JaxConfig(**c.to_dict()))


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


# --- layout helpers --------------------------------------------------------

def test_aug_pads_lanes_bit_equal_and_compensated(jx):
    rng = np.random.default_rng(11)
    for p, n, d, scale in ((16, 32, 25, 2.0), (300, 700, 25, 1.0),
                           (40, 90, 27, 3.0)):
        fa = rng.random((p, d), np.float32) * scale
        fn = rng.random((n, d), np.float32) * scale
        ra, rt = jx.pst.aug_pads(jx.jnp.asarray(fa), jx.jnp.asarray(fn),
                                 n + 64)
        ta, tt = rl.aug_pads(T(fa), T(fn), n + 64)
        assert ta.dtype == tt.dtype == torch.bfloat16
        np.testing.assert_array_equal(N(ta), N(ra))
        np.testing.assert_array_equal(N(tt), N(rt))
        # the compensation lanes carry residue (a collapsed split zeroes them)
        assert N(ta)[:p, d + 1].__abs__().max() > 0
        assert N(tt)[d + 4, :n].__abs__().max() > 0


def test_layout_quanta_match(jx):
    import jax.numpy as jnp
    pst = jx.pst
    for p in (1, 277, 512, 513, 4096, 4097, 5243, 8192, 9000):
        assert rl.p_tiling(p) == pst.p_tiling(p)
    for d in (1, 25, 26, 32, 33, 100, 122, 128):
        assert rl.d_pad_of(d) == pst.d_pad_of(d)
        if d + rl.AUG_LANES <= rl.D_PAD:
            assert rl.aug_d_pad_of(d) == pst.aug_d_pad_of(d)
    for m in (1, 16, 50, 64, 128):
        assert rl.m_pad_of(m) == pst.m_pad_of(m)
    assert rl._tile_n(torch.bfloat16) == pst._tile_n(jnp.bfloat16)
    assert rl._tile_n(torch.float32) == pst._tile_n(jnp.float32)
    assert (rl.MAX_TILE_P, rl.M_PAD, rl.EMIT_TN, rl.FINISH_EPS) == (
        pst.MAX_TILE_P, pst.M_PAD, pst.EMIT_TN, pst.FINISH_EPS)
    with pytest.raises(ValueError, match="whole-p"):
        rl._require_whole_p(2 * rl.MAX_TILE_P, "x")


@pytest.mark.parametrize("k", [4, 16, 64])
@pytest.mark.parametrize("seed", [0, 3])
def test_gram_sample_idx_bit_identical(jx, k, seed):
    for n_pad in (10240, 262144, 8388608):
        np.testing.assert_array_equal(
            tms.gram_sample_idx(n_pad, k, seed),
            jx.jms.gram_sample_idx(n_pad, k, seed))


# --- the streaming operators ------------------------------------------------

def _op_inputs(seed=4, p=64, n=1024, d=25):
    rng = np.random.default_rng(seed)
    return dict(
        fa=rng.normal(0, 0.3, (p, d)).astype(np.float32),
        fp=rng.normal(0, 0.3, (n, d)).astype(np.float32),
        v=rng.normal(size=n).astype(np.float32),
        t=rng.uniform(0.5, 1.5, p).astype(np.float32),
        rs=rng.uniform(0.5, 1.5, p).astype(np.float32),
        cs=(rng.uniform(0.0, 1.5, n) * (rng.random(n) > 0.1)).astype(np.float32),
        mask=(rng.random(n) > 0.2).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_operators_match(jx, dtype):
    jnp, jst = jx.jnp, jx.jst
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = _op_inputs()
    J = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: T(v) for k, v in x.items()}
    rel = REL_F32 if dtype == "float32" else 5e-3
    block = 256
    assert_rel(tst.matvec(t["fa"], t["fp"], t["v"], t["rs"], t["cs"], block,
                          td),
               jst.matvec(J["fa"], J["fp"], J["v"], J["rs"], J["cs"], block,
                          jd), rel)
    assert_rel(tst.rmatvec(t["fa"], t["fp"], t["t"], t["rs"], t["cs"], block,
                           td),
               jst.rmatvec(J["fa"], J["fp"], J["t"], J["rs"], J["cs"], block,
                           jd), rel)
    assert_rel(tst.gram(t["fa"], t["fp"], t["rs"], t["cs"], block, td),
               jst.gram(J["fa"], J["fp"], J["rs"], J["cs"], block, jd), rel)
    assert_rel(tst.sinkhorn_coarse_step(t["fa"], t["fp"], t["t"], t["mask"],
                                        1.7, block, td),
               jst.sinkhorn_coarse_step(J["fa"], J["fp"], J["t"], J["mask"],
                                        1.7, block, jd), rel)
    # a wider chunk (the card's choice) changes the f32 sum order only
    assert_rel(tst.matvec(t["fa"], t["fp"], t["v"], t["rs"], t["cs"], 1000,
                          td),
               tst.matvec(t["fa"], t["fp"], t["v"], t["rs"], t["cs"], block,
                          td), 1e-5)


# --- K7-K9 plain versions against the Pallas kernels ------------------------

def _kernel_inputs(jx, dtype, aug, seed=5, p=512, n=2048, d=25):
    """Layouts and vectors for the kernels, built with the reference's own
    pads and handed to both packages bit for bit."""
    jnp, pst = jx.jnp, jx.pst
    rng = np.random.default_rng(seed)
    fa = rng.normal(0, 0.3, (p, d)).astype(np.float32)
    fp = rng.normal(0, 0.3, (n, d)).astype(np.float32)
    jd = jnp.dtype(dtype)
    _, p_pad = pst.p_tiling(p)
    dp = pst.d_pad_of(d)
    fa_pad = jnp.zeros((p_pad, dp), jd).at[:p, :d].set(jnp.asarray(fa).astype(jd))
    if aug:
        fa_mv, f_t = pst.aug_pads(jnp.asarray(fa), jnp.asarray(fp), n)
    else:
        f_t = jnp.zeros((dp, n), jd).at[:d, :].set(jnp.asarray(fp).astype(jd).T)
        fa_mv = fa_pad
    bm = (rng.random(n) > 0.2).astype(np.float32)
    bm[-64:] = 0.0                             # padding columns
    t2 = np.zeros((2, p_pad), np.float32)
    t2[:, :p] = rng.uniform(0.5, 1.5, (2, p))
    t = np.zeros(p_pad, np.float32)
    t[:p] = rng.uniform(0.5, 1.5, p)
    na = np.zeros(p_pad, np.float32)
    na[:p] = np.sum(fa * fa, axis=1)
    nb = np.sum(fp * fp, axis=1).astype(np.float32)
    return SimpleNamespace(
        fa_mv=fa_mv, fa_pad=fa_pad, f_t=f_t, bm=bm, t2=t2, t=t, na=na, nb=nb,
        s_pre=(rng.uniform(0.0, 1.5, n) * bm).astype(np.float32),
        y=rng.normal(size=n).astype(np.float32),
        g=rng.normal(size=(p, 20)).astype(np.float32),
        cols=rng.uniform(0.0, 1.5, n).astype(np.float32), p=p,
        td=getattr(torch, dtype))


def _t(x, like):
    """A reference layout as a torch tensor of the same dtype."""
    return T(N(x), like)


@pytest.mark.parametrize("dtype,aug", [("bfloat16", True),
                                       ("bfloat16", False),
                                       ("float32", False)])
def test_k7_plain_matches_pallas(jx, dtype, aug):
    x = _kernel_inputs(jx, dtype, aug)
    ft, cols = x.f_t[:, :1024], x.cols[:1024]
    ref = N(jx.pst.kb_strip_pallas(x.fa_mv, ft, jx.jnp.asarray(cols),
                                   aug=aug))
    got = k79.kb_strip_plain(_t(x.fa_mv, x.td), _t(ft, x.td), T(cols), aug)
    assert got.dtype == x.td
    if dtype == "float32":
        assert_rel(N(got), ref, REL_F32)
    else:
        np.testing.assert_allclose(N(got), ref, atol=2.0 ** -7, rtol=0)
        assert np.mean(N(got) == ref) > 0.99
    # the gram over the emitted block: one bf16-in / f32-out GEMM
    g_ref = N(jx.pst.gram_pallas(x.fa_mv, ft, jx.jnp.asarray(cols), 512,
                                 aug=aug))
    g = k79.gram_plain(_t(x.fa_mv, x.td), _t(ft, x.td), T(cols), aug)
    assert_rel(N(g), g_ref, REL_F32 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype,aug", [("bfloat16", True),
                                       ("float32", False)])
def test_k8_plain_matches_pallas(jx, dtype, aug):
    jnp = jx.jnp
    x = _kernel_inputs(jx, dtype, aug)
    u_r, s_r = jx.pst.ext2_matvec_pallas(x.fa_mv, x.f_t, jnp.asarray(x.t2),
                                         jnp.asarray(x.bm), aug=aug)
    u, s = k79.ext2_matvec_plain(_t(x.fa_mv, x.td), _t(x.f_t, x.td), T(x.t2),
                                 T(x.bm), aug)
    rel = REL_F32 if dtype == "float32" else 2e-2
    assert_rel(N(u), N(u_r), rel)
    assert_rel(N(s), N(s_r), rel)
    assert (N(s)[x.bm == 0] == 0).all()        # padding and A columns: s = 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m_pad", [64, 128])
def test_k9_plain_matches_pallas(jx, dtype, m_pad):
    jnp = jx.jnp
    x = _kernel_inputs(jx, dtype, aug=(dtype == "bfloat16"), seed=6)
    p_pad = x.fa_pad.shape[0]
    gr = np.zeros((p_pad, m_pad), np.float32)
    gr[:x.p, :20] = x.g
    # K9 reads the plain fa with the aug f_t superset on the bf16 path
    ref = jx.pst.finish_colstats_pallas(
        x.fa_pad, x.f_t, jnp.asarray(x.t), jnp.asarray(x.s_pre),
        jnp.asarray(x.bm), jnp.asarray(gr), jnp.asarray(x.y),
        jnp.asarray(x.na), jnp.asarray(x.nb))
    got = k79.finish_colstats_plain(
        _t(x.fa_pad, x.td), _t(x.f_t, x.td), T(x.t), T(x.s_pre), T(x.bm),
        T(gr), T(x.y), T(x.na), T(x.nb))
    rel = REL_F32 if dtype == "float32" else 5e-3
    for g, r in zip(got, ref):
        assert_rel(N(g), N(r), rel)
    assert float(got[0][:, 20:].abs().max()) == 0.0   # pad columns exact 0
    assert (N(got[3])[x.bm == 0] == 0).all()


# --- LOBPCG -----------------------------------------------------------------

@pytest.mark.parametrize("n,k,iters", [(300, 12, 60), (200, 8, 5)])
def test_lobpcg_matches_jax(jx, n, k, iters):
    rng = np.random.default_rng(n + k)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([np.linspace(3.0, 1.0, 2 * k),
                          0.5 * rng.random(n - 2 * k)])
    a = ((q * lam) @ q.T).astype(np.float32)
    a = 0.5 * (a + a.T)
    x0 = rng.normal(size=(n, k)).astype(np.float32)
    aj = jx.jnp.asarray(a)
    th_r, u_r, it_r = jx.lobpcg(lambda v: aj @ v, jx.jnp.asarray(x0), m=iters)
    at = T(a)
    th, u, it = tlob.lobpcg_standard(lambda v: at @ v, T(x0), m=iters)
    assert it == int(it_r)
    np.testing.assert_allclose(th.numpy(), N(th_r), rtol=1e-4)
    # compare subspaces through projections, not raw vectors
    pr, pt = N(u_r) @ N(u_r).T, u.numpy() @ u.numpy().T
    assert np.abs(pr - pt).max() < (1e-3 if iters > 10 else 2e-2)
    if iters > 10:    # converged: the true top-k eigenvalues
        np.testing.assert_allclose(th.numpy(), lam[:k], rtol=1e-4)


# --- the whole slice ---------------------------------------------------------

def _cfg(**kw):
    cfg = dict(kernel="nlm", h=0.25, sample_rho=0.03, num_eigvecs=16,
               sinkhorn_iters=4, streaming=True, block_cols=2048,
               use_pallas=True, sinkhorn_coarse=4, sinkhorn_polish=1,
               gram_coarse=4, fused_finish=True)
    cfg.update(kw)
    return PipelineConfig(**cfg)


@pytest.fixture(scope="module")
def img_noisy():
    img = gt.make_test_image(96, 96)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    return img, noisy.astype(np.float32)


@pytest.fixture(scope="module")
def reference(jx, img_noisy):
    """graphlap_tpu.filter_image per tile dtype, its factor's scale vectors,
    and its LOBPCG start block."""
    jnp = jx.jnp
    _, noisy = img_noisy
    out = {}
    for dt in BARS:
        cfg = _cfg(affinity_dtype=dt)
        plan = gt.make_plan(noisy, cfg)
        jcfg = jx.cfg(cfg)
        res = jx.gl.filter_image(noisy, jcfg, plan=plan)
        fac = jx.jms._factor_streaming(jnp.asarray(noisy),
                                       jnp.asarray(plan.idx_a), jcfg)
        x0 = np.asarray(jx.jax.random.normal(
            jx.jax.random.PRNGKey(0), (plan.p, cfg.num_eigvecs),
            jnp.float32))
        out[dt] = (cfg, plan, res, fac, x0)
    return out


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_slice_matches_reference(img_noisy, reference, dtype):
    """The port's run on two threads (``torch_threads``)."""
    img, noisy = img_noisy
    cfg, plan, ref, _, x0 = reference[dtype]
    with torch_threads(2):
        z, vals = _filter_channel(T(noisy), interop.idx_to_device(
            plan.idx_a, "cpu"), cfg, x0=interop.block_to_device(x0, "cpu"))
    z = z.numpy()
    db, atol = BARS[dtype]
    assert z.shape == ref.image.shape and np.isfinite(z).all()
    np.testing.assert_allclose(z, ref.image, atol=atol)
    d = abs(gt.psnr(img, z) - gt.psnr(img, ref.image))
    assert d <= db, f"port vs reference PSNR delta {d:.4f} dB"
    np.testing.assert_allclose(vals[0].numpy(), ref.eigvals[0], rtol=1e-2)


def test_slice_scales_match_reference_f32(img_noisy, reference):
    _, noisy = img_noisy
    cfg, plan, _, fac_r, x0 = reference["float32"]
    fac = tms._factor_streaming(T(noisy),
                                interop.idx_to_device(plan.idx_a, "cpu"),
                                cfg, x0=T(x0))
    np.testing.assert_allclose(fac.s_a.numpy(), N(fac_r.s_a), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fac.s_b_cols.numpy(), N(fac_r.s_b_cols),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_slice_takes_fused_finish_and_k7_branch(jx, img_noisy, dtype,
                                                monkeypatch):
    """Both packages route the 96x96 recipe through the fused finish and
    the K7 gram (the reference's gates: 512-aligned p_tiling, n_pad =
    n_pad_k, 512-column gram blocks), with padding columns present."""
    _, noisy = img_noisy
    cfg = _cfg(affinity_dtype=dtype)
    plan = gt.make_plan(noisy, cfg)
    jcfg = jx.cfg(cfg)
    jctx = jx.jms._strip_ctx(jx.jnp.asarray(noisy),
                             jx.jnp.asarray(plan.idx_a), jcfg)
    tctx = tms._strip_ctx(T(noisy), interop.idx_to_device(plan.idx_a, "cpu"),
                          cfg)
    assert (tctx.n, tctx.p, tctx.n_pad, tctx.block) == (
        jctx.n, jctx.p, jctx.n_pad, jctx.block)
    assert tctx.n_pad == 10240 > tctx.n                # padding columns
    assert tuple(tctx.fa_pad.shape) == tuple(jctx.fa_pad.shape)
    assert tuple(tctx.f_t.shape) == tuple(jctx.f_t.shape)
    assert (tctx.fa_aug is None) == (jctx.fa_aug is None) == (
        dtype == "float32")
    # the same features up to f32 extraction order (atol 1e-6, as
    # tests/test_torch_pipeline.py holds them), rounded to the tile dtype
    np.testing.assert_allclose(N(tctx.f_t), N(jctx.f_t), rtol=2.0 ** -8,
                               atol=1e-6)
    assert tms._fused_finish_ok(tctx, cfg)
    assert jx.jms._fused_finish_ok(jctx, jcfg)
    blk = cfg.block_cols // cfg.gram_coarse
    for ctx in (tctx, jctx):
        assert ctx.f_t.shape[1] == ctx.n_pad and blk % rl.EMIT_TN == 0
    # and the port's cross does run through the K7 emitter
    calls = []
    real = k79.kb_strip_plain
    monkeypatch.setattr(k79, "kb_strip_plain",
                        lambda *a: calls.append(1) or real(*a))
    tms._factor_streaming(T(noisy), interop.idx_to_device(plan.idx_a, "cpu"),
                          cfg)
    assert calls


def test_padding_invariants():
    """Zero rows of fa_aug give kb = 1 and of the plain fa kb = exp(-nb),
    both annihilated by zero t2 / t / gr rows; padding columns carry bm = 0
    and s_pre = 0, so s = 0 and they add nothing to u, V, norms, coeffs."""
    rng = np.random.default_rng(2)
    p, n, d = 100, 1000, 25
    fa = T(rng.normal(0, 0.3, (p, d)))
    fp = T(rng.normal(0, 0.3, (n, d)))
    fa_aug, f_t = rl.aug_pads(fa, fp, 1024)
    p_pad = fa_aug.shape[0]
    kb = k79.kb_strip_plain(fa_aug, f_t, torch.ones(1024), aug=True)
    assert (kb[p:] == 1).all() and (kb[:, n:] == 1).all()
    bm = torch.zeros(1024)
    bm[:n] = 1.0
    t2 = torch.zeros((2, p_pad))
    t2[:, :p] = 1.0
    u, s = k79.ext2_matvec_plain(fa_aug, f_t, t2, bm, aug=True)
    assert (s[n:] == 0).all() and (u[p:] > 0).all()
    # u only sees real columns: the same as an exact-size run
    u_n, _ = k79.ext2_matvec_plain(fa_aug, f_t[:, :n].contiguous(), t2,
                                   bm[:n], aug=True)
    torch.testing.assert_close(u[:p], u_n[:p], rtol=1e-6, atol=0)
    fa_pad = torch.zeros((p_pad, f_t.shape[0]), dtype=torch.bfloat16)
    fa_pad[:p, :d] = fa.to(torch.bfloat16)
    na = torch.zeros(p_pad)
    na[:p] = torch.sum(fa * fa, dim=1)
    nb = torch.zeros(1024)
    nb[:n] = torch.sum(fp * fp, dim=1)
    gr = torch.zeros((p_pad, 16))
    gr[:p] = T(rng.normal(size=(p, 16)))
    t = torch.zeros(p_pad)
    t[:p] = 1.0
    v, norms, coeffs, s9 = k79.finish_colstats_plain(
        fa_pad, f_t, t, bm * 0.5, bm, gr, torch.ones(1024), na, nb)
    assert (s9[n:] == 0).all() and (v[n:] == 0).all()
    torch.testing.assert_close(norms, torch.sum(v * v, dim=0))


# --- dispatch and routing -----------------------------------------------------

def _counts():
    return [w.launches for w in WRAPPERS]


def test_filter_image_on_cpu_runs_the_recompute_slice(img_noisy):
    img, noisy = img_noisy
    cfg = _cfg(affinity_dtype="bfloat16")
    before = _counts()
    res = gt.filter_image(noisy, cfg, device="cpu")
    assert _counts() == before
    assert res.image.shape == noisy.shape and res.image.dtype == np.float32
    assert res.eigvals.shape == (cfg.num_eigvecs,)
    assert gt.psnr(img, res.image) > gt.psnr(img, noisy) + 0.5


def test_recompute_filter_image_without_cuda_raises(img_noisy):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        gt.filter_image(img_noisy[1], _cfg())


@pytest.mark.parametrize("kw,item", [
    (dict(use_pallas=False, fused_finish=False), "M6"),
    (dict(use_pallas=False, fused_finish=False, solver="chol"), "M6"),
    (dict(solver="oneshot"), "M2"),
    (dict(feature_dtype="bfloat16"), "M6"),
])
def test_recompute_outside_the_slice_raises(img_noisy, kw, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item}"):
        gt.filter_image(img_noisy[1], _cfg(**kw), device="cpu")


def test_past_the_fused_finish_gate_raises():
    """p_pad > MAX_TILE_P: the fused finish's gate refuses the shapes, and
    the factor takes the unfused schedule instead, as the reference's
    does. p stays past 4096 (4608, every pixel of 64 x 72); the rank, the
    coarse factors and the column blocks are cut to the least the schedule
    takes, and its p x p Cholesky solves run on two threads
    (``torch_threads``: on torch's default count beside busy neighbours
    one took seconds)."""
    cfg = _cfg(sample_rho=1.0, sample_cap=8192, num_eigvecs=2,
               block_cols=9216, sinkhorn_coarse=16, gram_coarse=16)
    img = gt.make_test_image(64, 72)
    plan = gt.make_plan(img, cfg)
    assert plan.p > rl.MAX_TILE_P
    idx = interop.idx_to_device(plan.idx_a, "cpu")
    with torch_threads(2):
        ctx = tms._strip_ctx(T(img), idx, cfg)
        assert not tms._fused_finish_ok(ctx, cfg)
        fac = tms._factor_streaming(T(img), idx, cfg)
    assert np.isfinite(fac.vals.numpy()).all()
    assert np.isfinite(fac.v_b.numpy()).all() and fac.v_b.shape[1] == 2


def _small_layouts():
    rng = np.random.default_rng(9)
    fa = T(rng.normal(0, 0.3, (100, 25)))
    fp = T(rng.normal(0, 0.3, (1000, 25)))
    fa_aug, f_t = rl.aug_pads(fa, fp, 1024)
    fa_pad = torch.zeros_like(fa_aug)
    fa_pad[:100, :25] = fa.to(torch.bfloat16)
    p = fa_aug.shape[0]
    v = lambda n: torch.ones(n)  # noqa: E731
    return SimpleNamespace(
        fa_aug=fa_aug, fa_pad=fa_pad, f_t=f_t,
        k7=(fa_aug, f_t, v(1024), True),
        k8=(fa_aug, f_t, torch.ones((2, p)), v(1024), True),
        k9=(fa_pad, f_t, v(p), v(1024), v(1024), torch.ones((p, 16)),
            v(1024), v(p), v(1024)))


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    x = _small_layouts()
    before = _counts()
    assert torch.equal(k79.kb_strip_cuda(*x.k7), k79.kb_strip_plain(*x.k7))
    for g, r in zip(k79.ext2_matvec_cuda(*x.k8), k79.ext2_matvec_plain(*x.k8)):
        assert torch.equal(g, r)
    for g, r in zip(k79.finish_colstats_cuda(*x.k9),
                    k79.finish_colstats_plain(*x.k9)):
        assert torch.equal(g, r)
    assert _counts() == before


@pytest.mark.parametrize("which", range(3))
def test_wrappers_refuse_devices_they_cannot_serve(which):
    x = _small_layouts()
    args = list((x.k7, x.k8, x.k9)[which])
    args[0] = torch.empty(args[0].shape, dtype=args[0].dtype, device="meta")
    with pytest.raises(ValueError, match="device"):
        WRAPPERS[which](*args)


def test_cuda_branch_raises_instead_of_falling_back(monkeypatch):
    """Where the kernel cannot run, the CUDA branch raises: no path
    returns the plain version's result for a CUDA tensor."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k79, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    x = _small_layouts()
    before = _counts()
    for fn, args in zip(WRAPPERS, (x.k7, x.k8, x.k9)):
        with pytest.raises(RuntimeError, match="unavailable"):
            fn(*args)
    assert _counts() == before
    # f32 plain layouts go to the kernel library (here missing), never run
    # plain
    f32 = [a.float() if isinstance(a, torch.Tensor) else a for a in x.k8]
    f32[0], f32[-1] = x.fa_pad.float(), False
    with pytest.raises(RuntimeError, match="unavailable"):
        k79.ext2_matvec_cuda(*f32)
    with pytest.raises(RuntimeError, match="unavailable"):
        k79.kb_strip_cuda(f32[0], f32[1], torch.ones(1024), False)
    # layouts the kernels do not take raise, never run plain: the plain
    # bf16 K7/K8 layout and an f32 aug one
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k79.kb_strip_cuda(x.fa_pad, x.f_t, torch.ones(1024), False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k79.ext2_matvec_cuda(x.fa_pad, *x.k8[1:4], False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        k79.ext2_matvec_cuda(x.fa_aug.float(), *f32[1:4], True)
    with pytest.raises(ValueError, match="multiple of 512"):
        k79.ext2_matvec_cuda(x.fa_aug[:100], x.f_t, torch.ones((2, 100)),
                             torch.ones(1024), True)
    assert _counts() == before


def _guard_case(which, p_pad=512, n=1024, m=16):
    """Arguments of K8 (which 0) or K9 (which 1) at the given shapes."""
    bf = torch.bfloat16
    fa, f_t = torch.zeros((p_pad, 32), dtype=bf), torch.zeros((32, n), dtype=bf)
    if which == 0:
        return k79.ext2_matvec_cuda, (fa, f_t, torch.ones((2, p_pad)),
                                      torch.ones(n), True)
    return k79.finish_colstats_cuda, (fa, f_t, torch.ones(p_pad), torch.ones(n),
                                      torch.ones(n), torch.ones((p_pad, m)),
                                      torch.ones(n), torch.ones(p_pad),
                                      torch.ones(n))


@pytest.mark.parametrize("which,shape,err,match", [
    (0, dict(p_pad=256), ValueError, "multiple of 512"),
    (0, dict(p_pad=8192), ValueError, "whole-p"),
    (0, dict(n=1056), ValueError, "multiple of 64"),
    (1, dict(p_pad=256), ValueError, "multiple of 512"),
    (1, dict(n=1088), ValueError, "multiple of 256"),
    (1, dict(m=20), ValueError, "multiple of 16"),
    (1, dict(m=144), ValueError, "multiple of 16"),
    # K9 holds no whole-p tile: p_pad 8192 passes its guards and reaches the
    # (here missing) kernel library
    (1, dict(p_pad=8192), RuntimeError, "unavailable"),
    (0, dict(p_pad=4096, n=64), RuntimeError, "unavailable"),
], ids=["k8-p256", "k8-p8192", "k8-n1056", "k9-p256", "k9-n1088", "k9-m20",
        "k9-m144", "k9-p8192", "k8-p4096"])
def test_kernel_shape_guards_raise_before_a_launch(monkeypatch, which, shape,
                                                   err, match):
    """The new tiles' shape guards (K8: p_pad % 512, p_pad <= 4096, n % 64;
    K9: p_pad % 512, n % 256, V width) raise before the library is asked
    for anything."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k79, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    fn, args = _guard_case(which, **shape)
    before = _counts()
    with pytest.raises(err, match=match):
        fn(*args)
    assert _counts() == before


def _c_signatures():
    """{name: (return kind, [argument kinds])} of every ``glt_*`` entry point
    in csrc/*.cu, each kind one of "p" (pointer), "i" (int), "z" (size_t)."""
    import re
    kind = lambda t: ("p" if "*" in t else "z" if "size_t" in t  # noqa: E731
                      else "i")
    sigs = {}
    for src in _build.sources():
        text = src.read_text()
        for ret, name, args in re.findall(
                r'^(?:extern "C" )?(int|size_t) (glt_\w+)\(([^)]*)\)\s*\{',
                text, re.M):
            sigs[name] = (kind(ret), [kind(a) for a in args.split(",")])
    return sigs


def test_build_argtypes_match_the_c_signatures():
    """ctypes passes every argument as _build declares it: a pointer or a
    size_t declared as an int would be cut to 32 bits, so the declared
    argtypes must match the C entry points one for one."""
    import ctypes
    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_size_t: "z"}
    sigs = _c_signatures()
    assert set(sigs) == set(_build._SIGNATURES)
    for name, (args, res) in _build._SIGNATURES.items():
        assert sigs[name] == (kind[res], [kind[a] for a in args]), name
    # the wgmma sandwich (K3/K4): ten pointers, P, N, the strip's row
    # stride, kp and the split count, then the stream
    assert sigs["glt_strip_sandwich"] == ("i", ["p"] * 10 + ["i"] * 5 + ["p"])
    # K7: the persistent emitter, P, S and its feature depth (32 or 64);
    # its entry's check
    assert sigs["glt_kb_strip"] == ("i", ["p"] * 4 + ["i", "i", "i", "p"])
    assert sigs["glt_kb_entries"] == ("i", ["p", "p"])
    # the redesigned K8 / K9 entry points, each told the feature depth
    assert sigs["glt_ext2_clusters"] == ("i", ["i", "i"])
    assert sigs["glt_colstats_v_blocks"] == ("i", ["i", "i"])
    assert sigs["glt_affinity_scratch_bytes"] == ("z", ["i", "i"])
    assert "glt_recompute_clusters" not in sigs
    # K9/K10's V pass has one design, with no switch to another
    assert "glt_colstats_v_design" not in sigs


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc process a source (started together), then one link; the
    objects are removed and the library lands under its content hash."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\n"
        "done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    out = _build.build()
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == len(_build.sources()) == 6
    assert all("sm_90a" in c for c in compiles)
    assert len(calls) == len(compiles) + 1 and "-shared" in calls[-1]
    assert out == _build.lib_path() and out.exists()
    assert [f.name for f in (tmp_path / "build").iterdir()] == [out.name]


# --- on the card: kernel against plain version --------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m", [(277, 10240, 16), (4000, 16384, 50)])
def test_k7_k9_kernels_match_plain(cuda_device, p, n, m):
    rng = np.random.default_rng(p)
    fa = torch.tensor(rng.normal(0, 0.3, (p, 25)).astype(np.float32),
                      device=cuda_device)
    fp = torch.tensor(rng.normal(0, 0.3, (n, 25)).astype(np.float32),
                      device=cuda_device)
    fa_aug, f_t = rl.aug_pads(fa, fp, n)
    p_pad = fa_aug.shape[0]
    fa_pad = torch.zeros_like(fa_aug)
    fa_pad[:p, :25] = fa.to(torch.bfloat16)
    dev = cuda_device
    bm = torch.tensor((rng.random(n) > 0.2).astype(np.float32), device=dev)
    cols = torch.tensor(rng.uniform(0, 1.5, n).astype(np.float32), device=dev)
    before = _counts()
    got = k79.kb_strip_cuda(fa_aug, f_t, cols, True)
    ref = k79.kb_strip_plain(fa_aug, f_t, cols, True)
    assert float((got.float() - ref.float()).abs().max()) <= 1.5 * 2.0 ** -7
    t2 = torch.zeros((2, p_pad), device=dev)
    t2[:, :p] = torch.tensor(rng.uniform(0.5, 1.5, (2, p)).astype(np.float32),
                             device=dev)
    got = k79.ext2_matvec_cuda(fa_aug, f_t, t2, bm, True)
    ref = k79.ext2_matvec_plain(fa_aug, f_t, t2, bm, True)
    assert max(map(_rel_err, got, ref)) <= 2e-2
    t = t2[0].contiguous()
    gr = torch.zeros((p_pad, tms._m_kernel(m)), device=dev)
    gr[:p, :m] = torch.tensor(rng.normal(size=(p, m)).astype(np.float32),
                              device=dev)
    na = torch.zeros(p_pad, device=dev)
    na[:p] = torch.sum(fa * fa, dim=1)
    nb = torch.sum(fp * fp, dim=1)
    y = torch.tensor(rng.normal(size=n).astype(np.float32), device=dev)
    args = (fa_pad, f_t, t, bm * 0.7, bm, gr, y, na, nb)
    got = k79.finish_colstats_cuda(*args)
    ref = k79.finish_colstats_plain(*args)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= 5e-3
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]


@pytest.mark.gpu
def test_recompute_slice_on_card_matches_cpu_plain(img_noisy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    img, noisy = img_noisy
    cfg = _cfg(affinity_dtype="bfloat16")
    plan = gt.make_plan(noisy, cfg)
    x0 = lobpcg_x0(plan.p, cfg.num_eigvecs, "cpu")
    before = _counts()
    z_gpu, _ = _filter_channel(T(noisy).cuda(),
                               interop.idx_to_device(plan.idx_a, "cuda"), cfg,
                               x0=x0.cuda())
    assert all(a > b for a, b in zip(_counts(), before))
    z_cpu, _ = _filter_channel(T(noisy), interop.idx_to_device(plan.idx_a,
                                                               "cpu"),
                               cfg, x0=x0)
    z_gpu, z_cpu = z_gpu.cpu().numpy(), z_cpu.numpy()
    np.testing.assert_allclose(z_gpu, z_cpu, atol=2e-2)
    assert abs(gt.psnr(img, z_gpu) - gt.psnr(img, z_cpu)) <= 0.05


def _fused_inputs(dev, p, n, m, seed):
    """K8 / K9 operands at (p rows padded to p_pad, n columns, V width m)
    from a seeded generator, as the fused finish builds them."""
    rng = np.random.default_rng(seed)
    tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fa = tt(rng.normal(0, 0.3, (p, 25)))
    fp = tt(rng.normal(0, 0.3, (n, 25)))
    fa_aug, f_t = rl.aug_pads(fa, fp, n)
    p_pad = fa_aug.shape[0]
    fa_pad = torch.zeros_like(fa_aug)
    fa_pad[:p, :25] = fa.to(torch.bfloat16)
    bm = tt(rng.random(n) > 0.2)
    t2 = torch.zeros((2, p_pad), device=dev)
    t2[:, :p] = tt(rng.uniform(0.5, 1.5, (2, p)))
    gr = torch.zeros((p_pad, tms._m_kernel(m)), device=dev)
    gr[:p, :m] = tt(rng.normal(size=(p, m)))
    na = torch.zeros(p_pad, device=dev)
    na[:p] = torch.sum(fa * fa, dim=1)
    k8 = (fa_aug, f_t, t2, bm, True)
    k9 = (fa_pad, f_t, t2[0].contiguous(), bm * 0.7, bm, gr,
          tt(rng.normal(size=n)), na, torch.sum(fp * fp, dim=1))
    return k8, k9


@pytest.mark.gpu
@pytest.mark.parametrize("p,n,m", [(4000, 77056, 128), (1000, 33024, 16)],
                         ids=["p4096-m128", "p1024-m16"])
def test_k8_k9_repeat_bit_for_bit(cuda_device, p, n, m):
    """Two launches of the redesigned K8 and K9 agree bit for bit (no float
    atomics; every cross-block sum in a fixed order), at p_pad 4096
    (MAX_TILE_P) and 1024, with column-tile counts (K8: n / 64 = 1204 and
    516, K9: n / 256 = 301 and 129) that do not divide evenly over the
    persistent grids; m = 128 is two K9 launches, and s is computed once
    (the second V block equals K10's with c = s, bit for bit)."""
    k8, k9 = _fused_inputs(cuda_device, p, n, m, seed=p + n)
    before = _counts()
    got = [k79.ext2_matvec_cuda(*k8) for _ in range(2)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    ref = k79.ext2_matvec_plain(*k8)
    assert max(map(_rel_err, got[0], ref)) <= 2e-2
    got = [k79.finish_colstats_cuda(*k9) for _ in range(2)]
    for a, b in zip(*got):
        assert torch.equal(a, b)
    # the reference's 5e-3 bar, as in test_k7_k9_kernels_match_plain
    ref = k79.finish_colstats_plain(*k9)
    errs = [_rel_err(g, r) for g, r in zip(got[0], ref)]
    print(f"K9 vs plain (V, norms, coeffs, s) at p {p}, n {n}, m {m}: {errs}")
    assert max(errs) <= 5e-3
    launches = 2 * (-(-k9[5].shape[1] // k79.MP_MAX))
    assert [a - b for a, b in zip(_counts(), before)] == [0, 2, launches]
    if m > k79.MP_MAX:
        v, norms, coeffs, s = got[0]
        fa_pad, f_t, _, _, _, gr, y, na, nb = k9
        head = k79.finish_colstats_cuda(*k9[:5], gr[:, :k79.MP_MAX].contiguous(),
                                        *k9[6:])
        assert torch.equal(head[3], s) and torch.equal(head[0], v[:, :64])
        tail = k79.colstats_v_cuda(fa_pad, f_t, gr[:, 64:].contiguous(), y, s,
                                   na, nb)
        assert torch.equal(tail[0], v[:, 64:])
        assert torch.equal(tail[1], norms[64:])
        assert torch.equal(tail[2], coeffs[64:])


# --- K7, the persistent gram emitter ----------------------------------------

def _k7_case(dev, p, s, seed, cols_hi=1.5):
    """K7 operands: p sample rows padded to p_pad, s columns, features at
    the scale of the existing K7 tests, cols in [0, cols_hi)."""
    rng = np.random.default_rng(seed)
    tt = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    fa_aug, f_t = rl.aug_pads(tt(rng.normal(0, 0.3, (p, 25))),
                              tt(rng.normal(0, 0.3, (s, 25))), s)
    return fa_aug, f_t, tt(rng.uniform(0, cols_hi, s)), True


@pytest.mark.parametrize("p,s,err,match", [
    (512, 1000, ValueError, "multiple of 128"),
    (512, 0, ValueError, "multiple of 128"),
    (0, 1024, ValueError, "non-empty"),
    (256, 1024, ValueError, "multiple of 512"),
    (512, 1024, NotImplementedError, "ROADMAP"),
    (512, 1024, ValueError, "feature lanes"),
    (512, 1024, ValueError, "shape"),
    # K7 holds no whole-p tile: p_pad 8192 and an uneven column count pass
    # its guards and reach the (here missing) kernel library
    (8192, 128 * 133, RuntimeError, "unavailable"),
], ids=["s1000", "s0", "p0", "p256", "f32", "lanes25", "cols", "p8192"])
def test_k7_raises_before_a_launch(monkeypatch, p, s, err, match):
    """K7's wrapper takes p_pad on the 512 quantum, any positive multiple of
    128 columns, 32 bf16 aug lanes and one bf16-roundable column scale each
    column; anything else raises before the library is asked for anything."""
    def no_lib():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(k79, "_device_kind", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "lib", no_lib)
    bf = torch.bfloat16
    dtype, lanes, ncols = bf, 32, s
    if match == "ROADMAP":
        dtype = torch.float32
    elif match == "feature lanes":
        lanes = 25
    elif match == "shape":
        ncols = s + 1
    fa = torch.zeros((p, lanes), dtype=dtype)
    f_t = torch.zeros((lanes, s), dtype=dtype)
    before = _counts()
    with pytest.raises(err, match=match):
        k79.kb_strip_cuda(fa, f_t, torch.ones(ncols), True)
    assert _counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("p,s", [(500, 128 * 133), (8000, 128 * 133),
                                 (1000, 128), (4000, 131072)],
                         ids=["p512-s17024", "p8192-s17024", "p1024-s128",
                              "p4096-s131072"])
def test_k7_kernel_matches_plain_across_its_shapes(cuda_device, p, s):
    """The persistent K7 against its plain version where the 128 x 128
    units do not divide evenly over the resident blocks (p_pad 512 and 8192
    by 133 column tiles), where there are fewer units than blocks (8 units)
    and at config 4's gram shape (p_pad 4096, 131072 columns), under the
    existing K7 bar (two bf16 ulps at cols below 1.5, as
    test_k7_k9_kernels_match_plain); a second launch on the same inputs is
    the same bit for bit."""
    args = _k7_case(cuda_device, p, s, seed=p + s)
    before = _counts()
    got = k79.kb_strip_cuda(*args)
    again = k79.kb_strip_cuda(*args)
    assert [a - b for a, b in zip(_counts(), before)] == [2, 0, 0]
    assert got.shape == (args[0].shape[0], s) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    ref = k79.kb_strip_plain(*args)
    assert float((got.float() - ref.float()).abs().max()) <= 1.5 * 2.0 ** -7


@pytest.mark.gpu
def test_k7_at_config4_feature_scale(cuda_device):
    """K7 on the features and gram columns config 4's recipe builds (h 0.25,
    NLM 5x5, sample cap 4096, gram 1/64), here on a 512 x 512 frame: p_pad
    3072, 4096 gram columns, every entry pattern the path produces."""
    cfg = PipelineConfig(
        kernel="nlm", h=0.25, sample_rho=0.01, sample_cap=4096,
        num_eigvecs=50, sinkhorn_iters=6, filter_name="identity",
        streaming=True, block_cols=65536, affinity_dtype="bfloat16",
        use_pallas=True, sinkhorn_coarse=64, gram_coarse=64,
        sinkhorn_polish=1, fused_finish=True)
    img = gt.make_test_image(512, 512)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=1), 0,
                    1).astype(np.float32)
    plan = gt.make_plan(noisy, cfg)
    ctx = tms._strip_ctx(T(noisy).cuda(),
                         interop.idx_to_device(plan.idx_a, "cuda"), cfg)
    jidx = torch.as_tensor(tms.gram_sample_idx(ctx.n_pad, cfg.gram_coarse,
                                               cfg.gram_jitter_seed),
                           dtype=torch.int64, device=cuda_device)
    f_t = ctx.f_t[:, jidx].contiguous()
    cols = torch.rand(f_t.shape[1], device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(1))
    got = k79.kb_strip_cuda(ctx.fa_aug, f_t, cols, True)
    ref = k79.kb_strip_plain(ctx.fa_aug, f_t, cols, True)
    assert got.shape == (ctx.fa_aug.shape[0], f_t.shape[1])
    # chip_smoke.py's kb_strip bar (cols below 1)
    assert float((got.float() - ref.float()).abs().max()) <= 2.0 ** -7


@pytest.mark.gpu
def test_k7_entry_equals_kb_aug_at_every_pattern(cuda_device):
    """K7's entry (kexp on bf16(d2)) equals the evaluated aug entry
    (kb_aug, route 0 of the K5/K6 entry check) at all 65536 bf16(d2)
    patterns, NaN and negative ones included."""
    from graphlap_tpu_torch.ops import cuda_matvec as k56
    ref = k56.aug_entries(0, cuda_device)
    assert int((k79.kb_entries(cuda_device) != ref).sum()) == 0
