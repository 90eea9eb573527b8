"""The dense (non-streaming) path of graphlap_tpu_torch against graphlap_tpu:
each ported piece on the same inputs (``psd_pinv_sqrt``,
``affinity_blocks``, ``normalize_blocks``, the three Nystrom solvers,
``apply_spectral_filter``, ``_dense_wapply``) and the whole slice through
``filter_image`` on the CPU, with the reference's LOBPCG start block and
sketch matrix injected where the solver draws them (torch cannot redraw
jax.random.normal(PRNGKey(0))). The reference's Pallas emitter runs in
interpret mode, its own CPU route.

Slice bars are the reference's fused-vs-unfused bars
(tests/test_strip_fused.py): <= 0.02 dB and max |diff| <= 2e-3 with f32
strips, <= 0.05 dB and <= 2e-2 with a bf16 strip or bf16 GEMM inputs.
Piece bars are those of tests/test_sinkhorn.py, tests/test_nystrom.py and
tests/test_sketch_solver.py or tighter; each is stated where it is used.
The ``gpu`` tests hold K1 at a ragged, permuted dense shape to its plain
version and the 96x96 dense slice on the card to the CPU run.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphlap_tpu_torch as gt
from graphlap_tpu_torch.models import pipeline as tpl
from graphlap_tpu_torch.ops import affinity as taff
from graphlap_tpu_torch.ops import cuda_affinity as k1
from graphlap_tpu_torch.ops import filters as tfl
from graphlap_tpu_torch.ops import linalg as tla
from graphlap_tpu_torch.ops import nystrom as tny
from graphlap_tpu_torch.ops import sinkhorn as tsk
from graphlap_tpu_torch.utils import interop

BF16_ULP = 2.0 ** -8
BARS = {"f32": (0.02, 2e-3), "bf16": (0.05, 2e-2)}


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
    from graphlap_tpu.models import pipeline as jpl
    from graphlap_tpu.ops import affinity as jaff
    from graphlap_tpu.ops import filters as jfl
    from graphlap_tpu.ops import linalg as jla
    from graphlap_tpu.ops import nystrom as jny
    from graphlap_tpu.ops import sinkhorn as jsk
    return SimpleNamespace(jax=jax, jnp=jnp, gl=gl, jpl=jpl, jaff=jaff,
                           jfl=jfl, jla=jla, jny=jny, jsk=jsk,
                           cfg=lambda c: JaxConfig(**c.to_dict()))


def T(x, dtype=None):
    """numpy (bf16 arrays included) -> a CPU tensor, optionally cast."""
    x = np.asarray(x)
    t = torch.tensor(x.astype(np.float32) if x.dtype.kind == "V"
                     or str(x.dtype) == "bfloat16" else x)
    return t if dtype is None else t.to(dtype)


def N(t):
    """A tensor or jax array -> an f64 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(np.asarray(t, np.float32), np.float64)


def noisy_image(size, seed=1, channels=None):
    img = gt.make_test_image(size, size, channels=channels)
    noisy = np.clip(gt.add_gaussian_noise(img, 0.1, seed=seed), 0, 1)
    return img, noisy.astype(np.float32)


def assert_bars(img, got, ref, bars):
    d_db = abs(gt.psnr(img, got) - gt.psnr(img, ref))
    d_max = float(np.abs(got - ref).max())
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert d_db <= bars[0] and d_max <= bars[1], (d_db, d_max)


def _x0(jx, p, k):
    """The reference's jax.random.normal(PRNGKey(0), (p, k)) block: LOBPCG's
    start block (k = m) or the sketch's test matrix (k = m + oversample)."""
    return np.asarray(jx.jax.random.normal(jx.jax.random.PRNGKey(0), (p, k),
                                           jx.jnp.float32))


# --- pieces -----------------------------------------------------------------

def test_psd_pinv_sqrt_matches_reference(jx):
    """A rank-deficient PSD matrix (rank 24 of 40, a tail under the soft
    cutoff): the truncated M^{-1/2} in f32 in both packages, against each
    other and against the reference's f64 twin."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal((40, 24)).astype(np.float32)
    mat = (b @ b.T / 24.0).astype(np.float32)
    got = N(tla.psd_pinv_sqrt(T(mat), 3e-3))
    ref = N(jx.jla.psd_pinv_sqrt(jx.jnp.asarray(mat), 3e-3))
    f64 = jx.jla.psd_pinv_sqrt_np(mat.astype(np.float64), 3e-3)
    scale = np.abs(f64).max()
    assert np.abs(got - ref).max() <= 1e-4 * scale
    assert np.abs(got - f64).max() <= 1e-4 * scale


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("which,dtype", [
    ("config1", "float32"), ("config1", "bfloat16_store"),
    ("config2", "float32"), ("config2", "bfloat16_store"),
    ("config2", "bfloat16")])
def test_affinity_blocks_match_reference(jx, which, dtype, pallas):
    """K_AA and K_AB at 96x96, at the K1 bars (entries in [0, 1]): 5e-5
    absolute for an f32 store (K_AA is stored f32 always), one bf16 ulp for
    a bf16 one. (Config 1's spatial coordinates rule out bf16 GEMM inputs:
    the config refuses them.)"""
    cfg = (gt.CONFIG1 if which == "config1" else gt.CONFIG2).replace(
        affinity_dtype=dtype, use_pallas=pallas)
    _, noisy = noisy_image(96)
    plan = gt.make_plan(noisy, cfg)
    kaa, kab = taff.affinity_blocks(T(noisy), T(plan.idx_a.astype(np.int64)),
                                    T(plan.perm.astype(np.int64)), cfg)
    jkaa, jkab = jx.jaff.affinity_blocks(
        jx.jnp.asarray(noisy), jx.jnp.asarray(plan.idx_a),
        jx.jnp.asarray(plan.perm), jx.cfg(cfg))
    assert kaa.dtype == torch.float32 and kaa.shape == jkaa.shape
    want = torch.bfloat16 if dtype == "bfloat16_store" else torch.float32
    assert kab.dtype == want and tuple(kab.shape) == tuple(jkab.shape)
    assert np.abs(N(kaa) - N(jkaa)).max() <= 5e-5
    bar = BF16_ULP if dtype == "bfloat16_store" else 5e-5
    assert np.abs(N(kab) - N(jkab)).max() <= bar


@pytest.fixture(scope="module")
def blocks(jx):
    """The reference's (K_AA, K_AB) of config 2 at 96x96 (p = 185, so every
    solver's eigh branch) and at 128x128 (p = 328 > 5 m: LOBPCG iterates),
    with f32 and bf16 stores, as numpy."""
    out = {}
    for size in (96, 128):
        _, noisy = noisy_image(size)
        for dtype in ("float32", "bfloat16_store"):
            cfg = gt.CONFIG2.replace(affinity_dtype=dtype)
            plan = gt.make_plan(noisy, cfg)
            kaa, kab = jx.jaff.affinity_blocks(
                jx.jnp.asarray(noisy), jx.jnp.asarray(plan.idx_a),
                jx.jnp.asarray(plan.perm), jx.cfg(cfg))
            out[size, dtype] = (np.asarray(kaa), np.asarray(kab), noisy,
                                plan)
    return out


def bf16_ulp(x):
    """One bf16 ulp of each entry of x (2^-7 of its binade)."""
    x = np.abs(x)
    return np.where(x > 0, 2.0 ** (np.floor(np.log2(np.where(x > 0, x, 1.0)))
                                   - 7), 0.0)


def _torch_blocks(kaa, kab):
    return T(kaa), T(kab, torch.bfloat16 if str(kab.dtype) == "bfloat16"
                     else torch.float32)


NORMALIZATIONS = {"sinkhorn": ("sinkhorn", 20, 1, 0),
                  "coarse": ("sinkhorn", 6, 4, 1),
                  "symmetric": ("symmetric", 20, 1, 0),
                  "none": ("none", 20, 1, 0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_store"])
@pytest.mark.parametrize("solver", ["oneshot", "lobpcg"])
@pytest.mark.parametrize("branch", sorted(NORMALIZATIONS))
def test_normalize_blocks_match_reference(jx, blocks, branch, solver, dtype):
    """Every branch of normalize_blocks on the reference's blocks, with the
    pinv (one-shot) and ridge-Cholesky K_AA solves: s to rtol 2e-4 and
    W_AA to atol 1e-5 (tests/test_sinkhorn.py's bars against f64); W_AB to
    atol 1e-5 at f32, and within one bf16 ulp of each entry when stored
    bf16 (a scale a few f32 ulps off can move the rounding)."""
    kaa, kab, _, _ = blocks[96, dtype]
    norm, iters, coarse, polish = NORMALIZATIONS[branch]
    got = tsk.normalize_blocks(*_torch_blocks(kaa, kab), norm, iters, 3e-3,
                               solver, coarse, polish)
    ref = jx.jsk.normalize_blocks(jx.jnp.asarray(kaa), jx.jnp.asarray(kab),
                                  norm, iters, 3e-3, solver, coarse, polish)
    waa, wab, s_a, s_b = (N(x) for x in got)
    jwaa, jwab, js_a, js_b = (N(x) for x in ref)
    assert got[1].dtype == (torch.bfloat16 if dtype == "bfloat16_store"
                            else torch.float32)
    np.testing.assert_allclose(s_a, js_a, rtol=2e-4)
    np.testing.assert_allclose(s_b, js_b, rtol=2e-4)
    np.testing.assert_allclose(waa, jwaa, rtol=0, atol=1e-5)
    if dtype == "float32":
        np.testing.assert_allclose(wab, jwab, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(wab - jwab) <= bf16_ulp(jwab))


@pytest.fixture(scope="module")
def scaled(jx, blocks):
    """The reference's Sinkhorn-scaled (W_AA, W_AB) of each block set, and
    the pixels in [A; B] order."""
    out = {}
    for key, (kaa, kab, noisy, plan) in blocks.items():
        waa, wab, _, _ = jx.jsk.normalize_blocks(
            jx.jnp.asarray(kaa), jx.jnp.asarray(kab), "sinkhorn", 20, 3e-3,
            "lobpcg")
        out[key] = (np.asarray(waa), np.asarray(wab),
                    noisy.ravel()[plan.perm].astype(np.float32))
    return out


def _filtered(basis, y, projection):
    """V V^T y (``projection``), else V diag(vals) V^T y, the identity
    filter's output."""
    v = N(basis.vecs)
    c = v.T @ y
    return v @ (c if projection else N(basis.vals) * c)


SOLVERS = ["oneshot", "chol", "lobpcg", "sketch"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_store"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_nystrom_solvers_match_reference(jx, scaled, solver, dtype):
    """nystrom_eigh (one-shot), nystrom_eigh_chol (eigh, and LOBPCG at p =
    328 > 5 m from the reference's start block) and nystrom_eigh_sketch
    (the reference's Omega) on the same scaled blocks, compared by
    eigenvalues and by the projection V V^T y: the vectors' signs and their
    order inside degenerate clusters are free. tests/test_nystrom.py holds
    the eigenvalues to atol 2e-3 and the projection to 5e-3 of max |z|
    (+ 5e-3) against f64; f32 strips are held ten times tighter. A bf16
    strip is held at those bars, and by V diag(vals) V^T y: the sketch
    rounds its thin f32 sums to bf16, so its eigenvalues move by ~1e-3
    with the sum order, while the top 50 end in clusters ~5e-4 apart,
    and which slice of them lands in the top 50 is ill-posed
    (the reference's own f32-typed and bf16 routes on the same strip
    values move V V^T y by 0.07); the identity filter weights that tail by
    its eigenvalues (~0.02)."""
    size = 128 if solver == "lobpcg" else 96
    waa, wab, y = scaled[size, dtype]
    p, m = waa.shape[0], 50
    twaa, twab = _torch_blocks(waa, wab)
    jwaa, jwab = jx.jnp.asarray(waa), jx.jnp.asarray(wab)
    if solver == "oneshot":
        got = tny.nystrom_eigh(twaa, twab, m, 3e-3)
        ref = jx.jny.nystrom_eigh(jwaa, jwab, m, 3e-3)
    elif solver == "sketch":
        k = min(m + 78, p)
        got = tny.nystrom_eigh_sketch(twaa, twab, m, 3e-3, 78, 2,
                                      T(_x0(jx, p, k)))
        ref = jx.jny.nystrom_eigh_sketch(jwaa, jwab, m, 3e-3, 78, 2)
    else:
        method = "lobpcg" if solver == "lobpcg" else "eigh"
        bf = dtype == "bfloat16_store"
        assert (5 * m < p) == (solver == "lobpcg")
        got = tny.nystrom_eigh_chol(
            twaa, twab, m, 3e-3, method,
            torch.bfloat16 if bf else torch.float32, 60,
            T(_x0(jx, p, m)) if solver == "lobpcg" else None)
        ref = jx.jny.nystrom_eigh_chol(
            jwaa, jwab, m, 3e-3, method,
            jx.jnp.bfloat16 if bf else jx.jnp.float32, 60)
    assert got.vecs.shape == ref.vecs.shape
    f32 = dtype == "float32"
    tight = 0.1 if f32 else 1.0
    np.testing.assert_allclose(N(got.vals), N(ref.vals), rtol=0,
                               atol=2e-3 * tight)
    z, jz = _filtered(got, y, f32), _filtered(ref, y, f32)
    assert np.abs(z - jz).max() <= 5e-3 * tight * (np.abs(jz).max() + 1.0)


@pytest.mark.parametrize("name", sorted(tfl.FILTER_REGISTRY))
def test_apply_spectral_filter_matches_reference(jx, name):
    """Every registry filter on an orthonormal basis, f32 to 1e-5 of max
    |y| (the same arithmetic)."""
    rng = np.random.default_rng(1)
    vecs = np.linalg.qr(rng.standard_normal((300, 12)))[0].astype(np.float32)
    vals = np.sort(rng.uniform(-0.05, 1.0, 12))[::-1].astype(np.float32)
    y = rng.uniform(0, 1, 300).astype(np.float32)
    param = 2.0 if name in ("power", "twicing") else 0.6
    got = tfl.apply_spectral_filter(T(y), T(vals), T(vecs), name, param)
    ref = jx.jfl.apply_spectral_filter(jx.jnp.asarray(y), jx.jnp.asarray(vals),
                                       jx.jnp.asarray(vecs), name, param)
    assert np.abs(N(got) - N(ref)).max() <= 1e-5 * np.abs(y).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16_store"])
@pytest.mark.parametrize("mode,name,param", [("matvec", "sharpen", 0.3),
                                             ("chebyshev", "exp_decay", 3.0)])
def test_dense_wapply_operator_filters_match_reference(jx, blocks, mode, name,
                                                       param, dtype):
    """f(W) y through _dense_wapply (the unscaled K_AA's ridge solve) on the
    reference's blocks and scales: 1e-4 of max |y| — the same products in
    another f32 order (six applications for the series)."""
    kaa, kab, noisy, plan = blocks[96, dtype]
    cfg = gt.CONFIG2.replace(filter_name=name, filter_param=param,
                          filter_mode=mode, cheb_degree=6,
                          affinity_dtype=dtype)
    jkaa, jkab = jx.jnp.asarray(kaa), jx.jnp.asarray(kab)
    _, _, s_a, s_b = jx.jsk.normalize_blocks(jkaa, jkab, "sinkhorn", 20,
                                             3e-3, "lobpcg")
    y = noisy.ravel()[plan.perm].astype(np.float32)
    ref = jx.jfl.apply_operator_filter(
        jx.jpl._dense_wapply(jkaa, jkab, s_a, s_b, jx.cfg(cfg)),
        jx.jnp.asarray(y), name, param, mode, 6)
    tkaa, tkab = _torch_blocks(kaa, kab)
    got = tfl.apply_operator_filter(
        tpl._dense_wapply(tkaa, tkab, T(s_a), T(s_b), cfg), T(y), name, param,
        mode, 6)
    assert np.abs(N(got) - N(ref)).max() <= 1e-4 * np.abs(y).max()


# --- the slice ---------------------------------------------------------------

SLICE = {
    # name: (config, image side, channels, bar class)
    "config1_128": (lambda: gt.CONFIG1, 128, None, "f32"),
    "config2_f32_pallas_96": (lambda: gt.CONFIG2.replace(use_pallas=True),
                              96, None, "f32"),
    "config2_f32_xla_96": (lambda: gt.CONFIG2, 96, None, "f32"),
    "config2_lobpcg_128": (lambda: gt.CONFIG2.replace(use_pallas=True), 128,
                           None, "f32"),
    "config2_bf16_store_96": (lambda: gt.CONFIG2.replace(
        use_pallas=True, affinity_dtype="bfloat16_store"), 96, None, "bf16"),
    "config2_bf16_gemm_96": (lambda: gt.CONFIG2.replace(
        use_pallas=True, affinity_dtype="bfloat16"), 96, None, "bf16"),
    "config2_rgb_48": (lambda: gt.CONFIG2.replace(use_pallas=True), 48, 3,
                       "f32"),
    "config2_matvec_sharpen_96": (lambda: gt.CONFIG2.replace(
        use_pallas=True, filter_name="sharpen", filter_param=0.3,
        filter_mode="matvec"), 96, None, "f32"),
}


def _port_filter(jx, noisy, cfg, plan):
    """The port's filter_image on the CPU, or, where LOBPCG iterates (p > 5
    m), its channel function with the reference's start block."""
    if noisy.ndim == 2 and cfg.solver == "lobpcg" \
            and 5 * cfg.num_eigvecs < plan.p:
        x0 = interop.block_to_device(_x0(jx, plan.p, cfg.num_eigvecs), "cpu")
        z, vals = tpl._filter_channel(
            T(noisy), T(plan.idx_a.astype(np.int64)), cfg, x0=x0,
            perm=T(plan.perm.astype(np.int64)),
            inv_perm=T(plan.inv_perm.astype(np.int64)))
        return z.numpy(), vals.numpy()
    res = gt.filter_image(noisy, cfg, plan=plan, device="cpu")
    return res.image, res.eigvals


@pytest.mark.parametrize("case", sorted(SLICE))
def test_dense_slice_matches_reference(jx, case):
    """filter_image on the dense path against graphlap_tpu.filter_image at
    the bars of its strip's class; config 1 also within the 0.1 dB gate of
    the float64 oracle (tests/test_pipeline.py's gate)."""
    make, size, channels, cls = SLICE[case]
    cfg = make()
    img, noisy = noisy_image(size, channels=channels)
    plan = gt.make_plan(noisy, cfg)
    z, vals = _port_filter(jx, noisy, cfg, plan)
    ref = jx.gl.filter_image(noisy, jx.cfg(cfg), plan=plan)
    assert z.dtype == np.float32
    assert_bars(img, z, np.asarray(ref.image), BARS[cls])
    assert vals.shape == np.asarray(ref.eigvals).shape
    if not cfg.operator_filter():
        np.testing.assert_allclose(vals, ref.eigvals, rtol=0, atol=1e-4)
    assert gt.psnr(img, z) > gt.psnr(img, noisy) + (
        -3.0 if cfg.filter_name == "sharpen" else 0.5)
    if case == "config1_128":
        from .oracle import oracle_filter_image
        orc, _ = oracle_filter_image(noisy, jx.cfg(cfg))
        assert abs(gt.psnr(img, z) - gt.psnr(img, orc)) <= 0.1


@pytest.mark.parametrize("filter_mode", ["spectral", "matvec"])
def test_dense_staged_matches_filter_image(filter_mode):
    """The staged dense path runs filter_image's schedule with four stage
    walls: the image within 1e-5 (tests/test_pipeline.py's staged bar); an
    operator filter has no eigensolve stage."""
    cfg = gt.CONFIG2.replace(use_pallas=True, filter_mode=filter_mode,
                             filter_name="sharpen" if filter_mode == "matvec"
                             else "identity", filter_param=0.3)
    _, noisy = noisy_image(96, channels=3)
    plan = gt.make_plan(noisy, cfg)
    staged = gt.filter_image_staged(noisy, cfg, plan=plan, device="cpu")
    fused = gt.filter_image(noisy, cfg, plan=plan, device="cpu")
    assert set(staged.timings) == {"affinity", "normalize", "eigensolve",
                                   "filter"}
    assert all(v >= 0.0 for v in staged.timings.values())
    assert (staged.timings["eigensolve"] == 0.0) == (filter_mode == "matvec")
    np.testing.assert_allclose(staged.image, fused.image, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(staged.eigvals, fused.eigvals)


def test_dense_staged_matches_reference_stages(jx):
    """The staged dense path against the reference's staged run at f32
    bars, with the same four timing keys."""
    cfg = gt.CONFIG2.replace(use_pallas=True)
    img, noisy = noisy_image(96)
    plan = gt.make_plan(noisy, cfg)
    res = gt.filter_image_staged(noisy, cfg, plan=plan, device="cpu")
    ref = jx.gl.filter_image_staged(noisy, jx.cfg(cfg), plan=plan)
    assert set(res.timings) == set(ref.timings)
    assert_bars(img, res.image, np.asarray(ref.image), BARS["f32"])


# --- guards ------------------------------------------------------------------

def test_check_dense_feasible_matches_reference(jx):
    """Past 8e9 strip bytes both packages raise the same message; at the
    bench's f32 twin (5.5 GB) and for streaming configs neither does."""
    big = SimpleNamespace(p=8192, n=262144)
    cfg = gt.CONFIG2
    with pytest.raises(ValueError) as got:
        tpl.check_dense_feasible(cfg, big)
    with pytest.raises(ValueError) as ref:
        jx.jpl.check_dense_feasible(jx.cfg(cfg), big)
    assert str(got.value) == str(ref.value)
    assert tpl.DENSE_STRIP_BYTES_LIMIT == jx.jpl.DENSE_STRIP_BYTES_LIMIT
    tpl.check_dense_feasible(cfg, SimpleNamespace(p=5243, n=262144))
    tpl.check_dense_feasible(cfg.replace(affinity_dtype="bfloat16_store"),
                             big)
    tpl.check_dense_feasible(cfg.replace(streaming=True), big)


def test_dense_guard_raises_before_any_work(monkeypatch):
    """filter_image and filter_image_staged raise the guard before the
    affinity stage runs."""
    def boom(*a, **k):
        raise AssertionError("affinity ran")
    monkeypatch.setattr(tpl, "affinity_blocks", boom)
    monkeypatch.setattr(tpl, "DENSE_STRIP_BYTES_LIMIT", 1e3)
    noisy = np.zeros((32, 32), np.float32)
    for fn in (gt.filter_image, gt.filter_image_staged):
        with pytest.raises(ValueError, match="single-chip bound"):
            fn(noisy, gt.CONFIG2, device="cpu")


def test_dense_luma_basis_and_mesh_still_raise():
    cfg = gt.CONFIG2
    with pytest.raises(NotImplementedError, match="M7"):
        gt.filter_image(np.zeros((16, 16, 3), np.float32),
                        cfg.replace(rgb_mode="luma_basis"), device="cpu")
    with pytest.raises(NotImplementedError, match="M7"):
        gt.filter_image_staged(np.zeros((16, 16, 3), np.float32),
                               cfg.replace(rgb_mode="luma_basis"),
                               device="cpu")
    with pytest.raises(NotImplementedError, match="M9"):
        gt.filter_image(np.zeros((16, 16), np.float32), cfg, mesh=object(),
                        device="cpu")


def test_dense_channel_needs_the_plan_perms():
    """The dense channel runs in the plan's [A; B] order and refuses to
    guess it."""
    with pytest.raises(ValueError, match="perm"):
        tpl._filter_channel(torch.zeros((16, 16)),
                            torch.arange(8, dtype=torch.int64), gt.CONFIG2)


def test_promoting_strip_products_keep_the_thin_operand_f32(monkeypatch):
    """strip_mm / strip_t_mm on a bf16 strip equal the f32 products of the
    upcast strip with the unrounded f32 operand, chunk by chunk (jnp's
    promotion), where rounding the operand to bf16 would not."""
    monkeypatch.setattr(tla, "PROMOTE_CHUNK", 7)
    rng = np.random.default_rng(2)
    strip = T(rng.random((9, 30), np.float32)).to(torch.bfloat16)
    x = T(rng.random(30, np.float32) + 1e-3)
    t = T(rng.random((9, 2), np.float32) + 1e-3)
    up = strip.to(torch.float64)
    np.testing.assert_allclose(N(tla.strip_mm(strip, x)),
                               N(up @ x.double()), rtol=1e-6)
    np.testing.assert_allclose(N(tla.strip_t_mm(strip, t)),
                               N(up.T @ t.double()), rtol=1e-6)
    rounded = N(up @ x.to(torch.bfloat16).double())
    assert np.abs(N(tla.strip_mm(strip, x)) - rounded).max() > 1e-5


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("store", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k1_dense_shape_ragged_permuted(cuda_device, store):
    """K1 as the dense path calls it: config 2's features at 96x96 in
    permuted [A; B] order, K_AB's N - p = 9031 columns (ragged at both
    stores): the view over padded rows within 5e-5 (f32) / one bf16 ulp of
    the plain version, and two launches bit for bit."""
    cfg = gt.CONFIG2.replace(use_pallas=True)
    _, noisy = noisy_image(96)
    plan = gt.make_plan(noisy, cfg)
    f = taff.extract_features(torch.tensor(noisy, device=cuda_device), cfg)
    fp = f[torch.tensor(plan.perm.astype(np.int64), device=cuda_device)]
    fa, fb = fp[:plan.p], fp[plan.p:]
    assert fb.shape[0] % 8 != 0
    before = k1.affinity_strip_cuda.launches
    got = k1.affinity_strip_cuda(fa, fb, torch.float32, store)
    again = k1.affinity_strip_cuda(fa, fb, torch.float32, store)
    assert k1.affinity_strip_cuda.launches == before + 2
    ref = k1.affinity_strip_plain(fa, fb, torch.float32, store)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert not got.is_contiguous()              # the padded rows, no copy
    assert torch.equal(got, again)
    bar = 5e-5 if store is None else BF16_ULP
    assert float((got.float() - ref.float()).abs().max()) <= bar


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16_store"])
def test_dense_slice_on_the_card_matches_the_cpu(cuda_device, dtype):
    """The 96x96 dense slice through K1 on the card against the plain
    versions on the CPU, at the bars of its strip's class."""
    cfg = gt.CONFIG2.replace(use_pallas=True, affinity_dtype=dtype)
    img, noisy = noisy_image(96)
    plan = gt.make_plan(noisy, cfg)
    before = k1.affinity_strip_cuda.launches
    card = gt.filter_image(noisy, cfg, plan=plan, device=cuda_device)
    assert k1.affinity_strip_cuda.launches == before + 1
    cpu = gt.filter_image(noisy, cfg, plan=plan, device="cpu")
    assert_bars(img, card.image, cpu.image,
                BARS["f32" if dtype == "float32" else "bf16"])
