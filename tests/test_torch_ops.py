"""graphlap_tpu_torch.ops (features, affinity, linalg, K_AA solve, sketch
helpers, filters) against graphlap_tpu.ops on the same numpy inputs.

Tolerances: f32 results differ only by summation order and libm (the two
packages run different GEMM and exp implementations) — 1e-5 absolute on
O(1) values. Strip entries come from the GEMM trick d2 = |a|^2 + |b|^2 -
2 a.b with norms up to ~40 at these bandwidths, so a few f32 ulps of the
norms (~1e-5) reach d2 and the entry: 5e-5 absolute. bf16-stored strips
may differ by one bf16 ulp (2^-8 below 1) where an f32 value sits on a
rounding boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlap_tpu as gl
from graphlap_tpu.ops import affinity as jaff
from graphlap_tpu.ops import filters as jfil
from graphlap_tpu.ops import linalg as jlin
from graphlap_tpu.ops import nystrom as jnys
from graphlap_tpu.ops import sinkhorn as jsk
from graphlap_tpu_torch.ops import affinity as taff
from graphlap_tpu_torch.ops import filters as tfil
from graphlap_tpu_torch.ops import linalg as tlin
from graphlap_tpu_torch.ops import nystrom as tnys
from graphlap_tpu_torch.ops import sinkhorn as tsk
from graphlap_tpu_torch.utils import interop

BF16_ULP = 2.0 ** -8
STRIP_F32_ATOL = 5e-5


def T(x):
    """A writable torch copy of a numpy (or jax) array."""
    return torch.tensor(np.asarray(x))


def _noisy(h=40, w=48):
    img = gl.make_test_image(h, w)
    return np.clip(gl.add_gaussian_noise(img, 0.1, seed=1), 0,
                   1).astype(np.float32)


def _cfgs(**kw):
    ref = gl.CONFIG2.replace(**kw)
    return ref, interop.config_from_dict(ref.to_dict())


@pytest.mark.parametrize("kw", [dict(), dict(kernel="gaussian", h=0.2),
                                dict(kernel="gaussian", spatial_h=8.0),
                                dict(patch_size=3)])
def test_feature_dim_and_features(kw):
    ref, port = _cfgs(**kw)
    assert taff.feature_dim(port) == jaff.feature_dim(ref)
    y = _noisy()
    fj = np.asarray(jaff.extract_features(jnp.asarray(y), ref))
    ft = taff.extract_features(T(y), port).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-6, rtol=0)


def test_features_padded_and_bandwidth_override():
    ref, port = _cfgs()
    y = _noisy()
    n_pad = y.size + 64
    fj = np.asarray(jaff.extract_features_padded(jnp.asarray(y), ref, n_pad,
                                                 h=0.2))
    ft = taff.extract_features_padded(T(y), port, n_pad,
                                      h=0.2).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-6, rtol=0)
    assert (ft[y.size:] == 0).all()


def test_bf16_feature_dtype():
    ref, port = _cfgs(feature_dtype="bfloat16")
    y = _noisy()
    ft = taff.extract_features(T(y), port)
    assert ft.dtype == torch.bfloat16
    fj = np.asarray(jaff.extract_features(jnp.asarray(y), ref).astype(
        jnp.float32))
    np.testing.assert_array_equal(ft.float().numpy(), fj)


@pytest.mark.parametrize("policy", ["float32", "bfloat16", "bfloat16_store"])
def test_affinity_strip_and_kaa(policy):
    ref, port = _cfgs(affinity_dtype=policy)
    y = _noisy()
    feats = np.asarray(jaff.extract_features(jnp.asarray(y), ref))
    fa = feats[::37]
    gemm_j = jnp.bfloat16 if policy == "bfloat16" else jnp.float32
    gemm_t = torch.bfloat16 if policy == "bfloat16" else torch.float32
    store_j = jnp.bfloat16 if policy != "float32" else None
    store_t = torch.bfloat16 if policy != "float32" else None
    kj = np.asarray(jaff.affinity_strip(jnp.asarray(fa), jnp.asarray(feats),
                                        gemm_j, store_j).astype(jnp.float32))
    kt = taff.affinity_strip(T(fa), T(feats),
                             gemm_t, store_t).float().numpy()
    atol = STRIP_F32_ATOL if store_t is None else BF16_ULP
    np.testing.assert_allclose(kt, kj, atol=atol, rtol=0)
    # K_AA: the exact (p, p) block is f32 in every policy
    kaa_j = np.asarray(jaff.affinity_strip(jnp.asarray(fa), jnp.asarray(fa),
                                           gemm_j))
    kaa_t = taff.affinity_strip(T(fa), T(fa),
                                gemm_t).numpy()
    np.testing.assert_allclose(kaa_t, kaa_j, atol=STRIP_F32_ATOL, rtol=0)


def _spd(p=48, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, 6)).astype(np.float32)
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    return np.exp(-d2 / 8.0).astype(np.float32)


def test_linalg_truncations():
    vals = np.array([1.0, 0.5, 4e-3, 2e-3, 1e-6, -1e-4], np.float32)
    for fn in ("trunc_inv_sqrt_vals", "trunc_inv_vals"):
        r = np.asarray(getattr(jlin, fn)(jnp.asarray(vals), 3e-3))
        t = getattr(tlin, fn)(T(vals), 3e-3).numpy()
        np.testing.assert_allclose(t, r, rtol=1e-6, atol=0)
    g = tlin._soft_gate(T(vals), torch.tensor(2e-3)).numpy()
    np.testing.assert_allclose(
        g, np.asarray(jlin._soft_gate(jnp.asarray(vals), 2e-3)), atol=1e-7)


def test_psd_pinv():
    k = _spd()
    r = np.asarray(jlin.psd_pinv(jnp.asarray(k), 3e-3))
    t = tlin.psd_pinv(T(k), 3e-3).numpy()
    # the projector onto the kept spectrum is well-conditioned; compare
    # its action on a smooth vector relative to the output scale
    v = np.linspace(0, 1, k.shape[0], dtype=np.float32)
    np.testing.assert_allclose(t @ v, r @ v, atol=1e-3 * np.abs(r @ v).max())


@pytest.mark.parametrize("solver", ["sketch", "chol", "oneshot"])
def test_kaa_solve(solver):
    k = _spd()
    u = np.random.default_rng(1).standard_normal(k.shape[0]).astype(np.float32)
    sj = jsk._make_kaa_solve(jnp.asarray(k), 3e-3, solver)
    st = tsk._make_kaa_solve(T(k), 3e-3, solver)
    r = np.asarray(sj(jnp.asarray(u)))
    t = st(T(u)).numpy()
    np.testing.assert_allclose(t, r, atol=1e-3 * np.abs(r).max(), rtol=0)
    # matrix right-hand sides too (the sketch solves (p, k) blocks)
    um = np.stack([u, 2 * u], 1)
    np.testing.assert_allclose(st(T(um)).numpy()[:, 1], 2 * t,
                               rtol=1e-5, atol=1e-5 * np.abs(t).max())


def test_ridge_eps_and_orthonormalize():
    k = _spd()
    assert np.isclose(float(tnys._ridge_eps(T(k), 3e-3)),
                      float(jnys._ridge_eps(jnp.asarray(k), 3e-3)), rtol=1e-6)
    # a sketch-like block: columns decaying over three decades
    y = (np.random.default_rng(2).standard_normal((64, 12))
         * np.logspace(0, -3, 12)[None, :]).astype(np.float32)
    qj = np.asarray(jnys._orthonormalize(jnp.asarray(y)))
    qt = tnys._orthonormalize(T(y)).numpy()
    # orthonormal, and the same subspace (bases may rotate inside it)
    np.testing.assert_allclose(qt.T @ qt, np.eye(12), atol=1e-4)
    np.testing.assert_allclose(qt @ qt.T, qj @ qj.T, atol=1e-3)
    assert tnys._LIVE_NORM2 == jnys._LIVE_NORM2


@pytest.mark.parametrize("name", sorted(jfil.FILTER_REGISTRY))
@pytest.mark.parametrize("param", [1.0, 2.0, 0.5])
def test_filter_registry(name, param):
    lam = np.linspace(-0.05, 1.0, 17).astype(np.float32)
    fj, ft = jfil.FILTER_REGISTRY[name], tfil.FILTER_REGISTRY[name]
    assert ft.affine == fj.affine
    r = np.asarray(fj.fn(jnp.asarray(lam), param))
    t = ft.fn(T(lam), param).numpy()
    np.testing.assert_allclose(t, r, rtol=1e-5, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(ft.fn(lam.astype(np.float64), param),
                               fj.fn(lam.astype(np.float64), param),
                               rtol=1e-12, equal_nan=True)
