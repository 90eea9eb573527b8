"""graphlap_tpu_torch's host-side modules against the JAX package's:
the copied config and sampling modules, I/O, metrics, the interop helpers,
and the port's import boundary (torch only — never jax nor graphlap_tpu)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import graphlap_tpu as gl
import graphlap_tpu.config as jcfg
import graphlap_tpu.utils.sampling as jsamp
import graphlap_tpu_torch as gt
import graphlap_tpu_torch.config as tcfg
import graphlap_tpu_torch.utils.sampling as tsamp
from graphlap_tpu_torch.utils import interop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PRESETS = {"CONFIG1": (jcfg.CONFIG1, tcfg.CONFIG1),
           "CONFIG2": (jcfg.CONFIG2, tcfg.CONFIG2),
           "CONFIG3": (jcfg.CONFIG3, tcfg.CONFIG3)}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_equal(name):
    ref, port = PRESETS[name]
    assert port.to_dict() == ref.to_dict()
    assert port.config_hash() == ref.config_hash()


@pytest.mark.parametrize("level", ["exact", "fast", "turbo"])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("n_pixels", [96 * 96, 512 * 512, 4096 * 4096])
def test_tuned_config_equal(name, streaming, level, n_pixels):
    ref, port = PRESETS[name]
    r = jcfg.tuned_config(ref.replace(streaming=streaming), n_pixels, level)
    t = tcfg.tuned_config(port.replace(streaming=streaming), n_pixels, level)
    assert t.to_dict() == r.to_dict() and t.config_hash() == r.config_hash()


@pytest.mark.parametrize("sigma", [0.05, 0.1, 0.2])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_denoise_tuned_equal(name, sigma):
    ref, port = PRESETS[name]
    assert (tcfg.denoise_tuned(port, sigma).to_dict()
            == jcfg.denoise_tuned(ref, sigma).to_dict())


def test_config_crosses_by_dict():
    ref = gl.CONFIG2.replace(streaming=True, strip_cache=True,
                             solver="sketch", use_pallas=True)
    port = interop.config_from_dict(ref.to_dict())
    assert isinstance(port, tcfg.PipelineConfig)
    assert port.config_hash() == ref.config_hash()


def test_config_validation_matches():
    with pytest.raises(ValueError):
        jcfg.PipelineConfig(strip_cache=True)
    with pytest.raises(ValueError):
        tcfg.PipelineConfig(strip_cache=True)


@pytest.mark.parametrize("hw,p", [((96, 96), 185), ((512, 512), 5243),
                                  ((37, 53), 20), ((8, 8), 64)])
def test_grid_sample_bit_identical(hw, p):
    r = jsamp.uniform_grid_sample(*hw, p)
    t = tsamp.uniform_grid_sample(*hw, p)
    assert t.idx_a.dtype == r.idx_a.dtype
    np.testing.assert_array_equal(t.idx_a, r.idx_a)
    np.testing.assert_array_equal(t.perm, r.perm)
    np.testing.assert_array_equal(t.inv_perm, r.inv_perm)


@pytest.mark.parametrize("seed", [0, 3])
def test_random_sample_bit_identical(seed):
    r = jsamp.random_sample(64, 80, 100, seed=seed)
    t = tsamp.random_sample(64, 80, 100, seed=seed)
    np.testing.assert_array_equal(t.idx_a, r.idx_a)


def test_make_plan_and_interop_plan():
    img = gl.make_test_image(96, 96)
    cfg = gl.CONFIG2
    r = gl.make_plan(img, cfg)
    t = gt.make_plan(img, interop.config_from_dict(cfg.to_dict()))
    np.testing.assert_array_equal(t.idx_a, r.idx_a)
    back = interop.plan_from_idx(r.idx_a, 96, 96)
    np.testing.assert_array_equal(back.perm, r.perm)
    idx = interop.idx_to_device(r.idx_a, "cpu")
    assert idx.dtype.is_floating_point is False and idx.shape == (r.p,)


def test_io_bit_identical(tmp_path):
    np.testing.assert_array_equal(gt.make_test_image(40, 56, seed=2),
                                  gl.make_test_image(40, 56, seed=2))
    np.testing.assert_array_equal(gt.make_test_image(24, 24, channels=3),
                                  gl.make_test_image(24, 24, channels=3))
    img = gl.make_test_image(32, 32)
    np.testing.assert_array_equal(gt.add_gaussian_noise(img, 0.1, seed=1),
                                  gl.add_gaussian_noise(img, 0.1, seed=1))
    path = str(tmp_path / "x.png")
    gt.save_image(path, img)
    np.testing.assert_array_equal(gt.load_image(path), gl.load_image(path))


def test_netpbm_waits_for_codec(tmp_path):
    with pytest.raises(NotImplementedError, match="codec"):
        gt.load_image(str(tmp_path / "x.pgm"))
    with pytest.raises(NotImplementedError, match="codec"):
        gt.save_image(str(tmp_path / "x.ppm"), np.zeros((4, 4)))


def test_metrics_match():
    img = gl.make_test_image(48, 48)
    noisy = np.clip(gl.add_gaussian_noise(img, 0.1, seed=1), 0, 1)
    assert gt.psnr(img, noisy) == gl.psnr(img, noisy)
    assert gt.estimate_noise_sigma(noisy) == gl.estimate_noise_sigma(noisy)
    # the reference routes SSIM through its C kernel when built, a
    # 1e-12-identical twin of the numpy body the port carries
    assert abs(gt.ssim(img, noisy) - gl.ssim(img, noisy)) < 1e-9
    rgb = gl.make_test_image(24, 24, channels=3)
    assert abs(gt.ssim(rgb, rgb * 0.9) - gl.ssim(rgb, rgb * 0.9)) < 1e-9


def test_precision_pins():
    import torch
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, imported in a fresh interpreter, pulls in
    no jax and no graphlap_tpu module."""
    mods = ["graphlap_tpu_torch"] + [
        "graphlap_tpu_torch." + os.path.splitext(os.path.relpath(
            os.path.join(d, f), os.path.join(ROOT, "graphlap_tpu_torch")))[0]
        .replace(os.sep, ".")
        for d, _, fs in os.walk(os.path.join(ROOT, "graphlap_tpu_torch"))
        for f in fs if f.endswith(".py") and f != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'graphlap_tpu' or "
            "m.startswith('graphlap_tpu.'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len(mods) >= 15
    assert {"graphlap_tpu_torch.cli", "graphlap_tpu_torch.utils.timing"} <= set(
        mods)


def test_port_sources_name_no_jax_import():
    """No source file of the port has an import statement for jax or the
    reference package."""
    bad = []
    for d, _, fs in os.walk(os.path.join(ROOT, "graphlap_tpu_torch")):
        for f in fs:
            if not f.endswith(".py"):
                continue
            for ln in open(os.path.join(d, f)):
                s = ln.strip()
                if s.startswith(("import ", "from ")) and (
                        " jax" in s or "graphlap_tpu " in s
                        or "graphlap_tpu." in s):
                    bad.append((f, s))
    assert not bad, bad
