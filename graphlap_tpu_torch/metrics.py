"""Image quality metrics: PSNR, SSIM and the noise-sigma estimate (port of
``graphlap_tpu/metrics.py``). Host-side numpy: metrics are reporting, not
the compute path. SSIM is the reference's numpy body; its C twin waits for
the native codec port (ROADMAP.md Queue 1, M0 codec)."""

from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, test: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    mse = float(np.mean((ref - test) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def ssim(ref: np.ndarray, test: np.ndarray, data_range: float = 1.0,
         sigma: float = 1.5) -> float:
    """Mean structural similarity (Wang et al. 2004), Gaussian 11x11 window.
    Grayscale (H, W) or per-channel averaged for (H, W, C)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    if ref.ndim == 3:
        return float(np.mean([ssim(ref[..., c], test[..., c], data_range, sigma)
                              for c in range(ref.shape[-1])]))

    radius = 5
    k = _gaussian_kernel1d(sigma, radius)

    def blur(img):
        out = np.apply_along_axis(lambda r: np.convolve(
            np.pad(r, radius, mode="reflect"), k, mode="valid"), 1, img)
        return np.apply_along_axis(lambda c: np.convolve(
            np.pad(c, radius, mode="reflect"), k, mode="valid"), 0, out)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = blur(ref), blur(test)
    xx, yy, xy = blur(ref * ref), blur(test * test), blur(ref * test)
    var_x = xx - mu_x**2
    var_y = yy - mu_y**2
    cov = xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
    return float(np.mean(num / den))


def estimate_noise_sigma(img: np.ndarray) -> float:
    """Robust noise-std estimate from the Haar diagonal-detail band (MAD of
    HH over 2x2 blocks divided by 0.6745); channels average."""
    img = np.asarray(img, dtype=np.float64)
    if img.ndim == 3:
        return float(np.mean([estimate_noise_sigma(img[..., c])
                              for c in range(img.shape[-1])]))
    h2, w2 = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    v = img[:h2, :w2]
    hh = 0.5 * (v[0::2, 0::2] - v[0::2, 1::2] - v[1::2, 0::2] + v[1::2, 1::2])
    return float(np.median(np.abs(hh)) / 0.6745)
