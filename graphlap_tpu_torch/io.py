"""Image I/O and synthetic-noise injection (port of ``graphlap_tpu/io.py``).

Images are float numpy arrays in [0, 1]: grayscale (H, W) or RGB (H, W, 3).
Host-side numpy, so the port and the reference denoise the identical noisy
image from the same seed. The ``.pgm/.ppm`` branch of the reference goes
through its native C codec, which is not ported yet (ROADMAP.md Queue 1,
M0 codec): those suffixes raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import numpy as np

_NETPBM = (".pgm", ".ppm")


def _refuse_netpbm(path) -> None:
    if str(path).lower().endswith(_NETPBM):
        raise NotImplementedError(
            "graphlap_tpu_torch: .pgm/.ppm I/O waits for the native codec "
            "port (ROADMAP.md Queue 1, M0 codec); use a Pillow format")


def load_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Load an image file to float64 in [0, 1]; (H, W) gray or (H, W, 3) RGB."""
    _refuse_netpbm(path)
    from PIL import Image

    img = Image.open(path)
    if grayscale:
        img = img.convert("L")
    elif img.mode not in ("L", "RGB"):
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.float64) / 255.0


def save_image(path: str, img: np.ndarray) -> None:
    """Save a float [0, 1] array as an 8-bit image."""
    _refuse_netpbm(path)
    from PIL import Image

    arr = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def add_gaussian_noise(img: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
    """Add i.i.d. Gaussian noise of std ``sigma`` (image range [0, 1])."""
    rng = np.random.default_rng(seed)
    return img + rng.normal(0.0, sigma, size=img.shape)


def make_test_image(h: int = 128, w: int = 128, channels: int = 0,
                    seed: int = 0) -> np.ndarray:
    """Deterministic synthetic test image: smooth gradients + shapes + texture
    (bit-identical to the reference's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    yy /= max(h - 1, 1)
    xx /= max(w - 1, 1)

    img = 0.35 + 0.3 * xx + 0.15 * np.sin(6.0 * np.pi * yy)
    disk = (yy - 0.35) ** 2 + (xx - 0.3) ** 2 < 0.04
    img[disk] = 0.9
    sq = (np.abs(yy - 0.7) < 0.12) & (np.abs(xx - 0.65) < 0.15)
    img[sq] = 0.12
    img += 0.03 * rng.standard_normal((h, w))
    img = np.clip(img, 0.0, 1.0)

    if channels:
        chans = [np.clip(img * (0.8 + 0.2 * c / max(channels - 1, 1))
                         + 0.05 * rng.standard_normal((h, w)), 0, 1)
                 for c in range(channels)]
        img = np.stack(chans, axis=-1)
    return img
