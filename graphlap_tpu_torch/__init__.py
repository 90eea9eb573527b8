"""graphlap_tpu_torch — the graph-Laplacian global image filter in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``graphlap_tpu`` (the JAX reference, which stays in the repo
and is what the port's tests hold it against). This package covers the
streaming paths of config 2 (strip_cache), config 4 (recompute with the
fused finish), config 3 / the 8 MP matvec denoise (recompute with an
operator filter, per-channel RGB) and the unfused spectral schedule (the
8 MP turbo recipe, ``filter_image_staged``); ROADMAP.md lists what is
still to port.

Precision policy: the GEMM-trick distance |a|^2 + |b|^2 - 2 a.b cancels
catastrophically at reduced precision, so f32 GEMMs run at full f32
precision (TF32 off for matmuls and cuDNN), the counterpart of the
reference pinning "highest". Mixed precision appears only as deliberate
bf16 operand roundings with f32 accumulation.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import (PipelineConfig, CONFIG1, CONFIG2, CONFIG3,  # noqa: E402
                     denoise_tuned, tuned_config)
from .io import (add_gaussian_noise, load_image, make_test_image,  # noqa: E402
                 save_image)
from .metrics import estimate_noise_sigma, psnr, ssim  # noqa: E402
from .models.pipeline import (FilterResult, filter_image,  # noqa: E402
                              filter_image_staged, make_plan)
from .utils.sampling import (SamplePlan, random_sample,  # noqa: E402
                             uniform_grid_sample)

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig", "CONFIG1", "CONFIG2", "CONFIG3", "tuned_config",
    "denoise_tuned", "estimate_noise_sigma",
    "load_image", "save_image", "add_gaussian_noise", "make_test_image",
    "psnr", "ssim",
    "FilterResult", "filter_image", "filter_image_staged", "make_plan",
    "SamplePlan", "uniform_grid_sample", "random_sample",
]
