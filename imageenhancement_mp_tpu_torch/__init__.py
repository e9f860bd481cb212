"""PyTorch/CUDA port of the JAX image-enhancement package beside it.

The fused hist-eq → unsharp main path, config 5 (median → CLAHE → unsharp)
through presets, ``make_pipeline`` and ``stream_frames``, the ops they are
made of, and bilateral filtering and (adaptive) thresholding, on torch
tensors.  A CPU tensor runs plain PyTorch; a CUDA tensor runs the
hand-written Hopper kernels in ``kernels/csrc`` (built with nvcc at first
use), or raises.  This package imports neither JAX nor the JAX package.
"""

from imageenhancement_mp_tpu_torch.api import (
    adaptive_threshold,
    bilateral_filter,
    clahe,
    equalize_hist,
    equalize_unsharp,
    gaussian_blur,
    median_blur,
    threshold,
    unsharp_mask,
)
from imageenhancement_mp_tpu_torch.models.presets import get_preset
from imageenhancement_mp_tpu_torch.pipeline import make_pipeline, stream_frames

__all__ = ["adaptive_threshold", "bilateral_filter", "clahe", "equalize_hist", "equalize_unsharp",
           "gaussian_blur", "get_preset", "make_pipeline", "median_blur", "stream_frames",
           "threshold", "unsharp_mask"]
