"""PyTorch/CUDA port of imageenhancement_mp_tpu.

The fused hist-eq → unsharp main path, config 5 (median → CLAHE → unsharp)
through presets, ``make_pipeline`` and ``stream_frames``, and the ops they
are made of, on torch tensors.  A CPU tensor runs plain PyTorch; a CUDA
tensor runs the hand-written Hopper kernels in ``kernels/csrc`` (built with
nvcc at first use), or raises.  This package imports neither JAX nor
imageenhancement_mp_tpu.
"""

from imageenhancement_mp_tpu_torch.api import (
    clahe,
    equalize_hist,
    equalize_unsharp,
    gaussian_blur,
    median_blur,
    unsharp_mask,
)
from imageenhancement_mp_tpu_torch.models.presets import get_preset
from imageenhancement_mp_tpu_torch.pipeline import make_pipeline, stream_frames

__all__ = ["clahe", "equalize_hist", "equalize_unsharp", "gaussian_blur", "get_preset",
           "make_pipeline", "median_blur", "stream_frames", "unsharp_mask"]
