"""PyTorch/CUDA port of the JAX image-enhancement package beside it.

The fused hist-eq → unsharp main path, config 5 (median → CLAHE → unsharp)
and config 2 (gamma → contrast stretch) through presets, ``make_pipeline``
and ``stream_frames``, the ops they are made of, the LUT family (``apply_lut``,
``histogram``, pooled ``equalize_hist``, gamma, log, ``convertScaleAbs``),
bilateral filtering, (adaptive) thresholding, the warp family (affine,
perspective, polar, remap, undistort), colour conversion (``cvt_color``,
``equalize_luma``, ``clahe_lab``) and non-local means denoising, on torch
tensors.  A CPU tensor runs plain PyTorch; a CUDA tensor runs the
hand-written Hopper kernels in ``kernels/csrc`` (built with nvcc at first
use), or raises.  This package imports neither JAX nor the JAX package.
"""

from imageenhancement_mp_tpu_torch.api import (
    adaptive_threshold,
    apply_lut,
    bilateral_filter,
    clahe,
    clahe_lab,
    contrast_stretch,
    convert_scale_abs,
    cvt_color,
    cvt_gray,
    equalize_hist,
    equalize_luma,
    equalize_unsharp,
    fast_nl_means_denoising,
    fast_nl_means_denoising_colored,
    fast_nl_means_denoising_colored_multi,
    fast_nl_means_denoising_multi,
    gamma,
    gaussian_blur,
    get_affine_transform,
    get_perspective_transform,
    get_rotation_matrix_2d,
    histogram,
    init_undistort_rectify_map,
    log_transform,
    median_blur,
    remap,
    threshold,
    undistort,
    unsharp_mask,
    warp_affine,
    warp_perspective,
    warp_polar,
)
from imageenhancement_mp_tpu_torch.models.presets import get_preset
from imageenhancement_mp_tpu_torch.pipeline import make_pipeline, stream_frames

__all__ = ["adaptive_threshold", "apply_lut", "bilateral_filter", "clahe", "clahe_lab",
           "contrast_stretch", "convert_scale_abs", "cvt_color", "cvt_gray", "equalize_hist",
           "equalize_luma", "equalize_unsharp", "fast_nl_means_denoising",
           "fast_nl_means_denoising_colored", "fast_nl_means_denoising_colored_multi",
           "fast_nl_means_denoising_multi", "gamma", "gaussian_blur", "get_affine_transform",
           "get_perspective_transform", "get_preset", "get_rotation_matrix_2d", "histogram",
           "init_undistort_rectify_map", "log_transform", "make_pipeline", "median_blur",
           "remap", "stream_frames", "threshold", "undistort", "unsharp_mask", "warp_affine",
           "warp_perspective", "warp_polar"]
