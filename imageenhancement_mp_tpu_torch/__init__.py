"""PyTorch/CUDA port of the JAX image-enhancement package beside it.

The fused hist-eq → unsharp main path, config 5 (median → CLAHE → unsharp),
config 2 (gamma → contrast stretch) and config 3 (Gaussian → Laplacian
sharpen → unsharp) through presets, ``make_pipeline`` and ``stream_frames``,
the ops they are made of, the spatial filters (Gaussian and unsharp in every
dtype, Laplacian, Sobel/Scharr, box filters, corner responses,
``spatial_gradient``, ``sqr_box_filter``, ``stack_blur``), the LUT family (``apply_lut``,
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
    box_blur,
    box_filter,
    clahe,
    clahe_lab,
    contrast_stretch,
    convert_scale_abs,
    corner_harris,
    corner_min_eigen_val,
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
    laplacian,
    laplacian_sharpen,
    log_transform,
    median_blur,
    remap,
    scharr,
    sobel,
    spatial_gradient,
    sqr_box_filter,
    stack_blur,
    threshold,
    undistort,
    unsharp_mask,
    warp_affine,
    warp_perspective,
    warp_polar,
)
from imageenhancement_mp_tpu_torch.models.presets import get_preset
from imageenhancement_mp_tpu_torch.pipeline import make_pipeline, stream_frames

__all__ = ["adaptive_threshold", "apply_lut", "bilateral_filter", "box_blur", "box_filter",
           "clahe", "clahe_lab", "contrast_stretch", "convert_scale_abs", "corner_harris",
           "corner_min_eigen_val", "cvt_color", "cvt_gray", "equalize_hist", "equalize_luma",
           "equalize_unsharp", "fast_nl_means_denoising", "fast_nl_means_denoising_colored",
           "fast_nl_means_denoising_colored_multi", "fast_nl_means_denoising_multi", "gamma",
           "gaussian_blur", "get_affine_transform", "get_perspective_transform", "get_preset",
           "get_rotation_matrix_2d", "histogram", "init_undistort_rectify_map", "laplacian",
           "laplacian_sharpen", "log_transform", "make_pipeline", "median_blur", "remap",
           "scharr", "sobel", "spatial_gradient", "sqr_box_filter", "stack_blur",
           "stream_frames", "threshold", "undistort", "unsharp_mask", "warp_affine",
           "warp_perspective", "warp_polar"]
