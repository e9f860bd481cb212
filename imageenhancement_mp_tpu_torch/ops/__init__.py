"""Planes-level ops ``[B, H, W]``: the port's counterparts of
the JAX package's ``ops``.

``OP_REGISTRY`` maps every name of the JAX registry (ops/__init__.py:53-94)
to its ported op; an unknown name raises ``KeyError``.
"""

from __future__ import annotations

from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_planes
from imageenhancement_mp_tpu_torch.ops.canny import canny_planes, connected_components_planes
from imageenhancement_mp_tpu_torch.ops.clahe import clahe_planes
from imageenhancement_mp_tpu_torch.ops.filter2d import filter2d_planes
from imageenhancement_mp_tpu_torch.ops.filters import (box_blur_planes, box_filter_planes,
                                                      corner_harris_planes,
                                                      corner_min_eigen_val_planes,
                                                      gaussian_blur_planes,
                                                      laplacian_sharpen_planes, sobel_planes,
                                                      stack_blur_planes, unsharp_mask_planes)
from imageenhancement_mp_tpu_torch.ops.histogram import (equalize_hist_global_planes,
                                                         equalize_hist_planes)
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.ops.morphology import (dilate_planes, erode_planes,
                                                          morphology_planes)
from imageenhancement_mp_tpu_torch.ops.nlmeans import fast_nl_means_planes
from imageenhancement_mp_tpu_torch.ops.pointwise import (calc_back_project_planes,
                                                         contrast_stretch_planes,
                                                         convert_scale_abs_planes, gamma_planes,
                                                         log_planes)
from imageenhancement_mp_tpu_torch.ops.pyramid import pyr_down_planes, pyr_up_planes
from imageenhancement_mp_tpu_torch.ops.resize import (flip_planes, resize_planes, rotate_planes,
                                                      transpose_planes)
from imageenhancement_mp_tpu_torch.ops.template import match_template_planes
from imageenhancement_mp_tpu_torch.ops.threshold import adaptive_threshold_planes, threshold_planes
from imageenhancement_mp_tpu_torch.ops.warp import (remap_planes, undistort_planes,
                                                    warp_affine_planes, warp_perspective_planes,
                                                    warp_polar_planes)

__all__ = ["OP_REGISTRY"]

OP_REGISTRY = dict(
    gamma=gamma_planes,
    log_transform=log_planes,
    contrast_stretch=contrast_stretch_planes,
    convert_scale_abs=convert_scale_abs_planes,
    equalize_hist=equalize_hist_planes,
    equalize_hist_global=equalize_hist_global_planes,
    gaussian_blur=gaussian_blur_planes,
    unsharp_mask=unsharp_mask_planes,
    laplacian_sharpen=laplacian_sharpen_planes,
    box_blur=box_blur_planes,
    box_filter=box_filter_planes,
    sobel=sobel_planes,
    corner_harris=corner_harris_planes,
    corner_min_eigen_val=corner_min_eigen_val_planes,
    stack_blur=stack_blur_planes,
    median_blur=median_blur_planes,
    clahe=clahe_planes,
    bilateral=bilateral_planes,
    threshold=threshold_planes,
    adaptive_threshold=adaptive_threshold_planes,
    warp_affine=warp_affine_planes,
    warp_perspective=warp_perspective_planes,
    warp_polar=warp_polar_planes,
    remap=remap_planes,
    undistort=undistort_planes,
    fast_nl_means=fast_nl_means_planes,
    calc_back_project=calc_back_project_planes,
    erode=erode_planes,
    dilate=dilate_planes,
    morphology=morphology_planes,
    filter2d=filter2d_planes,
    pyr_down=pyr_down_planes,
    pyr_up=pyr_up_planes,
    resize=resize_planes,
    flip=flip_planes,
    rotate=rotate_planes,
    transpose=transpose_planes,
    canny=canny_planes,
    connected_components=connected_components_planes,
    match_template=match_template_planes,
)
