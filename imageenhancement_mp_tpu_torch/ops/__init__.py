"""Planes-level ops ``[B, H, W]``: the port's counterparts of
the JAX package's ``ops`` for the ported slices.

``OP_REGISTRY`` maps the JAX registry's names (ops/__init__.py:53-94) to the
ported ops.  Looking up a name the JAX registry has but the port does not
yet raises ``NotImplementedError`` naming its ROADMAP Queue 1 item; an
unknown name raises ``KeyError``.
"""

from __future__ import annotations

from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_planes
from imageenhancement_mp_tpu_torch.ops.clahe import clahe_planes
from imageenhancement_mp_tpu_torch.ops.filters import (box_blur_planes, box_filter_planes,
                                                      corner_harris_planes,
                                                      corner_min_eigen_val_planes,
                                                      gaussian_blur_planes,
                                                      laplacian_sharpen_planes, sobel_planes,
                                                      stack_blur_planes, unsharp_mask_planes)
from imageenhancement_mp_tpu_torch.ops.histogram import (equalize_hist_global_planes,
                                                         equalize_hist_planes)
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.ops.nlmeans import fast_nl_means_planes
from imageenhancement_mp_tpu_torch.ops.pointwise import (contrast_stretch_planes,
                                                         convert_scale_abs_planes, gamma_planes,
                                                         log_planes)
from imageenhancement_mp_tpu_torch.ops.threshold import adaptive_threshold_planes, threshold_planes
from imageenhancement_mp_tpu_torch.ops.warp import (remap_planes, undistort_planes,
                                                    warp_affine_planes, warp_perspective_planes,
                                                    warp_polar_planes)

__all__ = ["OP_REGISTRY", "LATER"]

# the JAX registry's names not ported yet -> their ROADMAP Queue 1 item
LATER = {
    "calc_back_project": 6,
    **dict.fromkeys((
        "erode", "dilate", "morphology", "filter2d", "pyr_down", "pyr_up", "resize", "flip",
        "rotate", "transpose", "canny", "connected_components", "match_template"), "10b"),
}


class _Registry(dict):
    def __missing__(self, name):
        if name in LATER:
            raise NotImplementedError(
                f"op {name!r} is not ported yet: ROADMAP Queue 1 item {LATER[name]}")
        raise KeyError(f"unknown op {name!r}; available: {sorted(self)}")


OP_REGISTRY = _Registry(
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
)
