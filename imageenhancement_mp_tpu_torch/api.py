"""Public functions on torch tensors, with the shapes and keyword names of
the JAX package's ``api.py``.

Each accepts ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or ``[N,H,W,C]`` images
(u8, and u16/i16/f32 where a function says so) and works per plane (per
image × channel), except colour ``bilateral_filter`` and the
``fast_nl_means_*`` functions, whose weights join the channels, and the
colour conversions, which take ``[..,H,W,C]`` pixels.  The output lies on
the input's device:
a CPU tensor runs the plain PyTorch versions, a CUDA tensor the kernels.
``channels_last=False`` reads a 3-D input as ``[N, H, W]`` even when W ≤ 4.
The host helpers (the contour and shape functions, ``moments``,
``hough_lines_p``, ``gabor_kernel``) take tensors or arrays and return
NumPy, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.hist import hist256
from imageenhancement_mp_tpu_torch.ops import arith, pointwise, stats
from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_color, bilateral_planes
from imageenhancement_mp_tpu_torch.ops.canny import canny_planes, connected_components_planes
from imageenhancement_mp_tpu_torch.ops.clahe import clahe_planes
from imageenhancement_mp_tpu_torch.ops.distance import distance_transform_planes
from imageenhancement_mp_tpu_torch.ops import filters
from imageenhancement_mp_tpu_torch.ops.filter2d import filter2d_planes
from imageenhancement_mp_tpu_torch.ops.histogram import (equalize_hist_global_planes,
                                                         equalize_hist_planes, histogram_256)
from imageenhancement_mp_tpu_torch.ops import color
from imageenhancement_mp_tpu_torch.ops.floodfill import flood_region
from imageenhancement_mp_tpu_torch.ops.hough import hough_accumulator
from imageenhancement_mp_tpu_torch.ops.lk import calc_optical_flow_pyr_lk_planes
from imageenhancement_mp_tpu_torch.ops.meanshift import pyr_mean_shift_planes
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.ops import morphology
from imageenhancement_mp_tpu_torch.ops.nlmeans import (fast_nl_means_multi_vec,
                                                       fast_nl_means_u16_vec, fast_nl_means_vec)
from imageenhancement_mp_tpu_torch.ops import photo
from imageenhancement_mp_tpu_torch.ops.pyramid import pyr_down_planes, pyr_up_planes
from imageenhancement_mp_tpu_torch.ops import resize as rs
from imageenhancement_mp_tpu_torch.ops.seamless import seamless_clone_patch
from imageenhancement_mp_tpu_torch.ops.subpix import get_rect_sub_pix_planes
from imageenhancement_mp_tpu_torch.ops.template import match_template_planes
from imageenhancement_mp_tpu_torch.ops.threshold import adaptive_threshold_planes, threshold_planes
from imageenhancement_mp_tpu_torch.ops.warp import (remap_planes, undistort_planes,
                                                    warp_affine_planes, warp_perspective_planes,
                                                    warp_polar_planes)
from imageenhancement_mp_tpu_torch.pipeline import equalize_unsharp
from imageenhancement_mp_tpu_torch.utils import (contours_host, hough_host, photo_host, taps,
                                                 tracking, warp_coords)
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes, as_vec, treat_as_hwc
from imageenhancement_mp_tpu_torch.utils.shapes import host_array as _host
from imageenhancement_mp_tpu_torch.utils.structuring import (get_structuring_element as
                                                             _structuring_element)
from imageenhancement_mp_tpu_torch.utils.taps import deriv_kernels, gaussian_kernel
from imageenhancement_mp_tpu_torch.utils.thresholds import otsu_threshold, triangle_threshold

__all__ = ["apply_lut", "histogram", "gamma", "log_transform", "contrast_stretch",
           "convert_scale_abs", "equalize_hist", "gaussian_blur", "unsharp_mask", "equalize_unsharp",
           "laplacian", "laplacian_sharpen", "sobel", "scharr", "box_blur", "box_filter",
           "corner_harris", "corner_min_eigen_val", "spatial_gradient", "sqr_box_filter",
           "stack_blur", "clahe",
           "median_blur", "bilateral_filter", "threshold", "adaptive_threshold", "warp_affine",
           "warp_perspective", "remap", "warp_polar", "undistort", "get_rotation_matrix_2d",
           "get_affine_transform", "get_perspective_transform", "init_undistort_rectify_map",
           "cvt_color", "cvt_gray", "equalize_luma", "clahe_lab", "fast_nl_means_denoising",
           "fast_nl_means_denoising_colored", "fast_nl_means_denoising_multi",
           "fast_nl_means_denoising_colored_multi", "add_weighted", "integral", "apply_color_map",
           "calc_back_project", "filter2d", "sep_filter2d", "pyr_down", "pyr_up", "resize",
           "flip", "rotate", "transpose", "canny", "connected_components", "erode", "dilate",
           "morphology_ex", "get_structuring_element", "match_template",
           "add", "subtract", "absdiff", "multiply", "divide", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "minimum", "maximum", "compare", "accumulate",
           "accumulate_square", "accumulate_product", "accumulate_weighted", "blend_linear",
           "psnr", "norm", "mean_std_dev", "min_max_loc", "moments_device", "compare_hist",
           "get_gaussian_kernel", "get_deriv_kernels", "get_rect_sub_pix", "corner_sub_pix",
           "good_features_to_track", "calc_optical_flow_pyr_lk", "mean_shift", "cam_shift",
           "pyr_mean_shift_filtering", "edge_preserving_filter", "detail_enhance", "stylization",
           "pencil_sketch", "merge_mertens", "tonemap", "decolor", "denoise_tvl1",
           "tonemap_reinhard", "tonemap_drago", "tonemap_mantiuk", "align_mtb", "merge_debevec",
           "phase_correlate", "inpaint", "seamless_clone", "gabor_kernel", "distance_transform",
           "flood_fill", "hough_lines", "hough_lines_p", "find_contours", "contour_area",
           "arc_length", "bounding_rect", "contour_moments", "moments", "hu_moments",
           "match_shapes", "convex_hull", "is_contour_convex", "point_polygon_test",
           "convexity_defects", "min_area_rect", "box_points", "min_enclosing_circle", "fit_line",
           "fit_ellipse", "approx_poly_dp"]


def _check_u8(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")


def apply_lut(img: torch.Tensor, lut, channels_last: bool = True) -> torch.Tensor:
    """``cv2.LUT``: gather through a 256-entry table (exact).

    ``lut`` (a tensor or array) may be ``[256]`` (shared) or ``[B, 256]``
    with one table per plane (B = N·C in canonical plane order); it is cast
    to uint8, as the JAX package's ``apply_lut`` casts it."""
    _check_u8(img)
    lut = lut if isinstance(lut, torch.Tensor) else torch.from_numpy(np.asarray(lut))
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(pointwise.apply_lut_planes(planes, lut.to(img.device, torch.uint8)))


def histogram(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """Per-plane histogram (``cv2.calcHist`` ≡ bincount — exact).

    256 bins for uint8, 65536 for uint16; int32 counts shaped like the
    input's plane structure: [S], [C,S], [N,S], or [N,C,S]."""
    if img.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"expected uint8 or uint16 image tensor, got {img.dtype}")
    planes, _ = as_planes(img, channels_last=channels_last)
    h = histogram_256(planes)
    if img.dim() == 2:
        return h[0]
    if img.dim() == 3:
        return h  # [C, S] or [N, S]: plane order matches as_planes
    return h.reshape(img.shape[0], img.shape[-1], h.shape[-1])


def gamma(img: torch.Tensor, gamma_value: float, channels_last: bool = True) -> torch.Tensor:
    """Power-law transform ``s = 255·(r/255)^γ``: u8/u16 through static LUTs
    (exact), f32 directly."""
    _check_image_dtype(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(pointwise.gamma_planes(planes, float(gamma_value)))


def log_transform(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """Log transform ``s = (255/log 256)·log(1+r)``: u8/u16 through static
    LUTs (exact), f32 directly."""
    _check_image_dtype(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(pointwise.log_planes(planes))


def convert_scale_abs(img: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
                      channels_last: bool = True) -> torch.Tensor:
    """``cv2.convertScaleAbs(src, alpha, beta)`` per plane: uint8 saturated
    at 255, like cv2, for u8, u16, i16 or f32 input."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(pointwise.convert_scale_abs_planes(planes, float(alpha), float(beta)))


def contrast_stretch(img: torch.Tensor, out_range: tuple[float, float] = (0.0, 255.0),
                     channels_last: bool = True) -> torch.Tensor:
    """``cv2.normalize(NORM_MINMAX, α, β)`` per plane (exact on u8, u16 and
    i16; f32 cv2's float path)."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(pointwise.contrast_stretch_planes(
        planes, (float(out_range[0]), float(out_range[1]))))


def equalize_hist(img: torch.Tensor, per_frame: bool = True, per_channel: bool = True,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.equalizeHist`` (exact, 8-bit).

    ``per_frame=True`` (default) equalizes each plane independently like
    per-image cv2 calls.  ``per_frame=False`` pools the histogram and LUT
    across the batch, flicker-free for video: with ``per_channel=True``
    (default) each channel pools its own histogram across the frames, with
    ``per_channel=False`` every plane shares one."""
    _check_u8(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    if per_frame:
        return restore(equalize_hist_planes(planes))
    channels = 1
    if per_channel and (img.dim() == 4 or treat_as_hwc(img, channels_last)):
        channels = img.shape[-1]
    return restore(equalize_hist_global_planes(planes, channels))


def gaussian_blur(img: torch.Tensor, ksize=5, sigma: float = 0.0, sigma_y: float = 0.0,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.GaussianBlur`` on u8, u16, i16 or f32 — bit-exact on u8 and u16
    for any odd ksize and any σ (u8 through the conv kernel on CUDA).

    ``ksize``: int (square) or (rows, cols) — cv2's Size argument is
    (cols, rows); a 0 dimension is derived from its σ like cv2.
    ``sigma_y`` ≤ 0 follows ``sigma``.  i16: the f32 separable conv,
    rounded and saturated; f32: the f32 separable conv."""
    _check_image_dtype(img, allow_i16=True)
    ks = int(ksize) if isinstance(ksize, (int, np.integer)) else (int(ksize[0]), int(ksize[1]))
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.gaussian_blur_planes(planes, ks, float(sigma), float(sigma_y)))


def unsharp_mask(img: torch.Tensor, amount: float = 1.0, ksize: int = 5, sigma: float = 0.0,
                 channels_last: bool = True) -> torch.Tensor:
    """``cv2.addWeighted(src, 1+a, GaussianBlur(src), −a, 0)`` on u8, u16,
    i16 or f32 — exact on u8 and u16 for any ``amount`` and any σ (cv2's
    two-FMA f32 chain; u8 through the conv kernel on CUDA)."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.unsharp_mask_planes(planes, float(amount), int(ksize), float(sigma)))


def laplacian(img: torch.Tensor, ksize: int = 1, delta: float = 0.0,
              channels_last: bool = True) -> torch.Tensor:
    """``cv2.Laplacian`` (exact; u8 → int16, u16/i16 → int32, f32 → f32).
    ``ksize=1``: the 4-neighbour stencil; ``ksize≥3``: the Sobel-based form
    with raw-sum single saturation."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.laplacian_planes(planes, int(ksize), float(delta)))


def laplacian_sharpen(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """Sharpen = saturate(src − Laplacian(src)) (exact)."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.laplacian_sharpen_planes(planes))


def sobel(img: torch.Tensor, dx: int = 1, dy: int = 0, ksize: int = 3, scale: float = 1.0,
          delta: float = 0.0, channels_last: bool = True) -> torch.Tensor:
    """``cv2.Sobel`` (``ksize=-1`` = Scharr), REFLECT_101.  u8 → int16
    (exact at scale 1, any delta); u16/i16 → int32 (exact); f32 → f32.
    ``scale ≠ 1`` folds the scale into f32 taps.  Integer inputs: ksize
    limited to the exact int32 range (u8 ≤ 11, 16-bit ≤ 7 for first
    derivatives); convert to f32 for larger kernels."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.sobel_planes(planes, int(dx), int(dy), int(ksize), float(scale),
                                        float(delta)))


def scharr(img: torch.Tensor, dx: int = 1, dy: int = 0, scale: float = 1.0, delta: float = 0.0,
           channels_last: bool = True) -> torch.Tensor:
    """``cv2.Scharr`` — the 3×3 [3,10,3] derivative (see :func:`sobel`)."""
    return sobel(img, dx, dy, -1, scale, delta, channels_last)


def box_blur(img: torch.Tensor, ksize=3, channels_last: bool = True) -> torch.Tensor:
    """``cv2.blur(img, Size(kw, kh))`` — the normalized box (mean) filter,
    REFLECT_101.  ``ksize``: int or (rows, cols), odd dims ≥ 1.  u8/u16/i16
    exact; f32 f32 window sums times ``f32(1/area)``."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.box_blur_planes(planes, ksize))


def box_filter(img: torch.Tensor, ksize=3, normalize: bool = True,
               channels_last: bool = True) -> torch.Tensor:
    """``cv2.boxFilter`` — normalized == :func:`box_blur`; raw window sums
    otherwise (int32/f32, exact; even sizes with cv2's anchor)."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.box_filter_planes(planes, ksize, bool(normalize)))


def corner_harris(img: torch.Tensor, block_size: int = 2, ksize: int = 3, k: float = 0.04,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.cornerHarris`` — u8 in, f32 response."""
    _check_u8(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.corner_harris_planes(planes, int(block_size), int(ksize), float(k)))


def corner_min_eigen_val(img: torch.Tensor, block_size: int = 3, ksize: int = 3,
                         channels_last: bool = True) -> torch.Tensor:
    """``cv2.cornerMinEigenVal`` — u8 in, f32 response."""
    _check_u8(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.corner_min_eigen_val_planes(planes, int(block_size), int(ksize)))


def spatial_gradient(img: torch.Tensor, border: str = "reflect101",
                     channels_last: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``cv2.spatialGradient`` — the exact (dx, dy) Sobel-3 pair, u8 in,
    int16 out; ``border`` reflect101 or replicate (cv2's only two)."""
    _check_u8(img)
    if border not in ("reflect101", "replicate"):
        raise ValueError("border must be 'reflect101' or 'replicate'")
    planes, restore = as_planes(img, channels_last=channels_last)
    dx, dy = filters.spatial_gradient_planes(planes, str(border))
    return restore(dx), restore(dy)


def sqr_box_filter(img: torch.Tensor, ksize=3, normalize: bool = True,
                   channels_last: bool = True) -> torch.Tensor:
    """``cv2.sqrBoxFilter`` (ddepth → CV_32F) — REFLECT_101 window sums of
    squares in int64 (f64 for f32 input), one f32 cast."""
    _check_image_dtype(img, allow_i16=True)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.sqr_box_filter_planes(planes, ksize, bool(normalize)))


def stack_blur(img: torch.Tensor, ksize, channels_last: bool = True) -> torch.Tensor:
    """``cv2.stackBlur`` — u8, ``ksize`` int or (rows, cols), odd: two integer
    running-sum passes per axis and the pinned fixed-point descale."""
    _check_image_dtype(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(filters.stack_blur_planes(planes, ksize))


def clahe(img: torch.Tensor, clip_limit: float = 40.0, tile_grid: tuple[int, int] = (8, 8),
          channels_last: bool = True) -> torch.Tensor:
    """``cv2.createCLAHE(clip_limit, grid)`` per plane, u8 or u16 — exact.

    ``tile_grid`` is (rows, cols); cv2's Size argument is (cols, rows)."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(clahe_planes(planes, float(clip_limit), tuple(tile_grid)))


def median_blur(img: torch.Tensor, ksize: int = 3, channels_last: bool = True) -> torch.Tensor:
    """``cv2.medianBlur`` (exact; border = replicate; any odd ksize ≥ 3) on
    u8, u16, i16 or f32; the kernel takes u8/u16/i16 at ksize 3 and 5."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(median_blur_planes(planes, int(ksize)))


def bilateral_filter(img: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 50.0, channels_last: bool = True) -> torch.Tensor:
    """``cv2.bilateralFilter(img, d, σ_color, σ_space)`` — edge-preserving
    denoise, uint8.  Grayscale shapes filter per plane (the kernel on CUDA);
    C=3 colour uses cv2's JOINT semantics (one weight per pixel from the L1
    colour distance; plain PyTorch).  C ∉ {1, 3} and σ ≤ 0 raise."""
    _check_u8(img)
    color = img.dim() in (3, 4) and (
        treat_as_hwc(img, channels_last) if img.dim() == 3 else True) and img.shape[-1] == 3
    if img.dim() == 4 and img.shape[-1] not in (1, 3):
        raise ValueError(f"bilateral_filter needs C in (1, 3) like cv2, got {tuple(img.shape)}")
    if not color and img.dim() == 3 and treat_as_hwc(img, channels_last) and img.shape[-1] != 1:
        raise ValueError(f"bilateral_filter needs C in (1, 3) like cv2, got {tuple(img.shape)}")
    if color:
        return bilateral_color(img, int(d), float(sigma_color), float(sigma_space))
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(bilateral_planes(planes, int(d), float(sigma_color), float(sigma_space)))


def adaptive_threshold(img: torch.Tensor, maxval: float = 255.0, method: str = "mean",
                       type: str = "binary", block_size: int = 3, C: float = 0.0,
                       channels_last: bool = True) -> torch.Tensor:
    """``cv2.adaptiveThreshold(img, maxval, method, type, blockSize, C)`` —
    exact (uint8).  ``method``: mean | gaussian (the kernel on CUDA, any odd
    block size); ``type``: binary | binary_inv.  BORDER_REPLICATE."""
    _check_u8(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(adaptive_threshold_planes(planes, float(maxval), str(method), str(type),
                                             int(block_size), float(C)))


def threshold(img: torch.Tensor, thresh: float = 0.0, maxval: float = 255.0,
              type: str = "binary", method: str | None = None, channels_last: bool = True):
    """``cv2.threshold(img, thresh, maxval, type)`` — exact; returns
    ``(ret, dst)`` like cv2.  u8, u16, i16 or f32.

    ``type``: binary | binary_inv | trunc | tozero | tozero_inv.
    ``method``: None | "otsu" | "triangle" — compute the threshold from each
    plane's histogram (uint8 only, like cv2): the histograms in one
    ``hist256`` launch on CUDA, then cv2's scans on the host.  On a batch,
    every plane gets its own threshold — ``ret`` is then a NumPy array shaped
    like the plane structure ([C], [N], or [N,C]) instead of cv2's scalar.
    """
    if img.dtype not in (torch.uint8, torch.uint16, torch.int16, torch.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32 image tensor, got {img.dtype}")
    planes, restore = as_planes(img, channels_last=channels_last)
    if method is None:
        ret = float(thresh) if img.dtype == torch.float32 else float(np.floor(float(thresh)))
        return ret, restore(threshold_planes(planes, float(thresh), float(maxval), str(type)))
    if method not in ("otsu", "triangle"):
        raise ValueError(f"method must be None, 'otsu' or 'triangle', got {method!r}")
    if img.dtype != torch.uint8:
        raise TypeError(f"{method} threshold is uint8-only, like cv2")
    hists = hist256(planes.contiguous()).cpu().numpy()  # [B, 256], plane order
    plane_px = planes.shape[-2] * planes.shape[-1]
    ts = np.array([otsu_threshold(h, plane_px) if method == "otsu" else triangle_threshold(h)
                   for h in hists], dtype=np.int32)
    out = restore(threshold_planes(planes, torch.from_numpy(ts), float(maxval), str(type)))
    if img.dim() == 2:
        ret = float(ts[0])
    elif img.dim() == 3:
        ret = ts.astype(np.float64)  # [C] or [N], plane order == as_planes
    else:
        ret = ts.reshape(img.shape[0], img.shape[-1]).astype(np.float64)
    return ret, out


def warp_affine(img: torch.Tensor, M, dsize, interpolation: str = "linear",
                border: str = "constant", border_value: float = 0.0, inverse_map: bool = False,
                channels_last: bool = True) -> torch.Tensor:
    """``cv2.warpAffine(img, M, (ow, oh), ...)`` — ``dsize`` is (oh, ow)
    row-major, ``M`` a 2×3 matrix.  Exact for every dtype (u8/u16/i16/f32):
    cv2 5.0's hybrid f32 coordinate field and single-FMA lerp for
    u8/u16/f32 (u8 linear and nearest through the gather kernel on CUDA),
    cv2's legacy fixed point with float tab weights for i16; ``cubic`` and
    ``lanczos4`` as the JAX package's.  ``border``: constant (with
    ``border_value``, saturated like cv2) or replicate.  ``inverse_map`` is
    cv2's WARP_INVERSE_MAP."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(warp_affine_planes(planes, np.asarray(M, np.float64).reshape(2, 3),
                                      (int(dsize[0]), int(dsize[1])), str(interpolation),
                                      str(border), float(border_value), bool(inverse_map)))


def warp_perspective(img: torch.Tensor, M, dsize, interpolation: str = "linear",
                     border: str = "constant", border_value: float = 0.0,
                     inverse_map: bool = False, channels_last: bool = True) -> torch.Tensor:
    """``cv2.warpPerspective(img, M, (ow, oh), ...)`` — ``dsize`` is (oh, ow),
    ``M`` a 3×3 homography; the same dtypes, borders and interpolations as
    :func:`warp_affine`.  The perspective field is divided on the device,
    tensor by tensor (IEEE f32)."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(warp_perspective_planes(planes, np.asarray(M, np.float64).reshape(3, 3),
                                           (int(dsize[0]), int(dsize[1])), str(interpolation),
                                           str(border), float(border_value),
                                           bool(inverse_map)))


def remap(img: torch.Tensor, map_x, map_y, interpolation: str = "linear",
          border: str = "constant", border_value: float = 0.0,
          channels_last: bool = True) -> torch.Tensor:
    """``cv2.remap`` with f32 coordinate maps ``(oh, ow)`` (tensors or NumPy
    arrays), shared by every plane of the batch as in cv2.  u8 linear and
    nearest through the gather kernel on CUDA."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(remap_planes(planes, map_x, map_y, str(interpolation), str(border),
                                float(border_value)))


def warp_polar(img: torch.Tensor, dsize, center, max_radius: float, log: bool = False,
               inverse: bool = False, interpolation: str = "linear",
               channels_last: bool = True) -> torch.Tensor:
    """``cv2.warpPolar`` with ``WARP_FILL_OUTLIERS`` — ``dsize`` is cv2's
    (width, height) of the output; ``log=True`` is ``WARP_POLAR_LOG``,
    ``inverse=True`` maps a polar image back to cartesian.  cv2's maps are
    reproduced on the host once per geometry and kept on the device."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(warp_polar_planes(planes, (int(dsize[0]), int(dsize[1])),
                                     (float(center[0]), float(center[1])), float(max_radius),
                                     bool(log), bool(inverse), str(interpolation)))


def undistort(img: torch.Tensor, K, dist, new_K=None, channels_last: bool = True) -> torch.Tensor:
    """``cv2.undistort`` — cv2's quantized-map path: u8 through the 32×32
    integer tab, the other dtypes through the float tab."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(undistort_planes(planes, K, dist, new_K))


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` (host f64; ``center`` is (cx, cy) like cv2)."""
    return warp_coords.get_rotation_matrix_2d(center, angle_deg, scale)


def get_affine_transform(src, dst) -> np.ndarray:
    """``cv2.getAffineTransform`` (3 point pairs → 2×3 f64)."""
    return warp_coords.get_affine_transform(src, dst)


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` (4 point pairs → 3×3 f64)."""
    return warp_coords.get_perspective_transform(src, dst)


def init_undistort_rectify_map(K, dist, size, new_K=None):
    """``cv2.initUndistortRectifyMap`` (host f32 maps; ``size`` is (H, W)) —
    feed the result to :func:`remap`."""
    return warp_coords.init_undistort_rectify_map(K, dist, size, new_K)


# -- colour conversion ---------------------------------------------------------

_CVT_CODES = (
    "rgb2gray", "bgr2gray", "rgba2gray", "bgra2gray",
    "rgb2ycrcb", "bgr2ycrcb", "ycrcb2rgb", "ycrcb2bgr",
    "rgb2hsv", "bgr2hsv", "hsv2rgb", "hsv2bgr",
    "rgb2hls", "bgr2hls", "hls2rgb", "hls2bgr",
    "rgb2xyz", "bgr2xyz", "xyz2rgb", "xyz2bgr",
    "rgb2lab", "bgr2lab", "lab2rgb", "lab2bgr",
    "rgb2luv", "bgr2luv", "luv2rgb", "luv2bgr",
)


def _check_image_dtype(img: torch.Tensor, allow_i16: bool = False) -> None:
    ok = (torch.uint8, torch.uint16, torch.float32) + ((torch.int16,) if allow_i16 else ())
    if img.dtype not in ok:
        raise TypeError(f"expected uint8/uint16{'/int16' if allow_i16 else ''}/float32 image "
                        f"tensor, got {img.dtype}")


def cvt_color(img: torch.Tensor, code: str) -> torch.Tensor:
    """``cv2.cvtColor`` — codes ``{rgb,bgr,rgba,bgra}2gray``,
    ``{rgb,bgr}2{ycrcb,hsv,hls,xyz,lab,luv}`` and their inverses on
    ``[..,H,W,C]``.  Gray/YCrCb: u8/u16 exact, f32 cv2's FMA chains.
    HSV/HLS: u8, exact.  XYZ/Lab: u8 exact both ways (Lab through table
    lookups, the ``take_table`` kernel on CUDA); f32 the float formulas.
    Luv: u8 forward through cv2's packed trilinear tables, u8 inverse and
    f32 both ways through the float formulas."""
    _check_image_dtype(img)
    code = str(code).lower()
    if code not in _CVT_CODES:
        raise ValueError(f"code must be one of {_CVT_CODES}, got {code!r}")
    if img.dim() not in (3, 4):
        raise ValueError(f"expected [H,W,C] or [N,H,W,C], got {tuple(img.shape)}")
    fwd = "bgr" if code.startswith("b") else "rgb"
    inv = "bgr" if code.endswith("bgr") else "rgb"
    if code.endswith("2gray"):
        return color.cvt_gray_nhwc(img, fwd)
    for name, to_fn, from_fn in (("ycrcb", color.rgb_to_ycrcb_nhwc, color.ycrcb_to_rgb_nhwc),
                                 ("hsv", color.rgb_to_hsv_nhwc, color.hsv_to_rgb_nhwc),
                                 ("hls", color.rgb_to_hls_nhwc, color.hls_to_rgb_nhwc),
                                 ("xyz", color.rgb_to_xyz_nhwc, color.xyz_to_rgb_nhwc),
                                 ("lab", color.rgb_to_lab_nhwc, color.lab_to_rgb_nhwc),
                                 ("luv", color.rgb_to_luv_nhwc, color.luv_to_rgb_nhwc)):
        if code.endswith("2" + name):
            return to_fn(img, fwd)
        if code.startswith(name):
            return from_fn(img, inv)
    raise AssertionError(code)  # every code is handled above


def cvt_gray(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_{RGB,BGR}[A]2GRAY)`` on ``[H,W,C]`` or
    ``[N,H,W,C]``, C ∈ {3,4} (alpha ignored).  u8/u16 exact (15-bit
    sum-preserving fixed point); f32 cv2's two-FMA chain.  The channel axis
    is dropped."""
    _check_image_dtype(img)
    if img.dim() not in (3, 4):
        raise ValueError(f"expected [H,W,C] or [N,H,W,C], got {tuple(img.shape)}")
    return color.cvt_gray_nhwc(img, str(order))


def _need_tensor(x, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} takes torch.Tensor inputs, got {type(x).__name__}")


def _check_u8_rgb(img: torch.Tensor, what: str) -> None:
    _need_tensor(img, what)
    if img.dtype != torch.uint8:
        raise TypeError(f"{what}, got {img.dtype}")
    if img.dim() not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {tuple(img.shape)}")


def equalize_luma(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """Colour histogram equalization: RGB → YCrCb, ``cv2.equalizeHist`` on
    the luma plane, back to RGB — exact at every stage.  uint8 ``[H,W,3]``
    or ``[N,H,W,3]``."""
    _check_u8_rgb(img, "equalize_luma is uint8 (cv2.equalizeHist is 8-bit)")
    ycc = color.rgb_to_ycrcb_nhwc(img, order)
    y = equalize_hist_planes(ycc[..., 0].reshape((-1,) + tuple(ycc.shape[-3:-1])))
    y = y.reshape(ycc.shape[:-1])
    return color.ycrcb_to_rgb_nhwc(torch.cat([y[..., None], ycc[..., 1:]], dim=-1), order)


def clahe_lab(img: torch.Tensor, clip_limit: float = 2.0, tile_grid: tuple[int, int] = (8, 8),
              order: str = "rgb") -> torch.Tensor:
    """Colour CLAHE: RGB → Lab (cv2's u8 fixed point), CLAHE on the L plane
    only, back to RGB — cv2's ``cvtColor → CLAHE-on-L → cvtColor`` recipe,
    exact.  uint8 ``[H,W,3]`` or ``[N,H,W,3]``; ``tile_grid`` is (rows,
    cols)."""
    _check_u8_rgb(img, "clahe_lab is uint8 (cv2 Lab u8 path)")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    lab = color.rgb_to_lab_nhwc(img, order)
    L = clahe_planes(lab[..., 0].reshape((-1,) + tuple(lab.shape[-3:-1])), float(clip_limit),
                     tuple(tile_grid))
    L = L.reshape(lab.shape[:-1])
    return color.lab_to_rgb_nhwc(torch.cat([L[..., None], lab[..., 1:]], dim=-1), order)


# -- non-local means -----------------------------------------------------------

def fast_nl_means_denoising(img: torch.Tensor, h: float = 10.0, template_window: int = 7,
                            search_window: int = 21, channels_last: bool = True,
                            norm_type: str = "l2") -> torch.Tensor:
    """``cv2.fastNlMeansDenoising`` — bit-exact, uint8 (L2 or L1) or uint16
    (L1 only, cv2's own constraint; int64 accumulators).  Multichannel inputs
    follow cv2's vector-pixel semantics: one joint SSD over the channels
    drives a shared weight.  A 3-D input with last dim ≤ 4 is one [H,W,C]
    image (the ``as_planes`` ambiguity rule)."""
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    if norm_type not in ("l1", "l2"):
        raise ValueError(f"norm_type must be 'l1' or 'l2', got {norm_type!r}")
    if img.dtype == torch.uint16:
        if norm_type != "l1":
            raise ValueError("uint16 fastNlMeansDenoising requires norm_type='l1'"
                             " (cv2's own constraint)")
        vec, restore = as_vec(img, channels_last=channels_last)
        return restore(fast_nl_means_u16_vec(vec, float(h), t, s))
    _check_u8(img)
    vec, restore = as_vec(img, channels_last=channels_last)
    return restore(fast_nl_means_vec(vec, float(h), t, s, str(norm_type)))


def _check_colored(img: torch.Tensor, order: str, t: int, s: int, what: str) -> None:
    if img.dtype != torch.uint8:
        raise TypeError(f"{what} is uint8, got {img.dtype}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")


def fast_nl_means_denoising_colored(img: torch.Tensor, h: float = 3.0, h_color: float = 3.0,
                                    template_window: int = 7, search_window: int = 21,
                                    order: str = "rgb") -> torch.Tensor:
    """``cv2.fastNlMeansDenoisingColored`` — bit-exact: convert with the
    linear-RGB Lab variant (COLOR_LBGR2Lab), denoise L alone with ``h`` and
    the (a, b) pair as one 2-channel vector image with ``h_color``, convert
    back.  uint8 ``[H,W,3]`` or ``[N,H,W,3]``."""
    t, s = int(template_window), int(search_window)
    _check_colored(img, order, t, s, "fastNlMeansDenoisingColored")
    if img.dim() not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {tuple(img.shape)}")
    lab = color.rgb_to_lab_nhwc(img, order, srgb=False)
    batched = lab if lab.dim() == 4 else lab[None]
    L = fast_nl_means_vec(batched[..., :1], float(h), t, s)
    ab = fast_nl_means_vec(batched[..., 1:3], float(h_color), t, s)
    out = color.lab_to_rgb_nhwc(torch.cat([L, ab], dim=-1), order, srgb=False)
    return out if lab.dim() == 4 else out[0]


def _frames(frames, what: str):
    """A stacked tensor as it is, or a list of tensor frames; NumPy frames
    raise (each frame stays on its own device)."""
    if isinstance(frames, torch.Tensor):
        return frames
    if not isinstance(frames, (list, tuple)) or not all(
            isinstance(f, torch.Tensor) for f in frames):
        raise TypeError(f"{what} takes a stacked torch.Tensor or a list of torch.Tensor "
                        f"frames, not NumPy arrays")
    if not frames:
        raise ValueError(f"{what}: no frames")
    return list(frames)


def _frame_stack(frames, what: str) -> torch.Tensor:
    frames = _frames(frames, what)
    return frames if isinstance(frames, torch.Tensor) else torch.stack(frames)


def _temporal_stack(frames, idx: int, tw: int) -> torch.Tensor:
    tw, idx = int(tw), int(idx)
    if tw % 2 == 0:
        raise ValueError("temporalWindowSize must be odd")
    frames = _frames(frames, "fastNlMeansDenoisingMulti")
    lo = idx - tw // 2
    if lo < 0 or idx + tw // 2 >= len(frames):
        raise ValueError("temporal window exceeds the frame list")
    stack = _frame_stack(frames[lo:lo + tw], "fastNlMeansDenoisingMulti")
    if stack.dtype != torch.uint8:
        raise TypeError("fastNlMeansDenoisingMulti requires uint8 frames")
    return stack


def fast_nl_means_denoising_multi(frames, img_to_denoise_index: int, temporal_window_size: int,
                                  h: float = 3.0, template_window: int = 7,
                                  search_window: int = 21) -> torch.Tensor:
    """``cv2.fastNlMeansDenoisingMulti`` — bit-exact temporal NLMeans: the
    search set is every spatial offset in every frame of the odd
    ``temporal_window_size`` window centred on ``img_to_denoise_index``;
    templates come from the target frame.  ``frames`` is a ``[T,H,W]`` or
    ``[T,H,W,C]`` uint8 tensor (or a list of frame tensors); returns the denoised
    target frame."""
    stack = _temporal_stack(frames, img_to_denoise_index, temporal_window_size)
    if stack.dim() not in (3, 4) or (stack.dim() == 4 and stack.shape[-1] not in (1, 2, 3, 4)):
        raise ValueError(f"expected [T,H,W] or [T,H,W,C<=4] frames, got {tuple(stack.shape)}")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    vec = stack if stack.dim() == 4 else stack[..., None]
    out = fast_nl_means_multi_vec(vec[:, None], float(h), t, s)[0]
    return out if stack.dim() == 4 else out[..., 0]


def fast_nl_means_denoising_colored_multi(frames, img_to_denoise_index: int,
                                          temporal_window_size: int, h: float = 3.0,
                                          h_color: float = 3.0, template_window: int = 7,
                                          search_window: int = 21,
                                          order: str = "rgb") -> torch.Tensor:
    """``cv2.fastNlMeansDenoisingColoredMulti`` — bit-exact: every window
    frame converted with the linear-RGB Lab variant, temporal NLMeans on L
    with ``h`` and on the (a, b) pairs with ``h_color``, the target
    converted back.  ``frames`` is a ``[T,H,W,3]`` uint8 tensor (or a
    list of frame tensors); returns the denoised target."""
    stack = _temporal_stack(frames, img_to_denoise_index, temporal_window_size)
    if stack.dim() != 4 or stack.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] frames, got {tuple(stack.shape)}")
    t, s = int(template_window), int(search_window)
    _check_colored(stack, order, t, s, "fastNlMeansDenoisingColoredMulti")
    lab = color.rgb_to_lab_nhwc(stack, order, srgb=False)[:, None]
    L = fast_nl_means_multi_vec(lab[..., :1], float(h), t, s)
    ab = fast_nl_means_multi_vec(lab[..., 1:3], float(h_color), t, s)
    return color.lab_to_rgb_nhwc(torch.cat([L, ab], dim=-1)[0], order, srgb=False)


# -- point ops, geometry, edges, morphology and matching (the rest of the JAX
# package's OP_REGISTRY and its four point functions): plain PyTorch on the
# input's device, calc_back_project through apply_lut256

def _run(fn, img: torch.Tensor, channels_last: bool, **kwargs) -> torch.Tensor:
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(fn(planes, **kwargs))


def add_weighted(src1: torch.Tensor, alpha: float, src2: torch.Tensor, beta: float,
                 gamma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(src1, α, src2, β, γ)`` — exact for u8/u16/i16
    (cvRound + saturate) and bit-identical f32 (cv2's two-FMA chain).
    Elementwise: both inputs share any accepted shape."""
    _check_image_dtype(src1, allow_i16=True)
    return pointwise.add_weighted_arrays(src1, float(alpha), src2, float(beta), float(gamma))


def integral(img: torch.Tensor, sq: bool = False, channels_last: bool = True):
    """``cv2.integral`` / ``cv2.integral2`` per plane — ``[B, H+1, W+1]`` in
    canonical plane order.  u8 exact int32; u16/i16/f32 f32 sums, summed in
    f64 and cast once (u16/i16 equal the f64 oracle's f32 value)."""
    _check_image_dtype(img, allow_i16=True)
    planes, _ = as_planes(img, channels_last=channels_last)
    return pointwise.integral_planes(planes, bool(sq))


def apply_color_map(img: torch.Tensor, colormap: str = "jet",
                    channels_last: bool = True) -> torch.Tensor:
    """``cv2.applyColorMap`` — u8 gray → ``[B, H, W, 3]`` RGB through cv2's
    tables (``utils/colormaps.py`` lists the 22 names).  Returns RGB (cv2
    returns BGR)."""
    _check_u8(img)
    planes, _ = as_planes(img, channels_last=channels_last)
    return pointwise.apply_color_map_planes(planes, str(colormap))


def calc_back_project(img: torch.Tensor, hist, scale: float = 1.0,
                      channels_last: bool = True) -> torch.Tensor:
    """``cv2.calcBackProject([img],[0],hist,[0,256],scale)`` — exact folded
    LUT gather (u8; any bin count), one ``apply_lut256`` on CUDA."""
    _check_u8(img)
    return _run(pointwise.calc_back_project_planes, img, channels_last, hist=hist,
                scale=float(scale))


def filter2d(img: torch.Tensor, kernel, delta: float = 0.0,
             channels_last: bool = True) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel, delta=δ)`` — custom-kernel correlation
    (anchor kh//2, REFLECT_101), kernels ≤ 15×15.  Integer-valued kernels
    are exact on every dtype; float kernels on integer images sum in f64,
    exact against the f64 oracle; f32 images sum in f32."""
    _check_image_dtype(img, allow_i16=True)
    return _run(filter2d_planes, img, channels_last, kernel=kernel, delta=float(delta))


def sep_filter2d(img: torch.Tensor, kernel_x, kernel_y, delta: float = 0.0,
                 channels_last: bool = True) -> torch.Tensor:
    """``cv2.sepFilter2D(img, -1, kx, ky, delta)`` — ``filter2d`` with the
    outer product ``ky ⊗ kx``, as the JAX package composes it."""
    kx = _host(kernel_x).astype(np.float64).ravel()
    ky = _host(kernel_y).astype(np.float64).ravel()
    return filter2d(img, np.outer(ky, kx), delta, channels_last)


def pyr_down(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """``cv2.pyrDown``: REFLECT_101 [1,4,6,4,1] blur + 2× decimation →
    ``ceil(H/2) × ceil(W/2)`` (exact u8/u16/i16; f32 in f32)."""
    _check_image_dtype(img, allow_i16=True)
    return _run(pyr_down_planes, img, channels_last)


def pyr_up(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """``cv2.pyrUp``: 2× zero-stuff + [1,4,6,4,1] blur → ``2H × 2W`` (exact
    u8/u16/i16; f32 in f32)."""
    _check_image_dtype(img, allow_i16=True)
    return _run(pyr_up_planes, img, channels_last)


def resize(img: torch.Tensor, dsize, interpolation: str = "linear",
           channels_last: bool = True) -> torch.Tensor:
    """``cv2.resize(img, (ow, oh), interpolation)`` — ``dsize`` is
    ``(oh, ow)``, row-major.  ``interpolation``: nearest, linear (u8
    bit-exact fixed point; u16/i16/f32 cv2's f32 path), cubic, lanczos4
    (u8 exact integer sums) or area (integer factors exact, the 2×2 half-up
    path included; the general downscale in f64)."""
    _check_image_dtype(img, allow_i16=True)
    return _run(rs.resize_planes, img, channels_last, dsize=(int(dsize[0]), int(dsize[1])),
                interpolation=str(interpolation))


def flip(img: torch.Tensor, code: int = 0, channels_last: bool = True) -> torch.Tensor:
    """``cv2.flip``: 0 = vertical (rows), positive = horizontal (cols),
    negative = both — exact, any dtype."""
    _check_image_dtype(img, allow_i16=True)
    return _run(rs.flip_planes, img, channels_last, code=int(code))


def rotate(img: torch.Tensor, code: str = "90cw", channels_last: bool = True) -> torch.Tensor:
    """``cv2.rotate``: ``90cw`` | ``180`` | ``90ccw`` — exact."""
    _check_image_dtype(img, allow_i16=True)
    return _run(rs.rotate_planes, img, channels_last, code=str(code))


def transpose(img: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """``cv2.transpose`` — exact."""
    _check_image_dtype(img, allow_i16=True)
    return _run(rs.transpose_planes, img, channels_last)


def canny(img: torch.Tensor, threshold1: float, threshold2: float, aperture_size: int = 3,
          l2_gradient: bool = False, channels_last: bool = True) -> torch.Tensor:
    """``cv2.Canny`` — bit-exact, L1/L2 × aperture 3/5/7; uint8 input only,
    like cv2; 0/255 uint8 edges.  Replicate-border Sobel, cv2's fixed-point
    NMS, 8-connected hysteresis (a fixpoint on the device)."""
    _check_u8(img)
    return _run(canny_planes, img, channels_last, threshold1=float(threshold1),
                threshold2=float(threshold2), aperture_size=int(aperture_size),
                l2_gradient=bool(l2_gradient))


def connected_components(img: torch.Tensor, connectivity: int = 8,
                         channels_last: bool = True) -> torch.Tensor:
    """``cv2.connectedComponents`` — int32 labels (0 = background), numbered
    as cv2 numbers them for both connectivities (4: first-pixel raster
    order; 8: cv2's BBDT first-2×2-block order)."""
    _check_u8(img)
    return _run(connected_components_planes, img, channels_last,
                connectivity=int(connectivity))


def erode(img: torch.Tensor, ksize=3, iterations: int = 1, kernel=None,
          channels_last: bool = True) -> torch.Tensor:
    """``cv2.erode`` — exact min filter; rect ``ksize`` (int or (rows,
    cols), even allowed) or an arbitrary 0/1 ``kernel`` mask (see
    ``get_structuring_element``).  u8/u16/i16/f32."""
    _check_image_dtype(img, allow_i16=True)
    return _run(morphology.erode_planes, img, channels_last, ksize=ksize,
                iterations=int(iterations), kernel=kernel)


def dilate(img: torch.Tensor, ksize=3, iterations: int = 1, kernel=None,
           channels_last: bool = True) -> torch.Tensor:
    """``cv2.dilate`` — exact max filter (see ``erode``)."""
    _check_image_dtype(img, allow_i16=True)
    return _run(morphology.dilate_planes, img, channels_last, ksize=ksize,
                iterations=int(iterations), kernel=kernel)


def morphology_ex(img: torch.Tensor, op: str = "open", ksize=3, iterations: int = 1,
                  kernel=None, channels_last: bool = True) -> torch.Tensor:
    """``cv2.morphologyEx`` — exact: erode | dilate | open | close |
    gradient | tophat | blackhat; rect or arbitrary 0/1 kernels."""
    _check_image_dtype(img, allow_i16=True)
    return _run(morphology.morphology_planes, img, channels_last, op=str(op), ksize=ksize,
                iterations=int(iterations), kernel=kernel)


def get_structuring_element(shape: str, ksize) -> np.ndarray:
    """``cv2.getStructuringElement`` (host helper, bit-exact): rect |
    ellipse | cross; ``ksize`` = (rows, cols)."""
    return _structuring_element(shape, ksize)


def match_template(img: torch.Tensor, templ, method: str = "ccoeff_normed",
                   channels_last: bool = True) -> torch.Tensor:
    """``cv2.matchTemplate`` — f32 result ``(H-th+1, W-tw+1)`` per plane, the
    six methods in f64 and cast once (within 3e-6 relative of cv2; the
    SQDIFF_NORMED [0, 1] clamp)."""
    _check_image_dtype(img, allow_i16=True)
    return _run(match_template_planes, img, channels_last, templ=templ, method=str(method))


# -- arithmetic, accumulate and blendLinear: plain PyTorch on the input's device

def _arith(op: str, a: torch.Tensor, b: torch.Tensor = None, scale: float = 1.0) -> torch.Tensor:
    _check_image_dtype(a, allow_i16=True)
    return arith.arith_arrays(op, a, b, float(scale))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.add`` — saturating elementwise sum (exact)."""
    return _arith("add", a, b)


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.subtract`` — saturating difference (exact)."""
    return _arith("subtract", a, b)


def absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.absdiff`` — |a−b| saturated (exact)."""
    return _arith("absdiff", a, b)


def multiply(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``cv2.multiply(a, b, scale)`` — the f64 product, exact, with cv2's
    INT_MIN rule (a product past int32 saturates to the dtype's minimum);
    f32 ``(a·b)·scale`` in f32."""
    return _arith("multiply", a, b, scale)


def divide(a: torch.Tensor, b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``cv2.divide(a, b, scale)`` — the f64 quotient rounded half to even,
    ``b == 0`` → 0 for integer dtypes (exact); f32 ``(a·scale)/b`` with IEEE
    ±inf/nan."""
    return _arith("divide", a, b, scale)


def bitwise_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.bitwise_and`` — exact (integer dtypes)."""
    return _arith("bitwise_and", a, b)


def bitwise_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.bitwise_or`` — exact."""
    return _arith("bitwise_or", a, b)


def bitwise_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.bitwise_xor`` — exact."""
    return _arith("bitwise_xor", a, b)


def bitwise_not(a: torch.Tensor) -> torch.Tensor:
    """``cv2.bitwise_not`` — exact."""
    return _arith("bitwise_not", a)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.min`` — exact."""
    return _arith("minimum", a, b)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cv2.max`` — exact."""
    return _arith("maximum", a, b)


def compare(a: torch.Tensor, b: torch.Tensor, op: str = "gt") -> torch.Tensor:
    """``cv2.compare`` — uint8 0/255 mask; op: eq/gt/ge/lt/le/ne."""
    if op not in arith.COMPARE_OPS:
        raise ValueError(f"unknown compare op {op!r}")
    return _arith(op, a, b)


def accumulate(src: torch.Tensor, acc: torch.Tensor, mask=None) -> torch.Tensor:
    """``cv2.accumulate`` — the new f32 accumulator ``acc + f32(src)``
    (pixels where ``mask`` is 0 keep ``acc``), exact."""
    return arith.accumulate_arrays("acc", src, acc, mask=mask)


def accumulate_square(src: torch.Tensor, acc: torch.Tensor, mask=None) -> torch.Tensor:
    """``cv2.accumulateSquare`` — ``acc + f32(src)²``, exact."""
    return arith.accumulate_arrays("sq", src, acc, mask=mask)


def accumulate_product(src1: torch.Tensor, src2: torch.Tensor, acc: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """``cv2.accumulateProduct`` — ``acc + f32(src1)·f32(src2)``, exact."""
    return arith.accumulate_arrays("product", src1, acc, src2, mask=mask)


def accumulate_weighted(src: torch.Tensor, acc: torch.Tensor, alpha: float,
                        mask=None) -> torch.Tensor:
    """``cv2.accumulateWeighted`` — the running average ``acc·f32(1−α) +
    src·f32(α)`` with each product rounded on its own (cv2's native path),
    exact."""
    return arith.accumulate_arrays("weighted", src, acc, alpha=float(alpha), mask=mask)


def blend_linear(src1: torch.Tensor, src2: torch.Tensor, weights1, weights2) -> torch.Tensor:
    """``cv2.blendLinear`` — ``(src1·w1 + src2·w2) / (w1 + w2 + 1e-5)`` in
    f32, each product rounded on its own; u8 rounds half to even and
    saturates.  ``weights*`` are ``[H, W]`` f32 shared across channels."""
    return arith.blend_linear_arrays(src1, src2, weights1, weights2)


# -- statistics: 0-d tensors on the input's device; compare_hist on the host

def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """``cv2.PSNR`` — a 0-d f32 tensor (``inf`` on identical inputs): the
    squared-error sum exact in int64 for integer inputs, ``10·log10`` in
    f64, one f32 rounding.  No host sync."""
    return stats.psnr_arrays(a, b, float(max_val))


def norm(a: torch.Tensor, norm_type: str = "l2", b=None) -> torch.Tensor:
    """``cv2.norm(a[, b])`` — l1 | l2 | inf as a 0-d f32 tensor: exact int64
    sums for integer inputs (f64 otherwise), one f32 rounding."""
    return stats.norm_arrays(a, str(norm_type), b)


def mean_std_dev(img: torch.Tensor):
    """``cv2.meanStdDev`` — (mean, population std) 0-d f32 tensors: exact
    int64 sums for integer inputs, one f32 rounding each."""
    return stats.mean_std_dev_arrays(img)


def min_max_loc(arr: torch.Tensor):
    """``cv2.minMaxLoc`` on a 2-D map — ``(min_val, max_val, (min_x, min_y),
    (max_x, max_y))``, every entry a 0-d tensor (f32 values, int32
    coordinates), cv2's first-occurrence rule and (x, y) order."""
    mn, mx, ix, iy, ax, ay = stats.min_max_loc_plane(arr)
    return mn, mx, (ix, iy), (ax, ay)


def moments_device(img: torch.Tensor, binary_image: bool = False) -> dict:
    """``cv2.moments`` of a 2-D image — a dict of 24 0-d f32 tensors (the
    keys of ``MOMENT_KEYS``): raw moments exact in int64 for integer
    images, cv2's completion in f64, one f32 rounding per entry."""
    v = stats.moments_plane(img, bool(binary_image))
    return {k: v[i] for i, k in enumerate(stats.MOMENT_KEYS)}


def compare_hist(h1, h2, method: str = "correl") -> float:
    """``cv2.compareHist`` (host helper, f64): correl | chisqr | intersect |
    bhattacharyya."""
    return tracking.compare_hist(_host(h1), _host(h2), method)


def get_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """``cv2.getGaussianKernel`` — the ``[ksize, 1]`` f64 column kernel,
    bit-exact to the oracle (the fixed tables for σ ≤ 0, k ≤ 9)."""
    return gaussian_kernel(int(ksize), float(sigma), per_tap=True).reshape(-1, 1)


def get_deriv_kernels(dx: int, dy: int, ksize: int, normalize: bool = False):
    """``cv2.getDerivKernels`` — the (kx, ky) Sobel (ksize 1–31) or Scharr
    (ksize −1) taps as ``[n, 1]`` f32 columns, bit-exact."""
    kx, ky = deriv_kernels(int(dx), int(dy), int(ksize), bool(normalize), max_ksize=31)
    return (np.asarray(kx, np.float32).reshape(-1, 1), np.asarray(ky, np.float32).reshape(-1, 1))


# -- sub-pixel patches, corners, optical flow, mean shift

def get_rect_sub_pix(img: torch.Tensor, patch_size, centers, patch_type: str = None):
    """``cv2.getRectSubPix``, batched over centres — one ``(w, h)`` patch per
    row of ``centers`` ``[N, 2]`` (x, y) from one ``[H, W]`` / ``[H, W, C]``
    u8 or f32 image → ``[N, h, w(, C)]`` (a single ``(cx, cy)`` pair returns
    one patch).  cv2's three summation laws and its Q16 u8 kernel, exact.
    Centres must lie inside the image (as cv2 requires)."""
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"getRectSubPix supports u8/f32, got {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError("get_rect_sub_pix expects one [H,W] or [H,W,C] image")
    if patch_type is None:
        patch_type = "f32" if img.dtype == torch.float32 else "u8"
    if patch_type not in ("u8", "f32"):
        raise ValueError(f"patch_type must be 'u8' or 'f32', got {patch_type!r}")
    if img.dtype == torch.float32 and patch_type == "u8":
        raise ValueError("f32 source only extracts f32 patches (as cv2)")
    c = centers if isinstance(centers, torch.Tensor) else torch.as_tensor(
        np.asarray(centers, np.float32))
    single = c.dim() == 1
    out = get_rect_sub_pix_planes(img, c.reshape(-1, 2), int(patch_size[0]),
                                  int(patch_size[1]), patch_type == "f32")
    return out[0] if single else out


def corner_sub_pix(img: torch.Tensor, corners, win_size, zero_zone=(-1, -1),
                   max_count: int = 100, epsilon: float = 0.0) -> torch.Tensor:
    """``cv2.cornerSubPix`` — sub-pixel corner refinement on the host (a
    handful of corners, each a tiny iterative 2×2 solve), the oracle's law;
    returns the refined f32 corners on ``img``'s device."""
    out = tracking.corner_sub_pix(_host(img), _host(corners).astype(np.float32), win_size,
                                  zero_zone, max_count, epsilon)
    return torch.from_numpy(out).to(img.device)


def good_features_to_track(img: torch.Tensor, max_corners: int = 0, quality_level: float = 0.01,
                           min_distance: float = 10.0, mask=None, block_size: int = 3,
                           gradient_size: int = 3, use_harris: bool = False,
                           k: float = 0.04) -> torch.Tensor:
    """``cv2.goodFeaturesToTrack`` — ``[N, 2]`` f32 (x, y) corners on
    ``img``'s device.  The response map (minEigenVal or Harris) runs on the
    device; the selection chain (threshold, 3×3 NMS, stable sort, grid
    min-distance) on the host over the fetched map, as the oracle's."""
    _check_u8(img)
    if img.dim() != 2:
        raise ValueError("goodFeaturesToTrack expects a single [H,W] image")
    resp = (corner_harris(img, block_size, gradient_size, k) if use_harris
            else corner_min_eigen_val(img, block_size, gradient_size))
    pts = tracking.select_features(_host(resp), int(max_corners), float(quality_level),
                                   float(min_distance), None if mask is None else _host(mask))
    return torch.from_numpy(pts).to(img.device)


def _lk_levels(shape, ww: int, wh: int, max_level: int) -> int:
    """buildOpticalFlowPyramid's clamp: stop when the next level's width or
    height would be at most the window's."""
    h, w = shape
    n = 0
    for _ in range(max_level):
        nw, nh = (w + 1) // 2, (h + 1) // 2
        if nw <= ww or nh <= wh:
            break
        h, w, n = nh, nw, n + 1
    return n


def calc_optical_flow_pyr_lk(prev_img: torch.Tensor, next_img: torch.Tensor, prev_pts,
                             win_size=(21, 21), max_level: int = 3, max_count: int = 30,
                             epsilon: float = 0.01, min_eig_threshold: float = 1e-4,
                             exact: bool = True):
    """``cv2.calcOpticalFlowPyrLK`` — pyramidal Lucas-Kanade tracking of N
    points between two u8 ``[H, W]`` frames → ``(next_pts f32 [N, 2], status
    u8 [N], err f32 [N])`` on the frames' device.  ``exact=True`` sums in
    cv2's SIMD lane order and equals the oracle bit for bit;
    ``exact=False`` sums each window in one free-order reduction (within
    0.1 px of it on tracked points)."""
    _check_u8(prev_img)
    _check_u8(next_img)
    if prev_img.dim() != 2 or next_img.dim() != 2:
        raise ValueError("calc_optical_flow_pyr_lk expects [H,W] grayscale")
    ww, wh = int(win_size[0]), int(win_size[1])
    pts = prev_pts if isinstance(prev_pts, torch.Tensor) else torch.as_tensor(
        np.asarray(prev_pts, np.float32))
    pts = pts.to(prev_img.device, torch.float32).reshape(-1, 2)
    ml = min(int(max_level), _lk_levels(tuple(prev_img.shape), ww, wh, int(max_level)),
             _lk_levels(tuple(next_img.shape), ww, wh, int(max_level)))

    def pyramid(img):
        levels = [img]
        for _ in range(ml):
            levels.append(pyr_down_planes(levels[-1][None])[0])
        return levels

    return calc_optical_flow_pyr_lk_planes(pyramid(prev_img), pyramid(next_img), pts,
                                           (ww, wh), ml, int(max_count), float(epsilon),
                                           float(min_eig_threshold), bool(exact))


def mean_shift(prob_image, window, max_count: int = 100, epsilon: float = 1.0):
    """``cv2.meanShift`` on a back-projection map (host helper, integer
    dynamics, exact) → ``(iterations, (x, y, w, h))``; pairs with
    ``calc_back_project``."""
    return tracking.mean_shift(_host(prob_image), window, max_count, epsilon)


def cam_shift(prob_image, window, max_count: int = 100, epsilon: float = 1.0):
    """``cv2.CamShift`` — ``mean_shift`` and the oriented box from the
    grown window's moments (host helper) → ``((center, size, angle),
    (x, y, w, h))``."""
    return tracking.cam_shift(_host(prob_image), window, max_count, epsilon)


def pyr_mean_shift_filtering(img: torch.Tensor, sp: float, sr: float, max_level: int = 1,
                             max_count: int = 5, epsilon: float = 1.0) -> torch.Tensor:
    """``cv2.pyrMeanShiftFiltering`` — colour mean-shift segmentation, exact
    (dense masked iteration, ``cvRound(n·fl64(1/count))`` in f64).  ``img``
    is u8 ``[H, W, 3]`` or ``[N, H, W, 3]``; termcrit as cv2's (COUNT+EPS,
    5, 1.0)."""
    _check_u8(img)
    if img.dim() not in (3, 4) or img.shape[-1] != 3:
        raise ValueError("pyr_mean_shift_filtering expects [H,W,3] or [N,H,W,3] uint8")
    if not 0 <= int(max_level) <= 8:
        raise ValueError("max_level must be in [0, 8]")
    batch = img if img.dim() == 4 else img[None]
    out = pyr_mean_shift_planes(batch, float(sp), float(sr), int(max_level), int(max_count),
                                float(epsilon))
    return out if img.dim() == 4 else out[0]


# -- OpenCV's photo module and its companions: the domain-transform filters,
# the HDR merges and tonemaps, decolor, TV-L1 (plain torch on the input's
# device; merge_debevec's two tables through apply_lut256, decolor's u8 Lab
# legs through take_table), AlignMTB, phaseCorrelate, seamlessClone and
# inpaint (their host legs in utils/photo_host.py)

def _batched(fn, img: torch.Tensor):
    out = fn(img if img.dim() == 4 else img[None])
    if img.dim() == 4:
        return out
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


def edge_preserving_filter(img: torch.Tensor, flags: str = "recursive", sigma_s: float = 60.0,
                           sigma_r: float = 0.4) -> torch.Tensor:
    """``cv2.edgePreservingFilter`` — the Gastal domain transform on u8
    ``[H,W,3]`` / ``[N,H,W,3]``: ``flags='recursive'`` (RECURS_FILTER, the f32
    IIR chains one torch op per step) or ``'normconv'`` (NORMCONV_FILTER:
    sequential f32 coordinates, ``searchsorted`` box bounds, box means)."""
    _check_u8_rgb(img, "edgePreservingFilter is uint8")
    if flags not in ("recursive", "normconv"):
        raise ValueError(f"flags must be 'recursive' or 'normconv', got {flags!r}")
    return _batched(lambda x: photo.edge_preserving_filter_nhwc(
        x, flags, float(sigma_s), float(sigma_r)), img)


def detail_enhance(img: torch.Tensor, sigma_s: float = 10.0, sigma_r: float = 0.15,
                   order: str = "rgb") -> torch.Tensor:
    """``cv2.detailEnhance`` — the RF filter on the f32 Lab L plane, the
    detail layer boosted 3×.  u8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_u8_rgb(img, "detailEnhance is uint8")
    color._order(order)
    return _batched(lambda x: photo.detail_enhance_nhwc(
        x, float(sigma_s), float(sigma_r), order), img)


def stylization(img: torch.Tensor, sigma_s: float = 60.0, sigma_r: float = 0.45) -> torch.Tensor:
    """``cv2.stylization`` — the NC domain-transform filter and Sobel edge
    darkening.  u8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_u8_rgb(img, "stylization is uint8")
    return _batched(lambda x: photo.stylization_nhwc(x, float(sigma_s), float(sigma_r)), img)


def pencil_sketch(img: torch.Tensor, sigma_s: float = 60.0, sigma_r: float = 0.07,
                  shade_factor: float = 0.02, order: str = "rgb"):
    """``cv2.pencilSketch`` — ``(gray u8 [..H,W], color u8 [..H,W,3])``, the
    oracle's law bit for bit.  u8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_u8_rgb(img, "pencilSketch is uint8")
    color._order(order)
    return _batched(lambda x: photo.pencil_sketch_nhwc(
        x, float(sigma_s), float(sigma_r), float(shade_factor), order), img)


def _stack_rgb_u8(frames, what: str) -> torch.Tensor:
    stack = _frame_stack(frames, what)
    if stack.dim() != 4 or stack.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] frames, got {tuple(stack.shape)}")
    if stack.dtype != torch.uint8:
        raise TypeError(f"{what} expects uint8 frames, got {stack.dtype}")
    return stack


def merge_mertens(images, contrast_weight: float = 1.0, saturation_weight: float = 1.0,
                  exposure_weight: float = 0.0) -> torch.Tensor:
    """``cv2.createMergeMertens(...).process`` — exposure fusion of a
    ``[T,H,W,3]`` u8 tensor (or a list of frames) into f32 ``[H,W,3]``
    (about [0, 1]; scale by 255 and clip to display)."""
    stack = _stack_rgb_u8(images, "merge_mertens")
    return photo.merge_mertens_nhwc(stack, float(contrast_weight), float(saturation_weight),
                                    float(exposure_weight))


def _check_f32(img, what: str) -> None:
    _need_tensor(img, what)
    if img.dtype != torch.float32:
        raise TypeError(f"{what} expects float32 HDR input, got {img.dtype}")


def tonemap(img: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """``cv2.createTonemap(gamma).process`` — global min-max normalize and
    ``pow(1/gamma)``; a constant image maps to zeros.  f32 ``[H,W,3]``."""
    _check_f32(img, "tonemap")
    return photo.tonemap_nhwc(img, float(gamma))


def decolor(img: torch.Tensor, order: str = "rgb"):
    """``cv2.decolor`` — ``(grayscale u8 [H,W], color_boost u8 [H,W,3])``.
    The 9 polynomial weights solve on the host over the fetched image (at
    most 800 rows plus columns of work image); the evaluation, min-max
    normalize and the u8 Lab L-replacement (15 ``take_table`` lookups) run
    on the device."""
    _need_tensor(img, "decolor")
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[-1] != 3:
        raise TypeError("decolor expects a uint8 [H,W,3] image")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"unknown channel order {order!r}")
    rgb = img.flip(-1) if order == "bgr" else img
    wei, combs = photo_host.decolor_weights(_host(rgb).astype(np.float32) / np.float32(255.0))
    x = rgb.to(torch.float32) * color._f(1.0 / 255.0, rgb)
    chans = (x[..., 0], x[..., 1], x[..., 2])
    gray = torch.zeros_like(chans[0])
    for w, exps in zip(wei, combs):
        term = color._f(w, x)
        for ch, e in zip(chans, exps):
            if e:
                term = term * (ch if e == 1 else ch * ch)
        gray = gray + term
    mn, mx = gray.min(), gray.max()
    gray = torch.where(mx > mn, (gray - mn) / (mx - mn), gray * 0)
    g8 = torch.round(gray * color._f(255.0, x)).clamp(0, 255).to(torch.uint8)
    lab = color.rgb_to_lab_nhwc(rgb.contiguous(), "rgb")
    boost = color.lab_to_rgb_nhwc(torch.cat([g8[..., None], lab[..., 1:]], dim=-1), "rgb")
    return g8, (boost.flip(-1) if order == "bgr" else boost)


def denoise_tvl1(observations, lam: float = 1.0, niters: int = 30) -> torch.Tensor:
    """``cv2.denoise_TVL1`` — the Chambolle-Pock primal-dual TV-L1 denoiser
    on one or more noisy u8 ``[H,W]`` observations: a list of tensors or one
    ``[K,H,W]`` (or ``[H,W]``) tensor."""
    stack = _frame_stack(observations, "denoise_tvl1")
    if stack.dim() == 2:
        stack = stack[None]
    if stack.dtype != torch.uint8 or stack.dim() != 3:
        raise TypeError("denoise_tvl1 expects uint8 [H,W] observations")
    if int(niters) < 1 or float(lam) <= 0:
        raise ValueError("niters must be >= 1 and lam > 0")
    return photo.denoise_tvl1_stack(stack, float(lam), int(niters))


def _check_f32_rgb(img, what: str) -> None:
    _check_f32(img, what)
    if img.dim() != 3 or img.shape[-1] != 3:
        raise ValueError(f"{what} expects an f32 [H,W,3] image, got {tuple(img.shape)}")


def tonemap_reinhard(img: torch.Tensor, gamma: float = 1.0, intensity: float = 0.0,
                     light_adapt: float = 1.0, color_adapt: float = 0.0) -> torch.Tensor:
    """``cv2.createTonemapReinhard(...).process`` — f32 ``[H,W,3]`` HDR in,
    f32 [0, 1] out."""
    _check_f32_rgb(img, "tonemap_reinhard")
    return photo.tonemap_reinhard_nhwc(img[None], float(gamma), float(intensity),
                                       float(light_adapt), float(color_adapt))[0]


def tonemap_drago(img: torch.Tensor, gamma: float = 1.0, saturation: float = 1.0,
                  bias: float = 0.85) -> torch.Tensor:
    """``cv2.createTonemapDrago(...).process`` — f32 ``[H,W,3]``."""
    _check_f32_rgb(img, "tonemap_drago")
    return photo.tonemap_drago_nhwc(img[None], float(gamma), float(saturation), float(bias))[0]


def tonemap_mantiuk(img: torch.Tensor, gamma: float = 1.0, scale: float = 0.7,
                    saturation: float = 1.0) -> torch.Tensor:
    """``cv2.createTonemapMantiuk(...).process`` in its closed form
    ``L' = L^(scale^(1/0.4185))`` — f32 ``[H,W,3]``."""
    _check_f32_rgb(img, "tonemap_mantiuk")
    return photo.tonemap_mantiuk_nhwc(img[None], float(gamma), float(scale),
                                      float(saturation))[0]


def _shift(img: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """``cv2.AlignMTB.shiftMat``: translate by ``(sx, sy)``, zero fill."""
    out = torch.zeros_like(img)
    H, W = img.shape[:2]
    out[max(0, sy):min(H, H + sy), max(0, sx):min(W, W + sx)] = \
        img[max(0, -sy):min(H, H - sy), max(0, -sx):min(W, W - sx)]
    return out


def align_mtb(frames, max_bits: int = 6, exclude_range: int = 4, cut: bool = True) -> list:
    """``cv2.createAlignMTB(...).process`` — median-threshold-bitmap
    alignment of an exposure stack to its middle frame, bit-exact: the u8
    grays on the device, the greedy pyramid search over them on the host,
    the shifts and the crop to the common region (``cut``) on the device.
    ``frames``: a ``[T,H,W,3]`` u8 tensor or a list of frames; returns a
    list of aligned frames on their device."""
    frames = _frames(frames, "align_mtb")
    if isinstance(frames, torch.Tensor) and (frames.dim() != 4 or frames.shape[-1] != 3):
        raise ValueError(f"expected [T,H,W,3], got {tuple(frames.shape)}")
    if any(f.dim() != 3 or f.shape[-1] != 3 for f in frames):
        raise ValueError("align_mtb expects a list of [H,W,3] u8 frames")
    grays = [_host(color.cvt_gray_nhwc(f, "rgb")) for f in frames]
    shifts = photo_host.mtb_shifts(grays, int(max_bits), int(exclude_range))
    out = [_shift(f, sx, sy) for f, (sx, sy) in zip(frames, shifts)]
    if cut:
        xs, ys = [s[0] for s in shifts], [s[1] for s in shifts]
        mx, my = max(0, max(xs)), max(0, max(ys))
        nx, ny = min(0, min(xs)), min(0, min(ys))
        H, W = frames[0].shape[:2]
        out = [o[my:H + ny, mx:W + nx] for o in out]
    return out


def merge_debevec(frames, times) -> torch.Tensor:
    """``cv2.createMergeDebevec().process`` — HDR radiance from a
    ``[T,H,W,3]`` u8 tensor (or a list of frames) and the exposure times in
    seconds: f32 ``[H,W,3]``.  Its two 256-entry f32 tables are two
    ``apply_lut256`` lookups (``apply_lut256_wide`` on CUDA)."""
    stack = _stack_rgb_u8(frames, "merge_debevec")
    t = tuple(float(v) for v in np.asarray(times).ravel())
    if len(t) != stack.shape[0]:
        raise ValueError("times must match the number of frames")
    return photo.merge_debevec_nhwc(stack, t)


def phase_correlate(src1: torch.Tensor, src2: torch.Tensor, window=None):
    """``cv2.phaseCorrelate`` — sub-pixel translation between two equal-size
    single-channel frames, one device program on ``torch.fft`` (f32
    spectra): the optional window, the zero pad to the optimal DFT size,
    the normalized cross-power spectrum, the first maximum of its shifted
    inverse and the clamped 5×5 centroid.  Returns ``((dx, dy),
    response)``."""
    _need_tensor(src1, "phase_correlate")
    _need_tensor(src2, "phase_correlate")
    if src1.dim() != 2 or tuple(src2.shape) != tuple(src1.shape):
        raise ValueError("phase_correlate expects equal-shape 2-D inputs")
    H, W = src1.shape
    M, N = photo_host.optimal_dft_size(H), photo_host.optimal_dft_size(W)
    dev = src1.device
    a, b = src1.to(torch.float32), src2.to(dev, torch.float32)
    if window is not None:
        _need_tensor(window, "phase_correlate")
        w = window.to(dev, torch.float32)
        a, b = a * w, b * w
    pa = torch.zeros((M, N), dtype=torch.float32, device=dev)
    pb = torch.zeros_like(pa)
    pa[:H, :W] = a
    pb[:H, :W] = b
    P = torch.fft.fft2(pa) * torch.conj(torch.fft.fft2(pb))
    mag = P.abs()
    zero = mag == 0
    Q = torch.where(zero, torch.zeros_like(P), P / torch.where(zero, torch.ones_like(mag), mag))
    C = torch.fft.fftshift(torch.fft.ifft2(Q).real)
    flat = torch.argmax(C)
    py, px = flat // N, flat % N
    off = torch.arange(-2, 3, device=dev)
    ys = (py + off).clamp(0, M - 1)
    xs = (px + off).clamp(0, N - 1)
    box = C[ys][:, xs]
    first = torch.ones(1, dtype=torch.bool, device=dev)
    uy = torch.cat([first, ys[1:] != ys[:-1]])
    ux = torch.cat([first, xs[1:] != xs[:-1]])
    box = torch.where(uy[:, None] & ux[None, :], box, torch.zeros_like(box))
    s = box.sum()
    se = s + color._f(1.2e-38, C)
    cy = (box * ys[:, None].to(torch.float32)).sum() / se
    cx = (box * xs[None, :].to(torch.float32)).sum() / se
    dx, dy, resp = torch.stack([N / 2.0 - cx, M / 2.0 - cy, s]).tolist()
    return (dx, dy), resp


def inpaint(img: torch.Tensor, mask: torch.Tensor, inpaint_radius: float = 3.0,
            flags: str = "telea") -> torch.Tensor:
    """``cv2.inpaint`` (Telea fast marching) on a grayscale u8 ``[H,W]``
    image: a host helper by design (a priority-queue fill where every
    painted pixel feeds the next pop), the oracle's law bit for bit on the
    fetched image and mask; the result lies on ``img``'s device."""
    if flags != "telea":
        raise ValueError("only INPAINT_TELEA is implemented (flags='telea'); cv2's "
                         "INPAINT_NS iterative solver is not transcribed yet")
    _need_tensor(img, "inpaint")
    _need_tensor(mask, "inpaint")
    out = photo_host.inpaint_telea(_host(img), _host(mask), float(inpaint_radius))
    return torch.from_numpy(out).to(img.device)


def seamless_clone(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor, p,
                   flags: str = "normal") -> torch.Tensor:
    """``cv2.seamlessClone`` (NORMAL_CLONE) — Poisson image editing of u8
    gray or RGB tensors: the mask's bounding box in ``src`` pasted centred
    at ``p`` (x, y) in ``dst``.  The geometry is host work on the fetched
    mask; the Poisson solve (type-1 sine transforms through ``torch.fft``)
    and the paste run on the device."""
    for t in (src, dst, mask):
        _need_tensor(t, "seamless_clone")
    if src.dtype != torch.uint8 or dst.dtype != torch.uint8:
        raise TypeError("seamless_clone: uint8 images only")
    if flags != "normal":
        raise ValueError("only NORMAL_CLONE is implemented (flags='normal')")
    ys, xs = np.nonzero(_host(mask) != 0)
    if ys.size == 0:
        return dst.clone()
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    h, w = y1 - y0, x1 - x0
    cx, cy = int(p[0]), int(p[1])
    dy0, dx0 = cy - h // 2, cx - w // 2
    if dy0 < 0 or dx0 < 0 or dy0 + h > dst.shape[0] or dx0 + w > dst.shape[1]:
        raise ValueError("pasted ROI falls outside dst")

    def planes(a):
        return a[None] if a.dim() == 2 else a.permute(2, 0, 1)

    sp = planes(src[y0:y1, x0:x1])
    dp = planes(dst[dy0:dy0 + h, dx0:dx0 + w])
    blended = seamless_clone_patch(sp, dp, mask[y0:y1, x0:x1].to(dst.device) != 0)
    out = dst.clone()
    out[dy0:dy0 + h, dx0:dx0 + w] = blended[0] if src.dim() == 2 else blended.permute(1, 2, 0)
    return out


# -- distanceTransform, floodFill and the Hough transforms; contours, shape
# descriptors and moments (host helpers in utils/contours_host.py and
# utils/hough_host.py)

def gabor_kernel(ksize, sigma: float, theta: float, lambd: float, gamma: float = 1.0,
                 psi: float = np.pi / 2) -> np.ndarray:
    """``cv2.getGaborKernel`` (host helper, f64, ``ksize`` = (rows, cols)):
    the oracle's formula bit for bit; pair it with ``filter2d`` for Gabor
    banks."""
    return taps.gabor_kernel(ksize, sigma, theta, lambd, gamma, psi)


def distance_transform(img: torch.Tensor, distance_type: str = "l2", mask_size: int = 3,
                       dst_type: str = "f32", channels_last: bool = True) -> torch.Tensor:
    """``cv2.distanceTransform`` per plane of a u8 tensor: zero pixels are
    the sources.  The two-pass chamfer over sheared columns on the tensor's
    device (``ops/distance.py``), bit for bit the oracle's law: L1 (1, 2),
    C (1, 1), L2 3×3 (0.955, 1.3693), L2 5×5 (1, 1.4, 2.1969); L1 and C
    take the 3×3 mask.  ``dst_type='u8'`` (L1 only, as cv2) clips and
    truncates the f32 field."""
    _need_tensor(img, "distance_transform")
    _check_u8(img)
    dt = str(distance_type).lower()
    if dt not in ("l1", "l2", "c"):
        raise ValueError(f"distance_type must be l1|l2|c, got {distance_type!r}")
    if int(mask_size) not in (3, 5):
        raise ValueError(f"mask_size must be 3 or 5, got {mask_size}")
    if dst_type not in ("f32", "u8"):
        raise ValueError(f"dst_type must be f32|u8, got {dst_type!r}")
    if dst_type == "u8" and dt != "l1":
        raise ValueError("dst_type='u8' requires distance_type='l1' (cv2)")
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(distance_transform_planes(planes, dt, int(mask_size), str(dst_type)))


_FLOOD_DTYPES = {torch.uint8: (0, 255), torch.uint16: (0, 65535), torch.float32: None}


def flood_fill(img: torch.Tensor, seed_point, new_val, lo_diff=0, up_diff=0,
               connectivity: int = 4, fixed_range: bool = False, mask=None,
               mask_only: bool = False, mask_fill: int = 1):
    """``cv2.floodFill`` on a u8, u16 or f32 ``[H,W]`` or ``[H,W,C≤4]``
    tensor → ``(n, image, mask, rect)`` as cv2 returns them: the filled
    count, the filled image, the ``(H+2, W+2)`` u8 mask with its ring set
    to 1 and ``mask_fill`` in the filled cells, and the ``(x, y, w, h)``
    rectangle.  ``seed_point`` is (x, y); ``mask`` (a tensor or array) is
    copied, never written.  The region grows on the tensor's device as a
    fixpoint of shifted ORs (``ops/floodfill.py``); image and mask come
    back on that device."""
    _need_tensor(img, "flood_fill")
    if img.dtype not in _FLOOD_DTYPES:
        raise TypeError(f"floodFill supports uint8/uint16/float32, got {img.dtype}")
    gray = img.dim() == 2
    if not gray and (img.dim() != 3 or img.shape[2] > 4):
        raise ValueError(f"expected [H,W] or [H,W,C<=4], got {tuple(img.shape)}")
    H, W = img.shape[:2]
    C = 1 if gray else img.shape[2]
    x0, y0 = int(seed_point[0]), int(seed_point[1])
    if not (0 <= x0 < W and 0 <= y0 < H):
        raise ValueError(f"seed {seed_point} outside {W}x{H} image")
    conn = int(connectivity) or 4
    if conn not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    dev = img.device
    if mask is None:
        out_mask = torch.zeros((H + 2, W + 2), dtype=torch.uint8, device=dev)
    else:
        m = mask if isinstance(mask, torch.Tensor) else torch.from_numpy(np.asarray(mask))
        out_mask = m.to(dev, torch.uint8, copy=True)
    if tuple(out_mask.shape) != (H + 2, W + 2):
        raise ValueError("mask must be (H+2, W+2) uint8")
    blocked = out_mask[1:-1, 1:-1] != 0
    out_mask[0, :] = 1
    out_mask[-1, :] = 1
    out_mask[:, 0] = 1
    out_mask[:, -1] = 1
    lo = np.broadcast_to(np.abs(np.asarray(lo_diff, np.float32)).reshape(-1), (C,))
    up = np.broadcast_to(np.abs(np.asarray(up_diff, np.float32)).reshape(-1), (C,))
    region, n, rect, _ = flood_region(img.reshape(H, W, C).to(torch.float32), blocked,
                                      (y0, x0), torch.from_numpy(lo.copy()),
                                      torch.from_numpy(up.copy()), conn, bool(fixed_range))
    out = img.clone()
    if n == 0:
        return 0, out, out_mask, (0, 0, 0, 0)
    out_mask[1:-1, 1:-1].masked_fill_(region, int(mask_fill if mask_fill else 1))
    if not mask_only:
        nv = np.broadcast_to(np.asarray(new_val, np.float64).reshape(-1), (C,))
        lims = _FLOOD_DTYPES[img.dtype]
        if lims is None:
            fill = torch.from_numpy(nv.astype(np.float32))
            target = out
        else:
            fillv = np.clip(np.rint(nv), *lims)
            if img.dtype == torch.uint16:   # written through the int16 view
                fill = torch.from_numpy(fillv.astype(np.uint16).view(np.int16))
                target = out.view(torch.int16)
            else:
                fill = torch.from_numpy(fillv.astype(np.uint8))
                target = out
        if gray:
            target.masked_fill_(region, fill[0].item())
        else:
            target[region] = fill.to(dev)
    return n, out, out_mask, rect


def hough_lines(img: torch.Tensor, rho: float = 1.0, theta: float = np.pi / 180,
                threshold: int = 100, min_theta: float = 0.0,
                max_theta: float = np.pi) -> np.ndarray:
    """``cv2.HoughLines`` (standard) on one ``[H,W]`` u8 tensor → ``[N, 2]``
    f32 (rho, theta) lines, bit for bit the oracle's law.  The votes are
    counted on the tensor's device (``ops/hough.py``); the threshold, the
    4-neighbour maxima and the sort run on the fetched accumulator."""
    _need_tensor(img, "hough_lines")
    if img.dtype != torch.uint8 or img.dim() != 2:
        raise TypeError("HoughLines expects a single [H,W] uint8 image")
    H, W = img.shape
    _, tabcos, tabsin = hough_host.hough_tables(min_theta, max_theta, theta, rho)
    numrho = hough_host.hough_numrho(H, W, float(rho))
    acc = hough_accumulator(img, tabcos, tabsin, numrho).cpu().numpy()
    return hough_host.hough_lines_from_acc(acc, threshold, rho, min_theta, theta)


def hough_lines_p(img, rho: float = 1.0, theta: float = np.pi / 180, threshold: int = 100,
                  min_line_length: int = 0, max_line_gap: int = 0,
                  lines_max: int = 2 ** 31 - 1) -> np.ndarray:
    """``cv2.HoughLinesP`` → ``[N, 4]`` int32 (x1, y1, x2, y2) segments, bit
    for bit (cv2's local RNG stream and its erase-as-you-walk accumulator).
    A host helper by design: each random candidate un-votes and erases what
    the next one reads.  Takes a tensor (fetched) or an array."""
    return hough_host.hough_lines_p(_host(img), float(rho), float(theta), int(threshold),
                                    int(min_line_length), int(max_line_gap), int(lines_max))


def find_contours(img, mode: str = "list", method: str = "simple"):
    """``cv2.findContours`` → ``(contours, hierarchy)``: int32 ``[N, 2]``
    (x, y) arrays and the int32 ``[M, 4]`` hierarchy, in cv2's order, for
    the four modes and both methods.  A host helper by design: Suzuki-Abe
    border following erases as it walks.  Takes a u8 tensor (fetched) or
    array."""
    return contours_host.find_contours(_host(img), mode, method)


def contour_area(points, oriented: bool = False) -> float:
    """``cv2.contourArea`` (host helper): Green's-theorem area, bit for
    bit."""
    return contours_host.contour_area(_host(points), oriented)


def arc_length(points, closed: bool) -> float:
    """``cv2.arcLength`` (host helper): f32 square roots, f64 sum, bit for
    bit."""
    return contours_host.arc_length(_host(points), closed)


def bounding_rect(points):
    """``cv2.boundingRect`` (host helper) → (x, y, w, h), exact."""
    return contours_host.bounding_rect(_host(points))


def contour_moments(points) -> dict:
    """``cv2.moments`` of a point-list contour (host helper): cv2's Green
    closed forms, the 24 keys."""
    return contours_host.contour_moments(_host(points))


def moments(img, binary_image: bool = False) -> dict:
    """``cv2.moments`` of a grayscale image in f64 (host helper: it fetches
    the image; it feeds the exact ``hu_moments``/``match_shapes`` chain).
    On the device use :func:`moments_device`."""
    return contours_host.moments(_host(img), binary_image)


def hu_moments(m) -> np.ndarray:
    """``cv2.HuMoments`` (host helper): the seven invariants ``[7, 1]`` from
    a ``moments``/``contour_moments`` dict."""
    return contours_host.hu_moments(m)


def match_shapes(a, b, method: str = "i1") -> float:
    """``cv2.matchShapes`` of two grayscale images (host helper: fetches
    both): the log-Hu distances I1/I2/I3 with cv2's significance gates."""
    return contours_host.match_shapes(_host(a), _host(b), method)


def convex_hull(points, clockwise: bool = False, return_points: bool = True):
    """``cv2.convexHull`` (host helper): Sklansky's chains in cv2's order,
    points or int32 indices."""
    return contours_host.convex_hull(_host(points), clockwise, return_points)


def is_contour_convex(points) -> bool:
    """``cv2.isContourConvex`` (host helper), exact."""
    return contours_host.is_contour_convex(_host(points))


def point_polygon_test(contour, pt, measure_dist: bool = False) -> float:
    """``cv2.pointPolygonTest`` (host helper): +1/−1/0, or the signed f64
    distance."""
    return contours_host.point_polygon_test(_host(contour), pt, measure_dist)


def convexity_defects(contour, hull_indices) -> np.ndarray:
    """``cv2.convexityDefects`` (host helper) → ``[N, 4]`` int32 (start,
    end, farthest, fixed-point depth), bit for bit."""
    return contours_host.convexity_defects(_host(contour), _host(hull_indices))


def min_area_rect(points):
    """``cv2.minAreaRect`` (host helper) → ((cx, cy), (w, h), angle):
    rotating calipers over the hull in f64."""
    return contours_host.min_area_rect(_host(points))


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints`` (host helper): the four f32 corners of a rotated
    rect."""
    return contours_host.box_points(rect)


def min_enclosing_circle(points):
    """``cv2.minEnclosingCircle`` (host helper) → ((cx, cy), r), Welzl's
    disc in f64."""
    return contours_host.min_enclosing_circle(_host(points))


def fit_line(points, dist_type: str = "l2", param: float = 0.0, reps: float = 0.01,
             aeps: float = 0.01):
    """``cv2.fitLine`` (host helper, 2-D) → (vx, vy, x0, y0) f32: L2 in
    closed form, the robust types by cv2's 20-attempt IRLS scheme."""
    return contours_host.fit_line(_host(points), dist_type, param, reps, aeps)


def fit_ellipse(points):
    """``cv2.fitEllipse`` (host helper) → ((cx, cy), (w, h), angle): direct
    least squares."""
    return contours_host.fit_ellipse(_host(points))


def approx_poly_dp(curve, epsilon, closed: bool) -> np.ndarray:
    """``cv2.approxPolyDP`` (host helper): cv2 5.0's distance-to-segment
    law, bit for bit, for int and f32 curves."""
    return contours_host.approx_poly_dp(_host(curve), float(epsilon), bool(closed))
