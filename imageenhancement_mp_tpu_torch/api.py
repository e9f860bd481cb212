"""Public functions on torch tensors, with the shapes and keyword names of
the JAX package's ``api.py``.

Each accepts ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or ``[N,H,W,C]`` images
(u8, and u16/i16/f32 where a function says so) and works per plane (per
image × channel), except colour ``bilateral_filter``, whose weights join the
three channels.  The output lies on the input's device:
a CPU tensor runs the plain PyTorch versions, a CUDA tensor the kernels.
``channels_last=False`` reads a 3-D input as ``[N, H, W]`` even when W ≤ 4.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.hist import hist256
from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_color, bilateral_planes
from imageenhancement_mp_tpu_torch.ops.clahe import clahe_planes
from imageenhancement_mp_tpu_torch.ops.filters import gaussian_blur_planes, unsharp_mask_planes
from imageenhancement_mp_tpu_torch.ops.histogram import equalize_hist_planes
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.ops.threshold import adaptive_threshold_planes, threshold_planes
from imageenhancement_mp_tpu_torch.ops.warp import (remap_planes, undistort_planes,
                                                    warp_affine_planes, warp_perspective_planes,
                                                    warp_polar_planes)
from imageenhancement_mp_tpu_torch.pipeline import equalize_unsharp
from imageenhancement_mp_tpu_torch.utils import warp_coords
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes, treat_as_hwc
from imageenhancement_mp_tpu_torch.utils.thresholds import otsu_threshold, triangle_threshold

__all__ = ["equalize_hist", "gaussian_blur", "unsharp_mask", "equalize_unsharp", "clahe",
           "median_blur", "bilateral_filter", "threshold", "adaptive_threshold", "warp_affine",
           "warp_perspective", "remap", "warp_polar", "undistort", "get_rotation_matrix_2d",
           "get_affine_transform", "get_perspective_transform", "init_undistort_rectify_map"]


def _check_u8(img: torch.Tensor) -> None:
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")


def equalize_hist(img: torch.Tensor, per_frame: bool = True, per_channel: bool = True,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.equalizeHist`` on each plane (exact, 8-bit).

    Only ``per_frame=True`` is ported; the pooled (video) mode is ROADMAP
    Queue 1 item 4 and raises.  ``per_channel`` only matters when pooled."""
    if not per_frame:
        raise NotImplementedError(
            "pooled equalize_hist (per_frame=False) is ROADMAP Queue 1 item 4")
    _check_u8(img)
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(equalize_hist_planes(planes))


def gaussian_blur(img: torch.Tensor, ksize=5, sigma: float = 0.0, sigma_y: float = 0.0,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.GaussianBlur`` — bit-exact on u8 for any odd ksize ≤ 31 and any σ.

    ``ksize``: int (square) or (rows, cols) — cv2's Size argument is
    (cols, rows); a 0 dimension is derived from its σ like cv2.
    ``sigma_y`` ≤ 0 follows ``sigma``."""
    ks = int(ksize) if isinstance(ksize, (int, np.integer)) else (int(ksize[0]), int(ksize[1]))
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(gaussian_blur_planes(planes, ks, float(sigma), float(sigma_y)))


def unsharp_mask(img: torch.Tensor, amount: float = 1.0, ksize: int = 5, sigma: float = 0.0,
                 channels_last: bool = True) -> torch.Tensor:
    """``cv2.addWeighted(src, 1+a, GaussianBlur(src), −a, 0)`` — exact on u8
    for any ``amount`` and any σ."""
    planes, restore = as_planes(img, channels_last=channels_last)
    return restore(unsharp_mask_planes(planes, float(amount), int(ksize), float(sigma)))


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
