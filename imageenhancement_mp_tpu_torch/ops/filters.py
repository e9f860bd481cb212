"""Spatial filters on u8 planes: Gaussian blur and unsharp mask.

The u8 branches of the JAX package's ``ops/filters.py``
``gaussian_blur_planes`` and ``unsharp_mask_planes``.  Both go through
``kernels/conv.py::sep_conv_u8`` with cv2's Q8 taps; u16, i16 and f32 planes
are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.conv import sep_conv_u8
from imageenhancement_mp_tpu_torch.utils.taps import gaussian_axes, gaussian_kernel_fixed

__all__ = ["gaussian_blur_planes", "unsharp_mask_planes", "q8_taps"]

_LATER = (torch.uint16, torch.int16, torch.float32)


def _check_u8(planes: torch.Tensor) -> None:
    if planes.dtype in _LATER:
        raise NotImplementedError(
            f"{planes.dtype} filters are ROADMAP Queue 1 item 7; the port takes uint8")
    if planes.dtype != torch.uint8:
        raise TypeError(f"expected uint8/uint16/int16/float32 planes, got {planes.dtype}")


def q8_taps(ksize, sigma: float, sigma_y: float = 0.0) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """cv2's u8 Q8 taps ``(vertical, horizontal)`` for GaussianBlur's
    ``ksize``/``sigma``/``sigma_y`` conventions."""
    kh, kw, sy, sx = gaussian_axes(ksize, sigma, sigma_y, True)
    return (tuple(int(t) for t in gaussian_kernel_fixed(kh, sy)),
            tuple(int(t) for t in gaussian_kernel_fixed(kw, sx)))


def gaussian_blur_planes(planes: torch.Tensor, ksize=5, sigma: float = 0.0,
                         sigma_y: float = 0.0) -> torch.Tensor:
    """``cv2.GaussianBlur`` on ``[B, H, W]`` u8 planes, bit-exact for any σ.

    ``ksize``: int (square) or (rows, cols); a 0 dimension is derived from
    its σ like cv2.  ``sigma_y`` ≤ 0 follows ``sigma``."""
    _check_u8(planes)
    tv, th = q8_taps(ksize, sigma, sigma_y)
    return sep_conv_u8(planes.contiguous(), tv, th)


def unsharp_mask_planes(planes: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                        sigma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(src, 1+a, GaussianBlur(src), −a, 0)`` on u8 planes —
    exact for any ``amount`` (cv2's two single-rounded f32 FMAs)."""
    _check_u8(planes)
    tv, th = q8_taps(ksize, sigma)
    return sep_conv_u8(planes.contiguous(), tv, th, float(amount))
