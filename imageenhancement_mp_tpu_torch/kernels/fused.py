"""Fused median → Gaussian → unsharp on u8 planes in one pass.

:func:`median_unsharp` replaces the JAX package's
``kernels/fused.py::median_unsharp_pallas`` with the CUDA kernel
``csrc/fused.cu``: one route for every shape, down to 1×1 (the JAX kernel's
XLA fallback for images smaller than its halos has no counterpart).  Its
median stage runs the schedules of
:mod:`~imageenhancement_mp_tpu_torch.kernels.median_networks`, as
``median_blur``'s kernel does.
:func:`median_unsharp_plain` is the same function in plain PyTorch: the
median's and the conv's plain versions one after the other.

The route is chosen by ksize, as ``kernels/conv.py::conv_route`` chooses
one: up to :data:`FUSED_MAX_TAPS` taps the fused kernel, which takes its
taps by value; past them the chain of two hand kernels, ``median`` then
``sep_conv_u8``'s wide instance, which is exactly what the plain version
computes (a halo of ``ksize//2 + 2`` rows, 270 at 541 taps, fits no tile of
the fused kernel).  Nothing is caught: a failed launch raises on either
route.

The law (the JAX kernel's, ``kernels/fused.py:1-20``): the median takes a
replicate border; the Q8 Gaussian runs over the *median values* with a
REFLECT_101 border; the epilogue is ``sep_conv_u8``'s two single-rounded
f32 FMAs for every amount, which equal the JAX kernel's integer form for an
integral amount.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.conv import (sep_conv_u8, sep_conv_u8_plain,
                                                       unsharp_weights)
from imageenhancement_mp_tpu_torch.kernels.median import median_blur, median_blur_plain
from imageenhancement_mp_tpu_torch.utils.taps import gaussian_kernel_fixed

__all__ = ["FUSED_MAX_TAPS", "median_unsharp", "median_unsharp_plain", "fused_taps"]

FUSED_MAX_TAPS = 31  # the most taps csrc/fused.cu takes (by value); more run the chain


def fused_taps(ksize: int) -> tuple[int, ...]:
    """cv2's Q8 taps of an odd ``ksize`` ≥ 1 at σ = 0, on both axes."""
    if ksize % 2 == 0 or ksize < 1:
        raise ValueError(f"median_unsharp: odd ksize >= 1 expected, got {ksize}")
    return tuple(int(t) for t in gaussian_kernel_fixed(ksize))


def _check(planes: torch.Tensor, median_ksize: int) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"median_unsharp expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"median_unsharp expects [B, H, W] planes, got {tuple(planes.shape)}")
    if median_ksize not in (3, 5):
        raise ValueError(f"median_ksize must be 3 or 5, got {median_ksize}")


def median_unsharp_plain(planes: torch.Tensor, median_ksize: int = 5, amount: float = 1.0,
                         ksize: int = 5) -> torch.Tensor:
    taps = fused_taps(int(ksize))
    return sep_conv_u8_plain(median_blur_plain(planes, int(median_ksize)), taps, taps,
                             float(amount))


def median_unsharp(planes: torch.Tensor, median_ksize: int = 5, amount: float = 1.0,
                   ksize: int = 5) -> torch.Tensor:
    """``unsharp_mask(median_blur(planes, median_ksize), amount, ksize)`` on
    ``[B, H, W]`` u8 planes at σ = 0, exact, any odd ksize: in one pass over
    the planes up to :data:`FUSED_MAX_TAPS` taps, in two past them."""
    median_ksize, ksize = int(median_ksize), int(ksize)
    _check(planes, median_ksize)
    taps = fused_taps(ksize)
    if not on_cuda(planes, "median_unsharp"):
        return median_unsharp_plain(planes, median_ksize, amount, ksize)
    if len(taps) > FUSED_MAX_TAPS:
        return sep_conv_u8(median_blur(planes, median_ksize), taps, taps, float(amount))
    check_kernel_input("median_unsharp", planes)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    alpha, beta = unsharp_weights(float(amount))
    c_taps = np.ascontiguousarray(taps, np.int32)
    launch("median_unsharp", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
           median_ksize, c_taps.ctypes.data, len(taps), alpha, beta)
    return out
