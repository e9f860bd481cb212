"""The fused main path: histogram equalization followed by unsharp masking."""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.conv import sep_conv_u8
from imageenhancement_mp_tpu_torch.kernels.hist import equalize_lut256, hist256
from imageenhancement_mp_tpu_torch.ops.filters import q8_taps
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["equalize_unsharp"]


def equalize_unsharp(img: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                     sigma: float = 0.0) -> torch.Tensor:
    """hist-eq → unsharp on u8 images ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or
    ``[N,H,W,C]``, per plane; equal to
    ``ref.unsharp_mask(ref.equalize_hist(p), amount, ksize, sigma)``.

    Three launches for every shape: the histogram kernel, the equalize-LUT
    kernel, then ONE conv pass that applies each plane's LUT as it loads the
    pixels, runs the Gaussian and writes the unsharp epilogue — two reads of
    the image and one write.  Any odd ``ksize`` ≤ 31, including 1.
    """
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")
    planes, restore = as_planes(img)
    planes = planes.contiguous()
    tv, th = q8_taps(int(ksize), float(sigma))
    luts = equalize_lut256(hist256(planes), planes.shape[-2] * planes.shape[-1])
    return restore(sep_conv_u8(planes, tv, th, float(amount), luts=luts))
