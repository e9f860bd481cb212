"""256-bin histograms and per-plane histogram equalization (u8).

The counterpart of the JAX package's ``ops/histogram.py`` for u8
planes.  Every plane size takes one route: the histogram kernel, the
equalize-LUT kernel, then the LUT-apply kernel (``kernels/hist.py``).
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256, equalize_lut256, hist256

__all__ = ["histogram_256", "equalize_lut", "equalize_hist_planes"]


def _check_u8(planes: torch.Tensor) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {planes.dtype}")


def histogram_256(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane exact histogram: ``[B, H, W]`` u8 → ``[B, 256]`` int32."""
    if planes.dtype == torch.uint16:
        raise NotImplementedError("u16 histograms are ROADMAP Queue 1 item 7")
    return hist256(planes.contiguous())


def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """cv2.equalizeHist LUT from a ``[256]`` or ``[B, 256]`` int32 histogram
    of planes of ``total`` pixels: ``clip(rint(f32(cdf − h0)·f32(255/(N −
    h0))), 0, 255)``, with the identity for a constant plane."""
    if hist.dim() == 1:
        return equalize_lut256(hist[None].contiguous(), total)[0]
    return equalize_lut256(hist.contiguous(), total)


def equalize_hist_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.equalizeHist`` on each plane of ``[B, H, W]`` u8 — exact."""
    _check_u8(planes)
    planes = planes.contiguous()
    luts = equalize_lut256(hist256(planes), planes.shape[-1] * planes.shape[-2])
    return apply_lut256(planes, luts)
