"""Median filtering: ``cv2.medianBlur``, border = replicate.

The counterpart of the JAX package's ``ops/median.py``.  u8, u16 and
i16 planes with ksize 3 or 5 go through ``kernels/median.py::median_blur``
(the CUDA kernel on a CUDA tensor, its plain network on a CPU one).  f32
planes, and ksize ≥ 7 for every type, take a plain torch sort over the
stacked window taps on either device: the JAX package computes these outside
any Pallas kernel too (ops/median.py:51-59).
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.median import KERNEL_DTYPES, median_blur, window_taps

__all__ = ["median_blur_planes"]


def _sorted_median(planes: torch.Tensor, ksize: int) -> torch.Tensor:
    wide = planes if planes.dtype == torch.float32 else planes.to(torch.int32)
    stacked = torch.stack(window_taps(wide, ksize), dim=-1)
    return torch.sort(stacked, dim=-1).values[..., ksize * ksize // 2].to(planes.dtype)


def median_blur_planes(planes: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """``cv2.medianBlur`` on ``[B, H, W]`` uint8/uint16/int16/float32 planes —
    exact; any odd ksize ≥ 3."""
    ksize = int(ksize)
    if ksize % 2 == 0 or ksize < 3:
        raise ValueError("ksize must be odd and >= 3")
    if planes.dtype not in (*KERNEL_DTYPES, torch.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32 planes, got {planes.dtype}")
    planes = planes.contiguous()
    if planes.dtype in KERNEL_DTYPES and ksize in (3, 5):
        return median_blur(planes, ksize)
    return _sorted_median(planes, ksize)
