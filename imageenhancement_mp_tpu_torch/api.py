"""Public functions on torch tensors, with the shapes and keyword names of
``imageenhancement_mp_tpu/api.py``.

Each accepts ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or ``[N,H,W,C]`` images
(u8, and u16/i16 where a function says so) and works per plane (per image ×
channel).  The output lies on the input's device:
a CPU tensor runs the plain PyTorch versions, a CUDA tensor the kernels.
``channels_last=False`` reads a 3-D input as ``[N, H, W]`` even when W ≤ 4.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.ops.clahe import clahe_planes
from imageenhancement_mp_tpu_torch.ops.filters import gaussian_blur_planes, unsharp_mask_planes
from imageenhancement_mp_tpu_torch.ops.histogram import equalize_hist_planes
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.pipeline import equalize_unsharp
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["equalize_hist", "gaussian_blur", "unsharp_mask", "equalize_unsharp", "clahe",
           "median_blur"]


def equalize_hist(img: torch.Tensor, per_frame: bool = True, per_channel: bool = True,
                  channels_last: bool = True) -> torch.Tensor:
    """``cv2.equalizeHist`` on each plane (exact, 8-bit).

    Only ``per_frame=True`` is ported; the pooled (video) mode is ROADMAP
    Queue 1 item 4 and raises.  ``per_channel`` only matters when pooled."""
    if not per_frame:
        raise NotImplementedError(
            "pooled equalize_hist (per_frame=False) is ROADMAP Queue 1 item 4")
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")
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
