"""Public functions on torch tensors, with the shapes and keyword names of
``imageenhancement_mp_tpu/api.py``.

Each accepts ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or ``[N,H,W,C]`` u8 and works
per plane (per image × channel).  The output lies on the input's device:
a CPU tensor runs the plain PyTorch versions, a CUDA tensor the kernels.
``channels_last=False`` reads a 3-D input as ``[N, H, W]`` even when W ≤ 4.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.ops.filters import gaussian_blur_planes, unsharp_mask_planes
from imageenhancement_mp_tpu_torch.ops.histogram import equalize_hist_planes
from imageenhancement_mp_tpu_torch.pipeline import equalize_unsharp
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["equalize_hist", "gaussian_blur", "unsharp_mask", "equalize_unsharp"]


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
