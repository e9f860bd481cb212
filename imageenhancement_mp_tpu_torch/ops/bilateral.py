"""Bilateral filter: ``cv2.bilateralFilter`` on u8, gray planes and joint colour.

The counterpart of the JAX package's ``ops/bilateral.py``:

* :func:`bilateral_offsets` is a verbatim copy (host NumPy): the radius
  ``d//2`` (or ``round(1.5·σ_space)`` for d ≤ 0, at least 1, at most 25),
  the disc ``sqrt(i²+j²) ≤ radius`` in scan order with f32 space weights, and
  the f32 colour table ``exp(i²·(−0.5/σ_c²))``.  σ ≤ 0 raises.
* :func:`bilateral_planes` (gray ``[B, H, W]``) runs ``kernels/bilateral.py``
  for every shape and radius: the JAX package's wide/narrow split
  (``supports_bilateral_wide``) and its per-offset route through an f32 LUT
  have no counterpart here.
* :func:`bilateral_color` (``[..., H, W, 3]``, cv2's joint weights from the
  L1 colour distance) is plain PyTorch on both devices, as the JAX package
  computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.bilateral import MAX_RADIUS as _MAX_RADIUS
from imageenhancement_mp_tpu_torch.kernels.bilateral import bilateral_gray
from imageenhancement_mp_tpu_torch.kernels.conv import reflect101

__all__ = ["bilateral_planes", "bilateral_color", "bilateral_offsets", "bilateral_tables"]


def bilateral_offsets(d: int, sigma_color: float, sigma_space: float, cn: int = 1):
    """Host-side: ((i, j, space_w) disc offsets, f32 color LUT, radius)."""
    if sigma_color <= 0 or sigma_space <= 0:
        raise ValueError(
            "sigma_color and sigma_space must be > 0 (OpenCV 5.0's behavior "
            "for non-positive sigmas is data-dependent and unpinnable)"
        )
    radius = int(round(sigma_space * 1.5)) if d <= 0 else int(d) // 2
    radius = max(radius, 1)
    if radius > _MAX_RADIUS:
        raise ValueError(f"radius {radius} too large (max {_MAX_RADIUS})")
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    color_w = np.exp(np.arange(256 * cn, dtype=np.float64) ** 2 * gc).astype(np.float32)
    offs = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = np.sqrt(i * i + j * j)
            if r > radius:
                continue
            offs.append((i, j, float(np.float32(np.exp(r * r * gs)))))
    return offs, color_w, radius


@functools.lru_cache(maxsize=64)
def bilateral_tables(d: int, sigma_color: float, sigma_space: float, cn: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """``(offsets, lut, radius)`` on ``device``: the disc as ``[n, 3]`` f32
    rows ``(i, j, w0)`` and the ``[256·cn]`` f32 colour table, uploaded once
    per parameter set and shared by every caller (read them, never write)."""
    offs, color_w, r = bilateral_offsets(d, sigma_color, sigma_space, cn)
    offsets = torch.tensor(offs, dtype=torch.float32).reshape(-1, 3)
    return offsets.to(device), torch.from_numpy(color_w).to(device), r


def _check_u8(t: torch.Tensor) -> None:
    if t.dtype != torch.uint8:
        raise TypeError(f"bilateral_filter takes uint8 (like cv2's 8u path), got {t.dtype}")


def bilateral_planes(planes: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 50.0) -> torch.Tensor:
    """``cv2.bilateralFilter`` on grayscale ``[B, H, W]`` uint8 planes."""
    _check_u8(planes)
    offsets, lut, r = bilateral_tables(int(d), float(sigma_color), float(sigma_space), 1,
                                       planes.device)
    return bilateral_gray(planes.contiguous(), offsets, lut, r)


def bilateral_color(img: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                    sigma_space: float = 50.0) -> torch.Tensor:
    """``cv2.bilateralFilter`` on ``[..., H, W, 3]`` uint8 — cv2's JOINT
    color semantics: one weight per pixel from the L1 color distance."""
    _check_u8(img)
    if img.dim() < 3 or img.shape[-1] != 3:
        raise ValueError(f"color bilateral needs C=3 (like cv2), got {tuple(img.shape)}")
    offsets, cw, r = bilateral_tables(int(d), float(sigma_color), float(sigma_space), 3,
                                      img.device)
    H, W = img.shape[-3], img.shape[-2]
    rows = reflect101(torch.arange(-r, H + r, device=img.device), H)
    cols = reflect101(torch.arange(-r, W + r, device=img.device), W)
    p = img.index_select(-3, rows).index_select(-2, cols).to(torch.float32)
    c = p[..., r:r + H, r:r + W, :]
    num = torch.zeros(c.shape, dtype=torch.float32, device=img.device)
    den = torch.zeros(c.shape[:-1], dtype=torch.float32, device=img.device)
    for (i, j), w0 in zip(offsets[:, :2].to(torch.int64).tolist(), offsets[:, 2]):
        v = p[..., r + i:r + i + H, r + j:r + j + W, :]
        diff = (v - c).abs().sum(dim=-1).to(torch.int64)
        w = w0 * cw[diff]
        num = num + v * w[..., None]
        den = den + w
    return torch.round(num / den[..., None]).clamp(0, 255).to(torch.uint8)
