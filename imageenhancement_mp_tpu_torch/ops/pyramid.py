"""Gaussian pyramids: ``cv2.pyrDown`` / ``cv2.pyrUp`` on ``[B, H, W]``
planes.

The JAX package's ``ops/pyramid.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there).  The law, pinned to ``ref/ops.py``:
REFLECT_101 borders of two pixels, the separable [1, 4, 6, 4, 1] kernel in
exact int32 sums for u8/u16/i16 with ``(acc + 128) >> 8`` (down, then the
even rows and columns: ``ceil(H/2) × ceil(W/2)``) or ``(acc + 32) >> 6``
(up, over the image zero-stuffed to ``2H × 2W``); float32 in the JAX
package's f32 order, vertical pass first, one torch op per multiply and add.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.ops.filters import _f32, _pad

__all__ = ["pyr_down_planes", "pyr_up_planes"]

_K = (1, 4, 6, 4, 1)


def _check(planes: torch.Tensor) -> None:
    if planes.dtype not in (torch.uint8, torch.uint16, torch.int16, torch.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")


def _conv5(x: torch.Tensor) -> torch.Tensor:
    """The separable [1, 4, 6, 4, 1] sum over ``x`` (int32 or f32) with a
    REFLECT_101 border of two pixels."""
    H, W = x.shape[-2], x.shape[-1]
    p = _pad(x, 2, 2, 2, 2)
    if x.dtype == torch.float32:
        v = sum(_f32(k) * p[:, i:i + H, :] for i, k in enumerate(_K))
        return sum(_f32(k) * v[:, :, i:i + W] for i, k in enumerate(_K))
    v = sum(k * p[:, i:i + H, :] for i, k in enumerate(_K))
    return sum(k * v[:, :, i:i + W] for i, k in enumerate(_K))


def pyr_down_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrDown`` per plane → ``[B, ceil(H/2), ceil(W/2)]``."""
    _check(planes)
    if planes.dtype == torch.float32:
        return _conv5(planes)[:, ::2, ::2] * _f32(1.0 / 256.0)
    a = _conv5(planes.to(torch.int32))
    return ((a + 128) >> 8)[:, ::2, ::2].to(planes.dtype)


def pyr_up_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrUp`` per plane → ``[B, 2H, 2W]``."""
    _check(planes)
    B, H, W = planes.shape
    wide = torch.float32 if planes.dtype == torch.float32 else torch.int32
    up = torch.zeros((B, 2 * H, 2 * W), dtype=wide, device=planes.device)
    up[:, ::2, ::2] = planes.to(wide)
    if wide == torch.float32:
        return _conv5(up) * _f32(1.0 / 64.0)
    return ((_conv5(up) + 32) >> 6).to(planes.dtype)
