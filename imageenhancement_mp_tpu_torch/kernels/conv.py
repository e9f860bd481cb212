"""Separable u8 Gaussian with optional LUT prologue and unsharp epilogue.

:func:`sep_conv_u8` replaces both TPU conv kernels,
the JAX package's ``kernels/conv2.py::sep_conv5_wide`` (wide shapes,
LUT prologue) and the JAX package's ``kernels/conv.py::_sep_conv_planes``
(any shape), with one CUDA kernel (``csrc/conv.cu``) for every shape and
every odd ksize ≤ 31 per axis.  :func:`sep_conv_u8_plain` is the same
function in plain PyTorch.

The law, pinned to ``ref/ops.py``: cv2's Q8 taps, REFLECT_101 borders
(``numpy.pad(mode="reflect")``, reflecting again when the halo is deeper than
the plane), int32 accumulation, ``blur = (acc + 2^15) >> 16``; the unsharp
epilogue is cv2's two single-rounded f32 FMAs for every ``amount``::

    t = f32(blur · f32(−amount));  out = sat_u8(rint(f32(src · f32(1 + amount) + t)))
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256_plain
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["MAX_TAPS", "reflect101", "sep_conv_u8", "sep_conv_u8_plain", "unsharp_weights"]

MAX_TAPS = 31


def unsharp_weights(amount: float) -> tuple[float, float]:
    """``(alpha, beta) = (f32(1 + amount), f32(−amount))``, each an exact f32
    value held in a Python float (kernels/conv2.py:226's narrowing)."""
    return float(np.float32(1.0 + amount)), float(np.float32(-amount))


def _check_taps(taps: Sequence[int], axis: str) -> tuple[int, ...]:
    t = tuple(int(v) for v in taps)
    if len(t) % 2 == 0 or not 1 <= len(t) <= MAX_TAPS:
        raise ValueError(f"{axis} taps: odd count 1..{MAX_TAPS} expected, got {len(t)}")
    # non-negative Q8 taps summing to at most 256 keep acc < 2^31 and blur ≤ 255
    if min(t) < 0 or sum(t) > 256:
        raise ValueError(f"{axis} taps must be >= 0 with a sum <= 256, got {t}")
    return t


def reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """``numpy.pad(mode="reflect")`` source index of each padded index ``i``
    along an axis of ``n``: period 2(n−1), so a pad deeper than the axis
    reflects again; a 1-pixel axis repeats its only pixel."""
    if n == 1:
        return torch.zeros_like(i)
    m = 2 * (n - 1)
    i = torch.remainder(i, m)
    return torch.where(i >= n, m - i, i)


def sep_conv_u8_plain(planes: torch.Tensor, taps_v: Sequence[int], taps_h: Sequence[int],
                      amount: float | None = None,
                      luts: torch.Tensor | None = None) -> torch.Tensor:
    src = planes if luts is None else apply_lut256_plain(planes, luts)
    B, H, W = src.shape
    rv, rh = len(taps_v) // 2, len(taps_h) // 2
    rows = reflect101(torch.arange(-rv, H + rv, device=src.device), H)
    cols = reflect101(torch.arange(-rh, W + rh, device=src.device), W)
    p = src.to(torch.int32).index_select(1, rows).index_select(2, cols)
    v = sum(int(t) * p[:, j:j + H, :] for j, t in enumerate(taps_v))
    acc = sum(int(t) * v[:, :, j:j + W] for j, t in enumerate(taps_h))
    blur = ((acc + 32768) >> 16).clamp(max=255)
    if amount is None:
        return blur.to(torch.uint8)
    alpha, beta = (torch.tensor(w, dtype=torch.float32, device=src.device)
                   for w in unsharp_weights(amount))
    t = blur.to(torch.float32) * beta
    r = fma32(src.to(torch.float32), alpha, t)
    return torch.round(r).clamp(0, 255).to(torch.uint8)


def sep_conv_u8(planes: torch.Tensor, taps_v: Sequence[int], taps_h: Sequence[int],
                amount: float | None = None,
                luts: torch.Tensor | None = None) -> torch.Tensor:
    """Separable Q8 conv over ``[B, H, W]`` u8 planes → ``[B, H, W]`` u8.

    ``taps_v``/``taps_h``: cv2's Q8 integer taps per axis
    (``utils/taps.py::gaussian_kernel_fixed``), odd count ≤ 31.
    ``amount``: None writes the blur; a float writes the unsharp epilogue
    ``addWeighted(src, 1+amount, blur, −amount)``.  ``luts``: optional
    ``[B, 256]`` u8 per-plane table applied to the pixels before the conv;
    ``src`` in the epilogue is then the mapped pixel.
    """
    if planes.dtype != torch.uint8:
        raise TypeError(f"sep_conv_u8 expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"sep_conv_u8 expects [B, H, W] planes, got {tuple(planes.shape)}")
    tv, th = _check_taps(taps_v, "vertical"), _check_taps(taps_h, "horizontal")
    if luts is not None:
        if luts.dtype != torch.uint8 or luts.shape != (planes.shape[0], 256):
            raise ValueError(f"sep_conv_u8: expected [B, 256] u8 luts, got "
                             f"{luts.dtype} {tuple(luts.shape)}")
        if luts.device != planes.device:
            raise ValueError(f"sep_conv_u8: planes on {planes.device}, luts on {luts.device}")
    if not on_cuda(planes, "sep_conv_u8"):
        return sep_conv_u8_plain(planes, tv, th, amount, luts)
    check_kernel_input("sep_conv_u8", planes, *(() if luts is None else (luts,)))
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    alpha, beta = (1.0, 0.0) if amount is None else unsharp_weights(amount)
    c_tv, c_th = (np.ascontiguousarray(t, np.int32) for t in (tv, th))
    launch("sep_conv_u8", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
           c_tv.ctypes.data, len(tv), c_th.ctypes.data, len(th),
           None if luts is None else luts.data_ptr(),
           0 if amount is None else 1, alpha, beta)
    return out
