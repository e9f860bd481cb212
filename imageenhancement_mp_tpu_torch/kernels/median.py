"""Exact 3×3 / 5×5 median on u8, u16 or i16 planes, replicate border.

:func:`median_blur` replaces
the JAX package's ``kernels/median.py::median_blur_pallas`` with the
CUDA kernel ``csrc/median.cu::median_kernel<T, K>``, which runs the tiled
schedules that :mod:`~imageenhancement_mp_tpu_torch.kernels.median_networks`
builds, proves and renders.  :func:`median_blur_plain` is the same function
in plain PyTorch and an independent yardstick of it: ``kernels/networks.py``
``median9`` (Paeth's 19-comparator network) and ``median25`` (forgetful
selection) as ``torch.minimum``/``torch.maximum`` networks over the K² window
taps.  torch
has no min/max for u16 on the CPU, so the plain version widens every type to
int32 at entry and narrows at exit; the order of the values is unchanged.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch

__all__ = ["KERNEL_DTYPES", "median_blur", "median_blur_plain", "median9", "median25",
           "window_taps"]

# dtype -> the C entry point's type code
KERNEL_DTYPES = {torch.uint8: 0, torch.uint16: 1, torch.int16: 2}

_PAETH9 = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def _cex(w: list, i: int, j: int) -> None:
    w[i], w[j] = torch.minimum(w[i], w[j]), torch.maximum(w[i], w[j])


def median9(taps: list[torch.Tensor]) -> torch.Tensor:
    """Median of 9 equal-shaped tensors: Paeth's 19-comparator network."""
    w = list(taps)
    for i, j in _PAETH9:
        _cex(w, i, j)
    return w[4]


def median25(taps: list[torch.Tensor]) -> torch.Tensor:
    """Median of 25 equal-shaped tensors: forgetful selection (≤ 14 live)."""
    window = list(taps[:14])
    for k in range(14, 25):
        for i in range(1, len(window)):
            _cex(window, 0, i)   # the minimum to window[0]
        for i in range(2, len(window)):
            _cex(window, i, 1)   # the maximum of the rest to window[1]
        window = window[2:] + [taps[k]]
    _cex(window, 0, 1)
    _cex(window, 1, 2)
    _cex(window, 0, 1)
    return window[1]


def window_taps(planes: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The k² taps of each pixel's k×k window, replicate border: views of
    one edge-padded copy, row-major over the window."""
    B, H, W = planes.shape
    r = k // 2
    rows = torch.arange(-r, H + r, device=planes.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=planes.device).clamp(0, W - 1)
    p = planes.index_select(1, rows).index_select(2, cols)
    return [p[:, dy:dy + H, dx:dx + W] for dy in range(k) for dx in range(k)]


def _check(planes: torch.Tensor, ksize: int) -> None:
    if planes.dtype not in KERNEL_DTYPES:
        raise TypeError(f"median_blur takes uint8/uint16/int16 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"median_blur expects [B, H, W] planes, got {tuple(planes.shape)}")
    if ksize not in (3, 5):
        raise ValueError(f"median_blur's kernel takes ksize 3 or 5, got {ksize}")


def median_blur_plain(planes: torch.Tensor, ksize: int) -> torch.Tensor:
    _check(planes, ksize)
    taps = window_taps(planes.to(torch.int32), ksize)
    med = median9(taps) if ksize == 3 else median25(taps)
    return med.to(planes.dtype)


def median_blur(planes: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv2.medianBlur`` on ``[B, H, W]`` u8/u16/i16 planes, ksize 3 or 5 —
    exact; border = replicate."""
    ksize = int(ksize)
    _check(planes, ksize)
    if not on_cuda(planes, "median_blur"):
        return median_blur_plain(planes, ksize)
    check_kernel_input("median", planes)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel():
        launch("median", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
               KERNEL_DTYPES[planes.dtype], ksize)
    return out
