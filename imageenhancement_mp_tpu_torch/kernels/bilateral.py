"""Gray bilateral filter on u8 planes: the disc walk of ``cv2.bilateralFilter``.

:func:`bilateral_gray` replaces
the JAX package's ``kernels/bilateral.py::bilateral_gray_pallas`` with
the CUDA kernel ``csrc/bilateral.cu`` for every shape and every radius ≤ 25;
:func:`bilateral_gray_plain` is the same function in plain PyTorch.

The law, pinned to ``ref/ops.py::bilateral_filter``: for each disc offset
``(i, j, w0)`` in the order of ``ops/bilateral.py::bilateral_offsets``, with
``v`` the pixel at ``(y+i, x+j)`` through REFLECT_101 and ``c`` the centre,
``w = f32(w0·lut[|v−c|])``, ``num = f32(num + f32(v·w))``, ``den = f32(den + w)``;
then ``out = sat_u8(rint(num / den))`` with an IEEE f32 division.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.conv import reflect101

__all__ = ["MAX_RADIUS", "bilateral_gray", "bilateral_gray_plain"]

# the JAX package's radius limit (its ops/bilateral.py), which csrc/bilateral.cu's
# shared memory is sized for (kMaxR)
MAX_RADIUS = 25


def _check(planes: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor, radius: int) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"bilateral_gray expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"bilateral_gray expects [B, H, W] planes, got {tuple(planes.shape)}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"bilateral_gray: radius 1..{MAX_RADIUS}, got {radius}")
    n = offsets.shape[0] if offsets.dim() == 2 else 0
    if offsets.dtype != torch.float32 or offsets.shape != (n, 3) \
            or not 1 <= n <= (2 * radius + 1) ** 2:
        raise ValueError(f"bilateral_gray: expected [n, 3] f32 (i, j, w0) offsets of a radius-"
                         f"{radius} disc, got {offsets.dtype} {tuple(offsets.shape)}")
    if lut.dtype != torch.float32 or lut.shape != (256,):
        raise ValueError(f"bilateral_gray: expected a [256] f32 colour LUT, got "
                         f"{lut.dtype} {tuple(lut.shape)}")
    for t in (offsets, lut):
        if t.device != planes.device:
            raise ValueError(f"bilateral_gray: planes on {planes.device}, a table on {t.device}")


def bilateral_gray_plain(planes: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor,
                         radius: int) -> torch.Tensor:
    _check(planes, offsets, lut, radius)
    B, H, W = planes.shape
    r = radius
    rows = reflect101(torch.arange(-r, H + r, device=planes.device), H)
    cols = reflect101(torch.arange(-r, W + r, device=planes.device), W)
    p = planes.index_select(1, rows).index_select(2, cols)
    c = p[:, r:r + H, r:r + W].to(torch.int64)
    num = torch.zeros((B, H, W), dtype=torch.float32, device=planes.device)
    den = torch.zeros_like(num)
    for (i, j), w0 in zip(offsets[:, :2].to(torch.int64).tolist(), offsets[:, 2]):
        v = p[:, r + i:r + i + H, r + j:r + j + W].to(torch.int64)
        # each torch op rounds once, as the kernel's __fmul_rn / __fadd_rn do
        w = w0 * lut[(v - c).abs()]
        num = num + v.to(torch.float32) * w
        den = den + w
    return torch.round(num / den).clamp(0, 255).to(torch.uint8)


def bilateral_gray(planes: torch.Tensor, offsets: torch.Tensor, lut: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Gray bilateral over ``[B, H, W]`` u8 planes → ``[B, H, W]`` u8.

    ``offsets``: ``[n, 3]`` f32 rows ``(i, j, w0)``, the disc of
    ``ops/bilateral.py::bilateral_offsets`` in its order, ``|i|, |j| ≤
    radius``; ``lut``: the ``[256]`` f32 colour weights; ``radius`` 1..25.
    """
    radius = int(radius)
    _check(planes, offsets, lut, radius)
    if not on_cuda(planes, "bilateral_gray"):
        return bilateral_gray_plain(planes, offsets, lut, radius)
    check_kernel_input("bilateral", planes, offsets, lut)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel():
        launch("bilateral", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
               offsets.data_ptr(), offsets.shape[0], lut.data_ptr(), radius)
    return out
