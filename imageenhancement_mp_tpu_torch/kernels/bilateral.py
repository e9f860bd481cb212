"""Gray bilateral filter on u8 planes: the disc walk of ``cv2.bilateralFilter``.

:func:`bilateral_gray` replaces
the JAX package's ``kernels/bilateral.py::bilateral_gray_pallas`` with
the CUDA kernel family ``csrc/bilateral.cu`` for every shape and every radius ≤ 25;
:func:`bilateral_gray_plain` is the same function in plain PyTorch.

The law, pinned to ``ref/ops.py::bilateral_filter``: for each disc offset
``(i, j, w0)`` in the order of ``ops/bilateral.py::bilateral_offsets``, with
``v`` the pixel at ``(y+i, x+j)`` through REFLECT_101 and ``c`` the centre,
``w = f32(w0·lut[|v−c|])``, ``num = f32(num + f32(v·w))``, ``den = f32(den + w)``;
then ``out = sat_u8(rint(num / den))`` with an IEEE f32 division.

The kernel walks the disc row by row: disc row ``i`` holds ``j = −J_i … J_i``
with ``J_i = isqrt(R² − i²)`` (:func:`disc_rows`), the order of
``bilateral_offsets``.  It reads pixels as the words ``0x4B000000 | v`` (the
f32 ``2²³ + v``) and the colour table from 32 lane copies of 511 entries
(``csrc/bilateral.cu``; ``tests/test_torch_bilateral_disc.py`` models both).
A CUDA tensor takes the whole disc of its radius only, in that order
(:func:`disc_weights` checks it once per offsets tensor); the plain version
takes any offsets list.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, host_derived, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.conv import reflect101

__all__ = ["MAX_RADIUS", "MAX_COMPILED_RADIUS", "bilateral_gray", "bilateral_gray_plain",
           "disc_rows", "disc_weights"]

# the JAX package's radius limit (its ops/bilateral.py), which csrc/bilateral.cu's
# shared memory is sized for (kMaxR)
MAX_RADIUS = 25
# radii 1..5 (d 3..11) have compile-time instances (csrc/bilateral.cu kMaxCompileR)
MAX_COMPILED_RADIUS = 5


def disc_rows(radius: int) -> list[tuple[int, int]]:
    """The disc of ``radius`` as rows ``(i, J_i)``, i = −R … R, each row
    holding ``j = −J_i … J_i``: the kernel's walk (``i² + j² ≤ R²`` is
    ``sqrt(i² + j²) ≤ R`` for integers up to 25)."""
    return [(i, math.isqrt(radius * radius - i * i)) for i in range(-radius, radius + 1)]


def _disc_w0(rows: np.ndarray, radius: int) -> np.ndarray:
    want = [(i, j) for i, J in disc_rows(radius) for j in range(-J, J + 1)]
    if rows.shape != (len(want), 3) or not np.array_equal(rows[:, :2], np.array(want, np.float32)):
        raise ValueError(f"bilateral_gray: the kernel takes the whole radius-{radius} disc of "
                         f"ops/bilateral.py::bilateral_offsets in its order ({len(want)} rows)")
    return np.ascontiguousarray(rows[:, 2], dtype=np.float32)


def disc_weights(offsets: torch.Tensor, radius: int) -> np.ndarray:
    """The f32 w0 column of ``offsets`` on the host, after checking that its
    ``(i, j)`` rows are the whole disc of ``radius`` in the kernel's order;
    raise otherwise.  Made once per offsets tensor."""
    return host_derived(offsets, f"disc {radius}", lambda rows: _disc_w0(rows, radius))


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
                   radius: int, *, _runtime: bool = False) -> torch.Tensor:
    """Gray bilateral over ``[B, H, W]`` u8 planes → ``[B, H, W]`` u8.

    ``offsets``: ``[n, 3]`` f32 rows ``(i, j, w0)``, the disc of
    ``ops/bilateral.py::bilateral_offsets`` in its order, ``|i|, |j| ≤
    radius`` (the kernel takes the whole disc only); ``lut``: the ``[256]``
    f32 colour weights; ``radius`` 1..25.  ``_runtime`` takes the kernel's
    runtime instance at a radius that has a compile-time one (radius ≤ 5),
    for the card checks and A/Bs only.
    """
    radius = int(radius)
    _check(planes, offsets, lut, radius)
    if not on_cuda(planes, "bilateral_gray"):
        return bilateral_gray_plain(planes, offsets, lut, radius)
    check_kernel_input("bilateral", planes, offsets, lut)
    w0 = disc_weights(offsets, radius)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel():
        launch("bilateral", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
               offsets.data_ptr(), offsets.shape[0], lut.data_ptr(), radius, w0.ctypes.data,
               int(bool(_runtime)))
    return out
