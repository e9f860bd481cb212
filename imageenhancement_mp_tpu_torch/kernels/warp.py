"""Per-pixel gather for the warp family on u8 planes: :func:`warp_gather_u8`
at f32 coordinate maps, and :func:`warp_matrix_u8` at the coordinates of an
affine or perspective matrix, computed inside the kernel.

Both replace the JAX package's ``kernels/warp.py::_run``
(``gather_bilinear_pallas``, ``gather_nearest_pallas``) with one CUDA kernel
family, ``csrc/warp.cu``, for every shape, scale and map.  The TPU kernel windows the
source per output block and rejects footprints over its budget
(``WindowTooLarge``, then XLA takes over); it also leaves the constant border
to an overlay and an XLA fix-up of the partial band.  Here each tap is a load
that reads the border value itself, so there is neither a budget nor a
fix-up.

The law is the JAX XLA path's (its ``ops/warp.py::_gather`` and
``_bilinear_fma_device``), which the TPU kernel equals bitwise: coordinates
clipped to ±2e9; linear lerps rows then columns with single-rounded f32 FMAs
(``top = fma(tx, p01−p00, p00)``, ``bot`` likewise,
``fma(ty, bot−top, top)``), rounds half to even and saturates; nearest reads
the tap at ``rint(sx), rint(sy)``.  A replicate tap clamps its index; a
constant-border tap outside the plane reads ``border_value``.  The TPU kernel
instead zeroes ``tx`` where ``ix0 < 0``: both taps then clamp to one texel,
so the two agree (tests/test_torch_warp.py shows it).

:func:`gather` and :func:`bilinear_fma` are the plain building blocks, shared
with the plain branches of ``ops/warp.py`` for the other dtypes.
:func:`affine_field` and :func:`perspective_field` build cv2 5.0's f32
coordinate fields with torch ops; they are ``warp_matrix_u8``'s plain
coordinate source, and the field of every other dtype in ``ops/warp.py``.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["COORD_LIMIT", "gather", "bilinear_fma", "affine_field", "perspective_field",
           "warp_gather_u8", "warp_gather_u8_plain", "warp_matrix_u8", "warp_matrix_u8_plain"]

# coordinates are clipped to ±COORD_LIMIT before floor and the int casts
# (exact in f32; a pixel that far out samples only the border)
COORD_LIMIT = 2e9
BORDERS = ("constant", "replicate")
# the C entry point's coordinate sources (csrc/warp.cu)
_MAPS, _AFFINE, _PERSPECTIVE = 0, 1, 2


def gather(planes: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, border: str,
           border_value: float) -> torch.Tensor:
    """Taps of ``planes [B, H, W]`` at integer coordinates ``iy, ix`` (one
    shape, shared by every plane) → ``[B, *iy.shape]``: indices clamped into
    the plane and, under the constant border, ``border_value`` where
    ``(iy, ix)`` lies outside it.  u16 planes come back widened to int32
    (torch on the CPU has no u16 ``index_select``)."""
    B, H, W = planes.shape
    src = planes.to(torch.int32) if planes.dtype == torch.uint16 else planes
    iy, ix = iy.to(torch.int64), ix.to(torch.int64)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    v = src.reshape(B, H * W).index_select(1, idx.reshape(-1)).reshape(B, *iy.shape)
    if border == "constant":
        inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        v = torch.where(inside, v, torch.tensor(border_value, dtype=v.dtype, device=v.device))
    return v


def bilinear_fma(sample: Callable[[int, int], torch.Tensor], tx: torch.Tensor,
                 ty: torch.Tensor) -> torch.Tensor:
    """cv2 5.0's float bilinear: rows then columns, one single-rounded f32
    FMA per step.  ``sample(dy, dx)`` returns the f32 tap planes."""
    p00, p01 = sample(0, 0), sample(0, 1)
    p10, p11 = sample(1, 0), sample(1, 1)
    top = fma32(tx, p01 - p00, p00)
    bot = fma32(tx, p11 - p10, p10)
    return fma32(ty, bot - top, top)


# -- coordinate fields ----------------------------------------------------------

def _hybrid_form(a, b, c, oh: int, ow: int, device, row0: int = 0) -> torch.Tensor:
    """One linear form ``a·x + b·y + c`` (f32 coefficients) of cv2 5.0's
    hybrid coordinate field at rows ``y`` in ``[row0, row0 + oh)`` → f32
    ``(oh, ow)`` on ``device`` (``ref/ops.py::warp_affine_coords_f32``'s law
    for one row of M).  The kernel's matrix routes compute the same law per
    pixel."""
    a, b, c = (float(np.float32(v)) for v in (a, b, c))
    nb = ow - ow % 16
    # the per-row f32 table f32(b·y), made on the device (a host table would
    # cost a synchronising copy per call); y = f32(row), as the kernel
    # converts it
    ys = torch.arange(row0, row0 + oh, dtype=torch.float64, device=device).float()
    by = ys * b
    # f64 product of two f32 values is exact; the f64 add and the f32 cast
    # round as ref/ops.py::_fma32 does
    ax = torch.arange(ow, dtype=torch.float64, device=device) * a
    body = (ax[None, :nb] + (by + c).double()[:, None]).float()
    if nb == ow:
        return body
    tail = (ax[None, nb:] + by.double()[:, None]).float() + c
    return torch.cat([body, tail], dim=1)


def affine_field(Mi, oh: int, ow: int, device,
                 row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """cv2 5.0's f32 destination→source field of the inverse affine ``Mi``
    on ``device``, clipped to ±2e9: ``(sx, sy)``, each f32 ``(oh, ow)``,
    equal to ``ref/ops.py::warp_affine_coords_f32`` bit for bit.  ``row0``:
    the output rows ``[row0, row0 + oh)`` of a taller field (a row shard)."""
    Mf = np.asarray(Mi, np.float64).reshape(2, 3).astype(np.float32)
    out = []
    for a, b, c in Mf:
        s = _hybrid_form(a, b, c, oh, ow, device, row0)
        # |a·x + b·y + c| is largest at a corner: below this bound (a few f32
        # roundings included) no coordinate reaches the clip
        if abs(a) * (ow - 1) + abs(b) * (row0 + oh - 1) + abs(c) > 0.9 * COORD_LIMIT:
            s = s.clamp_(-COORD_LIMIT, COORD_LIMIT)
        out.append(s)
    return out[0], out[1]


def perspective_field(Mi, oh: int, ow: int, device,
                      row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 field of the inverse homography ``Mi`` on ``device``, clipped
    to ±2e9 (``ref/ops.py::warp_perspective_coords_f32``): three hybrid
    forms, then one f32 division per axis; a zero denominator gives 0.
    ``row0`` as in :func:`affine_field`."""
    Mf = np.asarray(Mi, np.float64).reshape(3, 3).astype(np.float32)
    nx, ny, den = (_hybrid_form(*Mf[r], oh, ow, device, row0) for r in (0, 1, 2))
    nz = den != 0
    return tuple(torch.where(nz, n / den, 0.0).clamp_(-COORD_LIMIT, COORD_LIMIT)
                 for n in (nx, ny))


def _check_planes(planes: torch.Tensor, border: str, border_value: int) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"warp_gather_u8 expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"warp_gather_u8 expects [B, H, W] planes, got {tuple(planes.shape)}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if not 0 <= border_value <= 255:
        raise ValueError(f"warp_gather_u8: border value {border_value} is not saturated to 0..255")


def _check(planes: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border: str,
           border_value: int) -> None:
    _check_planes(planes, border, border_value)
    if sx.dtype != torch.float32 or sy.dtype != torch.float32 or sx.dim() != 2 \
            or sx.shape != sy.shape:
        raise ValueError(f"warp_gather_u8: expected two f32 (oh, ow) maps, got {sx.dtype} "
                         f"{tuple(sx.shape)} and {sy.dtype} {tuple(sy.shape)}")
    if sx.device != planes.device or sy.device != planes.device:
        raise ValueError(f"warp_gather_u8: planes on {planes.device}, maps on {sx.device}, "
                         f"{sy.device}")


def warp_gather_u8_plain(planes: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                         nearest: bool = False, border: str = "constant",
                         border_value: int = 0) -> torch.Tensor:
    border_value = int(border_value)
    _check(planes, sx, sy, border, border_value)
    X = sx.clamp(-COORD_LIMIT, COORD_LIMIT)
    Y = sy.clamp(-COORD_LIMIT, COORD_LIMIT)
    if nearest:
        return gather(planes, torch.round(Y), torch.round(X), border, border_value)
    fx, fy = torch.floor(X), torch.floor(Y)
    ix0, iy0 = fx.to(torch.int64), fy.to(torch.int64)
    acc = bilinear_fma(
        lambda dy, dx: gather(planes, iy0 + dy, ix0 + dx, border, border_value).to(torch.float32),
        X - fx, Y - fy)
    return torch.round(acc).clamp(0.0, 255.0).to(torch.uint8)


def warp_gather_u8(planes: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                   nearest: bool = False, border: str = "constant",
                   border_value: int = 0) -> torch.Tensor:
    """Sample u8 ``planes [B, H, W]`` at the f32 coordinate field ``sx, sy``
    (``(oh, ow)``, shared by all planes, on the planes' device) → u8
    ``[B, oh, ow]``.

    ``nearest``: nearest instead of bilinear; ``border``: ``"constant"`` (taps
    outside the plane read ``border_value``, already saturated to 0..255) or
    ``"replicate"``.
    """
    nearest, border_value = bool(nearest), int(border_value)
    _check(planes, sx, sy, border, border_value)
    if not on_cuda(planes, "warp_gather_u8"):
        return warp_gather_u8_plain(planes, sx, sy, nearest, border, border_value)
    check_kernel_input("warp_gather_u8", planes, sx, sy)
    B, H, W = planes.shape
    oh, ow = sx.shape
    out = torch.empty((B, oh, ow), dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    launch("warp_gather_u8", planes.device, planes.data_ptr(), sx.data_ptr(), sy.data_ptr(),
           out.data_ptr(), B, H, W, oh, ow, 0, int(nearest), int(border == "replicate"),
           border_value, _MAPS, *([0.0] * 9))
    return out


def warp_matrix_u8_plain(planes: torch.Tensor, Mi, oh: int, ow: int, perspective: bool = False,
                         nearest: bool = False, border: str = "constant",
                         border_value: int = 0, row0: int = 0) -> torch.Tensor:
    field = perspective_field if perspective else affine_field
    return warp_gather_u8_plain(planes, *field(Mi, oh, ow, planes.device, row0), nearest,
                                border, border_value)


def warp_matrix_u8(planes: torch.Tensor, Mi, oh: int, ow: int, perspective: bool = False,
                   nearest: bool = False, border: str = "constant",
                   border_value: int = 0, row0: int = 0) -> torch.Tensor:
    """Sample u8 ``planes [B, H, W]`` at the coordinates of the inverse
    matrix ``Mi`` (2×3 affine, or 3×3 with ``perspective``) → u8
    ``[B, oh, ow]``: :func:`warp_gather_u8` at ``affine_field(Mi, oh, ow)``
    (or ``perspective_field``), with the field computed per pixel inside the
    kernel instead of read from device memory.  ``row0``: output rows
    ``[row0, row0 + oh)`` of the warp (a row shard's block); 0 renders the
    whole output."""
    nearest, border_value, oh, ow, row0 = (bool(nearest), int(border_value), int(oh), int(ow),
                                           int(row0))
    _check_planes(planes, border, border_value)
    if oh < 1 or ow < 1:
        raise ValueError(f"warp_matrix_u8: invalid output size {(oh, ow)}")
    if row0 < 0:
        raise ValueError(f"warp_matrix_u8: negative first row {row0}")
    # the inverse matrix as the kernel takes it: f32, 2×3 or 3×3
    Mf = np.asarray(Mi, np.float64).reshape((3, 3) if perspective else (2, 3)).astype(np.float32)
    if not on_cuda(planes, "warp_gather_u8"):
        return warp_matrix_u8_plain(planes, Mf, oh, ow, perspective, nearest, border, border_value,
                                    row0)
    check_kernel_input("warp_gather_u8", planes)
    B, H, W = planes.shape
    out = torch.empty((B, oh, ow), dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    coeffs = [float(v) for v in Mf.reshape(-1)] + [0.0] * (9 - Mf.size)
    launch("warp_gather_u8", planes.device, planes.data_ptr(), None, None, out.data_ptr(), B, H,
           W, oh, ow, row0, int(nearest), int(border == "replicate"), border_value,
           _PERSPECTIVE if perspective else _AFFINE, *coeffs)
    return out
