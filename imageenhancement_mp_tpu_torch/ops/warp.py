"""Warps on planes ``[B, H, W]``: ``cv2.warpAffine``, ``cv2.warpPerspective``,
``cv2.remap``, ``cv2.undistort`` and ``cv2.warpPolar``, the port's
counterpart of the JAX package's ``ops/warp.py`` with its signatures, and
bit-exact to it and to ``ref/`` for every dtype (u8/u16/i16/f32).

* u8 with ``linear`` or ``nearest``, under either border, goes through the
  CUDA kernel of ``kernels/warp.py`` on the card (its plain version on the
  CPU): ``warp_affine`` and ``warp_perspective`` as ``warp_matrix_u8``, which
  computes each pixel's coordinates from the matrix inside the kernel and
  builds no field; ``remap`` and ``warp_polar`` as ``warp_gather_u8`` at
  their f32 maps.
* Every other branch is plain PyTorch on the planes' device, the twin of the
  JAX package's XLA code: u16/f32 linear and nearest (the same gather and
  FMA lerp), the i16 legacy fixed point (float tab weights, sequential f32
  sums), cubic (cv2 5.0's warp-kernel weights with FMA row chains for the
  static warps, the classic weights for ``remap``), lanczos4 (cv2's
  quantized 1/32-cell tabs) and undistort (cv2's quantized maps).

Coordinate fields.  The affine and perspective fields
(``kernels/warp.py::affine_field``, ``perspective_field``; the other dtypes'
route, and the u8 route's plain version) are built on the planes' device
from per-row f32 tables: each linear form ``a·x + b·y + c``
follows cv2 5.0's hybrid law (SIMD body ``fma(a, x, f32(b·y + c))``, scalar
tail ``f32(fma(a, x, f32(b·y)) + c)`` on the last ``ow % 16`` columns), the
FMA written as an exact f64 product and one f64 add cast once to f32, which
is ``ref/``'s own arithmetic; perspective then divides tensor by tensor
(a zero denominator gives 0).  The polar maps need NumPy's f64 cos/sin and
cv2's pinned fastAtan2, so they are built on the host and kept on the device
in a small LRU (see :func:`polar_maps`), the counterpart of JAX's
per-geometry compile.  The fixed-point (i16, lanczos4), cubic and undistort
coordinates come from the host, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.warp import (BORDERS, COORD_LIMIT, affine_field,
                                                        bilinear_fma, gather, perspective_field,
                                                        warp_gather_u8, warp_matrix_u8)
from imageenhancement_mp_tpu_torch.utils.fma import fma32
from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.warp_coords import (
    _lanczos4_remap_tabs, _undistort_maps64, _warp_polar_maps, invert_affine,
    invert_perspective, warp_affine_coords_cubic_f32, warp_affine_coords_int,
    warp_affine_nn_coords_int, warp_perspective_coords_cubic_f32, warp_perspective_coords_int,
    warp_perspective_nn_coords_int, warp_tab_int)

__all__ = ["warp_affine_planes", "warp_affine_rows", "warp_perspective_planes", "remap_planes",
           "undistort_planes", "warp_polar_planes", "affine_field", "perspective_field",
           "polar_maps"]

_DTYPES = (torch.uint8, torch.uint16, torch.int16, torch.float32)
_INTERPOLATIONS = ("nearest", "linear", "cubic", "lanczos4")
_POLAR_CACHE = 8  # geometries whose polar maps stay on their device
# lanczos4 quantizes map coordinates times 32 into int32: clip first
_LANCZOS_LIMIT = 6e7

Sample = Callable[[int, int], torch.Tensor]


# -- coordinate fields ----------------------------------------------------------

@functools.lru_cache(maxsize=_POLAR_CACHE)
def _polar_maps_cached(H: int, W: int, dsize: tuple, center: tuple, max_radius: float,
                       log: bool, inverse: bool, device: torch.device):
    mx, my = _warp_polar_maps((H, W), dsize, center, max_radius, log, inverse)
    return (torch.from_numpy(np.ascontiguousarray(mx)).to(device),
            torch.from_numpy(np.ascontiguousarray(my)).to(device))


def polar_maps(H: int, W: int, dsize, center, max_radius: float, log: bool, inverse: bool,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """cv2.warpPolar's f32 maps (``ref/ops.py::_warp_polar_maps``, host
    NumPy) on ``device``.  The last 8 geometries, keyed by ``(H, W, dsize,
    center, max_radius, log, inverse, device)``, stay on their device (a 4K
    pair is 66 MB), so a repeated call skips the host build and the copy.
    The tensors are shared: do not write to them."""
    return _polar_maps_cached(int(H), int(W), (int(dsize[0]), int(dsize[1])),
                              (float(center[0]), float(center[1])), float(max_radius),
                              bool(log), bool(inverse), torch.device(device))


# -- plain samplers (the JAX package's XLA twins) -------------------------------

def _bilinear_tab_seq(sample: Sample, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """cv2's legacy 16S bilinear: float tab weights from the 1/32 fraction,
    sequential f32 accumulation."""
    w0 = (1 - fx) * (1 - fy)
    w1 = fx * (1 - fy)
    w2 = (1 - fx) * fy
    w3 = fx * fy
    acc = sample(0, 0) * w0 + sample(0, 1) * w1
    acc = acc + sample(1, 0) * w2
    return acc + sample(1, 1) * w3


def _cubic_w(t: torch.Tensor) -> list[torch.Tensor]:
    """cv2's 4-tap bicubic weights (A = −0.75) in cv2's order, w3 closing the
    partition of unity; every constant is exact in f32."""
    A = -0.75
    t1 = t + 1
    w0 = ((A * t1 - 5 * A) * t1 + 8 * A) * t1 - 4 * A
    w1 = (((A + 2) * t - (A + 3)) * t) * t + 1
    u = 1 - t
    w2 = (((A + 2) * u - (A + 3)) * u) * u + 1
    w3 = ((1 - w0) - w1) - w2
    return [w0, w1, w2, w3]


def _cubic_16tap(sample: Sample, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """f32 4×4 separable sum in the oracle's order: rows inner, columns outer."""
    wx, wy = _cubic_w(tx), _cubic_w(ty)
    acc = 0.0
    for a in range(4):
        row = 0.0
        for b in range(4):
            row = row + wx[b] * sample(a - 1, b - 1)
        acc = acc + wy[a] * row
    return acc


def _cubic_keys_w(t: torch.Tensor) -> list[torch.Tensor]:
    """cv2 5.0's warp-kernel cubic weights: factored forms, the single-rounded
    FMA in w1 through ``fma32``."""
    A = -0.75
    const = lambda v: torch.tensor(v, dtype=torch.float32, device=t.device)  # noqa: E731
    u = 1 - t
    tt = t * t
    uu = u * u
    w0 = A * (t * uu)
    w1 = fma32(tt, fma32(t, const(A + 2), const(-(A + 3))), const(1.0))
    w3 = A * (u * tt)
    w2 = ((1 - w0) - w1) - w3
    return [w0, w1, w2, w3]


def _cubic_keys_16tap(sample: Sample, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """cv2 5.0's cubic warp kernel's FMA row chains: ``row = fma(wx_b, v,
    row)`` inner, ``acc = fma(wy_a, row, acc)`` outer."""
    wx, wy = _cubic_keys_w(tx), _cubic_keys_w(ty)
    acc = None
    for a in range(4):
        r = wx[0] * sample(a - 1, -1)
        for b in range(1, 4):
            r = fma32(wx[b], sample(a - 1, b - 1), r)
        acc = wy[a] * r if acc is None else fma32(wy[a], r, acc)
    return acc


def _finish(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 result → the planes' dtype: half-even round and saturate."""
    if dtype == torch.float32:
        return acc
    lo, hi = int_bounds(dtype)
    return torch.round(acc).clamp(lo, hi).to(dtype)


def _sampler(planes: torch.Tensor, iy0: torch.Tensor, ix0: torch.Tensor, border: str,
             bv: float, dtype=torch.float32) -> Sample:
    return lambda dy, dx: gather(planes, iy0 + dy, ix0 + dx, border, bv).to(dtype)


def _sample_field(planes: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, nearest: bool,
                  border: str, bv: float) -> torch.Tensor:
    """Linear or nearest sampling at an f32 field (u8/u16/f32; nearest also
    i16): u8 through ``warp_gather_u8``, the rest its plain law."""
    if planes.dtype == torch.uint8:
        return warp_gather_u8(planes.contiguous(), sx.contiguous(), sy.contiguous(), nearest,
                              border, int(bv))
    X = sx.clamp(-COORD_LIMIT, COORD_LIMIT)
    Y = sy.clamp(-COORD_LIMIT, COORD_LIMIT)
    if nearest:
        return gather(planes, torch.round(Y), torch.round(X), border, bv).to(planes.dtype)
    fx, fy = torch.floor(X), torch.floor(Y)
    acc = bilinear_fma(_sampler(planes, fy.to(torch.int64), fx.to(torch.int64), border, bv),
                       X - fx, Y - fy)
    return _finish(acc, planes.dtype)


def _sample_cubic(planes: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, border: str,
                  bv: float, keys: bool) -> torch.Tensor:
    fx, fy = torch.floor(sx), torch.floor(sy)
    law = _cubic_keys_16tap if keys else _cubic_16tap
    acc = law(_sampler(planes, fy.to(torch.int64), fx.to(torch.int64), border, bv),
              sx - fx, sy - fy)
    return _finish(acc, planes.dtype)


def _sample_tab_bilinear(planes: torch.Tensor, iy0: torch.Tensor, ix0: torch.Tensor,
                         fx: torch.Tensor, fy: torch.Tensor, border: str,
                         bv: float) -> torch.Tensor:
    """i16 (and undistort's non-u8) quantized bilinear: ``fx, fy`` are the
    1/32 fractions as f32."""
    acc = _bilinear_tab_seq(_sampler(planes, iy0, ix0, border, bv), fx, fy)
    return _finish(acc, planes.dtype)


def _sample_lanczos4(planes: torch.Tensor, ix0: torch.Tensor, iy0: torch.Tensor,
                     fx: torch.Tensor, fy: torch.Tensor, border: str,
                     bv: float) -> torch.Tensor:
    """cv2's quantized lanczos4 at integer cells ``ix0, iy0`` and 1/32
    fractions ``fx, fy`` (int64 tensors): u8 through the 2^15 integer tab,
    the other dtypes through f32 factored rows."""
    w1_np, itab_np = _lanczos4_remap_tabs()
    dev = planes.device
    if planes.dtype == torch.uint8:
        itab = torch.from_numpy(itab_np.reshape(32 * 32, 64)).to(dev)
        cell = fy * 32 + fx
        acc = torch.zeros((planes.shape[0], *fx.shape), dtype=torch.int32, device=dev)
        sample = _sampler(planes, iy0, ix0, border, bv, torch.int32)
        for a in range(8):
            for b in range(8):
                acc = acc + sample(a - 3, b - 3) * itab[:, a * 8 + b][cell]
        return ((acc + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)
    w1 = torch.from_numpy(w1_np).to(dev)
    sample = _sampler(planes, iy0, ix0, border, bv)
    acc = torch.zeros((planes.shape[0], *fx.shape), dtype=torch.float32, device=dev)
    for a in range(8):
        row = torch.zeros_like(acc)
        for b in range(8):
            row = row + w1[:, b][fx] * sample(a - 3, b - 3)
        acc = acc + w1[:, a][fy] * row
    return _finish(acc, planes.dtype)


def _host_ints(planes: torch.Tensor, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Host int64 coordinates, clipped to int32's range, on the planes' device."""
    return [torch.from_numpy(np.clip(a, -2**31, 2**31 - 1)).to(planes.device) for a in arrays]


def _lanczos4_static(planes: torch.Tensor, X: np.ndarray, Y: np.ndarray, border: str,
                     bv: float) -> torch.Tensor:
    """Lanczos4 at host fixed-point coordinates ``X, Y`` (scale 2^5)."""
    return _sample_lanczos4(planes, *_host_ints(planes, X >> 5, Y >> 5, X & 31, Y & 31), border,
                            bv)


def _tab_bilinear_static(planes: torch.Tensor, X: np.ndarray, Y: np.ndarray, border: str,
                         bv: float) -> torch.Tensor:
    """i16 bilinear at host fixed-point coordinates ``X, Y`` (scale 2^5)."""
    fx, fy = (torch.from_numpy(((a & 31) / 32.0).astype(np.float32)).to(planes.device)
              for a in (X, Y))
    return _sample_tab_bilinear(planes, *_host_ints(planes, Y >> 5, X >> 5), fx, fy, border, bv)


# -- the ops --------------------------------------------------------------------

def _check(planes: torch.Tensor, interpolation: str, border: str) -> None:
    if planes.dtype not in _DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"expected [B, H, W] planes, got {tuple(planes.shape)}")
    if border not in BORDERS:
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if interpolation not in _INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r} "
                         "(nearest|linear|cubic|lanczos4)")


def _dsize(dsize) -> tuple[int, int]:
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    return oh, ow


def _border_value(dtype: torch.dtype, border_value: float) -> float:
    """cv2 saturates borderValue into an integer dtype before it blends."""
    if dtype == torch.float32:
        return float(border_value)
    lo, hi = int_bounds(dtype)
    return float(np.clip(np.round(float(border_value)), lo, hi))


def warp_affine_planes(planes: torch.Tensor, M, dsize, interpolation: str = "linear",
                       border: str = "constant", border_value: float = 0.0,
                       inverse_map: bool = False) -> torch.Tensor:
    """``cv2.warpAffine`` per plane on ``[B, H, W]``; ``dsize`` is (oh, ow),
    ``M`` a 2×3 matrix (``inverse_map``: M maps destination to source)."""
    _check(planes, interpolation, border)
    oh, ow = _dsize(dsize)
    Mi = (np.asarray(M, np.float64).reshape(2, 3) if inverse_map
          else invert_affine(np.asarray(M, np.float64)))
    return warp_affine_rows(planes, Mi, oh, ow, 0, oh, interpolation, border,
                            _border_value(planes.dtype, border_value))


def warp_affine_rows(planes: torch.Tensor, Mi: np.ndarray, oh: int, ow: int, row0: int,
                     rows: int, interpolation: str, border: str, bv: float) -> torch.Tensor:
    """Output rows ``[row0, row0 + rows)`` of the ``(oh, ow)`` warp of
    ``planes`` by the inverse matrix ``Mi`` (checked arguments, ``bv``
    saturated): the rows of :func:`warp_affine_planes`' result bit for bit.
    u8 linear and nearest pass ``row0`` to the kernel's matrix route; the
    other routes build only those rows of their host tables or torch field
    (each row's coordinates depend on that row alone)."""
    dev = planes.device
    if interpolation == "lanczos4":
        return _lanczos4_static(planes, *warp_affine_coords_int(Mi, rows, ow, row0), border, bv)
    if interpolation == "cubic":
        sx, sy = (torch.from_numpy(m).to(dev)
                  for m in warp_affine_coords_cubic_f32(Mi, rows, ow, row0))
        return _sample_cubic(planes, sx, sy, border, bv, keys=True)
    if planes.dtype == torch.int16:
        if interpolation == "nearest":
            iy, ix = _host_ints(planes, *warp_affine_nn_coords_int(Mi, rows, ow, row0))
            return gather(planes, iy, ix, border, bv)
        return _tab_bilinear_static(planes, *warp_affine_coords_int(Mi, rows, ow, row0), border,
                                    bv)
    if planes.dtype == torch.uint8:
        return warp_matrix_u8(planes.contiguous(), Mi, rows, ow, False,
                              interpolation == "nearest", border, int(bv), row0)
    sx, sy = affine_field(Mi, rows, ow, dev, row0)
    return _sample_field(planes, sx, sy, interpolation == "nearest", border, bv)


def warp_perspective_planes(planes: torch.Tensor, M, dsize, interpolation: str = "linear",
                            border: str = "constant", border_value: float = 0.0,
                            inverse_map: bool = False) -> torch.Tensor:
    """``cv2.warpPerspective`` per plane on ``[B, H, W]``; ``dsize`` is
    (oh, ow), ``M`` a 3×3 homography.  Matrix inversion is cv2's f64
    cofactor expansion."""
    _check(planes, interpolation, border)
    oh, ow = _dsize(dsize)
    Mi = (np.asarray(M, np.float64).reshape(3, 3) if inverse_map else invert_perspective(M))
    bv = _border_value(planes.dtype, border_value)
    dev = planes.device
    if interpolation == "lanczos4":
        return _lanczos4_static(planes, *warp_perspective_coords_int(Mi, oh, ow), border, bv)
    if interpolation == "cubic":
        sx, sy = (torch.from_numpy(m).to(dev)
                  for m in warp_perspective_coords_cubic_f32(Mi, oh, ow))
        return _sample_cubic(planes, sx, sy, border, bv, keys=True)
    if planes.dtype == torch.int16:
        if interpolation == "nearest":
            iy, ix = _host_ints(planes, *warp_perspective_nn_coords_int(Mi, oh, ow))
            return gather(planes, iy, ix, border, bv)
        return _tab_bilinear_static(planes, *warp_perspective_coords_int(Mi, oh, ow), border, bv)
    if planes.dtype == torch.uint8:
        return warp_matrix_u8(planes.contiguous(), Mi, oh, ow, True,
                              interpolation == "nearest", border, int(bv))
    sx, sy = perspective_field(Mi, oh, ow, dev)
    return _sample_field(planes, sx, sy, interpolation == "nearest", border, bv)


def _as_map(m, device) -> torch.Tensor:
    t = m if isinstance(m, torch.Tensor) else torch.from_numpy(np.asarray(m))
    return t.to(device=device, dtype=torch.float32)


def remap_planes(planes: torch.Tensor, map_x, map_y, interpolation: str = "linear",
                 border: str = "constant", border_value: float = 0.0) -> torch.Tensor:
    """``cv2.remap`` per plane on ``[B, H, W]`` with f32 maps ``(oh, ow)``
    (tensors or NumPy arrays, moved to the planes' device), shared by every
    plane."""
    _check(planes, interpolation, border)
    mx, my = _as_map(map_x, planes.device), _as_map(map_y, planes.device)
    if mx.dim() != 2 or mx.shape != my.shape:
        raise ValueError(f"remap expects two (oh, ow) maps, got {tuple(mx.shape)} and "
                         f"{tuple(my.shape)}")
    bv = _border_value(planes.dtype, border_value)
    if interpolation == "nearest" or (interpolation == "linear" and planes.dtype != torch.int16):
        return _sample_field(planes, mx, my, interpolation == "nearest", border, bv)
    mx = mx.clamp(-COORD_LIMIT, COORD_LIMIT)
    my = my.clamp(-COORD_LIMIT, COORD_LIMIT)
    if interpolation == "cubic":
        return _sample_cubic(planes, mx, my, border, bv, keys=False)
    # lanczos4 and i16 linear: cv2's quantized 1/32 coordinates
    X = torch.round(mx.clamp(-_LANCZOS_LIMIT, _LANCZOS_LIMIT) * 32).to(torch.int64)
    Y = torch.round(my.clamp(-_LANCZOS_LIMIT, _LANCZOS_LIMIT) * 32).to(torch.int64)
    if interpolation == "lanczos4":
        return _sample_lanczos4(planes, X >> 5, Y >> 5, X & 31, Y & 31, border, bv)
    return _sample_tab_bilinear(planes, Y >> 5, X >> 5, (X & 31).to(torch.float32) * (1 / 32),
                                (Y & 31).to(torch.float32) * (1 / 32), border, bv)


def undistort_planes(planes: torch.Tensor, K, dist, new_K=None) -> torch.Tensor:
    """``cv2.undistort`` per plane on ``[B, H, W]``: cv2's quantized-map path
    (f64 distortion maps rounded to 1/32 subpixels, constant border 0).  u8
    through the 32×32 integer tab at 2^15, the other dtypes through the
    float tab with sequential f32 sums."""
    _check(planes, "linear", "constant")
    B, H, W = planes.shape
    mx, my = _undistort_maps64(K, dist, (H, W), new_K)
    X = np.round(mx * 32).astype(np.int64)
    Y = np.round(my * 32).astype(np.int64)
    if planes.dtype != torch.uint8:
        return _tab_bilinear_static(planes, X, Y, "constant", 0.0)
    tab = torch.from_numpy(warp_tab_int()[Y & 31, X & 31].astype(np.int32)).to(planes.device)
    sample = _sampler(planes, *_host_ints(planes, Y >> 5, X >> 5), "constant", 0.0, torch.int32)
    acc = None
    for dy in range(2):
        for dx in range(2):
            term = sample(dy, dx) * tab[:, :, dy, dx]
            acc = term if acc is None else acc + term
    return ((acc + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)


def warp_polar_planes(planes: torch.Tensor, dsize, center, max_radius: float,
                      log: bool = False, inverse: bool = False,
                      interpolation: str = "linear") -> torch.Tensor:
    """``cv2.warpPolar`` with ``WARP_FILL_OUTLIERS`` on ``[B, H, W]``:
    ``dsize`` is cv2's (width, height) of the output, ``log`` semilog,
    ``inverse`` polar → cartesian (with cv2's one-row angular wrap pad).  The
    maps come from :func:`polar_maps`; sampling is :func:`remap_planes` with
    a constant border of 0."""
    _check(planes, interpolation, "constant")
    B, H, W = planes.shape
    mx, my = polar_maps(H, W, dsize, center, max_radius, log, inverse, planes.device)
    src = torch.cat([planes[:, H - 1:H], planes, planes[:, 0:1]], dim=1) if inverse else planes
    return remap_planes(src, mx, my, interpolation, "constant", 0.0)
