"""Geometric resize (``cv2.resize``) and the exact rearrangements
``cv2.flip``, ``cv2.rotate`` and ``cv2.transpose`` on ``[B, H, W]`` planes.

The JAX package's ``ops/resize.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there).  Every index and coefficient table is
built on the host in NumPy from ``utils/resize_tables.py`` (``ref/``'s
tables, copied), once per geometry and device, and gathered with
``index_select``.  The laws, pinned to ``ref/ops.py::resize``:

* nearest: ``min(floor(dx·n/on), n − 1)`` per axis.
* linear u8: cv2's 2^11 fixed point in int32, horizontal at full precision,
  the vertical mul-high ``(x·b) >> 16`` and ``(t + 2) >> 2``.  Other
  dtypes: cv2's f32 lerp per axis, one torch op per multiply and add.
* cubic u8: 2^11 taps on both axes and one ``(v + 2^21) >> 22``, summed
  exactly in int64 as ``ref/`` does (the JAX package's f32 vertical pass
  can be 1 off on razor ties).  Lanczos-4 u8: the JAX package's centred
  int32 sums, which equal ``ref/``'s int64 ones and wrap mod 2^32 where cv2's
  int vertical wraps.  Other dtypes: ``ref/``'s f32 sums in tap order.
* area: integer factors as a sum over each cell (the 2×2 case half up,
  ``(s + 2) >> 2``, else ``cvRound(s·f32(1/(f1·f2)))``); any other
  downscale as two weight matmuls, ``Wy · img · Wx``, in f64 (``ref/`` sums
  each cell in f64; the JAX package's f32 matmuls are its stand-in); an
  upscale axis the linear machinery with INTER_AREA coordinates.

Flip, rotate and transpose return contiguous tensors; uint16 planes flip
through their int16 view (torch has no ``flip`` for uint16 on the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.resize_tables import (cubic_weights, lanczos4_weights,
                                                               resize_cubic_tables,
                                                               resize_lanczos_tables,
                                                               resize_lin_tables)

__all__ = ["resize_planes", "flip_planes", "rotate_planes", "transpose_planes", "INTERPOLATIONS"]

INTERPOLATIONS = ("nearest", "linear", "cubic", "lanczos4", "area")
_RESIZE_SCALE = 1 << 11
F32, F64, I32, I64 = torch.float32, torch.float64, torch.int32, torch.int64


def _fixed_coeffs(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    c2 = np.round(frac.astype(np.float64) * _RESIZE_SCALE).astype(np.int32)
    return _RESIZE_SCALE - c2, c2


def _host_tables(kind: str, n: int, on: int) -> tuple[np.ndarray, ...]:
    """One axis's host tables: indices first, then coefficients."""
    if kind in ("lin", "area_lin"):
        i0, i1, r = resize_lin_tables(n, on, kind == "area_lin")
        c1, c2 = _fixed_coeffs(r)
        one = np.float32(1)
        return i0, i1, c1, c2, (one - r).astype(np.float32), r
    if kind == "nearest":
        return (np.minimum((np.arange(on) * (n / on)).astype(np.int64), n - 1),)
    if kind in ("cubic", "lanczos"):
        idx, r = (resize_cubic_tables if kind == "cubic" else resize_lanczos_tables)(n, on)
        w = cubic_weights if kind == "cubic" else lanczos4_weights
        fixed = np.stack([np.round(np.asarray(w(float(t)), np.float64) * 2048).astype(np.int64)
                          for t in r])
        flt = np.stack([w(float(t)) for t in r]).astype(np.float32)
        return idx.T.copy(), fixed.T.copy(), flt.T.copy()
    if kind == "area":
        return (_area_weights(n, on),)
    raise ValueError(kind)


@functools.lru_cache(maxsize=64)
def _tables(kind: str, n: int, on: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_host_tables`` copied to ``device`` once: a host copy made per call
    would wait for the device's stream."""
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in _host_tables(kind, n, on))


def _area_weights(n: int, on: int) -> np.ndarray:
    """``(on, n)`` f64 area-overlap weights of each output cell."""
    scale = n / on
    w = np.zeros((on, n), np.float64)
    for d in range(on):
        lo, hi = d * scale, min((d + 1) * scale, n)
        cells = np.arange(int(np.floor(lo)), min(int(np.ceil(hi)), n))
        w[d, cells] = np.minimum(cells + 1, hi) - np.maximum(cells, lo)
    return w


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-2, idx)


def _cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-1, idx)


def _linear(planes: torch.Tensor, oh: int, ow: int, area: bool) -> torch.Tensor:
    H, W = planes.shape[-2], planes.shape[-1]
    kind = "area_lin" if area else "lin"
    iy0, iy1, cy1, cy2, ry0, ry1 = _tables(kind, H, oh, planes.device)
    ix0, ix1, cx1, cx2, rx0, rx1 = _tables(kind, W, ow, planes.device)
    if planes.dtype == torch.uint8:
        a = planes.to(I32)
        sh = _cols(a, ix0) * cx1 + _cols(a, ix1) * cx2            # scale 2^11
        x0, x1 = _rows(sh, iy0) >> 4, _rows(sh, iy1) >> 4         # scale 2^7
        t = ((x0 * cy1[:, None]) >> 16) + ((x1 * cy2[:, None]) >> 16)
        return ((t + 2) >> 2).clamp(0, 255).to(torch.uint8)
    a = planes.to(F32)
    h = _cols(a, ix0) * rx0 + _cols(a, ix1) * rx1
    v = _rows(h, iy0) * ry0[:, None] + _rows(h, iy1) * ry1[:, None]
    return _round_cast(v, planes.dtype)


def _round_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """cvRound (half to even) and saturation of an f32 or f64 result."""
    if dtype == F32:
        return v.to(F32)
    minv, maxv = int_bounds(dtype)
    return torch.round(v).clamp(minv, maxv).to(I32).to(dtype)


def _taps(planes: torch.Tensor, oh: int, ow: int, kind: str) -> torch.Tensor:
    """Cubic (4 taps) or Lanczos-4 (8 taps) resize, horizontal pass first."""
    H, W = planes.shape[-2], planes.shape[-1]
    yi, yc, yf = _tables(kind, H, oh, planes.device)
    xi, xc, xf = _tables(kind, W, ow, planes.device)
    n = yi.shape[0]
    if planes.dtype == torch.uint8 and kind == "cubic":
        a = planes.to(I64)
        S = sum(_cols(a, xi[k]) * xc[k] for k in range(n))                 # scale 2^11
        v = sum(_rows(S, yi[k]) * yc[k][:, None] for k in range(n))        # scale 2^22
        return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    if planes.dtype == torch.uint8:
        # centred at 128, |Σc·(v−128)| ≤ 128·Σ|c| per axis keeps the 2^22
        # sums inside int32; the per-column and per-row tap sums restore the
        # mean (the rounded taps need not sum to 2048)
        xc32, yc32 = xc.to(I32), yc.to(I32)
        hsum, vsum = xc32.sum(0), yc32.sum(0)
        a = planes.to(I32) - 128
        S = sum(_cols(a, xi[k]) * xc32[k] for k in range(n)) + 128 * (hsum - 2048)
        v = sum(_rows(S, yi[k]) * yc32[k][:, None] for k in range(n))
        v = v + ((1 << 18) * vsum + (1 << 21))[:, None]
        return (v >> 22).clamp(0, 255).to(torch.uint8)
    a = planes.to(F32)
    S = torch.zeros((*a.shape[:-1], ow), dtype=F32, device=a.device)
    for k in range(n):
        S = S + _cols(a, xi[k]) * xf[k]
    v = torch.zeros((*a.shape[:-2], oh, ow), dtype=F32, device=a.device)
    for k in range(n):
        v = v + yf[k][:, None] * _rows(S, yi[k])
    return _round_cast(v, planes.dtype)


def _area(planes: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    B, H, W = planes.shape
    if H % oh == 0 and W % ow == 0:
        f1, f2 = H // oh, W // ow
        cells = planes.reshape(B, oh, f1, ow, f2)
        if planes.dtype == F32:
            s = cells.to(F64).sum((2, 4)).to(F32)
            return s * torch.tensor(np.float32(1.0 / (f1 * f2)))
        minv, maxv = int_bounds(planes.dtype)
        s = cells.to(I32).sum((2, 4), dtype=I32)
        if (f1, f2) == (2, 2):
            out = (s + 2) >> 2
        else:
            out = torch.round(s.to(F32) * torch.tensor(np.float32(1.0 / (f1 * f2))))
        return out.clamp(minv, maxv).to(I32).to(planes.dtype)
    (wy,), (wx,) = _tables("area", H, oh, planes.device), _tables("area", W, ow, planes.device)
    cell = float(np.float32(1.0 / ((H / oh) * (W / ow))))
    v = torch.matmul(torch.matmul(wy, planes.to(F64)), wx.T) * cell
    return _round_cast(v, planes.dtype)


def resize_planes(planes: torch.Tensor, dsize, interpolation: str = "linear") -> torch.Tensor:
    """``cv2.resize`` per plane on ``[B, H, W]``; ``dsize`` is (oh, ow)."""
    if planes.dtype not in (torch.uint8, torch.uint16, torch.int16, F32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    H, W = planes.shape[-2], planes.shape[-1]
    if interpolation == "nearest":
        (ys,), (xs,) = _tables("nearest", H, oh, planes.device), _tables("nearest", W, ow,
                                                                          planes.device)
        return _cols(_rows(planes, ys), xs)
    if interpolation == "linear":
        return _linear(planes, oh, ow, area=False)
    if interpolation == "cubic":
        return _taps(planes, oh, ow, "cubic")
    if interpolation == "lanczos4":
        return _taps(planes, oh, ow, "lanczos")
    if interpolation == "area":
        if H >= oh and W >= ow:
            return _area(planes, oh, ow)
        return _linear(planes, oh, ow, area=True)
    raise ValueError(f"unknown interpolation {interpolation!r}")


def _flip(planes: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    if planes.dtype == torch.uint16:
        return torch.flip(planes.view(torch.int16), dims).view(torch.uint16).contiguous()
    return torch.flip(planes, dims).contiguous()


def flip_planes(planes: torch.Tensor, code: int = 0) -> torch.Tensor:
    """``cv2.flip`` per plane: 0 rows, > 0 columns, < 0 both — exact."""
    code = int(code)
    return _flip(planes, (-2,) if code == 0 else (-1,) if code > 0 else (-2, -1))


def transpose_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.transpose`` per plane — exact."""
    return planes.transpose(-1, -2).contiguous()


def rotate_planes(planes: torch.Tensor, code: str = "90cw") -> torch.Tensor:
    """``cv2.rotate`` per plane (90cw | 180 | 90ccw) — exact."""
    if code == "90cw":
        return _flip(planes.transpose(-1, -2), (-1,))
    if code == "180":
        return _flip(planes, (-2, -1))
    if code == "90ccw":
        return _flip(planes.transpose(-1, -2), (-2,))
    raise ValueError(f"unknown rotation {code!r} (90cw|180|90ccw)")
