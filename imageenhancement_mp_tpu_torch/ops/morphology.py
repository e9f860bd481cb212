"""Morphology: ``cv2.erode``/``cv2.dilate`` (rect ``ksize`` or a 0/1 mask)
and the ``cv2.morphologyEx`` family, on ``[B, H, W]`` planes.

The JAX package's ``ops/morphology.py`` in plain PyTorch on the input's
device (it reaches no Pallas kernel there).  The laws, pinned to
``ref/ops.py``: exact min/max window filters whose border is the constant
identity of the operation (the dtype's maximum or +inf for erode, its
minimum or −inf for dilate), so edge windows ignore outside pixels; the
anchor at ``(kh//2, kw//2)``, even sizes included; ``iterations = n``
applies the op n times; open = dilateⁿ(erodeⁿ), close = erodeⁿ(dilateⁿ),
gradient = sat(dilate − erode), tophat = sat(src − open), blackhat =
sat(close − src).  Rect windows run rows then columns, a mask one shifted
min/max per set tap.  Integer planes are widened to int32 at entry and
narrowed at exit (torch has no ``minimum`` for uint16 on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.shapes import host_array

__all__ = ["erode_planes", "dilate_planes", "morphology_planes", "MORPH_OPS"]

MORPH_OPS = ("erode", "dilate", "open", "close", "gradient", "tophat", "blackhat")
_DTYPES = (torch.uint8, torch.uint16, torch.int16, torch.float32)


def _ksize2(ksize) -> tuple[int, int]:
    if isinstance(ksize, (tuple, list)):
        kh, kw = int(ksize[0]), int(ksize[1])
    else:
        kh = kw = int(ksize)
    if kh < 1 or kw < 1:
        raise ValueError(f"ksize dims must be >= 1, got {(kh, kw)}")
    return kh, kw


def _check_dtype(planes: torch.Tensor) -> None:
    if planes.dtype not in _DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")


def _identity(dtype: torch.dtype, op: str):
    """The border value that leaves ``op``'s window unchanged."""
    if dtype == torch.float32:
        return float("inf") if op == "min" else float("-inf")
    lo, hi = int_bounds(dtype)
    return hi if op == "min" else lo


def _minmax(x: torch.Tensor, kh: int, kw: int, mask, op: str, dtype: torch.dtype) -> torch.Tensor:
    """One min (``op="min"``) or max filter of the widened planes ``x``:
    over a ``kh × kw`` rect (``mask`` None) or the set taps of ``mask``."""
    H, W = x.shape[-2], x.shape[-1]
    p = torch.nn.functional.pad(x, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
                                value=_identity(dtype, op))
    f = torch.minimum if op == "min" else torch.maximum
    if mask is not None:
        acc = None
        for dy, dx in zip(*np.nonzero(mask)):
            v = p[:, dy:dy + H, dx:dx + W]
            acc = v if acc is None else f(acc, v)
        return x if acc is None else acc
    acc = p[:, 0:H, :]
    for dy in range(1, kh):
        acc = f(acc, p[:, dy:dy + H, :])
    out = acc[:, :, 0:W]
    for dx in range(1, kw):
        out = f(out, acc[:, :, dx:dx + W])
    return out


def _widen(planes: torch.Tensor) -> torch.Tensor:
    return planes if planes.dtype == torch.float32 else planes.to(torch.int32)


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.contiguous() if dtype == torch.float32 else x.to(dtype)


def _filter(x: torch.Tensor, ksize, iterations: int, kernel, op: str,
            dtype: torch.dtype) -> torch.Tensor:
    """``iterations`` min or max filters of the widened planes ``x``."""
    if kernel is not None:
        mask = host_array(kernel) != 0
        kh, kw = mask.shape
    else:
        mask, (kh, kw) = None, _ksize2(ksize)
    for _ in range(max(1, int(iterations))):
        x = _minmax(x, kh, kw, mask, op, dtype)
    return x


def erode_planes(planes: torch.Tensor, ksize=3, iterations: int = 1,
                 kernel=None) -> torch.Tensor:
    """``cv2.erode`` per plane — exact min filter (rect ``ksize``, an int or
    (rows, cols), or an arbitrary 0/1 ``kernel`` mask)."""
    _check_dtype(planes)
    return _narrow(_filter(_widen(planes), ksize, iterations, kernel, "min", planes.dtype),
                   planes.dtype)


def dilate_planes(planes: torch.Tensor, ksize=3, iterations: int = 1,
                  kernel=None) -> torch.Tensor:
    """``cv2.dilate`` per plane — exact max filter (see ``erode_planes``)."""
    _check_dtype(planes)
    return _narrow(_filter(_widen(planes), ksize, iterations, kernel, "max", planes.dtype),
                   planes.dtype)


def morphology_planes(planes: torch.Tensor, op: str = "open", ksize=3, iterations: int = 1,
                      kernel=None) -> torch.Tensor:
    """``cv2.morphologyEx`` per plane — exact compositions (module doc)."""
    if op not in MORPH_OPS:
        raise ValueError(f"op must be one of {MORPH_OPS}, got {op!r}")
    _check_dtype(planes)
    dtype = planes.dtype
    x = _widen(planes)

    def E(v):
        return _filter(v, ksize, iterations, kernel, "min", dtype)

    def D(v):
        return _filter(v, ksize, iterations, kernel, "max", dtype)

    return _narrow(compose(op, x, E, D, dtype), dtype)


def compose(op: str, x: torch.Tensor, E, D, dtype: torch.dtype) -> torch.Tensor:
    """``cv2.morphologyEx``'s ``op`` from the erosion ``E`` and dilation
    ``D`` of widened planes ``x`` (the module doc's laws)."""
    def sat_sub(a, b):
        if dtype == torch.float32:
            return a - b
        return (a - b).clamp(*int_bounds(dtype))

    return {"erode": lambda: E(x), "dilate": lambda: D(x), "open": lambda: D(E(x)),
            "close": lambda: E(D(x)), "gradient": lambda: sat_sub(D(x), E(x)),
            "tophat": lambda: sat_sub(x, D(E(x))), "blackhat": lambda: sat_sub(E(D(x)), x)}[op]()
