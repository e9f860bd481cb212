"""Custom-kernel correlation: ``cv2.filter2D(img, -1, kernel, delta)`` on
``[B, H, W]`` planes.

The JAX package's ``ops/filter2d.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there), with the same 15×15 bound.  The law,
pinned to ``ref/ops.py::filter2d``: correlation (no flip), anchor
``(kh//2, kw//2)``, REFLECT_101 borders (index tables, reflecting again when
a halo is deeper than the plane), then ``cvRound(acc + δ)`` and saturation.
Four routes:

* integer kernels on integer images whose int32 bound holds: exact int32
  sums, and ``acc + δ`` rounded jointly, half to even (the JAX package's
  carry);
* float kernels on integer images, and integer kernels whose int32 bound
  overflows: real f64 accumulation tap by tap in ``ref/``'s order.  The JAX
  package emulates that f64 with double-float f32 arithmetic only because
  the TPU has none;
* float32 images: the JAX package's f32 sum, tap by tap, then ``+ f32(δ)``.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.ops.filters import _f32, _pad
from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.shapes import host_array

__all__ = ["filter2d_planes"]

_MAX_K = 15  # the JAX package's per-axis kernel bound (its unroll limit)


def filter2d_planes(planes: torch.Tensor, kernel, delta: float = 0.0) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel, delta)`` per plane (module doc)."""
    if planes.dtype not in (torch.uint8, torch.uint16, torch.int16, torch.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    k = host_array(kernel).astype(np.float64)
    if k.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {k.shape}")
    kh, kw = k.shape
    if kh > _MAX_K or kw > _MAX_K:
        raise ValueError(f"kernel {kh}x{kw} exceeds the {_MAX_K}x{_MAX_K} unroll bound")
    H, W = planes.shape[-2], planes.shape[-1]
    taps = [(dy, dx, float(k[dy, dx]))
            for dy in range(kh) for dx in range(kw) if k[dy, dx] != 0.0]
    delta = float(delta)
    if planes.dtype == torch.float32:
        if not taps:  # acc ≡ 0: the output is the delta constant
            return torch.full(planes.shape, float(np.float32(delta)), device=planes.device)
        p = _pad(planes, kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
        acc = sum(_f32(t) * p[:, dy:dy + H, dx:dx + W] for dy, dx, t in taps)
        return acc + _f32(delta)
    minv, maxv = int_bounds(planes.dtype)
    if not taps:
        const = int(np.clip(np.round(delta), minv, maxv))
        return torch.full(planes.shape, const, dtype=torch.int32,
                          device=planes.device).to(planes.dtype)
    integral = all(t == int(t) for _, _, t in taps)
    bound = sum(abs(int(t)) for _, _, t in taps) * max(abs(minv), maxv) if integral else None
    if integral and bound < 2**30:
        p = _pad(planes.to(torch.int32), kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
        acc = sum(int(t) * p[:, dy:dy + H, dx:dx + W] for dy, dx, t in taps)
        # round(acc + δ) jointly, half to even: acc is integral, so the result
        # is acc + floor(δ) + carry, a tie (frac δ = .5) settled by parity
        dint = int(np.floor(delta))
        dfrac = delta - dint
        if abs(dint) >= 2**30:  # |δ| dwarfs |acc| < 2^30: every pixel saturates alike
            return torch.full(planes.shape, minv if dint < 0 else maxv, dtype=torch.int32,
                              device=planes.device).to(planes.dtype)
        out = acc + dint
        if dfrac > 0.5:
            out = out + 1
        elif dfrac == 0.5:
            out = out + (out & 1)
        return out.clamp(minv, maxv).to(planes.dtype)
    p = _pad(planes.to(torch.float64), kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
    acc = torch.zeros(planes.shape, dtype=torch.float64, device=planes.device)
    for dy, dx, t in taps:
        acc = acc + t * p[:, dy:dy + H, dx:dx + W]
    return torch.round(acc + delta).clamp(minv, maxv).to(torch.int32).to(planes.dtype)
