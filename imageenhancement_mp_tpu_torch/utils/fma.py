"""Exact single-rounded f32 FMA from plain f32 torch ops.

cv2's integer ``addWeighted`` computes single-rounded f32 FMAs.  A torch
multiply followed by an add rounds twice and flips ties.  ``fma32`` gives
the single rounding exactly: Dekker's two-product and Knuth's two-sum
produce the exact error terms, and adding them back yields the correctly
rounded result.  These are for the plain PyTorch versions; the CUDA kernels
call ``__fmaf_rn`` and ``__fmul_rn`` instead.  Each line is one torch op, so
nothing is contracted into a hardware FMA behind the algorithm's back.
"""

from __future__ import annotations

import torch

__all__ = ["two_prod", "two_sum", "fma32"]


def two_prod(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker two-product: exact ``x·y = p + e`` in f32."""
    p = x * y
    c = 4097.0  # 2^12 + 1: the f32 Veltkamp split constant
    xx = x * c
    xh = xx - (xx - x)
    xl = x - xh
    yy = y * c
    yh = yy - (yy - y)
    yl = y - yh
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, e


def two_sum(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth two-sum: exact ``x + y = s + e`` in f32, any signs."""
    s = x + y
    yp = s - x
    e = (x - (s - yp)) + (y - yp)
    return s, e


def fma32(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Single-rounded f32 FMA ``RN(x·scale + shift)``."""
    p, pe = two_prod(x, scale)
    s, se = two_sum(p, shift)
    return s + (pe + se)
