"""``cv2.resize``'s per-axis host tables, as NumPy: the linear (and
INTER_AREA upscale) source indices and fractions, cv2's bicubic weights and
indices, and its Lanczos-4 weights and indices.

A verbatim copy of ``resize_lin_tables``, ``cubic_weights``,
``resize_cubic_tables``, ``lanczos4_weights`` and ``resize_lanczos_tables``
in the JAX package's ``ref/ops.py`` (with the constants they read).  It is
copied, not imported, because importing the JAX package's ``ref`` runs that
package's ``__init__`` and so imports JAX.  ``tests/test_torch_resize.py``
pins each copy to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_lin_tables", "cubic_weights", "resize_cubic_tables", "lanczos4_weights",
           "resize_lanczos_tables"]


def resize_lin_tables(n: int, on: int, area: bool = False):
    """Per-axis linear-resize tables: ``(i0, i1, frac)``.

    Pinned empirically (docs/PARITY.md): cv2 computes the source
    coordinate ``(dx+0.5)*n/on - 0.5`` in double, stores it as FLOAT32,
    splits floor/frac, and clamps only the INDICES at the borders — the
    fractional part keeps its out-of-range value (e.g. -0.3 at the top
    edge), which changes the fixed-point coefficients vs a clamped
    model.  ``area=True`` gives INTER_AREA's upscale coordinates:
    ``sx = floor(dx*scale)``, ``fx = (dx+1) - (sx+1)*on/n`` clamped at
    0 (exact on the probe grids W2->5/7, W3->7, W4->9).
    """
    scale = n / on
    if area:
        # NOTE boundary caveat: when dx*scale sits within ~1 ulp of an
        # integer, cv2's table construction snaps inconsistently (probed
        # 18->66 dx=55 vs 45->50 dx=30: the two cases demand OPPOSITE
        # roundings, and the latter samples outside its own area cell),
        # so ONE row/column may sample the adjacent source line there
        # (~3 % of random size pairs).  docs/PARITY.md.
        i = np.floor(np.arange(on) * scale).astype(np.int64)
        f = (((np.arange(on) + 1) - (i + 1) * (on / n))).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((np.arange(on) + 0.5) * scale - 0.5).astype(np.float32)
        i = np.floor(f.astype(np.float64)).astype(np.int64)
        f = (f - i).astype(np.float32)
    i0 = np.clip(i, 0, n - 1)
    i1 = np.clip(i + 1, 0, n - 1)
    return i0, i1, f


_CUBIC_A = -0.75  # cv2's bicubic sharpness constant


def cubic_weights(t: float) -> np.ndarray:
    """cv2's 4-tap bicubic weights at fraction ``t`` (A = -0.75), in
    cv2's own evaluation order (w3 closes the partition of unity)."""
    A = _CUBIC_A
    w = np.empty(4)
    w[0] = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w[1] = ((A + 2) * t - (A + 3)) * t * t + 1
    w[2] = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w[3] = 1.0 - w[0] - w[1] - w[2]
    return w


def resize_cubic_tables(n: int, on: int):
    """Per-axis bicubic tables ``(idx[on,4], frac[on])`` — center-aligned
    f32 coordinates (same convention as linear), indices clamped
    (border replicate)."""
    f = ((np.arange(on) + 0.5) * (n / on) - 0.5).astype(np.float32)
    i = np.floor(f.astype(np.float64)).astype(np.int64)
    r = (f - i).astype(np.float32)
    idx = np.clip(i[:, None] + np.arange(-1, 3)[None, :], 0, n - 1)
    return idx, r


_L4_S45 = 0.70710678118654752440084436210485
_L4_CS = ((1, 0), (-_L4_S45, -_L4_S45), (0, 1), (_L4_S45, -_L4_S45),
          (-1, 0), (_L4_S45, _L4_S45), (0, -1), (-_L4_S45, _L4_S45))


def lanczos4_weights(t: float) -> np.ndarray:
    """cv2's 8-tap Lanczos-4 weights at fraction ``t`` — the
    angle-addition table form: ``w_i = (cs_i0·sin(y0) + cs_i1·cos(y0))
    / y_i²`` with ``y_i = −(t+3−i)·π/4``, each cast f32, then
    normalized by the f32 running sum (pinned; t below f32 eps snaps to
    the exact center tap)."""
    f32 = np.float32
    if t < np.finfo(np.float32).eps:
        w = np.zeros(8, f32)
        w[3] = 1
        return w
    y0 = -(t + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    co = np.empty(8, f32)
    for i in range(8):
        y = -(t + 3 - i) * np.pi * 0.25
        co[i] = f32((_L4_CS[i][0] * s0 + _L4_CS[i][1] * c0) / (y * y))
    ssum = f32(0.0)
    for i in range(8):
        ssum = f32(ssum + co[i])
    return (co * f32(f32(1.0) / ssum)).astype(f32)


def resize_lanczos_tables(n: int, on: int):
    """Per-axis Lanczos-4 tables ``(idx[on,8], frac[on])`` —
    center-aligned f32 coordinates, indices clamped (replicate)."""
    f = ((np.arange(on) + 0.5) * (n / on) - 0.5).astype(np.float32)
    i = np.floor(f.astype(np.float64)).astype(np.int64)
    r = (f - i).astype(np.float32)
    idx = np.clip(i[:, None] + np.arange(-3, 5)[None, :], 0, n - 1)
    return idx, r
