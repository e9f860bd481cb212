"""cv2's fastNlMeans weight LUT, as a NumPy host table.

A verbatim copy of the JAX package's ``ref/ops.py::_nlm_weight_lut`` (NORM_L1
and NORM_L2, temporal windows, and the 16-bit path with FPM = INT_MAX).  It
is copied, not imported, because importing the JAX package's ``ref`` imports
JAX.  ``tests/test_torch_nlmeans.py`` pins the copy to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["nlm_weight_lut"]


def _nlm_weight_lut(h: float, t: int, s: int, cn: int = 1, temporal: int = 1,
                    norm: str = "l2", maxval: int = 255):
    """cv2 fastNlMeans weight LUT (cn = pixel channels, SSD summed over
    channels; temporal = frames searched, 1 for the single-image API):
    index = SSD >> bin_shift where 2^bin_shift is the nearest pow-2 >=
    t²; w = round(FPM·exp(−dist/(h²·cn))) with
    FPM = INT_MAX // (temporal·s²·255) — the fixed-point multiplier
    scales with the SEARCH-SET size (temporal·s² candidates), NOT with
    cn (pinned by differential probe 2026-08-17: the /cn and
    plain-INT_MAX variants each leave ~1e-4-relative residue flipping
    rare quotients; this one is 0-LSB over 216 deterministic configs
    cn∈{1,2,3,4} + 108 temporal configs) — and the 0.001·FPM cutoff.
    Only the exp's variance normalisation sees cn."""
    tsq = t * t
    bs = 0
    while (1 << bs) < tsq:
        bs += 1
    mult = (1 << bs) / tsq
    if maxval > 255:
        # 16-bit path: cv2 dispatches int64 accumulators, so the
        # multiplier caps at INT_MAX itself (pinned 0/10 u16-L1 fuzz)
        fpm = np.iinfo(np.int32).max
    else:
        fpm = np.iinfo(np.int32).max // (temporal * (s * s) * 255)
    if norm == "l1":
        # NORM_L1: the template distance is a SAD, squared in the exp
        # (pinned: the h^2*cn^2 and linear-exp variants fail at h>=10)
        amd = int(maxval * cn * tsq / mult + 1)
        i = np.arange(amd + 1)
        dist = i * mult
        w = np.round(fpm * np.exp(-(dist * dist) / (h * h * cn))).astype(np.int64)
    else:
        amd = int(maxval * maxval * cn * tsq / mult + 1)
        i = np.arange(amd + 1)
        w = np.round(fpm * np.exp(-(i * mult) / (h * h * cn))).astype(np.int64)
    w[w < 0.001 * fpm] = 0
    # the LUT is zero beyond the cutoff — keep only the live prefix
    nz = np.nonzero(w)[0]
    cut = int(nz[-1]) + 1 if nz.size else 1
    return w[:cut + 1], bs, amd


nlm_weight_lut = _nlm_weight_lut
