"""cv2's Gaussian taps, as NumPy host tables: the u8 fixed-point ones and the
f64 float kernel.

A verbatim copy of the tap functions in the JAX package's ``ref/ops.py``
(``_BINOMIAL_FX``, ``_cdf_fixed_taps``, ``gaussian_kernel_fixed``,
``_auto_sigma``, ``gaussian_kernel``, ``gaussian_axes``).  It is copied, not
imported, because importing the JAX package's ``ref`` runs that package's
``__init__`` and so imports JAX.  ``tests/test_torch_utils.py`` pins each
copy to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_kernel_fixed", "gaussian_kernel", "gaussian_axes"]

_BINOMIAL_FX = {
    1: np.array([256], np.int64),  # k=1 is the identity (probe: any sigma)
    3: np.array([64, 128, 64], np.int64),
    5: np.array([16, 64, 96, 64, 16], np.int64),
    7: np.array([8, 28, 56, 72, 56, 28, 8], np.int64),
    # k=9 is ALSO a dyadic /256 table in cv2 (probe: getGaussianKernel(9,0)
    # returns exactly these /256) — k>=11 switches to the sigma formula
    9: np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], np.int64),
}


def _cdf_fixed_taps(ksize: int, sigma: float, q: int) -> np.ndarray:
    """cv2's bit-exact fixed-point Gaussian tap quantization, reverse-
    engineered (round 2): quantize the kernel's CUMULATIVE sums at scale
    ``q`` and difference — ``tap_i = round(q·cdf_i) − round(q·cdf_{i−1})``
    (guarantees Σtaps = q exactly).  Pinned by per-tap impulse staircase
    probes (80/80 configs) and 1500/1500 full-image fuzz vs cv2 5.0.0
    across k ≤ 31, σ ∈ (0, 8], u8 (q=256) and u16 (q=65536).
    """
    c = (ksize - 1) * 0.5
    i = np.arange(ksize, dtype=np.float64) - c
    v = np.exp(-(i * i) / (2.0 * sigma * sigma))
    v = v / v.sum()
    cdf = np.round(np.cumsum(v) * q)
    return np.diff(np.concatenate([[0.0], cdf])).astype(np.int64)


def gaussian_kernel_fixed(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2's uint8-path Gaussian kernel ·256 (bit-exact, any σ).

    σ≤0, k ∈ {1,3,5,7}: hardcoded binomial taps (SURVEY.md §8.2).
    Otherwise (σ≤0 uses auto-σ): cumulative-quantized taps at Q8
    (``_cdf_fixed_taps``) — cv2's bit-exact fixed-point scheme.
    """
    if ksize % 2 == 0 or ksize < 1:
        raise ValueError(f"ksize must be odd >= 1, got {ksize}")
    if sigma <= 0:
        if ksize in _BINOMIAL_FX:
            return _BINOMIAL_FX[ksize]
        sigma = _auto_sigma(ksize)
    return _cdf_fixed_taps(ksize, sigma, 256)


def _auto_sigma(ksize: int) -> float:
    """cv2's σ=0 fallback formula (used for k > 7)."""
    return 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` as float64 taps."""
    if sigma <= 0:
        if ksize in _BINOMIAL_FX:
            return _BINOMIAL_FX[ksize] / 256.0
        sigma = _auto_sigma(ksize)
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    g = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return g / g.sum()


def gaussian_axes(ksize, sigma: float, sigma_y: float, depth_u8: bool):
    """Resolve cv2's GaussianBlur parameter conventions to per-axis
    ``(kh, kw, sy, sx)``:

    * ``ksize``: int (square) or ``(kh, kw)`` rows-cols; a 0 dimension is
      derived from its sigma like cv2 — ``round(σ·F·2 + 1) | 1`` with
      F = 3 for 8-bit, 4 for deeper (pinned probe);
    * ``sigma_y <= 0`` follows ``sigma`` (cv2's sigmaY=0 convention);
      a ≤0 sigma with a positive ksize means auto-σ from that ksize
      (handled downstream by the tap functions).
    """
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else (int(ksize[0]), int(ksize[1]))
    sx = float(sigma)
    sy = float(sigma_y) if sigma_y > 0 else sx
    factor = 3 if depth_u8 else 4
    if kw <= 0:
        if sx <= 0:
            raise ValueError("ksize width 0 requires sigma > 0 (cv2 semantics)")
        kw = int(round(sx * factor * 2 + 1)) | 1
    if kh <= 0:
        if sy <= 0:
            raise ValueError("ksize height 0 requires sigma(_y) > 0 (cv2 semantics)")
        kh = int(round(sy * factor * 2 + 1)) | 1
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"ksize must be odd, got ({kh}, {kw})")
    return kh, kw, sy, sx
