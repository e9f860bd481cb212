"""The spatial filters' host tables, as NumPy: cv2's Gaussian taps (the u8 Q8
and u16 Q16 fixed-point ones and the f64 float kernel), cv2's derivative
kernels, and stackBlur's fixed-point descale tables.

A verbatim copy of the tap functions in the JAX package's ``ref/ops.py``
(``_BINOMIAL_FX``, ``_cdf_fixed_taps``, ``gaussian_kernel_fixed``,
``gaussian_taps_u16``, ``_auto_sigma``, ``gaussian_kernel``,
``gaussian_axes``, ``deriv_kernels``, ``gabor_kernel``) and of
``ref/stackblur.py``'s ``_MUL`` and ``_SHR``.  It is copied, not imported, because importing the JAX
package's ``ref`` runs that package's ``__init__`` and so imports JAX.
``tests/test_torch_utils.py`` pins each copy to the original
(``gabor_kernel``: ``tests/test_torch_contours.py``).  Two
options serve ``cv2.getGaussianKernel``/``cv2.getDerivKernels`` as the
oracle's ``get_gaussian_kernel``/``get_deriv_kernels`` compute them:
``gaussian_kernel(per_tap=True)`` and ``deriv_kernels(normalize=...,
max_ksize=31)`` (``tests/test_torch_tracking.py`` pins them).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["gaussian_kernel_fixed", "gaussian_taps_u16", "gaussian_kernel", "gaussian_axes",
           "deriv_kernels", "gabor_kernel", "STACK_MUL", "STACK_SHR"]

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


def gaussian_taps_u16(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2's uint16-path Gaussian taps ·65536 (bit-exact, any σ).

    σ≤0: k ≤ 9 the dyadic /256 tables ·256 (cv2 quirk — its 16U σ=0 k=9
    filter reuses the 8-bit kernel, pinned by probe); k ≥ 11 cumulative-
    quantized at Q16.  σ>0: cumulative-quantized at Q16.
    Apply with int accumulation and a single final ``(h + 2^31) >> 32``.
    """
    if ksize % 2 == 0 or ksize < 1:
        raise ValueError(f"ksize must be odd >= 1, got {ksize}")
    if sigma <= 0:
        if ksize in _BINOMIAL_FX:
            return _BINOMIAL_FX[ksize] * 256
        sigma = _auto_sigma(ksize)
    return _cdf_fixed_taps(ksize, sigma, 65536)


def _auto_sigma(ksize: int) -> float:
    """cv2's σ=0 fallback formula (used for k > 7)."""
    return 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8


def gaussian_kernel(ksize: int, sigma: float, per_tap: bool = False) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` as float64 taps: the
    oracle's vectorised form, or with ``per_tap`` cv2's own arithmetic as
    ``ref/ops.py::get_gaussian_kernel`` pins it (libm ``exp`` of
    ``−0.5/σ²·x²`` per tap, a sequential sum, then a multiplication by its
    reciprocal).  The two differ by an ulp on some taps; the fixed tables
    (σ ≤ 0, k ≤ 9) are the same."""
    if sigma <= 0:
        if ksize in _BINOMIAL_FX:
            return _BINOMIAL_FX[ksize] / 256.0
        sigma = _auto_sigma(ksize)
    if per_tap:
        scale2x = -0.5 / (sigma * sigma)
        k = np.asarray([math.exp(scale2x * (i - (ksize - 1) * 0.5) ** 2)
                        for i in range(ksize)], np.float64)
        s = 0.0
        for v in k:
            s += v
        return k * (1.0 / s)
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


def deriv_kernels(dx: int, dy: int, ksize: int = 3, normalize: bool = False,
                  max_ksize: int = 27):
    """``cv2.getDerivKernels(dx, dy, ksize, normalize)`` — exact.

    Pinned generation rule (verified against cv2 over the full grid in
    tests): each axis kernel of order ``o`` is
    ``[1] ⊛ [1,1]^(ksz−o−1) ⊛ [−1,1]^o`` with ``ksz = 3`` when
    ``ksize == 1`` and ``o > 0`` (no smoothing), else ``ksize``.
    ``ksize = -1`` selects the Scharr pair ([3,10,3] smoothing,
    [−1,0,1] derivative; requires dx+dy == 1).  Returns (kx, ky) int
    row vectors (x = columns axis, like cv2); with ``normalize`` float64
    ones, each Sobel axis scaled by ``1/2^(ksz−order−1)`` and the Scharr
    smoothing by 1/32.  ``max_ksize``: 27 keeps the filters' exact
    integer domain; cv2 itself takes up to 31.
    """
    if ksize == -1:
        if dx + dy != 1 or min(dx, dy) != 0:
            raise ValueError("Scharr (ksize=-1) needs (dx,dy) in {(1,0),(0,1)}")
        d = np.array([-1, 0, 1], np.int64)
        s = np.array([3, 10, 3], np.int64)
        if normalize:
            d, s = d.astype(np.float64), s * (1.0 / 32.0)
        return (d, s) if dx == 1 else (s, d)
    if ksize % 2 == 0 or ksize < 1 or ksize > max_ksize:
        # cv2 allows up to 31 but returns FLOAT kernels whose binomials
        # round in f32 beyond k=27 (C(28,14) > 2^24); the filters keep the
        # exact integer domain
        raise ValueError(f"ksize must be -1 or odd in [1, {max_ksize}], got {ksize}")

    def one(order):
        ksz = 3 if (ksize == 1 and order > 0) else ksize
        if order >= ksz:
            raise ValueError(f"derivative order {order} needs ksize > {order}")
        k = np.array([1], np.int64)
        for _ in range(ksz - order - 1):
            k = np.convolve(k, [1, 1])
        for _ in range(order):
            k = np.convolve(k, [-1, 1])
        return k * (1.0 / (1 << (ksz - order - 1))) if normalize else k

    return one(dx), one(dy)


def gabor_kernel(ksize, sigma: float, theta: float, lambd: float,
                 gamma: float = 1.0, psi: float = np.pi / 2) -> np.ndarray:
    """``cv2.getGaborKernel`` (f64) — the standard Gabor formula;
    ``ksize`` = (rows, cols) row-major."""
    rows, cols = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) \
        else (int(ksize), int(ksize))
    # cv2 bumps even sizes to the enclosing odd kernel (2*(k//2)+1) and
    # writes kernel[ymax−y, xmax−x] — i.e. the grid runs POSITIVE→
    # NEGATIVE (the cosine phase is odd in xr, so the flip matters)
    ymax, xmax = rows // 2, cols // 2
    y, x = np.mgrid[ymax:-ymax - 1:-1, xmax:-xmax - 1:-1]
    xr = x * np.cos(theta) + y * np.sin(theta)
    yr = -x * np.sin(theta) + y * np.cos(theta)
    ex = np.exp(-(xr * xr + gamma * gamma * yr * yr) / (2 * sigma * sigma))
    return (ex * np.cos(2 * np.pi * xr / lambd + psi)).astype(np.float64)


# Klingemann stackblur fixed-point tables (public-domain algorithm
# constants; index = radius)
STACK_MUL = [
    512, 512, 456, 512, 328, 456, 335, 512, 405, 328, 271, 456, 388, 335,
    292, 512, 454, 405, 364, 328, 298, 271, 496, 456, 420, 388, 360, 335,
    312, 292, 273, 512, 482, 454, 428, 405, 383, 364, 345, 328, 312, 298,
    284, 271, 259, 496, 475, 456, 437, 420, 404, 388, 374, 360, 347, 335,
    323, 312, 302, 292, 282, 273, 265, 512,
]
STACK_SHR = [
    9, 11, 12, 13, 13, 14, 14, 15, 15, 15, 15, 16, 16, 16, 16, 17, 17,
    17, 17, 17, 17, 17, 18, 18, 18, 18, 18, 18, 18, 18, 18, 19, 19, 19,
    19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 19, 20, 20, 20, 20, 20, 20,
    20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 20, 21,
]
