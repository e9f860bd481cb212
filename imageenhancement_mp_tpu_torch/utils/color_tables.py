"""cv2's colour-conversion constants and u8 tables, as NumPy host tables.

Verbatim copies of the JAX package's ``ref/ops.py`` definitions of the same
names: the HSV and HLS sector tables and the HSV divisor tables
(``_HSV_SHIFT``, ``_HSV_SECTOR``, ``_hsv_tables``, ``_HLS_SECTOR``), the XYZ
matrices and the Lab white point (``_XYZ_FWD``, ``_XYZ_INV``,
``_LAB_WHITE``), cv2's Lab fixed point (``_LAB_C_FWD``, ``_LAB_C_INV``,
``_trunc_div``, ``_lab_tabs`` with its two pinned cube-root flips at
entries 49 and 628) and cv2's Luv constants and packed u8 tables
(``_LUV_*``, ``_luv_fwd_f64``, ``_luv_u8_tabs``).  They are copied, not
imported, because importing the JAX package's ``ref`` imports JAX.
``tests/test_torch_color.py`` pins each copy to its original.

Each table is built once per process and cached; ``ops/color.py`` moves it
to a device once per device.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HSV_SHIFT", "HSV_SECTOR", "HLS_SECTOR", "XYZ_FWD", "XYZ_INV", "LAB_WHITE",
           "LAB_C_FWD", "LAB_C_INV", "LUV_UN", "LUV_VN", "LUV_UP_RANGE", "LUV_VP_RANGE",
           "hsv_tables", "lab_tabs", "luv_fwd_f64", "luv_u8_tabs"]

# cv2 u8 HSV (probes): forward is 12-bit fixed point — EXACT:
#   sdiv[i] = cvRound((255<<12)/i), hdiv[i] = cvRound((180<<12)/(6i));
#   V = max, diff = V−min, S = (diff·sdiv[V] + 2^11) >> 12,
#   Hraw = g−b | b−r+2·diff | r−g+4·diff by argmax branch (r-first),
#   H = ((Hraw·hdiv[diff] + 2^11) >> 12) (+180 if negative).
# The inverse is cv2's f32 sector chain, whose 32-pixel SIMD body
# TRUNCATES the final ·255 while its scalar tail ROUNDS (probed; the
# build-dependent tail is ±1 — docs/PARITY.md).  We implement the body.
_HSV_SHIFT = 12
_HSV_SECTOR = ((0, 3, 1), (2, 0, 1), (1, 0, 3), (1, 2, 0), (3, 1, 0), (0, 1, 2))


def _hsv_tables():
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.where(i == 0, 0, np.round((255 << _HSV_SHIFT) / i)).astype(np.int64)
        hdiv = np.where(i == 0, 0, np.round((180 << _HSV_SHIFT) / (6.0 * i))).astype(np.int64)
    return sdiv, hdiv


# Inverse HLS: cv2's p1/p2 sector chain in plain f32 (exhaustively
# identical for body AND tail, insensitive to FMA contraction).
_HLS_SECTOR = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))

_XYZ_FWD = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ_INV = np.array([[3.240479, -1.537150, -0.498535],
                     [-0.969256, 1.875992, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_LAB_WHITE = np.array([0.950456, 1.0, 1.088754])

# cv2's RGB<->Lab u8 fixed point (color_lab.cpp semantics), pinned
# EXHAUSTIVELY bit-exact against cv2 5.0 — every one of the 256^3 inputs
# in BOTH directions measures 0 LSB (round-3 probes).  Scales:
# gamma tab at 255*2^3 = 2040, cube-root tab at 2^15 over 3072 entries,
# XYZ coeffs at 2^12 whitepoint-folded, inverse at BASE = 2^14.
_LAB_C_FWD = np.array([[1777, 1541, 778],     # round(M/WP[:,None] * 4096)
                       [871, 2929, 296],
                       [73, 448, 3575]], np.int64)
_LAB_C_INV = np.array([[12615, -6296, -2223],  # round(inv(M)*WP[None,:]*4096)
                       [-3773, 7684, 185],
                       [217, -836, 4715]], np.int64)
_LAB_TABS = None


def _trunc_div(a, b):
    """C-style truncating integer division (negative dividends)."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


def _lab_tabs():
    global _LAB_TABS
    if _LAB_TABS is not None:
        return _LAB_TABS
    BASE = 1 << 14
    # sRGB gamma-expand table at scale 2040 (f64 build matches cv2's
    # softdouble build on every entry — exhaustive sweep)
    i = np.arange(256) / 255.0
    g = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_b = np.round(g * 2040).astype(np.int64)
    # cube-root tab at 2^15; entries 49/628 sit ~1e-4 from a .5 tie and
    # cv2's softdouble cbrt lands on the other side — pinned empirically
    # (the ONLY two of 3072 entries where f64 disagrees; flipping them
    # takes the exhaustive LRGB2Lab sweep from 541 bad pixels to 0)
    x = np.arange(3072) / 2040.0
    f = np.where(x > 0.008856, np.cbrt(x), 7.787 * x + 16.0 / 116.0)
    cbrt_b = np.round(f * (1 << 15)).astype(np.int64)
    cbrt_b[49] -= 1
    cbrt_b[628] += 1
    # inverse: y and f(y) per L (LabToYF_b)
    L = np.arange(256) * 100.0 / 255.0
    lth = 0.008856 * 903.3
    y_t = np.where(L <= lth, L / 903.3, ((L + 16.0) / 116.0) ** 3)
    ify_t = np.where(L <= lth, 7.787 * (L / 903.3) + 16.0 / 116.0,
                     (L + 16.0) / 116.0)
    y_b = np.round(y_t * BASE).astype(np.int64)
    ify_b = np.round(ify_t * BASE).astype(np.int64)
    # a/b offsets at BASE scale (cv2's shift-multiply approximations)
    ab = np.arange(256, dtype=np.int64)
    adiv = ((5 * ab * 53687 + (1 << 7)) >> 13) - 128 * BASE // 500
    bdiv = ((ab * 41943 + (1 << 4)) >> 9) - 128 * BASE // 200 + 1
    # f^-1 tab over ifxz in [-8145, -8145 + 9*BASE/4): linear branch is
    # TRUNCATING i*108/841 (not rounded!), cube is ((i*i)/B)*i/B truncating
    minab = -8145
    iv = np.arange(minab, minab + 9 * BASE // 4, dtype=np.int64)
    thresh = int(np.round(6.0 / 29.0 * BASE))
    lin = _trunc_div(iv * 108, 841) - (BASE * 16 * 108) // (116 * 841)
    cube = _trunc_div(_trunc_div(iv * iv, BASE) * iv, BASE)
    abxz = np.where(iv <= thresh, lin, cube)
    # inverse sRGB gamma table: 4096 entries -> u8
    u = np.arange(4096) / 4096.0
    ig = np.where(u <= 0.0031308, 12.92 * u, 1.055 * u ** (1 / 2.4) - 0.055)
    invg = np.clip(np.round(ig * 255.0), 0, 255).astype(np.int64)
    _LAB_TABS = (gamma_b, cbrt_b, y_b, ify_b, adiv, bdiv, minab, abxz, invg)
    return _LAB_TABS


_LUV_TABS = None
# cv2's D65 whitepoint (color_lab.cpp softfloat constants)
_LUV_XN, _LUV_ZN = 0.950456, 1.088754
_LUV_UN = 4 * _LUV_XN / (_LUV_XN + 15 + 3 * _LUV_ZN)
_LUV_VN = 9 / (_LUV_XN + 15 + 3 * _LUV_ZN)


def _luv_fwd_f64(rgb01):
    """Exact f64 sRGB->Luv (cv2's formulas/whitepoint): L in [0,100],
    u in [-134,220], v in [-140,122]."""
    x = np.asarray(rgb01, np.float64)
    g = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    r_, g_, b_ = g[..., 0], g[..., 1], g[..., 2]
    X = 0.412453 * r_ + 0.357580 * g_ + 0.180423 * b_
    Y = 0.212671 * r_ + 0.715160 * g_ + 0.072169 * b_
    Z = 0.019334 * r_ + 0.119193 * g_ + 0.950227 * b_
    L = np.where(Y > 0.008856, 116 * np.cbrt(Y) - 16, 903.3 * Y)
    d = X + 15 * Y + 3 * Z
    with np.errstate(divide="ignore", invalid="ignore"):
        up = np.where(d > 0, 4 * X / d, 0.0)
        vp = np.where(d > 0, 9 * Y / d, 0.0)
    return np.stack([L, 13 * L * (up - _LUV_UN), 13 * L * (vp - _LUV_VN)], -1)


# in-gamut u'/v' ranges over the sRGB cube (computed from the forward
# grid; clamping here reproduces the saturation cv2's integer inverse
# tables apply to out-of-gamut dark pixels)
_LUV_UP_RANGE = (0.1250000109241298, 0.4507042715242644)
_LUV_VP_RANGE = (0.15789450654274712, 0.5625000491585843)


def _luv_u8_tabs():
    """cv2's packed RGB2Luv_b trilinear machinery, structure pinned by
    constraint recovery (docs/PARITY.md "Luv"):

    * input tab ``cx = round(v*16384/255)`` (linear in v — the 33-cube
      grid lives in sRGB space, gamma is INSIDE the grid values);
    * cell = cx>>9, fraction = cx & 511 (9-bit, NOT the 16-level
      trilinearLUT granularity);
    * staged per-axis interpolation ``((512-f)*a + f*b + r) >> 9``;
    * per-channel post: L truncates (``val >> 6``), u/v round
      (``(val+32) >> 6``).

    Grid = round(packed_f64 * 64) + per-channel calibration offsets
    (+2, -7, +3) pinned against cv2 (the softfloat LUT build's
    per-entry residue remains: +-1 LSB on <=3.5 % / 1.1 % / 1.5 % px).
    Returns (tab, T) with T int32 ``(33, 33, 33, 3)``."""
    global _LUV_TABS
    if _LUV_TABS is not None:
        return _LUV_TABS
    g1 = np.arange(33) / 32.0
    R, G, B = np.meshgrid(g1, g1, g1, indexing="ij")
    luv = _luv_fwd_f64(np.stack([R, G, B], -1))
    TL = np.round(luv[..., 0] * (255.0 / 100.0) * 64) + 2
    Tu = np.round((luv[..., 1] + 134.0) * (255.0 / 354.0) * 64) - 7
    Tv = np.round((luv[..., 2] + 140.0) * (255.0 / 262.0) * 64) + 3
    T = np.stack([TL, Tu, Tv], -1).astype(np.int32)
    tab = np.rint(np.arange(256) * 16384 / 255).astype(np.int32)
    _LUV_TABS = (tab, T)
    return _LUV_TABS


# public names for the port's ops
HSV_SHIFT, HSV_SECTOR, HLS_SECTOR = _HSV_SHIFT, _HSV_SECTOR, _HLS_SECTOR
XYZ_FWD, XYZ_INV, LAB_WHITE = _XYZ_FWD, _XYZ_INV, _LAB_WHITE
LAB_C_FWD, LAB_C_INV = _LAB_C_FWD, _LAB_C_INV
LUV_UN, LUV_VN = _LUV_UN, _LUV_VN
LUV_UP_RANGE, LUV_VP_RANGE = _LUV_UP_RANGE, _LUV_VP_RANGE
hsv_tables, lab_tabs = _hsv_tables, _lab_tabs
luv_fwd_f64, luv_u8_tabs = _luv_fwd_f64, _luv_u8_tabs
