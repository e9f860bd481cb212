"""Host NumPy for the warp family: matrices, coordinate fields and tables.

Verbatim copies of the JAX package's ``ref/ops.py`` functions of the same
names (cv2 5.0's pinned laws), so the port builds the same coordinates
without importing the JAX package.  tests/test_torch_warp_coords.py holds
each copy to its original.

* Matrices: ``invert_affine``, ``get_rotation_matrix_2d``,
  ``invert_perspective``, ``get_perspective_transform``,
  ``get_affine_transform`` (through ``_hal_lu_solve``).
* f32 coordinate fields: ``warp_affine_coords_f32`` and
  ``warp_perspective_coords_f32`` (linear and nearest),
  ``warp_affine_coords_cubic_f32`` and ``warp_perspective_coords_cubic_f32``.
* Fixed-point coordinates (i16 and lanczos4): ``warp_affine_coords_int``,
  ``warp_affine_nn_coords_int``, ``warp_perspective_coords_int``,
  ``warp_perspective_nn_coords_int``; tables ``warp_tab_int`` and
  ``_lanczos4_remap_tabs``.
* Polar and undistortion maps: ``_warp_polar_maps`` (with ``cart_to_polar``
  and ``_fast_atan2_deg``), ``_undistort_maps64`` and
  ``init_undistort_rectify_map``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["invert_affine", "get_rotation_matrix_2d", "invert_perspective",
           "get_perspective_transform", "get_affine_transform", "warp_tab_int",
           "warp_affine_coords_int", "warp_affine_nn_coords_int", "warp_affine_coords_f32",
           "warp_affine_coords_cubic_f32", "warp_perspective_coords_f32",
           "warp_perspective_coords_int", "warp_perspective_nn_coords_int",
           "warp_perspective_coords_cubic_f32", "init_undistort_rectify_map",
           "cart_to_polar"]

_WARP_AB_BITS = 10          # cv2 AB_BITS (coordinate fixed point, i16 path)
_WARP_INTER_BITS = 5        # cv2 INTER_BITS (32 subpixel positions)
_WARP_REMAP_BITS = 15       # cv2 INTER_REMAP_COEF_BITS (tab scale)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` (f64, exact formula)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    out = np.empty((2, 3))
    out[0, 0] = M[1, 1] * d
    out[0, 1] = -M[0, 1] * d
    out[1, 0] = -M[1, 0] * d
    out[1, 1] = M[0, 0] * d
    out[0, 2] = -out[0, 0] * M[0, 2] - out[0, 1] * M[1, 2]
    out[1, 2] = -out[1, 0] * M[0, 2] - out[1, 1] * M[1, 2]
    return out


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D`` (f64; center is (cx, cy) like cv2)."""
    a = np.deg2rad(angle_deg)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = float(center[0]), float(center[1])
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def _fma32(a, b, c) -> np.ndarray:
    """Single-rounded f32 FMA ``RN_f32(a*b + c)`` (exact: the f64 product
    of two f32 values is exact, the add rounds once in f64, and the final
    f32 cast is the single rounding — ties are >29 bits away)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


_WARP_TAB_CACHE = None


def warp_tab_int() -> np.ndarray:
    """cv2's 32x32 bilinear remap tab at 2^15 (initInterTab2D): weights
    rounded independently, then the sum fixed to exactly 2^15 by
    adjusting the max element (deficit) or min element (excess).
    Memoized — the Python build loop is 1024 iterations."""
    global _WARP_TAB_CACHE
    if _WARP_TAB_CACHE is not None:
        return _WARP_TAB_CACHE
    S = 1 << _WARP_REMAP_BITS
    T = 1 << _WARP_INTER_BITS
    tab = np.zeros((T, T, 2, 2), np.int64)
    for ty in range(T):
        for tx in range(T):
            vy, vx = ty / T, tx / T
            w = np.array([[(1 - vy) * (1 - vx), (1 - vy) * vx],
                          [vy * (1 - vx), vy * vx]])
            iw = np.round(w * S).astype(np.int64)
            diff = int(iw.sum() - S)
            if diff:
                mx = np.unravel_index(w.argmax(), (2, 2))
                mn = np.unravel_index(w.argmin(), (2, 2))
                iw[mx if diff < 0 else mn] -= diff
            tab[ty, tx] = iw
    _WARP_TAB_CACHE = tab
    return tab


def warp_affine_coords_int(Mi: np.ndarray, oh: int, ow: int, row0: int = 0):
    """cv2's fixed-point dst→src coordinate tables for the i16 path:
    ``X = (round(Mi01·y + Mi02)·2^10 + 2^4 + round(Mi00·x·2^10)) >> 5``
    at scale 2^5 (adelta per column, X0 per row).  ``row0``: the tables'
    rows ``[row0, row0 + oh)`` of a taller output (each row's values are its
    own: a row shard's block of the whole tables)."""
    AB = 1 << _WARP_AB_BITS
    RD = 1 << (_WARP_AB_BITS - _WARP_INTER_BITS - 1)
    ys = np.arange(row0, row0 + oh)
    adelta = np.round(Mi[0, 0] * np.arange(ow) * AB).astype(np.int64)
    bdelta = np.round(Mi[1, 0] * np.arange(ow) * AB).astype(np.int64)
    X0 = (np.round((Mi[0, 1] * ys + Mi[0, 2]) * AB).astype(np.int64) + RD)
    Y0 = (np.round((Mi[1, 1] * ys + Mi[1, 2]) * AB).astype(np.int64) + RD)
    X = (X0[:, None] + adelta[None, :]) >> (_WARP_AB_BITS - _WARP_INTER_BITS)
    Y = (Y0[:, None] + bdelta[None, :]) >> (_WARP_AB_BITS - _WARP_INTER_BITS)
    return X, Y


def warp_affine_nn_coords_int(Mi: np.ndarray, oh: int, ow: int, row0: int = 0):
    """cv2's i16 NEAREST coordinate maps: AB fixed point rounded at
    scale 2^10 (shared by the oracle and the device op).  ``row0`` as in
    :func:`warp_affine_coords_int`."""
    AB = 1 << _WARP_AB_BITS
    ys = np.arange(row0, row0 + oh)
    ad = np.round(Mi[0, 0] * np.arange(ow) * AB).astype(np.int64)
    bd = np.round(Mi[1, 0] * np.arange(ow) * AB).astype(np.int64)
    X0 = np.round((Mi[0, 1] * ys + Mi[0, 2]) * AB).astype(np.int64)
    Y0 = np.round((Mi[1, 1] * ys + Mi[1, 2]) * AB).astype(np.int64)
    ix = (X0[:, None] + ad[None, :] + (AB >> 1)) >> _WARP_AB_BITS
    iy = (Y0[:, None] + bd[None, :] + (AB >> 1)) >> _WARP_AB_BITS
    return iy, ix


def warp_affine_coords_f32(Mi: np.ndarray, oh: int, ow: int):
    """cv2 5.0's f32 destination->source coordinate field for the float
    warp path, pinned EXACTLY (ramp-image coordinate extraction, then
    0/2500-per-dtype end-to-end fuzz):

    * SIMD body (columns ``x < ow - ow % 16``):
      ``s = fma(a, x, f32(b·y + c))`` — one FMA onto a per-row constant
      that was itself computed mul-then-add in f32.
    * scalar tail (the last ``ow % 16`` columns):
      ``s = f32(fma(a, x, f32(b·y)) + c)`` — the FMA runs onto the bare
      y-term and the constant is added after.

    Returns ``(sx, sy)`` f32 ``(oh, ow)`` maps."""
    Mi = np.asarray(Mi, np.float64)
    Mf = Mi.astype(np.float32)
    ys = np.arange(oh, dtype=np.float32)[:, None]
    xs = np.arange(ow, dtype=np.float32)[None, :]
    body = (np.arange(ow) < ow - (ow % 16))[None, :]
    out = []
    for r in (0, 1):
        a, b, c = Mf[r]
        crow = (b * ys + c).astype(np.float32)
        sb = _fma32(a, xs, crow)
        st = (_fma32(a, xs, (b * ys).astype(np.float32)) + c).astype(np.float32)
        out.append(np.where(body, sb, st).astype(np.float32))
    return out[0], out[1]


def warp_affine_coords_cubic_f32(Mi: np.ndarray, oh: int, ow: int, row0: int = 0):
    """cv2 5.0's new warp-kernel coordinate field (INTER_CUBIC path) —
    plain f32 row-constant law, NO fma and NO SIMD body/tail split
    (unlike the linear path's hybrid ``warp_affine_coords_f32``):
    ``s = f32(f32(a*x) + f32(f32(b*y) + c))``.  Pinned bitwise through
    the end-to-end cubic kernel (0 mismatches on all interior pixels
    over 30 random warps x 2 border modes).  ``row0`` as in
    :func:`warp_affine_coords_int` (y = f32(row))."""
    f32 = np.float32
    Mf = np.asarray(Mi, np.float64).astype(f32)
    xs = np.arange(ow, dtype=f32)
    ys = np.arange(row0, row0 + oh).astype(f32)
    out = []
    for r in (0, 1):
        a, b, c = Mf[r]
        rc = ((b * ys).astype(f32) + c).astype(f32)
        s = ((a * xs)[None, :].astype(f32) + rc[:, None]).astype(f32)
        out.append(np.clip(s, -2e9, 2e9))
    return out[0], out[1]


def warp_perspective_coords_cubic_f32(Mi: np.ndarray, oh: int, ow: int):
    """cv2 5.0's new warp-kernel perspective coordinates (INTER_CUBIC):
    numerators/denominator via ``fma(m0, x, f32(f32(m1*y) + m2))`` and
    an f32 division.  cv2's own division is a SIMD reciprocal +
    Newton refinement (hardware-dependent, like log32f) — the IEEE f32
    divide here lands within ~3 coordinate ulps, giving the measured
    budgets: u8 +-1 on ~0.01% px, u16/i16 +-1 on ~1.5% px, f32 <=6e-3
    absolute at 655-scale (~1e-5 relative)."""
    f32 = np.float32
    Mf = np.asarray(Mi, np.float64).reshape(3, 3).astype(f32)
    xs = np.arange(ow, dtype=f32)
    ys = np.arange(oh, dtype=f32)
    planes = []
    for r in range(3):
        a, b, c = Mf[r]
        rc = ((b * ys).astype(f32) + c).astype(f32)
        planes.append(_fma32(xs[None, :], a, rc[:, None] * np.ones((1, ow), f32)))
    nx, ny, dd = planes
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = np.nan_to_num((nx / dd).astype(f32))
        sy = np.nan_to_num((ny / dd).astype(f32))
    return np.clip(sx, -2e9, 2e9), np.clip(sy, -2e9, 2e9)


def invert_perspective(M: np.ndarray) -> np.ndarray:
    """cv2's 3x3 inversion as used by ``warpPerspective`` (f64 cofactor
    expansion; singular -> zeros like cv2's ``invert`` failure path)."""
    M = np.asarray(M, np.float64).reshape(3, 3)
    d = (M[0, 0] * (M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1])
         - M[0, 1] * (M[1, 0] * M[2, 2] - M[1, 2] * M[2, 0])
         + M[0, 2] * (M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]))
    d = 1.0 / d if d != 0 else 0.0
    A = np.empty((3, 3))
    A[0, 0] = (M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1]) * d
    A[0, 1] = -(M[0, 1] * M[2, 2] - M[0, 2] * M[2, 1]) * d
    A[0, 2] = (M[0, 1] * M[1, 2] - M[0, 2] * M[1, 1]) * d
    A[1, 0] = -(M[1, 0] * M[2, 2] - M[1, 2] * M[2, 0]) * d
    A[1, 1] = (M[0, 0] * M[2, 2] - M[0, 2] * M[2, 0]) * d
    A[1, 2] = -(M[0, 0] * M[1, 2] - M[0, 2] * M[1, 0]) * d
    A[2, 0] = (M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]) * d
    A[2, 1] = -(M[0, 0] * M[2, 1] - M[0, 1] * M[2, 0]) * d
    A[2, 2] = (M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]) * d
    return A


_HAL_LU_EPS = np.finfo(np.float64).eps * 100  # DBL_EPSILON*100, probed exactly


def _hal_lu_solve(A: np.ndarray, b: np.ndarray, eps: float = _HAL_LU_EPS):
    """OpenCV's ``hal::LU64f`` in its exact scalar arithmetic order:
    partial pivot by |column max|, eliminate with ``alpha = A[j,i] *
    (-1/A[i,i])``, then back-substitution ``(b[i] - sum) / A[i,i]``.
    Returns ``None`` when a pivot's magnitude drops below ``eps`` —
    probed bitwise at ``DBL_EPSILON*100`` (the boundary bisected to
    2.220446e-14 on diagonal systems), cv2's failure path."""
    A = A.copy()
    b = b.copy()
    m = A.shape[0]
    for i in range(m):
        k = i
        for j in range(i + 1, m):
            if abs(A[j, i]) > abs(A[k, i]):
                k = j
        if abs(A[k, i]) < eps:
            return None
        if k != i:
            A[[i, k]] = A[[k, i]]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / A[i, i]
        for j in range(i + 1, m):
            alpha = A[j, i] * d
            for k2 in range(i + 1, m):
                A[j, k2] += alpha * A[i, k2]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k2 in range(i + 1, m):
            s -= A[i, k2] * b[k2]
        b[i] = s / A[i, i]
    return b


def get_perspective_transform(src, dst) -> np.ndarray:
    """``cv2.getPerspectiveTransform`` (4 point pairs -> 3x3).

    BIT-EXACT vs cv2 5.0 on every quad that takes the LU path — i.e.
    all normally-conditioned inputs (0/300 + 1999/2000 deterministic
    fuzz incl. 1e4-scale and negative coords; the single non-LU config
    was a degenerate near-collinear quad).  Pinned model (probe
    2026-08-17):

    * the system-matrix cross products ``-x*u``/``-y*u``/``-x*v``/
      ``-y*v`` are computed in FLOAT32 (``Point2f`` arithmetic rounds
      before the f64 widening) — this is why cv2's own matrix maps
      src->dst with residual ~1e-4 on ~100-scale quads and why no
      f64-product model can match it;
    * the 8x8 solve is a direct f64 ``hal::LU64f`` with pivot
      tolerance ``DBL_EPSILON*100`` (every ``solveMethod`` agrees to
      ~1e-13 — the construction dominates, there is no
      normal-equations/SVD variance on this path);
    * DEGENERATE inputs (LU pivot underflow, or an LU solution whose
      residual ``|Ah-b|_inf`` exceeds ~2^-27 — boundary cases sit
      exactly 1 ulp of the ~1e6 product scale apart, so the last bit
      is unpinnable) fall back to cv2 5.0's homogeneous rescue: the
      unit-Frobenius-norm null vector of the 8x9 DLT system.  We
      return the same structural object via ``numpy.linalg.svd``; on
      rank-deficient systems cv2's Jacobi SVD picks a different basis
      of the (multi-dimensional) null space, so the fallback matches
      in norm and residual, not bitwise."""
    src = np.asarray(src, np.float32).reshape(4, 2)
    dst = np.asarray(dst, np.float32).reshape(4, 2)
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        A[i] = [x, y, 1, 0, 0, 0,
                np.float32(-x * u), np.float32(-y * u)]
        A[i + 4] = [0, 0, 0, x, y, 1,
                    np.float32(-x * v), np.float32(-y * v)]
        b[i], b[i + 4] = u, v
    h = _hal_lu_solve(A, b)
    if h is not None and np.abs(A @ h - b).max() <= 2.0 ** -27:
        return np.append(h, 1.0).reshape(3, 3)
    A9 = np.concatenate([A, -b[:, None]], axis=1)
    v9 = np.linalg.svd(A9)[2][-1]
    return v9.reshape(3, 3)


def get_affine_transform(src, dst) -> np.ndarray:
    """``cv2.getAffineTransform`` (3 point pairs -> 2x3).

    BIT-EXACT vs cv2 5.0 (0/500 deterministic fuzz): a direct f64
    ``hal::LU64f`` solve of the 6x6 system in cv2's exact scalar
    arithmetic order (``_hal_lu_solve``) — this system has no product
    entries, so unlike ``get_perspective_transform`` there is no f32
    rounding anywhere in its construction."""
    src = np.asarray(src, np.float64).reshape(3, 2)
    dst = np.asarray(dst, np.float64).reshape(3, 2)
    A = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        x, y = src[i]
        A[i] = [x, y, 1, 0, 0, 0]
        A[i + 3] = [0, 0, 0, x, y, 1]
        b[i], b[i + 3] = dst[i]
    h = _hal_lu_solve(A, b)
    if h is None:
        return np.zeros((2, 3))
    return h.reshape(2, 3)


def warp_perspective_coords_f32(Mi: np.ndarray, oh: int, ow: int):
    """cv2 5.0's f32 coordinate field for the float ``warpPerspective``
    path, pinned EXACTLY (ramp extraction + 800-config-per-dtype fuzz,
    all 0 LSB): the three linear forms (x-numerator, y-numerator,
    denominator) each use the SAME body/tail hybrid as ``warpAffine``
    (``warp_affine_coords_f32``), then one f32 division per axis; a zero
    denominator maps to coordinate 0 (cv2's guard)."""
    Mi = np.asarray(Mi, np.float64).reshape(3, 3)
    Mf = Mi.astype(np.float32)
    ys = np.arange(oh, dtype=np.float32)[:, None]
    xs = np.arange(ow, dtype=np.float32)[None, :]
    body = (np.arange(ow) < ow - (ow % 16))[None, :]
    chans = []
    for r in (0, 1, 2):
        a, b, c = Mf[r]
        sb = _fma32(a, xs, (b * ys + c).astype(np.float32))
        st = (_fma32(a, xs, (b * ys).astype(np.float32)) + c).astype(np.float32)
        chans.append(np.where(body, sb, st).astype(np.float32))
    nx, ny, den = chans
    with np.errstate(divide="ignore", invalid="ignore"):
        sx = np.where(den != 0, nx / den, np.float32(0)).astype(np.float32)
        sy = np.where(den != 0, ny / den, np.float32(0)).astype(np.float32)
    return sx, sy


def warp_perspective_coords_int(Mi: np.ndarray, oh: int, ow: int):
    """cv2's legacy 16S ``warpPerspective`` coordinates: per-pixel f64
    homography, ``W = 32/w`` (0 if w == 0), clamp, ``cvRound`` into the
    1/32 subpixel grid (0/800 fuzz for the downstream float-tab path)."""
    Mi = np.asarray(Mi, np.float64).reshape(3, 3)
    ys, xs = np.mgrid[0:oh, 0:ow]
    w = Mi[2, 0] * xs + Mi[2, 1] * ys + Mi[2, 2]
    lim = float(1 << 30)
    with np.errstate(divide="ignore", invalid="ignore"):
        Wt = np.where(w != 0, 32.0 / w, 0.0)
    X = np.rint(np.clip((Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2]) * Wt,
                        -lim, lim)).astype(np.int64)
    Y = np.rint(np.clip((Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2]) * Wt,
                        -lim, lim)).astype(np.int64)
    return X, Y


def warp_perspective_nn_coords_int(Mi: np.ndarray, oh: int, ow: int):
    """i16 NEAREST ``warpPerspective``: cvRound of the per-pixel f64
    homography coordinates (0/800 fuzz)."""
    Mi = np.asarray(Mi, np.float64).reshape(3, 3)
    ys, xs = np.mgrid[0:oh, 0:ow]
    w = Mi[2, 0] * xs + Mi[2, 1] * ys + Mi[2, 2]
    lim = float(1 << 30)
    with np.errstate(divide="ignore", invalid="ignore"):
        Wt = np.where(w != 0, 1.0 / w, 0.0)
    iy = np.rint(np.clip((Mi[1, 0] * xs + Mi[1, 1] * ys + Mi[1, 2]) * Wt,
                         -lim, lim)).astype(np.int64)
    ix = np.rint(np.clip((Mi[0, 0] * xs + Mi[0, 1] * ys + Mi[0, 2]) * Wt,
                         -lim, lim)).astype(np.int64)
    return iy, ix


_LANCZOS4_REMAP_TABS = None


def _lanczos4_remap_tabs():
    """cv2's 32-cell lanczos4 remap tabs (initInterTab1D/2D), pinned
    BITWISE by f32 delta-probe extraction (0/256 1-D entries):

    * 1-D: ``interpolateLanczos4(i/32)`` — f64 sin/cos off one phase,
      per-tap f64 ``(cs0*s0 + cs1*c0)/y²`` cast f32, then an f32
      SEQUENTIAL sum whose f32 reciprocal scales every tap; fraction 0
      short-circuits to the tap-3 delta.
    * u8 int tab: ``saturate16(cvRound(wy*wx * 2^15))`` with the cell
      sum corrected to 2^15 on ONE center-2x2 extremum — the corrected
      ENTRY cv2 picks is ambiguous on ~10 % of cells (probe-measured),
      worth ±1 LSB on ~0.3 % of output pixels (the documented budget).
    Returns ``(w1, itab)``: f32 ``(32, 8)`` and int32 ``(32, 32, 8, 8)``.
    """
    global _LANCZOS4_REMAP_TABS
    if _LANCZOS4_REMAP_TABS is not None:
        return _LANCZOS4_REMAP_TABS
    f32, f64 = np.float32, np.float64
    T = 32
    x = (np.arange(T) / f32(T)).astype(f32)
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45],
                   [-1, 0], [s45, s45], [0, -1], [-s45, s45]], f64)
    w1 = np.empty((T, 8), f32)
    xd = x.astype(f64)
    y0 = -(xd + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(8):
            y = -(xd + 3 - i) * np.pi * 0.25
            w1[:, i] = ((cs[i, 0] * s0 + cs[i, 1] * c0) / (y * y)).astype(f32)
    ssum = np.zeros(T, f32)
    for i in range(8):
        ssum = (ssum + w1[:, i]).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        w1 = (w1 * (f32(1.0) / ssum)[:, None]).astype(f32)
    w1[0] = 0
    w1[0, 3] = 1
    w2d = (w1[:, None, :, None] * w1[None, :, None, :]).astype(f32)
    S = 1 << _WARP_REMAP_BITS
    itab = np.clip(np.rint(w2d * f32(S)), -32768, 32767).astype(np.int64)
    for fy in range(T):
        for fx in range(T):
            cell = itab[fy, fx]
            diff = int(cell.sum()) - S
            if diff:
                mk = Mk = (3, 3)
                for k1 in (3, 4):
                    for k2 in (3, 4):
                        if cell[k1, k2] < cell[mk]:
                            mk = (k1, k2)
                        elif cell[k1, k2] > cell[Mk]:
                            Mk = (k1, k2)
                if diff < 0:
                    cell[Mk] -= diff
                else:
                    cell[mk] -= diff
    _LANCZOS4_REMAP_TABS = (w1, itab.astype(np.int32))
    return _LANCZOS4_REMAP_TABS


def init_undistort_rectify_map(K, dist, size, new_K=None):
    """``cv2.initUndistortRectifyMap`` (CV_32FC1 maps) — bit-exact
    (probe: 0 abs diff over random intrinsics): the standard radial
    (k1,k2,k3) + tangential (p1,p2) model evaluated in f64, cast f32.
    ``size`` is (H, W) row-major."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = list(np.asarray(dist, np.float64).ravel()) + [0.0] * 5
    k1, k2, p1, p2, k3 = d[:5]
    H, W = int(size[0]), int(size[1])
    nK = K if new_K is None else np.asarray(new_K, np.float64).reshape(3, 3)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = (u - nK[0, 2]) / nK[0, 0]
    y = (v - nK[1, 2]) / nK[1, 1]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def _undistort_maps64(K, dist, size, new_K=None):
    """The f64 (pre-f32-cast) maps — cv2.undistort quantizes THESE."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = list(np.asarray(dist, np.float64).ravel()) + [0.0] * 5
    k1, k2, p1, p2, k3 = d[:5]
    H, W = int(size[0]), int(size[1])
    nK = K if new_K is None else np.asarray(new_K, np.float64).reshape(3, 3)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = (u - nK[0, 2]) / nK[0, 0]
    y = (v - nK[1, 2]) / nK[1, 1]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def _fast_atan2_deg(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """cv2's ``fastAtan2`` (degrees, f32) — BIT-EXACT vs
    ``cv2.cartToPolar`` (0/262k random values incl. axes/origin, both
    angle units; probes 2026-08-17).  The pinned law: coefficients are
    the f32×f32 products ``f32(p_k)·f32(180/π)`` (NOT the once-rounded
    f64 product), the octant ratio guard is +DBL_EPSILON (an f32 no-op
    except at 0/0), and the odd polynomial is evaluated with
    SINGLE-ROUNDED FMAs; quadrant fixups subtract from exact 90/180/360
    and radians are a final ×f32(π/180)."""
    f32 = np.float32
    deg = f32(180 / np.pi)
    P1 = f32(f32(0.9997878412794807) * deg)
    P3 = f32(f32(-0.3258083974640975) * deg)
    P5 = f32(f32(0.1555786518463281) * deg)
    P7 = f32(f32(-0.04432655554792128) * deg)
    eps = np.float32(2.2204460492503131e-16)  # (float)DBL_EPSILON
    ax, ay = np.abs(x).astype(f32), np.abs(y).astype(f32)
    swap = ax < ay
    num = np.minimum(ax, ay).astype(f32)
    den = np.maximum(ax, ay).astype(f32)
    c = (num / (den + eps).astype(f32)).astype(f32)
    c2 = (c * c).astype(f32)

    def _fma(a, b, cc):
        return (a.astype(np.float64) * b.astype(np.float64)
                + cc.astype(np.float64)).astype(f32)

    a = _fma(_fma(_fma(np.full_like(c2, P7), c2, np.full_like(c2, P5)),
                  c2, np.full_like(c2, P3)), c2, np.full_like(c2, P1))
    a = (a * c).astype(f32)
    a = np.where(swap, (f32(90.0) - a).astype(f32), a)
    a = np.where(x < 0, (f32(180.0) - a).astype(f32), a)
    a = np.where(y < 0, (f32(360.0) - a).astype(f32), a)
    return a


def cart_to_polar(x: np.ndarray, y: np.ndarray, angle_in_degrees: bool = False):
    """``cv2.cartToPolar`` — BIT-EXACT f32 (0/262k fuzz): magnitude is
    ``sqrt(fma(x, x, y·y))`` (the fma argument order matters — x first),
    angle is the pinned fastAtan2 (optionally ×f32(π/180))."""
    f32 = np.float32
    x = np.asarray(x, f32)
    y = np.asarray(y, f32)
    mag = np.sqrt((x.astype(np.float64) * x.astype(np.float64)
                   + ((y * y).astype(f32)).astype(np.float64)).astype(f32)
                  ).astype(f32)
    ang = _fast_atan2_deg(y, x)
    if not angle_in_degrees:
        ang = (ang * f32(np.pi / 180)).astype(f32)
    return mag, ang


def _warp_polar_maps(src_hw, dsize, center, max_radius: float,
                     log: bool, inverse: bool):
    """cv2.warpPolar's coordinate maps (pinned bitwise, probes
    2026-08-17).  Forward: per-column radius table computed in f64,
    STORED f32 (cv2 keeps bufRhos as float), then f64 cos/sin rays +
    center, cast f32.  Inverse: f32 cartToPolar (f32 magnitude sqrt +
    fastAtan2 polynomial in degrees ×π/180), rho/phi descaled in f64,
    +1 on phi for the one-row BORDER_WRAP pad cv2 adds to the polar
    source.  Returns (map_x, map_y) f32 for ``remap``."""
    H, W = src_hw
    dw, dh = int(dsize[0]), int(dsize[1])
    f32 = np.float32
    # cv2's API takes center as Point2f — the coordinates are f32
    cx, cy = float(f32(center[0])), float(f32(center[1]))
    mr = float(max_radius)
    if not inverse:
        rho = np.arange(dw, dtype=np.float64)
        if log:
            buf = np.exp(rho * (np.log(mr) / dw)) - 1.0
        else:
            buf = rho * (mr / dw)
        buf = buf.astype(f32).astype(np.float64)
        phi = np.arange(dh, dtype=np.float64) * (2 * np.pi / dh)
        mapx = (buf[None, :] * np.cos(phi)[:, None] + cx).astype(f32)
        mapy = (buf[None, :] * np.sin(phi)[:, None] + cy).astype(f32)
        return mapx, mapy
    Kangle = 2 * np.pi / H
    Kmag = (np.log(mr) / W) if log else (mr / W)
    xs = (np.arange(dw, dtype=f32) - f32(cx)).astype(f32)
    ys = (np.arange(dh, dtype=f32) - f32(cy)).astype(f32)
    X = np.broadcast_to(xs[None, :], (dh, dw)).astype(f32)
    Y = np.broadcast_to(ys[:, None], (dh, dw)).astype(f32)
    mag, ang = cart_to_polar(X, Y)
    if log:
        # cv2 adds 1.f in f32, then runs its own log32f.  That log is
        # BUILD-DEPENDENT (the IPP and universal-intrinsic paths differ
        # from each other by 1 ulp on ~20 % of inputs — measured); we
        # use the correctly-rounded f32 log, giving ≤1-ulp map
        # coordinates vs either cv2 build (docstring budget).
        lg = np.log((mag + f32(1.0)).astype(f32).astype(np.float64)).astype(f32)
        rho = lg.astype(np.float64) / Kmag
    else:
        rho = mag.astype(np.float64) / Kmag
    mapx = rho.astype(f32)
    # cv2 casts the f64 angle quotient to f32 FIRST, then adds the +1
    # BORDER_WRAP row offset in f32 (pinned: adding before the cast
    # flips 15/1845 interpolation cells on f32 frames)
    mapy = ((ang.astype(np.float64) / Kangle).astype(f32)
            + f32(1.0)).astype(f32)
    return mapx, mapy
