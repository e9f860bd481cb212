"""Host helpers of the tracking family, copied from the NumPy oracle
``imageenhancement_mp_tpu/ref/ops.py`` (``compare_hist`` :3336,
``_fma32`` :2011, ``get_rect_sub_pix`` :5743, ``corner_sub_pix`` :5829, the
selection chain of ``good_features_to_track`` :5584, ``mean_shift`` :7355,
``cam_shift`` :7397), because the port may not import that package at run
time.  They run on NumPy arrays, as the JAX package runs them on the host:
a histogram comparison, a few corners' tiny iterative solves, a candidate
list and one window's moments are latency work, not throughput work.  The
one change is in ``corner_sub_pix``: its five sequential row-major f64 sums
are ``np.cumsum``'s last element (a sequential accumulation from the first
term, the same additions in the same order) instead of a Python loop.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compare_hist", "get_rect_sub_pix", "corner_sub_pix", "select_features",
           "mean_shift", "cam_shift"]

_HIST_CMP = ("correl", "chisqr", "intersect", "bhattacharyya")


def compare_hist(h1: np.ndarray, h2: np.ndarray, method: str = "correl") -> float:
    """``cv2.compareHist`` — cv2's four formulas in f64: correlation,
    chi-square, intersection, Bhattacharyya."""
    a = np.asarray(h1, np.float64).ravel()
    b = np.asarray(h2, np.float64).ravel()
    if a.shape != b.shape:
        raise ValueError("histograms must share shape")
    if method == "correl":
        da, db = a - a.mean(), b - b.mean()
        den = np.sqrt((da * da).sum() * (db * db).sum())
        return float((da * db).sum() / den) if den else 1.0
    if method == "chisqr":
        m = a > 0
        return float((((a - b) ** 2)[m] / a[m]).sum())
    if method == "intersect":
        return float(np.minimum(a, b).sum())
    if method == "bhattacharyya":
        den = a.sum() * b.sum()
        if den <= 0:
            return 1.0
        bc = np.sqrt(a * b).sum() / np.sqrt(den)
        return float(np.sqrt(max(1.0 - bc, 0.0)))
    raise ValueError(f"unknown method {method!r}; one of {_HIST_CMP}")


def _fma32(a, b, c) -> np.ndarray:
    """Single-rounded f32 FMA ``RN_f32(a*b + c)`` through f64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def get_rect_sub_pix(img: np.ndarray, patch_size, center, patch_type: str = None) -> np.ndarray:
    """``cv2.getRectSubPix`` at one centre on the host (the laws of
    ``ops/subpix.py``), for ``corner_sub_pix``."""
    f32 = np.float32
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"getRectSubPix supports u8/f32, got {img.dtype}")
    w, h = int(patch_size[0]), int(patch_size[1])
    cx, cy = float(center[0]), float(center[1])
    if patch_type is None:
        patch_type = "f32" if img.dtype == np.float32 else "u8"
    if patch_type not in ("u8", "f32"):
        raise ValueError(f"patch_type must be 'u8' or 'f32', got {patch_type!r}")
    if img.dtype == np.float32 and patch_type == "u8":
        raise ValueError("f32 source only extracts f32 patches (as cv2)")
    multi = img.ndim == 3 and img.shape[2] > 1
    x0 = f32(f32(cx) - f32((w - 1) * 0.5))
    y0 = f32(f32(cy) - f32((h - 1) * 0.5))
    ix, iy = int(np.floor(x0)), int(np.floor(y0))
    a, b = f32(x0 - ix), f32(y0 - iy)
    H, W = img.shape[:2]
    xs = np.clip(ix + np.arange(w + 1), 0, W - 1)
    ys = np.clip(iy + np.arange(h + 1), 0, H - 1)
    a11 = f32((f32(1) - a) * (f32(1) - b))
    a12 = f32(a * (f32(1) - b))
    a21 = f32((f32(1) - a) * b)
    a22 = f32(a * b)
    if patch_type == "u8":
        P = img[np.ix_(ys, xs)].astype(np.int64)
        p00 = P[:h, :w]; p01 = P[:h, 1:]; p10 = P[1:, :w]; p11 = P[1:, 1:]  # noqa: E702
        ws = [int(np.rint(np.float64(x) * 65536.0)) for x in (a11, a12, a21, a22)]
        s = p00 * ws[0] + p01 * ws[1] + p10 * ws[2] + p11 * ws[3]
        return np.clip((s + 32768) >> 16, 0, 255).astype(np.uint8)
    P = img[np.ix_(ys, xs)].astype(f32)
    p00 = P[:h, :w]; p01 = P[:h, 1:]; p10 = P[1:, :w]; p11 = P[1:, 1:]  # noqa: E702
    if multi:
        v = (((((p00 * a11).astype(f32) + (p01 * a12).astype(f32)).astype(f32)
               + (p10 * a21).astype(f32)).astype(f32)
              + (p11 * a22).astype(f32)).astype(f32))
    elif img.dtype == np.float32:
        v = _fma32(p11, a22, _fma32(p10, a21, _fma32(p01, a12, (p00 * a11).astype(f32))))
    else:
        v = ((((p00 * a11).astype(f32) + (p01 * a12).astype(f32)).astype(f32)
              + ((p10 * a21).astype(f32) + (p11 * a22).astype(f32)).astype(f32)).astype(f32))
    return v


def corner_sub_pix(img: np.ndarray, corners: np.ndarray, win_size, zero_zone=(-1, -1),
                   max_count: int = 100, epsilon: float = 0.0) -> np.ndarray:
    """``cv2.cornerSubPix`` — the gradient structure-tensor fixpoint per
    corner: a ``(2w+3, 2h+3)`` f32 patch, central differences weighted by
    cv2's f32 Gaussian mask (zero zone zeroed), the 2×2 system summed in
    row-major f64, the solve; stop on ``err ≤ ε²``, the iteration cap
    (clamped to [1, 100]), a degenerate determinant or the corner leaving
    the image; a corner that drifted more than the window resets."""
    f32 = np.float32
    ww, wh = int(win_size[0]), int(win_size[1])
    zw, zh = int(zero_zone[0]), int(zero_zone[1])
    win_w, win_h = 2 * ww + 1, 2 * wh + 1
    max_iters = min(max(int(max_count), 1), 100)
    eps = max(float(epsilon), 0.0) ** 2
    yy = (np.arange(win_h, dtype=np.int32) - wh).astype(f32) / f32(wh)
    xx = (np.arange(win_w, dtype=np.int32) - ww).astype(f32) / f32(ww)
    vy = np.exp(-(yy * yy).astype(f32).astype(np.float64)).astype(f32)
    vx = np.exp(-(xx * xx).astype(f32).astype(np.float64)).astype(f32)
    mask = (vy[:, None] * vx[None, :]).astype(f32)
    if zw >= 0 and zh >= 0 and zw * 2 + 1 < win_w and zh * 2 + 1 < win_h:
        mask[wh - zh:wh + zh + 1, ww - zw:ww + zw + 1] = 0
    m64 = mask.astype(np.float64)
    px = (np.arange(win_w) - ww).astype(np.float64)[None, :]
    py = (np.arange(win_h) - wh).astype(np.float64)[:, None]
    H, W = img.shape[:2]
    out = np.asarray(corners, np.float32).reshape(-1, 2).copy()
    for k in range(out.shape[0]):
        cT = out[k].copy()
        cI = cT.copy()
        for _ in range(max_iters):
            sub = get_rect_sub_pix(img, (win_w + 2, win_h + 2), (float(cI[0]), float(cI[1])),
                                   patch_type="f32").astype(np.float64)
            tgx = sub[1:-1, 2:] - sub[1:-1, :-2]
            tgy = sub[2:, 1:-1] - sub[:-2, 1:-1]
            gxx = tgx * tgx * m64
            gxy = tgx * tgy * m64
            gyy = tgy * tgy * m64
            t1 = gxx * px + gxy * py
            t2 = gxy * px + gyy * py
            # cv2's sequential row-major f64 sums, in one accumulation each
            a, b, c, bb1, bb2 = np.cumsum(np.stack([gxx, gxy, gyy, t1, t2]).reshape(5, -1),
                                          axis=1)[:, -1].tolist()
            det = a * c - b * b
            if abs(det) <= np.finfo(np.float64).eps ** 2:
                break
            scale = 1.0 / det
            nx = f32(float(cI[0]) + c * scale * bb1 - b * scale * bb2)
            ny = f32(float(cI[1]) - b * scale * bb1 + a * scale * bb2)
            err = (float(nx) - float(cI[0])) ** 2 + (float(ny) - float(cI[1])) ** 2
            cI = np.array([nx, ny], np.float32)
            if not (0 <= cI[0] < W and 0 <= cI[1] < H):
                break
            if err <= eps:
                break
        if abs(float(cI[0]) - float(cT[0])) > ww or abs(float(cI[1]) - float(cT[1])) > wh:
            cI = cT
        out[k] = cI
    return out.reshape(np.asarray(corners, np.float32).shape)


def select_features(response: np.ndarray, max_corners: int = 0, quality_level: float = 0.01,
                    min_distance: float = 10.0, mask: np.ndarray = None) -> np.ndarray:
    """``cv2.goodFeaturesToTrack``'s selection on a corner response map →
    ``[N, 2]`` f32 (x, y): threshold ``max·quality`` (TOZERO), 3×3 dilate
    NMS with equality kept, candidates on the 1-pixel-inset interior in
    raster order, a stable sort by response descending, then greedy
    min-distance rejection on a ``min_distance`` grid (strict ``<``)."""
    eig = response.astype(np.float32).copy()
    maxv = float(eig.max())
    thr = np.float32(maxv * quality_level)
    eig[eig <= thr] = 0.0
    H, W = eig.shape
    p = np.pad(eig, 1, mode="constant", constant_values=0)
    dil = eig.copy()
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            dil = np.maximum(dil, p[1 + di:1 + di + H, 1 + dj:1 + dj + W])
    keep = (eig != 0) & (eig == dil)
    if mask is not None:
        keep &= mask != 0
    ys, xs = np.nonzero(keep)
    inset = (ys >= 1) & (ys < H - 1) & (xs >= 1) & (xs < W - 1)
    ys, xs = ys[inset], xs[inset]
    vals = eig[ys, xs]
    order = np.argsort(-vals, kind="stable")
    ys, xs, vals = ys[order], xs[order], vals[order]
    out = []
    if min_distance >= 1:
        cell = int(min_distance)
        gw = (W + cell - 1) // cell
        gh = (H + cell - 1) // cell
        grid = [[] for _ in range(gw * gh)]
        md2 = float(min_distance) * float(min_distance)
        for y, x in zip(ys.tolist(), xs.tolist()):
            gx, gy = x // cell, y // cell
            good = True
            for ny in range(max(0, gy - 1), min(gh, gy + 2)):
                for nx in range(max(0, gx - 1), min(gw, gx + 2)):
                    for (py, px) in grid[ny * gw + nx]:
                        if (px - x) ** 2 + (py - y) ** 2 < md2:
                            good = False
                            break
                    if not good:
                        break
                if not good:
                    break
            if good:
                grid[gy * gw + gx].append((y, x))
                out.append((x, y))
                if max_corners > 0 and len(out) >= max_corners:
                    break
    else:
        for y, x in zip(ys.tolist(), xs.tolist()):
            out.append((x, y))
            if max_corners > 0 and len(out) >= max_corners:
                break
    return np.array(out, np.float32).reshape(-1, 2)


def mean_shift(prob_image, window, max_count: int = 100, epsilon: float = 1.0):
    """``cv2.meanShift`` — the window to its ROI's centroid in cv2's integer
    steps, ``dx = cvRound(m10/m00 − w/2)`` clamped to the image, until
    ``dx² + dy² < cvRound(ε²)`` or the mass vanishes.  Returns
    ``(iterations, (x, y, w, h))``."""
    mat = np.asarray(prob_image)
    H, W = mat.shape[:2]
    x, y, w, h = (int(v) for v in window)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    x, y, w, h = x0, y0, max(x1 - x0, 0), max(y1 - y0, 0)
    eps = max(float(epsilon), 0.0)
    eps = int(np.rint(eps * eps))
    niters = max(int(max_count), 1)
    i = niters
    for i in range(niters):
        if w == 0 or h == 0:
            x, y = W // 2, H // 2
            w, h = max(w, 1), max(h, 1)
        roi = mat[y:y + h, x:x + w].astype(np.float64)
        m00 = roi.sum()
        if abs(m00) < np.finfo(np.float64).eps:
            break
        ys, xs = np.mgrid[0:h, 0:w]
        m10 = (roi * xs).sum()
        m01 = (roi * ys).sum()
        dx = int(np.rint(m10 / m00 - w * 0.5))
        dy = int(np.rint(m01 / m00 - h * 0.5))
        nx = min(max(x + dx, 0), W - w)
        ny = min(max(y + dy, 0), H - h)
        dx, dy = nx - x, ny - y
        x, y = nx, ny
        if dx * dx + dy * dy < eps:
            break
    else:
        i = niters
    return i, (x, y, w, h)


def cam_shift(prob_image, window, max_count: int = 100, epsilon: float = 1.0):
    """``cv2.CamShift`` — :func:`mean_shift`, then the orientation and size
    from the central moments of the window grown by 10 pixels a side.
    Returns ``((center, size, angle), (x, y, w, h))``."""
    mat = np.asarray(prob_image)
    H, W = mat.shape[:2]
    TOLERANCE = 10
    _, (x, y, w, h) = mean_shift(prob_image, window, max_count, epsilon)
    x -= TOLERANCE
    if x < 0:
        x = 0
    y -= TOLERANCE
    if y < 0:
        y = 0
    w += 2 * TOLERANCE
    if x + w > W:
        w = W - x
    h += 2 * TOLERANCE
    if y + h > H:
        h = H - y
    roi = mat[y:y + h, x:x + w].astype(np.float64)
    m00 = roi.sum()
    if abs(m00) < np.finfo(np.float64).eps:
        return (((0.0, 0.0), (0.0, 0.0), 0.0), (x, y, w, h))
    ysg, xsg = np.mgrid[0:h, 0:w]
    m10 = (roi * xsg).sum()
    m01 = (roi * ysg).sum()
    m20 = (roi * xsg * xsg).sum()
    m11 = (roi * xsg * ysg).sum()
    m02 = (roi * ysg * ysg).sum()
    inv_m00 = 1.0 / m00
    xc = int(np.rint(m10 * inv_m00 + x))
    yc = int(np.rint(m01 * inv_m00 + y))
    mu20 = m20 - m10 * (m10 * inv_m00)
    mu11 = m11 - m10 * (m01 * inv_m00)
    mu02 = m02 - m01 * (m01 * inv_m00)
    a = mu20 * inv_m00
    b = mu11 * inv_m00
    c = mu02 * inv_m00
    square = np.sqrt(4 * b * b + (a - c) * (a - c))
    theta = np.arctan2(2 * b, a - c + square)
    cs, sn = np.cos(theta), np.sin(theta)
    rot_a = cs * cs * mu20 + 2 * cs * sn * mu11 + sn * sn * mu02
    rot_c = sn * sn * mu20 - 2 * cs * sn * mu11 + cs * cs * mu02
    length = np.sqrt(max(rot_a * inv_m00, 0.0)) * 4.0
    width = np.sqrt(max(rot_c * inv_m00, 0.0)) * 4.0
    if length < width:
        length, width = width, length
        cs, sn = sn, cs
        theta = np.pi * 0.5 - theta
    t0 = int(np.rint(abs(length * cs)))
    t1 = int(np.rint(abs(width * sn)))
    t0 = max(t0, t1) + 2
    nw = min(t0, W)
    t0 = int(np.rint(abs(length * sn)))
    t1 = int(np.rint(abs(width * cs)))
    t0 = max(t0, t1) + 2
    nh = min(t0, H)
    nx = max(0, xc - nw // 2)
    ny = max(0, yc - nh // 2)
    nx = min(nx, W - nw)
    ny = min(ny, H - nh)
    ang = float((np.pi * 0.5 + theta) * 180.0 / np.pi)
    while ang < 0:
        ang += 360.0
    while ang >= 360.0:
        ang -= 360.0
    if ang >= 180.0:
        ang -= 180.0
    box = ((float(np.float32(nx + nw * 0.5)), float(np.float32(ny + nh * 0.5))),
           (float(np.float32(width)), float(np.float32(length))),
           float(np.float32(ang)))
    return box, (nx, ny, nw, nh)
