"""Host helpers of the photo family, copied from the NumPy oracle
``imageenhancement_mp_tpu/ref/ops.py`` (``_decolor_gradvec`` and
``decolor_weights`` :2945-3021, ``_mtb_median``, ``shift_mat``,
``calculate_shift_mtb`` and ``align_mtb``'s shift search :4945-5031,
``_optimal_dft_size`` :5121, ``create_hanning_window`` :5180, with the
pieces they call: the f32 Lab forward and the float linear resize)
and ``ref/inpaint.py`` whole (Telea's fast-marching inpainting), because
the port may not import that package at run time.  They run on NumPy
arrays, as the JAX package runs them on the host: a 9-weight solve over an
image of at most 800 rows plus columns, a greedy pyramid search, a
priority-queue fill and table builders are sequential host work.

One change: ``decolor_weights`` shrinks a work image of more than 800 rows
plus columns channel by channel through the oracle's float linear law; the
oracle's own ``resize`` takes 2-D planes only and raises there.
"""

from __future__ import annotations

import heapq

import numpy as np

__all__ = ["decolor_weights", "shift_mat", "calculate_shift_mtb", "mtb_shifts",
           "optimal_dft_size", "create_hanning_window", "inpaint_telea"]

_F32 = np.float32

# ------------------------------------------------------------------ decolor

_XYZ_FWD = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_LAB_WHITE = np.array([0.950456, 1.0, 1.088754])


def _rgb_to_lab_f32(img: np.ndarray) -> np.ndarray:
    """f32 RGB in [0, 1] → f32 Lab: the analytic CIE formulas in f64."""
    r = img.astype(np.float64)
    r = np.where(r > 0.04045, ((r + 0.055) / 1.055) ** 2.4, r / 12.92)
    xyz = (r @ _XYZ_FWD.T) / _LAB_WHITE
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    L = np.where(xyz[..., 1] > 0.008856, 116.0 * fy - 16.0, 903.3 * xyz[..., 1])
    return np.stack([L, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1).astype(np.float32)


def _resize_lin_tables(n: int, on: int):
    """cv2's linear-resize source coordinate ``(dx + 0.5)·n/on − 0.5`` stored
    as f32, split into clamped indices and the unclamped fraction."""
    f = ((np.arange(on) + 0.5) * (n / on) - 0.5).astype(np.float32)
    i = np.floor(f.astype(np.float64)).astype(np.int64)
    f = (f - i).astype(np.float32)
    return np.clip(i, 0, n - 1), np.clip(i + 1, 0, n - 1), f


def _resize_linear_f32(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2's float linear resize of one f32 ``[H, W]`` plane: f32
    coefficients ``(1 − r, r)``, f32 sums, horizontal pass first."""
    H, W = img.shape
    iy0, iy1, ry = _resize_lin_tables(H, oh)
    ix0, ix1, rx = _resize_lin_tables(W, ow)
    a = img.astype(np.float32)
    one = np.float32(1)
    h0 = (a[:, ix0] * (one - rx) + a[:, ix1] * rx).astype(np.float32)
    return (h0[iy0] * (one - ry)[:, None] + h0[iy1] * ry[:, None]).astype(np.float32)


def _decolor_gradvec(ch: np.ndarray) -> np.ndarray:
    """cv2 Decolor::gradvector — [1,-1] correlations (x then y), last
    col/row zeroed, flattened via the transpose (column-major), x block
    then y block."""
    f32 = np.float32
    dx = np.zeros_like(ch, f32)
    dx[:, :-1] = ch[:, :-1] - ch[:, 1:]
    dy = np.zeros_like(ch, f32)
    dy[:-1, :] = ch[:-1, :] - ch[1:, :]
    return np.concatenate([dx.T.ravel(), dy.T.ravel()]).astype(np.float64)


def decolor_weights(img_rgb01: np.ndarray):
    """The Lu/Xu/Jia contrast-preserving decolorization solver as cv2.decolor
    runs it: a work image of at most 800 rows plus columns, the colour
    contrast ``|∇Lab|/100``, the 9 monomials' least-squares map, the weak
    order from the gradient signs at 0.05, and the EM loop (σ² = 4e-4 in
    the G-step, the stopping energy at σ = 0.02 as a mean; tol 1e-4, at
    most 16 rounds).  Returns the 9 f64 weights and their exponents."""
    f32, f64 = np.float32, np.float64
    img = np.asarray(img_rgb01, f32)
    h, w = img.shape[:2]
    if h + w > 800:
        sf = 800.0 / (h + w)
        oh, ow = int(round(h * sf)), int(round(w * sf))
        img = np.stack([_resize_linear_f32(img[..., c], oh, ow) for c in range(3)], -1)
    lab = _rgb_to_lab_f32(img.astype(f32))
    Cgp = [_decolor_gradvec(np.ascontiguousarray(lab[..., c])) for c in range(3)]
    Cg = np.sqrt(Cgp[0] ** 2 + Cgp[1] ** 2 + Cgp[2] ** 2) / 100.0
    R_, G_, B_ = img[..., 0], img[..., 1], img[..., 2]
    combs = [(r, g, b) for r in range(3) for g in range(3) for b in range(3)
             if 0 < r + g + b <= 2]
    pg = [_decolor_gradvec(((R_ ** r) * (G_ ** g) * (B_ ** b)).astype(f32))
          for r, g, b in combs]
    P = np.array(pg, f32)
    A = (P @ P.T).astype(f32)
    Bm = (P.astype(f64) * Cg[None, :]).astype(f32)
    Mt = np.linalg.solve(A.astype(f64), Bm.astype(f64))
    Rg = _decolor_gradvec(R_.astype(f32))
    Gg = _decolor_gradvec(G_.astype(f32))
    Bg = _decolor_gradvec(B_.astype(f32))
    lv = 0.05
    alf = (((Rg > lv) & (Gg > lv) & (Bg > lv)).astype(f64)
           - ((Rg < -lv) & (Gg < -lv) & (Bg < -lv)).astype(f64))
    wei = np.array([0.33 if sum(c) == 1 else 0.0 for c in combs], f64)
    sigma = 0.02
    E = 0.0
    pre_E = np.inf
    it = 0
    Pd = P.astype(f64)
    while abs(E - pre_E) > 1e-4:
        it += 1
        pre_E = E
        val = wei @ Pd
        Gp = ((1 + alf) / 2) * np.exp(-0.5 * (val - Cg) ** 2 / sigma ** 2)
        Gn = ((1 - alf) / 2) * np.exp(-0.5 * (val + Cg) ** 2 / sigma ** 2)
        s = Gp + Gn
        expterm = (Gp - Gn) / (s + (s == 0))
        wei = Mt @ expterm
        val = wei @ Pd
        en = -np.log(np.maximum(np.exp(-(val - Cg) ** 2 / sigma)
                                + np.exp(-(val + Cg) ** 2 / sigma), 1e-300))
        E = float(en.mean())
        if it > 15:
            break
    return wei, combs


# ------------------------------------------------------------------ AlignMTB

def _mtb_median(img: np.ndarray) -> int:
    csum = np.cumsum(np.bincount(img.ravel(), minlength=256))
    return int(np.argmax(csum >= img.size // 2)) + 1


def shift_mat(img: np.ndarray, shift) -> np.ndarray:
    """``cv2.AlignMTB.shiftMat`` — translate by ``(x, y)``, zero fill."""
    sx, sy = int(shift[0]), int(shift[1])
    out = np.zeros_like(img)
    H, W = img.shape[:2]
    out[max(0, sy):min(H, H + sy), max(0, sx):min(W, W + sx)] = \
        img[max(0, -sy):min(H, H - sy), max(0, -sx):min(W, W - sx)]
    return out


def calculate_shift_mtb(img0: np.ndarray, img1: np.ndarray, max_bits: int = 6,
                        exclude_range: int = 4):
    """``cv2.AlignMTB.calculateShift`` — the (x, y) translation that best
    aligns ``img1`` to ``img0`` (both u8 gray): a floor-sized decimation
    pyramid, median thresholds (getMedian's +1), strict improvement over
    the 3×3 candidates with the x offset as the outer loop."""
    maxlevel = min(int(max_bits) - 1, int(np.log(max(img0.shape)) / np.log(2.0)) - 1)

    def build(img):
        pyr = [img]
        for _ in range(maxlevel):
            c = pyr[-1]
            pyr.append(np.ascontiguousarray(c[:c.shape[0] // 2 * 2:2, :c.shape[1] // 2 * 2:2]))
        return pyr

    p0, p1 = build(img0), build(img1)
    sx = sy = 0
    for level in range(maxlevel, -1, -1):
        sx *= 2
        sy *= 2
        im0, im1 = p0[level], p1[level]
        m0, m1 = _mtb_median(im0), _mtb_median(im1)
        tb0, tb1 = im0 > m0, im1 > m1
        eb0 = np.abs(im0.astype(np.int32) - m0) > exclude_range
        eb1 = np.abs(im1.astype(np.int32) - m1) > exclude_range
        best = (int(im0.size), sx, sy)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                tx, ty = sx + dx, sy + dy
                stb = shift_mat(tb1, (tx, ty))
                seb = shift_mat(eb1, (tx, ty))
                err = int(((tb0 ^ stb) & eb0 & seb).sum())
                if err < best[0]:
                    best = (err, tx, ty)
        _, sx, sy = best
    return (sx, sy)


def mtb_shifts(grays: list, max_bits: int = 6, exclude_range: int = 4) -> list:
    """Each u8 gray frame's (x, y) shift onto the middle one, (0, 0) for it."""
    pivot = len(grays) // 2
    return [(0, 0) if i == pivot else
            calculate_shift_mtb(grays[pivot], g, max_bits, exclude_range)
            for i, g in enumerate(grays)]


# ------------------------------------------------------------------ DFT sizes, window

def optimal_dft_size(n: int) -> int:
    """cv2.getOptimalDFTSize: the smallest 2^a·3^b·5^c ≥ n."""
    best = None
    p2 = 1
    while p2 < 8 * n:
        p3 = p2
        while p3 < 8 * n:
            p5 = p3
            while p5 < 8 * n:
                if p5 >= n and (best is None or p5 < best):
                    best = p5
                p5 *= 5
            p3 *= 3
        p2 *= 2
    return int(best)


def create_hanning_window(size_hw) -> np.ndarray:
    """``cv2.createHanningWindow`` (CV_64F): the square root of the separable
    Hann product."""
    h, w = int(size_hw[0]), int(size_hw[1])
    wy = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(h) / (h - 1)))
    wx = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(w) / (w - 1)))
    return np.sqrt(np.outer(wy, wx))


# ------------------------------------------------------------------ inpaint (Telea)

KNOWN, BAND, INSIDE = 0, 1, 2


def _dilate(m: np.ndarray, el: np.ndarray) -> np.ndarray:
    """Binary dilation of uint8 m by structuring element el (odd, centered)."""
    kh, kw = el.shape
    ph, pw = kh // 2, kw // 2
    p = np.pad(m, ((ph, ph), (pw, pw)))
    out = np.zeros_like(m)
    for i in range(kh):
        for j in range(kw):
            if el[i, j]:
                out = np.maximum(out, p[i:i + m.shape[0], j:j + m.shape[1]])
    return out


class _Heap:
    """cv2's CvPriorityQueueFloat: min-heap on T with FIFO tie order."""

    def __init__(self):
        self.h: list = []
        self.n = 0

    def push(self, tval: float, i: int, j: int):
        heapq.heappush(self.h, (_F32(tval), self.n, i, j))
        self.n += 1

    def pop(self):
        if not self.h:
            return None
        t, _, i, j = heapq.heappop(self.h)
        return i, j

    def add_band(self, band: np.ndarray):
        for i, j in zip(*np.nonzero(band)):
            self.push(0.0, int(i), int(j))


def _fmm_solve(i1, j1, i2, j2, f, t):
    """cv2 FMM_solve: quadratic Eikonal update from two known neighbors."""
    a11 = float(t[i1, j1])
    a22 = float(t[i2, j2])
    m12 = min(a11, a22)
    if f[i1, j1] != INSIDE:
        if f[i2, j2] != INSIDE:
            if abs(a11 - a22) >= 1.0:
                sol = 1 + m12
            else:
                sol = (a11 + a22 + np.sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5
        else:
            sol = 1 + a11
    elif f[i2, j2] != INSIDE:
        sol = 1 + a22
    else:
        sol = 1 + m12
    return _F32(sol)


_DI = (-1, 0, 1, 0)
_DJ = (0, -1, 0, 1)


def _relax(f, t, i, j):
    """The least of the four axis-pair Eikonal solves at (i, j)."""
    return min(_fmm_solve(i - 1, j, i, j - 1, f, t), _fmm_solve(i + 1, j, i, j - 1, f, t),
               _fmm_solve(i - 1, j, i, j + 1, f, t), _fmm_solve(i + 1, j, i, j + 1, f, t))


def _calc_fmm(f, t, heap, negate, rows, cols):
    """March T outward over f==INSIDE; negate flips processed points."""
    processed = []
    while True:
        p = heap.pop()
        if p is None:
            break
        ii, jj = p
        f[ii, jj] = 3 if negate else KNOWN  # CHANGE=3 during the negate pass
        if negate:
            processed.append((ii, jj))
        for q in range(4):
            i, j = ii + _DI[q], jj + _DJ[q]
            if i <= 0 or j <= 0 or i > rows - 2 or j > cols - 2:
                continue
            if f[i, j] == INSIDE:
                dist = _relax(f, t, i, j)
                t[i, j] = dist
                f[i, j] = BAND
                heap.push(float(dist), i, j)
    if negate:
        for i, j in processed:
            f[i, j] = KNOWN
            t[i, j] = -t[i, j]


def _grad_t(f, t, i, j):
    """cv2's gradT: central (×0.5) when both neighbors known, one-sided else."""
    if f[i, j + 1] != INSIDE:
        if f[i, j - 1] != INSIDE:
            gx = (t[i, j + 1] - t[i, j - 1]) * _F32(0.5)
        else:
            gx = t[i, j + 1] - t[i, j]
    else:
        if f[i, j - 1] != INSIDE:
            gx = t[i, j] - t[i, j - 1]
        else:
            gx = _F32(0.0)
    if f[i + 1, j] != INSIDE:
        if f[i - 1, j] != INSIDE:
            gy = (t[i + 1, j] - t[i - 1, j]) * _F32(0.5)
        else:
            gy = t[i + 1, j] - t[i, j]
    else:
        if f[i - 1, j] != INSIDE:
            gy = t[i, j] - t[i - 1, j]
        else:
            gy = _F32(0.0)
    return gx, gy


def _paint(f, t, out, rng, i, j, rows, cols):
    """Telea's weighted average of (i, j)'s known neighbourhood, with the
    normalised gradient term, as ``int(x + 0.5)`` clipped to u8."""
    gtx, gty = _grad_t(f, t, i, j)
    ia = _F32(0.0)
    s = _F32(1.0e-20)
    jx = _F32(0.0)
    jy = _F32(0.0)
    for k in range(i - rng, i + rng + 1):
        km = k - 1 + (k == 1)
        kp = k - 1 - (k == rows - 2)
        for l in range(j - rng, j + rng + 1):
            lm = l - 1 + (l == 1)
            lp = l - 1 - (l == cols - 2)
            if (k > 0 and l > 0 and k < rows - 1 and l < cols - 1 and f[k, l] != INSIDE
                    and (i - k) * (i - k) + (j - l) * (j - l) <= rng * rng):
                ry = _F32(i - k)
                rx = _F32(j - l)
                r2 = rx * rx + ry * ry
                dst = _F32(1.0) / _F32(r2 * np.sqrt(np.float64(r2), dtype=np.float64))
                lev = _F32(1.0) / (_F32(1.0) + _F32(abs(t[k, l] - t[i, j])))
                drc = rx * gtx + ry * gty
                if abs(drc) <= 0.01:
                    drc = _F32(1.0e-6)
                w = _F32(abs(dst * lev * drc))
                # gradI on the working image (one-sided/central with the
                # boundary-shifted km/kp, lm/lp indices)
                if f[k, l + 1] != INSIDE and f[k, l - 1] != INSIDE:
                    gix = _F32(int(out[km, lp + 1]) - int(out[km, lm - 1])) * _F32(2.0)
                elif f[k, l + 1] != INSIDE:
                    gix = _F32(int(out[km, lp + 1]) - int(out[km, lm]))
                elif f[k, l - 1] != INSIDE:
                    gix = _F32(int(out[km, lp]) - int(out[km, lm - 1]))
                else:
                    gix = _F32(0.0)
                if f[k + 1, l] != INSIDE and f[k - 1, l] != INSIDE:
                    giy = _F32(int(out[kp + 1, lm]) - int(out[km - 1, lm])) * _F32(2.0)
                elif f[k + 1, l] != INSIDE:
                    giy = _F32(int(out[kp + 1, lm]) - int(out[km, lm]))
                elif f[k - 1, l] != INSIDE:
                    giy = _F32(int(out[kp, lm]) - int(out[km - 1, lm]))
                else:
                    giy = _F32(0.0)
                ia = ia + w * _F32(out[km, lm])
                jx = jx - w * gix * rx
                jy = jy - w * giy * ry
                s = s + w
    sat = ia / s + (jx + jy) / (_F32(np.sqrt(_F32(jx * jx + jy * jy), dtype=np.float32))
                                + _F32(1.0e-20)) + _F32(0.5)
    out[i - 1, j - 1] = np.uint8(np.clip(int(sat), 0, 255))


def _telea_paint(f, t, out, rng, heap, rows, cols):
    """Main Telea FMM: pop, relax and paint INSIDE neighbors, push."""
    while True:
        p = heap.pop()
        if p is None:
            break
        ii, jj = p
        f[ii, jj] = KNOWN
        for q in range(4):
            i, j = ii + _DI[q], jj + _DJ[q]
            if i <= 1 or j <= 1 or i > rows - 2 or j > cols - 2:
                continue
            if f[i, j] == INSIDE:
                dist = _relax(f, t, i, j)
                t[i, j] = dist
                _paint(f, t, out, rng, i, j, rows, cols)
                f[i, j] = BAND
                heap.push(float(dist), i, j)


def inpaint_telea(img: np.ndarray, mask: np.ndarray, radius: float = 3.0) -> np.ndarray:
    """``cv2.inpaint(img, mask, radius, INPAINT_TELEA)`` — grayscale u8: the
    band (cross-dilated mask minus the mask) marched outward over the
    ring and negated, then the main march painting each newly banded
    pixel."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise TypeError("inpaint: 2-D uint8 only")
    rng = max(1, min(100, int(round(radius))))
    rows, cols = img.shape[0] + 2, img.shape[1] + 2

    m = np.zeros((rows, cols), np.uint8)
    m[1:-1, 1:-1] = (np.asarray(mask) != 0).astype(np.uint8) * INSIDE
    f = m.copy()
    t = np.full((rows, cols), 1.0e6, np.float32)

    cross = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
    band = _dilate(m, cross)
    band = np.where(band > m, band - m, 0).astype(np.uint8)  # cvSub saturates
    band[0, :] = band[-1, :] = 0
    band[:, 0] = band[:, -1] = 0
    f[band > 0] = BAND
    t[band > 0] = 0.0  # the T array must agree with the heap's T=0 entries

    heap = _Heap()
    heap.add_band(band)

    rect = np.ones((2 * rng + 1, 2 * rng + 1), np.uint8)
    ring = _dilate(m, rect)
    ring = np.where(ring > m, ring - m, 0).astype(np.uint8)
    fout = np.where(ring > 0, np.uint8(INSIDE), np.uint8(KNOWN))
    # band points live inside the ring; march outward then negate
    _calc_fmm(fout, t, heap, True, rows, cols)

    heap = _Heap()
    heap.add_band(band)
    out = img.copy()
    _telea_paint(f, t, out, rng, heap, rows, cols)
    return out
