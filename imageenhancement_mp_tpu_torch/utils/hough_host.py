"""Host helpers of the Hough family, copied from the NumPy oracle, the JAX
package's ``ref/ops.py`` (``_CvRNG`` :6195, ``hough_lines_p``
:6211, ``_hough_numangle`` :5666, ``_hough_select`` :5720), because the port
may not import that package at run time, and the host side of
``hough_lines`` (``hough_tables``: the angle and trig tables that the JAX
package's ``api.hough_lines`` builds).  They run on NumPy arrays, as the JAX
package runs them on the host: the probabilistic transform is sequential by
design (each random candidate un-votes and erases what the next one reads),
and the standard transform's selection reads a small accumulator once.
``fit_line`` in ``utils/contours_host.py`` draws from the same ``_CvRNG``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hough_lines_p", "hough_tables", "hough_numrho", "hough_lines_from_acc"]


class _CvRNG:
    """cv2::RNG — the exact MWC generator (state·4164903690 + carry)."""

    def __init__(self, state=2 ** 64 - 1):
        self.state = state & 0xFFFFFFFFFFFFFFFF

    def next(self) -> int:
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) \
            & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform_int(self, a: int, b: int) -> int:
        return a + self.next() % (b - a) if b > a else a


def hough_lines_p(img: np.ndarray, rho: float = 1.0,
                  theta: float = np.pi / 180, threshold: int = 100,
                  min_line_length: int = 0,
                  max_line_gap: int = 0,
                  lines_max: int = 2 ** 31 - 1) -> np.ndarray:
    """``cv2.HoughLinesP`` — probabilistic Hough with cv2's
    erase-as-you-walk algorithm, BIT-EXACT (the routine seeds a LOCAL
    ``RNG((uint64)-1)`` per call, so it is deterministic; the exact MWC
    stream is reproduced by :class:`_CvRNG`).

    Pinned laws: ``numangle = cvRound(π/θ)``, ``numrho =
    cvRound(((W+H)·2+1)/ρ)``; trig table ``f32(cos(n·θ)·1/ρ)`` on the
    f64 product (unlike standard HoughLines' incremental-f32 angle);
    vote ``r = cvRound(f32(f32(x·tcos) + f32(y·tsin))) + (numrho-1)/2``;
    line walk in Q16 fixed point with ``cvRound(b·2^16/|a|)`` slope,
    gap counter reset on every hit; good = |Δx| ≥ len OR |Δy| ≥ len;
    second walk un-votes and clears the mask up to the recorded ends.
    Returns ``[N, 4]`` int32 (x1, y1, x2, y2).
    """
    if img.dtype != np.uint8:
        raise TypeError("HoughLinesP requires uint8 input")
    f32 = np.float32
    H, W = img.shape
    numangle = int(np.rint(np.pi / theta))
    numrho = int(np.rint(((W + H) * 2 + 1) / rho))
    irho = 1.0 / rho
    ns = np.arange(numangle, dtype=np.float64)
    tcos = (np.cos(ns * theta) * irho).astype(f32)
    tsin = (np.sin(ns * theta) * irho).astype(f32)
    mask = (img != 0)
    ys, xs = np.nonzero(img)
    # row-major collection order (cv2 scans rows)
    nz = list(zip(xs.tolist(), ys.tolist()))
    acc = np.zeros((numangle, numrho), np.int32)
    rng = _CvRNG()
    out = []
    SHIFT = 16
    count = len(nz)
    c0 = (numrho - 1) // 2
    while count > 0:
        idx = rng.uniform_int(0, count)
        j, i = nz[idx]
        nz[idx] = nz[count - 1]
        count -= 1
        if not mask[i, j]:
            continue
        rr = (np.rint((f32(j) * tcos + f32(i) * tsin).astype(f32))
              .astype(np.int64) + c0)
        acc[np.arange(numangle), rr] += 1
        vals = acc[np.arange(numangle), rr]
        max_n = int(np.argmax(vals))
        max_val = int(vals[max_n])
        if max_val < threshold:
            continue
        a = -float(tsin[max_n])
        b = float(tcos[max_n])
        x0, y0 = j, i
        if abs(a) > abs(b):
            xflag = True
            dx0 = 1 if a > 0 else -1
            dy0 = int(np.rint(b * (1 << SHIFT) / abs(a)))
            y0 = (y0 << SHIFT) + (1 << (SHIFT - 1))
        else:
            xflag = False
            dy0 = 1 if b > 0 else -1
            dx0 = int(np.rint(a * (1 << SHIFT) / abs(b)))
            x0 = (x0 << SHIFT) + (1 << (SHIFT - 1))
        line_end = [[0, 0], [0, 0]]
        for k in (0, 1):
            gap = 0
            x, y = x0, y0
            dx, dy = (dx0, dy0) if k == 0 else (-dx0, -dy0)
            while True:
                if xflag:
                    j1, i1 = x, y >> SHIFT
                else:
                    j1, i1 = x >> SHIFT, y
                if j1 < 0 or j1 >= W or i1 < 0 or i1 >= H:
                    break
                if mask[i1, j1]:
                    gap = 0
                    line_end[k] = [j1, i1]
                else:
                    gap += 1
                    if gap > max_line_gap:
                        break
                x += dx
                y += dy
        good = (abs(line_end[1][0] - line_end[0][0]) >= min_line_length
                or abs(line_end[1][1] - line_end[0][1]) >= min_line_length)
        for k in (0, 1):
            x, y = x0, y0
            dx, dy = (dx0, dy0) if k == 0 else (-dx0, -dy0)
            while True:
                if xflag:
                    j1, i1 = x, y >> SHIFT
                else:
                    j1, i1 = x >> SHIFT, y
                if mask[i1, j1]:
                    if good:
                        r2 = (np.rint((f32(j1) * tcos + f32(i1) * tsin)
                                      .astype(f32)).astype(np.int64) + c0)
                        acc[np.arange(numangle), r2] -= 1
                    mask[i1, j1] = False
                if i1 == line_end[k][1] and j1 == line_end[k][0]:
                    break
                x += dx
                y += dy
        if good:
            out.append([line_end[0][0], line_end[0][1],
                        line_end[1][0], line_end[1][1]])
            if len(out) >= lines_max:
                break
    return np.asarray(out, np.int32).reshape(-1, 4)


def _hough_numangle(min_theta: float, max_theta: float, theta: float) -> int:
    # cv2's computeNumangle: floor(span/step)+1, then drop the last bin
    # when the span is ~pi (a line would otherwise be detected twice)
    na = int(np.floor((max_theta - min_theta) / theta)) + 1
    if na > 1 and abs(np.pi - (na - 1) * theta) < theta / 2:
        na -= 1
    return na


def _hough_select(acc: np.ndarray, numangle: int, numrho: int,
                  threshold: int, rho: float, min_theta: float,
                  theta: float) -> np.ndarray:
    """Pinned HoughLines candidate selection over a padded accumulator."""
    f32 = np.float32
    cand = []
    for n in range(numangle):
        row = acc[n + 1]
        v = row[1:-1]
        keep = ((v > threshold) & (v > row[:-2]) & (v >= row[2:])
                & (v > acc[n][1:-1]) & (v >= acc[n + 2][1:-1]))
        for r in np.nonzero(keep)[0]:
            cand.append((int(v[r]), n, int(r)))
    cand.sort(key=lambda q: (-q[0], q[1] * numrho + q[2]))
    c0 = (numrho - 1) // 2
    return np.array([[(r - c0) * rho, f32(f32(min_theta) + f32(n) * f32(theta))]
                     for _, n, r in cand], np.float32).reshape(-1, 2)



def hough_numrho(H: int, W: int, rho: float) -> int:
    """``numrho = cvRound(((W + H)·2 + 1)/ρ)``, the accumulator's width."""
    return int(np.rint(((W + H) * 2 + 1) / rho))


def hough_tables(min_theta: float, max_theta: float, theta: float, rho: float):
    """The standard transform's ``(numangle, tabcos, tabsin)``: the angle
    grows by an INCREMENTAL f32 add (``ang += (float)θ``), sin/cos are taken
    on the f64-promoted f32 angle, times ``1/ρ``, cast to f32 (the JAX
    package's ``api.hough_lines``)."""
    f32 = np.float32
    numangle = _hough_numangle(float(min_theta), float(max_theta), float(theta))
    irho = 1.0 / float(rho)
    ang = np.empty(numangle)
    a = f32(min_theta)
    step = f32(theta)
    for i in range(numangle):
        ang[i] = np.float64(a)
        a = f32(a + step)
    return numangle, (np.cos(ang) * irho).astype(f32), (np.sin(ang) * irho).astype(f32)


def hough_lines_from_acc(acc: np.ndarray, threshold: int, rho: float, min_theta: float,
                         theta: float) -> np.ndarray:
    """The standard transform's lines from its fetched ``[numangle, numrho]``
    vote accumulator: padded with a ring of zeros, then ``_hough_select``."""
    numangle, numrho = acc.shape
    pad = np.zeros((numangle + 2, numrho + 2), np.int32)
    pad[1:-1, 1:-1] = acc
    return _hough_select(pad, numangle, numrho, int(threshold), float(rho), float(min_theta),
                         float(theta))
