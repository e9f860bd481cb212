"""Host helpers of the contour and shape family, copied from the NumPy
oracle, the JAX package's ``ref/ops.py`` (``_CONTOUR_DELTAS``/
``_CONTOUR_DIR`` :6331, ``_trace_contours`` :6336, ``_chain_simple`` :6413,
``find_contours`` :6431, ``contour_area`` :6515, ``arc_length`` :6533,
``bounding_rect`` :6555, ``contour_moments`` :6570, ``_sklansky`` :6639,
``convex_hull`` :6680, ``is_contour_convex`` :6772, ``point_polygon_test``
:6803, ``convexity_defects`` :6865, ``approx_poly_dp`` :6912,
``min_area_rect`` :7073, ``box_points`` :7130, ``min_enclosing_circle``
:7146, ``_fitline_wods`` :7197, ``fit_line`` :7217, ``fit_ellipse`` :7311,
``moments`` :5190, ``hu_moments`` :5231, ``match_shapes`` :5255), as they
are, because the port may not import that package at run time.  They run on
NumPy arrays, as the JAX package runs them on the host: Suzuki-Abe border
following erases as it walks, and the descriptors walk a contour's few
hundred points one after another.  ``fit_line``'s random support points
come from ``utils/hough_host.py``'s ``_CvRNG``.
"""

from __future__ import annotations

import numpy as np

from imageenhancement_mp_tpu_torch.utils.hough_host import _CvRNG

__all__ = ["find_contours", "contour_area", "arc_length", "bounding_rect", "contour_moments",
           "convex_hull", "is_contour_convex", "point_polygon_test", "convexity_defects",
           "approx_poly_dp", "min_area_rect", "box_points", "min_enclosing_circle", "fit_line",
           "fit_ellipse", "moments", "hu_moments", "match_shapes"]

_CONTOUR_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1),
                   (-1, 0), (-1, 1), (0, 1), (1, 1))  # CCW from E
_CONTOUR_DIR = {d: i for i, d in enumerate(_CONTOUR_DELTAS)}


def _trace_contours(img: np.ndarray):
    """Suzuki-Abe 8-connected border following (the algorithm behind
    ``cv2.findContours``), paper-exact: 3.1 scans CLOCKWISE from the
    zero neighbour that triggered the start, 3.3 scans COUNTER-
    clockwise from the previous border pixel, marking -NBD when the
    east neighbour was examined and zero.  Returns discovery-ordered
    ``(points [(x,y)], is_hole, parent_nbd, nbd)`` (frame = NBD 1);
    point sequences are bit-exact vs cv2 (fuzz 0/60 random blobs)."""
    H, W = img.shape
    f = (img != 0).astype(np.int32)
    NBD = 1
    info = {1: (True, None)}
    out = []
    for i in range(H):
        LNBD = 1
        for j in range(W):
            fij = f[i, j]
            if fij == 0:
                continue
            outer = fij == 1 and (j == 0 or f[i, j - 1] == 0)
            hole = fij >= 1 and (j == W - 1 or f[i, j + 1] == 0)
            if outer or hole:
                NBD += 1
                if outer:
                    d_from = _CONTOUR_DIR[(-1, 0)]
                    is_hole = False
                else:
                    d_from = _CONTOUR_DIR[(1, 0)]
                    if fij > 1:
                        LNBD = fij
                    is_hole = True
                parent = (info[LNBD][1] if is_hole == info[LNBD][0]
                          else LNBD)
                info[NBD] = (is_hole, parent)
                found = None
                for t in range(8):
                    d = (d_from - t) % 8
                    dx, dy = _CONTOUR_DELTAS[d]
                    x2, y2 = j + dx, i + dy
                    if 0 <= x2 < W and 0 <= y2 < H and f[y2, x2] != 0:
                        found = (x2, y2)
                        break
                pts = [(j, i)]
                if found is None:
                    f[i, j] = -NBD
                    out.append((pts, is_hole, parent, NBD))
                else:
                    x1, y1 = found
                    x2, y2 = x1, y1
                    x3, y3 = j, i
                    while True:
                        d_start = _CONTOUR_DIR[(x2 - x3, y2 - y3)]
                        east_zero = False
                        for t in range(1, 9):
                            d = (d_start + t) % 8
                            dx, dy = _CONTOUR_DELTAS[d]
                            x4, y4 = x3 + dx, y3 + dy
                            if (0 <= x4 < W and 0 <= y4 < H
                                    and f[y4, x4] != 0):
                                break
                            if (dx, dy) == (1, 0):
                                east_zero = True
                        if east_zero:
                            f[y3, x3] = -NBD
                        elif f[y3, x3] == 1:
                            f[y3, x3] = NBD
                        if (x4, y4) == (j, i) and (x3, y3) == (x1, y1):
                            break
                        pts.append((x4, y4))
                        x2, y2 = x3, y3
                        x3, y3 = x4, y4
                    out.append((pts, is_hole, parent, NBD))
            if abs(f[i, j]) > 1:
                LNBD = abs(f[i, j])
    return out


def _chain_simple(pts):
    """CHAIN_APPROX_SIMPLE: the cyclic direction-change corners, in
    traversal order — the start pixel is DROPPED when its incoming and
    outgoing directions agree (probed: cv2 starts such contours at the
    first corner after the scan hit)."""
    n = len(pts)
    if n == 1:
        return list(pts)
    keep = []
    for k in range(n):
        pp = pts[(k - 1) % n]
        p = pts[k]
        pn = pts[(k + 1) % n]
        if (p[0] - pp[0], p[1] - pp[1]) != (pn[0] - p[0], pn[1] - p[1]):
            keep.append(p)
    return keep if keep else [pts[0]]


def find_contours(img: np.ndarray, mode: str = "list",
                  method: str = "simple"):
    """``cv2.findContours`` — returns ``(contours, hierarchy)`` with
    contours a list of int32 ``[N, 2]`` (x, y) arrays and hierarchy
    int32 ``[M, 4]`` (next, prev, first_child, parent), bit-exact
    vs cv2 5.0 in content, ORDER and hierarchy (fuzz per mode/method).

    Pinned structure: contours discovered in raster order; every
    sibling list is emitted in REVERSE discovery order; ``list`` is the
    flat reverse, ``tree`` a preorder DFS, ``ccomp`` flattens to two
    levels (every outer border at level 0 in reverse discovery, each
    followed by its holes), ``external`` keeps only frame-child outers.
    ``method``: "none" (every boundary pixel) or "simple" (cyclic
    direction-change corners, start kept).
    """
    if img.dtype != np.uint8:
        raise TypeError("findContours requires uint8 input")
    mode = mode.lower()
    method = method.lower()
    if mode not in ("list", "external", "ccomp", "tree"):
        raise ValueError(f"unknown mode {mode!r}")
    if method not in ("none", "simple"):
        raise ValueError(f"unknown method {method!r}")
    traced = _trace_contours(img)
    items = []   # (points, is_hole, parent_nbd, nbd)
    for pts, is_hole, parent, nbd in traced:
        if method == "simple":
            pts = _chain_simple(pts)
        items.append((pts, is_hole, parent, nbd))
    by_nbd = {it[3]: it for it in items}
    children = {}
    for it in items:
        children.setdefault(it[2], []).append(it[3])
    for k in children:
        children[k] = children[k][::-1]  # reverse discovery
    order = []
    parent_of = {}
    if mode == "list":
        order = [it[3] for it in items][::-1]
        parent_of = {nbd: None for nbd in order}
    elif mode == "external":
        order = children.get(1, [])
        order = [n for n in order if not by_nbd[n][1]]
        parent_of = {nbd: None for nbd in order}
    elif mode == "tree":
        def dfs(nbd):
            order.append(nbd)
            for c in children.get(nbd, []):
                parent_of[c] = nbd
                dfs(c)
        for top in children.get(1, []):
            parent_of[top] = None
            dfs(top)
    else:  # ccomp: all outers level 0 (reverse discovery), then holes
        outers = [it[3] for it in items if not it[1]][::-1]
        for o in outers:
            parent_of[o] = None
            order.append(o)
            for h in children.get(o, []):
                if by_nbd[h][1]:
                    parent_of[h] = o
                    order.append(h)
    idx = {nbd: k for k, nbd in enumerate(order)}
    M = len(order)
    hier = np.full((M, 4), -1, np.int32)
    # sibling chains per parent, in output order
    sib = {}
    for nbd in order:
        sib.setdefault(parent_of.get(nbd), []).append(nbd)
    for plist in sib.values():
        for a, b in zip(plist, plist[1:]):
            hier[idx[a], 0] = idx[b]
            hier[idx[b], 1] = idx[a]
    for nbd in order:
        p = parent_of.get(nbd)
        if p is not None:
            hier[idx[nbd], 3] = idx[p]
            if hier[idx[p], 2] < 0:
                hier[idx[p], 2] = idx[nbd]
    contours = [np.asarray(by_nbd[n][0], np.int32).reshape(-1, 2)
                for n in order]
    return contours, hier.reshape(M, 4)


def contour_area(points, oriented: bool = False) -> float:
    """``cv2.contourArea`` — Green's-theorem signed area, f64 edge
    cross products accumulated sequentially, ×0.5; |·| unless
    ``oriented`` (bit-exact vs cv2, int and f32 contours)."""
    pts = np.asarray(points).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return 0.0
    a00 = 0.0
    px, py = float(pts[-1, 0]), float(pts[-1, 1])
    for k in range(n):
        x, y = float(pts[k, 0]), float(pts[k, 1])
        a00 += px * y - py * x
        px, py = x, y
    a00 *= 0.5
    return a00 if oriented else abs(a00)


def arc_length(points, closed: bool) -> float:
    """``cv2.arcLength`` — per edge ``s = f32(f32(dx·dx) + f32(dy·dy))``
    on Point2f-cast coords, the square root taken in FLOAT (cv2 runs
    ``cv::sqrt`` over a buffered f32 array), f64 sum — bit-exact
    (0/100 probe configs)."""
    f32 = np.float32
    pts = np.asarray(points).reshape(-1, 2).astype(np.float32)
    n = len(pts)
    if n < 2:
        return 0.0
    total = 0.0
    rng_last = n if closed else n - 1
    for k in range(rng_last):
        p = pts[k]
        q = pts[(k + 1) % n]
        dx = f32(q[0] - p[0])
        dy = f32(q[1] - p[1])
        s = f32(f32(dx * dx) + f32(dy * dy))
        total += float(f32(np.sqrt(np.float64(s))))
    return total


def bounding_rect(points):
    """``cv2.boundingRect`` — (x, y, w, h); ints exact, floats via
    cvFloor/cvCeil per cv2."""
    pts = np.asarray(points).reshape(-1, 2)
    if np.issubdtype(pts.dtype, np.integer):
        x0, y0 = int(pts[:, 0].min()), int(pts[:, 1].min())
        x1, y1 = int(pts[:, 0].max()), int(pts[:, 1].max())
    else:
        x0 = int(np.floor(pts[:, 0].min()))
        y0 = int(np.floor(pts[:, 1].min()))
        x1 = int(np.ceil(pts[:, 0].max()))
        y1 = int(np.ceil(pts[:, 1].max()))
    return (x0, y0, x1 - x0 + 1, y1 - y0 + 1)


def contour_moments(points):
    """``cv2.moments`` on a CONTOUR (point list) — cv2's Green-formula
    closed forms (moments.cpp contourMoments), sequential f64 edge
    accumulation with the 1/2·1/6·1/12·1/20 scalings and the
    negative-area sign flip; central/normalized moments via the
    ``moments``-style completion.  Returns the dict of 24 cv2 keys."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float64)
    n = len(pts)
    a00 = a10 = a01 = a20 = a11 = a02 = a30 = a21 = a12 = a03 = 0.0
    xi_1, yi_1 = pts[-1]
    xi_12, yi_12 = xi_1 * xi_1, yi_1 * yi_1
    for k in range(n):
        xi, yi = pts[k]
        xi2, yi2 = xi * xi, yi * yi
        dxy = xi_1 * yi - xi * yi_1
        xii_1, yii_1 = xi_1 + xi, yi_1 + yi
        a00 += dxy
        a10 += dxy * xii_1
        a01 += dxy * yii_1
        a20 += dxy * (xi_1 * xii_1 + xi2)
        a11 += dxy * (xi_1 * (yii_1 + yi_1) + xi * (yii_1 + yi))
        a02 += dxy * (yi_1 * yii_1 + yi2)
        a30 += dxy * xii_1 * (xi_12 + xi2)
        a03 += dxy * yii_1 * (yi_12 + yi2)
        a21 += dxy * (xi_12 * (3 * yi_1 + yi) + 2 * xi * xi_1 * yii_1
                      + xi2 * (yi_1 + 3 * yi))
        a12 += dxy * (yi_12 * (3 * xi_1 + xi) + 2 * yi * yi_1 * xii_1
                      + yi2 * (xi_1 + 3 * xi))
        xi_1, yi_1 = xi, yi
        xi_12, yi_12 = xi2, yi2
    if abs(a00) > 1.19209289550781250000e-7:
        sgn = 1.0 if a00 > 0 else -1.0
        db1_2, db1_6, db1_12 = sgn * 0.5, sgn / 6, sgn / 12
        db1_20, db1_24, db1_60 = sgn * 0.05, sgn / 24, sgn / 60
        m = {
            "m00": a00 * db1_2,
            "m10": a10 * db1_6, "m01": a01 * db1_6,
            "m20": a20 * db1_12, "m11": a11 * db1_24,
            "m02": a02 * db1_12,
            "m30": a30 * db1_20, "m21": a21 * db1_60,
            "m12": a12 * db1_60, "m03": a03 * db1_20,
        }
    else:
        m = {k: 0.0 for k in ("m00", "m10", "m01", "m20", "m11", "m02",
                              "m30", "m21", "m12", "m03")}
    # cv2 Moments completion (inv_m00 = 0 on degenerate contours)
    inv_m00 = 0.0
    cx = cy = 0.0
    if abs(m["m00"]) > np.finfo(np.float64).eps:
        inv_m00 = 1.0 / m["m00"]
        cx, cy = m["m10"] * inv_m00, m["m01"] * inv_m00
    m["mu20"] = m["m20"] - m["m10"] * cx
    m["mu11"] = m["m11"] - m["m10"] * cy
    m["mu02"] = m["m02"] - m["m01"] * cy
    m["mu30"] = m["m30"] - cx * (3 * m["mu20"] + cx * m["m10"])
    m["mu21"] = (m["m21"] - cx * (2 * m["mu11"] + cx * m["m01"])
                 - cy * m["mu20"])
    m["mu12"] = (m["m12"] - cy * (2 * m["mu11"] + cy * m["m10"])
                 - cx * m["mu02"])
    m["mu03"] = m["m03"] - cy * (3 * m["mu02"] + cy * m["m01"])
    s2 = inv_m00 * inv_m00
    s3 = s2 * np.sqrt(abs(inv_m00))
    for k in ("mu20", "mu11", "mu02"):
        m["nu" + k[2:]] = m[k] * s2
    for k in ("mu30", "mu21", "mu12", "mu03"):
        m["nu" + k[2:]] = m[k] * s3
    return m


def _sklansky(ptr, pts, start, end, nsign, sign2):
    """cv2 ``Sklansky_`` — one hull chain over x-sorted point order."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[ptr[start]] == pts[ptr[end]]:
        return [start]
    stack = [pprev, pcur, pnext]
    end2 = end + incr

    def sign(v):
        return int(v > 0) - int(v < 0)

    while pnext != end2:
        cury = pts[ptr[pcur]][1]
        nexty = pts[ptr[pnext]][1]
        by = nexty - cury
        if sign(by) != nsign:
            ax = pts[ptr[pcur]][0] - pts[ptr[pprev]][0]
            bx = pts[ptr[pnext]][0] - pts[ptr[pcur]][0]
            ay = cury - pts[ptr[pprev]][1]
            convexity = ay * bx - ax * by
            if sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur, pnext = pcur, pnext, pnext + incr
                stack.append(pnext)
            else:
                if pprev == start:
                    pcur = pnext
                    stack[1] = pcur
                    pnext += incr
                    stack[2] = pnext
                else:
                    stack[-2] = pnext
                    pcur = pprev
                    pprev = stack[-4]
                    stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points, clockwise: bool = False,
                return_points: bool = True):
    """``cv2.convexHull`` — Sklansky chains over the x-then-y sorted
    order, cv2's upper/lower assembly with the pre-swap collinearity
    stop/check, and the ascending/descending cyclic rotation
    (``ascending ⇔ (max_idx+1) mod n == min_idx``).

    BIT-EXACT (indices and order) for point sets with DISTINCT points
    (0/~500 fuzz configs); with exactly duplicated points the output is
    the same hull polygon up to a cyclic rotation — the index choice
    among equal points follows the build's unstable ``std::sort``
    (docs/PARITY.md).  Integer and f32 point arrays."""
    arr = np.asarray(points).reshape(-1, 2)
    if np.issubdtype(arr.dtype, np.integer):
        pts = [(int(p[0]), int(p[1])) for p in arr]
    else:
        pts = [(np.float32(p[0]), np.float32(p[1])) for p in arr]
    total = len(pts)
    if total == 0:
        return (np.zeros((0, 2), arr.dtype) if return_points
                else np.zeros((0,), np.int32))
    ptr = sorted(range(total), key=lambda k: (pts[k][0], pts[k][1]))
    miny = maxy = 0
    for i in range(1, total):
        y = pts[ptr[i]][1]
        if pts[ptr[miny]][1] > y:
            miny = i
        if pts[ptr[maxy]][1] < y:
            maxy = i
    if pts[ptr[0]] == pts[ptr[total - 1]]:
        out = [ptr[0]]
    else:
        out = []
        tl0 = _sklansky(ptr, pts, 0, maxy, -1, 1)
        tr0 = _sklansky(ptr, pts, total - 1, maxy, -1, -1)
        tl, tr = (tr0, tl0) if not clockwise else (tl0, tr0)
        for i in range(len(tl) - 1):
            out.append(ptr[tl[i]])
        for i in range(len(tr) - 1, 0, -1):
            out.append(ptr[tr[i]])
        stop_idx = (tr0[1] if len(tr0) > 2 else
                    (tl0[len(tl0) - 2] if len(tl0) + len(tr0) > 2 else -1))
        bl0 = _sklansky(ptr, pts, 0, miny, 1, -1)
        br0 = _sklansky(ptr, pts, total - 1, miny, 1, 1)
        if stop_idx >= 0:
            check_idx = (bl0[1] if len(bl0) > 2 else
                         (br0[2 - len(bl0)]
                          if len(bl0) + len(br0) > 2 else -1))
            if check_idx == stop_idx or (
                    check_idx >= 0
                    and pts[ptr[check_idx]] == pts[ptr[stop_idx]]):
                # all points on one line: bottom part is empty
                bl0 = bl0[:2]
                br0 = br0[:2]
        bl, br = (br0, bl0) if clockwise else (bl0, br0)
        for i in range(len(bl) - 1):
            out.append(ptr[bl[i]])
        for i in range(len(br) - 1, 0, -1):
            out.append(ptr[br[i]])
        nout = len(out)
        if nout >= 3:
            min_idx = max_idx = 0
            lt = 0
            for i in range(1, nout):
                idx = out[i]
                lt += out[i - 1] < idx
                if out[min_idx] > idx:
                    min_idx = i
                if out[max_idx] < idx:
                    max_idx = i
            mm = abs(max_idx - min_idx)
            if (mm == 1 or mm == nout - 1) and (lt <= 1 or lt >= nout - 2):
                ascending = (max_idx + 1) % nout == min_idx
                i0 = min_idx if ascending else max_idx
                if i0 > 0:
                    j = i0
                    rot = []
                    ok = True
                    for i in range(nout):
                        rot.append(out[j])
                        nj = j + 1 if j + 1 < nout else 0
                        if i < nout - 1 and (ascending != (out[j] < out[nj])):
                            ok = False
                            break
                        j = nj
                    if ok:
                        out = rot
    if return_points:
        return arr[np.asarray(out, np.int64)].reshape(-1, 2)
    return np.asarray(out, np.int32)


def is_contour_convex(points) -> bool:
    """``cv2.isContourConvex`` — orientation-flip scan over the closed
    curve (both cross-product signs seen → not convex)."""
    pts = np.asarray(points).reshape(-1, 2)
    n = len(pts)
    if n == 0:
        return False
    if np.issubdtype(pts.dtype, np.integer):
        P = [(int(p[0]), int(p[1])) for p in pts]
    else:
        P = [(np.float32(p[0]), np.float32(p[1])) for p in pts]
    prev = P[n - 2] if n >= 2 else P[0]
    cur = P[n - 1]
    dx0 = cur[0] - prev[0]
    dy0 = cur[1] - prev[1]
    orientation = 0
    for i in range(n):
        prev = cur
        cur = P[i]
        dx = cur[0] - prev[0]
        dy = cur[1] - prev[1]
        dxdy0 = dx * dy0
        dydx0 = dy * dx0
        orientation |= 2 if dydx0 > dxdy0 else (1 if dydx0 < dxdy0 else 3)
        if orientation == 3:
            return False
        dx0 = dx
        dy0 = dy
    return True


def point_polygon_test(contour, pt, measure_dist: bool = False) -> float:
    """``cv2.pointPolygonTest`` — exact crossing counter (+1/-1/0) for
    the no-distance form; signed min edge distance (f64) otherwise."""
    pts = np.asarray(contour).reshape(-1, 2)
    n = len(pts)
    is_int = (np.issubdtype(pts.dtype, np.integer)
              and float(pt[0]) == int(pt[0]) and float(pt[1]) == int(pt[1]))
    if not measure_dist and is_int:
        ipx, ipy = int(pt[0]), int(pt[1])
        P = [(int(p[0]), int(p[1])) for p in pts]
        counter = 0
        v0 = P[n - 1]
        for i in range(n):
            v = P[i]
            if (v0[1] <= ipy < v[1]) or (v[1] <= ipy < v0[1]):
                dist = ((ipy - v0[1]) * (v[0] - v0[0])
                        - (ipx - v0[0]) * (v[1] - v0[1]))
                if dist == 0:
                    return 0.0
                if (dist > 0) != (v[1] > v0[1]):
                    counter += 1
            elif v0[1] == ipy and v[1] == ipy:
                if ((v0[0] <= ipx <= v[0]) or (v[0] <= ipx <= v0[0])):
                    return 0.0
            elif (v0[1] == ipy and v0[0] == ipx) or \
                    (v[1] == ipy and v[0] == ipx):
                return 0.0
            v0 = v
        return -1.0 if counter % 2 == 0 else 1.0
    P = pts.astype(np.float64)
    px, py = float(pt[0]), float(pt[1])
    min_dist_sq = np.inf
    counter = 0
    v0 = P[n - 1]
    for i in range(n):
        v = P[i]
        if (v0[1] <= py < v[1]) or (v[1] <= py < v0[1]):
            dist = ((py - v0[1]) * (v[0] - v0[0])
                    - (px - v0[0]) * (v[1] - v0[1]))
            if (dist > 0) != (v[1] > v0[1]) and dist != 0:
                counter += 1
        dx, dy = v[0] - v0[0], v[1] - v0[1]
        dx1, dy1 = px - v0[0], py - v0[1]
        dx2, dy2 = px - v[0], py - v[1]
        if dx1 * dx + dy1 * dy <= 0:
            d = dx1 * dx1 + dy1 * dy1
        elif dx2 * dx + dy2 * dy >= 0:
            d = dx2 * dx2 + dy2 * dy2
        else:
            t = dx1 * dy - dy1 * dx
            d = t * t / (dx * dx + dy * dy)
        min_dist_sq = min(min_dist_sq, d)
        v0 = v
    dist = np.sqrt(min_dist_sq)
    if dist == 0:
        return 0.0
    inside = counter % 2 == 1
    if not measure_dist:
        return 1.0 if inside else -1.0
    return dist if inside else -dist


def convexity_defects(contour, hull_indices) -> np.ndarray:
    """``cv2.convexityDefects`` — [N, 4] int32
    (start_idx, end_idx, farthest_idx, fixpt_depth = cvRound(d·256)).
    cv2's exact convention: hull/contour co-orientation via
    ``((h1>h0)+(h2>h1)+(h0>h2)) != 2``, cyclic edge pairs starting at
    the ascending-order last vertex, STRICT depth maxima in f64 with
    the 1/sqrt edge normalization (bit-exact, 1661-contour fuzz)."""
    pts = np.asarray(contour).reshape(-1, 2).astype(np.int64)
    hull = [int(v) for v in np.asarray(hull_indices).reshape(-1)]
    n = len(pts)
    m = len(hull)
    if m < 3:
        return np.zeros((0, 4), np.int32)
    rev = ((hull[1] > hull[0]) + (hull[2] > hull[1])
           + (hull[0] > hull[2])) != 2
    out = []
    hcurr = hull[0] if rev else hull[m - 1]
    for i in range(m):
        hnext = hull[m - i - 1] if rev else hull[i]
        x0, y0 = pts[hcurr]
        x1, y1 = pts[hnext]
        dx0 = float(x1 - x0)
        dy0 = float(y1 - y0)
        scale = 0.0 if dx0 == 0 and dy0 == 0 else \
            1.0 / np.sqrt(dx0 * dx0 + dy0 * dy0)
        deepest = -1
        depth = 0.0
        is_defect = False
        j = hcurr
        while True:
            j = (j + 1) % n
            if j == hnext:
                break
            dx = float(pts[j][0] - x0)
            dy = float(pts[j][1] - y0)
            dist = abs(-dy0 * dx + dx0 * dy) * scale
            if dist > depth:
                depth = dist
                deepest = j
                is_defect = True
        if is_defect:
            out.append([hcurr, hnext, deepest,
                        int(np.rint(depth * 256.0))])
        hcurr = hnext
    return np.asarray(out, np.int32).reshape(-1, 4)


def approx_poly_dp(curve, epsilon, closed):
    """``cv2.approxPolyDP`` — BIT-EXACT vs cv2 5.0 (0/10584 int +
    0/1200 f32 fuzz configs).

    cv2 5.0 changed the law: the recursion rejects by squared
    DISTANCE-TO-SEGMENT (endpoint Euclidean outside the perpendicular
    band) compared directly against eps² — NOT the classic
    cross-product-vs-chord test (probed: a point past the chord end
    collapses at eps = its endpoint distance, not its line distance).
    The slice bookkeeping matches the classic implementation: the
    3-pass approximate-farthest-pair initializer for closed curves,
    LIFO slice stack, strict > farthest selection, and the final
    collinearity cleanup pass with the 0.5·eps²·len² rule.
    """
    src = np.asarray(curve).reshape(-1, 2)
    is_int = np.issubdtype(src.dtype, np.integer)
    pts = [(float(p[0]), float(p[1])) for p in src]
    count0 = count = len(pts)
    if count == 0:
        return src[:0]
    eps = float(epsilon)
    eps *= eps
    init_iters = 3
    is_closed = bool(closed)
    stack = []
    dst = [None] * (count + 8)
    new_count = 0
    pos = 0
    le_eps = False
    rs_start = 0

    def read_pt(pos):
        pt = pts[pos]
        pos += 1
        if pos >= count:
            pos = 0
        return pt, pos

    if not is_closed:
        end_pt = pts[0]
        start_pt = pts[count - 1]
        if start_pt != end_pt:
            stack.append((0, count - 1))
        else:
            is_closed = True
            init_iters = 1

    if is_closed:
        rs_start = 0
        for i in range(init_iters):
            max_dist = 0.0
            pos = (pos + rs_start) % count
            start_pt, pos = read_pt(pos)
            for j in range(1, count):
                pt, pos = read_pt(pos)
                dx = pt[0] - start_pt[0]
                dy = pt[1] - start_pt[1]
                dist = dx * dx + dy * dy
                if dist > max_dist:
                    max_dist = dist
                    rs_start = j
            le_eps = max_dist <= eps
        if not le_eps:
            rs_end = slice_start = pos % count
            slice_end = rs_start = (rs_start + slice_start) % count
            stack.append((rs_start, rs_end))
            stack.append((slice_start, slice_end))
        else:
            dst[new_count] = pts[pos]; new_count += 1

    while stack:
        slice_start, slice_end = stack.pop()
        end_pt = pts[slice_end]
        pos = slice_start
        start_pt, pos = read_pt(pos)
        if pos != slice_end:
            max_dist = 0.0
            dx = end_pt[0] - start_pt[0]
            dy = end_pt[1] - start_pt[1]
            L = dx * dx + dy * dy
            while pos != slice_end:
                pt, pos = read_pt(pos)
                dx1 = pt[0] - start_pt[0]
                dy1 = pt[1] - start_pt[1]
                t = dx1 * dx + dy1 * dy
                if t <= 0 or L == 0:
                    dist = dx1 * dx1 + dy1 * dy1
                elif t >= L:
                    dx2 = pt[0] - end_pt[0]
                    dy2 = pt[1] - end_pt[1]
                    dist = dx2 * dx2 + dy2 * dy2
                else:
                    c = dx1 * dy - dy1 * dx
                    dist = c * c / L
                if dist > max_dist:
                    max_dist = dist
                    rs_start = (pos + count - 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
            start_pt = pts[slice_start]
        if le_eps:
            dst[new_count] = start_pt; new_count += 1
        else:
            stack.append((rs_start, slice_end))
            stack.append((slice_start, rs_start))

    if not is_closed:
        dst[new_count] = pts[count - 1]; new_count += 1

    # final cleanup
    is_closed = bool(closed)
    count = new_count
    if count > 0:
        pos = count - 1 if is_closed else 0
        def read_dst(pos):
            pt = dst[pos]
            pos += 1
            if pos >= count:
                pos = 0
            return pt, pos
        start_pt, pos = read_dst(pos)
        wpos = pos
        pt, pos = read_dst(pos)
        i = 0 if is_closed else 1
        limit = count - (0 if is_closed else 1)
        while i < limit and new_count > 2:
            end_pt, pos = read_dst(pos)
            dx = end_pt[0] - start_pt[0]
            dy = end_pt[1] - start_pt[1]
            dist = abs((pt[0] - start_pt[0]) * dy
                       - (pt[1] - start_pt[1]) * dx)
            sip = ((pt[0] - start_pt[0]) * (end_pt[0] - pt[0])
                   + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1]))
            if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy)
                    and dx != 0 and dy != 0 and sip >= 0):
                new_count -= 1
                dst[wpos] = start_pt = end_pt
                wpos += 1
                if wpos >= count:
                    wpos = 0
                pt, pos = read_dst(pos)
                i += 2
                continue
            dst[wpos] = start_pt = pt
            wpos += 1
            if wpos >= count:
                wpos = 0
            pt = end_pt
            i += 1
        if not is_closed:
            dst[wpos] = pt

    out = dst[:new_count]
    arr = np.asarray(out, np.float64)
    if is_int:
        return np.asarray(np.rint(arr), np.int32)
    return arr.astype(np.float32)


def min_area_rect(points):
    """``cv2.minAreaRect`` — rotating calipers over the convex hull
    (f64 re-derivation).  Returns ``((cx, cy), (w, h), angle)`` in
    cv2's convention (angle ∈ (-90, 0] measured from the horizontal to
    the first box edge, width = that edge's extent).  Float-tolerance
    tier: the rectangle agrees with cv2 to ≤1e-3 px on corners (cv2
    computes the caliper chain in f32; docs/PARITY.md)."""
    hull = convex_hull(points).astype(np.float64)
    n = len(hull)
    if n == 0:
        return ((0.0, 0.0), (0.0, 0.0), 0.0)
    if n == 1:
        return ((float(hull[0, 0]), float(hull[0, 1])), (0.0, 0.0), 0.0)
    if n == 2:
        c = hull.mean(0)
        d = hull[1] - hull[0]
        w = float(np.hypot(*d))
        ang = float(np.degrees(np.arctan2(d[1], d[0])))
        return ((float(c[0]), float(c[1])), (w, 0.0), ang)
    best = None
    for i in range(n):
        a = hull[i]
        b = hull[(i + 1) % n]
        e = b - a
        L = np.hypot(*e)
        if L == 0:
            continue
        ux, uy = e / L
        # project hull on (u, perp)
        px = hull[:, 0] * ux + hull[:, 1] * uy
        py = -hull[:, 0] * uy + hull[:, 1] * ux
        w = px.max() - px.min()
        h = py.max() - py.min()
        area = w * h
        if best is None or area < best[0]:
            cx_r = (px.max() + px.min()) * 0.5
            cy_r = (py.max() + py.min()) * 0.5
            cx = cx_r * ux - cy_r * uy
            cy = cx_r * uy + cy_r * ux
            best = (area, cx, cy, w, h, np.degrees(np.arctan2(uy, ux)))
    _, cx, cy, w, h, ang = best
    # canonicalize to cv2's convention: angle in (-90, 0]
    ang = ang % 180.0
    if ang > 90.0:
        ang -= 180.0
    if ang > 0.0:
        ang -= 90.0
        w, h = h, w
    if ang <= -90.0:
        ang += 90.0
        w, h = h, w
    if ang == 0.0:
        ang = -90.0
        w, h = h, w
    return ((float(cx), float(cy)), (float(w), float(h)), float(ang))


def box_points(rect):
    """``cv2.boxPoints`` — the 4 corners of a rotated rect, cv2's
    corner order (starting from the 'lowest' corner, clockwise in
    image coords)."""
    (cx, cy), (w, h), ang = rect
    a = np.deg2rad(ang)
    b_cos, b_sin = np.cos(a) * 0.5, np.sin(a) * 0.5
    pts = np.array([
        [cx - b_sin * h - b_cos * w, cy + b_cos * h - b_sin * w],
        [cx + b_sin * h - b_cos * w, cy - b_cos * h - b_sin * w],
        [cx + b_sin * h + b_cos * w, cy - b_cos * h + b_sin * w],
        [cx - b_sin * h + b_cos * w, cy + b_cos * h + b_sin * w],
    ], np.float32)
    return pts


def min_enclosing_circle(points):
    """``cv2.minEnclosingCircle`` — Welzl's exact minimal disc in f64.
    Float-tolerance tier (cv2 runs a f32 support-point scheme; center/
    radius agree to ≤1e-3; docs/PARITY.md)."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float64)
    n = len(pts)
    if n == 0:
        return ((0.0, 0.0), 0.0)

    def circ2(a, b):
        c = (a + b) * 0.5
        return c, np.hypot(*(a - c))

    def circ3(a, b, c):
        ax, ay = a
        bx, by = b
        cx, cy = c
        d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
        if abs(d) < 1e-12:
            return None
        ux = ((ax * ax + ay * ay) * (by - cy) + (bx * bx + by * by)
              * (cy - ay) + (cx * cx + cy * cy) * (ay - by)) / d
        uy = ((ax * ax + ay * ay) * (cx - bx) + (bx * bx + by * by)
              * (ax - cx) + (cx * cx + cy * cy) * (bx - ax)) / d
        cen = np.array([ux, uy])
        return cen, np.hypot(*(a - cen))

    def inside(c, r, p, eps=1e-7):
        return np.hypot(*(p - c)) <= r + eps * max(1.0, r)

    # deterministic Welzl (move-to-front, fixed order)
    def md(ps, boundary):
        if len(boundary) == 3:
            res = circ3(*boundary)
            if res is not None:
                return res
        c, r = (np.array([0.0, 0.0]), -1.0)
        if len(boundary) == 1:
            c, r = boundary[0].copy(), 0.0
        elif len(boundary) == 2:
            c, r = circ2(*boundary)
        for i, p in enumerate(ps):
            if r < 0 or not inside(c, r, p):
                if len(boundary) < 3:
                    c, r = md(ps[:i], boundary + [p])
        return c, r

    c, r = md(list(pts), [])
    return ((float(c[0]), float(c[1])), float(r))


def _fitline_wods(pts, w):
    x = float((w * pts[:, 0]).sum())
    y = float((w * pts[:, 1]).sum())
    x2 = float((w * pts[:, 0] * pts[:, 0]).sum())
    y2 = float((w * pts[:, 1] * pts[:, 1]).sum())
    xy = float((w * pts[:, 0] * pts[:, 1]).sum())
    ws = float(w.sum())
    x /= ws
    y /= ws
    x2 /= ws
    y2 /= ws
    xy /= ws
    dx2 = x2 - x * x
    dy2 = y2 - y * y
    dxy = xy - x * y
    t = np.float32(np.arctan2(2 * dxy, dx2 - dy2)) / np.float32(2)
    return np.array([np.float32(np.cos(t)), np.float32(np.sin(t)),
                     np.float32(x), np.float32(y)], np.float32)


def fit_line(points, dist_type: str = "l2", param: float = 0.0,
             reps: float = 0.01, aeps: float = 0.01):
    """``cv2.fitLine`` (2-D).  L2 is the closed-form weighted-moments
    fit — agrees with cv2 to ~1e-6.  Robust types run the same
    20-attempt scheme as fitline.cpp (10 random support points from a
    local deterministic MWC stream, ≤30 IRLS rounds with cv2's weight
    laws, keep the min-L1 attempt); on well-conditioned near-linear
    data the result agrees with cv2 to ≤~0.3 in direction/anchor, but
    on MULTI-MODAL scatter the IRLS may settle in a different local
    fixpoint than cv2's (probed: no candidate start reproduces cv2's
    basin — some fitline.cpp micro-detail remains unpinned;
    docs/PARITY.md documents this as an approximation row).
    Returns (vx, vy, x0, y0) f32."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float32)
    n = len(pts)
    d = dist_type.lower()
    dists = {"l2": 2, "l1": 1, "l12": 4, "fair": 5, "welsch": 6,
             "huber": 7}
    if d not in dists:
        raise ValueError(f"unknown dist_type {dist_type!r}")
    ptsd = pts.astype(np.float64)
    if d == "l2":
        line = _fitline_wods(ptsd, np.ones(n))
        return tuple(np.float32(v) for v in line)
    C = {"l1": 0.0, "l12": 0.0,
         "fair": param if param > 0 else 1.3998,
         "welsch": param if param > 0 else 2.9846,
         "huber": param if param > 0 else 1.345}[d]

    def calc_w(r):
        r = r.astype(np.float64)
        if d == "l1":
            return (1.0 / np.maximum(r, np.finfo(np.float64).eps)
                    ).astype(np.float32)
        if d == "l12":
            return (1.0 / np.sqrt(1 + r * r * 0.5)).astype(np.float32)
        if d == "fair":
            return (1.0 / (1 + r / C)).astype(np.float32)
        if d == "welsch":
            return np.exp(-r * r / (2 * C * C)).astype(np.float32)
        return np.where(r < C, 1.0, C / np.maximum(r, 1e-300)
                        ).astype(np.float32)

    EPS = n * np.finfo(np.float32).eps
    rdelta = reps if reps != 0 else 1.0
    adelta = aeps if aeps != 0 else 0.01
    rng = _CvRNG()
    min_err = np.inf
    best = np.zeros(4, np.float32)
    for k in range(20):
        w = np.zeros(n, np.float32)
        i = 0
        while i < min(n, 10):
            j = rng.uniform_int(0, n)
            if w[j] < np.finfo(np.float32).eps:
                w[j] = 1.0
                i += 1
        line = _fitline_wods(ptsd, w.astype(np.float64))
        lineprev = line.copy()
        first = True
        err = 0.0
        for it in range(30):
            if not first:
                t = float(line[0]) * float(lineprev[0]) \
                    + float(line[1]) * float(lineprev[1])
                t = min(max(t, -1.0), 1.0)
                if abs(np.arccos(t)) < adelta:
                    dx = abs(np.float32(line[2] - lineprev[2]))
                    dy = abs(np.float32(line[3] - lineprev[3]))
                    if max(dx, dy) < rdelta:
                        break
            first = False
            nx, ny = np.float32(line[1]), np.float32(-line[0])
            r = np.abs(nx * (pts[:, 0] - np.float32(line[2]))
                       + ny * (pts[:, 1] - np.float32(line[3])))
            err = float(r.astype(np.float64).sum())
            if err < EPS:
                break
            w = calc_w(r)
            sw = float(w.astype(np.float64).sum())
            if abs(sw) > np.finfo(np.float32).eps:
                w = (w.astype(np.float64) / sw).astype(np.float32)
            else:
                w = np.ones(n, np.float32)
            lineprev = line.copy()
            line = _fitline_wods(ptsd, w.astype(np.float64))
        if err < min_err:
            min_err = err
            best = line.copy()
            if err < EPS:
                break
    return tuple(np.float32(v) for v in best)


def fit_ellipse(points):
    """``cv2.fitEllipse`` — cv2's normalized direct least squares
    (centered/scaled design matrix, SVD solve).  Float-tolerance tier:
    center/axes ≤1e-2 px, angle ≤0.1° mod 180 on non-degenerate
    samples (docs/PARITY.md).  Returns ((cx, cy), (w, h), angle)."""
    pts = np.asarray(points).reshape(-1, 2).astype(np.float64)
    n = len(pts)
    if n < 5:
        raise ValueError("fitEllipse needs >= 5 points")
    c = pts.mean(0)
    s = np.abs(pts - c).mean() or 1.0
    q = (pts - c) / s
    x, y = q[:, 0], q[:, 1]
    A = np.stack([x * x, x * y, y * y, x, y, np.ones(n)], 1)
    _, _, vt = np.linalg.svd(A, full_matrices=False)
    a, b, cc, dd, ee, ff = vt[-1]
    # unscale: x = (X-cx)/s
    A2 = a
    B2 = b
    C2 = cc
    D2 = (dd * s - 2 * a * c[0] - b * c[1])
    E2 = (ee * s - 2 * cc * c[1] - b * c[0])
    F2 = (a * c[0] ** 2 + b * c[0] * c[1] + cc * c[1] ** 2
          - dd * s * c[0] - ee * s * c[1] + ff * s * s)
    den = 4 * A2 * C2 - B2 * B2
    if den == 0:
        raise ValueError("degenerate ellipse")
    cx = (B2 * E2 - 2 * C2 * D2) / den
    cy = (B2 * D2 - 2 * A2 * E2) / den
    Fc = (A2 * cx * cx + B2 * cx * cy + C2 * cy * cy
          + D2 * cx + E2 * cy + F2)
    M = np.array([[A2, B2 / 2], [B2 / 2, C2]]) / (-Fc)
    evals, evecs = np.linalg.eigh(M)
    axes = 2.0 / np.sqrt(np.abs(evals))
    # cv2 convention: (width, height) with angle of the SECOND axis
    v = evecs[:, 1]
    ang = np.degrees(np.arctan2(v[1], v[0])) % 180.0
    w_ax, h_ax = float(axes[1]), float(axes[0])
    if w_ax > h_ax:
        w_ax, h_ax = h_ax, w_ax
        ang = (ang + 90.0) % 180.0
    return ((float(cx), float(cy)), (w_ax, h_ax), float(ang))


def moments(img: np.ndarray, binary_image: bool = False) -> dict:
    """``cv2.moments`` on a grayscale image — EXACT (f64 polynomial
    sums; raw m, central mu, normalized nu keys like cv2)."""
    I = np.asarray(img, np.float64)
    if I.ndim != 2:
        raise ValueError("moments expects a single-channel image")
    if binary_image:
        I = (I != 0).astype(np.float64)
    H, W = I.shape
    x = np.arange(W, dtype=np.float64)
    y = np.arange(H, dtype=np.float64)
    m = {}
    for p in range(4):
        for q in range(4):
            if p + q <= 3:
                m[f"m{p}{q}"] = float(((x ** p)[None, :] * (y ** q)[:, None]
                                       * I).sum())
    # cv2 Moments completion (inv_m00 = 0 on degenerate contours)
    inv_m00 = 0.0
    cx = cy = 0.0
    if abs(m["m00"]) > np.finfo(np.float64).eps:
        inv_m00 = 1.0 / m["m00"]
        cx, cy = m["m10"] * inv_m00, m["m01"] * inv_m00
    m["mu20"] = m["m20"] - m["m10"] * cx
    m["mu11"] = m["m11"] - m["m10"] * cy
    m["mu02"] = m["m02"] - m["m01"] * cy
    m["mu30"] = m["m30"] - cx * (3 * m["mu20"] + cx * m["m10"])
    m["mu21"] = (m["m21"] - cx * (2 * m["mu11"] + cx * m["m01"])
                 - cy * m["mu20"])
    m["mu12"] = (m["m12"] - cy * (2 * m["mu11"] + cy * m["m10"])
                 - cx * m["mu02"])
    m["mu03"] = m["m03"] - cy * (3 * m["mu02"] + cy * m["m01"])
    s2 = inv_m00 * inv_m00
    s3 = s2 * np.sqrt(abs(inv_m00))
    for k in ("mu20", "mu11", "mu02"):
        m["nu" + k[2:]] = m[k] * s2
    for k in ("mu30", "mu21", "mu12", "mu03"):
        m["nu" + k[2:]] = m[k] * s3
    return m


def hu_moments(m) -> np.ndarray:
    """``cv2.HuMoments`` — the seven invariants from normalized central
    moments (exact closed forms)."""
    if isinstance(m, np.ndarray):
        raise TypeError("pass the moments dict from moments()")
    n20, n11, n02 = m["nu20"], m["nu11"], m["nu02"]
    n30, n21, n12, n03 = m["nu30"], m["nu21"], m["nu12"], m["nu03"]
    t0 = n30 + n12
    t1 = n21 + n03
    q0 = t0 * t0
    q1 = t1 * t1
    h = np.empty(7)
    h[0] = n20 + n02
    h[1] = (n20 - n02) ** 2 + 4 * n11 * n11
    h[2] = (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2
    h[3] = q0 + q1
    h[4] = ((n30 - 3 * n12) * t0 * (q0 - 3 * q1)
            + (3 * n21 - n03) * t1 * (3 * q0 - q1))
    h[5] = (n20 - n02) * (q0 - q1) + 4 * n11 * t0 * t1
    h[6] = ((3 * n21 - n03) * t0 * (q0 - 3 * q1)
            - (n30 - 3 * n12) * t1 * (3 * q0 - q1))
    return h.reshape(7, 1)


def match_shapes(a: np.ndarray, b: np.ndarray, method: str = "i1") -> float:
    """``cv2.matchShapes`` on grayscale images — the log-Hu distances
    (methods I1/I2/I3; cv2's eps gate ``|h| > 1e-5 … > eps`` model,
    including matchcontours.cpp's anyA!=anyB → DBL_MAX degenerate rule:
    if exactly one side has all-zero Hu moments the shapes are maximally
    dissimilar, not a perfect match)."""
    if method not in ("i1", "i2", "i3"):
        raise ValueError(f"method must be i1/i2/i3, got {method!r}")
    ha = hu_moments(moments(a)).ravel()
    hb = hu_moments(moments(b)).ravel()
    eps = 1.0e-5
    total = 0.0
    any_a = any_b = False
    for va, vb in zip(ha, hb):
        ama, amb = abs(va), abs(vb)
        any_a = any_a or ama > eps
        any_b = any_b or amb > eps
        if ama > eps and amb > eps:
            sa = -np.copysign(1.0, va) * np.log10(ama)
            sb = -np.copysign(1.0, vb) * np.log10(amb)
            if method == "i1":
                total += abs(1.0 / sa - 1.0 / sb)
            elif method == "i2":
                total += abs(sa - sb)
            else:
                total = max(total, abs(sa - sb) / abs(sa))
    if any_a != any_b:
        return float(np.finfo(np.float64).max)  # cv2: DBL_MAX
    return float(total)
