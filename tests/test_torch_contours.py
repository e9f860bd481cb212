"""The contour, shape-descriptor, moment and Gabor host helpers of the port
(utils/contours_host.py, utils/taps.py::gabor_kernel and their api
wrappers) against the NumPy oracle ref/ (bit for bit: every output equal,
floats compared as equal values) and cv2, over the fuzz cases of
tests/test_contours.py, tests/test_moments.py and tests/test_features.py.
The api takes tensors as well as arrays: both give the oracle's result."""

import numpy as np
import pytest
import torch
from detseed import seed

import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu_torch.utils import contours_host
from imageenhancement_mp_tpu_torch.utils.taps import gabor_kernel

cv2 = pytest.importorskip("cv2")
cv2.setNumThreads(1)

_MODES = {"list": cv2.RETR_LIST, "external": cv2.RETR_EXTERNAL,
          "ccomp": cv2.RETR_CCOMP, "tree": cv2.RETR_TREE}
_METH = {"none": cv2.CHAIN_APPROX_NONE, "simple": cv2.CHAIN_APPROX_SIMPLE}


def _blob(rng, lo=8, hi=70):
    """tests/test_contours.py's blobs: blurred noise thresholded to 0/255."""
    H, W = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
    k = int(rng.choice([3, 5, 9]))
    return (cv2.GaussianBlur(rng.integers(0, 256, (H, W), np.uint8),
                             (k, k), 0)
            > int(rng.integers(100, 160))).astype(np.uint8) * 255


def _equal(a, b):
    """Equal results: arrays of one dtype and equal elements, tuples and
    dicts elementwise, floats as values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)
    return True


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("method", sorted(_METH))
def test_find_contours_bitwise(mode, method):
    """tests/test_contours.py::test_find_contours_bitwise's cases (its seed,
    25 blobs): content, order and hierarchy equal cv2 and ref/."""
    rng = np.random.default_rng(seed("fc", mode, method))
    for t in range(25):
        img = _blob(rng)
        cs, h = cv2.findContours(img, _MODES[mode], _METH[method])
        h = h.reshape(-1, 4) if h is not None else np.zeros((0, 4), np.int32)
        gc, gh = tie.find_contours(torch.from_numpy(img) if t % 2 else img, mode, method)
        assert len(gc) == len(cs)
        assert np.array_equal(gh, h)
        for a, b in zip(cs, gc):
            assert np.array_equal(a.reshape(-1, 2), b)
        _equal((gc, gh), ref.find_contours(img, mode, method))


def test_descriptors_bitwise():
    """tests/test_contours.py::test_descriptors_bitwise's contours: area,
    length, bounding box, convexity, moments, point tests and defects equal
    cv2 (within its budgets for the moments and distances) and ref/."""
    rng = np.random.default_rng(seed("fc-desc"))
    n_def = 0
    for _ in range(30):
        img = _blob(rng)
        cs, _ = cv2.findContours(img, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
        for c in cs:
            c2 = c.reshape(-1, 2)
            ct = torch.from_numpy(c2)
            assert tie.contour_area(c2) == cv2.contourArea(c) == ref.contour_area(c2)
            assert tie.contour_area(ct, True) == cv2.contourArea(c, True)
            for closed in (True, False):
                assert tie.arc_length(ct, closed) == cv2.arcLength(c, closed)
                assert tie.arc_length(c2, closed) == ref.arc_length(c2, closed)
            assert tie.bounding_rect(ct) == tuple(cv2.boundingRect(c)) == ref.bounding_rect(c2)
            assert tie.is_contour_convex(ct) == bool(cv2.isContourConvex(c))
            assert tie.is_contour_convex(c2) == ref.is_contour_convex(c2)
            mw = cv2.moments(c)
            mg = tie.contour_moments(ct)
            _equal(mg, ref.contour_moments(c2))
            for k, v in mw.items():
                assert abs(mg[k] - v) <= max(1e-8, 1e-11 * abs(v)), (k, v)
            for _ in range(3):
                p = (int(rng.integers(0, img.shape[1])),
                     int(rng.integers(0, img.shape[0])))
                assert (tie.point_polygon_test(ct, p, False)
                        == cv2.pointPolygonTest(c, p, False)
                        == ref.point_polygon_test(c2, p, False))
                dw = cv2.pointPolygonTest(c, p, True)
                d = tie.point_polygon_test(c2, p, True)
                assert d == ref.point_polygon_test(c2, p, True)
                assert abs(d - dw) <= 1e-9 * max(1, abs(dw))
            if len(c2) >= 4:
                hull = cv2.convexHull(c, returnPoints=False)
                try:
                    w = cv2.convexityDefects(c, hull)
                except cv2.error:
                    continue
                w = (w.reshape(-1, 4) if w is not None
                     else np.zeros((0, 4), np.int32))
                g = tie.convexity_defects(ct, torch.from_numpy(hull.reshape(-1)))
                assert np.array_equal(g, w)
                _equal(g, ref.convexity_defects(c2, hull.reshape(-1)))
                n_def += len(w)
    assert n_def > 50  # the fuzz exercised defects


@pytest.mark.parametrize("dt", ["int", "float"])
def test_convex_hull_distinct_bitwise(dt):
    rng = np.random.default_rng(seed("fc-hull", dt))
    for _ in range(60):
        n = int(rng.integers(3, 80))
        if dt == "int":
            base = rng.permutation(400 * 400)[:n]
            pts = np.stack([base % 400, base // 400], 1).astype(np.int32)
        else:
            pts = (rng.random((n, 2)) * 300).astype(np.float32)
        for cw in (False, True):
            want_i = cv2.convexHull(pts.reshape(-1, 1, 2), clockwise=cw,
                                    returnPoints=False).reshape(-1)
            want_p = cv2.convexHull(pts.reshape(-1, 1, 2),
                                    clockwise=cw).reshape(-1, 2)
            got_i = tie.convex_hull(torch.from_numpy(pts), cw, return_points=False)
            got_p = tie.convex_hull(pts, cw)
            assert np.array_equal(got_i, want_i), (n, cw)
            assert np.array_equal(got_p, want_p), (n, cw)
            _equal(got_i, ref.convex_hull(pts, cw, return_points=False))
            _equal(got_p, ref.convex_hull(pts, cw))


def test_convex_hull_duplicates_same_polygon():
    """Exact duplicates: the same polygon as cv2 up to a cyclic rotation,
    and ref/'s output exactly."""
    rng = np.random.default_rng(seed("fc-hull-dup"))
    for _ in range(40):
        n = int(rng.integers(4, 60))
        pts = rng.integers(0, 8, (n, 2)).astype(np.int32)
        for cw in (False, True):
            want = cv2.convexHull(pts.reshape(-1, 1, 2),
                                  clockwise=cw).reshape(-1, 2).tolist()
            got = tie.convex_hull(pts, cw)
            _equal(got, ref.convex_hull(pts, cw))
            got = got.tolist()
            assert len(got) == len(want)
            assert any(got[k:] + got[:k] == want for k in range(len(got)))


def test_segmentation_chain():
    """The port's Otsu threshold on a CPU tensor → find_contours →
    descriptors, against cv2 end to end."""
    rng = np.random.default_rng(seed("fc-chain"))
    img = cv2.GaussianBlur(rng.integers(0, 256, (60, 80), np.uint8), (9, 9), 0)
    _, binary = tie.threshold(torch.from_numpy(img), method="otsu")
    _, want_bin = cv2.threshold(img, 0, 255, cv2.THRESH_BINARY | cv2.THRESH_OTSU)
    np.testing.assert_array_equal(binary.numpy(), want_bin)
    want_cs, _ = cv2.findContours(want_bin, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    got_cs, _ = tie.find_contours(binary, "external", "simple")
    assert len(got_cs) == len(want_cs) > 0
    for a, b in zip(want_cs, got_cs):
        assert np.array_equal(a.reshape(-1, 2), b)
        assert tie.contour_area(b) == cv2.contourArea(a)


@pytest.mark.parametrize("dt", ["int", "float"])
def test_approx_poly_dp_bitwise(dt):
    rng = np.random.default_rng(seed("fc-approx", dt))
    for _ in range(25):
        if dt == "int":
            img = _blob(rng)
            cs, _ = cv2.findContours(img, cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE)
            curves = [c.reshape(-1, 2) for c in cs]
        else:
            n = int(rng.integers(3, 50))
            curves = [(rng.random((n, 2)) * 100).astype(np.float32)]
        for c in curves:
            for ep in (0.5, 1.0, 3.0, 8.0):
                for cl in (True, False):
                    want = cv2.approxPolyDP(c.reshape(-1, 1, 2), ep, cl).reshape(-1, 2)
                    got = tie.approx_poly_dp(torch.from_numpy(c), ep, cl)
                    assert np.array_equal(got.astype(want.dtype), want), (dt, ep, cl)
                    _equal(got, ref.approx_poly_dp(c, ep, cl))


def test_min_area_rect_circle_and_box_points():
    """The f64 re-derivations equal ref/ exactly and cv2 within 1e-3 px
    (tests/test_contours.py's budget)."""
    rng = np.random.default_rng(seed("fc-fit1"))
    for _ in range(50):
        n = int(rng.integers(3, 40))
        pts = (rng.random((n, 2)) * 100).astype(np.float32)
        gr = tie.min_area_rect(torch.from_numpy(pts))
        _equal(gr, ref.min_area_rect(pts))
        wr = cv2.minAreaRect(pts.reshape(-1, 1, 2))
        gb = tie.box_points(gr)
        _equal(gb, ref.box_points(gr))
        assert np.abs(np.sort(cv2.boxPoints(wr), axis=0) - np.sort(gb, axis=0)).max() <= 1e-3
        gc, grad = tie.min_enclosing_circle(pts)
        _equal((gc, grad), ref.min_enclosing_circle(pts))
        wc, wrad = cv2.minEnclosingCircle(pts.reshape(-1, 1, 2))
        assert abs(wrad - grad) <= 1e-3
        assert abs(wc[0] - gc[0]) <= 1e-3 and abs(wc[1] - gc[1]) <= 1e-3
    rng = np.random.default_rng(seed("fc-boxpts"))
    for _ in range(40):
        rect = ((float(rng.uniform(0, 100)), float(rng.uniform(0, 100))),
                (float(rng.uniform(1, 50)), float(rng.uniform(1, 50))),
                float(rng.uniform(-90, 90)))
        _equal(tie.box_points(rect), ref.box_points(rect))
        assert np.abs(tie.box_points(rect) - cv2.boxPoints(rect)).max() <= 1e-3


@pytest.mark.parametrize("dist_type", ["l2", "l1", "l12", "fair", "welsch", "huber"])
def test_fit_line_vs_ref(dist_type):
    """tests/test_contours.py's noisy lines: every distance type equals
    ref/ bit for bit (the robust types draw from the same MWC stream); L2
    agrees with cv2 within 1e-5."""
    rng = np.random.default_rng(seed("fc-fitline"))
    for _ in range(30):
        n = int(rng.integers(10, 50))
        th = rng.uniform(0, np.pi)
        t = rng.uniform(-50, 50, n)
        base = np.stack([50 + t * np.cos(th), 50 + t * np.sin(th)], 1)
        noise = rng.normal(0, 0.5, (n, 2))
        noise[:max(1, n // 8)] = rng.normal(0, 8, (max(1, n // 8), 2))
        pts = (base + noise).astype(np.float32)
        gl = tie.fit_line(torch.from_numpy(pts), dist_type)
        _equal(gl, ref.fit_line(pts, dist_type))
        if dist_type == "l2":
            wl = cv2.fitLine(pts.reshape(-1, 1, 2), cv2.DIST_L2, 0, 0.01, 0.01).reshape(-1)
            g = np.array(gl)
            assert min(np.abs(g - wl).max(),
                       np.abs(np.concatenate([-g[:2], g[2:]]) - wl).max()) <= 1e-5


def test_fit_ellipse_vs_ref_and_cv2():
    rng = np.random.default_rng(seed("fc-fitell"))
    for _ in range(40):
        t = rng.uniform(0, 2 * np.pi, 24)
        a, b = rng.uniform(10, 40), rng.uniform(5, 25)
        th = rng.uniform(0, np.pi)
        ex = 50 + a * np.cos(t) * np.cos(th) - b * np.sin(t) * np.sin(th)
        ey = 50 + a * np.cos(t) * np.sin(th) + b * np.sin(t) * np.cos(th)
        pts = (np.stack([ex, ey], 1) + rng.normal(0, 0.05, (24, 2))).astype(np.float32)
        ge = tie.fit_ellipse(torch.from_numpy(pts))
        _equal(ge, ref.fit_ellipse(pts))
        we = cv2.fitEllipse(pts.reshape(-1, 1, 2))
        agg = (abs(we[0][0] - ge[0][0]) + abs(we[0][1] - ge[0][1])
               + abs(we[1][0] - ge[1][0]) + abs(we[1][1] - ge[1][1])
               + abs(((we[2] - ge[2]) + 90) % 180 - 90))
        assert agg <= 0.1, agg
    with pytest.raises(ValueError):
        tie.fit_ellipse(np.zeros((4, 2), np.float32))


def test_moments_hu_and_match_shapes():
    """tests/test_moments.py's images: moments, Hu invariants and the three
    matchShapes methods equal ref/ exactly and cv2 within 1e-9 relative."""
    rng = np.random.default_rng(seed("moments"))
    for _ in range(6):
        img = rng.integers(0, 256, (int(rng.integers(10, 90)),
                                    int(rng.integers(10, 90)))).astype(np.uint8)
        got = tie.moments(torch.from_numpy(img))
        _equal(got, ref.moments(img))
        want = cv2.moments(img)
        for k, v in want.items():
            assert abs(got[k] - v) <= max(abs(v), 1e-12) * 1e-9, k
        hg = tie.hu_moments(got)
        _equal(hg, ref.hu_moments(got))
        hw = cv2.HuMoments(want).ravel()
        assert np.abs((hg.ravel() - hw) / np.maximum(np.abs(hw), 1e-300)).max() <= 1e-9
        img2 = rng.integers(0, 256, img.shape).astype(np.uint8)
        for mi, ms in [(cv2.CONTOURS_MATCH_I1, "i1"), (cv2.CONTOURS_MATCH_I2, "i2"),
                       (cv2.CONTOURS_MATCH_I3, "i3")]:
            g = tie.match_shapes(torch.from_numpy(img), img2, ms)
            _equal(g, ref.match_shapes(img, img2, ms))
            w = cv2.matchShapes(img, img2, mi, 0)
            assert abs(w - g) <= max(abs(w), 1e-12) * 1e-9
        _equal(tie.moments(img, binary_image=True), ref.moments(img, binary_image=True))
    with pytest.raises(TypeError):
        tie.hu_moments(np.zeros(7))


def test_match_shapes_degenerate():
    """cv2's rule: exactly one all-zero-Hu side is DBL_MAX apart, two are 0."""
    rng = np.random.default_rng(seed("moments-degen"))
    black = np.zeros((32, 32), np.uint8)
    shape = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    for mi, ms in [(cv2.CONTOURS_MATCH_I1, "i1"), (cv2.CONTOURS_MATCH_I2, "i2"),
                   (cv2.CONTOURS_MATCH_I3, "i3")]:
        assert tie.match_shapes(black, shape, ms) == cv2.matchShapes(black, shape, mi, 0)
        assert tie.match_shapes(black, black, ms) == 0.0
    with pytest.raises(ValueError):
        tie.match_shapes(black, black, "bogus")


def test_gabor_kernel_vs_ref_and_cv2():
    """tests/test_features.py::test_gabor_kernel's cases: the taps equal
    ref/ bit for bit and cv2 within 1e-12."""
    rng = np.random.default_rng(1)
    for _ in range(15):
        rows, cols = int(rng.integers(3, 15)), int(rng.integers(3, 15))
        sig, th, lm = rng.uniform(1, 5), rng.uniform(0, 3), rng.uniform(2, 10)
        ga, ps = rng.uniform(0.3, 1.5), rng.uniform(0, 3)
        got = tie.gabor_kernel((rows, cols), sig, th, lm, ga, ps)
        _equal(got, ref.gabor_kernel((rows, cols), sig, th, lm, ga, ps))
        want = cv2.getGaborKernel((cols, rows), sig, th, lm, ga, ps, ktype=cv2.CV_64F)
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-12
    _equal(gabor_kernel(7, 2.0, 0.5, 4.0), ref.gabor_kernel(7, 2.0, 0.5, 4.0))


def test_copies_are_the_oracle_source():
    """Each copied function's source is the oracle's, character for
    character."""
    import inspect

    from imageenhancement_mp_tpu.ref import ops as rops
    from imageenhancement_mp_tpu_torch.utils import hough_host

    for mod, names in ((contours_host, ["_trace_contours", "_chain_simple", "find_contours",
                                        "contour_area", "arc_length", "bounding_rect",
                                        "contour_moments", "_sklansky", "convex_hull",
                                        "is_contour_convex", "point_polygon_test",
                                        "convexity_defects", "approx_poly_dp", "min_area_rect",
                                        "box_points", "min_enclosing_circle", "_fitline_wods",
                                        "fit_line", "fit_ellipse", "moments", "hu_moments",
                                        "match_shapes"]),
                       (hough_host, ["_CvRNG", "hough_lines_p", "_hough_numangle",
                                     "_hough_select"])):
        for name in names:
            assert inspect.getsource(getattr(mod, name)) == \
                inspect.getsource(getattr(rops, name)), name
    assert contours_host._CONTOUR_DELTAS == rops._CONTOUR_DELTAS
    assert contours_host._CONTOUR_DIR == rops._CONTOUR_DIR
    assert inspect.getsource(gabor_kernel) == inspect.getsource(rops.gabor_kernel)
