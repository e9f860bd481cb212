"""Pyramidal Lucas-Kanade (ops/lk.py, api.calc_optical_flow_pyr_lk): the
port's exact=True tracker held bit for bit to ref/ops.py's
calc_optical_flow_pyr_lk (points, status, and err where status is 1) and to
the JAX package's device tracker; exact=False within 0.1 px of exact where
both track; the Scharr derivatives, the pyramid clamp and cv2's lane-order
sum (against a NumPy copy of the oracle's ``simd_sum``) on their own; and
the detect → refine → track chain through the port's api (GFTT,
cornerSubPix, LK) against the ref/ chain.  Frame pairs of 50–120 px with at
most 15 points, as the JAX package's tests use, made from numpy seeds with
ref/'s Gaussian blur and warpAffine."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch import api as port_api
from imageenhancement_mp_tpu_torch.ops import lk


def _shift(img, dx, dy):
    M = np.array([[1.0, 0.0, dx], [0.0, 1.0, dy]])
    return ref.warp_affine(img, M, img.shape, "linear", "constant", 0)


def _pair(rng, lo=50, hi=120, n=15):
    H, W = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
    base = ref.gaussian_blur(rng.integers(0, 256, (H, W), dtype=np.uint8), 5, 0.0)
    dx, dy = float(rng.uniform(-4, 4)), float(rng.uniform(-4, 4))
    nxt = _shift(base, dx, dy)
    pts = ref_ops.good_features_to_track(base, n, 0.01, 6)
    return base, nxt, pts, (dx, dy)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_bitwise(got, want, ctx):
    gp, gs, ge = (g.numpy() for g in got)
    wp, ws, we = want
    np.testing.assert_array_equal(gp, wp, err_msg=str(ctx))
    np.testing.assert_array_equal(gs, ws, err_msg=str(ctx))
    m = gs == 1
    np.testing.assert_array_equal(ge[m], we[m], err_msg=str(ctx))


@pytest.mark.parametrize("shape", [(8, 9), (37, 60), (2, 3), (1, 7), (5, 1)])
def test_scharr_deriv_matches_ref(shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    got = lk.scharr_deriv(_t(img)).numpy()
    np.testing.assert_array_equal(got, ref_ops.scharr_deriv(img).astype(np.int32))


@pytest.mark.parametrize("win", [5, 7, 11, 21])
def test_pyramid_clamp_and_levels_match_ref(win):
    rng = np.random.default_rng(2 + win)
    for _ in range(6):
        H, W = int(rng.integers(16, 120)), int(rng.integers(16, 120))
        ml = int(rng.integers(0, 5))
        img = rng.integers(0, 256, (H, W), dtype=np.uint8)
        n, levels = ref_ops.build_optical_flow_pyramid(img, (win, win), ml)
        assert port_api._lk_levels((H, W), win, win, ml) == n
        x = _t(img)
        for lv in levels[1:]:
            x = tie.pyr_down(x)
            np.testing.assert_array_equal(x.numpy(), lv)


def _simd_sum_mirror(A, B):
    """ref/ops.py's ``simd_sum`` (a closure inside the oracle's tracker),
    copied: 8-wide blocks into four f32 lanes through single-rounded FMAs,
    the scalar f32 tail row by row, ``tail + ((l0+l2) + (l1+l3))``."""
    f32 = np.float32
    lanes = np.zeros(4, np.float64)
    tail = f32(0.0)
    h, w = A.shape
    nb = w // 8 if w >= 8 else 0
    vw = nb * 8
    Af, Bf = A.astype(np.float64), B.astype(np.float64)
    P = (A * B).astype(f32)
    for i in range(h):
        for bkl in range(nb):
            for hf in (0, 1):
                for lane in range(4):
                    k = bkl * 8 + 4 * hf + lane
                    lanes[lane] = np.float64(f32(Af[i, k] * Bf[i, k] + lanes[lane]))
        for x in range(vw, w):
            tail = f32(tail + P[i, x])
    lf = lanes.astype(f32)
    return f32(tail + f32(f32(lf[0] + lf[2]) + f32(lf[1] + lf[3])))


@pytest.mark.parametrize("ww", [1, 3, 7, 8, 9, 15, 16, 21])
def test_lane_sum_exact_matches_the_oracle_order(ww):
    """Products up to 2^26 (LK's mismatch × derivative range), so the lanes
    round and the order shows."""
    rng = np.random.default_rng(ww)
    wh = 5
    A = rng.integers(-16320, 16321, (6, wh, ww)).astype(np.int32)
    B = rng.integers(-4080, 4081, (6, wh, ww)).astype(np.int32)
    got = lk.lane_sum_exact(_t(A), _t(B)).numpy()
    want = np.array([_simd_sum_mirror(a, b) for a, b in zip(A, B)], np.float32)
    np.testing.assert_array_equal(got, want)
    fast = lk.lane_sum_fast(_t(A), _t(B)).numpy()
    np.testing.assert_allclose(fast, want, rtol=1e-5)


@pytest.mark.parametrize("win", [3, 5, 9, 13, 15, 21])
def test_exact_matches_ref_bitwise(win):
    rng = np.random.default_rng(10 + win)
    for trial in range(3):
        base, nxt, pts, _ = _pair(rng, 50, 100)
        # a point outside, one on the border and one in a flat corner
        pts = np.concatenate([pts, [[-30.0, 5.0], [0.0, 0.0], [2.0, 2.0]]]).astype(np.float32)
        ml = int(rng.integers(0, 4))
        for mc, eps in ((30, 0.01), (12, 0.01), (50, 0.001)):
            got = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), _t(pts), (win, win), ml, mc,
                                               eps)
            assert got[0].dtype == torch.float32 and got[1].dtype == torch.uint8
            want = ref_ops.calc_optical_flow_pyr_lk(base, nxt, pts, (win, win), ml, mc, eps)
            _assert_bitwise(got, want, (win, trial, ml, mc, eps))


def test_exact_non_square_window_and_min_eig():
    rng = np.random.default_rng(30)
    base, nxt, pts, _ = _pair(rng)
    for win, me in (((7, 13), 1e-4), ((13, 5), 1e-3), ((9, 9), 0.0)):
        got = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), pts, win, 2, 30, 0.01, me)
        want = ref_ops.calc_optical_flow_pyr_lk(base, nxt, pts, win, 2, 30, 0.01, me)
        _assert_bitwise(got, want, (win, me))


@pytest.mark.parametrize("win,ml", [(9, 1), (21, 2)])
def test_exact_matches_jax(win, ml):
    rng = np.random.default_rng(40 + win)
    base, nxt, pts, _ = _pair(rng, 50, 100)
    got = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), _t(pts), (win, win), ml)
    jx = [np.asarray(v) for v in ie.calc_optical_flow_pyr_lk(base, nxt, pts, (win, win), ml)]
    _assert_bitwise(got, jx, (win, ml))


@pytest.mark.parametrize("win", [9, 15, 21])
def test_fast_within_a_tenth_of_exact(win):
    rng = np.random.default_rng(50 + win)
    for _ in range(2):
        base, nxt, pts, _ = _pair(rng)
        ex = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), _t(pts), (win, win), 2)
        fa = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), _t(pts), (win, win), 2, exact=False)
        m = (ex[1] == 1) & (fa[1] == 1)
        assert bool(m.any())
        assert float((fa[0][m] - ex[0][m]).abs().max()) < 0.1


def test_tracks_known_translation():
    rng = np.random.default_rng(60)
    base = ref.gaussian_blur(rng.integers(0, 256, (90, 110), dtype=np.uint8), 5, 0.0)
    dx, dy = 2.3, -1.6
    nxt = _shift(base, dx, dy)
    pts = ref_ops.good_features_to_track(base, 12, 0.01, 10)
    inner = (pts[:, 0] > 15) & (pts[:, 0] < 95) & (pts[:, 1] > 15) & (pts[:, 1] < 75)
    got, st, _ = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), _t(pts), (15, 15), 2)
    m = inner & (st.numpy() == 1)
    assert m.sum() >= 4
    assert np.abs(got.numpy()[m] - pts[m] - np.array([dx, dy])).max() < 0.25


def test_detect_refine_track_chain():
    """good_features_to_track → corner_sub_pix → calc_optical_flow_pyr_lk
    through the port's api, against the same chain on ref/ (bit for bit)
    and the JAX package's GFTT and cornerSubPix."""
    rng = np.random.default_rng(70)
    base, nxt, _, (dx, dy) = _pair(rng, 90, 120)
    g = tie.good_features_to_track(_t(base), 15, 0.01, 8)
    assert g.device == _t(base).device and g.dtype == torch.float32
    want_g = ref_ops.good_features_to_track(base, 15, 0.01, 8)
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(g.numpy(), np.asarray(ie.good_features_to_track(base, 15, 0.01,
                                                                                  8.0)))
    r = tie.corner_sub_pix(_t(base), g, (5, 5))
    want_r = ref_ops.corner_sub_pix(base, want_g, (5, 5))
    np.testing.assert_array_equal(r.numpy(), want_r)
    np.testing.assert_array_equal(r.numpy(), ie.corner_sub_pix(base, want_g, (5, 5)))
    got = tie.calc_optical_flow_pyr_lk(_t(base), _t(nxt), r)
    want = ref_ops.calc_optical_flow_pyr_lk(base, nxt, want_r)
    _assert_bitwise(got, want, "chain")
    m = got[1].numpy() == 1
    flow = got[0].numpy()[m] - r.numpy()[m]
    assert m.sum() >= 5 and abs(float(np.median(flow[:, 0])) - dx) < 0.25
    assert abs(float(np.median(flow[:, 1])) - dy) < 0.25


def test_lk_rejects():
    a = torch.zeros((20, 20), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tie.calc_optical_flow_pyr_lk(a.float(), a, [[1.0, 1.0]])
    with pytest.raises(ValueError):
        tie.calc_optical_flow_pyr_lk(a[None], a[None], [[1.0, 1.0]])
