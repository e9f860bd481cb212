"""The tracking family's host helpers and kernel builders: the copies in
utils/tracking.py (meanShift, CamShift, goodFeaturesToTrack's selection)
pinned to their originals in ref/ops.py; good_features_to_track through the
port's api (its response map from the port's corner_min_eig_val /
corner_harris) equal to the JAX package's corners; get_gaussian_kernel and
get_deriv_kernels (the port's utils/taps.py with ``per_tap`` and
``normalize``) bit for bit to ref/, raising where cv2 raises; and the
CamShift chain a user runs (cvt_color rgb2hsv → calc_back_project of the
hue → cam_shift, frame after frame) against the same chain on ref/ and on
the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.utils import tracking


def _prob(rng):
    """A back-projection map (a Gaussian blob, or noise), a window and a
    termination, as the JAX package's tracking tests draw them."""
    H, W = int(rng.integers(30, 100)), int(rng.integers(30, 100))
    cx, cy = int(rng.integers(5, W - 5)), int(rng.integers(5, H - 5))
    yy, xx = np.mgrid[0:H, 0:W]
    p = np.clip(255 * np.exp(-(((xx - cx) / rng.uniform(3, 10)) ** 2
                               + ((yy - cy) / rng.uniform(3, 10)) ** 2)), 0, 255).astype(np.uint8)
    if rng.random() < 0.3:
        p = rng.integers(0, 256, (H, W), dtype=np.uint8)
    win = (int(rng.integers(-5, W - 10)), int(rng.integers(-5, H - 10)),
           int(rng.integers(0, 15)), int(rng.integers(5, 15)))
    return p, win, int(rng.integers(1, 20)), float(rng.choice([0.5, 1.0, 2.0]))


@pytest.mark.parametrize("block", range(4))
def test_mean_shift_and_cam_shift_copies_pinned(block):
    rng = np.random.default_rng(100 + block)
    for _ in range(20):
        p, win, mc, eps = _prob(rng)
        want = ref_ops.mean_shift(p, win, mc, eps)
        assert tracking.mean_shift(p, win, mc, eps) == want
        assert tie.mean_shift(torch.from_numpy(p), win, mc, eps) == want
        want = ref_ops.cam_shift(p, win, mc, eps)
        assert tracking.cam_shift(p, win, mc, eps) == want
        assert tie.cam_shift(torch.from_numpy(p), win, mc, eps) == want
    zero = np.zeros((20, 30), np.uint8)
    assert tie.cam_shift(torch.from_numpy(zero), (3, 4, 5, 6)) == ref_ops.cam_shift(
        zero, (3, 4, 5, 6))


def _corner_scene(rng, H=80, W=104):
    img = rng.integers(0, 40, (H, W)).astype(np.float64)
    for _ in range(12):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
        img[y:y + rng.integers(5, 25), x:x + rng.integers(5, 25)] += rng.uniform(50, 150)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("args", [
    dict(max_corners=0, quality_level=0.01, min_distance=10.0),
    dict(max_corners=12, quality_level=0.05, min_distance=4.5),
    dict(max_corners=30, quality_level=0.01, min_distance=0.5),
    dict(max_corners=20, quality_level=0.02, min_distance=6.0, use_harris=True, k=0.05),
    dict(max_corners=25, quality_level=0.01, min_distance=3.0, block_size=5, gradient_size=5),
    dict(max_corners=40, quality_level=0.001, min_distance=2.0, mask=True),
])
def test_good_features_to_track(args):
    args = dict(args)
    rng = np.random.default_rng(110)
    img = _corner_scene(rng)
    if args.pop("mask", False):
        args["mask"] = (rng.random(img.shape) < 0.6).astype(np.uint8)
    got = tie.good_features_to_track(torch.from_numpy(img), **args)
    assert got.dtype == torch.float32 and got.shape[1] == 2 and got.shape[0] > 0
    # the selection copy, on the port's own response map
    use_harris = args.get("use_harris", False)
    bs, gs = args.get("block_size", 3), args.get("gradient_size", 3)
    resp = (tie.corner_harris(torch.from_numpy(img), bs, gs, args.get("k", 0.04)) if use_harris
            else tie.corner_min_eigen_val(torch.from_numpy(img), bs, gs)).numpy()
    sel = dict(max_corners=args["max_corners"], quality_level=args["quality_level"],
               min_distance=args["min_distance"], mask=args.get("mask"))
    want = ref_ops.good_features_to_track(img, block_size=bs, gradient_size=gs,
                                          use_harris=use_harris, k=args.get("k", 0.04),
                                          response=resp, **sel)
    np.testing.assert_array_equal(tracking.select_features(resp, **sel), want)
    np.testing.assert_array_equal(got.numpy(), want)
    jx = np.asarray(ie.good_features_to_track(img, **args))
    np.testing.assert_array_equal(got.numpy(), jx)


def test_good_features_to_track_rejects():
    with pytest.raises(TypeError):
        tie.good_features_to_track(torch.zeros((9, 9), dtype=torch.float32))
    with pytest.raises(ValueError):
        tie.good_features_to_track(torch.zeros((2, 9, 9), dtype=torch.uint8))


def test_get_gaussian_kernel_bitwise():
    for k in (1, 3, 5, 7, 9, 11, 15, 31):
        for s in (0.0, -1.0, 0.8, 1.5, 3.0, 7.3):
            got = tie.get_gaussian_kernel(k, s)
            want = ref_ops.get_gaussian_kernel(k, s)
            assert got.dtype == np.float64 and got.shape == (k, 1)
            np.testing.assert_array_equal(got, want, err_msg=f"k={k} sigma={s}")
            np.testing.assert_array_equal(got, ie.get_gaussian_kernel(k, s))


def test_get_deriv_kernels_bitwise_and_raises_where_cv2_does():
    """Equal to ref/ wherever the port takes the arguments; a ValueError
    where cv2.getDerivKernels raises (an order not below the kernel size,
    Scharr off dx + dy = 1).  cv2 also refuses dx = dy = 0, which ref/ (and
    so the JAX package and the port) answer with the smoothing pair."""
    n = 0
    for ks in (-1, 1, 3, 5, 7, 9, 15, 27, 29, 31):
        for dx in range(4):
            for dy in range(4):
                for nm in (False, True):
                    takes = (dx + dy == 1) if ks == -1 else all(
                        o < (3 if (ks == 1 and o > 0) else ks) for o in (dx, dy))
                    if not takes:
                        with pytest.raises(ValueError):
                            tie.get_deriv_kernels(dx, dy, ks, nm)
                        continue
                    gx, gy = tie.get_deriv_kernels(dx, dy, ks, nm)
                    wx, wy = ref_ops.get_deriv_kernels(dx, dy, ks, nm)
                    assert gx.dtype == gy.dtype == np.float32
                    np.testing.assert_array_equal(gx, wx, err_msg=f"{dx} {dy} {ks} {nm}")
                    np.testing.assert_array_equal(gy, wy, err_msg=f"{dx} {dy} {ks} {nm}")
                    n += 1
    assert n > 200
    for bad in (0, 2, 33):
        with pytest.raises(ValueError):
            tie.get_deriv_kernels(1, 0, bad)


def _blob_frames(T, H, W, seed):
    """RGB frames of a red disc moving right and down over a green-blue
    noisy background."""
    rng = np.random.default_rng(seed)
    frames = np.empty((T, H, W, 3), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        bg = np.stack([rng.integers(0, 60, (H, W)), rng.integers(80, 200, (H, W)),
                       rng.integers(60, 220, (H, W))], -1)
        cx, cy = W * 0.3 + t * W * 0.02, H * 0.35 + t * H * 0.015
        disc = (xx - cx) ** 2 + (yy - cy) ** 2 < (0.12 * min(H, W)) ** 2
        bg[disc] = [rng.integers(200, 256), rng.integers(0, 40), rng.integers(0, 40)]
        frames[t] = bg
    return frames


def test_cam_shift_chain_matches_ref_and_jax():
    """cvt_color rgb2hsv → the hue's back projection through a 32-bin
    histogram of the first window → cam_shift, over six frames: the same
    windows and boxes as the ref/ chain and the JAX package's."""
    T, H, W = 6, 72, 96
    frames = _blob_frames(T, H, W, 120)
    win0 = (int(W * 0.3) - 8, int(H * 0.35) - 8, 16, 16)
    hue0 = ref_ops.rgb_to_hsv(frames[0])[..., 0]
    x, y, w, h = win0
    hist = np.bincount(hue0[y:y + h, x:x + w].astype(np.int64).ravel() * 32 // 256, minlength=32)
    hist = hist * (255.0 / hist.max())
    wins = {"port": win0, "ref": win0, "jax": win0}
    for t in range(T):
        hsv = tie.cvt_color(torch.from_numpy(frames[t]), "rgb2hsv")
        np.testing.assert_array_equal(hsv.numpy(), ref_ops.rgb_to_hsv(frames[t]))
        bp = tie.calc_back_project(hsv[..., 0].contiguous(), hist)
        want_bp = ref_ops.calc_back_project(ref_ops.rgb_to_hsv(frames[t])[..., 0], hist)
        np.testing.assert_array_equal(bp.numpy(), want_bp)
        box, wins["port"] = tie.cam_shift(bp, wins["port"], 10, 1.0)
        want_box, wins["ref"] = ref_ops.cam_shift(want_bp, wins["ref"], 10, 1.0)
        assert (box, wins["port"]) == (want_box, wins["ref"]), t
        jbp = ie.calc_back_project(ie.cvt_color(jnp.asarray(frames[t]), "rgb2hsv")[..., 0],
                                   hist)
        jbox, wins["jax"] = ie.cam_shift(np.asarray(jbp), wins["jax"], 10, 1.0)
        assert (box, wins["port"]) == (jbox, wins["jax"]), t
    # the window followed the disc
    x, y, w, h = wins["port"]
    cx, cy = W * 0.3 + (T - 1) * W * 0.02, H * 0.35 + (T - 1) * H * 0.015
    assert abs(x + w / 2 - cx) < 4 and abs(y + h / 2 - cy) < 4
