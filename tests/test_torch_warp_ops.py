"""The port's warp ops (ops/warp.py) held to the JAX ops (their XLA route
on the CPU) and ref/, at 0 LSB: u8/u16/f32 linear and nearest under the
constant (border value 9 and 300) and replicate borders for warp_affine,
warp_perspective and remap; warp_polar forward and inverse, linear and
semilog; the i16 legacy fixed point; cubic and lanczos4 on every dtype; and
undistort.  The JAX docstrings allow ±1 between XLA:CPU and ref/ for cubic
and lanczos4, since XLA:CPU may contract FMAs: the port is held to ref/ at
0 and to JAX at ±1 there.
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.ref import ops as ref
from imageenhancement_mp_tpu.ops import warp as jw
from imageenhancement_mp_tpu_torch.ops import warp as tw
from torch_warp_cases import (BORDER_IDS, BORDERS, DIST, DTYPES, HOMOGRAPHY, K, ROT31, check,
                              img, maps, per_plane)


# -- the ops: linear and nearest ------------------------------------------------

@pytest.mark.parametrize("border,bv", BORDERS, ids=BORDER_IDS)
@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_affine_matches_jax_and_ref(dtype, interp, border, bv):
    x = img((2, 24, 40), dtype, 20)
    got = tw.warp_affine_planes(torch.from_numpy(x), ROT31, (21, 35), interp, border, bv)
    check(got, per_plane(lambda p: ref.warp_affine(p, ROT31, (21, 35), interp, border, bv), x),
           jw.warp_affine_planes(x, ROT31, (21, 35), interp, border, bv))


@pytest.mark.parametrize("border,bv", BORDERS, ids=BORDER_IDS)
@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_perspective_matches_jax_and_ref(dtype, interp, border, bv):
    x = img((2, 30, 40), dtype, 22)
    got = tw.warp_perspective_planes(torch.from_numpy(x), HOMOGRAPHY, (28, 37), interp, border,
                                     bv)
    check(got, per_plane(
        lambda p: ref.warp_perspective(p, HOMOGRAPHY, (28, 37), interp, border, bv), x),
        jw.warp_perspective_planes(x, HOMOGRAPHY, (28, 37), interp, border, bv))


@pytest.mark.parametrize("border,bv", BORDERS, ids=BORDER_IDS)
@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_remap_matches_jax_and_ref(dtype, interp, border, bv):
    x = img((2, 17, 23), dtype, 23)
    mx, my = maps(17, 23, 19, 29, 23)
    got = tw.remap_planes(torch.from_numpy(x), torch.from_numpy(mx), torch.from_numpy(my),
                          interp, border, bv)
    check(got, per_plane(lambda p: ref.remap(p, mx, my, interp, border, bv), x),
           jw.remap_planes(x, mx, my, interp, border, bv))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_warp_polar_u8_matches_jax_and_ref(inverse, log, interp):
    x = img((2, 64, 96), np.uint8, 19)
    dsize = (64, 96) if inverse else (48, 56)
    args = (dsize, (50.0, 30.0), 45.0, log, inverse, interp)
    got = tw.warp_polar_planes(torch.from_numpy(x), *args)
    check(got, per_plane(lambda p: ref.warp_polar(p, *args), x),
           jw.warp_polar_planes(x, *args))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32])
def test_warp_polar_other_dtypes_match_jax_and_ref(dtype, inverse):
    x = img((1, 40, 50), dtype, 24)
    args = ((40, 50) if inverse else (30, 36), (24.0, 18.0), 22.0, False, inverse, "linear")
    got = tw.warp_polar_planes(torch.from_numpy(x), *args)
    check(got, per_plane(lambda p: ref.warp_polar(p, *args), x),
           jw.warp_polar_planes(x, *args))


# -- the ops: i16, cubic, lanczos4, undistort -----------------------------------

def _op_cases(op, x, interp, border, bv):
    if op == "affine":
        return (lambda t: tw.warp_affine_planes(t, ROT31, (21, 35), interp, border, bv),
                lambda p: ref.warp_affine(p, ROT31, (21, 35), interp, border, bv),
                lambda a: jw.warp_affine_planes(a, ROT31, (21, 35), interp, border, bv))
    if op == "perspective":
        return (lambda t: tw.warp_perspective_planes(t, HOMOGRAPHY, (21, 35), interp, border, bv),
                lambda p: ref.warp_perspective(p, HOMOGRAPHY, (21, 35), interp, border, bv),
                lambda a: jw.warp_perspective_planes(a, HOMOGRAPHY, (21, 35), interp, border, bv))
    mx, my = maps(x.shape[1], x.shape[2], 21, 35, 25)
    return (lambda t: tw.remap_planes(t, mx, my, interp, border, bv),
            lambda p: ref.remap(p, mx, my, interp, border, bv),
            lambda a: jw.remap_planes(a, mx, my, interp, border, bv))


@pytest.mark.parametrize("border,bv", [("constant", 9.0), ("replicate", 0.0)],
                         ids=["const9", "replicate"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("op", ["affine", "perspective", "remap"])
def test_int16_legacy_paths(op, interp, border, bv):
    """i16 linear is cv2's fixed point with float tab weights, i16 nearest
    the fixed-point (static) or cvRound (remap) maps: 0 LSB against ref/."""
    x = img((2, 24, 40), np.int16, 26)
    port, oracle, jax_op = _op_cases(op, x, interp, border, bv)
    check(port(torch.from_numpy(x)), per_plane(oracle, x), jax_op(x))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
@pytest.mark.parametrize("interp", ["cubic", "lanczos4"])
@pytest.mark.parametrize("op", ["affine", "perspective", "remap"])
def test_cubic_and_lanczos4(op, interp, dtype):
    """Strict per-op f32 on the CPU equals ref/'s f32 sequence (the JAX
    docstrings' device == oracle); JAX on XLA:CPU is allowed ±1."""
    x = img((2, 24, 40), dtype, 27)
    border, bv = ("constant", 9.0) if dtype != np.float32 else ("replicate", 0.0)
    port, oracle, jax_op = _op_cases(op, x, interp, border, bv)
    check(port(torch.from_numpy(x)), per_plane(oracle, x), jax_op(x), tol_jax=1.0)


@pytest.mark.parametrize("new_k", [False, True])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_undistort_matches_jax_and_ref(dtype, new_k):
    x = img((2, 25, 41), dtype, 28)
    nk = np.array([[25.0, 0.0, 19.0], [0.0, 24.0, 11.5], [0.0, 0.0, 1.0]]) if new_k else None
    got = tw.undistort_planes(torch.from_numpy(x), K, DIST, nk)
    check(got, per_plane(lambda p: ref.undistort(p, K, DIST, nk), x),
           jw.undistort_planes(x, K, DIST, nk))
