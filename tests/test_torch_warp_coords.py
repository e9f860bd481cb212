"""The port's warp coordinates held to ref/ bit for bit: each host function
copied into utils/warp_coords.py against its ref/ops.py original, and the
affine and perspective fields ops/warp.py builds with torch (here on CPU
tensors) against ref/'s NumPy fields."""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.ops import warp as tw
from imageenhancement_mp_tpu_torch.utils import warp_coords as wc

F32 = np.float32
AFFINE = {
    "rot15": ref_ops.get_rotation_matrix_2d((20.0, 15.0), 15.0, 1.0),
    "rot31x1.1": ref_ops.get_rotation_matrix_2d((48.0, 32.0), 31.0, 1.1),
    "rot-23x0.9": ref_ops.get_rotation_matrix_2d((35.0, 25.0), -23.0, 0.9),
    "rot45x0.125": ref_ops.get_rotation_matrix_2d((350.0, 300.0), 45.0, 0.125),
    "shear": np.array([[1.0, 0.3, -10.0], [0.1, 0.9, 5.5]]),
}
PERSPECTIVE = {
    "mild": np.array([[1.0, 0.05, -5.0], [0.02, 0.98, 3.0], [2e-4, 1e-4, 1.0]]),
    "strong": np.array([[0.9, -0.2, 4.0], [0.15, 1.1, -2.0], [3e-3, -2e-3, 1.0]]),
}
# an inverse homography whose denominator is exactly 0 on column 5, and one
# whose denominator nearly vanishes (coordinates past ±2e9 are clipped)
PERSPECTIVE_INV = {
    "zero_den": np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0], [1.0, 0.0, -5.0]]),
    "tiny_den": np.array([[3e9, 0.0, 1.0], [0.0, -3e9, 1.0], [0.0, 0.0, 1e-3]]),
}
SIZES = [(13, 37), (9, 32), (5, 15), (1, 1)]
K = np.array([[30.0, 0.0, 16.5], [0.0, 28.0, 11.0], [0.0, 0.0, 1.0]])
DIST = [-0.21, 0.05, 1e-3, -2e-3, 0.01]
NEW_K = np.array([[25.0, 0.0, 15.0], [0.0, 24.0, 10.5], [0.0, 0.0, 1.0]])


def _args():
    rng = np.random.default_rng(5)
    Mi = ref_ops.invert_affine(AFFINE["rot31x1.1"])
    Mpi = ref_ops.invert_perspective(PERSPECTIVE["mild"])
    A = rng.random((6, 6)) + np.eye(6)
    xy = (rng.random((2, 40)) * 20 - 10).astype(F32)
    xy[:, :4] = [[0, 0, -3, 5], [0, 2, 0, -5]]  # the origin and the axes
    src4 = np.array([[0, 0], [50, 2], [48, 40], [1, 37]], F32)
    dst4 = np.array([[3, 1], [47, 5], [52, 38], [-2, 41]], F32)
    return [
        ("invert_affine", (AFFINE["shear"],)),
        ("get_rotation_matrix_2d", ((10.5, 7.25), -23.0, 0.9)),
        ("_fma32", (F32(1.1), np.arange(5, dtype=F32), F32(0.3))),
        ("warp_tab_int", ()),
        ("warp_affine_coords_int", (Mi, 13, 37)),
        ("warp_affine_nn_coords_int", (Mi, 13, 37)),
        ("warp_affine_coords_f32", (Mi, 13, 37)),
        ("warp_affine_coords_cubic_f32", (Mi, 13, 37)),
        ("invert_perspective", (PERSPECTIVE["strong"],)),
        ("_hal_lu_solve", (A, rng.random(6))),
        ("get_perspective_transform", (src4, dst4)),
        ("get_affine_transform", (src4[:3], dst4[:3])),
        ("warp_perspective_coords_f32", (Mpi, 13, 37)),
        ("warp_perspective_coords_int", (Mpi, 13, 37)),
        ("warp_perspective_nn_coords_int", (Mpi, 13, 37)),
        ("warp_perspective_coords_cubic_f32", (Mpi, 13, 37)),
        ("_lanczos4_remap_tabs", ()),
        ("init_undistort_rectify_map", (K, DIST, (12, 17))),
        ("_undistort_maps64", (K, DIST, (12, 17), NEW_K)),
        ("_fast_atan2_deg", (xy[1], xy[0])),
        ("cart_to_polar", (xy[0], xy[1])),
        ("cart_to_polar", (xy[0], xy[1], True)),
        ("_warp_polar_maps", ((30, 40), (20, 24), (15.5, 12.0), 18.0, False, False)),
        ("_warp_polar_maps", ((30, 40), (20, 24), (15.5, 12.0), 18.0, True, False)),
        ("_warp_polar_maps", ((30, 40), (34, 27), (15.5, 12.0), 18.0, False, True)),
        ("_warp_polar_maps", ((30, 40), (34, 27), (15.5, 12.0), 18.0, True, True)),
    ]


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", _args(), ids=lambda v: v if isinstance(v, str) else "")
def test_copy_equals_ref_original(name, args):
    _assert_same(getattr(wc, name)(*args), getattr(ref_ops, name)(*args))


def test_copy_constants_equal_ref():
    for name in ("_WARP_AB_BITS", "_WARP_INTER_BITS", "_WARP_REMAP_BITS", "_HAL_LU_EPS"):
        assert getattr(wc, name) == getattr(ref_ops, name)


def _clipped(m):
    return np.clip(m, -2e9, 2e9)


@pytest.mark.parametrize("oh,ow", SIZES)
@pytest.mark.parametrize("name", list(AFFINE))
def test_affine_field_equals_ref(name, oh, ow):
    """The torch-built field (body/tail split at ow − ow % 16) is
    ref/ops.py::warp_affine_coords_f32's, bit for bit."""
    Mi = ref_ops.invert_affine(AFFINE[name])
    got = tw.affine_field(Mi, oh, ow, torch.device("cpu"))
    want = ref_ops.warp_affine_coords_f32(Mi, oh, ow)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), _clipped(w))


@pytest.mark.parametrize("oh,ow", SIZES)
@pytest.mark.parametrize("name", list(PERSPECTIVE) + list(PERSPECTIVE_INV))
def test_perspective_field_equals_ref(name, oh, ow):
    Mi = (PERSPECTIVE_INV[name] if name in PERSPECTIVE_INV
          else ref_ops.invert_perspective(PERSPECTIVE[name]))
    got = tw.perspective_field(Mi, oh, ow, torch.device("cpu"))
    want = ref_ops.warp_perspective_coords_f32(Mi, oh, ow)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _clipped(w))
    if name == "zero_den" and ow > 5:
        assert (got[0][:, 5] == 0).all() and (got[1][:, 5] == 0).all()


def test_polar_maps_equal_ref_and_are_kept():
    args = (30, 40, (20, 24), (15.5, 12.0), 18.0, True, False)
    mx, my = tw.polar_maps(*args, "cpu")
    wx, wy = ref_ops._warp_polar_maps((30, 40), (20, 24), (15.5, 12.0), 18.0, True, False)
    np.testing.assert_array_equal(mx.numpy(), wx)
    np.testing.assert_array_equal(my.numpy(), wy)
    again = tw.polar_maps(*args, torch.device("cpu"))
    assert again[0] is mx and again[1] is my
    for inverse in (False, True):  # contiguous, as the gather kernel takes them
        assert all(m.is_contiguous() for m in tw.polar_maps(
            30, 40, (34, 27), (15.5, 12.0), 18.0, False, inverse, "cpu"))


def test_random_fields_equal_ref():
    """100 random affine and 100 random perspective fields, some with
    coordinates past ±2e9, odd sizes: bit for bit."""
    rng = np.random.default_rng(7)
    for t in range(100):
        scale = (1.0, 1e3, 1e8, 1e9)[t % 4]
        M = rng.normal(size=(2, 3)) * np.array([[2 * scale, 2.0, 500 * scale]])
        oh, ow = int(rng.integers(1, 40)), int(rng.integers(1, 50))
        Mp = np.vstack([M, [rng.normal() * 1e-3, rng.normal() * 1e-3, 1.0]])
        for got, want in ((tw.affine_field(M, oh, ow, "cpu"),
                           ref_ops.warp_affine_coords_f32(M, oh, ow)),
                          (tw.perspective_field(Mp, oh, ow, "cpu"),
                           ref_ops.warp_perspective_coords_f32(Mp, oh, ow))):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), _clipped(w), err_msg=f"case {t}")
