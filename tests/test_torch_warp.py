"""The port's warp kernel module (kernels/warp.py's plain version), its
dispatch, the api, the registry and interop.warp_maps_from_jax, held to the
JAX package and ref/.

* ``warp_gather_u8``'s plain version equals the JAX package's K11
  (``gather_bilinear_pallas`` / ``gather_nearest_pallas``) run in interpret
  mode, at 0 LSB.
* On a CUDA tensor, u8 linear and nearest reach the kernel, once per call,
  and nothing else does (the launch stubbed, as in test_torch_row_caps.py).
* The public functions take ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` and
  ``[N,H,W,C]`` and equal JAX's; ``warp_affine`` runs through
  ``make_pipeline``.
"""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.kernels import warp as jkw
from imageenhancement_mp_tpu.ops import warp as jw
from imageenhancement_mp_tpu.pipeline import make_pipeline as jax_make_pipeline
from imageenhancement_mp_tpu.ref import ops as ref
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import warp as kw
from imageenhancement_mp_tpu_torch.ops import warp as tw
from torch_warp_cases import DIST, HOMOGRAPHY, K, ROT31, img, maps


# -- the kernel module ----------------------------------------------------------

def test_gather_bilinear_plain_equals_interpret_k11():
    x = img((2, 64, 80), np.uint8, 0)
    M = ref.get_rotation_matrix_2d((40.0, 32.0), 15.0, 1.0)
    sx, sy = ref.warp_affine_coords_f32(ref.invert_affine(M), 60, 72)
    got = kw.warp_gather_u8(torch.from_numpy(x), torch.from_numpy(sx), torch.from_numpy(sy),
                            False, "replicate")
    want = np.asarray(jkw.gather_bilinear_pallas(x, sx, sy, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_nearest_plain_equals_interpret_k11():
    x = img((1, 50, 70), np.uint8, 3)
    M = ref.get_rotation_matrix_2d((35.0, 25.0), -23.0, 0.9)
    sx, sy = ref.warp_affine_coords_f32(ref.invert_affine(M), 50, 70)
    got = kw.warp_gather_u8(torch.from_numpy(x), torch.from_numpy(sx), torch.from_numpy(sy),
                            True, "replicate")
    want = np.asarray(jkw.gather_nearest_pallas(x, np.rint(sy).astype(np.int64),
                                                np.rint(sx).astype(np.int64), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_bilinear_plain_equals_interpret_k11_perspective():
    x = img((2, 60, 80), np.uint8, 13)
    sx, sy = ref.warp_perspective_coords_f32(ref.invert_perspective(HOMOGRAPHY), 56, 76)
    got = kw.warp_gather_u8(torch.from_numpy(x), torch.from_numpy(sx), torch.from_numpy(sy),
                            False, "replicate")
    want = np.asarray(jkw.gather_bilinear_pallas(x, sx, sy, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_replicate_clamp_equals_tpu_tx_zeroing():
    """The TPU kernel zeroes tx (ty) where ix0 < 0 (iy0 < 0); the port clamps
    each tap instead.  Both taps then read texel 0, so dropping the fraction
    there changes nothing."""
    x = torch.from_numpy(img((2, 9, 11), np.uint8, 4))
    rng = np.random.default_rng(4)
    sx = torch.from_numpy((rng.random((20, 30)) * 16 - 5).astype(np.float32))
    sy = torch.from_numpy((rng.random((20, 30)) * 14 - 5).astype(np.float32))
    zeroed = lambda s: torch.where(torch.floor(s) < 0, torch.floor(s), s)  # noqa: E731
    assert (zeroed(sx) != sx).any() and (zeroed(sy) != sy).any()
    np.testing.assert_array_equal(
        kw.warp_gather_u8(x, sx, sy, False, "replicate").numpy(),
        kw.warp_gather_u8(x, zeroed(sx), zeroed(sy), False, "replicate").numpy())


@pytest.mark.parametrize("nearest", [False, True])
def test_gather_far_maps_read_the_border(nearest):
    """Coordinates past ±2e9 (clipped) and exactly at the plane's edges."""
    x = torch.from_numpy(img((2, 6, 7), np.uint8, 6))
    sx = torch.tensor([[-3e9, 3e9, 0.0, 6.0, 6.5, -0.5]], dtype=torch.float32)
    sy = torch.tensor([[0.0, 2.0, -3e9, 5.0, 5.0, 3e9]], dtype=torch.float32)
    for border, bv in (("constant", 77), ("replicate", 0)):
        got = kw.warp_gather_u8(x, sx, sy, nearest, border, bv).numpy()
        want = np.stack([ref.remap(p, sx.numpy(), sy.numpy(),
                                   "nearest" if nearest else "linear", border, bv)
                         for p in x.numpy()])
        np.testing.assert_array_equal(got, want)


def test_gather_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    m = torch.zeros((2, 2), dtype=torch.float32)
    with pytest.raises(TypeError):
        kw.warp_gather_u8(x.to(torch.int16), m, m)
    with pytest.raises(ValueError):
        kw.warp_gather_u8(x, m.double(), m)
    with pytest.raises(ValueError):
        kw.warp_gather_u8(x, m, m, border="reflect")
    with pytest.raises(ValueError):
        kw.warp_gather_u8(x, m, m, border_value=300)


# -- dispatch on a CUDA tensor (the launch stubbed) -----------------------------

def _affine(interp, border="constant"):
    return lambda x: tw.warp_affine_planes(x, ROT31, (9, 11), interp, border, 9.0)


DISPATCH = {  # name -> (dtype, call, launches of warp_gather_u8)
    "affine_linear_u8": (np.uint8, _affine("linear"), 1),
    "affine_nearest_u8_replicate": (np.uint8, _affine("nearest", border="replicate"), 1),
    "perspective_linear_u8": (np.uint8, lambda x: tw.warp_perspective_planes(
        x, HOMOGRAPHY, (9, 11)), 1),
    "polar_u8": (np.uint8, lambda x: tw.warp_polar_planes(x, (8, 12), (6.0, 5.0), 7.0), 1),
    "polar_inverse_nearest_u8": (np.uint8, lambda x: tw.warp_polar_planes(
        x, (12, 10), (6.0, 5.0), 7.0, True, True, "nearest"), 1),
    "remap_nearest_u8": (np.uint8, lambda x: tw.remap_planes(
        x, *maps(10, 12, 9, 11, 1), "nearest"), 1),
    "affine_linear_u16": (np.uint16, _affine("linear"), 0),
    "affine_linear_f32": (np.float32, _affine("linear"), 0),
    "affine_linear_i16": (np.int16, _affine("linear"), 0),
    "affine_cubic_u8": (np.uint8, _affine("cubic"), 0),
    "affine_lanczos4_u8": (np.uint8, _affine("lanczos4"), 0),
    "remap_cubic_u8": (np.uint8, lambda x: tw.remap_planes(x, *maps(10, 12, 9, 11, 1),
                                                           "cubic"), 0),
    "undistort_u8": (np.uint8, lambda x: tw.undistort_planes(x, K, DIST), 0),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_on_cuda_reaches_the_kernel(monkeypatch, name):
    """u8 linear and nearest launch warp_gather_u8 once, with the maps' and
    the planes' geometry; every other branch launches nothing."""
    dtype, call, n = DISPATCH[name]
    launches = []
    monkeypatch.setattr(kw, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kw, "launch", lambda *args: launches.append(args))
    x = torch.from_numpy(img((3, 10, 12), dtype, 2))
    out = call(x)
    assert out.shape[0] == 3
    assert len(launches) == n
    for kernel, device, *args in launches:
        assert kernel == "warp_gather_u8" and device == x.device
        assert args[4] == 3 and args[6] == 12  # planes and width; H grows by 2 when
        assert tuple(args[7:9]) == tuple(out.shape[1:])  # inverse polar pads


# -- the api, the registry and interop ------------------------------------------

@pytest.mark.parametrize("shape", [(24, 40), (24, 40, 3), (2, 24, 40, 3), (3, 24, 40)])
def test_api_shapes_match_jax(shape):
    x = img(shape, np.uint8, 30)
    M = tie.get_rotation_matrix_2d((20.0, 12.0), 31.0, 1.1)
    np.testing.assert_array_equal(M, jie.get_rotation_matrix_2d((20.0, 12.0), 31.0, 1.1))
    t = torch.from_numpy(x)
    cases = [
        (tie.warp_affine(t, M, (21, 35), "linear", "constant", 9.0),
         jie.warp_affine(x, M, (21, 35), "linear", "constant", 9.0)),
        (tie.warp_perspective(t, HOMOGRAPHY, (21, 35), "nearest", "replicate"),
         jie.warp_perspective(x, HOMOGRAPHY, (21, 35), "nearest", "replicate")),
        (tie.warp_polar(t, (20, 30), (20.0, 12.0), 15.0, log=True),
         jie.warp_polar(x, (20, 30), (20.0, 12.0), 15.0, log=True)),
        (tie.undistort(t, K, DIST), jie.undistort(x, K, DIST)),
    ]
    mx, my = maps(24, 40, 21, 35, 31)
    cases.append((tie.remap(t, mx, my, "linear", "replicate"),
                  jie.remap(x, mx, my, "linear", "replicate")))
    for got, want in cases:
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_api_matrix_helpers_match_jax():
    src4 = np.array([[0, 0], [50, 2], [48, 40], [1, 37]], np.float32)
    dst4 = np.array([[3, 1], [47, 5], [52, 38], [-2, 41]], np.float32)
    np.testing.assert_array_equal(tie.get_perspective_transform(src4, dst4),
                                  jie.get_perspective_transform(src4, dst4))
    np.testing.assert_array_equal(tie.get_affine_transform(src4[:3], dst4[:3]),
                                  jie.get_affine_transform(src4[:3], dst4[:3]))
    for got, want in zip(tie.init_undistort_rectify_map(K, DIST, (12, 17)),
                         jie.init_undistort_rectify_map(K, DIST, (12, 17))):
        np.testing.assert_array_equal(got, want)


def test_api_rejects_other_dtypes():
    with pytest.raises(TypeError):
        tie.warp_affine(torch.zeros((4, 4), dtype=torch.int32), ROT31, (4, 4))
    with pytest.raises(ValueError):
        tie.warp_affine(torch.zeros((4, 4), dtype=torch.uint8), ROT31, (0, 4))
    with pytest.raises(ValueError):
        tie.warp_perspective(torch.zeros((4, 4), dtype=torch.uint8), HOMOGRAPHY, (4, 4),
                             interpolation="area")


def test_registry_warp_affine_through_make_pipeline():
    x = img((2, 24, 40, 3), np.uint8, 32)
    stages = [("warp_affine", {"M": ROT31, "dsize": (21, 35), "border": "replicate"}),
              ("median_blur", {"ksize": 3})]
    got = tie.make_pipeline(stages)(torch.from_numpy(x))
    want = jax_make_pipeline([("warp_affine", {"M": tuple(map(tuple, ROT31)), "dsize": (21, 35),
                                               "border": "replicate"}),
                              ("median_blur", {"ksize": 3})])(x)
    assert got.shape == (2, 21, 35, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interop_warp_maps_from_jax():
    Mi = ref.invert_affine(ROT31)
    sx, sy = ref.warp_affine_coords_f32(Mi, 21, 35)
    tx, ty = interop.warp_maps_from_jax(sx, sy)
    assert tx.dtype == torch.float32 and tx.is_contiguous() and tx.shape == (21, 35)
    x = img((2, 24, 40), np.uint8, 33)
    np.testing.assert_array_equal(tw.remap_planes(torch.from_numpy(x), tx, ty).numpy(),
                                  np.asarray(jw.warp_affine_planes(x, ROT31, (21, 35))))
    with pytest.raises(ValueError):
        interop.warp_maps_from_jax(sx.astype(np.float64), sy)
    with pytest.raises(ValueError):
        interop.warp_maps_from_jax(sx, sy[:, :-1])


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    """Every warp entry point on CPU tensors: the kernel counter stays at 0
    and the build is never called."""
    from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts

    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    reset_launch_counts()
    t = torch.from_numpy(img((2, 24, 40), np.uint8, 34))
    tie.warp_affine(t, ROT31, (21, 35), "nearest")
    tie.warp_perspective(t, HOMOGRAPHY, (21, 35))
    tie.warp_polar(t, (20, 30), (20.0, 12.0), 15.0, inverse=True)
    tie.remap(t, *maps(24, 40, 21, 35, 34))
    tie.undistort(t, K, DIST)
    assert launch_counts["warp_gather_u8"] == 0
