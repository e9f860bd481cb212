"""The port's main path (pipeline.equalize_unsharp) and public api held to
the JAX package — its Pallas flagship in interpret mode on a wide shape, its
default XLA route elsewhere — and to ref/, at 0 LSB; and the dispatch rules:
CPU tensors never reach the kernel build, unsupported inputs raise."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.pipeline import equalize_unsharp as jax_equalize_unsharp
from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts

WIDE = (2, 64, 256)
NARROW = (1, 37, 131)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _ref_planes(fn, x):
    return np.stack([fn(p) for p in x])


def _ref_eq_unsharp(amount=1.0, ksize=5, sigma=0.0):
    return lambda p: ref.unsharp_mask(ref.equalize_hist(p), amount, ksize, sigma)


@pytest.mark.parametrize("shape", [WIDE, (1, 128, 384)])
def test_equalize_unsharp_matches_jax_pallas_flagship(shape):
    x = _img(shape, 31)
    got = tie.equalize_unsharp(torch.from_numpy(x), 1.0, 5, 0.0).numpy()
    config.use_pallas_kernels = True
    try:
        want = np.asarray(jax_equalize_unsharp(x, 1.0, 5, 0.0))
    finally:
        config.use_pallas_kernels = None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _ref_planes(_ref_eq_unsharp(), x))


@pytest.mark.parametrize("layout", ["NHW", "HW", "NHWC", "HWC"])
def test_equalize_unsharp_layouts_match_jax_xla_and_ref(layout):
    shape = {"NHW": NARROW, "HW": NARROW[1:], "NHWC": (2, 37, 131, 3), "HWC": (37, 131, 3)}[layout]
    x = _img(shape, 32)
    got = tie.equalize_unsharp(torch.from_numpy(x), 0.5, 5, 0.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_equalize_unsharp(x, 0.5, 5, 0.0)))
    planes = {"NHW": x, "HW": x[None], "NHWC": np.moveaxis(x, -1, 1).reshape(-1, 37, 131),
              "HWC": np.moveaxis(x, -1, 0)}[layout]
    want = _ref_planes(_ref_eq_unsharp(0.5), planes)
    got_planes = {"NHW": got, "HW": got[None], "NHWC": np.moveaxis(got, -1, 1).reshape(-1, 37, 131),
                  "HWC": np.moveaxis(got, -1, 0)}[layout]
    np.testing.assert_array_equal(got_planes, want)


@pytest.mark.parametrize("ksize,sigma,amount", [
    (1, 0.0, 1.0), (3, 0.0, 2.0), (7, 2.3, -1.0), (31, 0.0, 0.5), (9, 0.0, 100.0), (5, 1.5, 0.7),
])
def test_equalize_unsharp_ksize_amount_grid_matches_ref(ksize, sigma, amount):
    for shape in (WIDE, NARROW, (1, 5, 9)):
        x = _img(shape, 33)
        got = tie.equalize_unsharp(torch.from_numpy(x), amount, ksize, sigma).numpy()
        np.testing.assert_array_equal(got, _ref_planes(_ref_eq_unsharp(amount, ksize, sigma), x),
                                      err_msg=str(shape))


@pytest.mark.parametrize("shape", [(2, 37, 131), (37, 131, 3), (2, 64, 256, 1)])
def test_api_matches_jax_api(shape):
    x = _img(shape, 34)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(tie.equalize_hist(t).numpy(), np.asarray(jie.equalize_hist(x)))
    np.testing.assert_array_equal(tie.gaussian_blur(t, 5, 0.0).numpy(),
                                  np.asarray(jie.gaussian_blur(x, 5, 0.0)))
    np.testing.assert_array_equal(tie.gaussian_blur(t, (3, 7), 1.2, 0.8).numpy(),
                                  np.asarray(jie.gaussian_blur(x, (3, 7), 1.2, 0.8)))
    np.testing.assert_array_equal(tie.unsharp_mask(t, 0.5, 5, 1.5).numpy(),
                                  np.asarray(jie.unsharp_mask(x, 0.5, 5, 1.5)))


def test_api_channels_last_false_matches_jax():
    x = _img((3, 9, 4), 35)  # [N, H, W<=4] grayscale frames
    t = torch.from_numpy(x)
    for fn in ("equalize_hist", "gaussian_blur", "unsharp_mask"):
        np.testing.assert_array_equal(getattr(tie, fn)(t, channels_last=False).numpy(),
                                      np.asarray(getattr(jie, fn)(x, channels_last=False)), err_msg=fn)


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    reset_launch_counts()
    x = torch.from_numpy(_img((2, 37, 131, 3), 36))
    tie.equalize_unsharp(x)
    tie.equalize_hist(x)
    tie.gaussian_blur(x, (3, 5))
    tie.unsharp_mask(x, -0.5)
    tie.equalize_hist(x, per_frame=False)
    tie.apply_lut(x, np.arange(256, dtype=np.float32))
    assert launch_counts == dict.fromkeys(launch_counts, 0)
    assert set(launch_counts) == {"hist256", "equalize_lut256", "apply_lut256", "sep_conv_u8",
                                  "median", "hist256_tiles", "clahe_lut", "clahe_blend",
                                  "bilateral", "athresh", "warp_gather_u8", "take_table",
                                  "apply_lut256_wide", "apply_luts_multi", "median_unsharp",
                                  "hist65536_tiles", "hist256_lut", "tile_luts256",
                                  "tile_luts65536"}


def test_public_functions_reject_what_the_port_does_not_take():
    x = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tie.equalize_hist(x.to(torch.uint16), per_frame=False)
    with pytest.raises(TypeError):
        tie.equalize_hist(x.to(torch.float32))
    with pytest.raises(TypeError):
        tie.equalize_unsharp(x.to(torch.uint16))
    # 33 taps is a result (sep_conv_u8's wide instance); even and zero sizes raise
    x33 = torch.from_numpy(_img((2, 8, 8), 34))
    np.testing.assert_array_equal(tie.equalize_unsharp(x33, ksize=33).numpy(),
                                  _ref_planes(_ref_eq_unsharp(ksize=33), x33.numpy()))
    with pytest.raises(ValueError):
        tie.equalize_unsharp(x, ksize=4)
    with pytest.raises(ValueError):
        tie.equalize_unsharp(x, ksize=0)
    # u16, i16 and f32 Gaussian and unsharp are ported: equal to ref/
    for dtype in (np.uint16, np.int16, np.float32):
        xd = torch.from_numpy(x33.numpy().astype(dtype) * dtype(100))
        for fn, rfn in ((tie.gaussian_blur, ref.gaussian_blur), (tie.unsharp_mask, ref.unsharp_mask)):
            got = fn(xd, channels_last=False).numpy()
            want = _ref_planes(rfn, xd.numpy())
            assert got.dtype == want.dtype
            assert np.abs(got.astype(np.float64) - want).max() <= (
                1e-2 if dtype == np.float32 else 0)
    with pytest.raises(ValueError):
        tie.equalize_unsharp(x.to("meta"))
