"""The port's sep_conv_u8 plain version (kernels/conv.py) and the u8 filter
ops held to the JAX package's conv kernels in interpret mode, its XLA route,
and ref/, at 0 LSB: integer taps and sums, then cv2's pinned two-FMA f32
epilogue, leave no room for a tolerance."""

import functools

import jax
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.kernels.conv import gaussian_blur_pallas, unsharp_mask_pallas
from imageenhancement_mp_tpu.kernels.conv2 import sep_conv5_wide, supports_wide
from imageenhancement_mp_tpu.ops import filters as jfilters
from imageenhancement_mp_tpu.ops.histogram import equalize_lut, histogram_256
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.ops import filters as tfilters

WIDE = (2, 64, 256)
NARROW = (1, 37, 131)
SMALL = (1, 5, 9)  # H < k and W < k for k = 7 (and for 31)


def _planes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _taps(k, sigma=0.0):
    return tfilters.q8_taps(k, sigma)


def _ref_stack(fn, x):
    return np.stack([fn(p) for p in x])


@pytest.mark.parametrize("amount", [None, 1.0, 0.5])
@pytest.mark.parametrize("k,sigma", [(5, 0.0), (5, 1.5)])
def test_matches_wide_kernel(k, sigma, amount):
    x = _planes(WIDE, 21)
    assert supports_wide(x.shape, np.uint8)
    tv, th = _taps(k, sigma)
    got = kconv.sep_conv_u8(torch.from_numpy(x), tv, th, amount).numpy()
    np.testing.assert_array_equal(got, np.asarray(sep_conv5_wide(x, tv, th, amount, interpret=True)))


@pytest.mark.parametrize("amount", [None, 1.0, 0.5])
def test_matches_wide_kernel_with_lut(amount):
    x = _planes(WIDE, 22)
    luts = _planes((WIDE[0], 256), 23)
    lut2 = luts.astype(np.int32).reshape(WIDE[0], 2, 128)  # the JAX flagship layout
    tv, th = _taps(5)
    got = kconv.sep_conv_u8(torch.from_numpy(x), tv, th, amount,
                            luts=interop.luts_from_lut2(lut2)).numpy()
    want = np.asarray(sep_conv5_wide(x, tv, th, amount, lut2=lut2, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_jax_built_lut_feeds_the_port_conv():
    """hist → equalize LUT built by the JAX package, handed across through
    interop.luts_from_lut2, then the port's fused conv: equals the JAX
    flagship's fused kernel on the same lut2."""
    x = _planes(WIDE, 24)
    total = WIDE[1] * WIDE[2]
    hists = histogram_256(x, method="scatter")
    luts = jax.vmap(functools.partial(equalize_lut, total=total))(hists)
    lut2 = np.asarray(luts.astype(np.int32).reshape(WIDE[0], 2, 128))
    tv, th = _taps(5)
    got = kconv.sep_conv_u8(torch.from_numpy(x), tv, th, 1.0,
                            luts=interop.luts_from_lut2(lut2)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(sep_conv5_wide(x, tv, th, 1.0, lut2=lut2, interpret=True)))


@pytest.mark.parametrize("fn", ["blur", "unsharp"])
def test_matches_narrow_kernel(fn):
    x = _planes(NARROW, 25)
    assert not supports_wide(x.shape, np.uint8)
    t = torch.from_numpy(x)
    if fn == "blur":
        got = tfilters.gaussian_blur_planes(t, 5, 0.0).numpy()
        want = gaussian_blur_pallas(x, 5, 0.0, interpret=True)
    else:
        got = tfilters.unsharp_mask_planes(t, 0.5, 5, 0.0).numpy()
        want = unsharp_mask_pallas(x, 0.5, 5, 0.0, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


# unsharp_mask takes a square ksize, so the rect (3, 5) case is blur only
_REF_CASES = [(ks, sigma, amount)
              for ks, sigma in [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), ((3, 5), 0.0),
                                (5, 1.5), (5, 2.3), (3, 2.3)]
              for amount in (None, 1.0, 0.5, -1.0, 100.0)
              if amount is None or not isinstance(ks, tuple)]


@pytest.mark.parametrize("ks,sigma,amount", _REF_CASES)
def test_matches_ref(ks, sigma, amount):
    for shape in (WIDE, NARROW, SMALL):
        x = _planes(shape, 26)
        t = torch.from_numpy(x)
        if amount is None:
            got = tfilters.gaussian_blur_planes(t, ks, sigma).numpy()
            want = _ref_stack(lambda p: ref.gaussian_blur(p, ks, sigma), x)
        else:
            got = tfilters.unsharp_mask_planes(t, amount, ks, sigma).numpy()
            want = _ref_stack(lambda p: ref.unsharp_mask(p, amount, ks, sigma), x)
        np.testing.assert_array_equal(got, want, err_msg=str(shape))


def test_deep_halo_and_31_taps_match_ref():
    # halos deeper than the plane reflect again (numpy.pad "reflect")
    for shape in [(1, 5, 9), (2, 1, 40), (1, 40, 1), (1, 2, 2)]:
        x = _planes(shape, 27)
        for ks, amount in [(31, None), ((31, 9), None), (31, 0.5), (9, -2.0)]:
            if amount is None:
                got = tfilters.gaussian_blur_planes(torch.from_numpy(x), ks).numpy()
                want = _ref_stack(lambda p: ref.gaussian_blur(p, ks), x)
            else:
                got = tfilters.unsharp_mask_planes(torch.from_numpy(x), amount, ks).numpy()
                want = _ref_stack(lambda p: ref.unsharp_mask(p, amount, ks), x)
            np.testing.assert_array_equal(got, want, err_msg=f"{shape} {ks} {amount}")


def test_negative_amount_wide_matches_ref_and_xla():
    """amount −1 on a wide shape: compared with ref/ and the JAX XLA route
    only.  The JAX Pallas wide kernel's packed integer epilogue is wrong for
    negative amounts (ROADMAP R1), so it is not a reference here; the port's
    single two-FMA law is right for every amount."""
    x = _planes(WIDE, 28)
    got = tfilters.unsharp_mask_planes(torch.from_numpy(x), -1.0, 5, 0.0).numpy()
    np.testing.assert_array_equal(got, _ref_stack(lambda p: ref.unsharp_mask(p, -1.0, 5, 0.0), x))
    config.use_pallas_kernels = False
    try:
        xla = np.asarray(jfilters.unsharp_mask_planes(x, -1.0, 5, 0.0))
    finally:
        config.use_pallas_kernels = None
    np.testing.assert_array_equal(got, xla)


def test_reflect_index_matches_numpy():
    for n in range(1, 9):
        for r in range(0, 16):
            want = np.pad(np.arange(n), r, mode="reflect")
            got = kconv.reflect101(torch.arange(-r, n + r), n).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"n={n} r={r}")


def test_sep_conv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    t5 = _taps(5)[0]
    # 33 taps is a result (the wide instance), the plain version's
    xr = torch.from_numpy(_planes((1, 8, 8), 5))
    np.testing.assert_array_equal(kconv.sep_conv_u8(xr, _taps(33)[0], t5).numpy(),
                                  kconv.sep_conv_u8_plain(xr, _taps(33)[0], t5).numpy())
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x, (), t5)  # no taps
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x, (128, 128), t5)  # even tap count
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x, (-16, 288, -16), t5)
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x, t5, t5, luts=torch.zeros(256, dtype=torch.uint8))
    with pytest.raises(TypeError):
        kconv.sep_conv_u8(x.to(torch.int32), t5, t5)
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x[0], t5, t5)
    with pytest.raises(ValueError):
        tfilters.gaussian_blur_planes(x, 32)
    with pytest.raises(ValueError):
        tfilters.gaussian_blur_planes(x, 0)
    np.testing.assert_array_equal(tfilters.gaussian_blur_planes(xr, 33).numpy(),
                                  ref.gaussian_blur(xr[0].numpy(), 33)[None])
    # u16, i16 and f32 are ported: equal to ref/ (f32 at its unsharp bound)
    for dtype in (np.uint16, np.int16, np.float32):
        xd = torch.from_numpy(xr.numpy().astype(dtype) * dtype(100))
        got = tfilters.unsharp_mask_planes(xd).numpy()
        want = ref.unsharp_mask(xd[0].numpy())[None]
        assert got.dtype == want.dtype
        assert np.abs(got.astype(np.float64) - want).max() <= (1e-2 if dtype == np.float32 else 0)
    with pytest.raises(TypeError):
        tfilters.gaussian_blur_planes(x.to(torch.int32))
