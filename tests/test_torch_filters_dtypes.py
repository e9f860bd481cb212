"""Gaussian blur and unsharp mask in every dtype, sep_conv_u8 past 31 taps,
and config 3, held to the JAX package and ref/ on numpy-seeded planes.

u8 and u16: 0 LSB against JAX and ref/.  The port's u16 Gaussian is one
int64 separable sum; it is held to both of the JAX package's int32 routes
(``_gauss_u16_fixed``, ``_gauss_u16_q16``) on random and all-65535 planes.
i16: 0 LSB against ref/, which runs the same f32 law one rounding per op, and
±1 against JAX, whose XLA:CPU f32 sums may contract into FMAs (ROADMAP R4);
unsharp against JAX only where a ±1 blur stays ±1 (|amount| ≤ 1).  f32: the
JAX package's own bounds against ref/ (tests/test_ops_vs_ref.py: 1e-3 for
the Gaussian, 1e-2 for unsharp), the same against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import filters as jf
from imageenhancement_mp_tpu.pipeline import equalize_unsharp as jax_equalize_unsharp
from imageenhancement_mp_tpu.pipeline import make_pipeline as jax_make_pipeline
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.kernels import launch_counts, reset_launch_counts
from imageenhancement_mp_tpu_torch.ops import filters as tf

SHAPE = (2, 24, 31)
GAUSS = [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), (9, 0.0), (11, 0.0), (5, 1.3), (0, 2.0),
         ((3, 7), 0.0), ((7, 3), 1.1)]


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 300 - 20).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _port(fn, x, *args):
    return fn(torch.from_numpy(x), *args).numpy()


def _jax(fn, x, *args):
    return np.asarray(fn(jnp.asarray(x), *args))


def _ref(fn, x):
    return np.stack([fn(p) for p in x])


def _diff(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())


@pytest.mark.parametrize("ksize,sigma", GAUSS, ids=[str(g) for g in GAUSS])
@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32], ids=["u16", "i16", "f32"])
def test_gaussian_blur_matches_jax_and_ref(dtype, ksize, sigma):
    x = _planes(SHAPE, dtype, 1)
    got = _port(tf.gaussian_blur_planes, x, ksize, sigma)
    want = _jax(jf.gaussian_blur_planes, x, ksize, sigma)
    oracle = _ref(lambda p: ref.gaussian_blur(p, ksize, sigma), x)
    if dtype == np.uint16:
        assert _diff(got, want) == 0 and _diff(got, oracle) == 0
    elif dtype == np.int16:
        assert _diff(got, oracle) == 0 and _diff(got, want) <= 1
    else:
        assert _diff(got, want) < 1e-3 and _diff(got, oracle) < 1e-3


@pytest.mark.parametrize("kind", ["random", "65535"])
def test_u16_gaussian_equals_both_jax_routes(kind):
    x = _planes(SHAPE, np.uint16, 2) if kind == "random" else np.full(SHAPE, 65535, np.uint16)
    for k in (3, 5, 7, 9):  # sigma 0, k <= 9: JAX takes its Q8 split route; Q16 also applies
        got = _port(tf.gaussian_blur_planes, x, k)
        assert _diff(got, np.asarray(jf._gauss_u16_fixed(jnp.asarray(x), k, k))) == 0
        assert _diff(got, np.asarray(jf._gauss_u16_q16(jnp.asarray(x), k, k, 0.0, 0.0))) == 0
    for (kh, kw), s in (((11, 13), 0.0), ((5, 9), 1.7), ((21, 3), 4.0)):
        got = _port(tf.gaussian_blur_planes, x, (kh, kw), s)
        assert _diff(got, np.asarray(jf._gauss_u16_q16(jnp.asarray(x), kh, kw, s, s))) == 0
    if kind == "65535":
        assert (got == 65535).all()


UNSHARP = [(1.0, 5), (0.5, 3), (-0.5, 5), (1.5, 5), (2.0, 3), (1.0, 1)]


@pytest.mark.parametrize("amount,ksize", UNSHARP, ids=[str(u) for u in UNSHARP])
@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.float32], ids=["u16", "i16", "f32"])
def test_unsharp_mask_matches_jax_and_ref(dtype, amount, ksize):
    x = _planes(SHAPE, dtype, 3)
    got = _port(tf.unsharp_mask_planes, x, amount, ksize)
    want = _jax(jf.unsharp_mask_planes, x, amount, ksize)
    oracle = _ref(lambda p: ref.unsharp_mask(p, amount, ksize), x)
    if dtype == np.uint16:
        assert _diff(got, want) == 0 and _diff(got, oracle) == 0
    elif dtype == np.int16:
        assert _diff(got, oracle) == 0
        if abs(amount) <= 1:
            assert _diff(got, want) <= 1
    else:
        assert _diff(got, want) < 1e-2 and _diff(got, oracle) < 1e-2


THIN = [(1, 1, 9), (1, 2, 6), (1, 3, 4), (2, 7, 1), (1, 2, 2)]


@pytest.mark.parametrize("shape", THIN, ids=[str(s) for s in THIN])
def test_5x5_kernels_on_thin_planes(shape):
    for dtype in (np.uint8, np.uint16, np.int16, np.float32):
        x = _planes(shape, dtype, 4)
        for fn, jfn, args in ((tf.gaussian_blur_planes, jf.gaussian_blur_planes, (5,)),
                              (tf.unsharp_mask_planes, jf.unsharp_mask_planes, (1.0, 5))):
            got, want = _port(fn, x, *args), _jax(jfn, x, *args)
            assert _diff(got, want) <= (1 if dtype == np.int16 else 0), (dtype, shape)


def test_api_takes_every_dtype_on_hwc_input():
    for dtype in (np.uint16, np.int16, np.float32):
        x = _planes((16, 20, 3), dtype, 5)
        got = tie.gaussian_blur(torch.from_numpy(x), 5).numpy()
        want = np.asarray(ie.gaussian_blur(x, 5))
        assert _diff(got, want) <= (0 if dtype == np.uint16 else 1e-3 if dtype == np.float32 else 1)
        got = tie.unsharp_mask(torch.from_numpy(x), 1.0, 3).numpy()
        want = np.asarray(ie.unsharp_mask(x, 1.0, 3))
        assert _diff(got, want) <= (0 if dtype == np.uint16 else 1e-2 if dtype == np.float32 else 1)


# ------------------------------------------------------------- past 31 taps

WIDE = [(33, 0.0), (0, 6.0), ((33, 5), 0.0), ((3, 37), 0.0), (35, 2.0), (0, 12.0)]


@pytest.mark.parametrize("ksize,sigma", WIDE, ids=[str(w) for w in WIDE])
def test_u8_wide_taps_match_jax_ref_and_plain(ksize, sigma):
    x = _planes((2, 40, 48), np.uint8, 6)
    tv, th = tf.q8_taps(ksize, sigma)
    assert max(len(tv), len(th)) > kconv.RUNTIME_MAX_TAPS
    blur = _port(tf.gaussian_blur_planes, x, ksize, sigma)
    assert _diff(blur, _jax(jf.gaussian_blur_planes, x, ksize, sigma)) == 0
    assert _diff(blur, _ref(lambda p: ref.gaussian_blur(p, ksize, sigma), x)) == 0
    assert _diff(blur, kconv.sep_conv_u8_plain(torch.from_numpy(x), tv, th).numpy()) == 0
    if isinstance(ksize, int) and ksize:
        sharp = _port(tf.unsharp_mask_planes, x, 1.5, ksize, sigma)
        assert _diff(sharp, _jax(jf.unsharp_mask_planes, x, 1.5, ksize, sigma)) == 0
        assert _diff(sharp, _ref(lambda p: ref.unsharp_mask(p, 1.5, ksize, sigma), x)) == 0


def test_equalize_unsharp_past_31_taps():
    x = _planes((2, 40, 48), np.uint8, 7)
    for ksize, sigma in ((33, 0.0), (37, 6.0)):
        got = tie.equalize_unsharp(torch.from_numpy(x), 1.0, ksize, sigma).numpy()
        want = _ref(lambda p: ref.unsharp_mask(ref.equalize_hist(p), 1.0, ksize, sigma), x)
        assert _diff(got, want) == 0
        assert _diff(got, np.asarray(jax_equalize_unsharp(x, 1.0, ksize, sigma))) == 0


def test_even_and_zero_sizes_still_raise():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for bad in (4, 32, 0, (33, 4)):
        with pytest.raises(ValueError):
            tf.gaussian_blur_planes(x, bad)
    for bad in (4, 32, 0):
        with pytest.raises(ValueError):
            tie.equalize_unsharp(x, ksize=bad)
    with pytest.raises(ValueError):
        kconv.sep_conv_u8(x, (128,) * 32, (256,))


# past 31 taps the zero ends are trimmed before the instance is chosen: these
# take the runtime instance on the trimmed taps, the rest the wide one
RUNTIME_AFTER_TRIM = {(33, 0.0): (31, 31), ((33, 5), 0.0): (31, 5), (35, 2.0): (13, 13)}


def test_past_31_taps_the_wrapper_launches_the_wide_instance(monkeypatch):
    launches = []
    monkeypatch.setattr(kconv, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kconv, "launch", lambda *args: launches.append(args))
    monkeypatch.setattr(kconv, "sep_conv_u8_plain", None)  # no plain fallback
    x = torch.zeros((2, 8, 9), dtype=torch.uint8)
    for ksize, sigma in WIDE:
        tv, th = tf.q8_taps(ksize, sigma)
        cut_v, cut_h = kconv.trim_taps(tv), kconv.trim_taps(th)
        runtime = (ksize, sigma) in RUNTIME_AFTER_TRIM
        if runtime:
            assert (len(cut_v), len(cut_h)) == RUNTIME_AFTER_TRIM[(ksize, sigma)]
        for amount, mode in ((None, (0, 0)), (1.0, (1, 1)), (0.5, (2, 0))):
            launches.clear()
            kconv.sep_conv_u8(x, tv, th, amount)
            (name, _, *args), = launches
            assert name == "sep_conv_u8"
            assert (args[6], args[8]) == (len(cut_v), len(cut_h))
            if runtime:
                assert args[9] is None and args[-7] == 0
                continue
            assert tuple(args[-7:-2]) == (kconv.WIDE, 0, 16, *mode)
            dev_taps = kconv._device_taps(cut_v, cut_h, x.device, 0)
            assert args[9] == dev_taps.data_ptr()
            np.testing.assert_array_equal(dev_taps.numpy(), kconv.wide_tap_buffer(cut_v, cut_h))
            assert tuple(dev_taps[:len(cut_v)].tolist()) == cut_v
    # at 31 taps and below the taps travel by value: no device buffer
    launches.clear()
    kconv.sep_conv_u8(x, *tf.q8_taps(31, 0.0))
    (_, _, *args), = launches
    assert args[9] is None and args[-7] == 0


# ------------------------------------------------------------- config 3

def _config3(k):
    return [("gaussian_blur", {"ksize": k}), ("laplacian_sharpen", {}),
            ("unsharp_mask", {"amount": 1.0, "ksize": k})]


@pytest.mark.parametrize("k", [3, 5])
def test_config3_matches_jax_and_ref(k):
    x = _planes((2, 48, 64), np.uint8, 8)
    got = tie.make_pipeline(_config3(k))(torch.from_numpy(x)).numpy()
    assert _diff(got, np.asarray(jax_make_pipeline(_config3(k))(x))) == 0
    want = _ref(lambda p: ref.unsharp_mask(ref.laplacian_sharpen(ref.gaussian_blur(p, k)), 1.0, k),
                x)
    assert _diff(got, want) == 0


@pytest.mark.parametrize("dtype", [np.uint16, np.float32], ids=["u16", "f32"])
def test_config3_other_dtypes_match_jax(dtype):
    x = _planes((16, 20, 3), dtype, 9)
    got = tie.make_pipeline(_config3(5))(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_make_pipeline(_config3(5))(x))
    # f32: the Gaussian's R4 differences (< 1e-4 here) grow through the
    # sharpen's 4-neighbour sum and the unsharp's two FMAs
    assert _diff(got, want) <= (0 if dtype == np.uint16 else 2e-3)


def test_config3_launches_sep_conv_u8_twice(monkeypatch):
    monkeypatch.setattr(kconv, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kconv, "launch", lambda name, *a: launch_counts.__setitem__(
        name, launch_counts[name] + 1))
    reset_launch_counts()
    pipe = tie.make_pipeline(_config3(5))
    pipe(torch.zeros((2, 16, 20), dtype=torch.uint8))
    assert {n: c for n, c in launch_counts.items() if c} == {"sep_conv_u8": 2}
    reset_launch_counts()
