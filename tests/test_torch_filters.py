"""The port's spatial filters beyond the Gaussian (ops/filters.py: Laplacian
and its sharpen, box blur and box filter, Sobel and Scharr, the corner
responses, spatialGradient, sqrBoxFilter, stackBlur) held to the JAX
package's ops/filters.py and to ref/ on numpy-seeded planes.

Tolerances: 0 for every integer output.  f32 outputs against JAX: XLA:CPU
contracts multiplies and adds into FMAs (ROADMAP R4), so the port's
one-rounding-per-op f32 sums may differ in the last bits; the bound is
stated per test, relative to the output's largest magnitude where the sums
grow with the kernel.  Against ref/, which sums in f64, the JAX package's own
test bounds (tests/test_ops_vs_ref.py, tests/test_features.py,
tests/test_gradient_blend.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import filters as jf
from imageenhancement_mp_tpu.ref.stackblur import stack_blur as ref_stack_blur
from imageenhancement_mp_tpu_torch.ops import filters as tf

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
IDS = ["u8", "u16", "i16", "f32"]
SHAPE = (2, 24, 31)
THIN = [(1, 1, 7), (1, 2, 5), (1, 3, 3), (1, 6, 1), (2, 5, 2)]


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _port(fn, x, *args):
    out = fn(torch.from_numpy(x), *args)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _jax(fn, x, *args):
    out = fn(jnp.asarray(x), *args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _ref(fn, x):
    return np.stack([fn(p) for p in x])


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _rel_err(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    return float(d / max(1e-9, float(np.abs(want).max())))


# ------------------------------------------------------------- Laplacian

@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_laplacian_matches_jax_and_ref(dtype, ksize):
    x = _planes(SHAPE, dtype, 100 + ksize)
    delta = 0.0 if ksize == 1 else 7.6
    got = _port(tf.laplacian_planes, x, ksize, delta)
    want = _jax(jf.laplacian_planes, x, ksize, delta)
    oracle = _ref(lambda p: ref.laplacian(p, ksize, delta), x)
    if dtype == np.float32:
        if ksize == 1:  # the 4-neighbour stencil: exact in f32 (4·x is exact)
            _same(got, want)
        else:
            assert _rel_err(got, want) < 1e-6
        assert np.abs(got - oracle).max() < 1e-3 * max(1.0, float(np.abs(oracle).max()) / 1e3)
    else:
        _same(got, want)
        _same(got, oracle)


@pytest.mark.parametrize("shape", THIN, ids=[str(s) for s in THIN])
@pytest.mark.parametrize("ksize", [1, 5])
def test_laplacian_thin_planes(shape, ksize):
    x = _planes(shape, np.uint8, 7)
    _same(_port(tf.laplacian_planes, x, ksize), _jax(jf.laplacian_planes, x, ksize))


def test_laplacian_raises_like_jax():
    x = _planes((1, 8, 9), np.uint16, 1)
    for fn, arr in ((tf.laplacian_planes, torch.from_numpy(x)), (jf.laplacian_planes, jnp.asarray(x))):
        with pytest.raises(ValueError, match="int32"):
            fn(arr, 11)
        with pytest.raises(ValueError, match="delta"):
            fn(arr, 1, 2.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_laplacian_sharpen_matches_jax_and_ref(dtype):
    x = _planes(SHAPE, dtype, 11)
    got = _port(tf.laplacian_sharpen_planes, x)
    _same(got, _jax(jf.laplacian_sharpen_planes, x))
    oracle = _ref(ref.laplacian_sharpen, x)
    if dtype == np.float32:
        assert np.abs(got - oracle).max() < 1e-3  # tests/test_ops_vs_ref.py's Laplacian bound
    else:
        _same(got, oracle)


# ------------------------------------------------------------- box filters

@pytest.mark.parametrize("ksize", [1, 3, 5, (3, 7), (5, 1)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_box_blur_matches_jax_and_ref(dtype, ksize):
    x = _planes(SHAPE, dtype, 20)
    got = _port(tf.box_blur_planes, x, ksize)
    _same(got, _jax(jf.box_blur_planes, x, ksize))
    oracle = _ref(lambda p: ref.box_blur(p, ksize), x)
    if dtype == np.float32:  # ref/ sums in f64
        assert np.abs(got - oracle).max() < 1e-3
    else:
        _same(got, oracle)


@pytest.mark.parametrize("ksize", [2, 3, (4, 3), (1, 2), (6, 5)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_box_filter_raw_sums_match_jax_and_ref(dtype, ksize):
    x = _planes(SHAPE, dtype, 21)
    got = _port(tf.box_filter_planes, x, ksize, False)
    _same(got, _jax(jf.box_filter_planes, x, ksize, False))
    oracle = _ref(lambda p: ref.box_filter(p, ksize, False), x)
    if dtype == np.float32:
        assert np.abs(got - oracle).max() < 1e-2  # f32 sums of up to 30 terms near 400
    else:
        _same(got, oracle)


@pytest.mark.parametrize("shape", THIN, ids=[str(s) for s in THIN])
def test_box_filters_on_thin_planes(shape):
    for dtype in (np.uint8, np.float32):
        x = _planes(shape, dtype, 22)
        _same(_port(tf.box_blur_planes, x, 5), _jax(jf.box_blur_planes, x, 5))
        _same(_port(tf.box_filter_planes, x, 4, False), _jax(jf.box_filter_planes, x, 4, False))


def test_box_blur_raises_like_jax():
    x = _planes((1, 8, 9), np.uint16, 2)
    for fn, arr in ((tf.box_blur_planes, torch.from_numpy(x)), (jf.box_blur_planes, jnp.asarray(x))):
        with pytest.raises(ValueError, match="overflow"):
            fn(arr, 201)
        with pytest.raises(ValueError, match="odd"):
            fn(arr, 4)
    with pytest.raises(TypeError):
        tf.box_blur_planes(torch.zeros((1, 8, 8), dtype=torch.int32), 3)


# ------------------------------------------------------------- Sobel / Scharr

SOBEL = [(1, 0, 3), (0, 1, 5), (1, 1, 7), (2, 0, 3), (0, 2, 5), (1, 0, 1), (1, 0, -1), (0, 1, -1)]


@pytest.mark.parametrize("dx,dy,ksize", SOBEL, ids=[str(s) for s in SOBEL])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sobel_matches_jax_and_ref(dtype, dx, dy, ksize):
    x = _planes(SHAPE, dtype, 30 + ksize)
    got = _port(tf.sobel_planes, x, dx, dy, ksize, 1.0, 7.0)
    want = _jax(jf.sobel_planes, x, dx, dy, ksize, 1.0, 7.0)
    oracle = _ref(lambda p: ref.sobel(p, dx, dy, ksize, 1.0, 7.0), x)
    if dtype == np.float32:
        assert _rel_err(got, want) < 1e-6
        # tests/test_ops_vs_ref.py:666's bound, relative to its k 5 sums
        assert _rel_err(got, oracle) < 1e-6
    else:
        _same(got, want)
        _same(got, oracle)


def _sobel_scaled_f32(p, dx, dy, ksize, scale, delta):
    """The scale path's law in NumPy f32, one rounding per op: vertical taps,
    then horizontal taps times the scale folded in f64 and rounded to f32."""
    kx, ky = ref.deriv_kernels(dx, dy, ksize)
    H, W = p.shape
    pd = np.pad(p, ((len(ky) // 2,) * 2, (len(kx) // 2,) * 2), mode="reflect").astype(np.float32)
    v = sum(np.float32(t) * pd[i:i + H, :] for i, t in enumerate(ky))
    acc = sum(np.float32(t * scale) * v[:, i:i + W] for i, t in enumerate(kx.astype(np.float64)))
    return np.round(acc + np.float32(delta))


@pytest.mark.parametrize("dx,dy,ksize", [(1, 0, 3), (0, 1, 5), (1, 0, -1)], ids=str)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16], ids=IDS[:3])
def test_sobel_scale_path(dtype, dx, dy, ksize):
    x = _planes(SHAPE, dtype, 40)
    got = _port(tf.sobel_planes, x, dx, dy, ksize, 0.37, 11.7)
    law = np.stack([_sobel_scaled_f32(p, dx, dy, ksize, 0.37, 11.7) for p in x])
    lo, hi = (-32768, 32767) if dtype == np.uint8 else (-(2**31), 2**31 - 1)
    np.testing.assert_array_equal(got, np.clip(law, lo, hi).astype(got.dtype))
    want = _jax(jf.sobel_planes, x, dx, dy, ksize, 0.37, 11.7)
    oracle = _ref(lambda p: ref.sobel(p, dx, dy, ksize, 0.37, 11.7), x)
    # R4 against JAX; ref/ folds in f64 (tests/test_ops_vs_ref.py:718's ±1)
    for other in (want, oracle):
        assert got.dtype == other.dtype
        assert np.abs(got.astype(np.int64) - other.astype(np.int64)).max() <= 1


def test_sobel_huge_delta_saturates_like_jax_and_ref():
    x = np.zeros((1, 16, 32), np.uint16)
    x[:, :, ::4] = 65535
    for delta in (2147400000.0, -4e9, 2.5e9):
        got = _port(tf.sobel_planes, x, 0, 1, 3, 1.0, delta)
        _same(got, _jax(jf.sobel_planes, x, 0, 1, 3, 1.0, delta))
        _same(got, ref.sobel(x[0], 0, 1, 3, 1.0, delta)[None])


@pytest.mark.parametrize("shape", THIN, ids=[str(s) for s in THIN])
def test_sobel_k7_on_thin_planes(shape):
    x = _planes(shape, np.uint8, 41)
    _same(_port(tf.sobel_planes, x, 1, 1, 7), _jax(jf.sobel_planes, x, 1, 1, 7))


def test_sobel_large_kernels_need_float32():
    x = _planes((1, 20, 21), np.uint8, 42)
    with pytest.raises(ValueError, match="float32"):
        tf.sobel_planes(torch.from_numpy(x), 1, 0, 15)
    xf = x.astype(np.float32)
    got = _port(tf.sobel_planes, xf, 1, 0, 15)
    assert _rel_err(got, _jax(jf.sobel_planes, xf, 1, 0, 15)) < 1e-6


def test_scharr_api_matches_jax():
    x = _planes((2, 24, 31), np.uint8, 43)
    _same(tie.scharr(torch.from_numpy(x), 0, 1, channels_last=False).numpy(),
          np.asarray(ie.scharr(x, 0, 1, channels_last=False)))


# ------------------------------------------------------------- corners

CORNERS = [(2, 3), (3, 3), (4, 5), (5, 5), (3, 1)]


@pytest.mark.parametrize("block,ksize", CORNERS, ids=[str(c) for c in CORNERS])
def test_corner_responses_match_jax_and_ref(block, ksize):
    x = _planes((2, 30, 37), np.uint8, 50 + block)
    got = _port(tf.corner_harris_planes, x, block, ksize, 0.05)
    # tests/test_features.py:74's bound (5e-6 of the largest response)
    assert _rel_err(got, _jax(jf.corner_harris_planes, x, block, ksize, 0.05)) <= 5e-6
    assert _rel_err(got, _ref(lambda p: ref.corner_harris(p, block, ksize, 0.05), x)) <= 5e-6
    got = _port(tf.corner_min_eigen_val_planes, x, block, ksize)
    # tests/test_features.py:103: the subtraction cancels on edges
    assert _rel_err(got, _jax(jf.corner_min_eigen_val_planes, x, block, ksize)) <= 5e-6
    assert _rel_err(got, _ref(lambda p: ref.corner_min_eigen_val(p, block, ksize), x)) <= 5e-6


def test_corner_responses_take_uint8_only():
    x = torch.zeros((1, 8, 8), dtype=torch.uint16)
    with pytest.raises(TypeError):
        tf.corner_harris_planes(x)
    with pytest.raises(TypeError):
        tf.corner_min_eigen_val_planes(x)


# ------------------------------------------------------------- gradients

@pytest.mark.parametrize("shape", [SHAPE] + THIN, ids=[str(s) for s in [SHAPE] + THIN])
@pytest.mark.parametrize("border", ["reflect101", "replicate"])
def test_spatial_gradient_matches_jax_and_ref(border, shape):
    x = _planes(shape, np.uint8, 60)
    dx, dy = _port(tf.spatial_gradient_planes, x, border)
    jdx, jdy = _jax(jf.spatial_gradient_planes, x, border)
    _same(dx, jdx)
    _same(dy, jdy)
    pairs = [ref.spatial_gradient(p, border) for p in x]
    _same(dx, np.stack([p[0] for p in pairs]))
    _same(dy, np.stack([p[1] for p in pairs]))


def test_spatial_gradient_api():
    x = _planes((20, 24, 3), np.uint8, 61)
    got = tie.spatial_gradient(torch.from_numpy(x), "replicate")
    want = ie.spatial_gradient(x, "replicate")
    for g, w in zip(got, want):
        _same(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        tie.spatial_gradient(torch.from_numpy(x), "constant")
    with pytest.raises(TypeError):
        tie.spatial_gradient(torch.zeros((8, 8), dtype=torch.uint16))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("ksize", [3, (5, 2), (2, 4)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_sqr_box_filter_matches_jax_and_ref(dtype, ksize, normalize):
    x = _planes(SHAPE, dtype, 70)
    got = _port(tf.sqr_box_filter_planes, x, ksize, normalize)
    with jax.enable_x64(True):
        want = _jax(jf.sqr_box_filter_planes, x, ksize, normalize)
    _same(got, want)
    _same(got, _ref(lambda p: ref.sqr_box_filter(p, ksize, normalize), x))


# ------------------------------------------------------------- stackBlur

@pytest.mark.parametrize("ksize", [1, 3, 5, 9, 13, (3, 9), (11, 1)], ids=str)
def test_stack_blur_matches_jax_and_ref(ksize):
    x = _planes((2, 30, 40), np.uint8, 80)
    got = _port(tf.stack_blur_planes, x, ksize)
    _same(got, _jax(jf.stack_blur_planes, x, ksize))
    _same(got, _ref(lambda p: ref_stack_blur(p, ksize), x))


def test_stack_blur_api_and_rejects():
    x = _planes((20, 24, 3), np.uint8, 81)
    _same(tie.stack_blur(torch.from_numpy(x), 5).numpy(), np.asarray(ie.stack_blur(x, 5)))
    with pytest.raises(ValueError):
        tie.stack_blur(torch.zeros((8, 8), dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        tie.stack_blur(torch.zeros((8, 8), dtype=torch.uint8), 129)
    with pytest.raises(TypeError):
        tie.stack_blur(torch.zeros((8, 8), dtype=torch.uint16), 3)


# ------------------------------------------------------------- the api

API = [
    ("laplacian", (3, 2.0), DTYPES),
    ("laplacian_sharpen", (), DTYPES),
    ("sobel", (0, 1, 5, 1.0, 3.0), DTYPES),
    ("box_blur", ((3, 5),), DTYPES),
    ("box_filter", (4, False), DTYPES),
    ("sqr_box_filter", (3, False), DTYPES),
    ("corner_harris", (3, 3, 0.04), [np.uint8]),
    ("corner_min_eigen_val", (2, 3), [np.uint8]),
]


@pytest.mark.parametrize("name,args,dtypes", API, ids=[a[0] for a in API])
def test_api_matches_jax_on_hwc_and_batches(name, args, dtypes):
    for dtype in dtypes:
        for shape in ((20, 24, 3), (2, 16, 20)):
            x = _planes(shape, dtype, 90)
            got = getattr(tie, name)(torch.from_numpy(x), *args).numpy()
            with jax.enable_x64(name == "sqr_box_filter"):
                want = np.asarray(getattr(ie, name)(x, *args))
            if got.dtype == np.float32 and name in ("laplacian", "sobel", "corner_harris",
                                                     "corner_min_eigen_val"):
                assert _rel_err(got, want) < 5e-6, (name, shape)
            else:
                _same(got, want)


def test_api_rejects_what_jax_rejects():
    i32 = torch.zeros((8, 8), dtype=torch.int32)
    for name in ("laplacian", "laplacian_sharpen", "sobel", "scharr", "box_blur", "box_filter",
                 "sqr_box_filter", "stack_blur", "gaussian_blur", "unsharp_mask"):
        with pytest.raises(TypeError):
            getattr(tie, name)(i32, *((3,) if name == "stack_blur" else ()))
    i16 = torch.zeros((8, 8), dtype=torch.int16)
    for name in ("corner_harris", "corner_min_eigen_val", "stack_blur"):
        with pytest.raises(TypeError):
            getattr(tie, name)(i16, *((3,) if name == "stack_blur" else ()))
