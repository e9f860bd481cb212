"""The port's colour conversions (ops/color.py, utils/color_tables.py, the
api's cvt_color, cvt_gray, equalize_luma and clahe_lab) held to the JAX
package, with its K12 table lookups in interpret mode
(``config.use_pallas_kernels = True``), and to ref/.

Integer paths: 0 LSB against JAX and ref/ (u8 ``luv2rgb`` is f32 ``pow``:
±1 against JAX, and ref/ is f64, so it is held to JAX only).  f32 gray and
YCrCb are the same ``fma32`` chains, bitwise.  The other f32 paths are
float formulas evaluated by two libraries: XYZ within 1e-6, the Lab and Luv
forwards within 1e-3 (torch has no ``cbrt``), their inverses within 1e-5.
The copied host tables equal the JAX package's bit for bit."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import color as jcolor
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.api import _CVT_CODES
from imageenhancement_mp_tpu_torch.kernels import take as kt
from imageenhancement_mp_tpu_torch.ops import color as tcolor
from imageenhancement_mp_tpu_torch.utils import color_tables as ct

DTYPES = (np.uint8, np.uint16, np.float32)
# f32 tolerance per colour space and direction (absolute)
F32_TOL = {"xyz": (1e-6, 1e-6), "lab": (1e-3, 1e-5), "luv": (1e-3, 1e-5)}


def _img(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.fixture
def pallas_on():
    config.use_pallas_kernels = True
    try:
        yield
    finally:
        config.use_pallas_kernels = None


def _jax_or_error(fn, *args):
    try:
        return np.asarray(fn(*args))
    except (TypeError, ValueError) as e:
        return type(e)


def _space(code):
    for name in ("ycrcb", "hsv", "hls", "xyz", "lab", "luv", "gray"):
        if name in code:
            return name
    raise AssertionError(code)


# -- the copied host tables ------------------------------------------------------

def test_tables_equal_the_jax_packages():
    """Every constant and table copied from ref/ops.py, bit for bit."""
    for a, b in zip(ct.hsv_tables(), ref_ops._hsv_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ct.HSV_SHIFT == ref_ops._HSV_SHIFT and ct.HSV_SECTOR == ref_ops._HSV_SECTOR
    assert ct.HLS_SECTOR == ref_ops._HLS_SECTOR
    for name in ("XYZ_FWD", "XYZ_INV", "LAB_WHITE", "LAB_C_FWD", "LAB_C_INV"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(ref_ops, "_" + name))
    for name in ("LUV_UN", "LUV_VN", "LUV_UP_RANGE", "LUV_VP_RANGE"):
        assert getattr(ct, name) == getattr(ref_ops, "_" + name)
    for a, b in zip(ct.lab_tabs(), ref_ops._lab_tabs()):
        np.testing.assert_array_equal(a, b)
    assert ct.lab_tabs()[1][49] == ref_ops._lab_tabs()[1][49]  # the pinned cbrt flips
    assert ct.lab_tabs()[1][628] == ref_ops._lab_tabs()[1][628]
    for a, b in zip(ct.luv_u8_tabs(), ref_ops._luv_u8_tabs()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).random((5, 7, 3))
    np.testing.assert_array_equal(ct.luv_fwd_f64(x), ref_ops._luv_fwd_f64(x))
    for v in (-7, 0, 5, 841, -841):
        np.testing.assert_array_equal(ct._trunc_div(np.array(v * 13), 841),
                                      ref_ops._trunc_div(np.array(v * 13), 841))


def test_interop_color_tables_from_jax():
    """The JAX package's device tables through interop equal the tables the
    port puts on the CPU."""
    lab, luv = interop.color_tables_from_jax(jcolor._lab_device_tabs(), jcolor._luv_host_tabs())
    mine = tcolor._lab_device_tabs(torch.device("cpu"))
    assert len(lab) == len(mine) == 9 and lab[6] == mine[6] == -8145
    for a, b in zip(lab[:6] + lab[7:], mine[:6] + mine[7:]):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    for a, b in zip(luv, tcolor._luv_device_tabs(torch.device("cpu"))[:4]):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    with pytest.raises(ValueError):
        interop.color_tables_from_jax(jcolor._lab_device_tabs()[:8], jcolor._luv_host_tabs())
    bad = list(jcolor._lab_device_tabs())
    bad[7] = np.asarray(bad[7])[:-1]
    with pytest.raises(ValueError):
        interop.color_tables_from_jax(bad, jcolor._luv_host_tabs())


# -- every code and dtype against JAX with K12 in interpret mode -----------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("code", _CVT_CODES)
def test_cvt_color_matches_jax(pallas_on, code, dtype):
    shape = (2, 9, 13, 4 if code.startswith(("rgba", "bgra")) else 3)
    x = _img(shape, dtype, _CVT_CODES.index(code))
    want = _jax_or_error(jie.cvt_color, x, code)
    if isinstance(want, type):  # a dtype JAX does not take: the port raises the same
        with pytest.raises(want):
            tie.cvt_color(torch.from_numpy(x), code)
        return
    got = tie.cvt_color(torch.from_numpy(x), code).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    space = _space(code)
    if dtype == np.float32 and space in F32_TOL:
        tol = F32_TOL[space][0 if code.startswith(("rgb", "bgr")) else 1]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    elif code.startswith("luv") and dtype == np.uint8:
        diff = np.abs(got.astype(np.int64) - want)
        assert diff.max() <= 1, f"{np.mean(diff > 0):.4%} of values differ"
    else:
        np.testing.assert_array_equal(got, want)


REF_FNS = {"2gray": ref.cvt_gray, "2ycrcb": ref.rgb_to_ycrcb, "ycrcb2": ref.ycrcb_to_rgb,
           "2hsv": ref.rgb_to_hsv, "hsv2": ref.hsv_to_rgb, "2hls": ref.rgb_to_hls,
           "hls2": ref.hls_to_rgb, "2xyz": ref.rgb_to_xyz, "xyz2": ref.xyz_to_rgb,
           "2lab": ref.rgb_to_lab, "lab2": ref.lab_to_rgb, "2luv": ref.rgb_to_luv}


@pytest.mark.parametrize("code", [c for c in _CVT_CODES if not c.startswith("luv")])
def test_cvt_color_u8_matches_ref(code):
    """Every u8 integer path against ref/, one image, 0 LSB.  HSV → RGB is
    held to cv2 itself, on rows of whole 32-pixel SIMD blocks (cv2's scalar
    row tail rounds otherwise): ref/'s plain f32 chain rounds cv2's
    single-rounded inner terms twice (ROADMAP R6)."""
    key = next(k for k in REF_FNS if k in code)
    width = 64 if key == "hsv2" else 17
    x = _img((11, width, 4 if code.startswith(("rgba", "bgra")) else 3), np.uint8, 40)
    bgr = code.startswith("b") if key.startswith("2") else code.endswith("bgr")
    order = "bgr" if bgr else "rgb"
    if key == "hsv2":
        x[..., 0] %= 180
        want = cv2.cvtColor(x, cv2.COLOR_HSV2BGR if bgr else cv2.COLOR_HSV2RGB)
    else:
        want = REF_FNS[key](x, order)
    np.testing.assert_array_equal(tie.cvt_color(torch.from_numpy(x), code).numpy(), want)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_hsv2rgb_equals_cv2_on_every_input(order):
    """All 180·256·256 valid u8 HSV pixels as one 180×65536 image (rows of
    whole SIMD blocks), 0 LSB against cv2; the plain f32 chain missed 1758
    of them by 1."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    x = np.stack([h, s, v], -1).astype(np.uint8).reshape(180, 65536, 3)
    want = cv2.cvtColor(x, cv2.COLOR_HSV2BGR if order == "bgr" else cv2.COLOR_HSV2RGB)
    got = tcolor.hsv_to_rgb_nhwc(torch.from_numpy(x), order).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("srgb", [True, False])
@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_lab_u8_both_ways_with_and_without_srgb(pallas_on, order, srgb):
    """The Lab legs, ``srgb=False`` (the linear-RGB variant colour NLMeans
    uses) too, and the round trip through the 36864-entry table: against
    ref/, and with ``srgb=False``, which cvt_color does not reach, against
    JAX's ops."""
    x = _img((2, 15, 21, 3), np.uint8, 41)
    lab = tcolor.rgb_to_lab_nhwc(torch.from_numpy(x), order, srgb)
    back = tcolor.lab_to_rgb_nhwc(lab, order, srgb)
    for i in range(2):
        np.testing.assert_array_equal(lab[i].numpy(), ref.rgb_to_lab(x[i], order, srgb))
        np.testing.assert_array_equal(back[i].numpy(), ref.lab_to_rgb(lab[i].numpy(), order, srgb))
    if not srgb:
        want = jcolor.rgb_to_lab_nhwc(jnp.asarray(x), order, srgb)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want))
        want = jcolor.lab_to_rgb_nhwc(jnp.asarray(lab.numpy()), order, srgb)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_every_u8_lab_input_matches_ref():
    """All 256 values in each channel (a 256×256 grid of two channels, the
    third a mix of both): every entry of the u8-indexed tables is read."""
    i, j = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    x = np.stack([i, j, (7 * i + j) % 256], -1).astype(np.uint8)
    for srgb in (True, False):
        np.testing.assert_array_equal(tcolor.rgb_to_lab_nhwc(torch.from_numpy(x), "rgb", srgb)
                                      .numpy(), ref.rgb_to_lab(x, "rgb", srgb))
        np.testing.assert_array_equal(tcolor.lab_to_rgb_nhwc(torch.from_numpy(x), "rgb", srgb)
                                      .numpy(), ref.lab_to_rgb(x, "rgb", srgb))
    np.testing.assert_array_equal(tcolor.rgb_to_luv_nhwc(torch.from_numpy(x)).numpy(),
                                  ref.rgb_to_luv(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9, 13, 3), (2, 9, 13, 4)])
def test_cvt_gray_matches_jax(shape, dtype):
    x = _img(shape, dtype, 42)
    for order in ("rgb", "bgr"):
        got = tie.cvt_gray(torch.from_numpy(x), order).numpy()
        np.testing.assert_array_equal(got, np.asarray(jie.cvt_gray(x, order)))
        np.testing.assert_array_equal(got[0] if x.ndim == 4 else got,
                                      ref.cvt_gray(x[0] if x.ndim == 4 else x, order))


def test_cbrt_is_odd_like_jnp():
    x = torch.tensor([-27.0, -1e-3, -0.0, 0.0, 1e-30, 0.008, 8.0, 1000.0])
    got = tcolor._cbrt(x).numpy()
    np.testing.assert_allclose(got, np.cbrt(x.numpy()), rtol=1e-6, atol=0)
    assert got[3] == 0 and np.all(np.sign(got) == np.sign(x.numpy()))


# -- the composites ---------------------------------------------------------------

@pytest.mark.parametrize("order", ["rgb", "bgr"])
@pytest.mark.parametrize("shape", [(19, 23, 3), (2, 19, 23, 3)])
def test_equalize_luma_matches_jax_and_ref(pallas_on, shape, order):
    x = _img(shape, np.uint8, 43)
    got = tie.equalize_luma(torch.from_numpy(x), order).numpy()
    np.testing.assert_array_equal(got, np.asarray(jie.equalize_luma(x, order)))
    one = x[-1] if x.ndim == 4 else x
    ycc = ref.rgb_to_ycrcb(one, order)
    ycc[..., 0] = ref.equalize_hist(ycc[..., 0])
    np.testing.assert_array_equal(got[-1] if x.ndim == 4 else got, ref.ycrcb_to_rgb(ycc, order))


@pytest.mark.parametrize("shape,clip,grid", [((26, 37, 3), 2.0, (2, 2)),
                                             ((2, 26, 37, 3), 40.0, (3, 4)),
                                             ((26, 37, 3), 0.0, (1, 1))])
def test_clahe_lab_matches_ref_and_jax(pallas_on, shape, clip, grid):
    """0 LSB against ref/'s composite; against JAX ±1, its CPU CLAHE tier
    (ROADMAP R4)."""
    x = _img(shape, np.uint8, 44)
    got = tie.clahe_lab(torch.from_numpy(x), clip, grid, "bgr").numpy()
    want = np.asarray(jie.clahe_lab(x, clip, grid, "bgr")).astype(np.int64)
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    for g, img in zip(got.reshape((-1,) + got.shape[-3:]), x.reshape((-1,) + x.shape[-3:])):
        lab = ref.rgb_to_lab(img, "bgr")
        lab[..., 0] = ref.clahe(lab[..., 0], clip, grid)
        np.testing.assert_array_equal(g, ref.lab_to_rgb(lab, "bgr"))


# -- K12's launches per call, and the api's checks --------------------------------

TAKES = {  # call -> take_table launches (one per JAX _take1 evaluation)
    "rgb2lab": 6, "bgr2lab": 6, "lab2rgb": 9, "lab2bgr": 9, "rgb2luv": 25, "bgr2luv": 25,
    "luv2rgb": 0, "rgb2gray": 0, "rgb2hsv": 0, "hsv2rgb": 0, "rgb2hls": 0, "rgb2xyz": 0,
    "rgb2ycrcb": 0,
}


def _count_takes(monkeypatch):
    calls = []

    def counting_on_cuda(t, name):
        calls.append(name)
        return False

    monkeypatch.setattr(kt, "on_cuda", counting_on_cuda)
    return calls


@pytest.mark.parametrize("code", list(TAKES))
def test_take_table_calls_per_conversion(monkeypatch, code):
    calls = _count_takes(monkeypatch)
    tie.cvt_color(torch.from_numpy(_img((2, 5, 6, 3), np.uint8, 45)), code)
    assert calls == ["take_table"] * TAKES[code]


def test_take_table_calls_of_the_composites(monkeypatch):
    calls = _count_takes(monkeypatch)
    x = torch.from_numpy(_img((1, 16, 16, 3), np.uint8, 46))
    tie.clahe_lab(x)
    assert len(calls) == 15
    calls.clear()
    tie.equalize_luma(x)
    tcolor.rgb_to_lab_nhwc(x, srgb=False)
    assert len(calls) == 3
    tcolor.lab_to_rgb_nhwc(x, srgb=False)
    assert len(calls) == 9


def test_api_rejects_what_jax_rejects():
    x = torch.zeros((4, 5, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.cvt_color(x, "rgb2cmyk")
    with pytest.raises(TypeError):
        tie.cvt_color(x.to(torch.int16), "rgb2gray")
    with pytest.raises(ValueError):
        tie.cvt_color(x[0], "rgb2gray")
    with pytest.raises(TypeError):
        tie.cvt_color(x.to(torch.uint16), "rgb2hsv")
    with pytest.raises(TypeError):
        tie.equalize_luma(x.float())
    with pytest.raises(ValueError):
        tie.clahe_lab(torch.zeros((4, 5, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tie.clahe_lab(x, order="xyz")
    with pytest.raises(ValueError):
        tie.cvt_gray(x, "grb")
