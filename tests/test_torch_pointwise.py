"""Config 2 and the point ops (ops/pointwise.py, ops/histogram.py, the api
and the gamma_stretch preset; addWeighted, integral, applyColorMap and
calcBackProject) held to the JAX package and to ref/ — and,
where the JAX package is off cv2 (ROADMAP R3: its i16 stretch), to cv2 —
at 0 LSB on every integer path; f32 paths within the JAX package's own
tolerances (tests/test_ops_vs_ref.py:202-211).  The copied host tables bit
for bit, and the launches each path makes with the kernels stubbed."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.models.presets import get_preset as jax_get_preset
from imageenhancement_mp_tpu.ops import pointwise as jpoint
from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes as jax_eq_global
from imageenhancement_mp_tpu.ref import colormaps as ref_colormaps
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.ops import histogram as thist
from imageenhancement_mp_tpu_torch.ops import pointwise as tpoint
from imageenhancement_mp_tpu_torch.utils import colormaps as tcolormaps
from imageenhancement_mp_tpu_torch.utils import lut_tables

cv2.setNumThreads(1)
F32_TOL = {"gamma": 2e-2, "log_transform": 2e-2, "contrast_stretch": 1e-3}


def _img(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 300.0 - 20.0).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)


def _per_plane(fn, x):
    """ref/'s function on each plane of a [N, H, W] batch."""
    return np.stack([fn(p) for p in x])


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


# -- the copied host tables --------------------------------------------------------

@pytest.mark.parametrize("g", [0.25, 1.0, 2.2, 3.7])
def test_tables_equal_the_jax_packages(g):
    pairs = [(lut_tables.gamma_lut_host(g), jpoint.gamma_lut_host(g)),
             (lut_tables.gamma_lut_host(g), ref_ops.gamma_lut(g)),
             (lut_tables.gamma_lut16(g), ref_ops.gamma_lut16(g)),
             (lut_tables.log_lut_host(), jpoint.log_lut_host()),
             (lut_tables.log_lut_host(), ref_ops.log_lut()),
             (lut_tables.log_lut16(), ref_ops.log_lut16())]
    for alpha, beta in ((g, -3.5), (-g, 100.25), (0.0039, 0.5)):
        for n, offset in ((256, 0), (65536, 0), (65536, -32768)):
            pairs.append((lut_tables.convert_scale_abs_lut(alpha, beta, n, offset),
                          ref_ops.convert_scale_abs_lut(alpha, beta, n, offset)))
    for mine, theirs in pairs:
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


# -- gamma, log and convertScaleAbs ------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("op,args,ref_fn", [
    ("gamma", (2.2,), lambda p: ref.gamma_transform(p, 2.2)),
    ("gamma", (0.45,), lambda p: ref.gamma_transform(p, 0.45)),
    ("log_transform", (), ref.log_transform)], ids=["gamma2.2", "gamma0.45", "log"])
def test_gamma_and_log_match_jax_and_ref(op, args, ref_fn, dtype):
    x = _img((2, 23, 41), dtype, 50)
    if dtype == np.float32:
        x = np.abs(x)
    got = getattr(tie, op)(torch.from_numpy(x), *args).numpy()
    want, oracle = np.asarray(getattr(jie, op)(x, *args)), _per_plane(ref_fn, x)
    assert got.dtype == want.dtype == oracle.dtype and got.shape == x.shape
    if dtype == np.float32:
        assert np.abs(got - want).max() < F32_TOL[op] and np.abs(got - oracle).max() < F32_TOL[op]
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (1.7, -3.2), (-0.5, 10.5), (0.0039, 0.5)])
def test_convert_scale_abs_matches_jax_ref_and_cv2(dtype, alpha, beta):
    x = _img((2, 23, 41), dtype, 51)
    x.reshape(-1)[:2] = (np.iinfo(dtype).min, np.iinfo(dtype).max) if dtype != np.float32 \
        else (-100.5, 0.5)
    got = tie.convert_scale_abs(torch.from_numpy(x), alpha, beta).numpy()
    assert got.dtype == np.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got, np.asarray(jie.convert_scale_abs(x, alpha, beta)))
    np.testing.assert_array_equal(got, _per_plane(lambda p: ref.convert_scale_abs(p, alpha, beta), x))
    np.testing.assert_array_equal(got, _per_plane(lambda p: cv2.convertScaleAbs(p, alpha=alpha,
                                                                               beta=beta), x))


# -- contrast stretch ----------------------------------------------------------------

RANGES = [(0.0, 255.0), (10.5, 200.25), (200.25, 10.5), (-7.3, 300.9), (3.0, 3.0)]


@pytest.mark.parametrize("out_range", RANGES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_contrast_stretch_u8_u16_match_jax_and_ref(dtype, out_range):
    x = _img((3, 19, 23), dtype, 52)
    x[1] = x[1] // 3 + 5  # a narrow range
    x[2] = x[2, 0, 0]     # a constant plane
    got = tie.contrast_stretch(torch.from_numpy(x), out_range).numpy()
    np.testing.assert_array_equal(got, np.asarray(jie.contrast_stretch(x, out_range)))
    np.testing.assert_array_equal(got, _per_plane(lambda p: ref.contrast_stretch(p, out_range), x))


@pytest.mark.parametrize("out_range", RANGES + [(-30000.5, 30000.0)])
def test_contrast_stretch_i16_matches_ref_and_cv2(out_range):
    """0 LSB against ref/ and cv2; ±1 against JAX, whose i16 tables are the
    R3 fault."""
    x = _img((3, 19, 23), np.int16, 53)
    x[1] = x[1] // 7
    x[2] = x[2, 0, 0]
    got = tie.contrast_stretch(torch.from_numpy(x), out_range).numpy()
    np.testing.assert_array_equal(got, _per_plane(lambda p: ref.contrast_stretch(p, out_range), x))
    a, b = out_range
    np.testing.assert_array_equal(
        got, _per_plane(lambda p: cv2.normalize(p, None, a, b, cv2.NORM_MINMAX), x))
    assert _maxdiff(got, jie.contrast_stretch(x, out_range)) <= 1


@pytest.mark.parametrize("out_range", RANGES[:3])
def test_contrast_stretch_f32_within_tolerance(out_range):
    x = _img((3, 19, 23), np.float32, 54)
    x[2] = 7.5
    got = tie.contrast_stretch(torch.from_numpy(x), out_range).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - np.asarray(jie.contrast_stretch(x, out_range))).max() < 1e-3
    assert np.abs(got - _per_plane(lambda p: ref.contrast_stretch(p, out_range), x)).max() < 1e-3
    assert np.all(got[2] == min(out_range))


@pytest.mark.parametrize("dtype,minv,maxv", [(np.uint8, 0, 255), (np.uint16, 0, 65535)])
def test_stretch_luts_match_jax(dtype, minv, maxv):
    """The tables alone, bit for bit, with equal and adjacent min/max."""
    lo = np.array([0, 5, 9, maxv - 1, 0, 77], np.int32)
    hi = np.array([maxv, 5, 200, maxv, 1, 78], np.int32)
    for a, b in ((0.0, 255.0), (-3.25, 1000.5), (17.0, 17.0)):
        got = tpoint.stretch_luts_from_minmax(torch.from_numpy(lo), torch.from_numpy(hi), a, b,
                                              maxv, torch.from_numpy(np.zeros(1, dtype)).dtype,
                                              minv)
        want = jpoint.stretch_luts_from_minmax(jnp.asarray(lo), jnp.asarray(hi), a, b, maxv,
                                               jnp.dtype(dtype), minv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- pooled equalize_hist ------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_equalize_hist_global_matches_jax(channels):
    x = _img((6, 20, 30), np.uint8, 55)
    x[::3] //= 4  # channel 0 darker: pooled per channel differs from pooled over all
    got = thist.equalize_hist_global_planes(torch.from_numpy(x), channels).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_eq_global(jnp.asarray(x), channels=channels)))


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(3, 20, 30, 3), (20, 30, 3), (4, 20, 30), (20, 30)])
def test_equalize_hist_pooled_api_matches_jax(shape, per_channel):
    x = _img(shape, np.uint8, 56)
    got = tie.equalize_hist(torch.from_numpy(x), per_frame=False, per_channel=per_channel)
    want = jie.equalize_hist(x, per_frame=False, per_channel=per_channel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_equalize_hist_pooled_rejects():
    """JAX's ValueError past 2^31 pooled pixels (checked from the shape,
    before any pixel is read), a plane count not divisible by channels,
    an axis_name outside a sharded call (as JAX's unbound axis), non-u8
    planes."""
    big = torch.zeros((1, 1, 1), dtype=torch.uint8).expand(1024, 1024, 2048)
    with pytest.raises(ValueError, match="2\\^31"):
        thist.equalize_hist_global_planes(big)
    with pytest.raises(ValueError, match="2\\^31"):
        jax.eval_shape(jax_eq_global, jax.ShapeDtypeStruct((1024, 1024, 2048), jnp.uint8))
    with pytest.raises(ValueError):
        thist.equalize_hist_global_planes(torch.zeros((4, 3, 3), dtype=torch.uint8), 3)
    with pytest.raises(NameError, match="unbound axis name"):
        thist.equalize_hist_global_planes(torch.zeros((3, 3, 3), dtype=torch.uint8),
                                          axis_name="x")
    with pytest.raises(TypeError):
        tie.equalize_hist(torch.zeros((3, 3), dtype=torch.uint16), per_frame=False)


# -- config 2 through the preset, and the registry ---------------------------------

@pytest.mark.parametrize("shape", [(2, 37, 131, 3), (3, 40, 72)])
def test_gamma_stretch_preset_matches_jax_and_ref(shape):
    x = _img(shape, np.uint8, 57)
    got = tie.get_preset("gamma_stretch")(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_get_preset("gamma_stretch")(x)))
    planes = x if len(shape) == 3 else np.moveaxis(x, -1, 1).reshape(-1, *shape[1:3])
    got_planes = got if len(shape) == 3 else np.moveaxis(got, -1, 1).reshape(-1, *shape[1:3])
    np.testing.assert_array_equal(
        got_planes, _per_plane(lambda p: ref.contrast_stretch(ref.gamma_transform(p, 2.2)), planes))


def test_point_ops_through_make_pipeline():
    x = torch.from_numpy(_img((2, 24, 40), np.uint8, 58))
    pipe = tie.make_pipeline([("gamma", {"gamma": 0.5}), "log_transform",
                              ("convert_scale_abs", {"alpha": 1.5, "beta": -2.0}),
                              ("contrast_stretch", {"out_range": (20.0, 230.0)}),
                              ("equalize_hist_global", {"channels": 2})])
    want = tie.contrast_stretch(tie.convert_scale_abs(tie.log_transform(tie.gamma(x, 0.5)),
                                                      1.5, -2.0), (20.0, 230.0))
    want = thist.equalize_hist_global_planes(want, 2)
    np.testing.assert_array_equal(pipe(x).numpy(), want.numpy())


def test_apply_lut_api_matches_jax():
    x = _img((2, 20, 30, 3), np.uint8, 59)
    rng = np.random.default_rng(59)
    for lut in (rng.integers(0, 256, 256).astype(np.uint8),
                rng.integers(-300, 600, (6, 256)).astype(np.int32),
                rng.random(256, dtype=np.float32) * 255):
        got = tie.apply_lut(torch.from_numpy(x), lut).numpy()
        np.testing.assert_array_equal(got, np.asarray(jie.apply_lut(x, lut)))
        np.testing.assert_array_equal(tie.apply_lut(torch.from_numpy(x), torch.from_numpy(lut))
                                      .numpy(), got)
    with pytest.raises(TypeError):
        tie.apply_lut(torch.from_numpy(x).to(torch.uint16), lut)


def test_point_ops_reject_what_jax_rejects():
    x = torch.zeros((4, 5), dtype=torch.int16)
    for dtype in (torch.int16, torch.int32):
        with pytest.raises(TypeError):
            tie.gamma(x.to(dtype), 2.0)
        with pytest.raises(TypeError):
            tie.log_transform(x.to(dtype))
    for fn in (tie.contrast_stretch, tie.convert_scale_abs):
        with pytest.raises(TypeError):
            fn(x.to(torch.int32))
        with pytest.raises(TypeError):
            fn(x.to(torch.float64))


# -- the launches each path makes, kernels stubbed ---------------------------------

def test_launches_of_each_path(monkeypatch):
    """gamma_stretch: two apply_lut256 launches and no other; pooled
    equalize: one hist256_lut (one group a channel), one apply_lut256; an f32
    table on u8 planes: one apply_lut256_wide; u16 and i16 planes, and f32
    point ops: none."""
    calls = []
    monkeypatch.setattr(khist, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(khist, "launch", lambda name, *args: calls.append(name))

    def launches(fn):
        calls.clear()
        fn()
        return sorted(calls)

    rgb = torch.zeros((2, 16, 24, 3), dtype=torch.uint8)
    assert launches(lambda: tie.get_preset("gamma_stretch")(rgb)) == ["apply_lut256"] * 2
    assert launches(lambda: tie.equalize_hist(rgb, per_frame=False)) == [
        "apply_lut256", "hist256_lut"]
    planes = torch.zeros((8, 12, 20), dtype=torch.uint8)
    assert launches(lambda: tpoint.apply_lut_planes(planes, torch.zeros(256))) == [
        "apply_lut256_wide"]
    assert launches(lambda: tie.convert_scale_abs(planes, 2.0, 1.0)) == ["apply_lut256"]
    for dtype in (torch.uint16, torch.int16, torch.float32):
        assert launches(lambda: tie.contrast_stretch(planes.to(dtype))) == []
        assert launches(lambda: tie.convert_scale_abs(planes.to(dtype))) == []
    assert launches(lambda: tie.gamma(planes.to(torch.uint16), 2.2)) == []
    assert launches(lambda: tie.histogram(planes.to(torch.uint16))) == []


# -- addWeighted, integral, applyColorMap, calcBackProject -------------------------

FOUR = [np.uint8, np.uint16, np.int16, np.float32]
FOUR_IDS = ["u8", "u16", "i16", "f32"]


@pytest.mark.parametrize("weights", [(0.7, -0.33, 12.5), (1.0, 1.0, 0.0), (0.5, 0.5, 0.5),
                                     (-1.25, 2.0, -100.0), (1e-3, 3e4, 7.0)])
@pytest.mark.parametrize("dtype", FOUR, ids=FOUR_IDS)
def test_add_weighted_matches_jax_and_ref(dtype, weights):
    """0 against both for every dtype: two single-rounded f32 FMAs."""
    a, b = _img((2, 37, 41), dtype, 71), _img((2, 37, 41), dtype, 72)
    al, be, ga = weights
    got = tpoint.add_weighted_arrays(torch.from_numpy(a), al, torch.from_numpy(b), be, ga).numpy()
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, np.asarray(jpoint.add_weighted_arrays(
        jnp.asarray(a), al, jnp.asarray(b), be, ga)))
    np.testing.assert_array_equal(got, ref.add_weighted(a, al, b, be, ga))
    np.testing.assert_array_equal(tie.add_weighted(torch.from_numpy(a), al, torch.from_numpy(b),
                                                   be, ga).numpy(), got)


def test_add_weighted_rejects_like_jax():
    a = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tie.add_weighted(a, 1.0, a.to(torch.uint16), 1.0)
    with pytest.raises(ValueError):
        tie.add_weighted(a, 1.0, a[:3], 1.0)
    with pytest.raises(TypeError):
        tie.add_weighted(a.to(torch.int32), 1.0, a.to(torch.int32), 1.0)


@pytest.mark.parametrize("shape", [(2, 37, 41), (1, 1, 1), (1, 3, 5)])
@pytest.mark.parametrize("dtype", FOUR, ids=FOUR_IDS)
def test_integral_matches_ref_and_jax(dtype, shape):
    """u8: int32, 0 against ref/ and JAX.  u16/i16/f32: f32 sums equal to
    f32(ref/'s f64 sums); JAX's f32 sums within 1e-6 of them, relative to
    the largest magnitude (docs/PARITY.md: ~1e-7)."""
    x = _img(shape, dtype, 73)
    s, s2 = tpoint.integral_planes(torch.from_numpy(x), sq=True)
    want = [ref.integral(p, sq=True) for p in x]
    js, js2 = jpoint.integral_planes(jnp.asarray(x), sq=True)
    assert s.dtype == (torch.int32 if dtype == np.uint8 else torch.float32)
    assert s2.dtype == torch.float32 and s.shape == (shape[0], shape[1] + 1, shape[2] + 1)
    np.testing.assert_array_equal(s.numpy(), np.stack([w[0] for w in want]).astype(s.numpy().dtype))
    np.testing.assert_array_equal(s2.numpy(), np.stack([w[1] for w in want]).astype(np.float32))
    for got, jax_out in ((s.numpy(), js), (s2.numpy(), js2)):
        scale = max(float(np.abs(got).max()), 1.0)
        assert np.abs(got.astype(np.float64) - np.asarray(jax_out)).max() <= 1e-6 * scale
    np.testing.assert_array_equal(tpoint.integral_planes(torch.from_numpy(x)).numpy(), s.numpy())


def test_integral_api_matches_jax():
    x = _img((2, 20, 30, 3), np.uint8, 74)
    got = tie.integral(torch.from_numpy(x))
    assert got.shape == (6, 21, 31)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jie.integral(x)))
    with pytest.raises(TypeError):
        tie.integral(torch.from_numpy(x).to(torch.int32))


def test_colormaps_are_refs():
    assert tcolormaps.COLORMAPS == tuple(ref_colormaps._TABLES)
    for name in tcolormaps.COLORMAPS:
        t = tcolormaps.colormap_table(name)
        assert t.dtype == np.uint8 and t.shape == (256, 3)
        np.testing.assert_array_equal(t, ref_colormaps.colormap_table(name))
    with pytest.raises(ValueError):
        tcolormaps.colormap_table("nope")


@pytest.mark.parametrize("name", ["jet", "turbo", "viridis", "twilight_shifted", "deepgreen"])
def test_apply_color_map_matches_jax_and_ref(name):
    x = _img((2, 37, 41), np.uint8, 75)
    got = tpoint.apply_color_map_planes(torch.from_numpy(x), name).numpy()
    assert got.shape == (2, 37, 41, 3)
    np.testing.assert_array_equal(got, np.asarray(jpoint.apply_color_map_planes(jnp.asarray(x),
                                                                                name)))
    np.testing.assert_array_equal(got, _per_plane(lambda p: ref.apply_color_map(p, name), x))
    api = tie.apply_color_map(torch.from_numpy(x[0]), name).numpy()
    np.testing.assert_array_equal(api, np.asarray(jie.apply_color_map(x[0], name)))
    with pytest.raises(TypeError):
        tie.apply_color_map(torch.from_numpy(x).to(torch.uint16), name)


@pytest.mark.parametrize("bins,scale", [(256, 1.0), (30, 0.9), (7, 300.0), (1, 2.5), (1000, 0.5)])
def test_calc_back_project_matches_jax_and_ref(bins, scale):
    x = _img((2, 37, 41), np.uint8, 76)
    hist = np.random.default_rng(bins).random(bins) * 300
    got = tpoint.calc_back_project_planes(torch.from_numpy(x), hist, scale).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpoint.calc_back_project_planes(
        jnp.asarray(x), hist, scale)))
    np.testing.assert_array_equal(got, _per_plane(
        lambda p: ref.calc_back_project(p, hist, scale), x))
    api = tie.calc_back_project(torch.from_numpy(x[0]), hist, scale).numpy()
    np.testing.assert_array_equal(api, np.asarray(jie.calc_back_project(x[0], hist, scale)))
    with pytest.raises(TypeError):
        tie.calc_back_project(torch.from_numpy(x).to(torch.int16), hist)


def test_calc_back_project_launches_apply_lut256_once(monkeypatch):
    """On CUDA (on_cuda forced, launch stubbed): one apply_lut256 with the
    folded u8 table, nothing else; the other point ops of this slice launch
    no kernel."""
    calls = []
    monkeypatch.setattr(khist, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(khist, "launch", lambda name, *args: calls.append((name, args)))
    x = torch.from_numpy(_img((3, 20, 30), np.uint8, 77))
    hist = np.arange(16, dtype=np.float64) * 20
    tie.calc_back_project(x, hist, 0.75, channels_last=False)
    assert [c[0] for c in calls] == ["apply_lut256"]
    table = tpoint._back_project_lut(tuple(hist), 0.75, x.device)
    assert calls[0][1][2] == table.data_ptr()      # device, planes, the cached table
    np.testing.assert_array_equal(table.numpy(), ref.calc_back_project(
        np.arange(256, dtype=np.uint8)[None], hist, 0.75)[0])
    calls.clear()
    tie.add_weighted(x, 0.5, x, 0.5, 1.0)
    tie.integral(x, sq=True, channels_last=False)
    tie.apply_color_map(x, "hot", channels_last=False)
    assert calls == []
