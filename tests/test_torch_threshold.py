"""The port's thresholds (ops/threshold.py, kernels/athresh.py plain version,
utils/thresholds.py, utils/taps.py::gaussian_kernel, the api) held to ref/
and the JAX package, at 0 LSB everywhere: the fixed threshold is a compare
and select, Otsu and Triangle are the same host scans over the same integer
histograms, and the Gaussian adaptive mean is the oracle's f64 arithmetic in
the oracle's order (JAX's K9 and its XLA route emulate that f64 exactly
enough to agree)."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import threshold as jthr
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import athresh as kathr
from imageenhancement_mp_tpu_torch.ops import threshold as tthr
from imageenhancement_mp_tpu_torch.utils import taps, thresholds

TYPES = ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")
RANGES = {np.uint8: (0, 256), np.uint16: (0, 65536), np.int16: (-32768, 32768)}
# per type: thresholds inside, at the edges of and beyond the value range
THRESHES = {np.uint8: [-5.0, 0.0, 127.5, 200.0, 255.0, 300.0],
            np.uint16: [-1.0, 1000.7, 40000.0, 65535.0, 70000.0],
            np.int16: [-40000.0, -32768.0, -0.5, 1234.0, 32767.0, 40000.0],
            np.float32: [-1.0, 0.25, 0.5, 0.999, 2.0]}
MAXVALS = {np.uint8: [255.0, 100.4, 300.0], np.uint16: [65535.0, 1000.6, -3.0],
           np.int16: [32767.0, -100.5, 50000.0], np.float32: [1.0, 0.3, 255.0]}
BLOCK_SIZES = (3, 5, 7, 11, 17, 51)
CS = (-3.5, 0.0, 2.0, 7.2)
SHAPES = [(2, 37, 131), (1, 5, 7), (1, 1, 1)]


def _img(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random(shape, dtype=np.float32)
    lo, hi = RANGES[dtype]
    return rng.integers(lo, hi, shape).astype(dtype)


@pytest.mark.parametrize("type", TYPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_threshold_planes_matches_ref(dtype, type):
    """Every type on u8/u16/i16/f32 with a scalar threshold (out-of-range
    ones included: the TRUNC-below-range zeros): 0 LSB against ref/."""
    x = _img((2, 17, 29), dtype, 60)
    for t in THRESHES[dtype]:
        for mv in MAXVALS[dtype]:
            got = tthr.threshold_planes(torch.from_numpy(x), t, mv, type)
            assert got.dtype == torch.from_numpy(x).dtype
            want = np.stack([ref.threshold(p, t, mv, type)[1] for p in x])
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t={t} maxval={mv}")


@pytest.mark.parametrize("type", TYPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_threshold_planes_per_plane_matches_jax(dtype, type):
    """A per-plane ``[B]`` threshold: 0 LSB against JAX's threshold_planes
    and against ref/ plane by plane."""
    x = _img((3, 17, 29), dtype, 61)
    ts = (np.array([0.25, 0.5, 0.75], np.float32) if dtype == np.float32 else
          np.array([x.min(), int(x.mean()), x.max()], np.int32))
    got = tthr.threshold_planes(torch.from_numpy(x), torch.from_numpy(ts), 200.0, type).numpy()
    np.testing.assert_array_equal(got, np.asarray(jthr.threshold_planes(x, ts, 200.0, type)))
    for p, t, g in zip(x, ts, got):
        np.testing.assert_array_equal(g, ref.threshold(p, float(t), 200.0, type)[1])


@pytest.mark.parametrize("method", ["otsu", "triangle"])
@pytest.mark.parametrize("shape", [(37, 131), (2, 37, 131), (37, 131, 3), (2, 16, 40, 3)])
def test_api_auto_threshold_matches_jax(method, shape):
    """Otsu/Triangle: ``ret`` (shape and values) and ``dst`` equal JAX's
    ``api.threshold``; for one plane also ref/'s."""
    # bimodal: a dark and a bright population
    x = _img(shape, np.uint8, 62) // 4 + np.where(_img(shape, np.uint8, 72) > 160, 150, 20)
    x = x.astype(np.uint8)
    ret, dst = tie.threshold(torch.from_numpy(x), 0.0, 255.0, "binary", method)
    jret, jdst = jie.threshold(x, 0.0, 255.0, "binary", method)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    assert type(ret) is type(jret)
    np.testing.assert_array_equal(np.asarray(ret), np.asarray(jret))
    if len(shape) == 2:
        rret, rdst = ref.threshold(x, 0.0, 255.0, "binary", method)
        assert ret == rret
        np.testing.assert_array_equal(dst.numpy(), rdst)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_api_fixed_threshold_matches_jax(dtype):
    x = _img((2, 16, 40, 3), dtype, 63)
    t = 0.4 if dtype == np.float32 else float(x.mean()) + 0.5
    for type in TYPES:
        ret, dst = tie.threshold(torch.from_numpy(x), t, 123.0, type)
        jret, jdst = jie.threshold(x, t, 123.0, type)
        assert ret == jret
        np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst), err_msg=type)


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("method", ["mean", "gaussian"])
def test_adaptive_matches_ref_and_jax(method, bs):
    """mean and gaussian, binary and binary_inv, C ∈ {−3.5, 0, 2, 7.2}, tiny
    planes included: 0 LSB against ref/, and against JAX's
    adaptive_threshold_planes (its XLA routes on these shapes) on the first."""
    for i, shape in enumerate(SHAPES):
        x = _img(shape, np.uint8, 64 + i)
        for C in CS:
            for type in ("binary", "binary_inv"):
                got = tthr.adaptive_threshold_planes(torch.from_numpy(x), 255.0, method, type,
                                                     bs, C).numpy()
                want = np.stack([ref.adaptive_threshold(p, 255.0, method, type, bs, C)
                                 for p in x])
                np.testing.assert_array_equal(got, want, err_msg=f"{shape} C={C} {type}")
                if i == 0:
                    np.testing.assert_array_equal(got, np.asarray(jthr.adaptive_threshold_planes(
                        x, 255.0, method, type, bs, C)), err_msg=f"JAX {shape} C={C} {type}")


@pytest.mark.parametrize("bs,C,type", [(3, 0.0, "binary"), (11, 2.0, "binary"),
                                       (17, -3.5, "binary_inv")])
def test_gaussian_vs_jax_k9_interpret(bs, C, type):
    """A wide shape through JAX's K9 in interpret mode: 0 LSB."""
    x = _img((2, 64, 256), np.uint8, 65)
    config.use_pallas_kernels = True
    try:
        want = np.asarray(jthr.adaptive_threshold_planes(x, 255.0, "gaussian", type, bs, C))
    finally:
        config.use_pallas_kernels = None
    taps64 = interop.athresh_taps_from_jax(ref_ops.gaussian_kernel(bs, 0.0))
    idelta = int(np.ceil(C)) if type == "binary" else int(np.floor(C))
    got = kathr.adaptive_threshold_gaussian(torch.from_numpy(x), taps64, 255, idelta,
                                            type == "binary_inv").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bs,C", [(11, 7.2), (51, -3.5)])
def test_gaussian_vs_jax_xla_route(bs, C):
    """A narrow shape (and a block size K9 rejects) takes JAX's double-float
    XLA route: 0 LSB."""
    x = _img((1, 37, 131), np.uint8, 66)
    got = tthr.adaptive_threshold_planes(torch.from_numpy(x), 200.0, "gaussian", "binary",
                                         bs, C).numpy()
    want = np.asarray(jthr.adaptive_threshold_planes(x, 200.0, "gaussian", "binary", bs, C))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(37, 131), (2, 37, 131), (2, 16, 40, 3)])
def test_api_adaptive_matches_jax_api(shape):
    x = _img(shape, np.uint8, 67)
    for method in ("mean", "gaussian"):
        got = tie.adaptive_threshold(torch.from_numpy(x), 255.0, method, "binary", 11, 2.0)
        want = jie.adaptive_threshold(x, 255.0, method, "binary", 11, 2.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=method)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 17, 31, 51, 101])
def test_gaussian_kernel_matches_ref(k):
    """The f64 float taps are ref/'s bit for bit (σ ≤ 0 and σ > 0), and
    ``gaussian_taps`` and interop carry them unchanged."""
    for sigma in (0.0, -1.0, 0.8, 2.5):
        t = taps.gaussian_kernel(k, sigma)
        assert t.dtype == np.float64
        np.testing.assert_array_equal(t, ref_ops.gaussian_kernel(k, sigma))
    dev_taps = tthr.gaussian_taps(k, torch.device("cpu"))
    assert dev_taps.dtype == torch.float64
    np.testing.assert_array_equal(dev_taps.numpy(), ref_ops.gaussian_kernel(k, 0.0))
    np.testing.assert_array_equal(
        interop.athresh_taps_from_jax([float(v) for v in ref_ops.gaussian_kernel(k, 0.0)]).numpy(),
        dev_taps.numpy())


def test_auto_threshold_copies_match_ref():
    """utils/thresholds.py equals ref/ on peaked, flat, one-bin and two-bin
    histograms."""
    assert thresholds.THRESH_TYPES == ref_ops._THRESH_TYPES
    rng = np.random.default_rng(68)
    hists = [rng.multinomial(5000, rng.dirichlet(np.full(256, a))) for a in (0.05, 0.5, 5.0)]
    hists += [np.eye(256, dtype=np.int64)[7] * 100, np.eye(256, dtype=np.int64)[250] * 3,
              (np.eye(256, dtype=np.int64)[3] + np.eye(256, dtype=np.int64)[200]) * 50]
    for h in hists:
        assert thresholds.otsu_threshold(h, int(h.sum())) == ref_ops.otsu_threshold(h, int(h.sum()))
        assert thresholds.triangle_threshold(h) == ref_ops.triangle_threshold(h)


def test_rejects_like_jax():
    x = _img((2, 16, 40), np.uint8, 69)
    for bad in [dict(type="trunc"), dict(method="median"), dict(block_size=4),
                dict(block_size=1)]:
        kwargs = {**dict(maxval=255.0, method="gaussian", type="binary", block_size=5), **bad}
        with pytest.raises(ValueError):
            jie.adaptive_threshold(x, **kwargs)
        with pytest.raises(ValueError):
            tie.adaptive_threshold(torch.from_numpy(x), **kwargs)
    with pytest.raises(TypeError):
        tie.adaptive_threshold(torch.from_numpy(x.astype(np.uint16)))
    with pytest.raises(ValueError):
        tie.threshold(torch.from_numpy(x), 1.0, 255.0, "binary", "isodata")
    with pytest.raises(ValueError):
        tie.threshold(torch.from_numpy(x), 1.0, 255.0, "nope")
    with pytest.raises(TypeError):
        tie.threshold(torch.from_numpy(x.astype(np.uint16)), method="otsu")
    with pytest.raises(TypeError):
        tie.threshold(torch.from_numpy(x.astype(np.int32)))
    planes = torch.from_numpy(x)
    with pytest.raises(ValueError):
        kathr.adaptive_threshold_gaussian(planes, torch.ones(4, dtype=torch.float64), 255, 0, False)
    with pytest.raises(ValueError):
        kathr.adaptive_threshold_gaussian(planes, torch.ones(3, dtype=torch.float32), 255, 0, False)
    with pytest.raises(ValueError):
        kathr.adaptive_threshold_gaussian(planes, torch.ones(3, dtype=torch.float64), 256, 0, False)
    with pytest.raises(ValueError):
        kathr.adaptive_threshold_gaussian(planes.to("meta"), torch.ones(3, dtype=torch.float64),
                                          255, 0, False)


def test_large_idelta_is_clamped_without_changing_the_result():
    """|C| far beyond 255 decides every pixel alike; the wrapper clamps
    idelta to fit the kernel's int32 and still equals ref/."""
    x = _img((1, 9, 13), np.uint8, 70)
    for C in (1e6, -1e6, 300.0, -300.0):
        for type in ("binary", "binary_inv"):
            got = tthr.adaptive_threshold_planes(torch.from_numpy(x), 255.0, "gaussian", type,
                                                 5, C).numpy()
            np.testing.assert_array_equal(
                got, ref.adaptive_threshold(x[0], 255.0, "gaussian", type, 5, C)[None])
