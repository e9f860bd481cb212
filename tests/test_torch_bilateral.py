"""The port's bilateral filter (kernels/bilateral.py plain version,
ops/bilateral.py, the api, the pipeline) held to ref/ and the JAX package.

Budgets: 0 LSB against ref/ for gray and colour, and against the JAX XLA
route; ±1 against JAX's K10 (``bilateral_gray_pallas``) in interpret mode.
K10's walk is the same f32 law, but under XLA:CPU its ``num + v·w`` may be
contracted into a fused multiply-add, which rounds once where ref/, cv2 and
the port round twice, and a quotient near .5 then rounds the other way
(ROADMAP Queue 3).  On (2, 64, 256) at d = 9, σ 75/75, seeds 11, 15 and 33
of 0-39 give one pixel of 32768 off by 1; the others none.
"""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import bilateral as jbil
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import bilateral as kbil
from imageenhancement_mp_tpu_torch.ops import bilateral as tbil

# (2, 64, 256) is a shape JAX's K10 takes; 3x4 is smaller than every radius
SHAPES = [(2, 64, 256), (1, 37, 131), (1, 5, 7), (1, 1, 1), (1, 3, 4)]
SIGMAS = [(75.0, 75.0), (30.0, 30.0), (10.0, 200.0)]
# d = 0 takes the radius round(1.5·σ_space): these give 4, 8 and 24
SIGMAS_D0 = [(75.0, 3.0), (30.0, 5.0), (10.0, 16.0)]
PARAMS = [(d, sc, ss) for d in (3, 5, 9) for sc, ss in SIGMAS] + \
         [(0, sc, ss) for sc, ss in SIGMAS_D0]


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _ref(x, d, sc, ss):
    return np.stack([ref.bilateral_filter(p, d, sc, ss) for p in x])


@pytest.mark.parametrize("d,sc,ss", PARAMS)
def test_gray_matches_ref(d, sc, ss):
    """0 LSB against ref/ over every shape, tiny planes and planes smaller
    than the radius included (REFLECT_101 reflects again)."""
    for i, shape in enumerate(SHAPES):
        x = _img(shape, 50 + i)
        got = tbil.bilateral_planes(torch.from_numpy(x), d, sc, ss)
        assert got.dtype == torch.uint8 and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), _ref(x, d, sc, ss), err_msg=str(shape))


@pytest.mark.parametrize("shape", [(37, 131, 3), (2, 16, 40, 3), (1, 2, 3, 3)])
@pytest.mark.parametrize("d,sc,ss", [(5, 50.0, 50.0), (9, 30.0, 30.0), (0, 10.0, 3.0)])
def test_color_matches_ref(shape, d, sc, ss):
    """cv2's joint colour weights, plain PyTorch: 0 LSB against ref/."""
    x = _img(shape, 52)
    got = tie.bilateral_filter(torch.from_numpy(x), d, sc, ss).numpy()
    want = np.stack([ref.bilateral_filter(p, d, sc, ss) for p in x.reshape(-1, *shape[-3:])])
    np.testing.assert_array_equal(got, want.reshape(shape))


@pytest.mark.parametrize("d,sc,ss", [(9, 75.0, 75.0), (5, 50.0, 50.0)])
def test_gray_vs_jax_k10_interpret(d, sc, ss):
    """±1 against JAX's K10 in interpret mode (the reason is in the module
    docstring), 0 LSB against ref/ on the same input."""
    x = _img((2, 64, 256), 11)
    config.use_pallas_kernels = True
    try:
        jax_out = np.asarray(jbil.bilateral_planes(x, d, sc, ss))
    finally:
        config.use_pallas_kernels = None
    got = kbil.bilateral_gray(torch.from_numpy(x), *_tables(d, sc, ss)).numpy()
    n_diff = int((got != jax_out).sum())
    print(f"d={d} sigma=({sc}, {sc}): {n_diff} of {got.size} pixels differ from K10 "
          f"(interpret), max {_maxdiff(got, jax_out)}")
    assert _maxdiff(got, jax_out) <= 1
    np.testing.assert_array_equal(got, _ref(x, d, sc, ss))


def _tables(d, sc, ss):
    offs, cw, r = jbil.bilateral_offsets(d, sc, ss)
    return (*interop.bilateral_tables_from_jax(offs, cw), r)


@pytest.mark.parametrize("d,sc,ss", [(9, 75.0, 75.0), (3, 10.0, 200.0)])
def test_gray_vs_jax_xla_route(d, sc, ss):
    """A narrow shape JAX's K10 rejects takes its XLA route: 0 LSB."""
    x = _img((1, 37, 131), 53)
    got = tbil.bilateral_planes(torch.from_numpy(x), d, sc, ss).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbil.bilateral_planes(x, d, sc, ss)))


@pytest.mark.parametrize("d,sc,ss,cn", [(9, 75.0, 75.0, 1), (5, 30.0, 30.0, 1),
                                        (0, 10.0, 16.0, 1), (51, 20.0, 40.0, 1),
                                        (9, 75.0, 75.0, 3)])
def test_offsets_and_lut_match_jax(d, sc, ss, cn):
    """The disc (order and f32 space weights) and the f32 colour table are
    JAX's bit for bit, and interop carries JAX's tables to the port's."""
    j_offs, j_cw, j_r = jbil.bilateral_offsets(d, sc, ss, cn)
    t_offs, t_cw, t_r = tbil.bilateral_offsets(d, sc, ss, cn)
    assert t_offs == j_offs and t_r == j_r
    assert t_cw.dtype == j_cw.dtype == np.float32
    np.testing.assert_array_equal(t_cw, j_cw)
    offsets, lut, r = tbil.bilateral_tables(d, sc, ss, cn, torch.device("cpu"))
    i_offsets, i_lut = interop.bilateral_tables_from_jax(j_offs, j_cw)
    assert r == j_r and torch.equal(offsets, i_offsets) and torch.equal(lut, i_lut)
    assert offsets.dtype == torch.float32 and offsets.shape == (len(j_offs), 3)


@pytest.mark.parametrize("shape,channels_last", [((37, 131), True), ((2, 37, 131), True),
                                                 ((37, 131, 1), True), ((2, 16, 40, 1), True),
                                                 ((2, 16, 3), False), ((16, 40, 3), True)])
def test_api_matches_jax_api(shape, channels_last):
    """``bilateral_filter`` per layout: 0 LSB against
    ``imageenhancement_mp_tpu.bilateral_filter`` (its XLA routes here)."""
    x = _img(shape, 54)
    got = tie.bilateral_filter(torch.from_numpy(x), 5, 50.0, 50.0, channels_last).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jie.bilateral_filter(x, 5, 50.0, 50.0, channels_last)))


def test_pipeline_bilateral_then_adaptive_threshold():
    """The two-stage chain document scans use, through make_pipeline: 0 LSB
    against ref/'s two steps."""
    x = _img((2, 37, 131), 55)
    pipe = tie.make_pipeline([
        ("bilateral", {"d": 9, "sigma_color": 75.0, "sigma_space": 75.0}),
        ("adaptive_threshold", {"method": "gaussian", "block_size": 11, "C": 2.0}),
    ])
    want = np.stack([ref.adaptive_threshold(ref.bilateral_filter(p, 9, 75.0, 75.0), 255.0,
                                            "gaussian", "binary", 11, 2.0) for p in x])
    np.testing.assert_array_equal(pipe(torch.from_numpy(x)).numpy(), want)


def test_rejects_like_jax():
    """σ ≤ 0, C ∉ {1, 3}, a radius over 25 and non-u8 raise like JAX."""
    x = _img((2, 16, 40, 3), 56)
    for bad in [dict(sigma_color=0.0), dict(sigma_space=-1.0), dict(d=0, sigma_space=20.0),
                dict(d=52)]:
        kwargs = {**dict(d=5, sigma_color=50.0, sigma_space=50.0), **bad}
        with pytest.raises(ValueError):
            jie.bilateral_filter(x, **kwargs)
        with pytest.raises(ValueError):
            tie.bilateral_filter(torch.from_numpy(x), **kwargs)
    for shape in [(16, 40, 2), (16, 40, 4), (2, 16, 40, 2), (2, 16, 40, 4)]:
        y = _img(shape, 57)
        with pytest.raises(ValueError):
            jie.bilateral_filter(y)
        with pytest.raises(ValueError):
            tie.bilateral_filter(torch.from_numpy(y))
    with pytest.raises(TypeError):
        tie.bilateral_filter(torch.from_numpy(x).to(torch.int16))
    planes = torch.zeros((1, 8, 8), dtype=torch.uint8)
    offsets, lut, r = tbil.bilateral_tables(5, 50.0, 50.0, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        kbil.bilateral_gray(planes, offsets, lut, 26)
    with pytest.raises(ValueError):
        kbil.bilateral_gray(planes, offsets, lut[:128], r)
    with pytest.raises(ValueError):
        kbil.bilateral_gray(planes.to("meta"), offsets, lut, r)
    with pytest.raises(ValueError):
        interop.bilateral_tables_from_jax([(0.5, 0, 1.0)], lut.numpy())
