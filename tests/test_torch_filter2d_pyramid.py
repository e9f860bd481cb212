"""The port's filter2D and Gaussian pyramids (ops/filter2d.py,
ops/pyramid.py) held to the JAX package's planes functions (called eagerly
on jnp arrays) and to ref/ on numpy-seeded planes.

Tolerances: integer kernels on every integer dtype, and float kernels on
u8, 0 against ref/ and JAX; float kernels on u16/i16, and integer kernels
past the int32 bound, 0 against ref/ (the port sums in f64 as ref/ does)
and ±1 against JAX (its double-float f32 route); integer pyramids 0; f32
outputs 0 against JAX (the same f32 ops in the same order, eagerly) and
within 1e-6 of ref/'s f64 sums relative to the output's largest
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import filter2d as jf
from imageenhancement_mp_tpu.ops import pyramid as jp
from imageenhancement_mp_tpu_torch.ops import filter2d as tf
from imageenhancement_mp_tpu_torch.ops import pyramid as tp

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
IDS = ["u8", "u16", "i16", "f32"]
SHAPE = (2, 24, 37)
TINY = [(1, 1, 1), (1, 3, 5)]
_K = np.random.default_rng(3)
KERNELS = {
    "sharpen3": np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float64),
    "emboss3": np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], np.float64),
    "int_even2x4": np.array([[1, 2, 0, -1], [3, 0, 0, 1]], np.float64),
    "float5": _K.normal(size=(5, 5)),
    "float15": _K.normal(size=(15, 15)) * 0.05,
    "float1x7": _K.random((1, 7)) / 3.5,
    "overflow": np.full((3, 3), 20000.0),
    "zeros": np.zeros((3, 3)),
}
DELTAS = [0.0, 2.5, -3.5, 0.49]


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max(initial=0.0))


def _rel(a, b):
    return _diff(a, b) / max(float(np.abs(np.asarray(b, np.float64)).max(initial=0.0)), 1e-30)


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_filter2d_matches_ref_and_jax(dtype, kname, delta):
    k = KERNELS[kname]
    x = _planes(SHAPE, dtype, 21)
    got = tf.filter2d_planes(torch.from_numpy(x), k, delta).numpy()
    jax_out = jf.filter2d_planes(jnp.asarray(x), k, delta)
    want = np.stack([ref.filter2d(p, k, delta) for p in x])
    if dtype == np.float32:
        assert _diff(got, jax_out) == 0
        assert _rel(got, want) <= 1e-6
        return
    assert _diff(got, want) == 0
    integral = np.all(k == np.round(k)) and kname != "overflow"
    assert _diff(got, jax_out) <= (0 if integral or dtype == np.uint8 else 1)


@pytest.mark.parametrize("shape", TINY)
@pytest.mark.parametrize("kname", ["sharpen3", "float5", "float15", "int_even2x4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_filter2d_halos_deeper_than_the_plane(dtype, kname, shape):
    """REFLECT_101 reflects again when the halo is deeper than the plane."""
    k = KERNELS[kname]
    x = _planes(shape, dtype, 22)
    got = tf.filter2d_planes(torch.from_numpy(x), k, 1.5).numpy()
    want = np.stack([ref.filter2d(p, k, 1.5) for p in x])
    if dtype == np.float32:
        assert _diff(got, jf.filter2d_planes(jnp.asarray(x), k, 1.5)) == 0
        assert _rel(got, want) <= 1e-6
    else:
        assert _diff(got, want) == 0


def test_filter2d_rejects_and_saturates_like_jax():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unroll bound"):
        tf.filter2d_planes(x, np.ones((16, 3)))
    with pytest.raises(ValueError):
        tf.filter2d_planes(x, np.ones(3))
    with pytest.raises(TypeError):
        tf.filter2d_planes(x.to(torch.int32), np.ones((3, 3)))
    with pytest.raises(ValueError):
        tie.filter2d(x, np.ones(3))
    xi = _planes((1, 9, 11), np.int16, 23)
    for delta in (2.0**31, -(2.0**40), 1e9 + 0.5):
        got = tf.filter2d_planes(torch.from_numpy(xi), KERNELS["sharpen3"], delta).numpy()
        assert _diff(got, jf.filter2d_planes(jnp.asarray(xi), KERNELS["sharpen3"], delta)) == 0
        assert _diff(got, np.stack([ref.filter2d(p, KERNELS["sharpen3"], delta) for p in xi])) == 0


@pytest.mark.parametrize("fn", ["pyr_down", "pyr_up"])
@pytest.mark.parametrize("shape", [SHAPE] + TINY)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_pyramids_match_jax_and_ref(dtype, shape, fn):
    x = _planes(shape, dtype, 24)
    got = getattr(tp, fn + "_planes")(torch.from_numpy(x)).numpy()
    assert _diff(got, getattr(jp, fn + "_planes")(jnp.asarray(x))) == 0
    want = np.stack([getattr(ref, fn)(p) for p in x])
    if dtype == np.float32:
        assert _rel(got, want) <= 1e-6
    else:
        assert _diff(got, want) == 0


def test_api_matches_jax():
    x = _planes((2, 24, 37, 3), np.uint8, 25)
    t = torch.from_numpy(x)
    assert _diff(tie.filter2d(t, KERNELS["float5"], 3.0),
                 ie.filter2d(jnp.asarray(x), KERNELS["float5"], 3.0)) == 0
    kx, ky = np.array([1.0, 2.0, 1.0]), np.array([-1.0, 0.0, 1.0, 0.5])
    assert _diff(tie.sep_filter2d(t, kx, ky, 1.0),
                 ie.sep_filter2d(jnp.asarray(x), kx, ky, 1.0)) == 0
    assert _diff(tie.pyr_down(t), ie.pyr_down(jnp.asarray(x))) == 0
    assert _diff(tie.pyr_up(t[0]), ie.pyr_up(jnp.asarray(x[0]))) == 0
    with pytest.raises(TypeError):
        tie.pyr_down(t.to(torch.int32))
