"""The port's morphology (ops/morphology.py: erode, dilate and the
morphologyEx family) held to the JAX package's ops/morphology.py (its planes
functions called eagerly on jnp arrays) and to ref/ at 0 for every dtype, op,
rect size (even ones too), 0/1 mask and iteration count; the copied
getStructuringElement bit for bit; the api and its rejections."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import morphology as jm
from imageenhancement_mp_tpu_torch.ops import morphology as tm
from imageenhancement_mp_tpu_torch.utils.structuring import get_structuring_element

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
IDS = ["u8", "u16", "i16", "f32"]
SHAPE = (2, 23, 37)


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


CASES = [(3, 1, None), ((4, 3), 2, None), ((1, 6), 1, None), (15, 1, None),
         (None, 1, ("ellipse", 5)), (None, 2, ("cross", (3, 4))), (None, 1, ("ellipse", (15, 15)))]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("op", tm.MORPH_OPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_morphology_matches_jax_and_ref(dtype, op, case):
    ksize, iterations, elem = CASES[case]
    kernel = None if elem is None else ref.get_structuring_element(*elem)
    ksize = 3 if ksize is None else ksize
    x = _planes(SHAPE, dtype, 5 + case)
    got = tm.morphology_planes(torch.from_numpy(x), op, ksize, iterations, kernel).numpy()
    _same(got, jm.morphology_planes(jnp.asarray(x), op, ksize, iterations, kernel))
    _same(got, np.stack([ref.morphology(p, op, ksize, iterations, kernel) for p in x]))


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 3, 5), (1, 1, 9)])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_erode_dilate_on_tiny_planes(dtype, shape):
    """Windows larger than the plane see only the identity border."""
    x = _planes(shape, dtype, 9)
    for fn, jfn, rfn in ((tm.erode_planes, jm.erode_planes, ref.erode),
                         (tm.dilate_planes, jm.dilate_planes, ref.dilate)):
        for ksize in (3, (5, 2)):
            got = fn(torch.from_numpy(x), ksize, 2).numpy()
            _same(got, jfn(jnp.asarray(x), ksize, 2))
            _same(got, np.stack([rfn(p, ksize, 2) for p in x]))


@pytest.mark.parametrize("shape", ["rect", "ellipse", "cross"])
def test_structuring_element_is_refs(shape):
    for ksize in [(r, c) for r in range(1, 16, 2) for c in range(1, 16, 3)] + [4, 7]:
        np.testing.assert_array_equal(get_structuring_element(shape, ksize),
                                      ref.get_structuring_element(shape, ksize))
        np.testing.assert_array_equal(tie.get_structuring_element(shape, ksize),
                                      ie.get_structuring_element(shape, ksize))


def test_api_matches_jax_on_hwc_and_all_zero_masks():
    x = _planes((1, 23, 37, 3), np.uint8, 11)
    ell = tie.get_structuring_element("ellipse", 5)
    for fn, args in (("erode", (3, 2)), ("dilate", ((4, 2),)), ("morphology_ex", ("tophat", 5))):
        got = getattr(tie, fn)(torch.from_numpy(x), *args).numpy()
        _same(got, getattr(ie, fn)(jnp.asarray(x), *args))
        got = getattr(tie, fn)(torch.from_numpy(x[0]), *args, kernel=ell).numpy()
        _same(got, getattr(ie, fn)(jnp.asarray(x[0]), *args, kernel=ell))
    zero = np.zeros((3, 3), np.uint8)
    _same(tie.erode(torch.from_numpy(x[0]), kernel=zero).numpy(), x[0])


def test_rejects_what_jax_rejects():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tm.morphology_planes(x, "thin")
    with pytest.raises(ValueError):
        tm.erode_planes(x, (0, 3))
    with pytest.raises(TypeError):
        tm.dilate_planes(x.to(torch.int32))
    with pytest.raises(TypeError):
        tie.erode(x.to(torch.int32))
    with pytest.raises(ValueError):
        tie.get_structuring_element("disc", 3)
