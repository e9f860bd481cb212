"""The port's median (kernels/median.py plain networks, ops/median.py, the
api) held to the JAX package — K6 ``median_blur_pallas`` in interpret mode
and its XLA route — and to ref/, at 0 LSB: a median is an order statistic of
integers (or of f32 values, copied unchanged), so nothing rounds."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.kernels.median import median_blur_pallas
from imageenhancement_mp_tpu.ops.median import median_blur_planes as jax_median_planes
from imageenhancement_mp_tpu_torch.kernels import median as kmedian
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes

SHAPES = [(2, 64, 256), (1, 37, 131), (1, 2, 3), (1, 1, 1)]
RANGES = {np.uint8: (0, 256), np.uint16: (0, 65536), np.int16: (-32768, 32768)}


def _planes(shape, dtype, seed):
    lo, hi = RANGES[dtype]
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _ref(x, k):
    return np.stack([ref.median_blur(p, k) for p in x])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_median_matches_pallas_xla_and_ref(dtype, k, shape):
    """0 LSB against K6 in interpret mode, the JAX XLA networks and ref/."""
    x = _planes(shape, dtype, 41)
    got = kmedian.median_blur(torch.from_numpy(x), k)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == x.shape
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(median_blur_pallas(x, k, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_median_planes(x, k, backend="xla")))
    np.testing.assert_array_equal(got, _ref(x, k))
    np.testing.assert_array_equal(median_blur_planes(torch.from_numpy(x), k).numpy(), got)


@pytest.mark.parametrize("dtype,k", [(np.float32, 3), (np.float32, 5), (np.float32, 7),
                                     (np.uint8, 7), (np.uint16, 9)])
def test_sort_route_matches_xla_and_ref(dtype, k):
    """f32 at every ksize and every type at ksize ≥ 7 take the torch sort:
    0 LSB against the JAX XLA route and ref/."""
    if dtype == np.float32:
        x = np.random.default_rng(42).random((2, 37, 131), dtype=np.float32)
    else:
        x = _planes((2, 37, 131), dtype, 42)
    got = median_blur_planes(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_median_planes(x, k, backend="xla")))
    np.testing.assert_array_equal(got, _ref(x, k))


@pytest.mark.parametrize("shape", [(2, 37, 131), (37, 131, 3), (2, 16, 40, 3)])
def test_api_median_matches_jax_api(shape):
    """0 LSB against ``imageenhancement_mp_tpu.median_blur`` per layout."""
    x = _planes(shape, np.uint8, 43)
    for k in (3, 5):
        np.testing.assert_array_equal(tie.median_blur(torch.from_numpy(x), k).numpy(),
                                      np.asarray(jie.median_blur(x, k)), err_msg=str(k))


def test_median_networks_on_duplicates():
    """Few distinct values (many ties) through both networks: 0 LSB to ref/."""
    x = _planes((2, 33, 70), np.uint8, 44) % 3
    for k in (3, 5):
        np.testing.assert_array_equal(kmedian.median_blur(torch.from_numpy(x), k).numpy(),
                                      _ref(x, k))


def test_median_rejects_what_it_does_not_take():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for k in (0, 1, 2, 4):
        with pytest.raises(ValueError):
            median_blur_planes(x, k)
    with pytest.raises(TypeError):
        median_blur_planes(x.to(torch.int32), 3)
    with pytest.raises(ValueError):
        kmedian.median_blur(x, 7)
    with pytest.raises(TypeError):
        kmedian.median_blur(x.to(torch.float32), 3)
    with pytest.raises(ValueError):
        kmedian.median_blur(x.to("meta"), 3)
