"""pyrMeanShiftFiltering (ops/meanshift.py): the port held to
ref/ops.py::pyr_mean_shift_filtering and to the JAX package's device op at
0 LSB — random, blurred and quantized colour images (quantized ones put the
``cvRound(n·fl64(1/count))`` updates on exact half ties), tiny images,
pyramid depths 0–3, fractional radii, batches — at ≤ 48×48 with sp ≤ 5."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref import ops as ref_ops


def _img(rng, H, W, kind):
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if kind == "blurred":
        return np.stack([ref.gaussian_blur(img[..., c], 5, 0.0) for c in range(3)], -1)
    if kind == "quantized":
        q = int(rng.integers(2, 64))
        return (img // q * q).astype(np.uint8)
    return img


PARAMS = [(5.0, 20.0, 1, 5, 1.0), (2.5, 16.0, 2, 5, 1.0), (3.7, 30.0, 0, 8, 2.3),
          (1.0, 4.0, 1, 3, 0.0), (4.2, 55.0, 3, 20, 4.9), (0.6, 0.3, 1, 1, 0.5)]


@pytest.mark.parametrize("kind", ["random", "blurred", "quantized"])
@pytest.mark.parametrize("p", range(len(PARAMS)))
def test_matches_ref(p, kind):
    sp, sr, ml, mc, eps = PARAMS[p]
    rng = np.random.default_rng(200 + p)
    for H, W in ((48, 48), (31, 45)):
        img = _img(rng, H, W, kind)
        got = tie.pyr_mean_shift_filtering(torch.from_numpy(img), sp, sr, ml, mc, eps)
        assert got.dtype == torch.uint8 and got.shape == img.shape
        want = ref_ops.pyr_mean_shift_filtering(img, sp, sr, ml, mc, eps)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{H}x{W} {PARAMS[p]}")


@pytest.mark.parametrize("shape", [(6, 6), (7, 9), (8, 31), (33, 8)])
def test_tiny_images_and_defaults(shape):
    rng = np.random.default_rng(210)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    for sp, sr, ml in ((2.0, 10.0, 1), (1.0, 4.0, 2), (5.0, 0.3, 1), (3.5, 2.0, 0),
                       (2.5, 16.0, 1)):
        got = tie.pyr_mean_shift_filtering(torch.from_numpy(img), sp, sr, ml)
        np.testing.assert_array_equal(got.numpy(), ref_ops.pyr_mean_shift_filtering(
            img, sp, sr, ml), err_msg=f"{shape} {sp} {sr} {ml}")
    c = np.full((24, 20, 3), 77, np.uint8)
    np.testing.assert_array_equal(tie.pyr_mean_shift_filtering(torch.from_numpy(c), 3.0, 10.0,
                                                               2).numpy(), c)


@pytest.mark.parametrize("params", [(5.0, 20.0, 1, 5, 1.0), (2.5, 16.0, 2, 5, 1.0)])
def test_matches_jax(params):
    sp, sr, ml, mc, eps = params
    rng = np.random.default_rng(220)
    img = _img(rng, 40, 44, "blurred")
    got = tie.pyr_mean_shift_filtering(torch.from_numpy(img), sp, sr, ml, mc, eps).numpy()
    np.testing.assert_array_equal(got, np.asarray(ie.pyr_mean_shift_filtering(
        img, sp, sr, ml, mc, eps)))


def test_batch_equals_each_image():
    rng = np.random.default_rng(230)
    batch = np.stack([_img(rng, 29, 37, k) for k in ("random", "blurred", "quantized")])
    got = tie.pyr_mean_shift_filtering(torch.from_numpy(batch), 3.0, 25.0, 1).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], ref_ops.pyr_mean_shift_filtering(
            batch[i], 3.0, 25.0, 1))


def test_rejects():
    with pytest.raises(TypeError):
        tie.pyr_mean_shift_filtering(torch.zeros((8, 8, 3), dtype=torch.uint16), 2.0, 5.0)
    with pytest.raises(ValueError):
        tie.pyr_mean_shift_filtering(torch.zeros((8, 8), dtype=torch.uint8), 2.0, 5.0)
    with pytest.raises(ValueError):
        tie.pyr_mean_shift_filtering(torch.zeros((8, 8, 4), dtype=torch.uint8), 2.0, 5.0)
    with pytest.raises(ValueError):
        tie.pyr_mean_shift_filtering(torch.zeros((8, 8, 3), dtype=torch.uint8), 2.0, 5.0, 9)
