"""getRectSubPix and cornerSubPix: the port's ops/subpix.py held to
ref/ops.py::get_rect_sub_pix and the JAX package's device op at 0 on every
law (Q16 u8 → u8; f32 1-channel FMA chain; u8 → f32 paired sums; the
multi-channel left-to-right sums; patches over the border), and the host
copies in utils/tracking.py (cornerSubPix and the one-centre
getRectSubPix it calls) pinned to their originals in ref/.  The JAX device
op takes its multi-channel law for any 3-D image; ref/ and the port follow
cv2, which sees one channel in [H, W, 1], so that layout is held to ref/
only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.utils import tracking

SOURCES = [("u8", (45, 61)), ("u8", (45, 61, 3)), ("f32", (45, 61)), ("f32", (45, 61, 3)),
           ("u8", (45, 61, 1))]


def _src(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape) * 255).astype(np.float32)


def _centers(rng, H, W, n=24):
    c = np.stack([rng.uniform(0, W - 1, n), rng.uniform(0, H - 1, n)], 1).astype(np.float32)
    c[:4] = [[0.0, 0.0], [W - 1, H - 1], [0.5, 17.5], [13.25, 0.75]]  # border, halves
    return c


@pytest.mark.parametrize("patch", [(5, 5), (7, 3), (4, 6), (1, 1)])
@pytest.mark.parametrize("src", range(len(SOURCES)))
def test_get_rect_sub_pix_matches_ref_and_jax(src, patch):
    kind, shape = SOURCES[src]
    img = _src(kind, shape, 70 + src)
    rng = np.random.default_rng(71 + src)
    c = _centers(rng, shape[0], shape[1])
    for pt in ([None, "f32"] if kind == "u8" else [None]):
        got = tie.get_rect_sub_pix(torch.from_numpy(img), patch, c, pt)
        want = np.stack([ref_ops.get_rect_sub_pix(img, patch, p, pt) for p in c])
        assert got.dtype == (torch.uint8 if (pt is None and kind == "u8") else torch.float32)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{shape} {patch} {pt}")
        host = np.stack([tracking.get_rect_sub_pix(img, patch, p, pt) for p in c])
        np.testing.assert_array_equal(host, want)
        if shape[-1] != 1 and patch in ((5, 5), (7, 3)):
            jx = np.asarray(ie.get_rect_sub_pix(jnp.asarray(img), patch, c, pt))
            np.testing.assert_array_equal(got.numpy(), jx, err_msg=f"{shape} {patch} {pt}")


def test_get_rect_sub_pix_single_center_and_tensor_centers():
    img = _src("u8", (30, 40), 80)
    one = tie.get_rect_sub_pix(torch.from_numpy(img), (6, 4), (12.3, 7.8))
    assert one.shape == (4, 6)
    np.testing.assert_array_equal(one.numpy(), ref_ops.get_rect_sub_pix(img, (6, 4), (12.3, 7.8)))
    c = torch.tensor([[12.3, 7.8], [3.0, 29.0]])
    both = tie.get_rect_sub_pix(torch.from_numpy(img), (6, 4), c, "f32")
    assert both.shape == (2, 4, 6) and both.dtype == torch.float32


def test_get_rect_sub_pix_rejects():
    u16 = torch.zeros((8, 8), dtype=torch.uint16)
    with pytest.raises(TypeError):
        tie.get_rect_sub_pix(u16, (3, 3), (4.0, 4.0))
    f = torch.zeros((8, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        tie.get_rect_sub_pix(f, (3, 3), (4.0, 4.0), "u8")
    with pytest.raises(ValueError):
        tie.get_rect_sub_pix(f, (3, 3), (4.0, 4.0), "f64")
    with pytest.raises(ValueError):
        tie.get_rect_sub_pix(torch.zeros((2, 8, 8, 1), dtype=torch.uint8), (3, 3), (4.0, 4.0))


def _corner_image(rng, H=72, W=96):
    """Blurred blocks: corners with interior windows and some at the border."""
    img = np.zeros((H, W), np.float32)
    for _ in range(9):
        y, x = rng.integers(0, H - 10), rng.integers(0, W - 10)
        img[y:y + rng.integers(8, 30), x:x + rng.integers(8, 30)] += rng.uniform(40, 120)
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, img)
    return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", [((5, 5), (-1, -1), 100, 0.0), ((3, 3), (1, 1), 40, 0.001),
                                  ((7, 4), (-1, -1), 5, 0.01), ((2, 6), (0, 2), 100, 0.0)])
def test_corner_sub_pix_copy_pinned(case):
    win, zz, mc, eps = case
    rng = np.random.default_rng(90)
    img = _corner_image(rng)
    corners = ref_ops.good_features_to_track(img, 25, 0.01, 5)
    corners = np.concatenate([corners, [[0.0, 0.0], [95.0, 71.0], [50.5, 30.25]]]).astype(
        np.float32)
    want = ref_ops.corner_sub_pix(img, corners, win, zz, mc, eps)
    np.testing.assert_array_equal(tracking.corner_sub_pix(img, corners, win, zz, mc, eps), want)
    got = tie.corner_sub_pix(torch.from_numpy(img), torch.from_numpy(corners), win, zz, mc, eps)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ie.corner_sub_pix(img, corners, win, zz, mc, eps))
    f32img = img.astype(np.float32) * 0.5
    np.testing.assert_array_equal(
        tracking.corner_sub_pix(f32img, corners, win, zz, mc, eps),
        ref_ops.corner_sub_pix(f32img, corners, win, zz, mc, eps))
