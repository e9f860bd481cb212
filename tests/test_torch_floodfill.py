"""floodFill in the port (ops/floodfill.py and api.flood_fill) on CPU tensors
against the NumPy oracle ref/, the JAX package's device op
(``ie.flood_fill``) and cv2.

Tolerance 0: the count, the filled image, the mask and the rectangle are
equal (f32 images bit for bit)."""

import numpy as np
import pytest
import torch
from detseed import seed

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu_torch.ops.floodfill import CHECK_EVERY, flood_region

cv2 = pytest.importorskip("cv2")


def _cv(img, seedp, nv, lo, up, conn, fixed, mask0, maskonly, mfill):
    flags = conn | (mfill << 8)
    if fixed:
        flags |= cv2.FLOODFILL_FIXED_RANGE
    if maskonly:
        flags |= cv2.FLOODFILL_MASK_ONLY
    im = img.copy()
    m = mask0.copy()
    return cv2.floodFill(im, m, seedp, nv, loDiff=lo, upDiff=up, flags=flags)


def _configs(rng, t):
    """tests/test_floodfill.py's fuzz: gray and RGB u8, 4/8-connected, fixed
    and floating range, mask-only, mask fill values, blocked mask cells."""
    H, W = int(rng.integers(3, 40)), int(rng.integers(3, 40))
    C = [1, 3][t % 2]
    img = rng.integers(0, 256, (H, W) if C == 1 else (H, W, C), np.uint8)
    seedp = (int(rng.integers(0, W)), int(rng.integers(0, H)))
    lo, up = int(rng.integers(0, 60)), int(rng.integers(0, 60))
    conn = [4, 8][t % 2 == 0]
    fixed = bool(t % 3)
    maskonly = t % 5 == 0
    mfill = int(rng.integers(1, 256)) if t % 4 == 0 else 1
    m0 = np.zeros((H + 2, W + 2), np.uint8)
    if t % 6 == 0:
        m0[1:-1, 1:-1] = (rng.random((H, W)) < 0.1).astype(np.uint8) * 3
    nv = int(rng.integers(0, 300))
    nv = nv if C == 1 else (nv, nv // 2, 7)
    lo_t = lo if C == 1 else (lo,) * C
    up_t = up if C == 1 else (up,) * C
    return img, seedp, nv, lo_t, up_t, conn, fixed, m0, maskonly, mfill


def _port(img, sp, nv, lo, up, conn, fixed, m0, mo, mf, mask_as_tensor=True):
    n, im, m, r = tie.flood_fill(torch.from_numpy(img), sp, nv, lo, up, conn, fixed,
                                 torch.from_numpy(m0) if mask_as_tensor else m0, mo, mf)
    assert isinstance(im, torch.Tensor) and isinstance(m, torch.Tensor)
    assert im.dtype == torch.from_numpy(img).dtype and m.dtype == torch.uint8
    return n, im.numpy(), m.numpy(), r


def _same(got, want, t):
    n, im, m, r = got
    n_w, im_w, m_w, r_w = want
    assert n == n_w and tuple(r) == tuple(r_w), (t, n, n_w, r, r_w)
    assert im.dtype == im_w.dtype and im.shape == im_w.shape, t
    assert np.array_equal(im.view(np.uint8), np.ascontiguousarray(im_w).view(np.uint8)), t
    assert np.array_equal(m, m_w), t


@pytest.mark.parametrize("block", range(4))
def test_port_vs_ref_and_cv2(block):
    """tests/test_floodfill.py::test_ref_vs_cv2's 80 configurations (its
    seed), 20 a case: the port equals ref/ and cv2."""
    rng = np.random.default_rng(seed("floodfill_ref"))
    for t in range(80):
        cfg = _configs(rng, t)
        if t // 20 != block:
            continue
        got = _port(*cfg, mask_as_tensor=t % 2 == 0)
        _same(got, ref.flood_fill(*cfg), t)
        _same(got, _cv(*cfg), t)


@pytest.mark.parametrize("t", range(14))
def test_port_vs_jax_device_op(t):
    """tests/test_floodfill.py::test_device_vs_cv2's 14 configurations (its
    seed): the port equals JAX's device op, ref/ and cv2."""
    rng = np.random.default_rng(seed("floodfill_dev"))
    for k in range(t + 1):
        cfg = _configs(rng, k)
    got = _port(*cfg)
    _same(got, ie.flood_fill(*cfg), t)
    _same(got, ref.flood_fill(*cfg), t)
    _same(got, _cv(*cfg), t)


def test_f32_and_u16_vs_jax_ref_and_cv2():
    """tests/test_floodfill.py::test_f32_and_u16's images, and an RGB u16
    image with a per-channel fill clipped at 65535."""
    rng = np.random.default_rng(seed("floodfill_f32"))
    f = (rng.random((12, 13)) * 10).astype(np.float32)
    m0 = np.zeros((14, 15), np.uint8)
    for diff, conn in ((0.7, 4), (3.0, 8)):
        cfg = (f, (4, 4), 77.5, diff, diff, conn, False, m0, False, 1)
        got = _port(*cfg)
        _same(got, _cv(*cfg), "f32")
        _same(got, ie.flood_fill(*cfg), "f32")
        _same(got, ref.flood_fill(*cfg), "f32")
    assert got[0] > 20
    u16 = rng.integers(0, 65536, (10, 11)).astype(np.uint16)
    cfg = (u16, (3, 3), 40000, 9000, 9000, 4, False, np.zeros((12, 13), np.uint8), False, 1)
    got = _port(*cfg)
    _same(got, ref.flood_fill(*cfg), "u16")
    _same(got, ie.flood_fill(*cfg), "u16")
    yy, xx = np.mgrid[0:10, 0:11]
    rgb = np.stack([yy * 3000 + xx * 2000, 60000 - xx * 500, yy * 700], -1).astype(np.uint16)
    for fixed in (False, True):
        cfg = (rgb, (5, 4), (40000.5, 1.5, 70000), (3000, 500, 700), (3000, 500, 700), 8,
               fixed, np.zeros((12, 13), np.uint8), False, 1)
        got = _port(*cfg)
        _same(got, ref.flood_fill(*cfg), ("u16 rgb", fixed))
        _same(got, ie.flood_fill(*cfg), ("u16 rgb", fixed))
        assert got[0] > (3 if fixed else 50)
        assert got[1][5, 4].tolist() == [40000, 2, 65535]


def test_fixpoint_on_a_spiral():
    """A 1-pixel corridor winding through a 31×31 frame: the fixpoint takes
    as many steps as the corridor is long (several blocks of CHECK_EVERY);
    the region, count and rectangle equal cv2's."""
    img = np.zeros((31, 31), np.uint8)
    top, left, bottom, right = 0, 0, 30, 30
    while top <= bottom and left <= right:
        img[top, left:right + 1] = 255
        img[top:bottom + 1, right] = 255
        if top + 2 <= bottom:
            img[bottom, left:right + 1] = 255
        if left + 2 <= right:
            img[top + 2:bottom + 1, left] = 255
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    cfg = (img, (0, 0), 100, 0, 0, 4, False, np.zeros((33, 33), np.uint8), False, 1)
    got = _port(*cfg)
    _same(got, _cv(*cfg), "spiral")
    _same(got, ref.flood_fill(*cfg), "spiral")
    x = torch.from_numpy(img).reshape(31, 31, 1).float()
    region, n, rect, steps = flood_region(x, torch.zeros(31, 31, dtype=torch.bool), (0, 0),
                                          torch.zeros(1), torch.zeros(1))
    assert n == got[0] and rect == got[3]
    assert steps % CHECK_EVERY == 0 and steps >= n - 1 > 4 * CHECK_EVERY


def test_validation_and_noop():
    img = torch.zeros((5, 5), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.flood_fill(img, (9, 0), 1)
    with pytest.raises(ValueError):
        tie.flood_fill(img, (1, 1), 1, connectivity=6)
    with pytest.raises(ValueError):
        tie.flood_fill(img, (1, 1), 1, mask=np.zeros((5, 5), np.uint8))
    with pytest.raises(ValueError):
        tie.flood_fill(torch.zeros((5, 5, 5), dtype=torch.uint8), (1, 1), 1)
    with pytest.raises(TypeError):
        tie.flood_fill(torch.zeros((5, 5), dtype=torch.int16), (1, 1), 1)
    with pytest.raises(TypeError):
        tie.flood_fill(np.zeros((5, 5), np.uint8), (1, 1), 1)
    # a blocked seed is a no-op; the caller's mask is not written
    m0 = np.zeros((7, 7), np.uint8)
    m0[1 + 2, 1 + 2] = 5
    mt = torch.from_numpy(m0.copy())
    n, im, m, r = tie.flood_fill(img, (2, 2), 200, mask=mt)
    assert n == 0 and r == (0, 0, 0, 0) and int(im[2, 2]) == 0
    assert torch.equal(mt, torch.from_numpy(m0))
    want = ie.flood_fill(np.zeros((5, 5), np.uint8), (2, 2), 200, mask=m0)
    np.testing.assert_array_equal(m.numpy(), want[2])
