"""phaseCorrelate, seamlessClone, inpaint and the host copies behind them in
the port (api.py, ops/seamless.py, utils/photo_host.py) against the NumPy
oracle ref/ and the JAX package on the CPU.

Tolerances: phase_correlate within 5e-2 px of the f64 oracle (f32 spectra;
tests/test_phasecorr.py's device budget); seamless_clone max ≤ 2 and mean
< 0.05 against ref/seamless.py (tests/test_seamless.py), the identity clone
±1; inpaint, the optimal DFT sizes and the Hanning window bit for bit.
"""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from detseed import seed
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref.inpaint import inpaint_telea
from imageenhancement_mp_tpu.ref.seamless import seamless_clone as ref_seamless_clone
from imageenhancement_mp_tpu_torch.utils import photo_host


def test_optimal_dft_size_and_hanning_window_are_refs():
    assert [photo_host.optimal_dft_size(n) for n in range(1, 1100)] == \
        [ref.ops._optimal_dft_size(n) for n in range(1, 1100)]
    for hw in [(64, 80), (33, 47), (5, 8), (1080, 1920)]:
        np.testing.assert_array_equal(photo_host.create_hanning_window(hw),
                                      ref.create_hanning_window(hw))


def _smooth(rng, H, W):
    """Gaussian noise blurred by a separable [1 4 6 4 1]² filter twice."""
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16
    x = rng.normal(120, 40, (H, W))
    for _ in range(2):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, x)
        x = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, x)
    return x.astype(np.float32)


@pytest.mark.parametrize("case", range(4))
def test_phase_correlate_matches_ref_and_jax(case):
    rng = np.random.default_rng(seed("phasecorr", case))
    H, W = int(rng.integers(30, 49)), int(rng.integers(30, 49))
    big = _smooth(rng, H + 20, W + 20)
    dy, dx = int(rng.integers(0, 6)), int(rng.integers(0, 6))
    a = big[8:8 + H, 8:8 + W]
    b = big[8 + dy:8 + H + dy, 8 + dx:8 + W + dx]
    win = photo_host.create_hanning_window((H, W)) if case % 2 else None
    (gx, gy), gr = ref.phase_correlate(a.astype(np.float64), b.astype(np.float64), win)
    (tx, ty), tr = tie.phase_correlate(torch.from_numpy(a), torch.from_numpy(b),
                                       None if win is None else torch.from_numpy(win))
    print(f"phase_correlate: port ({tx:.5f}, {ty:.5f}) {tr:.5f}, ref ({gx:.5f}, {gy:.5f}) "
          f"{gr:.5f}, true ({-dx}, {-dy})")
    assert abs(tx - gx) < 5e-2 and abs(ty - gy) < 5e-2
    assert abs(tr - gr) < 5e-2
    (jx, jy), _ = jie.phase_correlate(a, b, win)
    assert abs(tx - jx) < 5e-2 and abs(ty - jy) < 5e-2


def test_phase_correlate_takes_the_first_maximum_and_clamps():
    """Two equal peaks: the first in row-major order wins (cv2's minMaxLoc);
    a peak on the border clamps the 5×5 box (ref/'s centroid, JAX's
    duplicate-zeroed box)."""
    a = np.zeros((16, 20), np.float32)
    a[0, 0] = 1.0
    b = a.copy()
    (tx, ty), tr = tie.phase_correlate(torch.from_numpy(a), torch.from_numpy(b))
    (gx, gy), gr = ref.phase_correlate(a.astype(np.float64), b.astype(np.float64))
    assert abs(tx - gx) < 5e-2 and abs(ty - gy) < 5e-2 and abs(tr - gr) < 5e-2
    with pytest.raises(ValueError):
        tie.phase_correlate(torch.zeros((4, 5)), torch.zeros((5, 4)))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.phase_correlate(a, b)


def test_seamless_clone_tracks_ref():
    rng = np.random.default_rng(seed("seamless", "dev"))
    src = np.stack([_smooth(rng, 40, 50) for _ in range(3)], -1).clip(0, 255).astype(np.uint8)
    dst = np.stack([_smooth(rng, 60, 70) for _ in range(3)], -1).clip(0, 255).astype(np.uint8)
    mask = np.zeros((40, 50), np.uint8)
    mask[8:30, 10:40] = 255
    p = (35, 30)
    want = ref_seamless_clone(src, dst, mask, p)
    got = tie.seamless_clone(torch.from_numpy(src), torch.from_numpy(dst),
                             torch.from_numpy(mask), p).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    print(f"seamless_clone vs ref: max {d.max()}, mean {d.mean():.6f}")
    assert d.max() <= 2 and d.mean() < 0.05
    m2 = np.zeros(dst.shape[:2], bool)
    m2[30 - 11:30 + 11, 35 - 15:35 + 15] = True
    np.testing.assert_array_equal(got[~m2], dst[~m2])
    jax_out = np.asarray(jie.seamless_clone(src, dst, mask, p))
    assert np.abs(got.astype(int) - jax_out.astype(int)).max() <= 2


@pytest.mark.parametrize("gray", [False, True])
def test_seamless_clone_identity_and_rejects(gray):
    rng = np.random.default_rng(seed("seamless", "id", gray))
    img = rng.integers(0, 256, (40, 50) if gray else (40, 50, 3), np.uint8)
    mask = np.zeros((40, 50), np.uint8)
    mask[10:25, 12:30] = 255
    t = torch.from_numpy(img)
    out = tie.seamless_clone(t, t, torch.from_numpy(mask), (21, 17)).numpy()
    assert np.abs(out.astype(int) - img.astype(int)).max() <= 1
    np.testing.assert_array_equal(ref_seamless_clone(img, img, mask, (21, 17)), img)
    z = torch.zeros((20, 20), dtype=torch.uint8)
    np.testing.assert_array_equal(tie.seamless_clone(z, z, z, (10, 10)).numpy(), z.numpy())
    full = torch.full((20, 20), 255, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.seamless_clone(z, z, full, (1, 1))
    with pytest.raises(ValueError):
        tie.seamless_clone(z, z, full, (10, 10), flags="mixed")
    with pytest.raises(TypeError):
        tie.seamless_clone(z.float(), z, full, (10, 10))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.seamless_clone(z.numpy(), z, full, (10, 10))


@pytest.mark.parametrize("case", ["block", "stroke", "speckle", "smooth"])
def test_inpaint_is_refs_bit_for_bit(case):
    """The four masks of tests/test_inpaint.py."""
    rng = np.random.default_rng(seed("inpaint", case))
    if case == "smooth":
        yy, xx = np.mgrid[0:30, 0:30]
        img = (100 + 2 * xx + yy).clip(0, 255).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (30, 34) if case == "block" else (28, 40), np.uint8)
    mask = np.zeros_like(img)
    r = {"block": 3, "stroke": 4, "speckle": 2, "smooth": 3}[case]
    if case == "block":
        mask[10:16, 12:20] = 255
    elif case == "stroke":
        mask[14:16, 4:36] = 255
    elif case == "speckle":
        mask = (rng.random(img.shape) < 0.05).astype(np.uint8) * 255
    else:
        mask[12:18, 12:18] = 255
    got = tie.inpaint(torch.from_numpy(img), torch.from_numpy(mask), r)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), inpaint_telea(img, mask, r))
    np.testing.assert_array_equal(got.numpy(), jie.inpaint(img, mask, r))


def test_inpaint_empty_mask_and_rejects():
    img = torch.zeros((8, 8), dtype=torch.uint8)
    np.testing.assert_array_equal(tie.inpaint(img, torch.zeros_like(img), 3).numpy(), img.numpy())
    with pytest.raises(ValueError):
        tie.inpaint(img, torch.zeros_like(img), 3, flags="ns")
    with pytest.raises(TypeError):
        tie.inpaint(img.float(), torch.zeros_like(img), 3)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.inpaint(img.numpy(), torch.zeros_like(img), 3)
