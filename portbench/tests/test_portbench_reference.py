"""The plain references against the port's CPU path and against OpenCV, and
the control against the references, at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import faults, harness
from portbench.reference import plain
from portbench.traffic import content

from .conftest import SMALL, small_cell

CELLS = ["histeq_unsharp.gray1080p-b64", "denoise_clahe_sharpen.gray4k-b16",
         "histeq_unsharp.rgb1080p-b16", "denoise_clahe_sharpen.u16-4k-b2"]


def _batches(cell, seed):
    return content.make_pool(cell.traffic, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_reference_equals_the_port_on_the_cpu(name, seed):
    cell = small_cell(name)
    reference = harness.load_module("reference", cell.config_name).reference
    program = harness.program_entry(cell.config)
    for batch in _batches(cell, seed):
        want, got = reference(batch, cell.config), program(batch)
        assert want.shape == got.shape and want.dtype == got.dtype
        assert torch.equal(want, got)


@pytest.mark.parametrize("name", CELLS)
def test_control_differs_from_the_reference(name):
    cell = small_cell(name)
    reference = harness.load_module("reference", cell.config_name).reference
    control = faults.control(reference, cell.config)
    batch = _batches(cell, 5)[0]
    diff = (control(batch).to(torch.int32) - reference(batch, cell.config).to(torch.int32)).abs()
    assert int(diff.max()) >= 1


def _u16(rng, shape, hi=4096):
    return rng.integers(0, hi, shape, dtype=np.uint16)


@pytest.mark.parametrize("shape", [(37, 131), (48, 64), (33, 70), (8, 8), (9, 17)])
def test_plain_ops_equal_opencv(shape):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    u8 = rng.integers(0, 256, shape, dtype=np.uint8)
    u8 = (u8 // 3 + 40).astype(np.uint8)
    u16 = _u16(rng, shape)
    t8, t16 = torch.from_numpy(u8)[None], torch.from_numpy(u16.astype(np.int32)).to(torch.uint16)[None]

    def arr(t):
        return t[0].to(torch.int32).numpy()

    assert (arr(plain.equalize_hist(t8)) == cv2.equalizeHist(u8)).all()
    for src, t in ((u8, t8), (u16, t16)):
        blur = cv2.GaussianBlur(src, (5, 5), 0)
        assert (arr(plain.gaussian_blur(t, 5, 0.0)) == blur).all()
        sharp = cv2.addWeighted(src, 2.0, blur, -1.0, 0)
        assert (arr(plain.unsharp_mask(t, 1.0, 5, 0.0)) == sharp).all()
        assert (arr(plain.median_blur(t, 5)) == cv2.medianBlur(src, 5)).all()
        want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(src)
        assert (arr(plain.clahe(t, 2.0, (8, 8))) == want).all()


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (7, 0.0), (11, 0.0), (5, 1.3), (9, 2.5)])
def test_gaussian_taps_equal_opencv(ksize, sigma):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(ksize)
    for dtype, hi in ((np.uint8, 256), (np.uint16, 65536)):
        src = rng.integers(0, hi, (23, 41)).astype(dtype)
        t = torch.from_numpy(src.astype(np.int32)).to(torch.from_numpy(src).dtype)[None]
        got = plain.gaussian_blur(t, ksize, sigma)[0].to(torch.int32).numpy()
        assert (got == cv2.GaussianBlur(src, (ksize, ksize), sigma)).all()


def test_small_sizes_cover_every_mix():
    assert {small_cell(name).traffic_name for name in CELLS} == set(SMALL)
