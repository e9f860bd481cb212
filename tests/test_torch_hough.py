"""HoughLines and HoughLinesP in the port (ops/hough.py, utils/hough_host.py
and the api) on CPU tensors against the NumPy oracle ref/, the JAX
package's device op (``ie.hough_lines``) and cv2.

Tolerance 0: the lines are equal bit for bit (f32 (rho, theta) compared as
int32 words), the segments equal."""

import numpy as np
import pytest
import torch
from detseed import seed

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref import ops as rops
from imageenhancement_mp_tpu_torch.ops import hough as hough_ops
from imageenhancement_mp_tpu_torch.ops.hough import hough_accumulator
from imageenhancement_mp_tpu_torch.utils import hough_host

cv2 = pytest.importorskip("cv2")


def _gen(rng, hi_h=90, hi_w=90):
    """tests/test_hough.py's fuzz: 1-4 drawn lines and 3 % salt, ρ, θ,
    threshold and the angle range drawn at random."""
    H, W = int(rng.integers(20, hi_h)), int(rng.integers(20, hi_w))
    img = np.zeros((H, W), np.uint8)
    for _ in range(int(rng.integers(1, 5))):
        cv2.line(img, (int(rng.integers(0, W)), int(rng.integers(0, H))),
                 (int(rng.integers(0, W)), int(rng.integers(0, H))), 255, 1)
    img[rng.random((H, W)) < 0.03] = 255
    rho = float(rng.choice([1.0, 2.0, 0.5]))
    th = float(rng.choice([np.pi / 180, np.pi / 90, np.pi / 360]))
    thr = int(rng.integers(10, 40))
    mint = float(rng.choice([0.0, 0.3]))
    maxt = float(rng.choice([np.pi, 2.0]))
    return img, rho, th, thr, mint, maxt


def _cv(img, rho, th, thr, mint, maxt):
    w = cv2.HoughLines(img, rho, th, thr, min_theta=mint, max_theta=maxt)
    return np.zeros((0, 2), np.float32) if w is None else w.reshape(-1, 2)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("block", range(3))
def test_hough_lines_vs_ref_and_cv2(block):
    """tests/test_hough.py::test_ref_vs_cv2's 60 configurations (its seed),
    20 a case."""
    rng = np.random.default_rng(seed("hough_ref"))
    for t in range(60):
        cfg = _gen(rng)
        if t // 20 != block:
            continue
        got = tie.hough_lines(torch.from_numpy(cfg[0]), *cfg[1:])
        want = ref.hough_lines(*cfg)
        assert got.dtype == np.float32 and got.shape == want.shape, t
        assert np.array_equal(_bits(got), _bits(want)), t
        assert np.array_equal(_bits(got), _bits(_cv(*cfg))), t


@pytest.mark.parametrize("t", range(8))
def test_hough_lines_vs_jax_device_op(t):
    """Eight configurations of at most 48×64 (JAX compiles per shape): the
    port equals JAX's device op, ref/ and cv2."""
    rng = np.random.default_rng(seed("hough_dev"))
    for _ in range(t + 1):
        cfg = _gen(rng, 49, 65)
    got = tie.hough_lines(torch.from_numpy(cfg[0]), *cfg[1:])
    assert np.array_equal(_bits(got), _bits(ie.hough_lines(*cfg)))
    assert np.array_equal(_bits(got), _bits(ref.hough_lines(*cfg)))
    assert np.array_equal(_bits(got), _bits(_cv(*cfg)))


def test_accumulator_and_tables_vs_ref(monkeypatch):
    """The host tables are the JAX api's (ref/'s numangle, incremental-f32
    angles), and the accumulator's votes are ref/'s f32 law, in one chunk
    and in chunks of one angle."""
    rng = np.random.default_rng(seed("torch_hough_acc"))
    img, rho, th, _, mint, maxt = _gen(rng, 49, 65)
    numangle, tc, ts = hough_host.hough_tables(mint, maxt, th, rho)
    assert numangle == rops._hough_numangle(mint, maxt, th)
    ang = np.float32(mint) + np.zeros(1, np.float32)
    for _ in range(numangle - 1):
        ang = np.append(ang, np.float32(ang[-1] + np.float32(th)))
    np.testing.assert_array_equal(tc, (np.cos(ang.astype(np.float64)) / rho).astype(np.float32))
    H, W = img.shape
    numrho = hough_host.hough_numrho(H, W, rho)
    want = np.zeros((numangle, numrho), np.int32)
    ys, xs = np.nonzero(img)
    for n in range(numangle):
        r = np.rint((xs.astype(np.float32) * tc[n] + ys.astype(np.float32) * ts[n])
                    .astype(np.float32)).astype(int) + (numrho - 1) // 2
        np.add.at(want[n], r, 1)
    got = hough_accumulator(torch.from_numpy(img), tc, ts, numrho)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(hough_ops, "CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(hough_accumulator(torch.from_numpy(img), tc, ts,
                                                    numrho).numpy(), want)


def test_empty_and_simple():
    img = np.zeros((30, 30), np.uint8)
    assert tie.hough_lines(torch.from_numpy(img), 1.0, np.pi / 180, 10).shape == (0, 2)
    img[5, 2:20] = 255
    g = tie.hough_lines(torch.from_numpy(img), 1.0, np.pi / 180, 10)
    assert len(g) > 0
    assert np.array_equal(_bits(g), _bits(_cv(img, 1.0, np.pi / 180, 10, 0.0, np.pi)))
    with pytest.raises(TypeError):
        tie.hough_lines(img)
    with pytest.raises(TypeError):
        tie.hough_lines(torch.zeros((2, 30, 30), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tie.hough_lines(torch.zeros((30, 30), dtype=torch.int16))


@pytest.mark.parametrize("block", range(3))
def test_hough_lines_p_vs_ref_and_cv2(block):
    """tests/test_hough.py::TestHoughLinesP's 60 configurations (its seed),
    20 a case; tensors and arrays give the same segments."""
    rng = np.random.default_rng(seed("houghp"))
    for trial in range(60):
        H, W = int(rng.integers(20, 110)), int(rng.integers(20, 110))
        img = np.zeros((H, W), np.uint8)
        for _ in range(int(rng.integers(0, 6))):
            p1 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            p2 = (int(rng.integers(0, W)), int(rng.integers(0, H)))
            cv2.line(img, p1, p2, 255, int(rng.integers(1, 3)))
        img[rng.random((H, W)) < float(rng.choice([0.0, 0.02]))] = 255
        rho = float(rng.choice([0.5, 1.0, 2.0]))
        theta = float(rng.choice([np.pi / 180, np.pi / 90]))
        th = int(rng.integers(3, 50))
        ll = int(rng.integers(0, 40))
        lg = int(rng.integers(0, 15))
        if trial // 20 != block:
            continue
        want = cv2.HoughLinesP(img, rho, theta, th, minLineLength=ll, maxLineGap=lg)
        want = want.reshape(-1, 4) if want is not None else np.zeros((0, 4), np.int32)
        arg = torch.from_numpy(img) if trial % 2 else img
        got = tie.hough_lines_p(arg, rho, theta, th, ll, lg)
        assert got.dtype == np.int32
        assert np.array_equal(got, want), (H, W, rho, theta, th, ll, lg)
        assert np.array_equal(got, ref.hough_lines_p(img, rho, theta, th, ll, lg))


def test_hough_lines_p_finds_drawn_segment_and_lines_max():
    img = np.zeros((80, 80), np.uint8)
    cv2.line(img, (10, 20), (70, 60), 255, 1)
    cv2.line(img, (5, 70), (75, 72), 255, 1)
    got = tie.hough_lines_p(torch.from_numpy(img), 1, np.pi / 180, 30,
                            min_line_length=30, max_line_gap=2)
    assert len(got) >= 2
    one = tie.hough_lines_p(img, 1, np.pi / 180, 30, 30, 2, lines_max=1)
    np.testing.assert_array_equal(one, got[:1])
    np.testing.assert_array_equal(one, ref.hough_lines_p(img, 1, np.pi / 180, 30, 30, 2, 1))
