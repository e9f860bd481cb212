"""The port's Canny and connected components (ops/canny.py) held to the JAX
package's ops/canny.py (its planes functions called eagerly on jnp arrays)
and to ref/ at 0: Canny at apertures 3/5/7, L1 and L2, thresholds in
either order, on smooth noisy, random and tiny planes and on a weak chain
that hysteresis must follow across many of its steps; connected components
at connectivity 4 and 8 on thresholded planes, a spiral (one long snaking
component) and tiny planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import canny as jc
from imageenhancement_mp_tpu_torch.ops import canny as tc

SHAPE = (2, 40, 64)


def _smooth(seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
    base = 128 + 60 * np.sin(yy / 4.0) + 50 * np.cos(xx / 6.0)
    return np.clip(base + rng.normal(0, 8, SHAPE), 0, 255).astype(np.uint8)


def _random(seed):
    return np.random.default_rng(seed).integers(0, 256, SHAPE, dtype=np.uint8)


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresholds", [(50.0, 150.0), (200.0, 20.0), (10.5, 30.7), (0.0, 40000.0)])
@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("aperture", [3, 5, 7])
@pytest.mark.parametrize("kind", ["smooth", "random"])
def test_canny_matches_jax_and_ref(kind, aperture, l2, thresholds):
    x = _smooth(41) if kind == "smooth" else _random(42)
    t1, t2 = thresholds
    got = tc.canny_planes(torch.from_numpy(x), t1, t2, aperture, l2).numpy()
    _same(got, jc.canny_planes(jnp.asarray(x), t1, t2, aperture, l2))
    _same(got, np.stack([ref.canny(p, t1, t2, aperture, l2) for p in x]))


def test_canny_follows_a_weak_chain():
    """A step edge strong for 4 columns and weak (between the thresholds)
    for the other 60: every weak pixel is reached, one column a step."""
    x = np.full(SHAPE, 55, np.uint8)
    for b in range(2):
        for c in range(SHAPE[2]):
            row = 20 + (c // 7) % 3 if b else 20       # the second plane's edge wanders
            x[b, row:, c] = 255 if c < 4 else 85    # a step of 200 strong, of 30 weak
    keep, strong = tc.canny_candidates(torch.from_numpy(x), 60.0, 400.0)
    edges, steps = tc.hysteresis(keep, strong)
    assert steps >= SHAPE[2] - 4 and steps % tc.CHECK_EVERY == 0
    got = (edges.to(torch.uint8) * 255).numpy()
    assert got.any(axis=1).all()                   # the chain reaches every column
    _same(got, jc.canny_planes(jnp.asarray(x), 60.0, 400.0))
    _same(got, np.stack([ref.canny(p, 60.0, 400.0) for p in x]))
    _same(tc.canny_planes(torch.from_numpy(x), 60.0, 400.0).numpy(), got)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 3, 5)])
def test_canny_tiny_planes(shape):
    x = np.random.default_rng(43).integers(0, 256, shape, dtype=np.uint8)
    for aperture in (3, 5, 7):
        got = tc.canny_planes(torch.from_numpy(x), 20.0, 60.0, aperture).numpy()
        _same(got, np.stack([ref.canny(p, 20.0, 60.0, aperture) for p in x]))


def _spiral():
    m = np.zeros((41, 41), np.uint8)
    lo, hi = 0, 40
    while lo < hi:
        m[lo, lo:hi + 1] = 255
        m[lo:hi + 1, hi] = 255
        m[hi, lo:hi + 1] = 255
        m[lo + 2:hi + 1, lo] = 255
        lo += 2
        hi -= 2
    return m[None]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("kind", ["smooth", "random", "sparse", "spiral"])
def test_connected_components_match_jax_and_ref(kind, conn):
    if kind == "spiral":
        m = _spiral()
    elif kind == "sparse":
        m = (_random(44) > 200).astype(np.uint8) * 255
    else:
        m = ((_smooth(45) if kind == "smooth" else _random(46)) > 128).astype(np.uint8)
    got = tc.connected_components_planes(torch.from_numpy(m), conn).numpy()
    _same(got, jc.connected_components_planes(jnp.asarray(m), conn))
    _same(got, np.stack([ref.connected_components(p, conn) for p in m]))


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 3, 5)])
def test_connected_components_tiny_planes(shape):
    for fill in (0, 1, None):
        m = (np.full(shape, fill, np.uint8) if fill is not None else
             np.random.default_rng(47).integers(0, 2, shape).astype(np.uint8))
        for conn in (4, 8):
            got = tc.connected_components_planes(torch.from_numpy(m), conn).numpy()
            _same(got, np.stack([ref.connected_components(p, conn) for p in m]))


def test_api_matches_jax_and_rejects():
    x = _smooth(48)[0]
    t = torch.from_numpy(x)
    _same(tie.canny(t, 40.0, 120.0, 5, True).numpy(),
          ie.canny(jnp.asarray(x), 40.0, 120.0, 5, True))
    m = (x > 128).astype(np.uint8)
    _same(tie.connected_components(torch.from_numpy(m), 4).numpy(),
          ie.connected_components(jnp.asarray(m), 4))
    with pytest.raises(TypeError):
        tie.canny(t.to(torch.int16), 1.0, 2.0)
    with pytest.raises(ValueError):
        tc.canny_planes(t[None], 1.0, 2.0, 4)
    with pytest.raises(ValueError):
        tc.connected_components_planes(t[None], 6)
    with pytest.raises(TypeError):
        tie.connected_components(t.to(torch.float32))
