"""Shared inputs of the warp tests (tests/test_torch_warp*.py): images and
remap maps from numpy seeds, the matrices, and the comparison against ref/
(0 LSB) and the JAX package."""

import numpy as np
import torch

from imageenhancement_mp_tpu.ref import ops as ref

DTYPES = [np.uint8, np.uint16, np.float32]
BORDERS = [("constant", 9.0), ("constant", 300.0), ("replicate", 0.0)]
BORDER_IDS = ["const9", "const300", "replicate"]
ROT31 = ref.get_rotation_matrix_2d((20.0, 12.0), 31.0, 1.1)
HOMOGRAPHY = np.array([[1.0, 0.05, -5.0], [0.02, 0.98, 3.0], [2e-4, 1e-4, 1.0]])
K = np.array([[30.0, 0.0, 20.5], [0.0, 28.0, 12.0], [0.0, 0.0, 1.0]])
DIST = [-0.21, 0.05, 1e-3, -2e-3, 0.01]


def img(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape) * 500 - 100).astype(np.float32)
    lo, hi = {np.uint8: (0, 256), np.uint16: (0, 65536), np.int16: (-32768, 32768)}[dtype]
    return rng.integers(lo, hi, shape).astype(dtype)


def maps(H, W, oh, ow, seed):
    """Random remap maps reaching two pixels past every edge of the plane."""
    rng = np.random.default_rng(seed)
    mx = (rng.random((oh, ow)) * (W + 4) - 2).astype(np.float32)
    my = (rng.random((oh, ow)) * (H + 4) - 2).astype(np.float32)
    return mx, my


def per_plane(fn, x):
    return np.stack([fn(p) for p in x])


def check(got: torch.Tensor, want_ref: np.ndarray, want_jax, tol_jax: float = 0.0):
    """0 LSB against ref/; ``tol_jax`` against JAX; same dtype and shape."""
    g = got.numpy()
    assert g.dtype == want_ref.dtype and g.shape == want_ref.shape
    np.testing.assert_array_equal(g, want_ref)
    j = np.asarray(want_jax)
    assert j.shape == g.shape
    d = np.abs(g.astype(np.float64) - j.astype(np.float64)).max() if g.size else 0.0
    assert d <= tol_jax, d
