"""The port's matchTemplate (ops/template.py) held to the JAX package's
ops/template.py (its planes function called eagerly on jnp arrays) and to
ref/ on numpy-seeded planes, all six methods and every dtype: within 3e-6
of each, relative to the output's largest magnitude (docs/PARITY.md
"matchTemplate": cv2 itself is within 2e-6 of ref/).  The port computes in
f64 as ref/ does, so against ref/ the integer dtypes come out equal; the
SQDIFF_NORMED clamp to [0, 1]; flat windows and the rejections."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import template as jt
from imageenhancement_mp_tpu_torch.ops import template as tt

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
IDS = ["u8", "u16", "i16", "f32"]
SHAPE = (2, 40, 64)
TOL = 3e-6


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    return float(np.abs(a.astype(np.float64) - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("tshape", [(7, 11), (1, 1), (40, 5)])
@pytest.mark.parametrize("method", tt.METHODS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_match_template_matches_ref_and_jax(dtype, method, tshape):
    x = _planes(SHAPE, dtype, 51)
    th, tw = tshape
    templ = x[0, 3:3 + th, 9:9 + tw].copy()
    got = tt.match_template_planes(torch.from_numpy(x), templ, method).numpy()
    want = np.stack([ref.match_template(p, templ, method) for p in x])
    assert _rel(got, want) <= (0 if dtype != np.float32 else TOL)
    assert _rel(got, jt.match_template_planes(jnp.asarray(x), templ, method)) <= TOL
    if method == "sqdiff_normed":
        assert got.min() >= 0 and got.max() <= 1


def test_flat_windows_and_the_clamp():
    """Constant windows (zero variance, zero energy) take cv2's fallbacks."""
    x = np.zeros((1, 20, 30), np.uint8)
    x[0, :, 15:] = 200
    templ = np.full((4, 4), 7, np.uint8)
    for method in tt.METHODS:
        got = tt.match_template_planes(torch.from_numpy(x), templ, method).numpy()
        want = np.stack([ref.match_template(p, templ, method) for p in x])
        np.testing.assert_array_equal(got, want)


def test_api_matches_jax_and_rejects():
    x = _planes((40, 64, 3), np.uint8, 52)
    templ = x[5:13, 7:19, 0].copy()
    got = tie.match_template(torch.from_numpy(x), templ, "ccorr_normed").numpy()
    assert _rel(got, ie.match_template(jnp.asarray(x), templ, "ccorr_normed")) <= TOL
    t = torch.from_numpy(x[..., 0].copy())[None]
    with pytest.raises(ValueError):
        tt.match_template_planes(t, templ, "sad")
    with pytest.raises(ValueError):
        tt.match_template_planes(t, np.zeros((41, 2)))
    with pytest.raises(ValueError):
        tt.match_template_planes(t, np.zeros(3))
    with pytest.raises(TypeError):
        tie.match_template(t.to(torch.int32), templ)
