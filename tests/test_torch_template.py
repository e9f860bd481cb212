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


@pytest.mark.parametrize("call", ["match_template", "filter2d", "sep_filter2d", "morphology",
                                  "calc_back_project"])
def test_host_arguments_may_be_tensors(call):
    """A template, kernel or histogram given as a tensor (on any device:
    np.asarray reads neither a CUDA tensor nor one that requires grad, the
    CPU stand-in here) gives what the same array gives."""
    rng = np.random.default_rng(sum(map(ord, call)))
    img = torch.from_numpy(rng.integers(0, 256, (21, 26), dtype=np.uint8))
    arg = {"match_template": rng.integers(0, 256, (5, 7)).astype(np.float32),
           "filter2d": rng.normal(size=(3, 5)),
           "sep_filter2d": rng.normal(size=5),
           "morphology": (rng.random((3, 5)) > 0.4).astype(np.uint8),
           "calc_back_project": rng.random(32) * 300}[call]
    fn = {"match_template": lambda a: tie.match_template(img, a),
          "filter2d": lambda a: tie.filter2d(img, a),
          "sep_filter2d": lambda a: tie.sep_filter2d(img, a, a[1:]),
          "morphology": lambda a: tie.morphology_ex(img, "close", kernel=a),
          "calc_back_project": lambda a: tie.calc_back_project(img, a, 0.7)}[call]
    want = fn(arg)
    got = fn(torch.tensor(arg, dtype=torch.float64, requires_grad=True))
    assert torch.equal(got, want)
