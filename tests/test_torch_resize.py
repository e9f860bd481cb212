"""The port's resize, flip, rotate and transpose (ops/resize.py) held to the
JAX package's ops/resize.py (its planes functions called eagerly on jnp
arrays) and to ref/ on numpy-seeded planes; the copied host tables
(utils/resize_tables.py) bit for bit against ref/'s.

Tolerances: 0 against ref/ for every integer output (nearest; linear u8;
cubic and lanczos4 u8, exact integer sums; u16/i16 linear, cubic and
lanczos4 in ref/'s f32 order; integer-factor area; the general area
downscale, summed in f64 as ref/ sums it); against JAX 0 for nearest,
linear u8, lanczos4 u8 and integer-factor area, ±1 for cubic u8 (the JAX
package's f32 vertical pass is its documented 1-LSB budget against the
int64 oracle on razor ties), ±1 for u16/i16 linear, cubic and lanczos4
(ROADMAP R4) and ±1 for the general area downscale (its f32 matmuls), on at
most 2 % of the pixels.  f32 outputs: within 1e-6 of JAX and of ref/
relative to the output's largest magnitude.  Flip, rotate and transpose: 0,
uint16 included, and contiguous."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import resize as jr
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.ops import resize as tr
from imageenhancement_mp_tpu_torch.utils import resize_tables

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
IDS = ["u8", "u16", "i16", "f32"]
SHAPE = (2, 30, 48)
TINY = [(1, 1, 1), (1, 3, 5)]
# downscale by integer factors (2x2, 3x4, 1x2), general downscales, upscales,
# mixed axes, one pixel
SIZES = [(15, 24), (10, 12), (30, 24), (17, 29), (7, 48), (45, 70), (31, 100), (20, 96),
         (1, 1)]


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape, dtype=np.float32) * 500 - 100).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _diff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max(initial=0.0))


def _rel(a, b):
    return _diff(a, b) / max(float(np.abs(np.asarray(b, np.float64)).max(initial=0.0)), 1e-30)


def _jax_budget(dtype, interp, H, W, oh, ow) -> int:
    if interp == "nearest" or (interp in ("linear", "lanczos4") and dtype == np.uint8):
        return 0
    if interp == "area":
        integer_factor = H % oh == 0 and W % ow == 0
        return 0 if integer_factor or oh > H or ow > W else 1
    return 1


@pytest.mark.parametrize("dsize", SIZES)
@pytest.mark.parametrize("interp", tr.INTERPOLATIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_resize_matches_ref_and_jax(dtype, interp, dsize):
    x = _planes(SHAPE, dtype, 31)
    got = tr.resize_planes(torch.from_numpy(x), dsize, interp).numpy()
    jax_out = np.asarray(jr.resize_planes(jnp.asarray(x), dsize, interp))
    want = np.stack([ref.resize(p, dsize, interp) for p in x])
    if dtype == np.float32:
        assert _rel(got, want) <= 1e-6 and _rel(got, jax_out) <= 1e-6
        return
    assert _diff(got, want) == 0
    assert _diff(got, jax_out) <= _jax_budget(dtype, interp, *SHAPE[1:], *dsize)
    if interp == "area":
        assert np.count_nonzero(got != jax_out) <= 0.02 * got.size


@pytest.mark.parametrize("shape", TINY)
@pytest.mark.parametrize("interp", tr.INTERPOLATIONS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_resize_tiny_planes(dtype, interp, shape):
    x = _planes(shape, dtype, 32)
    for dsize in ((1, 1), (4, 9), (2, 3)):
        got = tr.resize_planes(torch.from_numpy(x), dsize, interp).numpy()
        want = np.stack([ref.resize(p, dsize, interp) for p in x])
        if dtype == np.float32:
            assert _rel(got, want) <= 1e-6
        else:
            assert _diff(got, want) == 0, dsize


def test_lanczos_u8_wraps_in_int32_like_jax():
    """Adversarial ringing (a checkerboard at full contrast, upscaled) keeps
    the centred int32 sums and equals JAX's, which wrap where cv2 wraps."""
    x = (np.indices((1, 12, 16)).sum(0) % 2 * 255).astype(np.uint8)
    for dsize in ((29, 41), (5, 7)):
        got = tr.resize_planes(torch.from_numpy(x), dsize, "lanczos4").numpy()
        assert _diff(got, jr.resize_planes(jnp.asarray(x), dsize, "lanczos4")) == 0
        assert _diff(got, np.stack([ref.resize(p, dsize, "lanczos4") for p in x])) == 0


@pytest.mark.parametrize("n,on", [(30, 15), (30, 17), (48, 100), (7, 3), (1, 5), (5, 1), (18, 66),
                                  (45, 50)])
def test_tables_are_refs(n, on):
    for area in (False, True):
        for a, b in zip(resize_tables.resize_lin_tables(n, on, area),
                        ref_ops.resize_lin_tables(n, on, area)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for mine, theirs in ((resize_tables.resize_cubic_tables, ref_ops.resize_cubic_tables),
                         (resize_tables.resize_lanczos_tables, ref_ops.resize_lanczos_tables)):
        for a, b in zip(mine(n, on), theirs(n, on)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for t in np.linspace(0.0, 1.0, 29, endpoint=False).astype(np.float32).tolist() + [1e-9]:
        assert np.array_equal(resize_tables.cubic_weights(t), ref_ops.cubic_weights(t))
        w = resize_tables.lanczos4_weights(t)
        assert w.dtype == np.float32 and np.array_equal(w, ref_ops.lanczos4_weights(t))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_flip_rotate_transpose(dtype):
    x = _planes(SHAPE, dtype, 33)
    t = torch.from_numpy(x)
    for code in (0, 1, -1, 5, -2):
        got = tr.flip_planes(t, code)
        assert got.is_contiguous() and got.dtype == t.dtype
        assert _diff(got.numpy(), np.stack([ref.flip(p, code) for p in x])) == 0
        assert _diff(got.numpy(), jr.flip_planes(jnp.asarray(x), code)) == 0
    for code in ("90cw", "180", "90ccw"):
        got = tr.rotate_planes(t, code)
        assert got.is_contiguous()
        assert _diff(got.numpy(), np.stack([ref.rotate(p, code) for p in x])) == 0
        assert _diff(got.numpy(), jr.rotate_planes(jnp.asarray(x), code)) == 0
    got = tr.transpose_planes(t)
    assert got.is_contiguous() and _diff(got.numpy(), np.stack([ref.transpose(p) for p in x])) == 0
    with pytest.raises(ValueError):
        tr.rotate_planes(t, "45")


def test_api_matches_jax_and_rejects():
    x = _planes((1, 30, 48, 3), np.uint8, 34)
    t = torch.from_numpy(x)
    for interp in tr.INTERPOLATIONS:
        budget = 1 if interp == "cubic" else 0
        assert _diff(tie.resize(t, (15, 24), interp), ie.resize(jnp.asarray(x), (15, 24), interp)) \
            <= budget
    assert _diff(tie.flip(t, -1), ie.flip(jnp.asarray(x), -1)) == 0
    assert _diff(tie.rotate(t[0], "90ccw"), ie.rotate(jnp.asarray(x[0]), "90ccw")) == 0
    assert _diff(tie.transpose(t), ie.transpose(jnp.asarray(x))) == 0
    with pytest.raises(ValueError):
        tr.resize_planes(t[0], (0, 4))
    with pytest.raises(ValueError):
        tr.resize_planes(t[0], (4, 4), "bilinear")
    with pytest.raises(TypeError):
        tie.resize(t.to(torch.int32), (4, 4))
