"""The LUT kernels' plain versions (kernels/hist.py: apply_lut256 with every
table dtype, apply_luts_multi) held to the JAX package's K5 and K13 in
interpret mode and to NumPy, at 0 LSB (float tables bit for bit); u16
``apply_lut_planes`` and u16 histograms; the tables carried over by
``interop.luts_from_jax``; and each wrapper's CUDA branch, driven on a CPU
tensor with ``on_cuda`` and ``launch`` stubbed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.kernels.hist import apply_lut256_pallas, apply_luts_multi_pallas
from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes as jax_apply_lut_planes
from imageenhancement_mp_tpu.ops.pointwise import stretch_luts_from_minmax as jax_stretch_luts
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.ops import histogram as thist
from imageenhancement_mp_tpu_torch.ops import pointwise as tpoint

WIDE = (np.uint16, np.int16, np.int32, np.float32)
SHAPES = [(2, 64, 256), (1, 37, 131), (3, 1000)]


def _planes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _tables(shape, dtype, seed, full=False):
    """Random tables; int32 entries below 2^24 unless ``full`` (the JAX
    one-hot form is exact only there), f32 normal values unless ``full``
    (then ±inf, NaN, subnormals and ±2^31-1 are mixed in)."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        t = (rng.standard_normal(shape) * 1e3).astype(np.float32)
        if full:
            specials = np.array([np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, 0.0, -0.0,
                                 3.4028235e38], np.float32)
            t.reshape(-1)[:: 7] = np.resize(specials, t.reshape(-1)[:: 7].shape)
        return t
    info = np.iinfo(dtype)
    lo, hi = (info.min, info.max) if full or dtype != np.int32 else (-2**24 + 1, 2**24 - 1)
    t = rng.integers(lo, hi, shape, endpoint=True).astype(dtype)
    if full:
        t.reshape(-1)[:2] = (info.min if dtype != np.int32 else -2**31 + 1, info.max)
    return t


def _bits(a):
    """An array's bits as integers, so NaN payloads and -0.0 compare too."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# -- K5: apply_lut256 with every table dtype --------------------------------------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", WIDE)
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_lut256_wide_matches_pallas(shape, dtype, shared):
    x = _planes(shape, 21)
    lut = _tables((256,) if shared else (shape[0], 256), dtype, 22)
    got = khist.apply_lut256(torch.from_numpy(x), torch.from_numpy(lut)).numpy()
    want = np.asarray(apply_lut256_pallas(x, lut, interpret=True))
    assert got.dtype == want.dtype == dtype and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the op-level entry point takes the same tables
    np.testing.assert_array_equal(
        _bits(tpoint.apply_lut_planes(torch.from_numpy(x), torch.from_numpy(lut)).numpy()),
        _bits(want))


@pytest.mark.parametrize("dtype", WIDE)
def test_apply_lut256_full_range_against_numpy(dtype):
    """i32 at ±(2^31−1) and f32 infinities, NaN and subnormals, bit for bit."""
    x = _planes((3, 37, 131), 23)
    x[:, 0, :128], x[:, 1, :128] = np.arange(128), np.arange(128, 256)  # every entry is read
    for lut in (_tables((3, 256), dtype, 24, full=True), _tables((256,), dtype, 25, full=True)):
        got = khist.apply_lut256(torch.from_numpy(x), torch.from_numpy(lut)).numpy()
        want = lut[x] if lut.ndim == 1 else np.stack([l[p] for l, p in zip(lut, x)])
        np.testing.assert_array_equal(_bits(got), _bits(want))


# -- K13: apply_luts_multi ---------------------------------------------------------

@pytest.mark.parametrize("K", [1, 9])
@pytest.mark.parametrize("dtype", (np.uint8,) + WIDE)
def test_apply_luts_multi_matches_pallas(dtype, K):
    x = _planes((2, 30, 41), 26)
    luts = _tables((2, K, 256), dtype, 27)
    got = khist.apply_luts_multi(torch.from_numpy(x), torch.from_numpy(luts))
    want = apply_luts_multi_pallas(x, luts, interpret=True)
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        assert g.shape == x.shape and g.numpy().dtype == dtype
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("dtype", (np.uint8,) + WIDE)
def test_apply_luts_multi_full_range_against_numpy(dtype):
    x = _planes((3, 1000), 28)
    luts = _tables((3, 64, 256), dtype, 29, full=True)
    got = khist.apply_luts_multi(torch.from_numpy(x), torch.from_numpy(luts))
    for k, g in enumerate(got):
        want = np.stack([luts[b, k][x[b]] for b in range(3)])
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(want), err_msg=str(k))


def test_lut_kernels_reject_what_they_do_not_take():
    x = torch.zeros((2, 4, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        khist.apply_lut256(x, torch.zeros(256, dtype=torch.int64))
    with pytest.raises(TypeError):
        khist.apply_lut256(x.to(torch.int16), torch.zeros(256, dtype=torch.int32))
    with pytest.raises(ValueError):
        khist.apply_lut256(x, torch.zeros((3, 256), dtype=torch.float32))
    with pytest.raises(TypeError):
        khist.apply_luts_multi(x, torch.zeros((2, 3, 256), dtype=torch.float64))
    for shape in ((2, 0, 256), (3, 2, 256), (2, 2, 255), (2, 256)):
        with pytest.raises(ValueError):
            khist.apply_luts_multi(x, torch.zeros(shape, dtype=torch.uint8))
    with pytest.raises(ValueError):
        khist.apply_luts_multi(x.to("meta"), torch.zeros((2, 1, 256), dtype=torch.uint8))
    with pytest.raises(ValueError):
        tpoint.apply_lut_planes(x.to(torch.uint16), torch.zeros(256, dtype=torch.uint8))
    with pytest.raises(ValueError):
        tpoint.apply_lut_planes(x.to(torch.uint16), torch.zeros((3, 65536), dtype=torch.uint16))
    with pytest.raises(ValueError):
        tpoint.apply_lut_planes(x.to(torch.int16), torch.zeros(65536, dtype=torch.uint8))


# -- the CUDA branches, launch stubbed --------------------------------------------

TALL = (1, 1_100_000, 8)


@pytest.fixture
def launches(monkeypatch):
    calls = []
    monkeypatch.setattr(khist, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(khist, "launch", lambda *args: calls.append(args))
    return calls


@pytest.mark.parametrize("dtype,name,nbytes", [
    (torch.uint8, "apply_lut256", None), (torch.uint16, "apply_lut256_wide", 2),
    (torch.int16, "apply_lut256_wide", 2), (torch.int32, "apply_lut256_wide", 4),
    (torch.float32, "apply_lut256_wide", 4)])
@pytest.mark.parametrize("shared", [True, False])
def test_apply_lut256_cuda_branch(launches, dtype, name, nbytes, shared):
    x = torch.zeros(TALL, dtype=torch.uint8)
    lut = torch.zeros((256,) if shared else (1, 256), dtype=dtype)
    out = khist.apply_lut256(x, lut)
    assert out.shape == TALL and out.dtype == dtype
    assert len(launches) == 1
    kernel, device, xp, lp, stride, op, B, n, *rest = launches[0]
    assert (kernel, device, xp, lp, op) == (name, x.device, x.data_ptr(), lut.data_ptr(),
                                            out.data_ptr())
    assert (stride, B, n) == (0 if shared else 256, 1, TALL[1] * TALL[2])
    assert rest == ([] if nbytes is None else [nbytes])


@pytest.mark.parametrize("dtype,nbytes", [(torch.uint8, 1), (torch.int16, 2),
                                          (torch.float32, 4)])
@pytest.mark.parametrize("K", [1, 9, 64])
def test_apply_luts_multi_cuda_branch(launches, dtype, nbytes, K):
    shape = TALL if K < 64 else (3, 8, 8)
    x = torch.zeros(shape, dtype=torch.uint8)
    luts = torch.zeros((shape[0], K, 256), dtype=dtype)
    outs = khist.apply_luts_multi(x, luts)
    assert len(outs) == K and all(o.shape == shape and o.dtype == dtype for o in outs)
    assert len(launches) == 1
    assert launches[0] == ("apply_luts_multi", x.device, x.data_ptr(), luts.data_ptr(), K,
                           outs[0].data_ptr(), shape[0], shape[1] * shape[2], nbytes)
    # the K outputs are views of one [K, B, ...] tensor, in table order
    assert outs[-1].data_ptr() - outs[0].data_ptr() == (K - 1) * x.numel() * outs[0].element_size()


def test_empty_planes_launch_nothing(launches):
    x = torch.zeros((2, 0, 5), dtype=torch.uint8)
    assert khist.apply_lut256(x, torch.zeros(256, dtype=torch.float32)).shape == x.shape
    assert [o.shape for o in khist.apply_luts_multi(x, torch.zeros((2, 3, 256), dtype=torch.int16))] \
        == [x.shape] * 3
    assert launches == []


# -- u16 planes, u16 histograms ---------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint16, np.uint8, np.float32])
@pytest.mark.parametrize("shared", [True, False])
def test_apply_lut_planes_u16_matches_jax(shared, dtype):
    """u16 planes with 65536-entry tables: a plain gather on both devices."""
    rng = np.random.default_rng(30)
    x = rng.integers(0, 65536, (3, 23, 41)).astype(np.uint16)
    x[0, 0, :2] = (0, 65535)
    shape = (65536,) if shared else (3, 65536)
    lut = (rng.standard_normal(shape) * 1e4).astype(dtype) if dtype == np.float32 else \
        rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    got = tpoint.apply_lut_planes(torch.from_numpy(x), torch.from_numpy(lut)).numpy()
    want = np.asarray(jax_apply_lut_planes(jnp.asarray(x), jnp.asarray(lut)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(37, 41), (2, 23, 41), (23, 41, 3), (2, 23, 41, 3)])
def test_histogram_u8_u16_match_bincount_and_jax(shape):
    rng = np.random.default_rng(31)
    for dtype, S in ((np.uint8, 256), (np.uint16, 65536)):
        x = rng.integers(0, S, shape).astype(dtype)
        got = tie.histogram(torch.from_numpy(x)).numpy()
        want = np.asarray(jie.histogram(x))
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        planes = interop.planes_from_numpy(x).numpy()
        np.testing.assert_array_equal(got.reshape(-1, S),
                                      np.stack([np.bincount(p.ravel(), minlength=S) for p in planes]))
    with pytest.raises(TypeError):
        tie.histogram(torch.zeros((4, 4), dtype=torch.int16))
    with pytest.raises(TypeError):
        thist.histogram_256(torch.zeros((1, 4, 4), dtype=torch.float32))


# -- the tables carried over from the JAX package ---------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_jax_stretch_tables_through_interop(dtype):
    """JAX's stretch_luts_from_minmax output, carried over, applied by the
    port, equals the port's own tables and the port's contrast_stretch."""
    minv, maxv = (-32768, 32767) if dtype == np.int16 else (0, np.iinfo(dtype).max)
    rng = np.random.default_rng(32)
    x = rng.integers(minv, maxv, (3, 19, 23), endpoint=True).astype(dtype)
    x[2] = x[2, 0, 0]  # a constant plane
    lo, hi = x.reshape(3, -1).min(1).astype(np.int32), x.reshape(3, -1).max(1).astype(np.int32)
    want = interop.luts_from_jax(jax_stretch_luts(jnp.asarray(lo), jnp.asarray(hi), -7.25, 201.5,
                                                  maxv, jnp.dtype(dtype), minv))
    mine = tpoint.stretch_luts_from_minmax(torch.from_numpy(lo), torch.from_numpy(hi), -7.25,
                                           201.5, maxv, want.dtype, minv)
    if dtype == np.int16:  # R3: JAX's double-float i16 tables can be 1 off cv2
        assert int((mine.to(torch.int32) - want.to(torch.int32)).abs().max()) <= 1
        return
    assert torch.equal(mine, want)
    t = torch.from_numpy(x)
    applied = tpoint.apply_lut_planes(t, want) if dtype == np.uint8 else tpoint._gather_planes(t, want)
    np.testing.assert_array_equal(applied.numpy(),
                                  tpoint.contrast_stretch_planes(t, (-7.25, 201.5)).numpy())


def test_luts_from_jax_shapes_and_rejects():
    for a in (np.zeros(256, np.uint8), np.zeros((3, 256), np.float32),
              np.zeros((2, 9, 256), np.int32), np.zeros(65536, np.uint16),
              np.zeros((2, 65536), np.int16)):
        t = interop.luts_from_jax(jnp.asarray(a))
        assert t.shape == a.shape and t.numpy().dtype == a.dtype
        t.view(-1)[0] = 1  # writable, not a view of JAX's buffer
    for a in (np.zeros(255, np.uint8), np.zeros((2, 3, 65536), np.uint16),
              np.zeros(256, np.float64), np.zeros((1, 1, 1, 256), np.uint8)):
        with pytest.raises(ValueError):
            interop.luts_from_jax(a)
