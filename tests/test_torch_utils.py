"""The port's utilities held to the JAX package: tap tables, shapes, FMA,
interop, and the port's import isolation."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu.utils import fma as jfma
from imageenhancement_mp_tpu.utils import shapes as jshapes
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.utils import fma as tfma
from imageenhancement_mp_tpu_torch.utils import shapes as tshapes
from imageenhancement_mp_tpu_torch.utils import taps

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 31])
def test_taps_match_ref(k):
    for sigma in (0.0, -1.0, 0.6, 1.5, 2.3, 5.0, 8.0):
        np.testing.assert_array_equal(
            taps.gaussian_kernel_fixed(k, sigma), ref_ops.gaussian_kernel_fixed(k, sigma))
        if sigma > 0:
            np.testing.assert_array_equal(
                taps._cdf_fixed_taps(k, sigma, 256), ref_ops._cdf_fixed_taps(k, sigma, 256))
    assert taps._auto_sigma(k) == ref_ops._auto_sigma(k)


def test_tap_tables_and_axes_match_ref():
    assert taps._BINOMIAL_FX.keys() == ref_ops._BINOMIAL_FX.keys()
    for k, v in taps._BINOMIAL_FX.items():
        np.testing.assert_array_equal(v, ref_ops._BINOMIAL_FX[k])
    for args in [(5, 0.0, 0.0, True), ((3, 5), 0.0, 0.0, True), (0, 1.5, 0.0, True),
                 ((0, 7), 1.2, 2.0, True), (0, 1.5, 0.0, False), ((0, 0), 0.7, 0.0, True)]:
        assert taps.gaussian_axes(*args) == ref_ops.gaussian_axes(*args)
    for bad in [(4, 0.0, 0.0, True), (0, 0.0, 0.0, True)]:
        with pytest.raises(ValueError):
            taps.gaussian_axes(*bad)
    with pytest.raises(ValueError):
        taps.gaussian_kernel_fixed(4)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 11, 31, 41])
def test_u16_taps_match_ref(k):
    for sigma in (0.0, -1.0, 0.6, 1.5, 2.3, 5.0, 8.0):
        np.testing.assert_array_equal(taps.gaussian_taps_u16(k, sigma),
                                      ref_ops.gaussian_taps_u16(k, sigma))
    with pytest.raises(ValueError):
        taps.gaussian_taps_u16(k + 1)


def test_deriv_kernels_match_ref():
    for ksize in (-1, 1, 3, 5, 7, 9, 15, 27, 29, 4, 0):
        for dx in range(4):
            for dy in range(4):
                try:
                    want = ref_ops.deriv_kernels(dx, dy, ksize)
                except ValueError:
                    with pytest.raises(ValueError):
                        taps.deriv_kernels(dx, dy, ksize)
                    continue
                got = taps.deriv_kernels(dx, dy, ksize)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def test_stack_blur_tables_match_ref():
    from imageenhancement_mp_tpu.ref import stackblur as ref_stackblur
    assert taps.STACK_MUL == ref_stackblur._MUL and len(taps.STACK_MUL) == 64
    assert taps.STACK_SHR == ref_stackblur._SHR and len(taps.STACK_SHR) == 64


@pytest.mark.parametrize("shape,channels_last", [
    ((5, 7), True), ((5, 7, 3), True), ((2, 5, 7), True), ((2, 5, 7, 3), True),
    ((2, 5, 3), True), ((2, 5, 3), False), ((2, 5, 7, 1), True),
])
def test_as_planes_matches_jax(shape, channels_last):
    x = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    jp, jrestore = jshapes.as_planes(jnp.asarray(x), channels_last)
    tp, trestore = tshapes.as_planes(torch.from_numpy(x), channels_last)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(trestore(tp).numpy(), x)
    assert tshapes.treat_as_hwc(torch.from_numpy(x), channels_last) == \
        jshapes.treat_as_hwc(x, channels_last)


def test_as_planes_rejects_other_ranks():
    with pytest.raises(ValueError):
        tshapes.as_planes(torch.zeros(3, dtype=torch.uint8))


def test_fma32_matches_jax_and_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, 4096).astype(np.float32)
    scale = np.float32(1.0 + rng.uniform(-3, 3))
    shift = (rng.integers(0, 256, 4096) * np.float32(-rng.uniform(0, 3))).astype(np.float32)
    got = tfma.fma32(torch.from_numpy(x), torch.tensor(scale), torch.from_numpy(shift)).numpy()
    want_jax = np.asarray(jfma.fma32(jnp.asarray(x), jnp.float32(scale), jnp.asarray(shift)))
    # f32 products of f32 values are exact in f64: one f64 add, one f32 rounding
    exact = (x.astype(np.float64) * np.float64(scale) + shift.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, exact)


def test_import_pulls_no_jax():
    code = ("import sys, imageenhancement_mp_tpu_torch, imageenhancement_mp_tpu_torch.interop, "
            "imageenhancement_mp_tpu_torch.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'imageenhancement_mp_tpu' or m.startswith('imageenhancement_mp_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_luts_from_lut2_layout():
    rng = np.random.default_rng(3)
    luts = rng.integers(0, 256, (3, 256)).astype(np.int32)
    lut2 = luts.reshape(3, 2, 128)  # the JAX flagship's layout (pipeline.py:210)
    got = interop.luts_from_lut2(lut2)
    assert got.dtype == torch.uint8 and got.shape == (3, 256)
    np.testing.assert_array_equal(got.numpy(), luts)
    with pytest.raises(ValueError):
        interop.luts_from_lut2(np.zeros((3, 256), np.int32))
    with pytest.raises(ValueError):
        interop.luts_from_lut2(np.full((1, 2, 128), 256, np.int32))


@pytest.mark.parametrize("shape", [(9, 11), (2, 9, 11), (2, 9, 11, 3), (9, 11, 3)])
def test_planes_from_numpy_matches_jax(shape):
    x = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    got = interop.planes_from_numpy(x)
    assert got.is_contiguous() and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jshapes.as_planes(jnp.asarray(x))[0]))
