"""K14: the fused median → Gaussian → unsharp (kernels/fused.py) — its plain
version held to the JAX package's ``median_unsharp_pallas`` in interpret
mode and to the ref/ chain at 0 LSB, planes smaller than the halos
included, ksize past 31 too; and its CUDA branch, driven on a CPU tensor
with ``on_cuda`` and ``launch`` stubbed: the fused kernel up to 31 taps, the
median → sep_conv_u8 chain past them."""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.kernels.fused import median_unsharp_pallas
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.kernels import fused as kfused
from imageenhancement_mp_tpu_torch.kernels import median as kmedian
from imageenhancement_mp_tpu_torch.ops.filters import unsharp_mask_planes
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes


def _planes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _ref_chain(x, km, amount, ksize):
    return np.stack([ref.unsharp_mask(ref.median_blur(p, km), amount, ksize, 0.0) for p in x])


@pytest.mark.parametrize("amount", [1.0, 1.5, -0.5, 2.0])
@pytest.mark.parametrize("km", [3, 5])
def test_median_unsharp_matches_pallas(km, amount):
    x = _planes((2, 64, 131), 41)
    got = kfused.median_unsharp(torch.from_numpy(x), km, amount, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(median_unsharp_pallas(x, km, amount, 5,
                                                                        interpret=True)))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 3), (1, 4, 131), (2, 37, 131)])
@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("km", [3, 5])
def test_median_unsharp_matches_ref_chain(km, ksize, shape):
    """Planes smaller than either halo run the one route too."""
    x = _planes(shape, 42 + ksize)
    for amount in (1.0, 0.7, 64.0):
        got = kfused.median_unsharp(torch.from_numpy(x), km, amount, ksize).numpy()
        np.testing.assert_array_equal(got, _ref_chain(x, km, amount, ksize),
                                      err_msg=f"amount {amount}")
        # and the port's two-op chain on the same input
        two = unsharp_mask_planes(median_blur_planes(torch.from_numpy(x), km), amount, ksize)
        np.testing.assert_array_equal(got, two.numpy())


def test_median_unsharp_ksize_31_matches_ref_chain():
    x = _planes((1, 40, 70), 43)
    np.testing.assert_array_equal(kfused.median_unsharp(torch.from_numpy(x), 5, 1.5, 31).numpy(),
                                  _ref_chain(x, 5, 1.5, 31))


@pytest.mark.parametrize("ksize", [33, 37])
@pytest.mark.parametrize("km", [3, 5])
def test_median_unsharp_past_31_taps_matches_pallas(km, ksize):
    """A plane tall and wide enough for the JAX kernel's halos, so JAX takes
    its Pallas path: H, W >= 2 (ksize//2 + km//2) + 2."""
    x = _planes((1, 48, 80), 44)
    amount = 1.0 if km == 5 else -0.5  # the interpret run takes 15-30 s a call
    got = kfused.median_unsharp(torch.from_numpy(x), km, amount, ksize).numpy()
    np.testing.assert_array_equal(got, np.asarray(median_unsharp_pallas(
        x, km, amount, ksize, interpret=True)))
    np.testing.assert_array_equal(got, _ref_chain(x, km, amount, ksize))


def test_median_unsharp_rejects_what_it_does_not_take():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kfused.median_unsharp(x.to(torch.uint16))
    with pytest.raises(ValueError):
        kfused.median_unsharp(x[0])
    with pytest.raises(ValueError):
        kfused.median_unsharp(x, 7)
    for ksize in (4, -1):
        with pytest.raises(ValueError):
            kfused.median_unsharp(x, 5, 1.0, ksize)
    # past 31 taps a result, equal to the ref/ chain
    y = _planes((1, 8, 8), 45)
    np.testing.assert_array_equal(kfused.median_unsharp(torch.from_numpy(y), 5, 1.0, 33).numpy(),
                                  _ref_chain(y, 5, 1.0, 33))
    with pytest.raises(ValueError):
        kfused.median_unsharp(x.to("meta"))


TALL = (1, 1_100_000, 8)


@pytest.mark.parametrize("km,amount,ksize", [(5, 1.0, 5), (3, -0.5, 31), (5, 64.0, 3)])
def test_median_unsharp_cuda_branch(monkeypatch, km, amount, ksize):
    """One launch with the full height, cv2's taps and the f32 weights."""
    calls = []
    monkeypatch.setattr(kfused, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kfused, "launch", lambda *args: calls.append(args))
    x = torch.zeros(TALL, dtype=torch.uint8)
    out = kfused.median_unsharp(x, km, amount, ksize)
    assert out.shape == TALL and out.dtype == torch.uint8
    assert len(calls) == 1
    name, device, xp, op, B, H, W, k, taps_ptr, kg, alpha, beta = calls[0]
    assert (name, device, xp, op) == ("median_unsharp", x.device, x.data_ptr(), out.data_ptr())
    assert (B, H, W, k, kg) == (*TALL, km, ksize)
    assert isinstance(taps_ptr, int) and (alpha, beta) == (np.float32(1 + amount),
                                                           np.float32(-amount))
    assert kfused.fused_taps(ksize) == tuple(int(t) for t in ref.gaussian_kernel_fixed(ksize))
    calls.clear()
    assert kfused.median_unsharp(torch.zeros((2, 0, 9), dtype=torch.uint8)).shape == (2, 0, 9)
    assert calls == []


@pytest.mark.parametrize("km,ksize", [(5, 33), (3, 101)])
def test_median_unsharp_past_31_taps_launches_the_chain(monkeypatch, km, ksize):
    """Past FUSED_MAX_TAPS: one median launch, then one sep_conv_u8 launch
    (cv2's taps on both axes, trimmed of their zero ends, on the instance
    they then take: the runtime one at ksize 33, the wide one at 101; the
    unsharp epilogue), and no median_unsharp launch."""
    calls = []
    for mod in (kfused, kmedian, kconv):
        monkeypatch.setattr(mod, "on_cuda", lambda t, what: True)
        monkeypatch.setattr(mod, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(kconv, "stream_handle", lambda device: 0)
    x = torch.zeros((2, 40, 50), dtype=torch.uint8)
    out = kfused.median_unsharp(x, km, 1.5, ksize)
    assert out.shape == x.shape and out.dtype == torch.uint8
    assert [c[0] for c in calls] == ["median", "sep_conv_u8"]
    (_, med), (_, conv) = calls
    assert med[-1] == km
    taps = kfused.fused_taps(ksize)
    route = kconv.conv_route(taps, taps)
    assert (conv[7], conv[9]) == (len(route.taps_v), len(route.taps_h))
    assert conv[12] == route.instance == (0 if ksize == 33 else kconv.WIDE)
    assert taps == tuple(int(t) for t in ref.gaussian_kernel_fixed(ksize))
    calls.clear()
    kfused.median_unsharp(x, km, 1.5, kfused.FUSED_MAX_TAPS)
    assert [c[0] for c in calls] == ["median_unsharp"]
