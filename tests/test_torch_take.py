"""The port's per-element table lookup (kernels/take.py): ``take_table_plain``
against NumPy and against the JAX package's K12 ``take_table_pallas`` in
interpret mode, the K15 dynamic-gather probe's inputs, int64 tables,
clamped indices, the checks, and the CUDA branch with the launch stubbed
(the kernel itself runs only on the card, through chip_smoke.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.kernels.hist import take_table_pallas
from imageenhancement_mp_tpu_torch.kernels import take as kt

I32, I64 = torch.int32, torch.int64


def _case(shape, L, per_plane, dtype, seed, lo=0, hi=None):
    """Random indices in ``[lo, hi)`` (default ``[0, L)``) and a random table."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, L if hi is None else hi, shape).astype(np.int32)
    info = np.iinfo(dtype)
    tshape = (shape[0], L) if per_plane else (L,)
    tab = rng.integers(info.min, info.max, tshape, dtype=dtype)
    return idx, tab


def _numpy_take(idx, tab):
    L = tab.shape[-1]
    i = np.clip(idx, 0, L - 1).reshape(idx.shape[0], -1)
    if tab.ndim == 1:
        return tab[i].reshape(idx.shape)
    return np.take_along_axis(tab, i, axis=1).reshape(idx.shape)


def test_k15_probe_inputs():
    """The probe's exact case: take_along_axis on one [8, 128] int32 table,
    the per-plane lookup with B = 8 and L = 128."""
    tn = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    ixn = (tn * 7 + 3) % 128
    got = kt.take_table_plain(torch.from_numpy(ixn), torch.from_numpy(tn)).numpy()
    np.testing.assert_array_equal(got, tn[np.arange(8)[:, None], ixn])
    again = kt.take_table(torch.from_numpy(ixn), torch.from_numpy(tn))
    np.testing.assert_array_equal(again.numpy(), got)


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("L", [1, 128, 256, 3072, 4096, 36864, 35937])
def test_plain_matches_numpy(L, dtype, per_plane):
    idx, tab = _case((3, 7, 11), L, per_plane, dtype, L)
    idx.flat[:2] = (0, L - 1)  # both ends of the table
    got = kt.take_table(torch.from_numpy(idx), torch.from_numpy(tab))
    assert got.dtype == torch.from_numpy(tab).dtype and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), _numpy_take(idx, tab))


@pytest.mark.parametrize("per_plane", [False, True])
@pytest.mark.parametrize("L", [128, 1024, 4096])
def test_plain_matches_jax_k12_interpret(L, per_plane):
    """0 LSB against K12 in interpret mode (int32 tables, L a multiple of 128
    as the TPU kernel requires)."""
    idx, tab = _case((2, 9, 130), L, per_plane, np.int32, 7 + L)
    want = np.asarray(take_table_pallas(idx, tab, interpret=True))
    got = kt.take_table_plain(torch.from_numpy(idx), torch.from_numpy(tab)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("per_plane", [False, True])
def test_indices_are_clamped(per_plane):
    """Indices below 0 read entry 0 and indices ≥ L read entry L − 1."""
    idx, tab = _case((2, 50), 300, per_plane, np.int64, 11, lo=-2**31, hi=2**31 - 1)
    idx[:, :4] = (-1, 300, 2**31 - 1, -2**31)
    got = kt.take_table_plain(torch.from_numpy(idx), torch.from_numpy(tab)).numpy()
    np.testing.assert_array_equal(got, _numpy_take(idx, tab))
    first, last = (tab[:, :1], tab[:, -1:]) if per_plane else (tab[0], tab[-1])
    np.testing.assert_array_equal(got[:, [0, 3]], np.broadcast_to(first, (2, 2)))
    np.testing.assert_array_equal(got[:, [1, 2]], np.broadcast_to(last, (2, 2)))


def test_views_and_tiny_planes():
    """1×1 planes, a storage offset of one element and an empty batch."""
    idx, tab = _case((4, 1, 1), 5, True, np.int32, 12)
    got = kt.take_table(torch.from_numpy(idx), torch.from_numpy(tab))
    np.testing.assert_array_equal(got.numpy(), _numpy_take(idx, tab))
    idx, tab = _case((2, 6, 9), 256, False, np.int32, 13)
    buf = torch.zeros(idx.size + 1, dtype=I32)
    view = buf[1:].view(idx.shape)
    view.copy_(torch.from_numpy(idx))
    np.testing.assert_array_equal(kt.take_table(view, torch.from_numpy(tab)).numpy(),
                                  _numpy_take(idx, tab))
    empty = kt.take_table(torch.zeros((0, 3), dtype=I32), torch.arange(4, dtype=I64))
    assert empty.shape == (0, 3) and empty.dtype == I64


def test_rejects_what_the_kernel_does_not_take():
    idx = torch.zeros((2, 3), dtype=I32)
    with pytest.raises(TypeError):
        kt.take_table(idx, torch.zeros(4, dtype=torch.int16))
    with pytest.raises(TypeError):
        kt.take_table(idx, torch.zeros(4, dtype=torch.float32))
    with pytest.raises(TypeError):
        kt.take_table(idx.long(), torch.zeros(4, dtype=I32))
    with pytest.raises(ValueError):
        kt.take_table(idx, torch.zeros((3, 4), dtype=I32))  # per-plane count ≠ B
    with pytest.raises(ValueError):
        kt.take_table(idx, torch.zeros((2, 2, 4), dtype=I32))
    with pytest.raises(ValueError):
        kt.take_table(idx, torch.zeros(0, dtype=I32))
    with pytest.raises(ValueError):
        kt.take_table(torch.zeros((), dtype=I32), torch.zeros(4, dtype=I32))
    with pytest.raises(ValueError):
        kt.take_table(idx, torch.zeros(4, dtype=I32, device="meta"))


CUDA_CASES = {  # name -> (idx shape, table shape, dtype, launch args after the pointers)
    "shared_int32": ((4, 6, 7), (256,), I32, (1, 168, 256, 0, 4)),
    "per_plane_int32": ((4, 6, 7), (4, 128), I32, (4, 42, 128, 1, 4)),
    "shared_int64_long": ((1, 2_200_000, 8), (35937,), I64, (1, 17_600_000, 35937, 0, 8)),
    "per_plane_many": ((70000, 8, 8), (70000, 128), I32, (70000, 64, 128, 1, 4)),
}


@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_dispatch_on_cuda_reaches_the_kernel(monkeypatch, name):
    """A CUDA tensor launches the kernel once, with the planes, the indices
    per plane, the table length, the table mode and the entry size; a shared
    table reads all indices as one flat plane."""
    ishape, tshape, dtype, want = CUDA_CASES[name]
    launches = []
    monkeypatch.setattr(kt, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kt, "launch", lambda *args: launches.append(args))
    idx, tab = torch.zeros(ishape, dtype=I32), torch.zeros(tshape, dtype=dtype)
    out = kt.take_table(idx, tab)
    assert out.shape == ishape and out.dtype == dtype
    assert len(launches) == 1
    kernel, device, ip, tp, op, *args = launches[0]
    assert kernel == "take_table" and device == idx.device
    assert (ip, tp, op) == (idx.data_ptr(), tab.data_ptr(), out.data_ptr())
    assert tuple(args) == want


def test_dispatch_refuses_non_contiguous_cuda_input(monkeypatch):
    monkeypatch.setattr(kt, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kt, "launch", lambda *args: None)
    with pytest.raises(ValueError):
        kt.take_table(torch.zeros((2, 6), dtype=I32)[:, ::2], torch.zeros(4, dtype=I32))


def test_smem_limit_is_the_sources():
    """The Python constant names the limit csrc/take.cu compiles in."""
    text = (Path(kt.__file__).parent / "csrc" / "take.cu").read_text()
    assert f"kSmemTableBytes = {kt.SMEM_TABLE_BYTES // 1024} * 1024" in text
