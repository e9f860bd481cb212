"""The redesigned bilateral kernel's host-side pieces (kernels/bilateral.py)
held to the law they stand for: the disc walk, the colour table the kernel
gathers from, the pixel words, the runtime instance's zero-padded disc, and
the CUDA branch's arguments.  JAX's K10 in interpret mode at radii the
older comparisons do not reach: ±1 (the reason is in
tests/test_torch_bilateral.py's docstring), 0 LSB against ref/.
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import bilateral as jbil
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import bilateral as kbil
from imageenhancement_mp_tpu_torch.ops import bilateral as tbil

CPU = torch.device("cpu")
MAGIC = 0x4B000000  # the bits of f32 2^23: MAGIC | v is the f32 2^23 + v


def magic_words(v: np.ndarray) -> np.ndarray:
    """The kernel's staged pixels: ``MAGIC | v`` as uint32 words."""
    return np.uint32(MAGIC) | np.asarray(v, dtype=np.uint32)


def lane_table(lut: torch.Tensor) -> torch.Tensor:
    """The kernel's shared colour table, flat: 511 entries, entry ``e`` of
    lane ``l`` at ``e·32 + l`` holding ``lut[|e − 255|]``."""
    return lut[(torch.arange(511) - 255).abs()].repeat_interleave(32)


def lane_index(vword: np.ndarray, cword: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """The float index into :func:`lane_table` that the kernel's gather forms
    from a pixel's word, the centre's word and the lane, in its uint32
    arithmetic: byte ``v·128 + ((255 − c)·128 + 4·lane)`` mod 2³² (the
    words' 2²³·128 cancel), over 4 (csrc/bilateral.cu lut_at, vkey_of,
    ckey_of)."""
    v, c = np.asarray(vword, np.uint32), np.asarray(cword, np.uint32)
    lane4 = np.asarray(lane, np.uint32) * np.uint32(4)
    with np.errstate(over="ignore"):
        byte = (v << np.uint32(7)) + (((np.uint32(255) - c) << np.uint32(7)) + lane4)
    return byte // 4


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("radius", range(1, kbil.MAX_RADIUS + 1))
def test_disc_rows_are_bilateral_offsets(radius):
    """Rows (i, −J_i … J_i) in order are bilateral_offsets' (i, j) list, and
    the w0 the kernel receives is the list's, bit for bit."""
    offs, _, r = tbil.bilateral_offsets(2 * radius + 1, 30.0, 30.0)
    assert r == radius
    walk = [(i, j) for i, J in kbil.disc_rows(radius) for j in range(-J, J + 1)]
    assert walk == [(i, j) for i, j, _ in offs]
    offsets, _, _ = tbil.bilateral_tables(2 * radius + 1, 30.0, 30.0, 1, CPU)
    w0 = kbil.disc_weights(offsets, radius)
    assert w0.dtype == np.float32
    np.testing.assert_array_equal(w0, np.array([w for _, _, w in offs], np.float32))


def test_disc_weights_rejects_other_lists_and_follows_writes():
    """The kernel takes the whole disc in order only; the host copy is made
    again after an in-place write."""
    offsets, _, r = tbil.bilateral_tables(9, 75.0, 75.0, 1, CPU)
    for bad in (offsets[:-1], offsets.flip(0), offsets[:, [1, 0, 2]]):
        with pytest.raises(ValueError):
            kbil.disc_weights(bad.contiguous(), r)
    with pytest.raises(ValueError):
        kbil.disc_weights(offsets, r + 1)
    mine = offsets.clone()
    assert kbil.disc_weights(mine, r)[0] == offsets[0, 2]
    mine[0, 2] = 0.5
    assert kbil.disc_weights(mine, r)[0] == np.float32(0.5)


@pytest.mark.parametrize("sigma_color", [75.0, 10.0])
def test_lane_table_gather_equals_lut(sigma_color):
    """For every pixel, centre and lane, the kernel's gather address reads
    lut[|v − c|] from the lane-replicated signed table, in the lane's own
    bank; every (entry, lane) of the table is lut[|entry − 255|]."""
    lut = torch.from_numpy(tbil.bilateral_offsets(9, sigma_color, 30.0)[1])
    table = lane_table(lut).numpy()
    assert table.shape == (511 * 32,)
    v, c, lane = np.meshgrid(np.arange(256), np.arange(256), np.arange(32), indexing="ij")
    idx = lane_index(magic_words(v), magic_words(c), lane)
    assert idx.max() < table.shape[0]
    np.testing.assert_array_equal(idx % 32, lane)
    np.testing.assert_array_equal(idx // 32, v - c + 255)
    np.testing.assert_array_equal(table[idx], lut.numpy()[np.abs(v - c)])
    entry, ln = np.divmod(np.arange(table.shape[0]), 32)
    np.testing.assert_array_equal(table, lut.numpy()[np.abs(entry - 255)])
    assert ln.max() == 31


def test_magic_words_convert_exactly():
    """0x4B000000 | v as f32, minus 2²³, is v for all 256 values, and the
    difference of two words is v − c."""
    v = np.arange(256)
    w = magic_words(v)
    np.testing.assert_array_equal(w.view(np.float32) - np.float32(2.0 ** 23), v.astype(np.float32))
    d = w[:, None].astype(np.int64) - w[None, :].astype(np.int64)
    np.testing.assert_array_equal(d, v[:, None] - v[None, :])


def _padded_walk(x: np.ndarray, offsets: np.ndarray, lut: np.ndarray, r: int) -> np.ndarray:
    """The runtime instance's walk in NumPy f32: each disc row in 4-wide j
    blocks from −align4(J_i), padded with weight 0, every op rounded once."""
    B, H, W = x.shape
    rows = kbil.reflect101(torch.arange(-r, H + r), H).numpy()
    cols = kbil.reflect101(torch.arange(-r - 8, W + r + 8), W).numpy()
    p = x[:, rows][:, :, cols].astype(np.float32)
    c = p[:, r:r + H, r + 8:r + 8 + W]
    num = np.zeros((B, H, W), np.float32)
    den = np.zeros((B, H, W), np.float32)
    k = 0
    for i, J in kbil.disc_rows(r):
        a = (J + 3) & ~3
        for j in range(-a, -a + 4 * ((J + a + 4) // 4)):
            w0 = offsets[k + j + J, 2] if -J <= j <= J else np.float32(0.0)
            v = p[:, r + i:r + i + H, r + 8 + j:r + 8 + j + W]
            w = np.float32(w0) * lut[np.abs(v - c).astype(np.int64)]
            num = num + v * w
            den = den + w
        k += 2 * J + 1
    return np.clip(np.round(num / den), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("d,sc,ss", [(3, 10.0, 200.0), (9, 75.0, 75.0), (13, 30.0, 30.0),
                                     (0, 30.0, 5.0)])
def test_zero_padded_disc_walk_is_exact(d, sc, ss):
    """Visits of weight +0 leave num and den as they are: the runtime
    instance's padded walk equals the plain version bit for bit."""
    x = _img((2, 21, 37), 70)
    offsets, lut, r = tbil.bilateral_tables(d, sc, ss, 1, CPU)
    got = _padded_walk(x, offsets.numpy(), lut.numpy(), r)
    np.testing.assert_array_equal(got, kbil.bilateral_gray_plain(torch.from_numpy(x), offsets,
                                                                 lut, r).numpy())


def test_cuda_branch_passes_disc_weights_and_routes(monkeypatch):
    """With the launch stubbed: the C entry gets the host w0 of the disc and
    the instance flag."""
    launches = []
    monkeypatch.setattr(kbil, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kbil, "launch", lambda *args: launches.append(args))
    x = torch.zeros((1, 40, 70), dtype=torch.uint8)
    offsets, lut, r = tbil.bilateral_tables(9, 75.0, 75.0, 1, CPU)
    kbil.bilateral_gray(x, offsets, lut, r)
    kbil.bilateral_gray(x, offsets, lut, r, _runtime=True)
    (name, _, *a), (_, _, *b) = launches
    assert name == "bilateral" and a[6] == offsets.shape[0] and a[8] == r
    w0 = kbil.disc_weights(offsets, r)
    assert a[9] == w0.ctypes.data and a[10] == 0 and b[10] == 1
    with pytest.raises(ValueError):
        kbil.bilateral_gray(x, offsets[:-1].contiguous(), lut, r)


@pytest.mark.parametrize("d,sc,ss", [(3, 30.0, 30.0), (7, 50.0, 20.0), (11, 75.0, 75.0)])
def test_gray_vs_jax_k10_interpret_more_radii(d, sc, ss):
    """Radii 1, 3 and 5 through JAX's K10 in interpret mode: ±1, and 0 LSB
    against ref/."""
    x = _img((2, 64, 256), 71)
    config.use_pallas_kernels = True
    try:
        jax_out = np.asarray(jbil.bilateral_planes(x, d, sc, ss))
    finally:
        config.use_pallas_kernels = None
    offs, cw, r = jbil.bilateral_offsets(d, sc, ss)
    got = kbil.bilateral_gray(torch.from_numpy(x), *interop.bilateral_tables_from_jax(offs, cw),
                              r).numpy()
    assert int(np.abs(got.astype(np.int64) - jax_out).max()) <= 1
    np.testing.assert_array_equal(got, np.stack([ref.bilateral_filter(p, d, sc, ss) for p in x]))
