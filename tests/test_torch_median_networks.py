"""The median schedules of kernels/median_networks.py, which
csrc/median.cu (K6) and csrc/fused.cu (K14) run as the generated
csrc/median_networks.cuh.

The CUDA kernels cannot run here, so the schedules are proved here instead:
the committed header is their rendering byte for byte; each output reads
only its own k x k window; and each output is the median on every 0/1
window (a circuit of min and max that selects the median of every 0/1 input
selects it of every input: the 0-1 principle), checked bit-sliced over all
2^25 (k 5) or 2^9 (k 3) windows.  Random u8, u16 and i16 windows with many
ties are held to torch.sort's middle element as well."""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu_torch.kernels import median_networks as mnet

BY_NAME = {s.name: s for s in mnet.SCHEDULES}
OUTPUTS = [(s.name, rc) for s in mnet.SCHEDULES for rc, _ in s.outputs]
CHUNK = 1 << 14  # 64-bit words per evaluation: 2^20 windows


def _words(t: int, w0: int, n: int) -> np.ndarray:
    """Bit b of word w is window 64 w + b; this is the bit of tap t in each."""
    if t < 6:
        return np.full(n, sum(1 << b for b in range(64) if (b >> t) & 1), dtype=np.uint64)
    w = np.arange(w0, w0 + n, dtype=np.uint64)
    return np.where((w >> np.uint64(t - 6)) & np.uint64(1), np.uint64(2**64 - 1),
                    np.uint64(0))


def _expected(k: int, w0: int, n: int) -> np.ndarray:
    """1 where the window holds more ones than half its taps."""
    need = k * k // 2 + 1
    at_least = [sum(1 << b for b in range(64) if bin(b).count("1") >= c) for c in range(8)]
    ones_w = np.array([bin(w).count("1") for w in range(w0, w0 + n)])
    table = np.array([at_least[min(max(c, 0), 7)] for c in range(need + 1)], dtype=np.uint64)
    return table[np.clip(need - ones_w, 0, need)]


def test_header_is_the_rendering():
    assert mnet.render() == mnet.HEADER.read_text()


@pytest.mark.parametrize("name,rc", OUTPUTS)
def test_cone_lies_in_the_window(name, rc):
    s = BY_NAME[name]
    taps = mnet.cone(s, dict(s.outputs)[rc])
    assert taps <= s.window(*rc)
    assert len(taps) == s.k * s.k  # every tap of the window counts


@pytest.mark.parametrize("name,rc", OUTPUTS)
def test_median_on_every_0_1_window(name, rc):
    s = BY_NAME[name]
    k, (r0, c0) = s.k, rc
    n_words = max(1, (1 << (k * k)) // 64)
    for w0 in range(0, n_words, CHUNK):
        n = min(CHUNK, n_words - w0)
        taps = {(r0 + i, c0 + j): _words(i * k + j, w0, n) for i in range(k) for j in range(k)}
        zero = np.zeros(n, dtype=np.uint64)
        got = mnet.evaluate(s, lambda r, c: taps.get((r, c), zero), np.bitwise_and,
                            np.bitwise_or)[rc]
        want = _expected(k, w0, n)
        bad = np.flatnonzero(got != want)
        assert bad.size == 0, f"{name} {rc}: wrong on windows of word {w0 + bad[0]}"


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_median_of_random_windows_with_ties(name, dtype):
    s = BY_NAME[name]
    fh, fw = s.footprint
    info = np.iinfo(dtype)
    rng = np.random.default_rng(7)
    # few distinct values, the type's extremes among them, so ties abound
    values = np.array([info.min, info.max, 0, 1, info.max - 1, 77], dtype=dtype)
    x = np.where(rng.random((fh, fw, 4000)) < 0.5, values[rng.integers(0, 6, (fh, fw, 4000))],
                 rng.integers(info.min, info.max + 1, (fh, fw, 4000)).astype(dtype))
    got = mnet.evaluate(s, lambda r, c: x[r, c], np.minimum, np.maximum)
    for (r, c), g in got.items():
        win = torch.from_numpy(x[r:r + s.k, c:c + s.k].reshape(s.k * s.k, -1).astype(np.int32))
        want = torch.sort(win, dim=0).values[s.k * s.k // 2].numpy()
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.astype(np.int32), want)


@pytest.mark.parametrize("k,network", [(5, 336), (3, 38)])
def test_tile_schedule_cuts_the_min_max(k, network):
    """The TPU's networks take 336 (forgetful selection, k 5) and 38 (Paeth,
    k 3) min/max per pixel; the tiled schedules share work across outputs."""
    s = BY_NAME[f"median_tile{k}"]
    assert (s.rows, s.cols, s.footprint) == (mnet.TILE, mnet.TILE, (k + 1, k + 1))
    assert s.ops_per_output * 2 <= network
    assert all(kind in ("min", "max", "min3", "max3") for kind, _ in s.ops)
