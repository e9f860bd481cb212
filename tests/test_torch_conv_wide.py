"""The arithmetic of ``sep_conv_u8``'s wide instance (``csrc/conv.cu``,
``sep_conv_u8_wide_kernel``), modelled in NumPy as the kernel does it, and
the host's trimming of zero taps (``kernels/conv.py::trim_taps``,
``conv_route``).

The model takes the route's trimmed taps and the kernel's tile
(``wide_tile`` below mirrors ``conv.cu::wide_tile``), walks the column blocks
and tap segments, builds each block's union of columns from ``ubase`` and
``o`` as the kernel does, runs the vertical pass in rounds of 512 union
columns on two packed 16-bit lanes per uint32 with wrapping multiply-adds
(one product a nonzero tap, the input rows in order as the kernel streams
them), turns each lane into f32 through the bits 0x4B00LLLL, runs the
horizontal pass as f32 FMAs in the kernel's order, and rounds as
``floor((acc + 2^15) · 2^-16)``.  It must equal the port's plain version,
``ref/`` and the JAX package at 0 LSB; no lane may carry and no sum may
reach 2^24.  The CUDA kernel itself runs only on the card: ``chip_smoke.py``
holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import filters as jf
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

M32 = np.uint64(0xFFFFFFFF)
ROUND = 512      # conv.cu: kWideRound, union columns per vertical round
MAX_ROUNDS = 2   # conv.cu: kWideMaxRounds
MAX_SMEM = 168296  # conv.cu: kWideMaxSmem, the shared memory the instance opts in to once


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    m = 2 * (n - 1)
    i = np.mod(i, m)
    return np.where(i >= n, m - i, i)


def wide_tile(kh: int, W: int) -> tuple[int, int, int]:
    """conv.cu::wide_tile: (tw, kseg, vstride) for kh horizontal taps."""
    khp = -(-kh // 8) * 8
    cap = -(-W // 64) * 64
    for rounds in range(1, MAX_ROUNDS + 1):
        n = ROUND * rounds - 15 - khp
        tw = n // 64 * 64 if n >= 0 else -64   # C's division truncates: any negative is < 64
        if tw >= 3 * khp or tw >= cap:
            break
    if tw >= 64:
        tw, kseg = min(tw, cap), khp
    else:
        tw, kseg = 64, (ROUND * MAX_ROUNDS - 15 - 64) // 8 * 8
    return tw, kseg, -(-(15 + tw + kseg) // ROUND) * ROUND + 1


def _vertical(p: np.ndarray, tv: tuple, H: int) -> np.ndarray:
    """Vertical sums of the reflected input rows ``p`` ([B, H + kv - 1, U]
    u8) on packed lanes, as wide_vround computes them: input row j + r is
    multiplied by tap j for output row r, zero taps skipped; f32 [B, H, U]."""
    pairs = p[..., 0::2].astype(np.uint64) | (p[..., 1::2].astype(np.uint64) << np.uint64(16))
    lo, hi = p[..., 0::2].astype(np.int64), p[..., 1::2].astype(np.int64)
    acc = np.zeros(pairs[:, :H].shape, np.uint64)
    lane_lo = lane_hi = 0
    for j, t in enumerate(tv):
        if t:
            acc = (acc + np.uint64(t) * pairs[:, j:j + H]) & M32
            lane_lo = lane_lo + t * lo[:, j:j + H]
            lane_hi = lane_hi + t * hi[:, j:j + H]
    assert np.max(lane_lo) <= 65280 and np.max(lane_hi) <= 65280, "a vertical lane carried"
    assert np.array_equal(acc, np.asarray(lane_lo, np.uint64) | (np.asarray(lane_hi, np.uint64) << np.uint64(16)))
    # 0x4B00LLLL as f32 is 2^23 + LLLL
    f = [((acc >> np.uint64(s)) & np.uint64(0xFFFF) | np.uint64(0x4B000000)).astype(np.uint32).view(np.float32)
         - np.float32(8388608.0) for s in (0, 16)]
    return np.stack(f, -1).reshape(*acc.shape[:-1], -1)


def _f32_law(s: np.ndarray, b: np.ndarray, amount: float) -> np.ndarray:
    """cv2's t = f32(b·beta), r = RN32(s·alpha + t), sat(rint(r)): s·alpha
    and its sum with t are exact in f64 here, so one f32 rounding."""
    alpha, beta = (np.float32(w) for w in kconv.unsharp_weights(amount))
    t = (b.astype(np.float32) * beta).astype(np.float32)
    r = (s.astype(np.float64) * np.float64(alpha) + t.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(r), 0, 255).astype(np.int64)


def wide_model(x: np.ndarray, taps_v, taps_h, amount=None, luts=None, stats=None) -> np.ndarray:
    """``sep_conv_u8`` on [B, H, W] u8 through the wide instance, written as
    the kernel computes it."""
    route = kconv.conv_route(taps_v, taps_h)
    assert route.instance == kconv.WIDE and not route.packed and route.shift == 16
    tv, th = route.taps_v, route.taps_h
    src = x if luts is None else np.take_along_axis(luts, x.reshape(x.shape[0], -1), 1).reshape(x.shape)
    B, H, W = src.shape
    kv, kh = len(tv), len(th)
    rv, rh = kv // 2, kh // 2
    buf = kconv.wide_tap_buffer(tv, th)
    assert tuple(buf[:kv]) == tv
    thf = buf[kv:].view(np.float32)
    tw, kseg, vstride = wide_tile(kh, W)
    assert tw % 64 == 0 and kseg % 8 == 0 and vstride % 2 == 1
    smem = 32 * vstride * 4 + (kseg + 8) * 4 + 2 * 32 * ROUND + 256
    assert smem <= (113 * 1024 if vstride == ROUND + 1 else 227 * 1024)  # 2 blocks a SM, else 1
    khp = -(-kh // 8) * 8
    assert len(thf) == khp + 8 and not thf[kh:].any()
    rows = _reflect(np.arange(-rv, H + rv), H)
    blur = np.empty((B, H, W), np.int64)
    for x0 in range(0, W, tw):
        ngroups = -(-min(tw, W - x0) // 8)
        acc = np.zeros((B, H, 8 * ngroups), np.float32)
        for j0 in range(0, khp, kseg):
            lenp = min(kseg, khp - j0)
            assert j0 + lenp + 8 <= len(thf)                  # the segment's staged taps
            org = x0 + j0 - rh
            ubase = org - org % 16
            o = org - ubase
            uneed = (o + 8 * ngroups + lenp + 15) // 16 * 16
            assert uneed <= vstride - 1                       # inside a row of the shared tile
            assert o + 8 * (ngroups - 1) + lenp - 1 + 8 < uneed   # the windows' last read
            V = np.concatenate([                              # one round of 512 columns each
                _vertical(src[:, rows][:, :, _reflect(ubase + np.arange(c0, min(c0 + ROUND, uneed)), W)],
                          tv, H) for c0 in range(0, uneed, ROUND)], -1)
            for jj in range(lenp):                            # the window, tap by tap
                t = thf[j0 + jj]
                if t != 0:
                    acc = (acc + t * V[..., o + jj:o + jj + 8 * ngroups]).astype(np.float32)
                    if stats is not None:
                        stats["max_sum"] = max(stats.get("max_sum", 0), float(acc.max()))
        assert np.array_equal(acc, np.floor(acc)) and acc.max() < 2 ** 24
        b = np.floor((acc + np.float32(32768)) * np.float32(1 / 65536)).astype(np.int64)
        blur[..., x0:x0 + 8 * ngroups] = b[..., :min(8 * ngroups, W - x0)]
    assert blur.max() <= 255
    mode, a = kconv.epilogue_mode(amount)
    s = src.astype(np.int64)
    if mode == 0:
        out = blur
    elif mode == 1:
        lanes = (1 + a) * s + 256 * a - a * blur
        assert lanes.min() >= a and lanes.max() <= 255 + 511 * a
        out = np.clip(lanes, 256 * a, 256 * a + 255) & 0xFF
    else:
        out = _f32_law(s, blur, amount)
    return out.astype(np.uint8)


def _planes(shape, seed, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "255":
        return np.full(shape, 255, np.uint8)
    if kind == "0/255":
        return (rng.integers(0, 2, shape) * 255).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _plain(x, tv, th, amount=None, luts=None):
    return kconv.sep_conv_u8_plain(torch.from_numpy(x), tv, th, amount,
                                   None if luts is None else torch.from_numpy(luts)).numpy()


SIGMAS = [6.0, 10.0, 12.0, 20.0]
AMOUNTS = [None, 1.0, 0.5, -1.0, 100.0]


@pytest.mark.parametrize("sigma", SIGMAS)
def test_model_matches_plain_ref_and_jax(sigma):
    x = _planes((2, 40, 300), 41)
    tv, th = q8_taps(0, sigma)
    assert kconv.conv_route(tv, th).instance == kconv.WIDE
    blur = wide_model(x, tv, th)
    np.testing.assert_array_equal(blur, _plain(x, tv, th))
    np.testing.assert_array_equal(blur, np.stack([ref.gaussian_blur(p, 0, sigma) for p in x]))
    np.testing.assert_array_equal(blur, np.asarray(jf.gaussian_blur_planes(jnp.asarray(x), 0, sigma)))
    sharp = wide_model(x, tv, th, 1.5)
    np.testing.assert_array_equal(sharp, np.stack([ref.unsharp_mask(p, 1.5, 0, sigma) for p in x]))
    np.testing.assert_array_equal(
        sharp, np.asarray(jf.unsharp_mask_planes(jnp.asarray(x), 1.5, 0, sigma)))


@pytest.mark.parametrize("use_lut", [False, True])
@pytest.mark.parametrize("sigma", [6.0, 20.0, 90.0])
def test_model_matches_plain_every_epilogue(sigma, use_lut):
    x = _planes((1, 37, 131), 42)
    luts = _planes((1, 256), 43) if use_lut else None
    tv, th = q8_taps(0, sigma)
    for amount in AMOUNTS:
        np.testing.assert_array_equal(wide_model(x, tv, th, amount, luts),
                                      _plain(x, tv, th, amount, luts), err_msg=str(amount))


# planes smaller than the halo (which reflects again), one pixel, thin and
# ragged ones, and widths on both sides of a block's 64-column multiples
SMALL = [(1, 1, 1), (1, 5, 9), (2, 3, 1), (1, 2, 2), (1, 1, 640), (1, 33, 513), (2, 7, 65)]


@pytest.mark.parametrize("shape", SMALL, ids=[str(s) for s in SMALL])
def test_model_on_planes_smaller_than_the_halo(shape):
    x = _planes(shape, 44)
    for ks, sigma in ((0, 6.0), (0, 12.0), (0, 45.0)):
        tv, th = q8_taps(ks, sigma)
        for amount in (None, 1.0, 0.5):
            np.testing.assert_array_equal(wide_model(x, tv, th, amount), _plain(x, tv, th, amount),
                                          err_msg=f"{sigma} {amount}")


@pytest.mark.parametrize("taps", [
    ((64, 128, 64), q8_taps(0, 6.0)[1]), (q8_taps(0, 6.0)[0], (64, 128, 64)),
    ((256,), q8_taps(0, 20.0)[1]),
    # asymmetric past 31 taps
    ((1,) * 20 + (2,) * 13, (2,) * 13 + (1,) * 20), ((0,) * 3 + (7,) * 31 + (0,) * 5, (256,)),
], ids=["3x37", "37x3", "1x111", "asym33", "asym39"])
def test_model_on_rectangular_and_asymmetric_taps(taps):
    tv, th = taps
    x = _planes((2, 19, 77), 45)
    assert kconv.conv_route(tv, th).instance == kconv.WIDE
    for amount in (None, 1.0, 0.5):
        np.testing.assert_array_equal(wide_model(x, tv, th, amount), _plain(x, tv, th, amount),
                                      err_msg=str(amount))


def test_segments_keep_their_sums():
    """Taps wider than the shared tile (kh past 937) run in segments on a
    64-column tile with the sums kept across them."""
    th = (1,) + (0,) * 500 + (2,) * 5 + (0,) * 500 + (1,)
    tv = (3,) * 35
    assert wide_tile(len(th), 300)[:2] == (64, 944)
    x = _planes((1, 9, 300), 46)
    np.testing.assert_array_equal(wide_model(x, tv, th, 1.0), _plain(x, tv, th, 1.0))


@pytest.mark.parametrize("kind", ["255", "0/255"])
def test_no_lane_carries_at_the_extremes(kind):
    x = _planes((1, 40, 90), 47, kind)
    for sigma in (6.0, 45.0, 90.0):
        tv, th = q8_taps(0, sigma)
        stats = {}
        np.testing.assert_array_equal(wide_model(x, tv, th, stats=stats), _plain(x, tv, th))
        assert stats["max_sum"] < 2 ** 24


def test_every_gaussian_tap_set_stays_inside_its_lanes():
    """Every q8_taps(0, σ) set from 33 to 541 taps: no vertical lane can pass
    255·Σtv ≤ 65,280, and no horizontal sum, partial or whole, reaches 2^24
    (taps ≥ 0, so each partial sum is at most the whole one)."""
    counts = set()
    for sigma in np.arange(5.0, 90.05, 0.05):
        tv, th = q8_taps(0, float(sigma))
        if not 33 <= len(tv) <= 541:
            continue
        counts.add(len(tv))
        r = kconv.conv_route(tv, th)
        assert r.taps_v == r.taps_v[::-1] and min(r.taps_v) >= 0
        assert r.taps_v[0] and r.taps_v[-1]                     # both ends trimmed
        assert 255 * sum(r.taps_v) <= 65280
        assert 65280 * sum(r.taps_h) < 2 ** 24
        assert r.instance == (kconv.WIDE if len(r.taps_v) > kconv.RUNTIME_MAX_TAPS else 0)
    assert min(counts) == 33 and max(counts) == 541


TRIMS = [((33, 0.0), 31, "runtime/int32"), ((0, 5.1), 29, "runtime/int32"),
         (((33, 5), 0.0), 31, "runtime/int32"), (((1, 35), 0.0), 1, "runtime/packed"),
         ((35, 2.0), 13, "runtime/int32"), ((0, 6.0), 33, "wide/int32"),
         ((0, 12.0), 67, "wide/int32"), ((0, 20.0), 111, "wide/int32"),
         ((0, 90.0), 491, "wide/int32")]


@pytest.mark.parametrize("args,n,route", TRIMS, ids=[str(t[0]) for t in TRIMS])
def test_trimming_keeps_the_result(args, n, route):
    tv, th = q8_taps(*args)
    r = kconv.conv_route(tv, th)
    assert (len(r.taps_v), r.describe()) == (n, route)
    for full, cut in ((tv, r.taps_v), (th, r.taps_h)):
        z = (len(full) - len(cut)) // 2 if len(full) > kconv.RUNTIME_MAX_TAPS else 0
        assert len(full) - len(cut) == 2 * z and not any(full[:z]) and not any(full[len(full) - z:])
    if not r.packed:
        assert (r.taps_v, r.taps_h) == (kconv.trim_taps(tv), kconv.trim_taps(th))
    x = _planes((1, 23, 45), 48)
    np.testing.assert_array_equal(_plain(x, tv, th, 0.5),
                                  _plain(x, kconv.trim_taps(tv), kconv.trim_taps(th), 0.5))
    np.testing.assert_array_equal(kconv.sep_conv_u8(torch.from_numpy(x), tv, th, 0.5).numpy(),
                                  _plain(x, tv, th, 0.5))


def test_only_tap_sets_past_31_are_trimmed():
    for t in ((0, 64, 128, 64, 0), (0,) * 13 + (256,) + (0,) * 17, (0, 0, 256, 0, 0)):
        assert kconv.trim_taps(t) == t
        assert kconv.conv_route(t, t).taps_v in (t, kconv.reduce_taps(t)[0])
    # ends that differ in their zero runs lose the shorter run from both ends
    t = (0,) * 3 + (1,) * 30 + (0,) * 2
    assert kconv.trim_taps(t) == (0,) + (1,) * 30
    assert kconv.trim_taps((0,) * 16 + (256,) + (0,) * 16) == (256,)


def test_asymmetric_wide_taps_are_accepted():
    tv, th = (1,) * 20 + (2,) * 13, (3,) * 33
    x = torch.from_numpy(_planes((1, 12, 40), 49))
    got = kconv.sep_conv_u8(x, tv, th, 1.0)
    np.testing.assert_array_equal(got.numpy(), _plain(x.numpy(), tv, th, 1.0))


def test_tile_rule_fits_every_width_and_tap_count():
    for kh in list(range(33, 1200, 2)) + [2001, 10001]:
        for W in (1, 8, 63, 64, 300, 1920, 3840, 100000):
            tw, kseg, vstride = wide_tile(kh, W)
            khp = -(-kh // 8) * 8
            assert tw % 64 == 0 and tw >= 64 and kseg % 8 == 0 and vstride % 2 == 1
            assert 15 + tw + min(kseg, khp) <= vstride - 1 <= ROUND * MAX_ROUNDS
            assert tw <= -(-W // 64) * 64
            assert kseg >= khp or tw == 64      # segments only on the 64-column tile


def _smem_bytes(vstride: int, kseg: int) -> int:
    """conv.cu::wide_smem_bytes."""
    return 4 * (32 * vstride + kseg + 8) + 2 * 32 * ROUND + 4 * 2 * 33 + 256


def test_every_tile_fits_the_shared_memory_opted_in_once():
    most = 0
    for kh in list(range(1, 1200, 2)) + [2001, 10001]:
        for W in (1, 8, 63, 64, 300, 1920, 3840, 100000):
            tw, kseg, vstride = wide_tile(kh, W)
            most = max(most, _smem_bytes(vstride, kseg))
    assert most == MAX_SMEM == _smem_bytes(ROUND * MAX_ROUNDS + 1, (ROUND * MAX_ROUNDS - 79) // 8 * 8)
    assert MAX_SMEM <= 227 * 1024
