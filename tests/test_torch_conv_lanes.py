"""The arithmetic of the Hopper ``sep_conv_u8`` kernel (``csrc/conv.cu``),
modelled in NumPy as the kernel does it, and the host's choice of its
instance and route (``kernels/conv.py::conv_route``, ``epilogue_mode``).

The model packs two pixels into one uint32 (lo + hi·2^16), runs the vertical
pass on the pairs with wrapping uint32 multiply-adds, then the horizontal pass
either on the pairs (the odd pairs built as a byte permute of two aligned
words) or on unpacked int32 columns, the shift rounding, and the epilogue
on lanes (integral amounts) or as cv2's two f32 FMAs.  It must equal the
port's plain version, ``ref/`` and the JAX package's wide kernel at 0 LSB,
and no lane may carry into its neighbour.  The CUDA kernel itself runs only
on the card: ``chip_smoke.py`` holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.kernels.conv import gaussian_blur_pallas, unsharp_mask_pallas
from imageenhancement_mp_tpu.kernels.conv2 import sep_conv5_wide, supports_wide
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

M32 = np.uint64(0xFFFFFFFF)


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(i)
    m = 2 * (n - 1)
    i = np.mod(i, m)
    return np.where(i >= n, m - i, i)


def _f32_law(s: np.ndarray, b: np.ndarray, amount: float) -> np.ndarray:
    """cv2's t = f32(b·beta), r = RN32(s·alpha + t), sat(rint(r)).  s·alpha
    is exact in f64 (8 by 24 bits) and so is its sum with t for the amounts
    used here (operands within 53 bits of each other): one f32 rounding."""
    alpha, beta = (np.float32(w) for w in kconv.unsharp_weights(amount))
    t = (b.astype(np.float32) * beta).astype(np.float32)
    r = (s.astype(np.float64) * np.float64(alpha) + np.float64(t)).astype(np.float32)
    return np.clip(np.rint(r), 0, 255).astype(np.int64)


def lanes_model(x: np.ndarray, tv, th, amount=None, luts=None) -> np.ndarray:
    """``sep_conv_u8`` on [B, H, W] u8, written as the kernel computes it."""
    route = kconv.conv_route(tv, th)
    mode, a = kconv.epilogue_mode(amount)
    src = x if luts is None else np.take_along_axis(luts, x.reshape(x.shape[0], -1), 1).reshape(x.shape)
    B, H, W = src.shape
    rv, rh = len(tv) // 2, len(th) // 2
    padl = rh + (rh & 1)              # even: pairs start on output columns
    wo = W + (W & 1)
    rows = _reflect(np.arange(-rv, H + rv), H)
    cols = _reflect(np.arange(-padl, wo + padl + 2), W)
    p = src[:, rows][:, :, cols].astype(np.uint64)
    lo, hi = p[..., 0::2], p[..., 1::2]
    pairs = lo | (hi << np.uint64(16))                  # two pixels per uint32
    # vertical: one multiply-add per pair, wrapping at 32 bits like an IMAD
    v = np.zeros((B, H, pairs.shape[-1]), np.uint64)
    v_lo = np.zeros_like(v)
    v_hi = np.zeros_like(v)
    for j, t in enumerate(route.taps_v):
        v = (v + np.uint64(t) * pairs[:, j:j + H]) & M32
        v_lo += np.uint64(t) * lo[:, j:j + H]
        v_hi += np.uint64(t) * hi[:, j:j + H]
    assert v_lo.max() < 65536 and v_hi.max() < 65536, "a vertical lane carried"
    assert np.array_equal(v, v_lo | (v_hi << np.uint64(16)))
    nq = wo // 2
    if route.packed:
        half2 = np.uint64((1 << route.shift >> 1) * 0x00010001)
        acc = np.zeros((B, H, nq), np.uint64)
        for j, t in enumerate(route.taps_h):
            m = 2 * np.arange(nq) + padl + j - rh      # first column of the pair, one parity
            if (padl + j - rh) % 2 == 0:
                word = v[..., m >> 1]
            else:                                      # __byte_perm(e[m], e[m + 1], 0x5432)
                word = (v[..., m >> 1] >> np.uint64(16)) | ((v[..., (m >> 1) + 1] << np.uint64(16)) & M32)
            acc = (acc + np.uint64(t) * word) & M32
        blur = ((acc + half2) >> np.uint64(route.shift)) & np.uint64(0x00FF00FF)
    else:
        vcol = np.stack([v & np.uint64(0xFFFF), v >> np.uint64(16)], -1).reshape(B, H, -1).astype(np.int64)
        acc = sum(t * vcol[..., padl + j - rh:padl + j - rh + wo] for j, t in enumerate(route.taps_h))
        assert acc.max() < 2 ** 31
        b = np.minimum((acc + (1 << route.shift >> 1)) >> route.shift, 255).astype(np.uint64)
        blur = b[..., 0::2] | (b[..., 1::2] << np.uint64(16))
    s = pairs[:, rv:rv + H, padl // 2:padl // 2 + nq]
    if mode == 0:
        out = blur
    elif mode == 1:
        w = (s * np.uint64(1 + a) + np.uint64(256 * a * 0x00010001) + (M32 + 1) - blur * np.uint64(a)) & M32
        lanes = np.stack([w & np.uint64(0xFFFF), w >> np.uint64(16)], -1)
        assert lanes.max() <= 255 + 511 * a and lanes.min() >= a   # the lane bound of the proof
        lanes = np.clip(lanes, 256 * a, 256 * a + 255)              # __vmaxu2, __vminu2
        out_b = (lanes & np.uint64(0xFF)).reshape(B, H, wo)
        return out_b[..., :W].astype(np.uint8)
    else:
        b2 = np.stack([blur & np.uint64(0xFFFF), blur >> np.uint64(16)], -1)
        s2 = np.stack([s & np.uint64(0xFFFF), s >> np.uint64(16)], -1)
        return _f32_law(s2, b2, amount).reshape(B, H, wo)[..., :W].astype(np.uint8)
    out_b = np.stack([out & np.uint64(0xFF), (out >> np.uint64(16)) & np.uint64(0xFF)], -1)
    return out_b.reshape(B, H, wo)[..., :W].astype(np.uint8)


def _planes(shape, seed, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "255":
        return np.full(shape, 255, np.uint8)
    if kind == "0/255":
        return (rng.integers(0, 2, shape) * 255).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _plain(x, tv, th, amount, luts):
    return kconv.sep_conv_u8_plain(torch.from_numpy(x), tv, th, amount,
                                   None if luts is None else torch.from_numpy(luts)).numpy()


KS = [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), ((3, 5), 0.0), (5, 1.5), (7, 2.3), (9, 0.0),
      (31, 0.0), ((1, 31), 0.0)]
AMOUNTS = [None, 1.0, 0.5, -1.0, 100.0]


@pytest.mark.parametrize("ks,sigma", KS)
@pytest.mark.parametrize("use_lut", [False, True])
def test_model_matches_plain_and_ref(ks, sigma, use_lut):
    x = _planes((2, 19, 45), 31)
    luts = _planes((2, 256), 32) if use_lut else None
    tv, th = q8_taps(ks, sigma)
    for amount in AMOUNTS:
        got = lanes_model(x, tv, th, amount, luts)
        np.testing.assert_array_equal(got, _plain(x, tv, th, amount, luts), err_msg=str(amount))
        if luts is None and (amount is None or not isinstance(ks, tuple)):
            if amount is None:
                want = np.stack([ref.gaussian_blur(q, ks, sigma) for q in x])
            else:
                want = np.stack([ref.unsharp_mask(q, amount, ks, sigma) for q in x])
            np.testing.assert_array_equal(got, want, err_msg=f"ref {amount}")


# taps at the sum limit 256, symmetric and not, on both routes
TAP_SETS = [((16, 64, 96, 64, 16), (16, 64, 96, 64, 16)), ((64, 128, 64), (256,)),
            ((0, 256, 0), (128, 0, 128)), ((1, 254, 1), (2, 252, 2)), ((255, 1, 0), (8, 240, 8)),
            ((256,), (1,) * 31), ((0, 0, 0), (64, 128, 64))]


@pytest.mark.parametrize("kind", ["255", "0/255", "random"])
@pytest.mark.parametrize("taps", TAP_SETS, ids=[str(i) for i in range(len(TAP_SETS))])
def test_model_at_the_sum_limit(kind, taps):
    tv, th = taps
    x = _planes((2, 9, 37), 33, kind)
    for amount in (None, 1.0, 127.0, 0.5):
        np.testing.assert_array_equal(lanes_model(x, tv, th, amount), _plain(x, tv, th, amount, None),
                                      err_msg=f"{taps} {amount}")


@pytest.mark.parametrize("k,sigma", [(5, 0.0), (3, 0.0), (5, 1.5)])
@pytest.mark.parametrize("use_lut", [False, True])
def test_model_matches_jax_wide_kernel(k, sigma, use_lut):
    x = _planes((2, 16, 256), 34)
    assert supports_wide(x.shape, np.uint8)
    luts = _planes((2, 256), 35) if use_lut else None
    lut2 = None if luts is None else luts.astype(np.int32).reshape(2, 2, 128)
    tv, th = q8_taps(k, sigma)
    for amount in (None, 1.0, 0.5):   # the JAX packed epilogue is wrong below 0 (ROADMAP R1)
        want = np.asarray(sep_conv5_wide(x, tv, th, amount, lut2=lut2, interpret=True))
        np.testing.assert_array_equal(lanes_model(x, tv, th, amount, luts), want, err_msg=str(amount))


@pytest.mark.parametrize("shift", list(range(9)) + [16])
def test_shift_rounding_equals_cv2(shift):
    """(acc + q/2) >> log2 q equals (acc8 + 2^15) >> 16 with acc8 = acc·65536/q
    for every reachable acc (≤ 255·q)."""
    q = 1 << shift
    acc = np.arange(255 * q + 1, dtype=np.int64)
    acc8 = acc << (16 - shift)
    np.testing.assert_array_equal((acc + (q >> 1)) >> shift, (acc8 + 32768) >> 16)


def test_lane_epilogue_equals_two_fmas():
    """For every integral amount in [0, 127], src and blur: the lanes' form
    equals cv2's two f32 FMAs, computed here exactly in float64."""
    s, b = np.meshgrid(np.arange(256, dtype=np.int64), np.arange(256, dtype=np.int64), indexing="ij")
    for a in range(kconv.MAX_LANE_AMOUNT + 1):
        assert kconv.epilogue_mode(float(a)) == (1, a)
        lane = (1 + a) * s + 256 * a - a * b
        assert lane.min() >= 0 and lane.max() <= 65535
        got = np.clip(lane, 256 * a, 256 * a + 255) & 0xFF
        np.testing.assert_array_equal(got, _f32_law(s, b, float(a)), err_msg=str(a))


ROUTES = [((1, 0.0), "runtime/packed", 0), ((3, 0.0), "k3/packed", 4), ((5, 0.0), "k5/packed", 8),
          ((7, 0.0), "k7/int32", 16), (((3, 5), 0.0), "runtime/packed", 6),
          ((5, 1.5), "k5/int32", 16), ((3, 1.1), "k3/int32", 16), ((7, 2.3), "k7/int32", 16),
          ((9, 0.0), "runtime/int32", 16), ((31, 0.0), "runtime/int32", 16),
          (((1, 31), 0.0), "runtime/packed", 8), (((5, 3), 0.0), "runtime/packed", 6),
          # past 31 taps the zero ends are trimmed first (kernels/conv.py::trim_taps)
          ((33, 0.0), "runtime/int32", 16), ((0, 6.0), "wide/int32", 16),
          (((33, 1), 0.0), "runtime/packed", 8), (((3, 35), 0.0), "runtime/int32", 16)]


@pytest.mark.parametrize("ks_sigma,route,shift", ROUTES, ids=[str(r[0]) for r in ROUTES])
def test_host_chooses_instance_and_route(monkeypatch, ks_sigma, route, shift):
    tv, th = q8_taps(*ks_sigma)
    r = kconv.conv_route(tv, th)
    assert (r.describe(), r.shift) == (route, shift)
    if r.packed:    # the kernel's entry point refuses a packed route whose lanes could carry
        assert 255 * sum(r.taps_v) * sum(r.taps_h) + (1 << r.shift >> 1) <= 65535
        assert r.taps_v == kconv.reduce_taps(kconv.trim_taps(tv))[0]
        assert r.taps_h == kconv.reduce_taps(kconv.trim_taps(th))[0]
    else:
        assert (r.taps_v, r.taps_h) == (kconv.trim_taps(tv), kconv.trim_taps(th))
        assert 255 * sum(tv) <= 65535
    launches = []
    monkeypatch.setattr(kconv, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kconv, "launch", lambda *args: launches.append(args))
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for amount, mode in ((None, (0, 0)), (1.0, (1, 1)), (127.0, (1, 127)), (128.0, (2, 0)),
                         (0.5, (2, 0)), (-1.0, (2, 0)), (0.0, (1, 0))):
        launches.clear()
        kconv.sep_conv_u8(x, tv, th, amount)
        (name, _, *args), = launches
        assert name == "sep_conv_u8"
        assert tuple(args[-7:-2]) == (r.instance, int(r.packed), r.shift, *mode)


def test_every_gaussian_tap_set_fits_its_route():
    for k in range(1, 46, 2):
        for sigma in (0.0, 0.3, 0.8, 1.1, 1.5, 2.3, 4.0, 9.0):
            tv, _ = q8_taps(k, sigma)
            r = kconv.conv_route(tv, tv)
            bound = 255 * sum(r.taps_v) * (sum(r.taps_h) if r.packed else 1)
            assert bound <= 65535, (k, sigma, r)
            n = len(kconv.trim_taps(tv))   # the count after trimming (k itself up to 31)
            assert n == k or k > kconv.RUNTIME_MAX_TAPS
            assert r.instance == (n if n in kconv.COMPILED_K else
                                  0 if n <= kconv.RUNTIME_MAX_TAPS else kconv.WIDE)
            assert r.packed or r.shift == 16


# the kernel's residues: widths ≡ 0, 1, 15 mod 16 and tiny, heights around a tile
RESIDUES = [(1, 16, 128), (1, 17, 129), (2, 15, 143), (1, 40, 140), (1, 3, 1), (1, 1, 2),
            (2, 5, 3), (1, 33, 31)]


@pytest.mark.parametrize("shape", RESIDUES, ids=[str(s) for s in RESIDUES])
def test_plain_matches_jax_conv_planes_at_residues(shape):
    x = _planes(shape, 36)
    t = torch.from_numpy(x)
    tv, th = q8_taps(5, 0.0)
    np.testing.assert_array_equal(kconv.sep_conv_u8_plain(t, tv, th).numpy(),
                                  np.asarray(gaussian_blur_pallas(x, 5, 0.0, interpret=True)))
    tv, th = q8_taps(3, 0.0)
    np.testing.assert_array_equal(kconv.sep_conv_u8_plain(t, tv, th, 0.5).numpy(),
                                  np.asarray(unsharp_mask_pallas(x, 0.5, 3, 0.0, interpret=True)))
    np.testing.assert_array_equal(lanes_model(x, tv, th, 0.5), kconv.sep_conv_u8_plain(t, tv, th, 0.5).numpy())
