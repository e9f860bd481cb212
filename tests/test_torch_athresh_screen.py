"""The screened Gaussian adaptive threshold (kernels/athresh.py): the f32
screen with its margin and the exact f64 recompute, held to the plain
version bit for bit, its error bound checked on the same inputs, the exact
ties at k 3 that only the recompute decides, and JAX's K9 in interpret mode
at block sizes the older comparisons do not reach (0 LSB).
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import threshold as jthr
from imageenhancement_mp_tpu_torch.kernels import athresh as kathr
from imageenhancement_mp_tpu_torch.ops.threshold import gaussian_taps

CPU = torch.device("cpu")
BLOCK_SIZES = [3, 5, 7, 9, 11, 17, 31, 51]
CS = [-3.5, 0.0, 2.0, 7.2]
KINDS = ["random", "constant", "checkerboard", "ramp"]


def _plane(kind: str, shape=(2, 37, 70), seed=80) -> torch.Tensor:
    B, H, W = shape
    if kind == "random":
        x = np.random.default_rng(seed).integers(0, 256, shape)
    elif kind == "constant":
        x = np.full(shape, 201)
    elif kind == "checkerboard":
        x = np.broadcast_to(255 * ((np.arange(H)[:, None] + np.arange(W)[None, :]) % 2), shape)
    else:
        x = np.broadcast_to((np.arange(H)[:, None] * 7 + np.arange(W)[None, :] * 3) % 256, shape)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))


def _idelta(C: float, inv: bool) -> int:
    return int(np.floor(C)) if inv else int(np.ceil(C))


def _tie_plane(seed=81) -> torch.Tensor:
    """3×3 blocks, each constant n but for its centre c = n − 2: at the
    centre the k 3 mean is c + 3/2 = m + ½ for idelta 2 (m = c + 1), an
    exact tie that rint breaks to the even neighbour."""
    rng = np.random.default_rng(seed)
    n = rng.integers(2, 256, (2, 9, 17))
    x = np.repeat(np.repeat(n, 3, axis=1), 3, axis=2)
    x[:, 1::3, 1::3] -= 2
    return torch.from_numpy(x.astype(np.uint8))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_screened_mirror_equals_plain(bs, kind):
    """The screen plus the recompute equals the plain version bit for bit, C
    in {−3.5, 0, 2, 7.2}, binary and binary_inv."""
    x = _plane(kind)
    taps = gaussian_taps(bs, CPU)
    for C in CS:
        for inv in (False, True):
            idelta = _idelta(C, inv)
            got, recomputed = kathr.adaptive_threshold_screened_plain(x, taps, 255, idelta, inv)
            want = kathr.adaptive_threshold_gaussian_plain(x, taps, 255, idelta, inv)
            assert torch.equal(got, want), (C, inv)
            assert got.dtype == torch.uint8 and recomputed.shape == x.shape


def test_k3_exact_ties_go_to_the_recompute():
    """At the built ties the screen (ε = 0 for k 3) recomputes, both ways of
    breaking a tie occur, and the result is the plain version's."""
    x = _tie_plane()
    taps = gaussian_taps(3, CPU)
    assert kathr.screen_margin(taps.numpy()) == 0.0
    for inv in (False, True):
        got, recomputed = kathr.adaptive_threshold_screened_plain(x, taps, 255, 2, inv)
        assert torch.equal(got, kathr.adaptive_threshold_gaussian_plain(x, taps, 255, 2, inv))
        centres = torch.zeros_like(recomputed)
        centres[:, 1::3, 1::3] = True
        assert bool(recomputed[centres].all())
        hits = got[centres] == (0 if inv else 255)
        assert 0 < int(hits.sum()) < int(centres.sum())  # rint sends ties both ways
    acc32, acc64 = kathr.screen_sums(x, taps)
    c = x[:, 1::3, 1::3].to(torch.float64)
    assert torch.equal(acc64[:, 1::3, 1::3], c + 1.5) and torch.equal(acc32.double(), acc64)


@pytest.mark.parametrize("bs", [11, 17, 31])
def test_forced_margins(bs):
    """ε = +∞ recomputes every pixel; ε = 0 on data with no near-ties (none
    within twice the f32 bound of m + ½, checked against the f64 sums) still
    equals the plain version."""
    x = _plane("random", seed=82)
    taps = gaussian_taps(bs, CPU)
    want = kathr.adaptive_threshold_gaussian_plain(x, taps, 255, 2, False)
    got, recomputed = kathr.adaptive_threshold_screened_plain(x, taps, 255, 2, False,
                                                              margin=float("inf"))
    assert torch.equal(got, want) and bool(recomputed.all())
    _, acc64 = kathr.screen_sums(x, taps)
    near = (acc64 - (x.to(torch.float64) + 1.5)).abs() <= 2 * kathr.screen_bounds(taps.numpy())[0]
    assert not bool(near.any())
    got0, recomputed0 = kathr.adaptive_threshold_screened_plain(x, taps, 255, 2, False, margin=0.0)
    assert torch.equal(got0, want) and not bool(recomputed0.any())


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_bound_holds(bs):
    """max |acc32 − acc64| ≤ ε/2 over every plane kind and the tie plane;
    ε is 0 exactly for k 3/5/7/9, where acc32 equals acc64."""
    taps = gaussian_taps(bs, CPU)
    eps = kathr.screen_margin(taps.numpy())
    assert (eps == 0.0) == (bs <= 9)
    for x in [_plane(kind) for kind in KINDS] + [_tie_plane()]:
        acc32, acc64 = kathr.screen_sums(x, taps)
        err = float((acc32.double() - acc64).abs().max())
        assert err <= eps / 2, (err, eps)
        if bs <= 9:
            assert err == 0.0


def test_margin_formula():
    """ε(k) = 2(γ_{2k+2}(2⁻²⁴) + γ_{2k+2}(2⁻⁵³))·255·(Σ|t|)², rounded up to an f32."""
    for bs in (11, 17, 51):
        t = gaussian_taps(bs, CPU).numpy()
        n, s = 2 * bs + 2, float(np.abs(t).sum())
        want = 2 * 255 * s * s * (n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
                                  + n * 2.0 ** -53 / (1 - n * 2.0 ** -53))
        eps = kathr.screen_margin(t)
        assert eps >= want and np.float32(eps) == eps and eps < want * (1 + 2.0 ** -22)
    assert 3.6e-4 < kathr.screen_bounds(gaussian_taps(11, CPU).numpy())[0] < 3.7e-4


def test_cuda_branch_passes_margin_and_routes(monkeypatch):
    """With the launch stubbed: the C entry gets the screen margin, the
    forced one, and the instance flag."""
    launches = []
    monkeypatch.setattr(kathr, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kathr, "launch", lambda *args: launches.append(args))
    x = torch.zeros((1, 40, 70), dtype=torch.uint8)
    taps = gaussian_taps(11, CPU)
    kathr.adaptive_threshold_gaussian(x, taps, 255, 2, False)
    kathr.adaptive_threshold_gaussian(x, taps, 255, 2, False, _margin=float("inf"), _runtime=True)
    (name, _, *a), (_, _, *b) = launches
    assert name == "athresh" and a[-2] == kathr.screen_margin(taps.numpy()) and a[-1] == 0
    assert b[-2] == float("inf") and b[-1] == 1


@pytest.mark.parametrize("bs,C,type", [(5, 2.0, "binary"), (7, -3.5, "binary_inv"),
                                       (9, 7.2, "binary"), (13, 0.0, "binary_inv")])
def test_gaussian_vs_jax_k9_interpret_more_block_sizes(bs, C, type):
    """Block sizes 5, 7, 9 and 13 through JAX's K9 in interpret mode: 0 LSB,
    and 0 LSB against ref/."""
    x = np.random.default_rng(83).integers(0, 256, (2, 64, 256), dtype=np.uint8)
    config.use_pallas_kernels = True
    try:
        want = np.asarray(jthr.adaptive_threshold_planes(x, 255.0, "gaussian", type, bs, C))
    finally:
        config.use_pallas_kernels = None
    got = kathr.adaptive_threshold_gaussian(torch.from_numpy(x), gaussian_taps(bs, CPU), 255,
                                            _idelta(C, type == "binary_inv"),
                                            type == "binary_inv").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([ref.adaptive_threshold(p, 255.0, "gaussian",
                                                                        type, bs, C) for p in x]))
