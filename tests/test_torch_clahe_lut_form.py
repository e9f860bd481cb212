"""CLAHE stage B at S = 65536 (``csrc/clahe.cu::clahe_lut16_kernel``) in the
closed form the kernel computes, on the CPU.  The kernel cannot run here; a
NumPy mirror of its decomposition is held at 0 LSB to the JAX package's
``ops/clahe.py::clahe_tile_luts`` and to ``clahe_lut_plain``:

* the tile's bins split over a cluster of 8 blocks of 512 threads, each lane
  taking 8 bins in each of 2 rounds (a warp 512 bins), as the kernel's
  ``i_lane`` and rounds lay them out;
* each block's pair of sums (clipped, excess), the tile's excess and the
  lower ranks' clipped sum from the pairs, the warp and lane prefixes;
* ``cdf(i) = Pc(i) + raise·(i + 1) + min(i / step + 1, resid)`` with
  ``i / step`` from one division per lane and round, then a counter.

The histograms are adversarial: every residue class of the excess that sets
``step`` (one per value ``step`` can take), ``resid = 0`` and ``S − 1``, all
mass in one bin, ``clip_abs = 1`` and no clip, tiles of one pixel, and areas
near 2^31 − 1.  The counter and the closed form of the bumps are checked
exhaustively where that is cheap (every ``step`` and every bin; every
``resid`` at S = 256).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.ops.clahe import clahe_tile_luts
from imageenhancement_mp_tpu_torch.kernels import clahe as kc

S16 = 65536
# csrc/clahe.cu: kLut16Blocks, kLut16Threads, kLut16Bins
BLOCKS, THREADS, BINS = 8, 512, 8
INT32_MAX = 2**31 - 1


def step_of(resid):
    return np.maximum(S16 // np.maximum(resid, 1), 1) if np.ndim(resid) else \
        max(S16 // max(resid, 1), 1)


def lane_bins(S: int, blocks: int, threads: int) -> np.ndarray:
    """The bins of a tile as the kernel lays them out: ``[blocks, warps,
    rounds, 32, BINS]``; block ``rank`` owns ``S / blocks`` bins, warp ``w``
    ``rounds·256`` of them, lane ``l`` in round ``r`` the 8 from
    ``w·rounds·256 + r·256 + l·8``."""
    warps = threads // 32
    rounds = S // (blocks * threads * BINS)
    assert rounds * blocks * threads * BINS == S
    rank = np.arange(blocks)[:, None, None, None, None]
    w = np.arange(warps)[None, :, None, None, None]
    r = np.arange(rounds)[None, None, :, None, None]
    lane = np.arange(32)[None, None, None, :, None]
    j = np.arange(BINS)[None, None, None, None, :]
    return rank * (S // blocks) + w * rounds * 32 * BINS + r * 32 * BINS + lane * BINS + j


def lut_mirror(hists: np.ndarray, area: int, clip_limit: float, blocks: int = BLOCKS,
               threads: int = THREADS) -> np.ndarray:
    """The kernel's arithmetic on ``[T, S]`` int32 histograms, in int64 with
    every intermediate checked to fit int32, and its f32 roundings."""
    T, S = hists.shape
    clip_abs, scale = kc.clip_and_scale(area, clip_limit, S)
    idx = lane_bins(S, blocks, threads)
    c = hists.astype(np.int64)[:, idx]  # [T, blocks, warps, rounds, 32, BINS]
    if clip_abs > 0:
        ex = np.maximum(c - clip_abs, 0).sum(axis=(3, 4, 5))  # per warp: [T, blocks, warps]
        c = np.minimum(c, clip_abs)
    else:
        ex = np.zeros(c.shape[:3], np.int64)
    mine = c.sum(axis=-1)                         # [T, blocks, warps, rounds, 32]
    incl = np.cumsum(mine, axis=-1)               # the warp's inclusive scan, per round
    round_tot = incl[..., 31]                     # [T, blocks, warps, rounds]
    warp_clip = round_tot.sum(axis=-1)            # [T, blocks, warps]
    pair_clip, pair_ex = warp_clip.sum(axis=-1), ex.sum(axis=-1)  # each block's pair
    excess = pair_ex.sum(axis=-1)                 # [T]: the cluster's pairs, read by warp 0
    lower = np.cumsum(pair_clip, axis=-1) - pair_clip  # clipped sum of the lower ranks
    before = lower[:, :, None] + np.cumsum(warp_clip, axis=-1) - warp_clip
    for a in (c, ex, mine, incl, excess, before):
        assert a.min() >= 0 and a.max() <= INT32_MAX
    raise_, resid = excess >> 16 if S == S16 else excess // S, excess % S
    step = np.maximum(S // np.maximum(resid, 1), 1)
    bc = (slice(None),) + (None,) * 4            # [T] -> [T, 1, 1, 1, 1]
    i0 = idx[..., 0]                             # each lane's first bin per round
    q = i0[None] // step[bc]                     # one division per lane and round
    rem = i0[None] - q * step[bc]
    # the lane's clipped prefix before its first bin in each round
    cum = (before[:, :, :, None, None] + (np.cumsum(round_tot, axis=-1) - round_tot)[..., None]
           + incl - mine)
    lut = np.empty(c.shape, np.int64)
    for j in range(BINS):
        cum = cum + c[..., j]
        cdf = cum + raise_[bc] * (i0 + j + 1) + np.minimum(q + 1, resid[bc])
        assert cdf.max() <= INT32_MAX
        f = np.rint(cdf.astype(np.float32) * np.float32(scale))
        lut[..., j] = np.clip(f, 0.0, np.float32(S - 1)).astype(np.int64)
        rem += 1
        wrap = rem == step[bc]
        rem[wrap] = 0
        q[wrap] += 1
    out = np.empty((T, S), np.int64)
    out[:, idx.reshape(-1)] = lut.reshape(T, -1)
    return out.astype(np.uint8 if S == 256 else np.uint16)


def plain(hists: np.ndarray, area: int, clip_limit: float) -> np.ndarray:
    return kc.clahe_lut_plain(torch.from_numpy(hists), area, clip_limit).numpy()


def jax_luts(hists: np.ndarray, area: int, clip_limit: float) -> np.ndarray:
    return np.asarray(clahe_tile_luts(jnp.asarray(hists), area, clip_limit,
                                      hist_size=hists.shape[1]))


def excess_for(resids, area: int, rng) -> np.ndarray:
    """[len(resids), 65536] histograms of ``area`` pixels (area ≥ 65536) whose
    excess over ``clip_abs = 1`` is ≡ each resid mod 65536: n ones on random
    bins and the rest of the area in one more bin, excess = area − 1 − n."""
    h = np.zeros((len(resids), S16), np.int32)
    for t, rho in enumerate(resids):
        n = (area - 1 - int(rho)) % S16
        bins = rng.permutation(S16)[:n + 1]
        h[t, bins[:n]] = 1
        h[t, bins[n]] = area - n
    return h


# one resid for each value step takes: the least resid giving it
STEP_RESIDS = sorted({step_of(r): r for r in range(S16 - 1, 0, -1)}.values())
TINY_CLIP = 1e-9  # clip_abs = max(int(1e-9·area/S), 1) = 1


def test_step_resids_cover_every_step():
    steps = {step_of(r) for r in STEP_RESIDS}
    assert steps == {step_of(r) for r in range(1, S16)} and 1 in steps and S16 // 2 in steps
    assert len(STEP_RESIDS) == len(steps)


@pytest.mark.parametrize("part", range(4))
def test_every_step_value_matches_plain(part):
    area = 3 * S16 + 12345
    assert kc.clip_and_scale(area, TINY_CLIP, S16)[0] == 1
    resids = STEP_RESIDS[part::4]
    rng = np.random.default_rng(part)
    for k in range(0, len(resids), 32):  # 32 tiles at a time: the mirror's arrays stay small
        h = excess_for(resids[k:k + 32], area, rng)
        want = plain(h, area, TINY_CLIP)
        np.testing.assert_array_equal(lut_mirror(h, area, TINY_CLIP), want)
        if k == 0:  # a few of them against JAX too
            np.testing.assert_array_equal(want[:4], jax_luts(h[:4], area, TINY_CLIP))


@pytest.mark.parametrize("resid", [0, 1, 2, S16 // 2, S16 // 2 + 1, S16 - 2, S16 - 1])
def test_edge_resids_match_plain_and_jax(resid):
    area = 2 * S16 + 777
    h = excess_for([resid, resid], area, np.random.default_rng(resid))
    want = plain(h, area, TINY_CLIP)
    np.testing.assert_array_equal(lut_mirror(h, area, TINY_CLIP), want)
    np.testing.assert_array_equal(jax_luts(h, area, TINY_CLIP), want)
    if resid == S16 - 1:
        assert step_of(resid) == 1


@pytest.mark.parametrize("area", [1, 2, 7, S16 - 1, S16, 153600, INT32_MAX - 3, INT32_MAX])
@pytest.mark.parametrize("clip_limit", [0.0, TINY_CLIP, 2.0, 40.0])
def test_all_mass_in_one_bin(area, clip_limit):
    h = np.zeros((4, S16), np.int32)
    for t, b in enumerate((0, 1, 40000, S16 - 1)):
        h[t, b] = area
    want = plain(h, area, clip_limit)
    np.testing.assert_array_equal(lut_mirror(h, area, clip_limit), want)
    if area <= S16:
        np.testing.assert_array_equal(jax_luts(h, area, clip_limit), want)


@pytest.mark.parametrize("clip_limit", [0.0, TINY_CLIP, 0.5, 2.0, 40.0])
def test_random_tiles_match_plain_and_jax(clip_limit):
    """Peaked random histograms (as chip_smoke.py feeds stage B), tiles of
    one pixel among them, and an area near 2^31 − 1 (plain only: the JAX
    reference's int32 cumsum is the same function)."""
    rng = np.random.default_rng(7)
    area = 270 * 480
    h = np.stack([rng.multinomial(area, p) for p in rng.dirichlet(np.full(S16, 0.02), size=5)]
                 ).astype(np.int32)
    want = plain(h, area, clip_limit)
    np.testing.assert_array_equal(lut_mirror(h, area, clip_limit), want)
    np.testing.assert_array_equal(jax_luts(h, area, clip_limit), want)
    one = np.zeros((3, S16), np.int32)
    one[np.arange(3), rng.integers(0, S16, 3)] = 1
    np.testing.assert_array_equal(lut_mirror(one, 1, clip_limit), plain(one, 1, clip_limit))
    np.testing.assert_array_equal(jax_luts(one, 1, clip_limit), plain(one, 1, clip_limit))
    big = INT32_MAX - 11
    hb = np.stack([rng.multinomial(big, p) for p in rng.dirichlet(np.full(S16, 0.05), size=2)]
                  ).astype(np.int32)
    np.testing.assert_array_equal(lut_mirror(hb, big, clip_limit), plain(hb, big, clip_limit))


@pytest.mark.parametrize("clip_limit", [0.0, 1.0, 2.0, 40.0])
def test_decomposition_at_s256_matches_jax(clip_limit):
    """The same decomposition over 256 bins (one block of 32 lanes, one
    round), against JAX and the plain version."""
    rng = np.random.default_rng(11)
    area = 37 * 131
    h = np.stack([rng.multinomial(area, p) for p in rng.dirichlet(np.full(256, 0.05), size=6)]
                 ).astype(np.int32)
    h[0] = 0
    h[0, 200] = area
    want = plain(h, area, clip_limit)
    np.testing.assert_array_equal(lut_mirror(h, area, clip_limit, blocks=1, threads=32), want)
    np.testing.assert_array_equal(jax_luts(h, area, clip_limit), want)


def test_step_counter_exhaustive():
    """For every step the formula yields (S / resid for resid ≥ 1, and S
    for resid = 0) and every bin i < 65536: the lane's counter, started from
    one division at its first bin of a round, gives i / step and i % step."""
    i0 = np.unique(lane_bins(S16, BLOCKS, THREADS)[..., 0])
    assert len(i0) == S16 // BINS
    for step in sorted({step_of(r) for r in range(S16)}):
        q, rem = i0 // step, i0 % step
        for j in range(BINS):
            np.testing.assert_array_equal(q, (i0 + j) // step)
            np.testing.assert_array_equal(rem, (i0 + j) % step)
            rem = rem + 1
            wrap = rem == step
            rem[wrap] = 0
            q = q + wrap


def test_bump_closed_form():
    """min(i / step + 1, resid) is the count of bumps at bins ≤ i: every
    resid at S = 256; at S = 65536 the least and greatest resid of every
    step value and 0."""
    for S, resids in ((256, range(256)),
                      (S16, [0] + STEP_RESIDS + [max(r for r in range(1, S16) if step_of(r) == s)
                                                 for s in sorted({step_of(r) for r in
                                                                  STEP_RESIDS})[:64]])):
        i = np.arange(S)
        for resid in resids:
            step = max(S // max(resid, 1), 1)
            bumps = np.cumsum((i % step == 0) & (i // step < resid))
            np.testing.assert_array_equal(np.minimum(i // step + 1, resid), bumps)


def test_lane_bins_cover_the_tile_once_with_aligned_vectors():
    idx = lane_bins(S16, BLOCKS, THREADS)
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(S16))
    first = idx[..., 0]
    assert (first % 8 == 0).all()  # two 16-byte loads, one 16-byte store
    # a warp's lanes in a round cover 256 contiguous bins: 1 KiB loaded, 512 B stored
    assert (np.diff(first, axis=-1) == BINS).all()


def test_misaligned_histograms_are_copied_before_the_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(kc, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kc, "launch", lambda *args: calls.append(args))
    buf = torch.zeros(2 * S16 + 1, dtype=torch.int32)
    for h in (buf[:2 * S16].view(2, S16), buf[1:].view(2, S16)):
        out = kc.clahe_lut(h, 100, 2.0)
        assert out.shape == (2, S16) and out.dtype == torch.uint16
        name, _, hp, op, T, S, clip_abs, scale = calls[-1]
        assert (name, T, S, op) == ("clahe_lut", 2, S16, out.data_ptr())
        assert hp % 16 == 0 and (hp == h.data_ptr()) == (h.data_ptr() % 16 == 0)
        assert (clip_abs, scale) == (1, float(np.float32(65535) / np.float32(100)))


# --- the same law in the u16 tile kernel's epilogue ---------------------------
# csrc/clahe.cu::hist65536_tiles_kernel<true> (tile_luts65536) runs it on the
# counters its cluster holds: R blocks of the tile's cluster (kHist16Ranks =
# 2 blocks of 1024 threads; the A/B's R = 4 of 512), 4 rounds of 8 bins a
# lane, the pairs exchanged as in clahe_lut16_kernel (tile_context) and each
# entry from lut16_octet, the law both kernels call.
EPILOGUES = [(2, 1024), (4, 512)]


@pytest.mark.parametrize("blocks,threads", EPILOGUES)
@pytest.mark.parametrize("clip_limit", [0.0, TINY_CLIP, 2.0, 40.0])
def test_epilogue_split_over_ranks_matches_plain_and_jax(blocks, threads, clip_limit):
    """Peaked random tiles of config 5's area, all mass in one bin at both
    ends of a rank's range, tiles of one pixel and an area near 2^31 − 1."""
    assert lane_bins(S16, blocks, threads).shape[2] == 4  # rounds
    rng = np.random.default_rng(blocks * 100 + int(clip_limit))
    area = 270 * 480
    h = np.stack([rng.multinomial(area, p) for p in rng.dirichlet(np.full(S16, 0.02), size=3)]
                 ).astype(np.int32)
    want = plain(h, area, clip_limit)
    np.testing.assert_array_equal(lut_mirror(h, area, clip_limit, blocks, threads), want)
    np.testing.assert_array_equal(jax_luts(h, area, clip_limit), want)
    edge = np.zeros((4, S16), np.int32)
    for t, b in enumerate((0, S16 // blocks - 1, S16 // blocks, S16 - 1)):
        edge[t, b] = area
    np.testing.assert_array_equal(lut_mirror(edge, area, clip_limit, blocks, threads),
                                  plain(edge, area, clip_limit))
    one = np.zeros((3, S16), np.int32)
    one[np.arange(3), rng.integers(0, S16, 3)] = 1
    np.testing.assert_array_equal(lut_mirror(one, 1, clip_limit, blocks, threads),
                                  plain(one, 1, clip_limit))
    big = INT32_MAX - 11
    hb = rng.multinomial(big, rng.dirichlet(np.full(S16, 0.05)))[None].astype(np.int32)
    np.testing.assert_array_equal(lut_mirror(hb, big, clip_limit, blocks, threads),
                                  plain(hb, big, clip_limit))


@pytest.mark.parametrize("blocks,threads", EPILOGUES)
def test_epilogue_split_over_every_step_value(blocks, threads):
    """Half the values step can take (one resid each; R = 2 the even ones
    of STEP_RESIDS, R = 4 the odd ones) through the R-rank split, 32 tiles
    at a time."""
    area = 3 * S16 + 12345
    rng = np.random.default_rng(blocks)
    resids = STEP_RESIDS[blocks // 4::2]
    for k in range(0, len(resids), 32):
        h = excess_for(resids[k:k + 32], area, rng)
        np.testing.assert_array_equal(lut_mirror(h, area, TINY_CLIP, blocks, threads),
                                      plain(h, area, TINY_CLIP))


@pytest.mark.parametrize("blocks,threads", EPILOGUES)
def test_epilogue_lane_bins_stay_in_their_rank(blocks, threads):
    """Each rank's lanes cover exactly the values its counters hold, in
    aligned 8-bin vectors: the epilogue reads only its own shared memory."""
    idx = lane_bins(S16, blocks, threads)
    assert np.array_equal(np.sort(idx.reshape(-1)), np.arange(S16))
    for rank in range(blocks):
        mine = idx[rank].reshape(-1)
        assert mine.min() == rank * S16 // blocks and mine.max() == (rank + 1) * S16 // blocks - 1
    assert (idx[..., 0] % 8 == 0).all()
