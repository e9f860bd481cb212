"""The two 256-entry scans folded into the counts that feed them
(csrc/hist_count.cuh, csrc/hist.cu::hist256_kernel, csrc/clahe.cu::
hist256_tiles_kernel): ``kernels/hist.py::hist256_equalize_lut`` (launch
``hist256_lut``) and ``kernels/clahe.py::tile_luts256`` (launch
``tile_luts256``).

* Their plain versions against the JAX package at 0 LSB: K1
  ``hist256_pallas(interpret=True)`` through JAX's ``equalize_lut``, K4
  ``equalize_hist_pallas(interpret=True)`` against the port's
  ``apply_lut256`` with the fused LUTs, and JAX's ``clahe_tile_luts`` over
  its ``_tile_hists`` (stage A and B are integer work and one pinned f32
  law: no tolerance, unlike the blend's ROADMAP R4).
* A NumPy mirror of the handoff (``last_of_group``): each block's 256
  partial bins stored as a scratch row, tickets taken in a seeded random
  order, the last arrival's 16-byte tail sum (four row groups of 64 lanes)
  and the law it runs (the f32 roundings written out), against the
  single-pass law, with the tickets back at 0; random, flat, constant,
  two-valued and sparse histograms, clip 0, 2 and 40, totals near
  2^31 - 1, and the kernels' own work split of a plane.
* The dispatch with ``on_cuda`` and ``launch`` stubbed: ``equalize_unsharp``,
  per-frame ``equalize_hist`` and config 5 make exactly their launches and
  no fill once the stream's tickets exist, and the row-caps shapes reach
  one launch with grids within a grid axis.
"""

import zlib

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.kernels.hist import equalize_hist_pallas, hist256_pallas
from imageenhancement_mp_tpu.ops import clahe as jclahe
from imageenhancement_mp_tpu.ops.histogram import equalize_lut as jax_equalize_lut
from imageenhancement_mp_tpu_torch import kernels as kpkg
from imageenhancement_mp_tpu_torch.kernels import clahe as kc
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.kernels import hist as kh
from imageenhancement_mp_tpu_torch.kernels import median as kmedian
from imageenhancement_mp_tpu_torch.ops import clahe as tc

# --- the plain versions against the JAX package -----------------------------


def _planes(shape, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "constant":
        return np.full(shape, 77, np.uint8)
    if kind == "two-valued":
        return np.where(rng.integers(0, 2, shape) == 1, 200, 3).astype(np.uint8)
    # narrow: values in [100, 104], most bins empty, bin 0 empty
    return rng.integers(100, 105, shape, dtype=np.uint8)


KINDS = ["random", "constant", "two-valued", "narrow"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(2, 17, 33), (1, 40, 130)])
def test_equalize_lut_plain_matches_jax(shape, kind):
    x = _planes(shape, kind, 3)
    got = kh.hist256_equalize_lut(torch.from_numpy(x)).numpy()
    hists = np.asarray(hist256_pallas(x, interpret=True))
    want = np.stack([np.asarray(jax_equalize_lut(h, shape[1] * shape[2])) for h in hists])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_luts_through_apply_match_jax_k4(kind):
    x = _planes((2, 24, 40), kind, 4)
    t = torch.from_numpy(x)
    got = kh.apply_lut256(t, kh.hist256_equalize_lut(t)).numpy()
    np.testing.assert_array_equal(got, np.asarray(equalize_hist_pallas(x, interpret=True)))


@pytest.mark.parametrize("clip", [0.0, 2.0, 40.0])
@pytest.mark.parametrize("shape,grid", [((1, 37, 131), (8, 8)), ((2, 30, 64), (2, 2)),
                                        ((1, 20, 27), (4, 3)), ((1, 6, 1100), (2, 1))])
def test_tile_luts_plain_matches_jax(shape, grid, clip):
    x = _planes(shape, "random", 5)
    B, H, W = shape
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    got = kc.tile_luts256(torch.from_numpy(x), gh, gw, th, tw, clip).numpy()
    padded = np.pad(x, ((0, 0), (0, gh * th - H), (0, gw * tw - W)), mode="reflect")
    hists = np.concatenate([np.asarray(jclahe._tile_hists(p, gh, gw, th, tw, 256))
                            for p in padded])
    want = np.asarray(jclahe.clahe_tile_luts(hists, th * tw, clip, 256))
    np.testing.assert_array_equal(got, want)


# --- a NumPy mirror of the handoff and the laws -----------------------------

F32 = np.float32


def equalize_law(h: np.ndarray, total: int) -> np.ndarray:
    """hist_count.cuh::equalize_lut_entry for one histogram."""
    cdf = np.cumsum(h.astype(np.int64)).astype(np.int32)
    i0 = int((cdf == 0).sum())
    h0 = int(h[i0]) if i0 < 256 else 0
    if h0 == total:
        return np.arange(256, dtype=np.uint8)
    scale = F32(255.0) / F32(max(total - h0, 1))
    r = np.rint((cdf - h0).astype(F32) * scale)
    return np.clip(r, 0, 255).astype(np.uint8)


def stage_b_law(h: np.ndarray, clip_abs: int, scale: np.float32) -> np.ndarray:
    """hist_count.cuh::clahe_lut256_entry for one histogram."""
    v = h.astype(np.int64)
    if clip_abs > 0:
        excess = int(np.maximum(v - clip_abs, 0).sum())
        raise_, resid = excess // 256, excess % 256
        step = max(256 // max(resid, 1), 1)
        i = np.arange(256)
        v = np.minimum(v, clip_abs) + raise_ + ((i % step == 0) & (i // step < resid))
    cdf = np.cumsum(v).astype(np.int32)
    return np.clip(np.rint(cdf.astype(F32) * F32(scale)), 0, 255).astype(np.uint8)


def handoff(rows: np.ndarray, tickets: np.ndarray, group: int, rng) -> np.ndarray:
    """last_of_group over one group: members store ``rows`` (``[members,
    256]`` u32), take tickets in a random order; the last one resets its
    ticket and sums the rows as the 16-byte tail does.  Returns that
    total."""
    members = rows.shape[0]
    last = None
    for m in rng.permutation(members):
        prev = tickets[group]
        tickets[group] += 1
        if prev == members - 1:
            assert last is None
            last = m
            tickets[group] = 0
    assert last is not None or members == 1
    if members == 1:
        return rows[0].astype(np.uint32)
    vec = rows.astype(np.uint32).reshape(members, 64, 4)  # [row, lane q, word]
    parts = np.zeros((4, 64, 4), np.uint32)  # threads t = 64 r0 + q, all q at once
    for r0 in range(4):
        for k0 in range(r0, members, 4 * 8):  # kTailLoads = 8
            for u in range(8):
                if k0 + 4 * u < members:
                    parts[r0] += vec[k0 + 4 * u]
    w = parts.reshape(-1)  # word 256 r0 + 4 q + j: bin 4 q + j of row group r0
    t = np.arange(256)
    return w[t] + w[256 + t] + w[512 + t] + w[768 + t]


def split_rows(h: np.ndarray, members: int, rng) -> np.ndarray:
    """A histogram cut into ``members`` partial rows at random."""
    rows = np.zeros((members, 256), np.int64)
    for b in np.flatnonzero(h):
        rows[:, b] = rng.multinomial(int(h[b]), np.full(members, 1.0 / members))
    return rows


def hist_of(kind: str, total: int, rng) -> np.ndarray:
    h = np.zeros(256, np.int64)
    if kind == "random":
        h[:] = rng.multinomial(total, rng.dirichlet(np.full(256, 0.5)))
    elif kind == "flat":
        h[:] = total // 256
        h[: total % 256] += 1
    elif kind == "constant":
        h[rng.integers(0, 256)] = total
    elif kind == "two-valued":
        a, b = rng.choice(256, 2, replace=False)
        h[a] = total // 3
        h[b] = total - total // 3
    else:  # sparse, bin 0 empty
        bins = rng.choice(np.arange(1, 256), 5, replace=False)
        h[bins] = rng.multinomial(total, np.full(5, 0.2))
    return h


HIST_KINDS = ["random", "flat", "constant", "two-valued", "sparse"]
TOTALS = [1, 255, 64 * 1000 + 7, 2**31 - 1, 2**31 - 12]


@pytest.mark.parametrize("total", TOTALS)
@pytest.mark.parametrize("kind", HIST_KINDS)
def test_handoff_mirror_gives_the_equalize_law(kind, total):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {total}".encode()))
    tickets = np.zeros(4, np.int64)
    for members in (1, 2, 49, 198):
        h = hist_of(kind, total, rng)
        got = handoff(split_rows(h, members, rng), tickets, 1, rng)
        assert (got.astype(np.int64) == h).all()
        lut = equalize_law(got.astype(np.int64), total)
        want = kh.equalize_lut256_plain(torch.from_numpy(h[None].astype(np.int32)), total)[0]
        np.testing.assert_array_equal(lut, want.numpy())
    assert not tickets.any()


@pytest.mark.parametrize("clip", [0.0, 2.0, 40.0])
@pytest.mark.parametrize("area", [1, 270 * 480, 2**31 - 1])
@pytest.mark.parametrize("kind", HIST_KINDS)
def test_handoff_mirror_gives_the_stage_b_law(kind, area, clip):
    rng = np.random.default_rng(zlib.crc32(f"{kind} {area} {clip}".encode()))
    tickets = np.zeros(3, np.int64)
    clip_abs, scale = kc.clip_and_scale(area, clip, 256)
    for members in (1, 3, 6):
        h = hist_of(kind, area, rng)
        got = handoff(split_rows(h, members, rng), tickets, 2, rng)
        lut = stage_b_law(got.astype(np.int64), clip_abs, scale)
        want = kc.clahe_lut_plain(torch.from_numpy(h[None].astype(np.int32)), area, clip)[0]
        np.testing.assert_array_equal(lut, want.numpy())
    assert not tickets.any()


def test_tickets_come_back_to_zero_over_changing_calls():
    """Back-to-back launches on one stream share one ticket buffer with
    changing group counts and members: each leaves it at 0."""
    rng = np.random.default_rng(8)
    tickets = np.zeros(300, np.int64)
    for _ in range(24):
        groups, members = int(rng.integers(1, 300)), int(rng.integers(1, 60))
        for g in rng.permutation(groups):
            h = hist_of("random", 1000, rng)
            assert (handoff(split_rows(h, members, rng), tickets, g, rng).astype(np.int64)
                    == h).all()
        assert not tickets.any()


def _block_rows(plane: np.ndarray, blocks: int) -> np.ndarray:
    """hist256_kernel's partial rows of one plane at address 0 (no head):
    vector i goes to block (i // 256) % blocks, tail byte j to block
    ((j - tail_start) // 256) % blocks."""
    n = plane.size
    flat = plane.reshape(-1)
    nvec = n // 16
    rows = np.zeros((blocks, 256), np.int64)
    for i in range(nvec):
        np.add.at(rows[(i // 256) % blocks], flat[16 * i:16 * i + 16], 1)
    for j in range(16 * nvec, n):
        rows[((j - 16 * nvec) // 256) % blocks, flat[j]] += 1
    return rows


@pytest.mark.parametrize("shape", [(1, 64, 1000), (3, 300, 301), (2, 5, 9)])
def test_handoff_mirror_over_the_kernel_split(shape):
    """The kernel's own split of each plane among its blocks, then the
    handoff and the law: the fused LUT of each plane."""
    x = _planes(shape, "random", 9)
    B = shape[0]
    n = x[0].size
    blocks, _ = kh.hist256_plan(B, n)
    rng = np.random.default_rng(10)
    tickets = np.zeros(B, np.int64)
    want = kh.hist256_equalize_lut(torch.from_numpy(x)).numpy()
    for b in range(B):
        total = handoff(_block_rows(x[b], blocks), tickets, b, rng)
        np.testing.assert_array_equal(equalize_law(total.astype(np.int64), n), want[b])
    assert not tickets.any()


@pytest.mark.parametrize("shape,groups", [((6, 40, 130), 3), ((6, 40, 130), 1),
                                          ((4, 5, 9), 2), ((3, 64, 1000), 3)])
def test_grouped_handoff_mirror_over_the_kernel_split(shape, groups):
    """Pooled groups (hist256_kernel with groups C): plane b's blocks are
    members (b / C)·blocks + x of group b % C, whose scratch holds (B/C)·blocks
    rows; the last of all of them sums the rows and runs the equalize law
    at total (B/C)·n: the grouped LUTs, tickets back at 0."""
    x = _planes(shape, "random", 12)
    B, n = shape[0], x[0].size
    blocks, _ = kh.hist256_plan(B, n)
    members = B // groups * blocks
    scratch = np.zeros((groups, members, 256), np.int64)
    for b in range(B):
        g = b % groups
        scratch[g, (b // groups) * blocks:(b // groups + 1) * blocks] = _block_rows(x[b], blocks)
    rng = np.random.default_rng(13)
    tickets = np.zeros(groups, np.int64)
    want = kh.hist256_equalize_lut(torch.from_numpy(x), groups).numpy()
    for g in rng.permutation(groups):
        total = handoff(scratch[g], tickets, g, rng)
        np.testing.assert_array_equal(equalize_law(total.astype(np.int64), members // blocks * n),
                                      want[g])
    assert not tickets.any()


# --- the dispatch, with the launches stubbed --------------------------------


def _stub(monkeypatch, *modules):
    launches = []
    for m in modules:
        monkeypatch.setattr(m, "on_cuda", lambda t, what: True)
        monkeypatch.setattr(m, "launch", lambda *args: launches.append(args))
    return launches


def _no_fills(monkeypatch):
    fills = []
    for name in ("zeros", "zeros_like", "full", "full_like"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (fills.append(_n),
                                                                            _r(*a, **k))[1])
    return fills


@pytest.mark.parametrize("shape", [(2, 37, 131), (1, 300, 301), (8, 6, 7)])
def test_equalize_paths_launch_the_fused_kernel_and_no_fill(monkeypatch, shape):
    launches = _stub(monkeypatch, kh, kconv)
    x = torch.from_numpy(_planes(shape, "random", 11))
    tie.equalize_unsharp(x)  # the stream's tickets exist from here on
    launches.clear()
    fills = _no_fills(monkeypatch)
    tie.equalize_unsharp(x)
    tie.equalize_hist(x)
    assert [a[0] for a in launches] == ["hist256_lut", "sep_conv_u8", "hist256_lut",
                                        "apply_lut256"]
    assert fills == []
    B, n = shape[0], shape[1] * shape[2]
    name, dev, xp, out, b, nn, groups, blocks, grid_y, partial, tickets = launches[0]
    assert (b, nn, groups) == (B, n, B) and (blocks, grid_y) == kh.hist256_plan(B, n)
    assert (partial == 0) == (tickets == 0) == (blocks == 1)


@pytest.mark.parametrize("shape,grid", [((2, 2160 // 8, 3840 // 8), (8, 8)), ((1, 37, 131), (8, 8))])
def test_config5_launches_one_fused_tiles_kernel_and_no_fill(monkeypatch, shape, grid):
    from imageenhancement_mp_tpu_torch.models.presets import get_preset

    launches = _stub(monkeypatch, kc, kconv, kmedian)
    pipe = get_preset("denoise_clahe_sharpen")
    x = torch.from_numpy(_planes(shape, "random", 12))
    pipe(x)
    launches.clear()
    fills = _no_fills(monkeypatch)
    pipe(x)
    assert [a[0] for a in launches] == ["median", "tile_luts256", "clahe_blend", "sep_conv_u8"]
    assert fills == []
    B, H, W = shape
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    args = launches[1][2:]
    clip_abs, scale = kc.clip_and_scale(th * tw, 2.0, 256)
    assert args[2:4] == (clip_abs, float(scale))
    assert args[4:11] == (B, H, W, gh, gw, th, tw)
    band_rows, bands, grid_y, partial, tickets = args[11:]
    assert (band_rows, bands, grid_y) == kc.tile_band_plan(B, gh, gw, th, tw)
    assert (partial == 0) == (tickets == 0) == (grid_y == 1)


@pytest.mark.parametrize("shape,grid", [((70000, 8, 8), (2, 2)), ((1, 2_200_000, 8), (8, 8))])
def test_row_caps_shapes_reach_one_fused_launch(monkeypatch, shape, grid):
    launches = _stub(monkeypatch, kh, kc)
    x = torch.zeros(shape, dtype=torch.uint8)
    B, H, W = shape
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    assert kh.hist256_equalize_lut(x).shape == (B, 256)
    assert kc.tile_luts256(x, gh, gw, th, tw, 2.0).shape == (B * gh * gw, 256)
    assert [a[0] for a in launches] == ["hist256_lut", "tile_luts256"]
    *_, blocks, grid_y, partial, tickets = launches[0]
    assert 1 <= blocks <= kh.HIST_GRID_BLOCKS and 1 <= grid_y <= min(B, 65535)
    assert (partial == 0) == (blocks == 1)
    band_rows, bands, grid_y, partial, tickets = launches[1][13:]
    assert (bands - 1) * band_rows < th <= bands * band_rows
    assert 1 <= grid_y <= min(bands, 65535) and B * gh * gw < 2**31
    assert (partial == 0) == (grid_y == 1)


def test_stream_workspace_grows_and_keeps_counters_apart_from_rows():
    dev = torch.device("cpu")
    a = kpkg.stream_workspace(dev, 10, zeroed=True)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert kpkg.stream_workspace(dev, 5, zeroed=True) is a  # one buffer a stream
    r = kpkg.stream_workspace(dev, 10, zeroed=False)
    assert r is not a and r.data_ptr() != a.data_ptr()  # rows never land on counters
    b = kpkg.stream_workspace(dev, a.numel() + 1, zeroed=True)
    assert b.numel() > a.numel() and not b.any()
    assert kpkg.stream_workspace(dev, 3, zeroed=True) is b


def test_handoff_scratch_takes_rows_from_the_workspace_up_to_its_cap():
    dev = torch.device("cpu")
    assert kh.handoff_scratch(dev, 8, 1) == (None, 0, 0)
    rows, partial, tickets = kh.handoff_scratch(dev, 8, 49)
    assert rows is None and partial % 16 == 0 and tickets
    assert partial == kpkg.stream_workspace(dev, 1, zeroed=False).data_ptr()
    assert tickets == kpkg.stream_workspace(dev, 1, zeroed=True).data_ptr()
    rows, partial, _ = kh.handoff_scratch(dev, 64, kh.WORKSPACE_ROWS // 64 + 1)
    assert rows is not None and partial == rows.data_ptr()


def test_fused_wrappers_check_their_inputs():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        kh.hist256_equalize_lut(x.to(torch.int16))
    with pytest.raises(TypeError):
        kc.tile_luts256(x.to(torch.uint16), 2, 2, 4, 4, 2.0)
    with pytest.raises(ValueError):
        kc.tile_luts256(x, 2, 2, 3, 4, 2.0)  # tiles do not cover the plane
    with pytest.raises(ValueError):
        kh.hist256_equalize_lut(x.to("meta"))
    empty = torch.zeros((3, 0, 5), dtype=torch.uint8)
    assert torch.equal(kh.hist256_equalize_lut(empty), kh.hist256_equalize_lut_plain(empty))
