"""u16 CLAHE's two kernels (``csrc/clahe.cu``: ``hist65536_tiles``, stage A,
and ``clahe_blend_u16_kernel``, stage C), on the CPU.  The kernels cannot
run here; NumPy mirrors follow their plans and arithmetic and are held to the
plain versions at 0 LSB.

* The blend's block plan (``blend16_pieces``, ``blend16_rows``, decoded as
  the kernel decodes ``blockIdx``) over the 16 geometries of
  ``test_torch_clahe_quads.py``: every pixel lies in exactly one block, each
  block inside one interpolation cell, within its vectors and fx buffer.
* A mirror of the blend's chunked walk (per block: the value chunks its
  pixels use, matched through bit planes; per chunk the quads of the four
  LUT rows between the block's least and greatest value; per pixel in the
  chunk the f32 blend) equals
  ``clahe_blend_plain`` on random, smooth, constant, 12-bit and two-extreme
  planes, and stages only the chunks a block uses (one on 12-bit and
  constant planes).
* Stage A: a mirror of its tile walk (8-pixel vectors, head, tail,
  reflected pad; two blocks a tile, each counting one half of the value
  range) reads every padded position once per block with aligned body
  loads and counts exactly, and a mirror of the half split (each half's
  32768 int32 counters stored whole) equals ``tile_hists_plain``, also on
  tiles of 65535 and more equal values.
* The CUDA dispatch with ``on_cuda`` and ``launch`` stubbed: u16
  ``clahe_planes`` launches ``hist65536_tiles``, ``clahe_lut`` and
  ``clahe_blend`` once each and never calls ``tile_hists_plain``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import U16_PLANES, u16_planes
from imageenhancement_mp_tpu_torch.kernels import clahe as kc
from imageenhancement_mp_tpu_torch.ops import clahe as tc
from test_torch_clahe_quads import GEOMETRIES, MIRROR

SHIFT = 13  # csrc/clahe.cu kB16Shift: chunks of 8192 values
CHUNK = 1 << SHIFT
TWO23 = np.float32(8388608.0)


def reflect101(i: int, n: int) -> int:
    """csrc/reflect.cuh::reflect101."""
    if 0 <= i < n:
        return i
    if n == 1:
        return 0
    m = 2 * (n - 1)
    i %= m
    return m - i if i >= n else i


def _tables(H, W, grid):
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    xi0, xi1, fx = tc._interp_coords(W, tw, gw)
    yi0, yi1, fy = tc._interp_coords(H, th, gh)
    return (gh, gw, th, tw), np.stack([yi0, yi1]), fy, np.stack([xi0, xi1]), fx


def blocks(yidx, xidx):
    """The u16 blend's blocks of one plane as the kernel decodes them:
    ``(ya, yb, xa, xb, xv, nv)`` for blockIdx.x = piece * maxbands + band and
    each row cell on the y axis; empty bands are skipped, as the kernel
    skips them."""
    pieces, rows = kc.blend16_pieces(xidx), kc.blend16_rows(yidx)
    maxbands = -(-int((rows[:, 1] - rows[:, 0]).max()) // int(pieces[:, 2].min()))
    for xa, xb, rpb in pieces.tolist():
        xv, nv = xa & ~7, -(-xb // 8) - xa // 8
        for band in range(maxbands):
            for r0, r1 in rows.tolist():
                ya = r0 + band * rpb
                if ya < r1:
                    yield ya, min(ya + rpb, r1), xa, xb, xv, nv


@pytest.mark.parametrize("H,W,grid", GEOMETRIES)
def test_blend_plan_covers_each_pixel_once_inside_one_cell(H, W, grid):
    _, yidx, _, xidx, _ = _tables(H, W, grid)
    pieces = kc.blend16_pieces(xidx)
    assert (pieces[:, 2] >= 1).all() and pieces[:, 0].min() == 0 and pieces[:, 1].max() == W
    cover = np.zeros((H, W), np.int32)
    for ya, yb, xa, xb, xv, nv in blocks(yidx, xidx):
        assert 1 <= nv <= kc.B16_MAX_PIECE_VECS and (yb - ya) * nv <= kc.B16_ITEMS
        assert xv <= xa < xb <= min(xv + 8 * nv, W) and xb > xv + 8 * (nv - 1)
        # one cell: the four neighbour LUTs are the same over the block
        assert (yidx[:, ya:yb] == yidx[:, ya:ya + 1]).all()
        assert (xidx[:, xa:xb] == xidx[:, xa:xa + 1]).all()
        cover[ya:yb, xa:xb] += 1
    assert (cover == 1).all()


def _as_f32(bits):
    return np.asarray(bits, np.uint32).view(np.float32)


def blend16_mirror(x, luts, gh, gw, yidx, fy, xidx, fx):
    """clahe_blend_u16_kernel in NumPy: ``x`` [B, H, W] u16 and ``luts``
    [B·gh·gw, 65536] u16 → (u16 [B, H, W], chunks staged per block)."""
    B, H, W = x.shape
    out = np.zeros_like(x)
    staged = []
    lut32 = luts.astype(np.uint32)
    for b in range(B):
        for ya, yb, xa, xb, xv, nv in blocks(yidx, xidx):
            cols = np.arange(xv, xv + 8 * nv)
            c = cols[(cols >= xa) & (cols < xb)]  # the block's pixels of each vector
            v = x[b, ya:yb][:, c].astype(np.uint32)
            ty0, ty1, tx0, tx1 = yidx[0, ya], yidx[1, ya], xidx[0, xa], xidx[1, xa]
            r00, r01, r10, r11 = (lut32[(b * gh + ty) * gw + tx]
                                  for ty, tx in ((ty0, tx0), (ty0, tx1), (ty1, tx0), (ty1, tx1)))
            # bit planes: bit i of plane i is value bit SHIFT + i
            planes = [(v >> (SHIFT + i)) & 1 for i in range(16 - SHIFT)]
            used = [ch for ch in range(1 << (16 - SHIFT))
                    if np.all([planes[i] == ((ch >> i) & 1) for i in range(16 - SHIFT)],
                              axis=0).any()]
            staged.append(len(used))
            gxs, fxs = np.float32(1) - fx[c][None, :], fx[c][None, :]
            gys, fys = np.float32(1) - fy[ya:yb][:, None], fy[ya:yb][:, None]
            res = np.zeros(v.shape, np.uint32)
            bmin, bmax = int(v.min()), int(v.max())
            for ch in used:
                # only the groups of 8 values between the block's least and
                # greatest value are staged; the rest of the chunk stays 0
                v0 = ch << SHIFT
                g0, g1 = (max(bmin, v0) - v0) >> 3, (min(bmax, v0 + CHUNK - 1) - v0) >> 3
                s0, s1 = v0 + 8 * g0, v0 + 8 * g1 + 8
                q_x, q_y = np.zeros(CHUNK, np.uint32), np.zeros(CHUNK, np.uint32)
                q_x[s0 - v0:s1 - v0] = r00[s0:s1] | r01[s0:s1] << 16
                q_y[s0 - v0:s1 - v0] = r10[s0:s1] | r11[s0:s1] << 16
                m = (v >> SHIFT) == ch
                qx, qy = q_x[v[m] & (CHUNK - 1)], q_y[v[m] & (CHUNK - 1)]
                e = [_as_f32(0x4B000000 | (q & 0xFFFF)) - TWO23 for q in (qx, qx >> 16, qy, qy >> 16)]
                gx, f = np.broadcast_to(gxs, v.shape)[m], np.broadcast_to(fxs, v.shape)[m]
                gy, g = np.broadcast_to(gys, v.shape)[m], np.broadcast_to(fys, v.shape)[m]
                top = gx * e[0] + f * e[1]
                bot = gx * e[2] + f * e[3]
                r = np.minimum(np.maximum(gy * top + g * bot, np.float32(0)), np.float32(65535))
                res[m] = (r + TWO23).view(np.uint32) & 0xFFFF
            out[b, ya:yb][:, c] = res.astype(np.uint16)
    return out, staged


# the mirror's geometries: those of the u8 mirror with at most 256 tiles
# (128 KiB of random LUT each); one plane where the tiles are many
MIRROR16 = [g for g in MIRROR if np.prod(g[2]) <= 256]


@pytest.mark.parametrize("kind", U16_PLANES)
@pytest.mark.parametrize("H,W,grid", MIRROR16)
def test_blend_mirror_equals_plain(H, W, grid, kind):
    (gh, gw, th, tw), yidx, fy, xidx, fx = _tables(H, W, grid)
    rng = np.random.default_rng(H * 7 + W)
    B = 2 if gh * gw <= 64 else 1
    x = u16_planes((B, H, W), kind, rng)
    luts = rng.integers(0, 65536, (B * gh * gw, 65536)).astype(np.uint16)
    t = (*tc._coord_tables(H, th, gh, torch.device("cpu")),
         *tc._coord_tables(W, tw, gw, torch.device("cpu")))
    want = kc.clahe_blend_plain(torch.from_numpy(x), torch.from_numpy(luts), gh, gw, *t).numpy()
    got, staged = blend16_mirror(x, luts, gh, gw, yidx, fy, xidx, fx)
    np.testing.assert_array_equal(got, want)
    if kind in ("constant", "12-bit"):
        assert set(staged) == {1}  # one chunk: an empty chunk is never staged
    if kind == "extremes":
        assert max(staged) <= 2


def test_blend_mirror_equals_plain_on_real_luts():
    """CLAHE's own LUTs (stages A and B) on a 4K-shaped crop, grid 8x8."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(u16_planes((1, 270, 480), "smooth", rng))
    (gh, gw, th, tw), yidx, fy, xidx, fx = _tables(270, 480, (8, 8))
    luts = kc.clahe_lut(kc.hist65536_tiles(x, gh, gw, th, tw), th * tw, 2.0)
    t = (*tc._coord_tables(270, th, gh, torch.device("cpu")),
         *tc._coord_tables(480, tw, gw, torch.device("cpu")))
    want = kc.clahe_blend_plain(x, luts, gh, gw, *t).numpy()
    got, _ = blend16_mirror(x.numpy(), luts.numpy(), gh, gw, yidx, fy, xidx, fx)
    np.testing.assert_array_equal(got, want)


# --- stage A -----------------------------------------------------------------

# (B, H, W, grid): divisible and not, tiny tiles, gw = 1, a single column,
# the R2 geometry, a tile of exactly 65535 pixels, tiles wider than 65535
HIST_GEOMETRIES = [(2, 37, 131, (8, 8)), (1, 164, 164, (2, 2)), (1, 2, 3, (2, 2)),
                   (1, 30, 256, (2, 2)), (1, 5, 7, (8, 8)), (1, 3, 1, (2, 2)),
                   (1, 6, 1100, (2, 1)), (1, 255, 257, (1, 1)), (1, 2, 70001, (1, 1)),
                   (1, 300, 301, (3, 7)), (1, 1, 65536, (1, 1)), (1, 1000, 130, (2, 1))]


RANKS, THREADS = 2, 1024  # csrc/clahe.cu: kHist16Ranks, kHist16Threads


class Count16:
    """csrc/clahe.cu::Count16: one block's 16-bit counters of the whole value
    range; a vector of 8 equal pixels adds 8 at once.  No counter may pass
    65535 within a round."""

    def __init__(self):
        self.w = np.zeros(65536, np.int64)

    def add(self, v, n):
        self.w[v] += n
        assert self.w[v] <= 65535

    def add_one(self, v):
        self.add(v, 1)

    def add_vec(self, vals):
        if len(set(vals)) == 1:
            self.add(vals[0], 8)
            return
        for v in vals:
            self.add(v, 1)


def rounds_of(th, tw, ranks=RANKS):
    """csrc/clahe.cu::Rounds16: ``(share, piece_w, band_rows, pieces,
    bands)``: each rank's share of the tile's rows, counted in bands of
    band_rows rows by column pieces of piece_w columns."""
    share = -(-th // ranks)
    piece = min(tw, 65535)
    band = 65535 // piece
    return share, piece, band, -(-tw // piece), -(-share // band)


def tile_walk16(x, gh, gw, th, tw, base, ranks=RANKS, threads=THREADS):
    """hist65536_tiles_kernel's index arithmetic for every block (``ranks``
    a tile, one cluster, each walking its share of the tile's rows in its
    rounds), warp and lane, the plane at byte address ``base``, counting
    into each block's 16-bit counters; after each round the cluster's sums
    go into the tile's bins.  Returns ``(reads[b, R, C], hists [B·gh·gw,
    65536])``."""
    B, H, W = x.shape
    reads = np.zeros((B, gh * th, gw * tw), np.int64)
    hists = np.zeros((B * gh * gw, 65536), np.int64)
    warps = threads // 32
    share, piece_w, band_rows, pieces, bands = rounds_of(th, tw, ranks)
    for tile in range(B * gh * gw):
        b, t = divmod(tile, gh * gw)
        ty, tx = divmod(t, gw)
        plane = base + 2 * b * H * W
        for rnd in range(pieces * bands):
            piece, band = divmod(rnd, bands)
            c0 = tx * tw + piece * piece_w
            pw = min(piece_w, tw - piece * piece_w)
            length, cp = max(min(c0 + pw, W) - c0, 0), max(c0, W)
            npad = c0 + pw - cp
            ragged = (plane + 2 * c0) % 16 != 0 or (W | length) % 8 != 0 or npad > 0
            blocks = [Count16() for _ in range(ranks)]
            for rank, c in enumerate(blocks):
                r0 = min(rank * share, th)
                nrows = min(band_rows, min(share, th - r0) - band * band_rows)
                R0 = ty * th + r0 + band * band_rows

                def row_body(q):
                    sy = reflect101(R0 + q, H)
                    addr = plane + 2 * (sy * W + c0)
                    head = min((16 - addr % 16) % 16 // 2, length)
                    return sy, head, (length - head) // 8

                def read(R, C, sy, sx):
                    assert R // th == ty and C // tw == tx
                    reads[b, R, C] += 1
                    return int(x[b, sy, sx])

                for tid in range(threads):
                    q, j = tid // 32, tid % 32
                    row = row_body(q) if q < nrows else None
                    while q < nrows and j >= row[2]:
                        j -= row[2]
                        q += warps
                        if q < nrows:
                            row = row_body(q)
                    while q < nrows:
                        sy, head, nv = row
                        first = c0 + head + 8 * j
                        assert (plane + 2 * (sy * W + first)) % 16 == 0  # a uint4 load
                        assert first + 8 <= min(c0 + pw, W)
                        c.add_vec([read(R0 + q, C, sy, C) for C in range(first, first + 8)])
                        j += 32
                        while q < nrows and j >= row[2]:
                            j -= row[2]
                            q += warps
                            if q < nrows:
                                row = row_body(q)
                for warp in range(warps):
                    for r in range(warp, nrows if ragged else 0, warps):
                        sy, head, nv = row_body(r)
                        tail0 = head + 8 * nv
                        for lane in range(32):
                            if lane < 16:
                                if lane < head:
                                    c.add_one(read(R0 + r, c0 + lane, sy, c0 + lane))
                            elif tail0 + lane - 16 < length:
                                C = c0 + tail0 + lane - 16
                                c.add_one(read(R0 + r, C, sy, C))
                            for k in range(lane, npad, 32):
                                c.add_one(read(R0 + r, cp + k, sy, reflect101(cp + k, W)))
            # the cluster's sums of this round: rank q's range summed over the
            # blocks (cluster_bins), added to the earlier rounds'
            hists[tile] += sum(c.w for c in blocks)
    return reads, hists


@pytest.mark.parametrize("B,H,W,grid", HIST_GEOMETRIES[:8])
@pytest.mark.parametrize("base", [0, 2, 14])
def test_tile_walk_reads_each_position_once_and_counts_exactly(B, H, W, grid, base):
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    rng = np.random.default_rng(B * H + W + base)
    x = u16_planes((B, H, W), "random" if base else "extremes", rng)
    reads, hists = tile_walk16(x, gh, gw, th, tw, base)
    assert (reads == 1).all()  # by exactly one block of the tile's cluster
    want = kc.tile_hists_plain(torch.from_numpy(x), gh, gw, th, tw).numpy()
    np.testing.assert_array_equal(hists, want)


@pytest.mark.parametrize("B,H,W,grid,ranks", [(1, 600, 131, (1, 1), 2), (1, 2, 70001, (1, 1), 2),
                                              (2, 37, 131, (8, 8), 4), (1, 5, 7, (8, 8), 4)])
def test_tile_walk_over_rounds_and_four_ranks(B, H, W, grid, ranks):
    """Tiles of more than 65535 pixels a block (two row bands; a row wider
    than 65535, two column pieces) and the A/B's cluster of 4: every
    position read once, no 16-bit counter past 65535 in a round, the sums
    exact."""
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    x = u16_planes((B, H, W), "constant" if H == 600 else "random",
                   np.random.default_rng(H * W))
    assert rounds_of(th, tw, ranks)[3] * rounds_of(th, tw, ranks)[4] == (
        kc.tile16_rounds(th, tw) if ranks == RANKS else 1)
    reads, hists = tile_walk16(x, gh, gw, th, tw, 2, ranks=ranks)
    assert (reads == 1).all()
    np.testing.assert_array_equal(
        hists, kc.tile_hists_plain(torch.from_numpy(x), gh, gw, th, tw).numpy())


def test_rows_split_among_the_ranks():
    """Every padded row of a tile in exactly one rank's share and one band
    of it, for tiles of 1 to 300 rows at 2 and 4 ranks (shares empty where
    th < R), and the round count the wrapper computes for its scratch."""
    for ranks in (2, 4):
        for th in range(1, 301):
            share, _, band_rows, _, bands = rounds_of(th, 70, ranks)
            rows = []
            for rank in range(ranks):
                r0 = min(rank * share, th)
                for band in range(bands):
                    n = min(band_rows, min(share, th - r0) - band * band_rows)
                    rows += range(r0 + band * band_rows, r0 + band * band_rows + max(n, 0))
            assert rows == list(range(th))
    for th, tw, rounds in ((270, 480, 1), (135, 240, 1), (540, 960, 4), (2, 70001, 2),
                           (1, 65536, 2), (1, 65535, 1), (2 * 65535, 1, 1), (2 * 65535 + 1, 1, 2)):
        assert kc.tile16_rounds(th, tw) == rounds
        share, piece, band, pieces, bands = rounds_of(th, tw)
        assert pieces * bands == rounds and band * piece <= 65535 and min(share, band) * piece <= 65535


def rank_count(x, gh, gw, th, tw, ranks=RANKS):
    """The count alone (no walk): each block's rows of each round into
    16-bit counters (none past 65535), the cluster's sums of the round added
    into the tile's bins."""
    B, H, W = x.shape
    rows = np.array([reflect101(r, H) for r in range(gh * th)])
    cols = np.array([reflect101(c, W) for c in range(gw * tw)])
    share, piece_w, band_rows, pieces, bands = rounds_of(th, tw, ranks)
    out = np.zeros((B * gh * gw, 65536), np.int64)
    for tile in range(B * gh * gw):
        b, t = divmod(tile, gh * gw)
        ty, tx = divmod(t, gw)
        v = x[b][rows[ty * th:(ty + 1) * th]][:, cols[tx * tw:(tx + 1) * tw]].astype(np.int64)
        for rnd in range(pieces * bands):
            piece, band = divmod(rnd, bands)
            for rank in range(ranks):
                r0 = min(rank * share, th) + band * band_rows
                r1 = min(r0 + band_rows, min((rank + 1) * share, th))
                counts = np.bincount(v[r0:r1, piece * piece_w:(piece + 1) * piece_w].ravel(),
                                     minlength=65536)
                assert counts.max(initial=0) <= 65535
                out[tile] += counts
    return out


@pytest.mark.parametrize("kind", U16_PLANES)
@pytest.mark.parametrize("B,H,W,grid", HIST_GEOMETRIES)
def test_half_count_equals_plain(B, H, W, grid, kind):
    """The count split among the cluster's blocks by rows and rounds (R = 2,
    and the A/B's R = 4), merged, equals the plain histograms."""
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    x = u16_planes((B, H, W), kind, np.random.default_rng(H + W))
    want = kc.tile_hists_plain(torch.from_numpy(x), gh, gw, th, tw).numpy()
    np.testing.assert_array_equal(rank_count(x, gh, gw, th, tw), want)
    np.testing.assert_array_equal(rank_count(x, gh, gw, th, tw, ranks=4), want)


@pytest.mark.parametrize("H,W", [(255, 257), (300, 512)])
@pytest.mark.parametrize("v", [40000, 40001, 65535, 0])
def test_tiles_of_equal_values_fill_one_counter(H, W, v):
    """A tile of 65535 pixels of one value (the most a 16-bit counter holds)
    and one of 153600 (two blocks, each in two rounds): one bin holds them
    all, and no 16-bit counter passes 65535."""
    x = np.full((1, H, W), v, np.uint16)
    h = rank_count(x, 1, 1, H, W)
    assert h[0, v] == H * W and h[0].sum() == H * W


def test_packed_counters_decode_as_the_merge_reads_them():
    """Each block's 16-bit counters, value v in half v & 1 of word v >> 1,
    read back as cluster_bins reads 8 bins from a 16-byte vector: every
    count returns to its value."""
    from pathlib import Path

    src = (Path(kc.__file__).parent / "csrc" / "clahe.cu").read_text()
    assert "atomicAdd(&w[v >> 1], n << ((v & 1u) << 4));" in src
    v = np.arange(65536)
    counts = np.random.default_rng(3).integers(0, 65536, 65536)
    words = np.zeros(32768, np.int64)
    np.add.at(words, v >> 1, counts << (16 * (v & 1)))
    got = np.empty(65536, np.int64)
    for i0 in range(0, 65536, 8):
        d = words[i0 // 2:i0 // 2 + 4]
        got[i0:i0 + 8:2] = d & 0xFFFF
        got[i0 + 1:i0 + 8:2] = d >> 16
    np.testing.assert_array_equal(got, counts)


# --- stages A and B in one launch: tile_luts65536 ----------------------------

# (B, H, W, grid): ragged tiles (the pad read through reflected indices),
# reflected pads wider than half a tile, one-pixel tiles, a single column
LUT16_GEOMETRIES = [(2, 37, 131, (8, 8)), (1, 5, 7, (8, 8)), (1, 8, 8, (8, 8)),
                    (1, 3, 1, (2, 2)), (1, 6, 1100, (2, 1))]


@pytest.mark.parametrize("B,H,W,grid", LUT16_GEOMETRIES)
def test_tile_luts65536_matches_jax_stages(B, H, W, grid):
    """tile_luts65536 (its plain version on the CPU) equals the JAX
    package's _tile_hists and clahe_tile_luts(hist_size=65536) at 0 LSB at
    clip 0, 2 and 40, and clahe_lut over hist65536_tiles: stages A and B
    are integer work and one pinned f32 law."""
    from imageenhancement_mp_tpu.ops import clahe as jclahe

    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    x = u16_planes((B, H, W), "random", np.random.default_rng(H + W))
    padded = np.pad(x, ((0, 0), (0, gh * th - H), (0, gw * tw - W)), mode="reflect")
    hists = np.concatenate([np.asarray(jclahe._tile_hists(p, gh, gw, th, tw, 65536))
                            for p in padded])
    staged = kc.hist65536_tiles(torch.from_numpy(x), gh, gw, th, tw)
    np.testing.assert_array_equal(staged.numpy(), hists)
    for clip in (0.0, 2.0, 40.0):
        got = kc.tile_luts65536(torch.from_numpy(x), gh, gw, th, tw, clip).numpy()
        assert got.dtype == np.uint16 and got.shape == (B * gh * gw, 65536)
        np.testing.assert_array_equal(
            got, np.asarray(jclahe.clahe_tile_luts(hists, th * tw, clip, 65536)))
        np.testing.assert_array_equal(got, kc.clahe_lut(staged, th * tw, clip).numpy())


# --- the CUDA dispatch -----------------------------------------------------

def _stub(monkeypatch):
    launches = []
    monkeypatch.setattr(kc, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kc, "launch", lambda *args: launches.append(args))
    return launches


@pytest.mark.parametrize("H,W,grid", [(64, 256, (8, 2)), (37, 131, (8, 8)), (5, 3, (2, 2))])
def test_u16_clahe_launches_the_three_kernels(monkeypatch, H, W, grid):
    launches = _stub(monkeypatch)

    def refuse(*args):
        raise AssertionError("tile_hists_plain on the CUDA branch")

    monkeypatch.setattr(kc, "tile_hists_plain", refuse)
    x = torch.zeros((2, H, W), dtype=torch.uint16)
    tc.clahe_planes(x, 2.0, grid)
    # stages A and B in one launch since the cluster kernel: two in all
    assert [a[0] for a in launches] == ["tile_luts65536", "clahe_blend"]
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    clip_abs, scale = kc.clip_and_scale(th * tw, 2.0, 65536)
    # (one round: no scratch)
    assert launches[0][4:] == (0, clip_abs, float(scale), 2, H, W, gh, gw, th, tw)
    blend = launches[1]
    pieces_ptr, npieces, maxbands, rows_ptr, nrows, chunk, band = blend[-7:]
    _, yidx, _, xidx, _ = _tables(H, W, grid)
    pieces, rows = kc.blend16_pieces(xidx), kc.blend16_rows(yidx)
    assert (npieces, nrows, chunk, band) == (len(pieces), len(rows), 0, 0)
    assert maxbands == -(-int((rows[:, 1] - rows[:, 0]).max()) // int(pieces[:, 2].min()))
    assert pieces_ptr and rows_ptr


def test_u16_blend_rejects_luts_off_16_bytes(monkeypatch):
    _stub(monkeypatch)
    x = torch.zeros((1, 64, 256), dtype=torch.uint16)
    gh, gw, th, tw = tc.tile_geometry(64, 256, (8, 2))
    t = (*tc._coord_tables(64, th, gh, x.device), *tc._coord_tables(256, tw, gw, x.device))
    buf = torch.zeros(gh * gw * 65536 + 1, dtype=torch.uint16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kc.clahe_blend(x, buf[1:].view(gh * gw, 65536), gh, gw, *t)


def test_hist65536_tiles_takes_only_u16():
    with pytest.raises(TypeError, match="uint16"):
        kc.hist65536_tiles(torch.zeros((1, 4, 4), dtype=torch.uint8), 2, 2, 2, 2)


@pytest.mark.parametrize("shape,grid", [((2, 37, 131), (8, 8)), ((1, 270, 480), (8, 8)),
                                        ((3, 5, 3), (2, 2))])
def test_u16_tile_kernels_pass_their_arguments(monkeypatch, shape, grid):
    """hist65536_tiles and tile_luts65536 each launch once with the plane
    geometry (and, for the LUTs, stage B's clip_abs and scale of the tile
    area), into an output of the tile count's rows, never through the plain
    versions."""
    launches = _stub(monkeypatch)

    def refuse(*args):
        raise AssertionError("a plain version on the CUDA branch")

    monkeypatch.setattr(kc, "tile_hists_plain", refuse)
    monkeypatch.setattr(kc, "clahe_lut_plain", refuse)
    B, H, W = shape
    x = torch.zeros(shape, dtype=torch.uint16)
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    h = kc.hist65536_tiles(x, gh, gw, th, tw)
    lut = kc.tile_luts65536(x, gh, gw, th, tw, 40.0)
    assert h.shape == lut.shape == (B * gh * gw, 65536)
    assert (h.dtype, lut.dtype) == (torch.int32, torch.uint16)
    (n1, d1, x1, o1, *a1), (n2, d2, x2, o2, *a2) = launches
    assert (n1, n2) == ("hist65536_tiles", "tile_luts65536") and x1 == x2 == x.data_ptr()
    assert (o1, o2) == (h.data_ptr(), lut.data_ptr()) and o1 % 16 == o2 % 16 == 0
    clip_abs, scale = kc.clip_and_scale(th * tw, 40.0, 65536)
    assert a1 == [B, H, W, gh, gw, th, tw]
    assert a2 == [0, clip_abs, float(scale), B, H, W, gh, gw, th, tw]  # one round: no scratch


def test_multi_round_luts_take_a_scratch(monkeypatch):
    """Tiles of more than 2 x 65535 pixels count in rounds: tile_luts65536
    hands the kernel an int32 scratch of the tiles' bins (16-byte aligned,
    no fill) for the earlier rounds' sums; hist65536_tiles sums into its
    output."""
    launches = _stub(monkeypatch)
    x = torch.zeros((2, 1080, 1920), dtype=torch.uint16)
    gh, gw, th, tw = tc.tile_geometry(1080, 1920, (2, 2))
    assert kc.tile16_rounds(th, tw) == 4
    kc.tile_luts65536(x, gh, gw, th, tw, 2.0)
    kc.hist65536_tiles(x, gh, gw, th, tw)
    (_, _, _, _, scratch, *_), (_, _, _, out, *rest) = launches
    assert scratch and scratch % 16 == 0 and len(rest) == 7


def test_cluster_shape_of_the_u16_tile_kernel():
    """The launch the tests' mirrors model: a cluster of kHist16Ranks
    blocks of kHist16Threads threads a tile, tiles on the grid's x axis and
    the ranks on its y axis, rounds of at most 65535 pixels a block."""
    from pathlib import Path

    src = (Path(kc.__file__).parent / "csrc" / "clahe.cu").read_text()
    assert f"constexpr int kHist16Ranks = {RANKS};" in src and kc.HIST16_RANKS == RANKS
    assert f"constexpr int kHist16Threads = {THREADS};" in src
    kernel = src[src.index("hist65536_tiles_kernel(const uint16_t*"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "__cluster_dims__(1, kHist16Ranks, 1)" in src
    assert "const dim3 grid(unsigned(B * gh * gw), kHist16Ranks);" in src
    assert "kRoundPixels = 65535;" in src and kc.ROUND_PIXELS == 65535
    # a barrier after each round's count and after each earlier round's
    # merge; every exit after cluster_arrive and cluster_wait
    assert kernel.count("cluster.sync();") == 2
    assert kernel.count("cluster_arrive();") == kernel.count("cluster_wait();") == 2
    assert "atomicAdd(cg::this_cluster()" not in src  # no atomic leaves its block


def test_u16_tile_kernels_check_their_inputs():
    x = torch.zeros((1, 8, 8), dtype=torch.uint16)
    with pytest.raises(TypeError, match="uint16"):
        kc.tile_luts65536(x.to(torch.uint8), 2, 2, 4, 4, 2.0)
    with pytest.raises(ValueError, match="do not cover"):
        kc.tile_luts65536(x, 2, 2, 3, 4, 2.0)
    with pytest.raises(ValueError, match="overflow"):
        kc.tile_luts65536(x, 1, 1, 2**16, 2**16, 2.0)  # th * tw: the int32 cdf
    with pytest.raises(ValueError):
        kc.tile_luts65536(x.to("meta"), 2, 2, 4, 4, 2.0)
