"""NumPy mirrors of the walks of K1's two counting kernels
(csrc/hist.cu::hist256, csrc/clahe.cu::hist256_tiles), which count through
csrc/hist_count.cuh.  The kernels cannot run here; these mirrors follow
their index arithmetic step by step and are held to the plain versions and
to the JAX package's K1 (``hist256_pallas`` in interpret mode) and its
``_tile_hists``.

* The tile walk: which rows and columns each block's body vectors, head and
  tail bytes and pad loop read, for every tile, band, warp and lane, over
  geometries with odd W and tw, tw < 16, tiles not 16-aligned, pads deeper
  than one reflection, 1x1 tiles, a one-row plane, gw·tw > W with W = 1, and
  planes at several 16-byte alignments.  Every padded position of every tile
  is read exactly once, every body vector is a 16-byte aligned load inside
  its source row, and the histograms equal the plain version and JAX's at
  0 LSB.
* The plane walk of hist256: head, tail and grid-strided body vectors cover
  the plane once, each vector an aligned load.
* The band plan of hist256_tiles keeps every band within its tile and
  ``grid_y`` within 65535 (the wrappers' launches on [70000, 8, 8] and
  [1, 2_200_000, 8]: tests/test_torch_row_caps.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu.kernels.hist import hist256_pallas
from imageenhancement_mp_tpu.ops import clahe as jclahe
from imageenhancement_mp_tpu_torch.kernels import clahe as kclahe
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.ops.clahe import tile_geometry

THREADS, WARPS = 256, 8


def reflect101(i: int, n: int) -> int:
    """csrc/reflect.cuh::reflect101."""
    if 0 <= i < n:
        return i
    if n == 1:
        return 0
    m = 2 * (n - 1)
    i %= m
    return m - i if i >= n else i


def split(addr: int, length: int) -> tuple[int, int]:
    """``(head, nv)`` of ``length`` bytes at address ``addr``: bytes up to
    the first 16-byte boundary (at most ``length``), then whole vectors."""
    head = min((16 - addr % 16) % 16, length)
    return head, (length - head) >> 4


# --- hist256_tiles ----------------------------------------------------------

def tile_walk(B, H, W, gh, gw, th, tw, base):
    """Run hist256_tiles_kernel's index arithmetic for every block, warp and
    lane with the plane at address ``base``.  Returns the padded positions
    each tile read, as ``reads[b, R, C]`` counts with each read checked to lie
    in its own tile, and the source bytes each tile read (for its
    histogram)."""
    band_rows, bands, grid_y = kclahe.tile_band_plan(B, gh, gw, th, tw)
    assert 1 <= grid_y <= min(bands, 65535)
    assert (bands - 1) * band_rows < th <= bands * band_rows
    reads = np.zeros((B, gh * th, gw * tw), np.int64)
    sources = [[] for _ in range(B * gh * gw)]
    for tile in range(B * gh * gw):
        b, t = divmod(tile, gh * gw)
        ty, tx = divmod(t, gw)
        plane = base + b * H * W
        c0 = tx * tw
        length = max(min(c0 + tw, W) - c0, 0)
        cp = max(c0, W)
        npad = c0 + tw - cp
        ragged = (plane + c0) % 16 != 0 or (W | length) % 16 != 0 or npad > 0

        def read(R, C, sy, sx):
            assert R // th == ty and C // tw == tx
            reads[b, R, C] += 1
            sources[tile].append((b, sy, sx))

        for by in range(grid_y):
            for band in range(by, bands, grid_y):
                R0 = ty * th + band * band_rows
                nrows = min(band_rows, th - band * band_rows)

                def row_body(q):
                    sy = reflect101(R0 + q, H)
                    head, nv = split(plane + sy * W + c0, length)
                    return sy, c0 + head, nv

                # each lane's stream of body vectors: row q, vector j
                for tid in range(THREADS):
                    q, j = tid // 32, tid % 32
                    row = row_body(q) if q < nrows else None
                    while q < nrows and j >= row[2]:
                        j -= row[2]
                        q += WARPS
                        if q < nrows:
                            row = row_body(q)
                    while q < nrows:
                        sy, col, nv = row
                        assert 0 <= j < nv
                        first = col + 16 * j
                        assert (plane + sy * W + first) % 16 == 0  # a uint4 load
                        assert c0 <= first and first + 16 <= min(c0 + tw, W)
                        for C in range(first, first + 16):
                            read(R0 + q, C, sy, C)
                        j += 32
                        while q < nrows and j >= row[2]:
                            j -= row[2]
                            q += WARPS
                            if q < nrows:
                                row = row_body(q)
                # head, tail and pad, one row per warp iteration
                for warp in range(WARPS):
                    for r in range(warp, nrows if ragged else 0, WARPS):
                        sy = reflect101(R0 + r, H)
                        head, nv = split(plane + sy * W + c0, length)
                        tail0 = head + 16 * nv
                        for lane in range(32):
                            if lane < 16:
                                if lane < head:
                                    read(R0 + r, c0 + lane, sy, c0 + lane)
                            elif tail0 + lane - 16 < length:
                                C = c0 + tail0 + lane - 16
                                read(R0 + r, C, sy, C)
                            for k in range(lane, npad, 32):
                                read(R0 + r, cp + k, sy, reflect101(cp + k, W))
    return reads, sources


# (shape, grid): W and tw odd with tw < 16; tiles off 16-byte boundaries;
# pads deeper than one reflection; 1x1 tiles; a one-row plane; gw·tw > W with
# W = 1; wide tiles (more vectors per row than lanes); config 5's 8x8 grid on
# a quarter-size plane; bands over tall tiles; tiles of whole aligned rows,
# which skip the head/tail loop
TILE_GEOMETRIES = [
    ((1, 20, 27), (4, 3)),      # W 27, tw 9
    ((2, 13, 45), (2, 5)),      # tw 9, odd H
    ((1, 37, 131), (8, 8)),     # tw 17
    ((1, 3, 2), (8, 8)),        # th = tw = 1: pads of 5 rows and 6 columns
    ((1, 5, 7), (3, 8)),        # pad columns deeper than the plane
    ((1, 8, 8), (8, 8)),        # 1x1 tiles
    ((2, 1, 40), (2, 4)),       # a one-row plane
    ((1, 5, 1), (3, 8)),        # W = 1, gw·tw = 8
    ((1, 6, 1100), (2, 1)),     # 69 vectors a row
    ((1, 68, 120), (8, 8)),     # 4K's tile shape at a quarter: tw 15
    ((1, 135, 480), (8, 8)),    # tw 60, th 17
    ((1, 300, 16), (1, 1)),     # aligned rows, bands of one tile
    ((2, 37, 128), (8, 8)),     # aligned rows (at base 0) and 3 pad rows
    ((1, 1, 1), (8, 8)),
    ((3, 11, 33), (2, 2)),
]


def _padded_tile_stack(x, gh, gw, th, tw):
    B, H, W = x.shape
    padded = np.pad(x, ((0, 0), (0, gh * th - H), (0, gw * tw - W)), mode="reflect")
    stack = padded.reshape(B, gh, th, gw, tw).transpose(0, 1, 3, 2, 4).reshape(B * gh * gw, th * tw)
    return padded, stack


@pytest.mark.parametrize("base", [0, 1, 7])
@pytest.mark.parametrize("shape,grid", TILE_GEOMETRIES, ids=[f"{s}-{g}" for s, g in TILE_GEOMETRIES])
def test_tile_walk_reads_each_padded_position_once(shape, grid, base):
    B, H, W = shape
    gh, gw, th, tw = tile_geometry(H, W, grid)
    reads, sources = tile_walk(B, H, W, gh, gw, th, tw, base)
    np.testing.assert_array_equal(reads, 1)

    x = np.random.default_rng(70 + base).integers(0, 256, shape, dtype=np.uint8)
    got = np.stack([np.bincount([x[b, sy, sx] for b, sy, sx in src], minlength=256)
                    for src in sources]).astype(np.int32)
    plain = kclahe.tile_hists_plain(torch.from_numpy(x), gh, gw, th, tw).numpy()
    np.testing.assert_array_equal(got, plain)
    padded, stack = _padded_tile_stack(x, gh, gw, th, tw)
    np.testing.assert_array_equal(got, np.asarray(hist256_pallas(jnp.asarray(stack), interpret=True)))
    jax_hists = np.concatenate([np.asarray(jclahe._tile_hists(jnp.asarray(p), gh, gw, th, tw, 256))
                                for p in padded])
    np.testing.assert_array_equal(got, jax_hists)


@pytest.mark.parametrize("kind", ["constant", "two-valued"])
def test_tile_hists_on_flat_planes(kind):
    """The plain version and JAX agree on the planes that send every lane
    to one bin (the kernel's worst case for atomics)."""
    shape, grid = (2, 37, 131), (8, 8)
    gh, gw, th, tw = tile_geometry(shape[1], shape[2], grid)
    x = np.full(shape, 255, np.uint8)
    if kind == "two-valued":
        x[:, ::2] = 0
    plain = kclahe.tile_hists_plain(torch.from_numpy(x), gh, gw, th, tw).numpy()
    _, stack = _padded_tile_stack(x, gh, gw, th, tw)
    np.testing.assert_array_equal(plain, np.asarray(hist256_pallas(jnp.asarray(stack), interpret=True)))
    assert (plain.sum(axis=1) == th * tw).all()


# --- hist256 ----------------------------------------------------------------

def plane_walk(n, base, blocks):
    """hist256_kernel's walk of one plane of ``n`` bytes at address ``base``
    by ``blocks`` blocks: how often each byte was read."""
    reads = np.zeros(n, np.int64)
    head, nvec = split(base, n)
    tail0 = head + 16 * nvec
    stride = blocks * THREADS
    for g in range(blocks * THREADS):
        for i in range(g, nvec, stride):
            assert (base + head + 16 * i) % 16 == 0
            reads[head + 16 * i:head + 16 * i + 16] += 1
        reads[np.arange(g, head, stride)] += 1
        reads[np.arange(tail0 + g, n, stride)] += 1
    return reads


@pytest.mark.parametrize("base", [0, 1, 9, 15])
@pytest.mark.parametrize("B,n", [(1, 1), (1, 15), (2, 17), (3, 1000), (8, 4847), (1, 70_000),
                                 (2, 2_073_600), (70000, 64)])
def test_plane_walk_covers_each_byte_once(B, n, base):
    blocks, grid_y = khist.hist256_plan(B, n)
    assert 1 <= blocks and 1 <= grid_y <= min(B, 65535)
    if n > 100_000:  # a large plane: the walk of a few of its blocks
        blocks = min(blocks, 3)
    np.testing.assert_array_equal(plane_walk(n, base, blocks), 1)


def test_hist256_plain_matches_jax_on_flat_and_random_planes():
    rng = np.random.default_rng(71)
    x = np.stack([np.full((37, 131), 255, np.uint8), np.zeros((37, 131), np.uint8),
                  rng.integers(0, 256, (37, 131), dtype=np.uint8),
                  np.where(rng.integers(0, 2, (37, 131)) == 1, 255, 0).astype(np.uint8)])
    np.testing.assert_array_equal(khist.hist256_plain(torch.from_numpy(x)).numpy(),
                                  np.asarray(hist256_pallas(jnp.asarray(x), interpret=True)))


# --- the host's band plan -------------------------------------------------------

@pytest.mark.parametrize("B,gh,gw,th,tw", [(70000, 8, 8, 1, 1), (1, 8, 8, 275_000, 1),
                                           (1, 1, 1, 2_200_000, 8), (1, 1, 1, 2**31 // 8 - 1, 8),
                                           (2, 8, 8, 270, 480), (1, 2, 2, 40_000, 50_000)])
def test_tile_band_plan_bounds(B, gh, gw, th, tw):
    band_rows, bands, grid_y = kclahe.tile_band_plan(B, gh, gw, th, tw)
    assert (bands - 1) * band_rows < th <= bands * band_rows
    assert 1 <= grid_y <= min(bands, 65535)
    assert band_rows * tw <= kclahe.TILE_BLOCK_PX + tw
