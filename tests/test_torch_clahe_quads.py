"""The u8 CLAHE blend kernel's plan and arithmetic (``csrc/clahe.cu``,
``clahe_blend_u8_kernel``), on the CPU.

* ``blend_chunk`` / ``blend_band`` over many geometries (tiles of 1×1, a grid
  larger than the image, ragged W and H, 1080p, 4K, (2, 2) on 164×164, grids
  of 64 and 4000 columns): every pixel falls in exactly one block, every
  chunk touches at most 16 column cells, and ``column_cells`` names the four
  LUTs each column blends.
* A NumPy mirror of the kernel's walk (per block and row: the quad tables of
  the chunk's cells, each word ``l00 | l01 << 8 | l10 << 16 | l11 << 24``;
  per pixel one table read, the entries as ``0x4B000000 | v`` minus 2^23,
  the blend in f32, the byte as the low bits of ``r + 2^23``) equals
  ``clahe_blend_plain`` at 0 LSB, with random LUTs over the whole byte range.
* The CUDA branch (``on_cuda`` and ``launch`` stubbed) passes the plan to the
  C entry point, derives it once per coordinate table (a square plane's rows
  and columns share one), and rejects LUTs that are not 4-byte aligned.
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu_torch.kernels import clahe as kc
from imageenhancement_mp_tpu_torch.ops import clahe as tc

GEOMETRIES = [  # (H, W, grid)
    (8, 8, (8, 8)), (5, 7, (8, 8)), (1, 1, (8, 8)), (2, 3, (2, 2)), (164, 164, (2, 2)),
    (37, 131, (8, 8)), (1079, 1917, (8, 8)), (1080, 1920, (8, 8)), (2160, 3840, (8, 8)),
    (64, 3840, (1, 64)), (100, 4000, (3, 64)), (40, 5000, (2, 4000)), (30, 256, (2, 2)),
    (17, 33, (17, 33)), (3, 1, (2, 2)), (2200, 8, (8, 8)),
]
MIRROR = [g for g in GEOMETRIES if g[0] * g[1] <= 200_000]


def _plan(H, W, grid):
    gh, gw, th, tw = tc.tile_geometry(H, W, grid)
    xi0, xi1, _ = tc._interp_coords(W, tw, gw)
    yi0, yi1, _ = tc._interp_coords(H, th, gh)
    xidx, yidx = np.stack([xi0, xi1]), np.stack([yi0, yi1])
    return (gh, gw, th, tw), xidx, yidx, kc.blend_chunk(xidx, gw), kc.blend_band(yidx)


@pytest.mark.parametrize("H,W,grid", GEOMETRIES)
def test_plan_covers_each_pixel_once_within_the_budget(H, W, grid):
    (gh, gw, th, tw), xidx, yidx, chunk, band = _plan(H, W, grid)
    assert chunk % kc.BLEND_PX == 0 and kc.BLEND_PX <= chunk <= kc.BLEND_MAX_CHUNK
    assert 1 <= band <= kc.BLEND_MAX_BAND
    cells = kc.column_cells(xidx[0], xidx[1], gw)
    assert (np.diff(cells) >= 0).all()
    cover = np.zeros((H, W), np.int32)
    for c0 in range(0, W, chunk):  # the grid's x axis
        c1 = min(c0 + chunk, W)
        assert cells[c1 - 1] - cells[c0] + 1 <= kc.BLEND_MAX_CELLS
        for y0 in range(0, H, band):  # the grid's y axis, per plane
            cover[y0:y0 + band, c0:c1] += 1
    assert (cover == 1).all()
    # each column's cell names its two neighbour tiles
    np.testing.assert_array_equal(np.clip(cells - 1, 0, gw - 1), xidx[0])
    np.testing.assert_array_equal(np.minimum(cells, gw - 1), xidx[1])
    rows = kc.column_cells(yidx[0], yidx[1], gh)
    np.testing.assert_array_equal(np.clip(rows - 1, 0, gh - 1), yidx[0])
    np.testing.assert_array_equal(np.minimum(rows, gh - 1), yidx[1])


def test_plan_at_4k_uses_the_widest_chunks():
    _, _, _, chunk, band = _plan(2160, 3840, (8, 8))
    assert (chunk, band) == (kc.BLEND_MAX_CHUNK, kc.BLEND_MAX_BAND)
    _, _, _, chunk, band = _plan(64, 3840, (1, 64))  # 60-column tiles: chunks shrink
    assert chunk < kc.BLEND_MAX_CHUNK and band == kc.BLEND_MAX_BAND
    _, _, _, chunk, band = _plan(8, 8, (8, 8))  # 1x1 tiles: one-row bands
    assert (chunk, band) == (16, 1)


def _as_f32(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint32).view(np.float32)


TWO23 = np.float32(8388608.0)


def quad_mirror(x, luts, gh, gw, yidx, fy, xidx, fx, chunk, band):
    """The kernel's walk in NumPy: ``x`` [B, H, W] u8, ``luts`` [B·gh·gw,
    256] u8 → u8 [B, H, W]."""
    B, H, W = x.shape
    out = np.zeros_like(x)
    cells = kc.column_cells(xidx[0], xidx[1], gw)
    for b in range(B):
        lb = luts[b * gh * gw:(b + 1) * gh * gw].astype(np.uint32)
        for c0 in range(0, W, chunk):
            c1 = min(c0 + chunk, W)
            cell0, ncells = cells[c0], cells[c1 - 1] - cells[c0] + 1
            local = cells[c0:c1] - cell0
            f = fx[c0:c1]
            g = np.float32(1.0) - f
            for ya in range(0, H, band):
                for y in range(ya, min(ya + band, H)):
                    y0, y1 = int(yidx[0, y]), int(yidx[1, y])
                    quads = np.empty((ncells, 256), np.uint32)
                    for j in range(ncells):
                        c = cell0 + j
                        t0, t1 = min(max(c - 1, 0), gw - 1), min(c, gw - 1)
                        quads[j] = (lb[y0 * gw + t0] | lb[y0 * gw + t1] << 8
                                    | lb[y1 * gw + t0] << 16 | lb[y1 * gw + t1] << 24)
                    w = quads[local, x[b, y, c0:c1]]
                    e = [_as_f32(0x4B000000 | ((w >> s) & 0xFF)) - TWO23 for s in (0, 8, 16, 24)]
                    top = g * e[0] + f * e[1]
                    bot = g * e[2] + f * e[3]
                    r = (np.float32(1.0) - fy[y]) * top + fy[y] * bot
                    r = np.minimum(np.maximum(r, np.float32(0)), np.float32(255))
                    out[b, y, c0:c1] = ((r + TWO23).view(np.uint32) & 0xFF).astype(np.uint8)
    return out


@pytest.mark.parametrize("H,W,grid", MIRROR)
def test_quad_mirror_equals_plain(H, W, grid):
    (gh, gw, th, tw), xidx, yidx, chunk, band = _plan(H, W, grid)
    rng = np.random.default_rng(H * 7 + W)
    B = 2
    x = rng.integers(0, 256, (B, H, W), dtype=np.uint8)
    luts = rng.integers(0, 256, (B * gh * gw, 256), dtype=np.uint8)
    yt, fyt = tc._coord_tables(H, th, gh, torch.device("cpu"))
    xt, fxt = tc._coord_tables(W, tw, gw, torch.device("cpu"))
    want = kc.clahe_blend_plain(torch.from_numpy(x), torch.from_numpy(luts), gh, gw, yt, fyt,
                                xt, fxt).numpy()
    got = quad_mirror(x, luts, gh, gw, yidx, fyt.numpy(), xidx, fxt.numpy(), chunk, band)
    np.testing.assert_array_equal(got, want)


def test_quad_mirror_equals_plain_on_real_luts():
    """CLAHE's own LUTs (stage A and B) on a 4K-shaped crop, grid 8x8."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 256, (1, 270, 480), dtype=np.uint8))
    gh, gw, th, tw = tc.tile_geometry(270, 480, (8, 8))
    luts = kc.clahe_lut(kc.hist256_tiles(x, gh, gw, th, tw), th * tw, 2.0)
    yt, fyt = tc._coord_tables(270, th, gh, torch.device("cpu"))
    xt, fxt = tc._coord_tables(480, tw, gw, torch.device("cpu"))
    want = kc.clahe_blend_plain(x, luts, gh, gw, yt, fyt, xt, fxt).numpy()
    got = quad_mirror(x.numpy(), luts.numpy(), gh, gw, yt.numpy(), fyt.numpy(), xt.numpy(),
                      fxt.numpy(), kc.blend_chunk(xt.numpy(), gw), kc.blend_band(yt.numpy()))
    np.testing.assert_array_equal(got, want)


def _stub(monkeypatch):
    launches = []
    monkeypatch.setattr(kc, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kc, "launch", lambda *args: launches.append(args))
    return launches


@pytest.mark.parametrize("H,W,grid", [(64, 256, (8, 2)), (2160, 3840, (8, 8)), (8, 8, (8, 8))])
def test_cuda_branch_passes_the_plan(monkeypatch, H, W, grid):
    launches = _stub(monkeypatch)
    x = torch.zeros((2, H, W), dtype=torch.uint8)
    tc.clahe_planes(x, 2.0, grid)
    blends = [a for a in launches if a[0] == "clahe_blend"]
    assert len(blends) == 1
    *_, chunk, band = blends[0]
    _, _, _, want_chunk, want_band = _plan(H, W, grid)
    assert (chunk, band) == (want_chunk, want_band)


def test_cuda_branch_u16_and_alignment(monkeypatch):
    launches = _stub(monkeypatch)
    x16 = torch.zeros((1, 64, 256), dtype=torch.uint16)
    gh, gw, th, tw = tc.tile_geometry(64, 256, (8, 2))
    tables = (*tc._coord_tables(64, th, gh, x16.device), *tc._coord_tables(256, tw, gw, x16.device))
    kc.clahe_blend(x16, torch.zeros((gh * gw, 65536), dtype=torch.uint16), gh, gw, *tables)
    assert launches[-1][-2:] == (0, 0)  # the u8 plan: the u16 kernel takes its own
    x8 = torch.zeros((1, 64, 256), dtype=torch.uint8)
    buf = torch.zeros(gh * gw * 256 + 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="4-byte aligned"):
        kc.clahe_blend(x8, buf[1:].view(gh * gw, 256), gh, gw, *tables)


def test_cuda_branch_derives_the_plan_once_per_table(monkeypatch):
    """A square plane shares one coordinate table between rows and columns;
    the chunk and the band are still each derived once, not once per call."""
    launches = _stub(monkeypatch)
    calls = []
    for name in ("blend_chunk", "blend_band"):
        fn = getattr(kc, name)
        monkeypatch.setattr(kc, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    tc._coord_tables.cache_clear()  # tables no earlier test derived a plan from
    x = torch.zeros((1, 164, 164), dtype=torch.uint8)
    for _ in range(3):
        tc.clahe_planes(x, 2.0, (2, 2))
    assert sorted(calls) == ["blend_band", "blend_chunk"]
    assert len([a for a in launches if a[0] == "clahe_blend"]) == 3
