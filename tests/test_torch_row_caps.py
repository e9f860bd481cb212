"""No row cap in the kernel wrappers (ROADMAP Queue 3, P3).

The JAX package and the port's plain path take planes of any height; the
kernels must too.  A CUDA kernel cannot run here, so each wrapper is driven
down its CUDA branch on a CPU tensor: its module's ``on_cuda`` answers True
and its ``launch`` only records the call.  A ``[1, 1_100_000, 8]`` u8 plane
(8.8 MB) is taller than 65535 tiles of 16 rows (median) or bands of 8 rows
(clahe_blend), the grid-axis limit the kernels once put rows on (the LUT
kernels take flat planes: tests/test_torch_lut.py drives them); the wrapper
must neither raise nor launch more than once; u16 CLAHE's stage A and
blend take the same plane as u16.  K1's two counting kernels
(hist256, hist256_tiles) take their grid from the host; its plan keeps
``gridDim.y`` within 65535 on ``[70000, 8, 8]`` and ``[1, 2_200_000, 8]``.
"""

import pytest
import torch

from imageenhancement_mp_tpu_torch.kernels import athresh as kathresh
from imageenhancement_mp_tpu_torch.kernels import bilateral as kbilateral
from imageenhancement_mp_tpu_torch.kernels import clahe as kclahe
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.kernels import fused as kfused
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.kernels import median as kmedian
from imageenhancement_mp_tpu_torch.kernels import warp as kwarp
from imageenhancement_mp_tpu_torch.ops import clahe as tclahe
from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_tables
from imageenhancement_mp_tpu_torch.ops.threshold import gaussian_taps

TALL = (1, 1_100_000, 8)


def _median(x):
    return kmedian.median_blur(x, 5)


def _clahe_blend(x):
    B, H, W = x.shape
    gh, gw, th, tw = tclahe.tile_geometry(H, W, (8, 8))
    luts = torch.zeros((B * gh * gw, 256), dtype=torch.uint8)
    tables = (*tclahe._coord_tables(H, th, gh, x.device),
              *tclahe._coord_tables(W, tw, gw, x.device))
    return kclahe.clahe_blend(x, luts, gh, gw, *tables)


def _sep_conv(x):
    return kconv.sep_conv_u8(x, (16, 64, 96, 64, 16), (16, 64, 96, 64, 16), 1.0)


def _bilateral(x):
    offsets, lut, r = bilateral_tables(9, 75.0, 75.0, 1, x.device)
    return kbilateral.bilateral_gray(x, offsets, lut, r)


def _athresh(x):
    return kathresh.adaptive_threshold_gaussian(x, gaussian_taps(11, x.device), 255, 2, False)


def _warp_gather(x):
    B, H, W = x.shape
    sy, sx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    return kwarp.warp_gather_u8(x, sx.contiguous(), sy.contiguous())


def _warp_matrix(x):
    B, H, W = x.shape
    return kwarp.warp_matrix_u8(x, [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], H, W)


def _median_unsharp(x):
    return kfused.median_unsharp(x, 5, 1.0, 5)


@pytest.mark.parametrize("module,name,run", [
    (kmedian, "median", _median),
    (kclahe, "clahe_blend", _clahe_blend),
    (kconv, "sep_conv_u8", _sep_conv),
    (kbilateral, "bilateral", _bilateral),
    (kathresh, "athresh", _athresh),
    (kwarp, "warp_gather_u8", _warp_gather),
    (kwarp, "warp_gather_u8", _warp_matrix),
    (kfused, "median_unsharp", _median_unsharp),
], ids=["median", "clahe_blend", "sep_conv_u8", "bilateral", "athresh", "warp_gather_u8",
        "warp_gather_u8_matrix", "median_unsharp"])
def test_tall_plane_reaches_one_launch(monkeypatch, module, name, run):
    launches = []
    monkeypatch.setattr(module, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(module, "launch", lambda *args: launches.append(args))
    x = torch.zeros(TALL, dtype=torch.uint8)
    out = run(x)
    assert out.shape == TALL and out.dtype == torch.uint8
    assert len(launches) == 1
    kernel, device, *args = launches[0]
    assert kernel == name and device == x.device
    assert TALL[1] in args  # the full height reaches the C entry point


def _hist65536_tiles(x):
    B, H, W = x.shape
    return kclahe.hist65536_tiles(x, *tclahe.tile_geometry(H, W, (8, 8)))


def _tile_luts65536(x):
    B, H, W = x.shape
    return kclahe.tile_luts65536(x, *tclahe.tile_geometry(H, W, (8, 8)), 2.0)


def _clahe_blend_u16(x):
    B, H, W = x.shape
    gh, gw, th, tw = tclahe.tile_geometry(H, W, (8, 8))
    luts = torch.zeros((B * gh * gw, 65536), dtype=torch.uint16)
    tables = (*tclahe._coord_tables(H, th, gh, x.device),
              *tclahe._coord_tables(W, tw, gw, x.device))
    return kclahe.clahe_blend(x, luts, gh, gw, *tables)


@pytest.mark.parametrize("name,run,out_shape", [
    ("hist65536_tiles", _hist65536_tiles, (64, 65536)),
    ("clahe_blend", _clahe_blend_u16, TALL),
    ("tile_luts65536", _tile_luts65536, (64, 65536)),
], ids=["hist65536_tiles", "clahe_blend_u16", "tile_luts65536"])
def test_u16_tall_plane_reaches_one_launch(monkeypatch, name, run, out_shape):
    """u16 CLAHE's kernels on a [1, 1_100_000, 8] u16 plane: one launch
    with the full height; the blend's plan puts (plane, row cell) pairs on
    the grid's y axis and at most 2^31 - 1 blocks on its x axis."""
    launches = []
    monkeypatch.setattr(kclahe, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kclahe, "launch", lambda *args: launches.append(args))
    x = torch.zeros(TALL, dtype=torch.uint16)
    out = run(x)
    assert tuple(out.shape) == out_shape
    assert len(launches) == 1
    kernel, device, *args = launches[0]
    assert kernel == name and device == x.device and TALL[1] in args
    if name == "clahe_blend":
        _, npieces, maxbands, _, nrows, chunk, band = args[-7:]
        assert (chunk, band) == (0, 0) and npieces * maxbands < 2**31 and nrows <= 9


@pytest.mark.parametrize("shape,grid", [((70000, 8, 8), (1, 1)), ((1, 2_200_000, 8), (8, 8))])
def test_grid_plans_stay_within_a_grid_axis(monkeypatch, shape, grid):
    launches = []
    for module in (khist, kclahe):
        monkeypatch.setattr(module, "on_cuda", lambda t, what: True)
        monkeypatch.setattr(module, "launch", lambda *args: launches.append(args))
    x = torch.zeros(shape, dtype=torch.uint8)
    B, H, W = shape
    gh, gw, th, tw = tclahe.tile_geometry(H, W, grid)
    assert khist.hist256(x).shape == (B, 256)
    assert kclahe.hist256_tiles(x, gh, gw, th, tw).shape == (B * gh * gw, 256)
    (name, _, _, _, b, n, blocks, grid_y, _, _), tiles = launches
    assert name == "hist256" and (b, n) == (B, H * W)
    assert 1 <= blocks <= khist.HIST_GRID_BLOCKS and 1 <= grid_y <= min(B, 65535)
    assert tiles[0] == "hist256_tiles" and tiles[4:11] == (B, H, W, gh, gw, th, tw)
    band_rows, bands, grid_y = tiles[11:14]
    assert (bands - 1) * band_rows < th <= bands * band_rows
    assert 1 <= grid_y <= min(bands, 65535) and B * gh * gw < 2**31
