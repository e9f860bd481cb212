"""CLAHE: ``cv2.createCLAHE(clip, grid).apply`` on u8 and u16 planes.

The counterpart of the JAX package's ``ops/clahe.py``, with ONE route
for every geometry: stage A (per-tile histograms) → stage B (clipped tile
LUTs) → stage C (bilinear blend of the four neighbour LUTs), the kernels of
``kernels/clahe.py``; stages A and B are one launch (``tile_luts256`` for
u8, ``tile_luts65536`` for u16), so a call makes two.  The JAX package switches between a quadrant kernel, a
nine-LUT kernel and an XLA gather by divisibility and tile split; the port
has no such switch, so the quadrant guard's fault on some divisible
geometries (ROADMAP R2) has no counterpart here.

cv2's laws, as the JAX package and ``ref/`` pin them:
  * when a dimension does not divide by the grid, BOTH dimensions are padded
    at the bottom/right by ``tiles − size % tiles`` with REFLECT_101; stage A
    reads the pad through reflected indices, and stage C blends the unpadded
    pixels with the padded tile size;
  * interpolation coordinates are ``y·f32(1/tile) − 0.5`` in f32, with the
    fractions taken before the tile indices are clamped
    (:func:`_interp_coords`, a verbatim copy);
  * ``clipAbs = max(int(clip·area/S), 1)``, and the residual goes +1 to bins
    ``0, step, 2·step, …``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.clahe import (
    HIST_SIZE,
    clahe_blend,
    clahe_lut,
    tile_luts256,
    tile_luts65536,
)

__all__ = ["clahe_planes", "clahe_tile_luts", "blend_tile_luts", "tile_geometry", "coord_rows"]


def _interp_coords(n: int, tile: int, ntiles: int):
    """Host-side (static) bilinear coords: idx0, idx1, frac per pixel row/col."""
    # mirror cv2's f32 evaluation: txf = x * (1.0f/tile) - 0.5f
    inv = np.float32(1.0) / np.float32(tile)
    f = np.arange(n, dtype=np.float32) * inv - np.float32(0.5)
    i0f = np.floor(f).astype(np.int64)
    frac = (f - i0f).astype(np.float32)
    i0 = np.clip(i0f, 0, ntiles - 1).astype(np.int32)
    i1 = np.clip(i0f + 1, 0, ntiles - 1).astype(np.int32)
    return i0, i1, frac


@functools.lru_cache(maxsize=64)
def _coord_tables(n: int, tile: int, ntiles: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_interp_coords` as ``([2, n] int32 (i0; i1), [n] f32)`` tensors
    on ``device``, uploaded once per geometry."""
    i0, i1, frac = _interp_coords(n, tile, ntiles)
    return (torch.from_numpy(np.stack([i0, i1])).to(device),
            torch.from_numpy(frac).to(device))


@functools.lru_cache(maxsize=64)
def coord_rows(n: int, tile: int, ntiles: int, start: int, count: int,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Entries ``[start, start + count)`` of :func:`_coord_tables`, as
    contiguous tensors made once per geometry and slice: the rows of a
    shard of a row-sharded frame, so the blend's plans, derived once per
    table, are derived once per shard."""
    idx, frac = _coord_tables(n, tile, ntiles, device)
    return (idx[:, start:start + count].contiguous(),
            frac[start:start + count].contiguous())


def tile_geometry(H: int, W: int, tile_grid: tuple[int, int]) -> tuple[int, int, int, int]:
    """``(gh, gw, th, tw)``: cv2's tile size, on the padded image when a
    dimension does not divide."""
    gh, gw = (int(g) for g in tile_grid)
    if gh < 1 or gw < 1:
        raise ValueError(f"tile_grid must be positive, got {tile_grid}")
    if H % gh == 0 and W % gw == 0:
        return gh, gw, H // gh, W // gw
    return gh, gw, (H + gh - H % gh) // gh, (W + gw - W % gw) // gw


def clahe_tile_luts(hists: torch.Tensor, area: int, clip_limit: float) -> torch.Tensor:
    """Stage B: ``[T, S]`` int32 tile histograms → ``[T, S]`` LUTs, u8 for
    S = 256 and u16 for S = 65536 (``kernels/clahe.py::clahe_lut``)."""
    return clahe_lut(hists.contiguous(), area, clip_limit)


def blend_tile_luts(planes: torch.Tensor, luts: torch.Tensor, gh: int, gw: int, th: int,
                    tw: int) -> torch.Tensor:
    """Stage C: ``[B, H, W]`` planes through their ``[B·gh·gw, S]`` tile LUTs
    with the exact CLAHE bilinear weights of ``th × tw`` tiles."""
    B, H, W = planes.shape
    yidx, fy = _coord_tables(H, th, gh, planes.device)
    xidx, fx = _coord_tables(W, tw, gw, planes.device)
    return clahe_blend(planes.contiguous(), luts.contiguous(), gh, gw, yidx, fy, xidx, fx)


def clahe_planes(planes: torch.Tensor, clip_limit: float = 40.0,
                 tile_grid: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """``cv2.createCLAHE`` on uint8/uint16 planes ``[B, H, W]`` — exact.
    ``tile_grid`` is (rows, cols); uint16 uses cv2's 65536-bin histogram."""
    if planes.dtype not in HIST_SIZE:
        raise TypeError(f"CLAHE supports uint8/uint16 (cv2 parity), got {planes.dtype}")
    planes = planes.contiguous()
    B, H, W = planes.shape
    gh, gw, th, tw = tile_geometry(H, W, tile_grid)
    tile_luts = tile_luts256 if planes.dtype == torch.uint8 else tile_luts65536
    luts = tile_luts(planes, gh, gw, th, tw, float(clip_limit))
    return blend_tile_luts(planes, luts, gh, gw, th, tw)
