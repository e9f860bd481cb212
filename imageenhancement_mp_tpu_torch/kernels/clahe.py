"""CLAHE's three stages, each a CUDA kernel (``csrc/clahe.cu``) beside its
plain PyTorch version.

* :func:`hist256_tiles` — stage A for u8: the 256-bin histogram of every
  tile of every plane, read in place, pad rows and columns through reflected
  indices (the JAX package's ``kernels/hist.py::hist256_pallas`` at
  its CLAHE call site, ops/clahe.py:207-212).
* :func:`tile_luts256` — stages A and B for u8 in one launch: the same
  kernel as :func:`hist256_tiles`, whose epilogue runs stage B's S = 256 law
  on each tile's finished histogram and writes only the tile's LUT.
* :func:`hist65536_tiles` — stage A for u16: the same walk, by a cluster
  of two blocks a tile, each walking half the tile's rows into 16-bit
  counters of the whole value range (rounds of at most 65535 pixels,
  :func:`tile16_rounds`), then summing its half of the range over the
  cluster through distributed shared memory.  The JAX package computes
  this stage in XLA, outside any Pallas kernel (ops/clahe.py:55-61,
  :213-216); the plain version, :func:`tile_hists_plain`, is a
  ``bincount`` over ``(plane·T + tile)·S + v`` offsets.
* :func:`tile_luts65536` — stages A and B for u16 in one launch: the same
  kernel, whose epilogue runs stage B's S = 65536 law on the cluster's
  sums and writes only the tile's u16 LUT.
* :func:`clahe_lut` — stage B, the clipped tile LUTs of histograms held in
  memory (``ops/clahe.py::clahe_tile_luts``; XLA in the JAX package, no
  Pallas): one block per tile for S = 256, one cluster of 8 blocks per tile
  for S = 65536.
* :func:`clahe_blend` — stage C, the bilinear blend of the four neighbour
  LUTs; one kernel per pixel type for every geometry, in place of
  ``kernels/clahe_u16.py::clahe_blend_quad_pallas`` and
  ``kernels/clahe_blend.py::clahe_blend_pallas``.  The u8 kernel stages, per
  interpolation cell, a shared-memory table of words packing the four
  neighbour entries of each value; :func:`blend_chunk` and
  :func:`blend_band` size its blocks.  The u16 kernel's blocks each lie in
  one cell (:func:`blend16_pieces`, :func:`blend16_rows`) and stage the four
  LUT rows in value chunks that their pixels use.

Tiles are numbered ``b·gh·gw + ty·gw + tx``; the histogram and LUT tables
are ``[B·gh·gw, S]`` with S = 256 (u8) or 65536 (u16).  The tile geometry
(``th``, ``tw``, with ``gh·th ≥ H`` and ``gw·tw ≥ W``) is cv2's, computed by
``ops/clahe.py``.  Dispatch is by device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel, any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, host_derived, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.conv import reflect101
from imageenhancement_mp_tpu_torch.kernels.hist import HIST_GRID_BLOCKS, MAX_GRID_Y, handoff_scratch

__all__ = [
    "HIST_SIZE",
    "hist256_tiles", "tile_hists_plain", "tile_band_plan", "tile_luts256", "tile_luts256_plain",
    "hist65536_tiles", "tile_luts65536", "tile_luts65536_plain", "tile16_rounds",
    "HIST16_RANKS",
    "clahe_lut", "clahe_lut_plain", "clip_and_scale",
    "clahe_blend", "clahe_blend_plain", "column_cells", "blend_chunk", "blend_band",
    "blend16_pieces", "blend16_rows",
]

HIST_SIZE = {torch.uint8: 256, torch.uint16: 65536}
_LUT_DTYPE = {256: torch.uint8, 65536: torch.uint16}
_INT32_MAX = 2**31 - 1
# the u8 blend's blocks (csrc/clahe.cu): 128 threads of 8 adjacent columns,
# at most 16 column cells (16 KiB of quad tables) and 16 rows per block;
# chunks are whole multiples of 16 columns
BLEND_PX, BLEND_MAX_CHUNK, BLEND_MAX_CELLS, BLEND_MAX_BAND = 16, 1024, 16, 16
# the u16 blend's blocks (csrc/clahe.cu): 512 threads of 4 vectors of 8
# pixels; a column piece of at most 256 vectors
B16_ITEMS, B16_MAX_PIECE_VECS = 512 * 4, 256


def _check_planes(planes: torch.Tensor, name: str) -> None:
    if planes.dtype not in HIST_SIZE:
        raise TypeError(f"{name}: CLAHE takes uint8/uint16 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"{name} expects [B, H, W] planes, got {tuple(planes.shape)}")


def _check_geometry(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int) -> None:
    _, H, W = planes.shape
    if min(gh, gw, th, tw) < 1 or gh * th < H or gw * tw < W:
        raise ValueError(f"tiles {gh}x{gw} of {th}x{tw} do not cover a {H}x{W} plane")
    if max(gh * th, gw * tw, th * tw) > _INT32_MAX:
        raise ValueError(f"tiles {gh}x{gw} of {th}x{tw}: indices overflow int32")


# --- stage A ---------------------------------------------------------------

def tile_hists_plain(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int) -> torch.Tensor:
    """Per-tile histograms ``[B·gh·gw, S]`` int32 of u8 (S = 256) or u16
    (S = 65536) planes, the pad read through REFLECT_101 indices."""
    _check_planes(planes, "tile_hists_plain")
    _check_geometry(planes, gh, gw, th, tw)
    B, H, W = planes.shape
    S = HIST_SIZE[planes.dtype]
    dev = planes.device
    rows = reflect101(torch.arange(gh * th, device=dev), H)
    cols = reflect101(torch.arange(gw * tw, device=dev), W)
    v = planes.to(torch.int64).index_select(1, rows).index_select(2, cols)
    tile = ((torch.arange(gh * th, device=dev) // th)[:, None] * gw
            + (torch.arange(gw * tw, device=dev) // tw)[None, :])
    plane = torch.arange(B, device=dev)[:, None, None] * (gh * gw)
    offsets = (plane + tile) * S + v
    counts = torch.bincount(offsets.reshape(-1), minlength=B * gh * gw * S)
    return counts.reshape(B * gh * gw, S).to(torch.int32)


# pixels a band of hist256_tiles holds at most, unless tiles are few: 256
# threads x 15 vectors of 16 pixels
TILE_BLOCK_PX = 256 * 15 * 16


def tile_band_plan(B: int, gh: int, gw: int, th: int, tw: int) -> tuple[int, int, int]:
    """``(band_rows, bands, grid_y)`` of ``hist256_tiles``: each of the
    ``B·gh·gw`` tiles (on ``gridDim.x``) cut into ``bands`` bands of
    ``band_rows`` rows, of at most about ``TILE_BLOCK_PX`` pixels each and,
    when tiles are few, enough for one wave of resident blocks; bands stride
    over ``grid_y``."""
    tiles = B * gh * gw
    bands = min(th, max(-(-(th * tw) // TILE_BLOCK_PX), HIST_GRID_BLOCKS // tiles))
    band_rows = -(-th // bands)
    bands = -(-th // band_rows)
    return band_rows, bands, min(bands, MAX_GRID_Y)


def _count_tiles(name: str, planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                 clip_limit: float | None = None) -> torch.Tensor | None:
    """Check, then on CUDA planes launch ``hist256_tiles`` (``[B·gh·gw,
    256]`` int32 histograms) or, with a ``clip_limit``, ``tile_luts256``
    (u8 LUTs): one launch, the output written whole.  None on CPU planes."""
    if planes.dtype != torch.uint8:
        raise TypeError(f"{name} expects uint8 planes, got {planes.dtype}")
    _check_planes(planes, name)
    _check_geometry(planes, gh, gw, th, tw)
    if not on_cuda(planes, name):
        return None
    check_kernel_input(name, planes)
    B, H, W = planes.shape
    if B * gh * gw > _INT32_MAX:
        raise ValueError(f"{name}: {B * gh * gw} tiles overflow the grid")
    lut_args = ()
    if clip_limit is not None:
        clip_abs, scale = clip_and_scale(th * tw, clip_limit, 256)
        lut_args = (clip_abs, float(scale))
    out = torch.empty((B * gh * gw, 256), dtype=torch.uint8 if lut_args else torch.int32,
                      device=planes.device)
    if out.numel():
        plan = tile_band_plan(B, gh, gw, th, tw)
        rows, partial, tickets = handoff_scratch(planes.device, B * gh * gw, plan[2])
        launch(name, planes.device, planes.data_ptr(), out.data_ptr(), *lut_args, B, H, W,
               gh, gw, th, tw, *plan, partial, tickets)
        del rows  # queued: the caching allocator reuses it in stream order
    return out


def hist256_tiles(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int) -> torch.Tensor:
    """Stage A for u8: ``[B, H, W]`` → ``[B·gh·gw, 256]`` int32, tile
    ``(ty, tx)`` covering padded rows ``ty·th ..`` and columns ``tx·tw ..``."""
    gh, gw, th, tw = int(gh), int(gw), int(th), int(tw)
    out = _count_tiles("hist256_tiles", planes, gh, gw, th, tw)
    return tile_hists_plain(planes, gh, gw, th, tw) if out is None else out


def tile_luts256_plain(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                       clip_limit: float) -> torch.Tensor:
    return clahe_lut_plain(tile_hists_plain(planes, gh, gw, th, tw), th * tw, clip_limit)


def tile_luts256(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                 clip_limit: float) -> torch.Tensor:
    """Stages A and B for u8: ``[B, H, W]`` → ``[B·gh·gw, 256]`` u8 tile LUTs,
    equal to ``clahe_lut(hist256_tiles(planes, gh, gw, th, tw), th·tw,
    clip_limit)``.  On CUDA one launch (``tile_luts256``): the last band
    block of each tile runs stage B on the tile's finished histogram; no
    histogram is kept."""
    gh, gw, th, tw = int(gh), int(gw), int(th), int(tw)
    out = _count_tiles("tile_luts256", planes, gh, gw, th, tw, float(clip_limit))
    return tile_luts256_plain(planes, gh, gw, th, tw, clip_limit) if out is None else out


# u16 stage A's cluster (csrc/clahe.cu::kHist16Ranks blocks a tile) and
# the most pixels a block counts into its 16-bit counters in one round
HIST16_RANKS, ROUND_PIXELS = 2, 65535


def tile16_rounds(th: int, tw: int) -> int:
    """The rounds each block of a u16 tile's cluster counts in: its share of
    the tile's rows, ``ceil(th / HIST16_RANKS)``, in bands of
    ``ROUND_PIXELS // piece`` rows by column pieces of ``piece = min(tw,
    ROUND_PIXELS)``, so no 16-bit counter passes 65535 (one round for tiles
    of up to 2 x 65535 pixels)."""
    share = -(-th // HIST16_RANKS)
    piece = min(tw, ROUND_PIXELS)
    return -(-tw // piece) * -(-share // (ROUND_PIXELS // piece))


def _count_tiles16(name: str, planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                   clip_limit: float | None = None) -> torch.Tensor | None:
    """Check, then on CUDA planes launch ``hist65536_tiles`` (``[B·gh·gw,
    65536]`` int32 histograms) or, with a ``clip_limit``, ``tile_luts65536``
    (u16 LUTs): one launch, the output written whole.  None on CPU planes."""
    if planes.dtype != torch.uint16:
        raise TypeError(f"{name} expects uint16 planes, got {planes.dtype}")
    _check_planes(planes, name)
    _check_geometry(planes, gh, gw, th, tw)
    if not on_cuda(planes, name):
        return None
    check_kernel_input(name, planes)
    B, H, W = planes.shape
    if B * gh * gw > _INT32_MAX:
        raise ValueError(f"{name}: {B * gh * gw} tiles overflow the grid")
    if not (H and W):  # no pixels: empty histograms, and their LUTs
        hists = torch.zeros((B * gh * gw, 65536), dtype=torch.int32, device=planes.device)
        return hists if clip_limit is None else clahe_lut(hists, th * tw, clip_limit)
    scratch = None
    if clip_limit is None:
        out = torch.empty((B * gh * gw, 65536), dtype=torch.int32, device=planes.device)
        lut_args = ()
    else:
        out = torch.empty((B * gh * gw, 65536), dtype=torch.uint16, device=planes.device)
        if tile16_rounds(th, tw) > 1:  # the earlier rounds' sums, written before read
            scratch = torch.empty((B * gh * gw, 65536), dtype=torch.int32, device=planes.device)
        clip_abs, scale = clip_and_scale(th * tw, clip_limit, 65536)
        lut_args = (0 if scratch is None else scratch.data_ptr(), clip_abs, float(scale))
    if out.numel():  # the kernel writes every entry
        launch(name, planes.device, planes.data_ptr(), out.data_ptr(), *lut_args, B, H, W,
               gh, gw, th, tw)
    del scratch  # queued: the caching allocator reuses it in stream order
    return out


def hist65536_tiles(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int) -> torch.Tensor:
    """Stage A for u16: ``[B, H, W]`` → ``[B·gh·gw, 65536]`` int32, tile
    ``(ty, tx)`` covering padded rows ``ty·th ..`` and columns ``tx·tw ..``."""
    gh, gw, th, tw = int(gh), int(gw), int(th), int(tw)
    out = _count_tiles16("hist65536_tiles", planes, gh, gw, th, tw)
    return tile_hists_plain(planes, gh, gw, th, tw) if out is None else out


def tile_luts65536_plain(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                         clip_limit: float) -> torch.Tensor:
    return clahe_lut_plain(tile_hists_plain(planes, gh, gw, th, tw), th * tw, clip_limit)


def tile_luts65536(planes: torch.Tensor, gh: int, gw: int, th: int, tw: int,
                   clip_limit: float) -> torch.Tensor:
    """Stages A and B for u16: ``[B, H, W]`` → ``[B·gh·gw, 65536]`` u16 tile
    LUTs, equal to ``clahe_lut(hist65536_tiles(planes, gh, gw, th, tw),
    th·tw, clip_limit)``.  On CUDA one launch (``tile_luts65536``): each
    tile's cluster runs stage B on the counters it holds; no histogram is
    kept."""
    gh, gw, th, tw = int(gh), int(gw), int(th), int(tw)
    out = _count_tiles16("tile_luts65536", planes, gh, gw, th, tw, float(clip_limit))
    return tile_luts65536_plain(planes, gh, gw, th, tw, clip_limit) if out is None else out


# --- stage B ---------------------------------------------------------------

def clip_and_scale(area: int, clip_limit: float, S: int) -> tuple[int, np.float32]:
    """``(clip_abs, scale)`` of a tile of ``area`` pixels: ``clip_abs =
    max(int(clip_limit·area/S), 1)``, or 0 (no clip) for ``clip_limit ≤ 0``,
    as ops/clahe.py:84 computes it in Python; ``scale = f32(S−1)/f32(area)``,
    one IEEE f32 division on the host."""
    clip_abs = max(int(clip_limit * area / S), 1) if clip_limit > 0 else 0
    return clip_abs, np.float32(S - 1) / np.float32(area)


def _check_hists(hists: torch.Tensor, area: int) -> int:
    if hists.dtype != torch.int32 or hists.dim() != 2 or hists.shape[1] not in _LUT_DTYPE:
        raise TypeError(f"expected [T, 256] or [T, 65536] int32 histograms, got "
                        f"{hists.dtype} {tuple(hists.shape)}")
    if not 1 <= area <= _INT32_MAX:
        raise ValueError(f"tile area {area} does not fit the int32 cdf")
    return hists.shape[1]


def clahe_lut_plain(hists: torch.Tensor, area: int, clip_limit: float) -> torch.Tensor:
    S = _check_hists(hists, area)
    clip_abs, scale = clip_and_scale(area, clip_limit, S)
    h = hists
    if clip_abs:
        excess = (h - clip_abs).clamp(min=0).sum(dim=1, keepdim=True)
        h = h.clamp(max=clip_abs) + excess // S
        resid = excess % S
        step = (S // resid.clamp(min=1)).clamp(min=1)
        i = torch.arange(S, device=h.device)[None, :]
        h = h + ((i % step == 0) & (i // step < resid))
    cdf = torch.cumsum(h, dim=1).to(torch.float32)
    lut = torch.round(cdf * torch.tensor(scale, device=h.device)).clamp(0, S - 1)
    return lut.to(torch.int32).to(_LUT_DTYPE[S])


def clahe_lut(hists: torch.Tensor, area: int, clip_limit: float) -> torch.Tensor:
    """Stage B: ``[T, S]`` int32 histograms of tiles of ``area`` pixels →
    ``[T, S]`` LUTs (u8 for S = 256, u16 for S = 65536): clip, redistribute,
    cdf, ``clamp(rint(f32(cdf)·scale), 0, S−1)``; see :func:`clip_and_scale`."""
    area = int(area)
    S = _check_hists(hists, area)
    if not on_cuda(hists, "clahe_lut"):
        return clahe_lut_plain(hists, area, clip_limit)
    check_kernel_input("clahe_lut", hists)
    if S == 65536 and hists.data_ptr() % 16:
        hists = hists.clone()  # the S = 65536 kernel reads 16-byte vectors
    clip_abs, scale = clip_and_scale(area, clip_limit, S)
    out = torch.empty(hists.shape, dtype=_LUT_DTYPE[S], device=hists.device)
    if hists.shape[0]:
        launch("clahe_lut", hists.device, hists.data_ptr(), out.data_ptr(), hists.shape[0], S,
               clip_abs, float(scale))
    return out


# --- stage C ---------------------------------------------------------------

def _check_blend(planes, luts, gh, gw, yidx, fy, xidx, fx) -> None:
    _check_planes(planes, "clahe_blend")
    B, H, W = planes.shape
    S = HIST_SIZE[planes.dtype]
    if luts.dtype != planes.dtype or luts.shape != (B * gh * gw, S):
        raise ValueError(f"clahe_blend: expected [{B * gh * gw}, {S}] {planes.dtype} LUTs, "
                         f"got {luts.dtype} {tuple(luts.shape)}")
    for idx, frac, n in ((yidx, fy, H), (xidx, fx, W)):
        if idx.dtype != torch.int32 or idx.shape != (2, n) or frac.dtype != torch.float32 \
                or frac.shape != (n,):
            raise ValueError("clahe_blend: coordinate tables must be [2, n] int32 and [n] f32")
    for t in (luts, yidx, fy, xidx, fx):
        if t.device != planes.device:
            raise ValueError(f"clahe_blend: planes on {planes.device}, a table on {t.device}")


def column_cells(i0: np.ndarray, i1: np.ndarray, n: int) -> np.ndarray:
    """The interpolation cell of each column (or row) whose neighbour tiles
    are ``(i0, i1)`` on a grid of ``n`` tiles, as the u8 kernel derives it:
    0 before the first tile centre, ``n`` after the last, else ``i1``.  The
    four neighbour LUTs are the same across a cell."""
    return np.where(i1 > i0, i1, np.where(i0 == 0, 0, n))


def blend_chunk(xidx: np.ndarray, gw: int) -> int:
    """The u8 blend's columns per block from the host column table
    ``[2, W]``: the widest multiple of 16, at most 1024, such that every
    chunk ``[k·chunk, (k+1)·chunk)`` touches at most 16 column cells (16
    columns touch at most 16, so one is always found)."""
    W = xidx.shape[1]
    cells = column_cells(xidx[0], xidx[1], gw)
    chunk = min(BLEND_MAX_CHUNK, -(-W // BLEND_PX) * BLEND_PX)
    while chunk > BLEND_PX:
        starts = np.arange(0, W, chunk)
        ends = np.minimum(starts + chunk, W) - 1
        if (cells[ends] - cells[starts]).max() < BLEND_MAX_CELLS:
            break
        chunk -= BLEND_PX
    return chunk


def blend_band(yidx: np.ndarray) -> int:
    """The u8 blend's rows per block from the host row table ``[2, H]``: 16,
    or the shortest row cell's height where that is less (tiles of a few
    rows).  A band that crosses into the next row cell stages its tables
    anew, so any band is right; this one keeps most bands inside one cell."""
    change = np.flatnonzero((yidx[0, 1:] != yidx[0, :-1]) | (yidx[1, 1:] != yidx[1, :-1])) + 1
    runs = np.diff(np.concatenate([[0], change, [yidx.shape[1]]]))
    return int(min(BLEND_MAX_BAND, runs.min()))


def _runs(idx: np.ndarray) -> np.ndarray:
    """``[n, 2]`` (start, end) of the runs of equal ``(idx[0], idx[1])``:
    the cells of a ``[2, n]`` coordinate table."""
    change = np.flatnonzero((idx[0, 1:] != idx[0, :-1]) | (idx[1, 1:] != idx[1, :-1])) + 1
    edges = np.concatenate([[0], change, [idx.shape[1]]])
    return np.stack([edges[:-1], edges[1:]], axis=1)


def blend16_rows(yidx: np.ndarray) -> np.ndarray:
    """The u16 blend's row cells from the host row table ``[2, H]``:
    ``[n, 2]`` int32 (first row, end row)."""
    return _runs(yidx).astype(np.int32)


def blend16_pieces(xidx: np.ndarray) -> np.ndarray:
    """The u16 blend's column pieces from the host column table ``[2, W]``:
    ``[n, 3]`` int32 (first column, end column, rows per block).  Each
    column cell is cut where its 8-column vectors (counted from column 0)
    pass ``B16_MAX_PIECE_VECS``; a block takes as many rows of a piece as
    fill its ``B16_ITEMS`` vectors.  Vectors that straddle two cells belong
    to a piece of each, which blends only its own columns."""
    out = []
    for c0, c1 in _runs(xidx):
        va, vb = c0 // 8, -(-c1 // 8)
        for v in range(va, vb, B16_MAX_PIECE_VECS):
            ve = min(v + B16_MAX_PIECE_VECS, vb)
            out.append((max(c0, 8 * v), min(c1, 8 * ve), B16_ITEMS // (ve - v)))
    return np.array(out, np.int32).reshape(-1, 3)


def _blend16_plan(yidx: torch.Tensor, xidx: torch.Tensor) -> tuple[int, ...]:
    """The u16 kernel's plan arguments: the pieces and row cells on the
    device (derived once per coordinate table) and the most row bands of
    any piece in any row cell."""
    dev = xidx.device

    def pieces_of(a: np.ndarray):
        p = blend16_pieces(a)
        return torch.from_numpy(p).to(dev), len(p), int(p[:, 2].min())

    def rows_of(a: np.ndarray):
        r = blend16_rows(a)
        return torch.from_numpy(r).to(dev), len(r), int((r[:, 1] - r[:, 0]).max())

    pieces, npieces, min_rpb = host_derived(xidx, "clahe u16 blend pieces", pieces_of)
    rows, nrows, max_h = host_derived(yidx, "clahe u16 blend rows", rows_of)
    return pieces.data_ptr(), npieces, -(-max_h // min_rpb), rows.data_ptr(), nrows


def clahe_blend_plain(planes: torch.Tensor, luts: torch.Tensor, gh: int, gw: int,
                      yidx: torch.Tensor, fy: torch.Tensor, xidx: torch.Tensor,
                      fx: torch.Tensor) -> torch.Tensor:
    B = planes.shape[0]
    S = HIST_SIZE[planes.dtype]
    flat = luts.to(torch.int32).reshape(-1)
    v = planes.to(torch.int64)
    plane = torch.arange(B, device=planes.device)[:, None, None] * (gh * gw)
    y0, y1 = (i.to(torch.int64)[None, :, None] for i in yidx)
    x0, x1 = (i.to(torch.int64)[None, None, :] for i in xidx)

    def corner(ty, tx):
        return flat[(plane + ty * gw + tx) * S + v].to(torch.float32)

    # blend_tile_luts' association (ops/clahe.py:145-148); each torch op
    # rounds once, as the kernel's __fmul_rn / __fadd_rn / __fsub_rn do
    fxr, fyc = fx[None, None, :], fy[None, :, None]
    gx, gy = torch.ones_like(fxr) - fxr, torch.ones_like(fyc) - fyc
    top = gx * corner(y0, x0) + fxr * corner(y0, x1)
    bot = gx * corner(y1, x0) + fxr * corner(y1, x1)
    out = torch.round(gy * top + fyc * bot).clamp(0, S - 1)
    return out.to(torch.int32).to(planes.dtype)


def clahe_blend(planes: torch.Tensor, luts: torch.Tensor, gh: int, gw: int,
                yidx: torch.Tensor, fy: torch.Tensor, xidx: torch.Tensor,
                fx: torch.Tensor) -> torch.Tensor:
    """Stage C: each pixel of ``[B, H, W]`` u8/u16 planes through the four
    neighbour tile LUTs of ``luts`` (``[B·gh·gw, S]``, the planes' dtype),
    blended with row ``y`` weights ``yidx[:, y]``, ``fy[y]`` and column
    weights ``xidx[:, x]``, ``fx[x]`` (ops/clahe.py ``_interp_coords``)."""
    gh, gw = int(gh), int(gw)
    _check_blend(planes, luts, gh, gw, yidx, fy, xidx, fx)
    if not on_cuda(planes, "clahe_blend"):
        return clahe_blend_plain(planes, luts, gh, gw, yidx, fy, xidx, fx)
    check_kernel_input("clahe_blend", planes, luts, yidx, fy, xidx, fx)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if not out.numel():
        return out
    chunk = band = 0  # u8 only
    plan16 = (0, 0, 0, 0, 0)  # u16 only
    # each plan once per coordinate table (ops/clahe.py keeps them per geometry)
    if planes.dtype == torch.uint8:
        if luts.data_ptr() % 4:
            raise ValueError("clahe_blend: the u8 kernel reads LUT rows as 4-byte words; "
                             "pass 4-byte aligned LUTs")
        chunk = host_derived(xidx, f"clahe blend chunk, gw {gw}", lambda a: blend_chunk(a, gw))
        band = host_derived(yidx, "clahe blend band", blend_band)
    else:
        if luts.data_ptr() % 16:
            raise ValueError("clahe_blend: the u16 kernel reads LUT rows as 16-byte vectors; "
                             "pass 16-byte aligned LUTs")
        plan16 = _blend16_plan(yidx, xidx)
    launch("clahe_blend", planes.device, planes.data_ptr(), luts.data_ptr(), out.data_ptr(),
           B, H, W, planes.element_size(), gh, gw, yidx.data_ptr(), fy.data_ptr(),
           xidx.data_ptr(), fx.data_ptr(), *plan16, chunk, band)
    return out
