"""Spatial sharding: one frame's rows split across a mesh axis.

The counterpart of the JAX package's ``parallel/spatial.py``.  Batch
sharding (``parallel/sharding.py``) scales throughput; row sharding scales
the frame: a gigapixel scan or an 8K aerial tile is split into row blocks,
one a shard, and three collective patterns keep every op equal to its
unsharded twin bit for bit:

* stencils exchange their ``r`` boundary rows with the neighbour shards
  (:func:`halo_exchange`, both shifts in one exchange); the top and bottom
  shards make the frame's own border from their rows instead (REFLECT_101,
  replicate or the constant identity), so the unsharded op runs on the
  extended block and the ``r`` rows it gets wrong on each side are cropped;
* statistics pool with ``psum`` / ``pmin`` / ``pmax`` (256 bins or two
  values a plane);
* CLAHE computes the LUTs of its own tile rows, ``all_gather``s the
  ``[gh·gw, S]`` table and blends its rows with the global row coordinates.

The geometry twins resample, so each shard owns an equal block of OUTPUT
rows, ``[idx·oh/n, (idx+1)·oh/n)``, and fetches the input rows they read:
resize through a halo whose radius the host row tables give, warpAffine,
remap and warpPolar from the ``all_gather``ed frame (a map can read any
row), Canny through halos and a hysteresis that floods across shards until
a ``psum`` says no shard grew.

Each twin runs the port's own planes op, so the kernels that op launches
run on each shard's block.  The local functions take ``axis_name`` and run
inside a sharded call; :func:`shard_spatial` makes one.  A 2-D mesh with
axes ``("batch", "y")`` and ``batch_axis="batch"`` shards planes and rows
at once, the row collectives staying within each batch shard's group.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.clahe import (HIST_SIZE, clahe_blend, tile_luts256,
                                                        tile_luts65536)
from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256
from imageenhancement_mp_tpu_torch.ops.bilateral import bilateral_offsets, bilateral_planes
from imageenhancement_mp_tpu_torch.ops.canny import (_dilate8, _nms_keep, _sobel_replicate,
                                                    check_canny, hysteresis, magnitude)
from imageenhancement_mp_tpu_torch.ops.clahe import _coord_tables, coord_rows
from imageenhancement_mp_tpu_torch.ops.filter2d import filter2d_planes
from imageenhancement_mp_tpu_torch.ops.filters import (box_blur_planes, gaussian_blur_planes,
                                                      laplacian_sharpen_planes, sobel_planes,
                                                      unsharp_mask_planes)
from imageenhancement_mp_tpu_torch.ops.histogram import (equalize_hist_global_planes,
                                                         equalize_lut, histogram_256)
from imageenhancement_mp_tpu_torch.ops.median import median_blur_planes
from imageenhancement_mp_tpu_torch.ops.morphology import (MORPH_OPS, _identity, _ksize2, _minmax,
                                                          _narrow, _widen, compose)
from imageenhancement_mp_tpu_torch.ops.pointwise import (convert_scale_abs_planes, gamma_planes,
                                                         log_planes, plane_minmax, stretch_planes)
from imageenhancement_mp_tpu_torch.ops.resize import (check_resize, resize_planes, resize_rows,
                                                      row_kind, row_reach, shard_row_tables)
from imageenhancement_mp_tpu_torch.ops.threshold import adaptive_threshold_planes, threshold_planes
from imageenhancement_mp_tpu_torch.ops.warp import (_border_value, _check, polar_maps, remap_planes,
                                                    warp_affine_rows)
from imageenhancement_mp_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, all_gather,
                                                         axis_index, axis_size, device_put, pmax,
                                                         pmin, psum, run_sharded, shift)
from imageenhancement_mp_tpu_torch.utils.shapes import host_array
from imageenhancement_mp_tpu_torch.utils.taps import deriv_kernels, gaussian_axes
from imageenhancement_mp_tpu_torch.utils.warp_coords import invert_affine

__all__ = [
    "shard_spatial", "device_put_spatial", "halo_exchange",
    "gaussian_blur_spatial", "box_blur_spatial", "bilateral_spatial",
    "adaptive_threshold_spatial", "erode_spatial", "dilate_spatial", "morphology_spatial",
    "sobel_spatial", "filter2d_spatial", "unsharp_mask_spatial", "median_blur_spatial",
    "laplacian_sharpen_spatial", "equalize_hist_spatial", "contrast_stretch_spatial",
    "clahe_spatial", "resize_spatial", "warp_affine_spatial", "remap_spatial", "canny_spatial",
    "SPATIAL_OP_REGISTRY", "spatial_chain", "make_spatial_pipeline",
]

_INT32_MAX = 2**31 - 1


def shard_spatial(planes_fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh,
                  axis_name: str = "y", batch_axis: str | None = None) -> Callable:
    """``planes_fn`` over frame rows: it receives each shard's ``[B, H/n, W]``
    block and must use the ``*_spatial`` twins for anything that reads
    across rows; pointwise planes ops run as they are.  H must divide by the
    ``axis_name`` size; ``batch_axis`` also splits the planes (a 2-D mesh)."""
    spec = (batch_axis, axis_name, None)
    return run_sharded(planes_fn, mesh, spec, spec)


def device_put_spatial(planes, mesh: Mesh, axis_name: str = "y",
                       batch_axis: str | None = None) -> ShardedTensor:
    """Place ``[B, H, W]`` planes (tensor or NumPy array) on the mesh, rows
    split along ``axis_name`` (and planes along ``batch_axis``)."""
    return device_put(planes, mesh, (batch_axis, axis_name, None))


def halo_exchange(local: torch.Tensor, r: int, axis_name: str = "y", mode: str = "reflect",
                  const_val=0) -> torch.Tensor:
    """A local ``[B, h, W]`` row block extended by ``r`` halo rows a side.

    Interior halos are the neighbour shards' boundary rows (both shifts in
    one exchange, ``mesh.shift``); the top and bottom shards make the frame's border instead:
    ``mode="reflect"`` (BORDER_REFLECT_101: rows ``r..1`` and ``h-2..h-1-r``),
    ``"edge"`` (replicate) or ``"const"`` (``const_val``).  Reflect needs
    ``h ≥ r+1`` (its border reads local row ``r``), the others ``h ≥ r``."""
    if r <= 0:
        return local
    if mode not in ("reflect", "edge", "const"):
        raise ValueError(f"mode must be 'reflect', 'edge' or 'const', got {mode!r}")
    h = local.shape[1]
    h_min = r + 1 if mode == "reflect" else r
    if h < h_min:
        raise ValueError(
            f"shard height {h} too small for halo radius {r} with mode {mode!r} "
            f"(need h ≥ {h_min}); use fewer shards or a smaller kernel")
    # my bottom rows become the lower neighbour's top halo, and vice versa
    top, bot = shift(local[:, -r:, :], local[:, :r, :], axis_name)
    B, _, W = local.shape
    if mode == "reflect":
        own_top, own_bot = local[:, 1:r + 1, :].flip(1), local[:, h - 1 - r:h - 1, :].flip(1)
    elif mode == "edge":
        own_top, own_bot = local[:, :1, :].expand(B, r, W), local[:, -1:, :].expand(B, r, W)
    else:
        own_top = own_bot = torch.full((B, r, W), const_val, dtype=local.dtype,
                                       device=local.device)
    return torch.cat([own_top if top is None else top, local,
                      own_bot if bot is None else bot], dim=1)


def _stencil_spatial(local: torch.Tensor, op: Callable, r: int, mode: str, axis_name: str,
                     const_val=0) -> torch.Tensor:
    """Halo exchange, the unsharded op on the extended block, crop.  Exact:
    the op's own border reaches only the ``r`` outermost output rows of each
    side, which are cropped; every kept row reads true halo or local rows."""
    if r == 0:
        return op(local)
    return op(halo_exchange(local, r, axis_name, mode, const_val))[:, r:-r, :]


def gaussian_blur_spatial(local: torch.Tensor, ksize=5, sigma: float = 0.0,
                          sigma_y: float = 0.0, axis_name: str = "y") -> torch.Tensor:
    """``cv2.GaussianBlur`` on row-sharded planes (halo: the kernel's radius)."""
    kh = gaussian_axes(ksize, sigma, sigma_y, local.dtype == torch.uint8)[0]
    op = partial(gaussian_blur_planes, ksize=ksize, sigma=sigma, sigma_y=sigma_y)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def unsharp_mask_spatial(local: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                         sigma: float = 0.0, axis_name: str = "y") -> torch.Tensor:
    """Unsharp mask on row-sharded planes (halo: the blur's radius)."""
    kh = gaussian_axes(ksize, sigma, sigma, local.dtype == torch.uint8)[0]
    op = partial(unsharp_mask_planes, amount=amount, ksize=ksize, sigma=sigma)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def median_blur_spatial(local: torch.Tensor, ksize: int = 3,
                        axis_name: str = "y") -> torch.Tensor:
    """``cv2.medianBlur`` on row-sharded planes (replicate border)."""
    op = partial(median_blur_planes, ksize=ksize)
    return _stencil_spatial(local, op, int(ksize) // 2, "edge", axis_name)


def box_blur_spatial(local: torch.Tensor, ksize=3, axis_name: str = "y") -> torch.Tensor:
    """``cv2.blur`` on row-sharded planes (halo: kh//2 rows)."""
    kh = int(ksize[0]) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _stencil_spatial(local, partial(box_blur_planes, ksize=ksize), kh // 2, "reflect",
                            axis_name)


def bilateral_spatial(local: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                      sigma_space: float = 50.0, axis_name: str = "y") -> torch.Tensor:
    """``cv2.bilateralFilter`` on row-sharded grayscale planes (halo: the
    disc's radius)."""
    r = bilateral_offsets(d, sigma_color, sigma_space)[2]
    op = partial(bilateral_planes, d=d, sigma_color=sigma_color, sigma_space=sigma_space)
    return _stencil_spatial(local, op, r, "reflect", axis_name)


def _minmax_spatial(x: torch.Tensor, op: str, kh: int, kw: int, dtype: torch.dtype,
                    axis_name: str) -> torch.Tensor:
    """One rect min (erode) or max (dilate) filter of widened planes ``x``;
    the halo at the frame's top and bottom is the op's identity, as cv2's
    BORDER_CONSTANT is."""
    if kh % 2 == 0:
        raise ValueError("spatial morphology needs an odd kernel height")
    return _stencil_spatial(x, lambda p: _minmax(p, kh, kw, None, op, dtype), kh // 2, "const",
                            axis_name, const_val=_identity(dtype, op))


def _morph_filters(ksize, iterations: int, dtype: torch.dtype, axis_name: str):
    """The erosion and dilation (``iterations`` each, a halo each) of
    widened row-sharded planes."""
    kh, kw = _ksize2(ksize)

    def run(x, op):
        for _ in range(max(1, int(iterations))):
            x = _minmax_spatial(x, op, kh, kw, dtype, axis_name)
        return x

    return partial(run, op="min"), partial(run, op="max")


def erode_spatial(local: torch.Tensor, ksize=3, iterations: int = 1,
                  axis_name: str = "y") -> torch.Tensor:
    """``cv2.erode`` on row-sharded planes (a halo a iteration)."""
    return morphology_spatial(local, "erode", ksize, iterations, axis_name)


def dilate_spatial(local: torch.Tensor, ksize=3, iterations: int = 1,
                   axis_name: str = "y") -> torch.Tensor:
    """``cv2.dilate`` on row-sharded planes (a halo a iteration)."""
    return morphology_spatial(local, "dilate", ksize, iterations, axis_name)


def morphology_spatial(local: torch.Tensor, op: str = "open", ksize=3, iterations: int = 1,
                       axis_name: str = "y") -> torch.Tensor:
    """``cv2.morphologyEx`` on row-sharded planes, each stage with a halo
    of its own: cv2 pads every intermediate with that stage's identity, so
    one wider halo would be wrong at the frame's top and bottom."""
    if op not in MORPH_OPS:
        raise ValueError(f"op must be one of {MORPH_OPS}, got {op!r}")
    E, D = _morph_filters(ksize, iterations, local.dtype, axis_name)
    return _narrow(compose(op, _widen(local), E, D, local.dtype), local.dtype)


def sobel_spatial(local: torch.Tensor, dx: int = 1, dy: int = 0, ksize: int = 3,
                  scale: float = 1.0, delta: float = 0.0, axis_name: str = "y") -> torch.Tensor:
    """``cv2.Sobel``/``Scharr`` on row-sharded planes (halo: the ky radius)."""
    ky = deriv_kernels(dx, dy, ksize)[1]
    op = partial(sobel_planes, dx=dx, dy=dy, ksize=ksize, scale=scale, delta=delta)
    return _stencil_spatial(local, op, len(ky) // 2, "reflect", axis_name)


def filter2d_spatial(local: torch.Tensor, kernel, delta: float = 0.0,
                     axis_name: str = "y") -> torch.Tensor:
    """``cv2.filter2D`` on row-sharded planes (halo: kh//2 rows)."""
    kh = host_array(kernel).shape[0]
    op = partial(filter2d_planes, kernel=kernel, delta=delta)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def adaptive_threshold_spatial(local: torch.Tensor, maxval: float = 255.0, method: str = "mean",
                               type: str = "binary", block_size: int = 3, C: float = 0.0,
                               axis_name: str = "y") -> torch.Tensor:
    """``cv2.adaptiveThreshold`` on row-sharded planes (halo: bs//2 rows of
    replicate border, cv2's border here)."""
    op = partial(adaptive_threshold_planes, maxval=maxval, method=method, type=type,
                 block_size=block_size, C=C)
    return _stencil_spatial(local, op, int(block_size) // 2, "edge", axis_name)


def laplacian_sharpen_spatial(local: torch.Tensor, axis_name: str = "y") -> torch.Tensor:
    """Laplacian sharpen on row-sharded planes (3×3 stencil, halo 1)."""
    return _stencil_spatial(local, laplacian_sharpen_planes, 1, "reflect", axis_name)


def equalize_hist_spatial(local: torch.Tensor, axis_name: str = "y") -> torch.Tensor:
    """``cv2.equalizeHist`` per frame on row-sharded planes: each shard
    counts its rows (``hist256``), a ``psum`` pools the 256 bins, and every
    shard maps its rows through the frame's LUT (``equalize_lut256``,
    ``apply_lut256``)."""
    if local.dtype != torch.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {local.dtype}")
    total = local.shape[-2] * local.shape[-1] * axis_size(axis_name)
    if total > _INT32_MAX:
        raise ValueError(
            f"frame covers {total} pixels, which overflows the int32 cdf; equalizeHist "
            "parity is defined up to 2^31-1 pixels per frame")
    local = local.contiguous()
    return apply_lut256(local, equalize_lut(psum(histogram_256(local), axis_name), total))


def contrast_stretch_spatial(local: torch.Tensor, out_range: tuple[float, float] = (0.0, 255.0),
                             axis_name: str = "y") -> torch.Tensor:
    """``cv2.normalize(MINMAX)`` per frame on row-sharded planes: each
    shard's minimum and maximum pool with ``pmin``/``pmax``, then the
    unsharded law (``ops/pointwise.py::stretch_planes``) runs on the rows."""
    lo, hi = plane_minmax(local)
    return stretch_planes(local, pmin(lo, axis_name), pmax(hi, axis_name), out_range)


def clahe_spatial(local: torch.Tensor, clip_limit: float = 40.0,
                  tile_grid: tuple[int, int] = (8, 8), axis_name: str = "y") -> torch.Tensor:
    """``cv2.createCLAHE`` on row-sharded planes.

    Each shard owns ``gh/n`` tile rows.  Stages A and B run on them alone
    (``tile_luts256`` for u8, ``tile_luts65536`` for u16); one ``all_gather`` shares the ``[gh·gw, S]`` LUT table, the only
    state the blend needs from other shards; stage C (``clahe_blend``)
    blends the shard's rows with rows ``[row0, row0 + h)`` of the frame's
    row coordinates.  Needs divisible geometry: ``gh % n == 0``,
    ``(H/n) % (gh/n) == 0`` and ``W % gw == 0`` (cv2's REFLECT_101 pad of
    an indivisible frame is the unsharded op's alone: pad before sharding)."""
    if local.dtype not in HIST_SIZE:
        raise TypeError(f"CLAHE supports uint8/uint16 (cv2 parity), got {local.dtype}")
    B, h, W = local.shape
    n = axis_size(axis_name)
    gh, gw = (int(g) for g in tile_grid)
    if gh % n:
        raise ValueError(f"spatial CLAHE needs tile rows {gh} divisible by mesh size {n}")
    ghl = gh // n
    if h % ghl or W % gw:
        raise ValueError(
            f"spatial CLAHE needs divisible geometry: local rows {h} % {ghl} == 0 "
            f"and width {W} % {gw} == 0 (pad the frame before sharding)")
    th, tw = h // ghl, W // gw
    local = local.contiguous()
    tile_luts = tile_luts256 if local.dtype == torch.uint8 else tile_luts65536
    luts = tile_luts(local, ghl, gw, th, tw, float(clip_limit))
    S = luts.shape[1]
    # a new tensor from torch.cat: aligned as the blend kernels read it
    luts = all_gather(luts.reshape(B, ghl * gw, S), axis_name, axis=1, tiled=True)
    yidx, fy = coord_rows(h * n, th, gh, axis_index(axis_name) * h, h, local.device)
    xidx, fx = _coord_tables(W, tw, gw, local.device)
    return clahe_blend(local, luts.reshape(B * gh * gw, S), gh, gw, yidx, fy, xidx, fx)


# -- geometry: each shard renders an equal block of output rows ----------------

def _geom_split(local: torch.Tensor, dsize, axis_name: str) -> tuple:
    """``(n, idx, h, H, oh, ow, oloc)``: the shard count and this shard's
    index, the local and frame heights, the output size and the output rows
    a shard renders."""
    n, idx = axis_size(axis_name), axis_index(axis_name)
    h = local.shape[1]
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh % n:
        raise ValueError(
            f"spatial geometry needs the output height {oh} divisible by the "
            f"{n}-shard mesh axis (pad dsize or reshard)")
    return n, idx, h, h * n, oh, ow, oh // n


def _vhalo(lo, hi, n: int, h: int, oloc: int) -> int:
    """The halo radius: how far any shard's output block reaches past its
    own input rows, from each output row's least and greatest input row."""
    r = 0
    for s in range(n):
        o0, o1 = s * oloc, (s + 1) * oloc
        r = max(r, s * h - int(lo[o0:o1].min()), int(hi[o0:o1].max()) - ((s + 1) * h - 1))
    return r


def resize_spatial(local: torch.Tensor, dsize, interpolation: str = "linear",
                   axis_name: str = "y") -> torch.Tensor:
    """``cv2.resize`` on row-sharded planes, equal bit for bit to
    ``resize_planes`` on the gathered frame.  Each shard renders its output
    rows from its block extended by a replicate halo as deep as its rows
    reach (``_vhalo`` of the host row tables), through its rows of the y
    tables rebased onto that block (``ops/resize.py::shard_row_tables``).
    The area downscale by integer factors needs neither: no cell straddles
    two shards."""
    n, idx, h, H, oh, ow, oloc = _geom_split(local, dsize, axis_name)
    check_resize(local, dsize)
    kind = row_kind(interpolation, H, local.shape[2], oh, ow)
    if kind is None:
        return resize_planes(local, (oloc, ow), "area")
    r = _vhalo(*row_reach(kind, H, oh), n, h, oloc)
    ext = halo_exchange(local, r, axis_name, "edge")
    return resize_rows(ext, H, oh, ow, kind, shard_row_tables(kind, H, oh, n, idx, r, local.device))


def warp_affine_spatial(local: torch.Tensor, M, dsize, interpolation: str = "linear",
                        border: str = "constant", border_value: float = 0.0,
                        inverse_map: bool = False, axis_name: str = "y") -> torch.Tensor:
    """``cv2.warpAffine`` on row-sharded planes, equal bit for bit to
    ``warp_affine_planes`` on the gathered frame.  An affine map reads rows
    from anywhere, so the frame is ``all_gather``ed and each shard renders
    its own output rows (``ops/warp.py::warp_affine_rows``): u8 linear and
    nearest through ``warp_gather_u8``'s matrix route with the shard's first
    row, the other routes from their rows of the coordinate tables."""
    n, idx, h, H, oh, ow, oloc = _geom_split(local, dsize, axis_name)
    _check(local, interpolation, border)
    Mi = (np.asarray(M, np.float64).reshape(2, 3) if inverse_map
          else invert_affine(np.asarray(M, np.float64)))
    full = all_gather(local, axis_name, axis=1, tiled=True)
    return warp_affine_rows(full, Mi, oh, ow, idx * oloc, oloc, interpolation, border,
                            _border_value(local.dtype, border_value))


def remap_spatial(local: torch.Tensor, map_x, map_y, interpolation: str = "linear",
                  border: str = "constant", border_value: float = 0.0,
                  axis_name: str = "y") -> torch.Tensor:
    """``cv2.remap`` on row-sharded planes.  ``map_x``/``map_y`` are this
    shard's output-row block of the maps (split them as the output is split,
    e.g. ``run_sharded(fn, mesh, [(None, "y"), ("y",), ("y",)], ...)``); the
    frame is ``all_gather``ed, as a map can read any row.  Equal bit for bit
    to ``remap_planes`` on the gathered frame and maps."""
    full = all_gather(local, axis_name, axis=1, tiled=True)
    return remap_planes(full, map_x, map_y, interpolation, border, border_value)


def warp_polar_spatial(local: torch.Tensor, dsize, center, max_radius: float,
                       log: bool = False, inverse: bool = False, interpolation: str = "linear",
                       axis_name: str = "y") -> torch.Tensor:
    """``cv2.warpPolar`` on row-sharded planes, equal bit for bit to
    ``warp_polar_planes`` on the gathered frame: each shard samples the
    ``all_gather``ed frame (with the inverse's one-row angular wrap pad) at
    its rows of the polar maps (``ops/warp.py::polar_maps``, kept on the
    device).  ``dsize`` is cv2's (width, height)."""
    n, idx = axis_size(axis_name), axis_index(axis_name)
    H, W = local.shape[1] * n, local.shape[2]
    dh = int(dsize[1])
    if dh % n:
        raise ValueError(f"output height {dh} must divide the {n}-shard axis")
    mx, my = polar_maps(H, W, dsize, center, max_radius, log, inverse, local.device)
    rows = slice(idx * (dh // n), (idx + 1) * (dh // n))
    full = all_gather(local, axis_name, axis=1, tiled=True)
    if inverse:
        full = torch.cat([full[:, -1:], full, full[:, :1]], dim=1)
    return remap_planes(full, mx[rows], my[rows], interpolation, "constant", 0.0)


def canny_spatial(local: torch.Tensor, threshold1: float, threshold2: float,
                  aperture_size: int = 3, l2_gradient: bool = False,
                  axis_name: str = "y") -> torch.Tensor:
    """``cv2.Canny`` on row-sharded u8 planes, equal bit for bit to
    ``canny_planes`` on the gathered frame.  Sobel reads a replicate halo of
    the aperture's radius, non-maximum suppression a zero halo of one
    magnitude row.  Hysteresis is a fixpoint across shards: each round every
    shard floods its block (``ops/canny.py::hysteresis``), takes one edge row
    from each neighbour and grows from it, and a ``psum`` of "grew" says
    whether another round runs (two collectives a round)."""
    check_canny(local, aperture_size)
    r = aperture_size // 2
    ext = halo_exchange(local, r, axis_name, "edge")
    gx = _sobel_replicate(ext, 1, 0, aperture_size)[:, r:-r, :]
    gy = _sobel_replicate(ext, 0, 1, aperture_size)[:, r:-r, :]
    mag, lo_i, hi_i = magnitude(gx, gy, threshold1, threshold2, aperture_size, l2_gradient)
    keep = _nms_keep(halo_exchange(mag, 1, axis_name, "const", 0), gx, gy) & (mag > lo_i)
    edges = keep & (mag > hi_i)
    while True:
        edges, _ = hysteresis(keep, edges)
        ext = halo_exchange(edges, 1, axis_name, "const", False)
        grown = edges | (keep & _dilate8(ext)[:, 1:-1, :])
        grew = psum(torch.any(grown != edges).to(torch.int32), axis_name)
        edges = grown
        if not int(grew):
            return edges.to(torch.uint8) * 255


def _local_op(fn: Callable) -> Callable:
    """A pointwise planes op (no state across rows or shards) in the
    registry's signature: it ignores ``axis_name``."""
    def run(local, axis_name: str = "y", **kw):
        return fn(local, **kw)

    return run


def _equalize_hist_global_spatial(local, axis_name: str = "y", **kw):
    """Pooled hist-eq over rows × frames × shards: the psum of
    ``equalize_hist_global_planes`` pools across any named axis."""
    return equalize_hist_global_planes(local, axis_name=axis_name, **kw)


def _remap_stage(local: torch.Tensor, map_x, map_y, interpolation: str = "linear",
                 border: str = "constant", border_value: float = 0.0,
                 axis_name: str = "y") -> torch.Tensor:
    """The registry's ``remap`` stage: it takes the WHOLE ``(oh, ow)`` maps,
    as the unsharded ``remap`` does, and each shard renders its own rows of
    them, so a pipeline's ``remap`` stage equals the unsharded op.  (The JAX
    package's stage passes the whole maps to ``remap_spatial``, which reads
    them as each shard's block: every shard renders every row, ``n·oh`` rows
    in all; ROADMAP R12.)"""
    n, idx = axis_size(axis_name), axis_index(axis_name)
    maps = [m if isinstance(m, torch.Tensor) else np.asarray(m) for m in (map_x, map_y)]
    oh = maps[0].shape[0]
    if oh % n:
        raise ValueError(f"spatial remap needs the maps' {oh} rows divisible by the "
                         f"{n}-shard mesh axis")
    rows = slice(idx * (oh // n), (idx + 1) * (oh // n))
    return remap_spatial(local, *(m[rows] for m in maps), interpolation, border, border_value,
                         axis_name)


SPATIAL_OP_REGISTRY: dict[str, Callable] = {
    # pointwise: no state across shards, the planes op runs as it is
    "gamma": _local_op(gamma_planes),
    "log_transform": _local_op(log_planes),
    "convert_scale_abs": _local_op(convert_scale_abs_planes),
    "threshold": _local_op(threshold_planes),
    # pooled statistics and halo ops: the twins
    "contrast_stretch": contrast_stretch_spatial,
    "equalize_hist": equalize_hist_spatial,
    "equalize_hist_global": _equalize_hist_global_spatial,
    "clahe": clahe_spatial,
    "gaussian_blur": gaussian_blur_spatial,
    "box_blur": box_blur_spatial,
    "bilateral": bilateral_spatial,
    "adaptive_threshold": adaptive_threshold_spatial,
    "erode": erode_spatial,
    "dilate": dilate_spatial,
    "morphology": morphology_spatial,
    "sobel": sobel_spatial,
    "filter2d": filter2d_spatial,
    "laplacian_sharpen": laplacian_sharpen_spatial,
    "unsharp_mask": unsharp_mask_spatial,
    "median_blur": median_blur_spatial,
    # geometry: output rows split across the shards
    "resize": resize_spatial,
    "warp_affine": warp_affine_spatial,
    "remap": _remap_stage,
    "canny": canny_spatial,
}


def spatial_chain(stages, axis_name: str = "y") -> Callable[[torch.Tensor], torch.Tensor]:
    """The local function of a row-sharded stage chain: stage specs
    ``name`` or ``(name, kwargs)`` from :data:`SPATIAL_OP_REGISTRY`, run in
    order on a shard's ``[B, h, W]`` block.  Validated here: an unknown
    name raises ``KeyError``.  A geometry stage changes the block's height
    and width; its output height must divide by the shard count."""
    chain = []
    for s in stages:
        name, kwargs = (s, {}) if isinstance(s, str) else s
        if name not in SPATIAL_OP_REGISTRY:
            raise KeyError(f"unknown spatial op {name!r}; available: {sorted(SPATIAL_OP_REGISTRY)}")
        kwargs = dict(kwargs)
        if "backend" in kwargs:
            raise TypeError(f"stage {name!r}: the port's ops take no 'backend' argument")
        chain.append((SPATIAL_OP_REGISTRY[name], kwargs))

    def run(local: torch.Tensor) -> torch.Tensor:
        for fn, kwargs in chain:
            local = fn(local, axis_name=axis_name, **kwargs)
        return local

    return run


def make_spatial_pipeline(stages, mesh: Mesh, axis_name: str = "y",
                          batch_axis: str | None = None) -> Callable:
    """Row-sharded twin of ``pipeline.make_pipeline``: the same stage specs
    over ``[B, H, W]`` planes whose rows split along ``axis_name`` (H must
    divide by its size).  Example, config 5 over a mesh::

        pipe = make_spatial_pipeline([
            ("median_blur", {"ksize": 5}),
            ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
            ("unsharp_mask", {"amount": 1.0}),
        ], mesh)
        out = pipe(planes)
    """
    return shard_spatial(spatial_chain(stages, axis_name), mesh, axis_name, batch_axis)
