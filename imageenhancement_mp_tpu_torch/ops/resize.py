"""Geometric resize (``cv2.resize``) and the exact rearrangements
``cv2.flip``, ``cv2.rotate`` and ``cv2.transpose`` on ``[B, H, W]`` planes.

The JAX package's ``ops/resize.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there).  Every index and coefficient table is
built on the host in NumPy from ``utils/resize_tables.py`` (``ref/``'s
tables, copied), once per geometry and device, and gathered with
``index_select``.  The laws, pinned to ``ref/ops.py::resize``:

* nearest: ``min(floor(dx·n/on), n − 1)`` per axis.
* linear u8: cv2's 2^11 fixed point in int32, horizontal at full precision,
  the vertical mul-high ``(x·b) >> 16`` and ``(t + 2) >> 2``.  Other
  dtypes: cv2's f32 lerp per axis, one torch op per multiply and add.
* cubic u8: 2^11 taps on both axes and one ``(v + 2^21) >> 22``, summed
  exactly in int64 as ``ref/`` does (the JAX package's f32 vertical pass
  can be 1 off on razor ties).  Lanczos-4 u8: the JAX package's centred
  int32 sums, which equal ``ref/``'s int64 ones and wrap mod 2^32 where cv2's
  int vertical wraps.  Other dtypes: ``ref/``'s f32 sums in tap order.
* area: integer factors as a sum over each cell (the 2×2 case half up,
  ``(s + 2) >> 2``, else ``cvRound(s·f32(1/(f1·f2)))``); any other
  downscale as ``ref/``'s f64 cell sums: the cell's terms ``x·(wy·wx)`` in
  NumPy's pairwise order (the JAX package's f32 matmuls are its stand-in);
  an upscale axis the linear machinery with INTER_AREA coordinates.

Row sharding (``parallel/spatial.py::resize_spatial``) runs the same code on
a shard's halo-extended row block with its rows of the y tables
(:func:`shard_row_tables`, indices rebased onto the block), so each shard's
output rows are the unsharded op's bit for bit.

Flip, rotate and transpose return contiguous tensors; uint16 planes flip
through their int16 view (torch has no ``flip`` for uint16 on the CPU).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import host_derived
from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.resize_tables import (cubic_weights, lanczos4_weights,
                                                               resize_cubic_tables,
                                                               resize_lanczos_tables,
                                                               resize_lin_tables)

__all__ = ["resize_planes", "flip_planes", "rotate_planes", "transpose_planes", "INTERPOLATIONS",
           "check_resize", "row_kind", "row_reach", "shard_row_tables", "resize_rows"]

INTERPOLATIONS = ("nearest", "linear", "cubic", "lanczos4", "area")
_DTYPES = (torch.uint8, torch.uint16, torch.int16, torch.float32)
_RESIZE_SCALE = 1 << 11
# per-shard y tables kept on their device: 4 shards of 8 geometries, apart
# from the unsharded tables' own cache
_SHARD_TABLES = 32
# f64 terms of the general area downscale held at once (128 MiB)
_AREA_TERMS = 1 << 24
F32, F64, I32, I64 = torch.float32, torch.float64, torch.int32, torch.int64


def _fixed_coeffs(frac: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    c2 = np.round(frac.astype(np.float64) * _RESIZE_SCALE).astype(np.int32)
    return _RESIZE_SCALE - c2, c2


@functools.lru_cache(maxsize=16)
def _host_tables(kind: str, n: int, on: int) -> tuple[np.ndarray, ...]:
    """One axis's host tables: indices first, then coefficients.  Linear
    and nearest tables are ``(on,)``; the tap kinds (cubic, Lanczos-4 and
    the area band) are stored transposed, taps × output lines.  Shared:
    do not write to them."""
    if kind in ("lin", "area_lin"):
        i0, i1, r = resize_lin_tables(n, on, kind == "area_lin")
        c1, c2 = _fixed_coeffs(r)
        one = np.float32(1)
        return i0, i1, c1, c2, (one - r).astype(np.float32), r
    if kind == "nearest":
        return (np.minimum((np.arange(on) * (n / on)).astype(np.int64), n - 1),)
    if kind in ("cubic", "lanczos"):
        idx, r = (resize_cubic_tables if kind == "cubic" else resize_lanczos_tables)(n, on)
        w = cubic_weights if kind == "cubic" else lanczos4_weights
        fixed = np.stack([np.round(np.asarray(w(float(t)), np.float64) * 2048).astype(np.int64)
                          for t in r])
        flt = np.stack([w(float(t)) for t in r]).astype(np.float32)
        return idx.T.copy(), fixed.T.copy(), flt.T.copy()
    if kind == "area":
        return _area_band(n, on)
    raise ValueError(kind)


@functools.lru_cache(maxsize=64)
def _tables(kind: str, n: int, on: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_host_tables`` copied to ``device`` once: a host copy made per call
    would wait for the device's stream."""
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in _host_tables(kind, n, on))


def _area_band(n: int, on: int) -> tuple[np.ndarray, np.ndarray]:
    """The area-overlap band of each output cell along one axis (a
    downscale): ``(idx, w)``, each ``(K, on)`` with K the widest band, the
    input lines each output line overlaps and their f64 weights, in
    ``ref/``'s order.  A shorter band is padded with its last line at
    weight 0, so every padded term reads a line the band already reads."""
    scale = n / on
    bands = []
    for d in range(on):
        lo, hi = d * scale, min((d + 1) * scale, n)
        cells = np.arange(int(np.floor(lo)), min(int(np.ceil(hi)), n))
        bands.append((cells, np.minimum(cells + 1, hi) - np.maximum(cells, lo)))
    K = max(len(c) for c, _ in bands)
    idx = np.empty((K, on), np.int64)
    w = np.zeros((K, on), np.float64)
    for d, (cells, wd) in enumerate(bands):
        idx[:, d] = cells[-1]
        idx[:len(cells), d] = cells
        w[:len(cells), d] = wd
    return idx, w


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-2, idx)


def _cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-1, idx)


def _linear(planes: torch.Tensor, ow: int, kind: str, ytab: tuple) -> torch.Tensor:
    """Linear (or INTER_AREA-coordinate linear) resize through the y tables
    ``ytab`` (``_host_tables`` order, one entry an output row)."""
    iy0, iy1, cy1, cy2, ry0, ry1 = ytab
    ix0, ix1, cx1, cx2, rx0, rx1 = _tables(kind, planes.shape[-1], ow, planes.device)
    if planes.dtype == torch.uint8:
        a = planes.to(I32)
        sh = _cols(a, ix0) * cx1 + _cols(a, ix1) * cx2            # scale 2^11
        x0, x1 = _rows(sh, iy0) >> 4, _rows(sh, iy1) >> 4         # scale 2^7
        t = ((x0 * cy1[:, None]) >> 16) + ((x1 * cy2[:, None]) >> 16)
        return ((t + 2) >> 2).clamp(0, 255).to(torch.uint8)
    a = planes.to(F32)
    h = _cols(a, ix0) * rx0 + _cols(a, ix1) * rx1
    v = _rows(h, iy0) * ry0[:, None] + _rows(h, iy1) * ry1[:, None]
    return _round_cast(v, planes.dtype)


def _round_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """cvRound (half to even) and saturation of an f32 or f64 result."""
    if dtype == F32:
        return v.to(F32)
    minv, maxv = int_bounds(dtype)
    return torch.round(v).clamp(minv, maxv).to(I32).to(dtype)


def _taps(planes: torch.Tensor, ow: int, kind: str, ytab: tuple) -> torch.Tensor:
    """Cubic (4 taps) or Lanczos-4 (8 taps) resize through the y tables
    ``ytab`` (taps × output rows), horizontal pass first."""
    yi, yc, yf = ytab
    xi, xc, xf = _tables(kind, planes.shape[-1], ow, planes.device)
    n, oh = yi.shape
    if planes.dtype == torch.uint8 and kind == "cubic":
        a = planes.to(I64)
        S = sum(_cols(a, xi[k]) * xc[k] for k in range(n))                 # scale 2^11
        v = sum(_rows(S, yi[k]) * yc[k][:, None] for k in range(n))        # scale 2^22
        return ((v + (1 << 21)) >> 22).clamp(0, 255).to(torch.uint8)
    if planes.dtype == torch.uint8:
        # centred at 128, |Σc·(v−128)| ≤ 128·Σ|c| per axis keeps the 2^22
        # sums inside int32; the per-column and per-row tap sums restore the
        # mean (the rounded taps need not sum to 2048)
        xc32, yc32 = xc.to(I32), yc.to(I32)
        hsum, vsum = xc32.sum(0), yc32.sum(0)
        a = planes.to(I32) - 128
        S = sum(_cols(a, xi[k]) * xc32[k] for k in range(n)) + 128 * (hsum - 2048)
        v = sum(_rows(S, yi[k]) * yc32[k][:, None] for k in range(n))
        v = v + ((1 << 18) * vsum + (1 << 21))[:, None]
        return (v >> 22).clamp(0, 255).to(torch.uint8)
    a = planes.to(F32)
    S = torch.zeros((*a.shape[:-1], ow), dtype=F32, device=a.device)
    for k in range(n):
        S = S + _cols(a, xi[k]) * xf[k]
    v = torch.zeros((*a.shape[:-2], oh, ow), dtype=F32, device=a.device)
    for k in range(n):
        v = v + yf[k][:, None] * _rows(S, yi[k])
    return _round_cast(v, planes.dtype)


def _area_cells(planes: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Area downscale by integer factors: a sum over each cell."""
    B, H, W = planes.shape
    f1, f2 = H // oh, W // ow
    cells = planes.reshape(B, oh, f1, ow, f2)
    if planes.dtype == F32:
        s = cells.to(F64).sum((2, 4)).to(F32)
        return s * torch.tensor(np.float32(1.0 / (f1 * f2)))
    minv, maxv = int_bounds(planes.dtype)
    s = cells.to(I32).sum((2, 4), dtype=I32)
    if (f1, f2) == (2, 2):
        out = (s + 2) >> 2
    else:
        out = torch.round(s.to(F32) * torch.tensor(np.float32(1.0 / (f1 * f2))))
    return out.clamp(minv, maxv).to(I32).to(planes.dtype)


def _pairwise_sum(terms: list) -> torch.Tensor:
    """The sum of ``terms`` (equal-shaped f64 tensors) in NumPy's pairwise
    order for one contiguous run of that many values: fewer than 8 in turn;
    up to 128 as eight strided partials, ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``,
    then the tail in turn; more split at half the count, rounded down to a
    multiple of 8, each half summed the same way."""
    n = len(terms)
    if n < 8:
        s = terms[0]
        for t in terms[1:]:
            s = s + t
        return s
    if n <= 128:
        body = n - n % 8
        r = list(terms[:8])
        for i in range(8, body, 8):
            r = [a + b for a, b in zip(r, terms[i:i + 8])]
        s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for t in terms[body:]:
            s = s + t
        return s
    half = n // 2 - (n // 2) % 8
    return _pairwise_sum(terms[:half]) + _pairwise_sum(terms[half:])


def _band_groups(w: torch.Tensor) -> list:
    """The output lines of the band table ``w`` (``(K, on)``, padded with
    weight 0, every real weight above 0) grouped by their band's length:
    ``[(length, lines on w's device)]``, computed once per table."""
    def groups(wh: np.ndarray) -> list:
        lengths = (wh != 0).sum(0)
        return [(int(k), torch.from_numpy(np.flatnonzero(lengths == k)).to(w.device))
                for k in np.unique(lengths)]
    return host_derived(w, "area_groups", groups)


def _area_band_sum(planes: torch.Tensor, H: int, oh: int, ow: int, ytab: tuple) -> torch.Tensor:
    """Area downscale of the frame ``H`` rows high to ``oh`` rows through the
    band tables ``ytab`` (``_area_band``'s, one column an output row), each
    cell as ``ref/`` computes it: the f64 terms ``x · (wy·wx)`` (the outer
    weight rounded first) in row-major order of the cell, summed in NumPy's
    pairwise order for their count (:func:`_pairwise_sum`), then times
    cvRound's f32 ``1/cell area``.  Cells are taken by band lengths (the
    order depends on the count) and output rows in chunks of at most
    ``_AREA_TERMS`` terms."""
    yi, yw = ytab
    xi, xw = _tables("area", planes.shape[-1], ow, planes.device)
    a = planes.to(F64)
    B = a.shape[0]
    out = torch.empty((B, yi.shape[1], ow), dtype=F64, device=a.device)
    for ny, rows in _band_groups(yw):
        for nx, cols in _band_groups(xw):
            step = max(1, _AREA_TERMS // (B * len(cols) * ny * nx))
            for r0 in range(0, len(rows), step):
                r = rows[r0:r0 + step]
                terms = []
                for ky in range(ny):
                    band = _rows(a, yi[ky][r])
                    for kx in range(nx):
                        w = yw[ky][r][:, None] * xw[kx][cols]
                        terms.append(_cols(band, xi[kx][cols]) * w)
                # NumPy's reduction starts from +0.0: no cell sums to -0.0
                out[:, r[:, None], cols] = _pairwise_sum(terms) + 0.0
    cell = float(np.float32(1.0 / ((H / oh) * (planes.shape[-1] / ow))))
    return _round_cast(out * cell, planes.dtype)


def check_resize(planes: torch.Tensor, dsize) -> tuple[int, int]:
    """The dtype check of ``resize_planes`` and its ``(oh, ow)``."""
    if planes.dtype not in _DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    return oh, ow


def row_kind(interpolation: str, H: int, W: int, oh: int, ow: int) -> str | None:
    """The kind of y tables that resizing ``(H, W)`` to ``(oh, ow)`` reads,
    or None for the area downscale by integer factors, which reads none."""
    if interpolation == "area":
        if H >= oh and W >= ow:
            return None if H % oh == 0 and W % ow == 0 else "area"
        return "area_lin"
    kinds = {"nearest": "nearest", "linear": "lin", "cubic": "cubic", "lanczos4": "lanczos"}
    if interpolation not in kinds:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    return kinds[interpolation]


def row_reach(kind: str, H: int, oh: int) -> tuple[np.ndarray, np.ndarray]:
    """The least and greatest input row that each output row reads, ``(oh,)``
    each (host NumPy)."""
    tabs = _host_tables(kind, H, oh)
    if kind in ("lin", "area_lin"):
        return np.minimum(tabs[0], tabs[1]), np.maximum(tabs[0], tabs[1])
    if kind == "nearest":
        return tabs[0], tabs[0]
    return tabs[0].min(axis=0), tabs[0].max(axis=0)


@functools.lru_cache(maxsize=_SHARD_TABLES)
def shard_row_tables(kind: str, H: int, oh: int, n: int, idx: int, r: int,
                     device: torch.device) -> tuple[torch.Tensor, ...]:
    """Shard ``idx`` of ``n``'s y tables on ``device``: the rows ``[idx·oh/n,
    (idx+1)·oh/n)`` of ``_host_tables(kind, H, oh)`` (the second axis of the
    tap kinds' taps × rows tables), their indices rebased onto the shard's
    block extended by ``r`` halo rows a side (its first row is frame row
    ``idx·H/n − r``).  Copied to the device once: a host copy made per call
    would wait for the device's stream."""
    oloc, off = oh // n, idx * (H // n) - r
    rows = slice(idx * oloc, (idx + 1) * oloc)
    tabs = _host_tables(kind, H, oh)
    if kind == "nearest":
        cut = [tabs[0][rows] - off]
    elif kind in ("lin", "area_lin"):
        cut = [tabs[0][rows] - off, tabs[1][rows] - off] + [t[rows] for t in tabs[2:]]
    else:
        cut = [tabs[0][:, rows] - off] + [t[:, rows] for t in tabs[1:]]
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in cut)


def resize_rows(planes: torch.Tensor, H: int, oh: int, ow: int, kind: str,
                ytab: tuple) -> torch.Tensor:
    """Resize ``planes`` to ``ow`` columns and one row per entry of the y
    tables ``ytab`` (of ``kind``, indices into ``planes``' rows), for a frame
    of ``H`` rows resized to ``oh``: the whole frame with its own tables, or
    a shard's halo block with :func:`shard_row_tables`."""
    if kind == "nearest":
        return _cols(_rows(planes, ytab[0]), _tables("nearest", planes.shape[-1], ow,
                                                     planes.device)[0])
    if kind in ("lin", "area_lin"):
        return _linear(planes, ow, kind, ytab)
    if kind in ("cubic", "lanczos"):
        return _taps(planes, ow, kind, ytab)
    return _area_band_sum(planes, H, oh, ow, ytab)


def resize_planes(planes: torch.Tensor, dsize, interpolation: str = "linear") -> torch.Tensor:
    """``cv2.resize`` per plane on ``[B, H, W]``; ``dsize`` is (oh, ow)."""
    oh, ow = check_resize(planes, dsize)
    H, W = planes.shape[-2], planes.shape[-1]
    kind = row_kind(interpolation, H, W, oh, ow)
    if kind is None:
        return _area_cells(planes, oh, ow)
    return resize_rows(planes, H, oh, ow, kind, _tables(kind, H, oh, planes.device))


def _flip(planes: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    if planes.dtype == torch.uint16:
        return torch.flip(planes.view(torch.int16), dims).view(torch.uint16).contiguous()
    return torch.flip(planes, dims).contiguous()


def flip_planes(planes: torch.Tensor, code: int = 0) -> torch.Tensor:
    """``cv2.flip`` per plane: 0 rows, > 0 columns, < 0 both — exact."""
    code = int(code)
    return _flip(planes, (-2,) if code == 0 else (-1,) if code > 0 else (-2, -1))


def transpose_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.transpose`` per plane — exact."""
    return planes.transpose(-1, -2).contiguous()


def rotate_planes(planes: torch.Tensor, code: str = "90cw") -> torch.Tensor:
    """``cv2.rotate`` per plane (90cw | 180 | 90ccw) — exact."""
    if code == "90cw":
        return _flip(planes.transpose(-1, -2), (-1,))
    if code == "180":
        return _flip(planes, (-2, -1))
    if code == "90ccw":
        return _flip(planes.transpose(-1, -2), (-2,))
    raise ValueError(f"unknown rotation {code!r} (90cw|180|90ccw)")
