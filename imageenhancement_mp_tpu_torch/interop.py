"""State carried across from the JAX package.

The system has no weights.  Its only state is the fixed-point tap tables
(``utils/taps.py``, host NumPy in both packages), the per-plane LUTs (the
point ops' tables of any dtype through :func:`luts_from_jax`),
CLAHE's per-tile LUTs, the bilateral disc and colour table, the f64 taps
of the Gaussian adaptive threshold, the warps' f32 coordinate fields, the
u8 Lab and Luv tables and the non-local-means weight LUT.  The JAX flagship keeps each plane's 256-entry LUT
as ``[B, 2, 128]`` int32 (``lut2``, the JAX package's pipeline.py:210);
the port keeps ``[B, 256]`` u8.  JAX's CLAHE stage B returns ``[B·gh·gw, S]``
u8 or u16 tile LUTs, tiles in ``(b, ty, tx)`` order; the port's stage C reads
the same layout as a contiguous ``[B·gh·gw, S]`` tensor.  Inputs arrive as NumPy arrays, the format both packages
share; the tensors made here lie on the CPU until the caller moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.nlm_tables import nlm_weight_lut
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["planes_from_numpy", "luts_from_lut2", "luts_from_jax", "clahe_luts_from_jax",
           "bilateral_tables_from_jax", "athresh_taps_from_jax", "warp_maps_from_jax",
           "color_tables_from_jax", "nlm_lut_from_jax"]

_LUT_DTYPES = tuple(map(np.dtype, (np.uint8, np.uint16, np.int16, np.int32, np.float32)))


def planes_from_numpy(arr: np.ndarray, channels_last: bool = True) -> torch.Tensor:
    """A NumPy image or batch → contiguous ``[B, H, W]`` CPU planes, in the
    plane order both packages' ``as_planes`` use."""
    planes, _ = as_planes(torch.from_numpy(np.ascontiguousarray(arr)), channels_last)
    return planes.contiguous()


def luts_from_lut2(lut2) -> torch.Tensor:
    """The JAX flagship's ``[B, 2, 128]`` int32 ``lut2`` → the port's
    ``[B, 256]`` u8 (row-major: entry v is ``lut2[b, v // 128, v % 128]``)."""
    a = np.asarray(lut2)
    if a.ndim != 3 or a.shape[1:] != (2, 128):
        raise ValueError(f"expected a [B, 2, 128] lut2, got {a.shape}")
    if a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError("lut2 entries must lie in 0..255 for a u8 LUT")
    return torch.from_numpy(a.reshape(a.shape[0], 256).astype(np.uint8))


def luts_from_jax(luts) -> torch.Tensor:
    """The JAX package's point-op tables (gamma, log and convertScaleAbs
    tables, ``ops/pointwise.py::stretch_luts_from_minmax``'s output, K-table
    stacks; u8, u16, i16, i32 or f32) → the port's CPU tensor of the same
    dtype and layout: ``[256]`` or ``[B, 256]`` for ``kernels/hist.py::
    apply_lut256``, ``[B, K, 256]`` for ``apply_luts_multi``, ``[65536]`` or
    ``[B, 65536]`` for u16 planes."""
    a = np.array(luts)  # a copy: JAX's arrays are read-only
    ok = (a.ndim in (1, 2) and a.shape[-1] in (256, 65536)) or (a.ndim == 3 and a.shape[-1] == 256)
    if a.dtype not in _LUT_DTYPES or not ok:
        raise ValueError(f"expected a [256], [B, 256], [B, K, 256], [65536] or [B, 65536] table "
                         f"of u8/u16/i16/i32/f32, got {a.dtype} {a.shape}")
    return torch.from_numpy(a)


def clahe_luts_from_jax(luts, B: int, gh: int, gw: int) -> torch.Tensor:
    """JAX's CLAHE stage-B output (``ops/clahe.py::clahe_tile_luts`` over the
    tiles of B planes: ``[B·gh·gw, S]``, u8 with S = 256 or u16 with
    S = 65536) → the port's ``[B·gh·gw, S]`` CPU table for
    ``kernels/clahe.py::clahe_blend``."""
    a = np.asarray(luts)
    S = {np.dtype(np.uint8): 256, np.dtype(np.uint16): 65536}.get(a.dtype)
    if S is None or a.shape != (B * gh * gw, S):
        raise ValueError(f"expected [{B * gh * gw}, 256] u8 or [{B * gh * gw}, 65536] u16 "
                         f"tile LUTs, got {a.dtype} {a.shape}")
    return torch.from_numpy(a.copy())  # a writable, contiguous copy


def bilateral_tables_from_jax(offs, color_w) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's host bilateral tables (``ops/bilateral.py::bilateral_offsets``:
    the ``(i, j, w0)`` disc list and the ``[256·cn]`` f32 colour table) →
    the port's CPU tensors: ``[n, 3]`` f32 offsets rows ``(i, j, w0)`` in
    the same order, as ``kernels/bilateral.py`` reads them, and the f32 table
    (``[256]`` for gray)."""
    rows = np.asarray(offs, dtype=np.float64).reshape(-1, 3)
    if len(rows) == 0 or np.any(rows[:, :2] != np.round(rows[:, :2])) \
            or np.any(rows[:, 2] != rows[:, 2].astype(np.float32)):
        raise ValueError("expected a non-empty list of (i, j, w0) with integer i, j "
                         "and f32-exact w0")
    cw = np.asarray(color_w)
    if cw.dtype != np.float32 or cw.shape not in ((256,), (768,)):
        raise ValueError(f"expected a [256] or [768] f32 colour table, got {cw.dtype} {cw.shape}")
    return torch.from_numpy(rows.astype(np.float32)), torch.from_numpy(cw.copy())


def athresh_taps_from_jax(taps) -> torch.Tensor:
    """The f64 taps JAX's Gaussian adaptive threshold takes
    (``ref/ops.py::gaussian_kernel(block_size, 0)``, passed to
    ``kernels/dfconv.py`` as Python floats) → the port's ``[k]`` f64 CPU
    tensor for ``kernels/athresh.py``."""
    t = np.asarray(taps, dtype=np.float64)
    if t.ndim != 1 or t.shape[0] < 3 or t.shape[0] % 2 == 0:
        raise ValueError(f"expected an odd number >= 3 of taps, got shape {t.shape}")
    return torch.from_numpy(t.copy())


def warp_maps_from_jax(sx, sy) -> tuple[torch.Tensor, torch.Tensor]:
    """A warp's only state, its coordinate field: the f32 ``(oh, ow)`` maps
    the JAX package bakes with ``ref/``'s f32 functions
    (``warp_affine_coords_f32``, ``warp_perspective_coords_f32``,
    ``_warp_polar_maps``) → the port's contiguous f32 CPU tensors, as
    ``kernels/warp.py::warp_gather_u8`` and ``ops/warp.py::remap_planes``
    read them."""
    a, b = np.asarray(sx), np.asarray(sy)
    if a.dtype != np.float32 or b.dtype != np.float32 or a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"expected two f32 (oh, ow) maps of one shape, got {a.dtype} {a.shape} "
                         f"and {b.dtype} {b.shape}")
    return torch.from_numpy(a.copy()), torch.from_numpy(b.copy())


def color_tables_from_jax(lab_tabs, luv_tabs) -> tuple[tuple, tuple]:
    """The JAX package's u8 colour tables → the port's CPU layouts.

    ``lab_tabs``: the nine of ``ops/color.py::_lab_device_tabs`` (``gamma_b,
    cbrt_b, y_b, ify_b, adiv, bdiv, minab, abxz, invg``: int32 tables, and
    ``minab`` an integer) → the same nine as ``ops/color.py::_lab_device_tabs``
    holds them: contiguous int32 tensors and ``minab`` an int.
    ``luv_tabs``: ``ops/color.py::_luv_host_tabs`` (the ``[256]`` input table
    and the ``[35937, 3]`` grid) → the first four of
    ``ops/color.py::_luv_device_tabs``: the input table and the grid's three
    columns, ``[35937]`` each."""
    if len(lab_tabs) != 9 or len(luv_tabs) != 2:
        raise ValueError("expected the nine Lab tables and the two Luv tables")
    lab = [np.array(a) for a in lab_tabs]  # copies: JAX's arrays are read-only
    sizes = (256, 3072, 256, 256, 256, 256, None, 36864, 4096)
    for a, n in zip(lab, sizes):
        if n is not None and (a.shape != (n,) or a.dtype != np.int32):
            raise ValueError(f"expected a [{n}] int32 Lab table, got {a.dtype} {a.shape}")
    if lab[6].shape != () or not np.issubdtype(lab[6].dtype, np.integer):
        raise ValueError(f"expected minab as an integer, got {lab[6]!r}")
    tab, grid = (np.array(a) for a in luv_tabs)
    if tab.shape != (256,) or grid.shape != (33 ** 3, 3) or tab.dtype != np.int32 \
            or grid.dtype != np.int32:
        raise ValueError(f"expected a [256] and a [35937, 3] int32 Luv table, got "
                         f"{tab.dtype} {tab.shape} and {grid.dtype} {grid.shape}")
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lab_t = (*map(as_t, lab[:6]), int(lab[6]), as_t(lab[7]), as_t(lab[8]))
    return lab_t, (as_t(tab), *(as_t(grid[:, c]) for c in range(3)))


def nlm_lut_from_jax(lut, h: float, t: int, s: int, cn: int = 1, temporal: int = 1,
                     norm: str = "l2", maxval: int = 255) -> tuple[torch.Tensor, int, int]:
    """The weight LUT the JAX package's ``ops/nlmeans.py`` builds for these
    parameters (the live prefix of ``ref/ops.py::_nlm_weight_lut``: int32
    for u8, int64 for u16, ``maxval`` 65535) → the port's triple, as
    ``ops/nlmeans.py::_lut`` returns it: the CPU table, its bin shift and its
    last index.  Raises when the table's length or dtype does not fit the
    parameters."""
    w, bs, _ = nlm_weight_lut(float(h), int(t), int(s), int(cn), temporal=int(temporal),
                              norm=str(norm), maxval=int(maxval))
    a = np.asarray(lut)
    dtype = np.int64 if maxval > 255 else np.int32
    if a.shape != w.shape or a.dtype != dtype:
        raise ValueError(f"expected a {w.shape} {np.dtype(dtype)} LUT for these parameters, "
                         f"got {a.dtype} {a.shape}")
    return torch.from_numpy(a.copy()), bs, len(a) - 1
