"""Point ops: ``cv2.LUT``, gamma and log transforms, ``cv2.normalize(MINMAX)``,
``cv2.convertScaleAbs``, ``cv2.addWeighted``, ``cv2.integral``/``integral2``,
``cv2.applyColorMap`` and ``cv2.calcBackProject``.

The counterpart of the JAX package's ``ops/pointwise.py``, whole.  u8
planes with a 256-entry table, of any table dtype, go through
``kernels/hist.py::apply_lut256``; u16 planes with 65536-entry tables and
i16 planes are a plain torch gather on both devices, as the JAX package
keeps them in XLA.  The host tables (``utils/lut_tables.py``) are copied to
a device once and kept there.  The stretch builds its tables on the device
from each plane's minimum and maximum, with cv2's f64 scale and shift in
native f64: the JAX package emulates that f64 with double-float tables
(:155-166, :219-239) only because the TPU has none.  The integral images
sum in f64 on the device for the same reason and cast once: the JAX
package's f32 sums are its stand-in for cv2's f64.  ``calc_back_project``
folds its bins, scale and rounding into one host f64 → u8 table and runs
``apply_lut256``; ``apply_color_map`` is a ``[256, 3]`` table gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256, take_rows
from imageenhancement_mp_tpu_torch.utils import lut_tables
from imageenhancement_mp_tpu_torch.utils.colormaps import colormap_table
from imageenhancement_mp_tpu_torch.utils.fma import fma32
from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.shapes import host_array

__all__ = ["apply_lut_planes", "gamma_planes", "log_planes", "convert_scale_abs_planes",
           "contrast_stretch_planes", "plane_minmax", "stretch_planes", "stretch_luts_from_minmax", "add_weighted_arrays",
           "integral_planes", "apply_color_map_planes", "calc_back_project_planes"]

F32, F64 = torch.float32, torch.float64


@functools.lru_cache(maxsize=64)
def _device_table(name: str, args: tuple, device: torch.device) -> torch.Tensor:
    """``utils/lut_tables.py``'s table ``name(*args)``, copied to ``device``
    once: a host copy made per call would wait for the device's stream."""
    return torch.from_numpy(getattr(lut_tables, name)(*args)).to(device)


def _gather_planes(planes: torch.Tensor, lut: torch.Tensor, minv: int = 0) -> torch.Tensor:
    """``lut[v − minv]`` for each value v of each plane; ``lut`` is ``[S]``
    shared or ``[B, S]`` per plane."""
    idx = planes.reshape(planes.shape[0], -1).to(torch.int64)
    return take_rows(lut, idx - minv if minv else idx).reshape(planes.shape)


def apply_lut_planes(planes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``cv2.LUT`` ≡ gather: ``lut`` is ``[S]`` shared or ``[B, S]`` per
    plane, S = 256 for u8 planes (a u8, u16, i16, i32 or f32 table, through
    the kernel on CUDA) or 65536 for u16 planes.  Output dtype = table
    dtype."""
    if lut.device != planes.device:
        raise ValueError(f"planes on {planes.device}, table on {lut.device}")
    if planes.dtype == torch.uint8 and lut.shape[-1] == 256:
        return apply_lut256(planes.contiguous(), lut.contiguous())
    if planes.dtype == torch.uint16 and lut.shape[-1] == 65536 and (
            lut.dim() == 1 or (lut.dim() == 2 and lut.shape[0] == planes.shape[0])):
        return _gather_planes(planes, lut)
    raise ValueError(f"cv2.LUT takes u8 planes with 256-entry tables or u16 planes with "
                     f"65536-entry tables, [S] or [B, S]; got {planes.dtype} planes "
                     f"{tuple(planes.shape)} and a {tuple(lut.shape)} table")


def _check_point_dtype(planes: torch.Tensor, what: str) -> None:
    if planes.dtype == torch.int16:
        raise TypeError(f"{what} is defined for uint8/uint16/float32 (not int16)")
    if planes.dtype not in (torch.uint8, torch.uint16, F32):
        raise TypeError(f"{what} takes uint8/uint16/float32 planes, got {planes.dtype}")


def gamma_planes(planes: torch.Tensor, gamma: float) -> torch.Tensor:
    """uint8/uint16: LUT path (exact).  float32: direct ``255·(r/255)^γ``."""
    _check_point_dtype(planes, "gamma")
    if planes.dtype == F32:
        r = planes.clamp_min(0.0) * (1.0 / 255.0)
        return 255.0 * torch.pow(r, float(np.float32(gamma)))
    name = "gamma_lut16" if planes.dtype == torch.uint16 else "gamma_lut_host"
    return apply_lut_planes(planes, _device_table(name, (float(gamma),), planes.device))


def log_planes(planes: torch.Tensor) -> torch.Tensor:
    """uint8/uint16: LUT path (exact).  float32: direct ``c·log(1+r)``."""
    _check_point_dtype(planes, "log_transform")
    if planes.dtype == F32:
        return float(np.float32(255.0 / np.log(256.0))) * torch.log1p(planes.clamp_min(0.0))
    name = "log_lut16" if planes.dtype == torch.uint16 else "log_lut_host"
    return apply_lut_planes(planes, _device_table(name, (), planes.device))


def convert_scale_abs_planes(planes: torch.Tensor, alpha: float = 1.0,
                             beta: float = 0.0) -> torch.Tensor:
    """``cv2.convertScaleAbs`` per plane — ``saturate_u8(round(|α·x+β|))``,
    u8 for every input dtype.  Integer inputs use exact tables built with
    cv2's single-rounded f32 FMA; float32 computes that FMA with ``fma32``."""
    if planes.dtype == F32:
        a, b = (torch.full((), float(np.float32(v)), dtype=F32, device=planes.device)
                for v in (alpha, beta))
        out = torch.abs(torch.round(fma32(planes, a, b)))
        return out.clamp(0, 255).to(torch.int32).to(torch.uint8)
    if planes.dtype == torch.int16:
        lut = _device_table("convert_scale_abs_lut", (float(alpha), float(beta), 65536, -32768),
                            planes.device)
        return _gather_planes(planes, lut, -32768)
    if planes.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"convert_scale_abs takes uint8/uint16/int16/float32, got {planes.dtype}")
    n = 65536 if planes.dtype == torch.uint16 else 256
    lut = _device_table("convert_scale_abs_lut", (float(alpha), float(beta), n), planes.device)
    return apply_lut_planes(planes, lut)


_INT_RANGE = {torch.uint8: (0, 255), torch.uint16: (0, 65535), torch.int16: (-32768, 32767)}


def contrast_stretch_planes(planes: torch.Tensor,
                            out_range: tuple[float, float] = (0.0, 255.0)) -> torch.Tensor:
    """``cv2.normalize(MINMAX, α, β)`` per plane — exact for u8/u16/i16
    across arbitrary float ranges.  The range is sorted (the plane's minimum
    maps to min(α, β)); a constant plane maps to α.  float32: cv2's float
    path, no rounding."""
    lo, hi = plane_minmax(planes)
    return stretch_planes(planes, lo, hi, out_range)


def plane_minmax(planes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each plane's ``[B]`` minimum and maximum, as :func:`stretch_planes`
    takes them: f32 for f32 planes, int32 for u16, the planes' dtype else."""
    if planes.dtype != F32 and planes.dtype not in _INT_RANGE:
        raise TypeError(f"contrast_stretch takes uint8/uint16/int16/float32, got {planes.dtype}")
    flat = planes.reshape(planes.shape[0], -1)
    # torch's CPU min/max has no uint16
    return torch.aminmax(flat.to(torch.int32) if planes.dtype == torch.uint16 else flat, dim=1)


def stretch_planes(planes: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   out_range: tuple[float, float] = (0.0, 255.0)) -> torch.Tensor:
    """:func:`contrast_stretch_planes` with each plane's ``[B]`` minimum
    ``lo`` and maximum ``hi`` given (:func:`plane_minmax`), as a row-sharded
    frame pools them across its shards."""
    a, b = sorted((float(out_range[0]), float(out_range[1])))
    if planes.dtype == F32:
        lo, hi = lo[:, None, None], hi[:, None, None]
        # tensor / tensor: one IEEE division, as JAX's f32 (b − a) / d
        scale = torch.full_like(lo, b - a) / torch.clamp_min(hi - lo, 1e-45)
        out = (planes - lo) * scale + a
        return torch.where(hi == lo, a, out)
    minv, maxv = _INT_RANGE[planes.dtype]
    luts = stretch_luts_from_minmax(lo, hi, a, b, maxv, planes.dtype, minv)
    if planes.dtype == torch.uint8:
        return apply_lut_planes(planes, luts)  # the LUT kernel on CUDA
    return _gather_planes(planes, luts, minv)


def stretch_luts_from_minmax(lo: torch.Tensor, hi: torch.Tensor, a: float, b: float, maxv: int,
                             dtype: torch.dtype, minv: int = 0) -> torch.Tensor:
    """cv2-exact normalize(MINMAX) LUTs from per-plane ``[B]`` minima and
    maxima (plane values, negative for int16), built on their device:
    ``[B, maxv − minv + 1]`` in ``dtype``, indexed by ``value − minv``.
    ``a ≤ b``.

    cv2's law (``ref/ops.py:268-279``): f64 ``scale = (b − a)·(1/(hi − lo))``
    and ``shift = a − lo·scale``, then per entry ``f32(i·f64(f32 scale) +
    f64(f32 shift))`` rounded half to even and saturated; a constant plane
    gives ``round(a)`` saturated.  Each product and sum is its own torch op,
    so nothing contracts them."""
    lo64, hi64 = lo.to(F64), hi.to(F64)
    d = hi64 - lo64
    one = torch.ones_like(d)
    scale = (b - a) * (one / torch.where(d == 0, one, d))
    shift = a - lo64 * scale
    s32, sh32 = scale.to(F32).to(F64), shift.to(F32).to(F64)
    i = torch.arange(minv, maxv + 1, dtype=F64, device=lo.device)
    prod = i[None, :] * s32[:, None]  # exact: ≤ 17 integer bits times an f32 value
    val = torch.add(prod, sh32[:, None]).to(F32)  # one f64 rounding, then one to f32
    lut = torch.round(val).clamp(minv, maxv).to(torch.int32)
    fill = int(round(max(min(a, float(maxv)), float(minv))))
    return torch.where((d == 0)[:, None], fill, lut).to(dtype)


_DTYPES = (torch.uint8, torch.uint16, torch.int16, F32)


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {x.dtype}")


def add_weighted_arrays(src1: torch.Tensor, alpha: float, src2: torch.Tensor, beta: float,
                        gamma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(src1, α, src2, β, γ)`` — exact, all dtypes,
    elementwise over any matching shapes.  cv2's two single-rounded f32 FMAs
    ``f32(src1·f32(α) + f32(src2·f32(β) + f32(γ)))`` (``fma32``), then
    cvRound (half to even) and saturation for integer dtypes; float32
    returns the f32 accumulator unrounded."""
    if src2.dtype != src1.dtype:
        raise TypeError(f"src dtypes differ: {src1.dtype} vs {src2.dtype}")
    if src2.shape != src1.shape:
        raise ValueError(f"src shapes differ: {tuple(src1.shape)} vs {tuple(src2.shape)}")
    if src2.device != src1.device:
        raise ValueError(f"src devices differ: {src1.device} vs {src2.device}")
    _check_dtype(src1)
    al, be, ga = (torch.full((), float(np.float32(v)), dtype=F32, device=src1.device)
                  for v in (alpha, beta, gamma))
    acc = fma32(src1.to(F32), al, fma32(src2.to(F32), be, ga))
    if src1.dtype == F32:
        return acc
    minv, maxv = int_bounds(src1.dtype)
    return torch.round(acc).clamp(minv, maxv).to(torch.int32).to(src1.dtype)


def _integral(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zero-padded ``[B, H+1, W+1]`` cumulative sums of ``x`` (int64 or f64)
    cast once to ``dtype``."""
    s = torch.nn.functional.pad(x.cumsum(-2).cumsum(-1), (1, 0, 1, 0))
    return s.to(dtype)


def integral_planes(planes: torch.Tensor, sq: bool = False):
    """``cv2.integral``/``integral2`` per plane: ``[B, H+1, W+1]``
    zero-padded cumulative sums.  u8 → int32, exact (int32 wraps as the JAX
    package's int32 sums do past 2^31 − 1); u16/i16/f32 → f32, as the JAX
    package returns them, summed in f64 on the device and cast once, so
    u16/i16 equal ``f32(ref)``.  ``sq=True`` also returns the squared sums,
    f32 for every dtype, made the same way."""
    _check_dtype(planes)
    if planes.dtype == torch.uint8:
        s = _integral(planes.to(torch.int64), torch.int32)
    else:
        s = _integral(planes.to(F64), F32)
    if not sq:
        return s
    p = planes.to(F64)
    return s, _integral(p * p, F32)


@functools.lru_cache(maxsize=64)
def _colormap_device(name: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(colormap_table(name)).to(device)


def apply_color_map_planes(planes: torch.Tensor, colormap: str = "jet") -> torch.Tensor:
    """``cv2.applyColorMap`` per plane: ``[B, H, W]`` u8 → ``[B, H, W, 3]``
    RGB through cv2's 256-entry table (bitwise)."""
    if planes.dtype != torch.uint8:
        raise TypeError("applyColorMap requires uint8 input")
    tab = _colormap_device(str(colormap), planes.device)
    return tab.index_select(0, planes.reshape(-1).to(torch.int64)).reshape(*planes.shape, 3)


@functools.lru_cache(maxsize=64)
def _back_project_lut(hist: tuple, scale: float, device: torch.device) -> torch.Tensor:
    """The 256-entry u8 table ``saturate(round(hist[v·bins/256]·scale))``,
    built on the host in f64 and copied to ``device`` once."""
    h = np.asarray(hist, np.float64)
    idx = (np.arange(256, dtype=np.int64) * len(h)) // 256
    lut = np.clip(np.round(h[idx] * scale), 0, 255).astype(np.uint8)
    return torch.from_numpy(lut).to(device)


def calc_back_project_planes(planes: torch.Tensor, hist, scale: float = 1.0) -> torch.Tensor:
    """``cv2.calcBackProject`` per plane (u8, range [0, 256)) — exact: one
    ``apply_lut256`` with the folded table (bin = v·bins/256, out =
    saturate(round(hist[bin]·scale)))."""
    if planes.dtype != torch.uint8:
        raise TypeError("calcBackProject requires uint8 input")
    h = tuple(float(v) for v in host_array(hist).astype(np.float64).ravel())
    return apply_lut256(planes.contiguous(), _back_project_lut(h, float(scale), planes.device))
