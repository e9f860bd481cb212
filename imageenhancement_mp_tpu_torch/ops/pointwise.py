"""Point ops: ``cv2.LUT``, gamma and log transforms, ``cv2.normalize(MINMAX)``
and ``cv2.convertScaleAbs``.

The counterpart of the JAX package's ``ops/pointwise.py`` (:34-241).  u8
planes with a 256-entry table, of any table dtype, go through
``kernels/hist.py::apply_lut256``; u16 planes with 65536-entry tables and
i16 planes are a plain torch gather on both devices, as the JAX package
keeps them in XLA.  The host tables (``utils/lut_tables.py``) are copied to
a device once and kept there.  The stretch builds its tables on the device
from each plane's minimum and maximum, with cv2's f64 scale and shift in
native f64: the JAX package emulates that f64 with double-float tables
(:155-166, :219-239) only because the TPU has none.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256, take_rows
from imageenhancement_mp_tpu_torch.utils import lut_tables
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["apply_lut_planes", "gamma_planes", "log_planes", "convert_scale_abs_planes",
           "contrast_stretch_planes", "stretch_luts_from_minmax"]

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
    a, b = sorted((float(out_range[0]), float(out_range[1])))
    B = planes.shape[0]
    if planes.dtype == F32:
        lo, hi = torch.aminmax(planes.reshape(B, -1), dim=1)
        lo, hi = lo[:, None, None], hi[:, None, None]
        # tensor / tensor: one IEEE division, as JAX's f32 (b − a) / d
        scale = torch.full_like(lo, b - a) / torch.clamp_min(hi - lo, 1e-45)
        out = (planes - lo) * scale + a
        return torch.where(hi == lo, a, out)
    if planes.dtype not in _INT_RANGE:
        raise TypeError(f"contrast_stretch takes uint8/uint16/int16/float32, got {planes.dtype}")
    minv, maxv = _INT_RANGE[planes.dtype]
    flat = planes.reshape(B, -1)
    # torch's CPU min/max has no uint16
    lo, hi = torch.aminmax(flat.to(torch.int32) if planes.dtype == torch.uint16 else flat, dim=1)
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
