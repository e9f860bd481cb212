"""Spatial filters on ``[B, H, W]`` planes: Gaussian blur, unsharp mask,
Laplacian (and the Laplacian sharpen), Sobel/Scharr, box filters, the
structure-tensor corner responses, ``spatialGradient``, ``sqrBoxFilter`` and
``stackBlur``.

The JAX package's ``ops/filters.py`` function by function.  u8 Gaussian and
unsharp go through ``kernels/conv.py::sep_conv_u8`` with cv2's Q8 taps (any
odd ksize); everything else is plain PyTorch on the input's device, as the
JAX package leaves it to XLA: its Pallas kernels serve only those two.

The laws are the JAX package's, pinned to ``ref/ops.py``: REFLECT_101 borders
(``numpy.pad(mode="reflect")``, reflecting again when a halo is deeper than
the plane, through :func:`kernels.conv.reflect101` index tables), exact
integer sums where the JAX package keeps them exact, and its f32 order where
it works in floats: taps as f32 values, the vertical pass first, the terms
added one at a time in tap order (``sum`` over the taps, zero taps skipped
where the JAX package skips them), one torch op per multiply and add so
nothing is contracted into an FMA.  The u16 Gaussian is one int64 separable
sum on cv2's Q16 taps (the JAX package's two int32 routes exist only because
the TPU has no int64): ``(h + 2^31) >> 32`` with ``h < 2^48``.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.conv import reflect101, sep_conv_u8
from imageenhancement_mp_tpu_torch.utils.fma import fma32
from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds
from imageenhancement_mp_tpu_torch.utils.taps import (STACK_MUL, STACK_SHR, deriv_kernels,
                                                      gaussian_axes, gaussian_kernel,
                                                      gaussian_kernel_fixed, gaussian_taps_u16)

__all__ = ["box_blur_planes", "box_filter_planes", "corner_harris_planes",
           "corner_min_eigen_val_planes", "gaussian_blur_planes", "laplacian_planes",
           "laplacian_sharpen_planes", "q8_taps", "sobel_planes", "spatial_gradient_planes",
           "sqr_box_filter_planes", "stack_blur_planes", "unsharp_mask_planes"]

_INT_DTYPES = (torch.uint8, torch.uint16, torch.int16)
_DTYPES = _INT_DTYPES + (torch.float32,)


def _f32(v: float) -> torch.Tensor:
    """``v`` rounded to an f32 value, as a 0-dim CPU tensor: a scalar operand
    of exactly that value on either device."""
    return torch.tensor(np.float32(v))


def _pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
         replicate: bool = False) -> torch.Tensor:
    """``jnp.pad`` of the last two axes: REFLECT_101 (``mode="reflect"``) or
    REPLICATE (``mode="edge"``), through index tables, so any depth works."""
    H, W = x.shape[-2], x.shape[-1]

    def index(n: int, lo: int, hi: int) -> torch.Tensor:
        i = torch.arange(-lo, n + hi, device=x.device)
        return i.clamp(0, n - 1) if replicate else reflect101(i, n)

    return x.index_select(-2, index(H, top, bottom)).index_select(-1, index(W, left, right))


def _check_dtype(planes: torch.Tensor) -> None:
    if planes.dtype not in _DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32 planes, got {planes.dtype}")


def _ksize_pair(ksize) -> tuple[int, int]:
    if isinstance(ksize, (tuple, list)):
        return int(ksize[0]), int(ksize[1])
    return int(ksize), int(ksize)


def _narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast integer values already in ``dtype``'s range to ``dtype`` (via
    int32: torch's CPU ops on uint16 are few)."""
    return x.to(torch.int32).to(dtype) if dtype == torch.uint16 else x.to(dtype)


def _sep_conv_f32(x: torch.Tensor, taps_v, taps_h) -> torch.Tensor:
    """Separable conv with REFLECT_101 border, f32 accumulation (the JAX
    package's ``_sep_conv_f32``)."""
    kh, kw = len(taps_v), len(taps_h)
    H, W = x.shape[-2], x.shape[-1]
    p = _pad(x.to(torch.float32), kh // 2, kh // 2, kw // 2, kw // 2)
    v = sum(_f32(taps_v[j]) * p[:, j:j + H, :] for j in range(kh))
    return sum(_f32(taps_h[j]) * v[:, :, j:j + W] for j in range(kw))


def q8_taps(ksize, sigma: float, sigma_y: float = 0.0) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """cv2's u8 Q8 taps ``(vertical, horizontal)`` for GaussianBlur's
    ``ksize``/``sigma``/``sigma_y`` conventions."""
    kh, kw, sy, sx = gaussian_axes(ksize, sigma, sigma_y, True)
    return (tuple(int(t) for t in gaussian_kernel_fixed(kh, sy)),
            tuple(int(t) for t in gaussian_kernel_fixed(kw, sx)))


def gaussian_blur_planes(planes: torch.Tensor, ksize=5, sigma: float = 0.0,
                         sigma_y: float = 0.0) -> torch.Tensor:
    """``cv2.GaussianBlur`` on u8/u16/i16/f32 planes.

    ``ksize``: int (square) or (rows, cols); a 0 dimension is derived from
    its σ like cv2.  ``sigma_y`` ≤ 0 follows ``sigma``.  u8 and u16:
    bit-exact for any σ (cv2's Q8 / Q16 taps, exact integer sums, one final
    rounding shift).  i16: the f32 separable conv on f32-rounded taps,
    rounded half to even and saturated.  f32: the f32 separable conv."""
    _check_dtype(planes)
    if planes.dtype == torch.uint8:
        tv, th = q8_taps(ksize, sigma, sigma_y)
        return sep_conv_u8(planes.contiguous(), tv, th)
    kh, kw, sy, sx = gaussian_axes(ksize, sigma, sigma_y, False)
    if kh == 1 and kw == 1:
        return planes  # cv2: k=1 is the identity for any sigma
    if planes.dtype == torch.float32:
        return _sep_conv_f32(planes, gaussian_kernel(kh, sy), gaussian_kernel(kw, sx))
    if planes.dtype == torch.int16:
        acc = _sep_conv_f32(planes, gaussian_kernel(kh, sy), gaussian_kernel(kw, sx))
        return torch.round(acc).clamp(-32768, 32767).to(torch.int16)
    tv, th = gaussian_taps_u16(kh, sy), gaussian_taps_u16(kw, sx)
    H, W = planes.shape[-2], planes.shape[-1]
    p = _pad(planes.to(torch.int64), kh // 2, kh // 2, kw // 2, kw // 2)
    v = sum(int(tv[j]) * p[:, j:j + H, :] for j in range(kh))
    h = sum(int(th[j]) * v[:, :, j:j + W] for j in range(kw))
    return _narrow(((h + (1 << 31)) >> 32).clamp(0, 65535), torch.uint16)


def _add_weighted_fma(src_f32: torch.Tensor, blur_f32: torch.Tensor, amount: float) -> torch.Tensor:
    """cv2's integer addWeighted for fractional weights: two single-rounded
    f32 FMAs, rounded half to even."""
    t = blur_f32 * _f32(-amount)  # f32(blur·β): one rounding
    return torch.round(fma32(src_f32, _f32(1.0 + amount), t))


def unsharp_mask_planes(planes: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                        sigma: float = 0.0) -> torch.Tensor:
    """``cv2.addWeighted(src, 1+a, GaussianBlur(src), −a, 0)`` on
    u8/u16/i16/f32 planes — exact for u8/u16 and any ``amount``: integral
    amounts in exact int32, fractional ones cv2's two single-rounded f32 FMAs
    (``round(f32(src·f32(1+a) + f32(blur·f32(−a))))``); f32 the same two FMAs
    without the round."""
    _check_dtype(planes)
    if planes.dtype == torch.uint8:
        tv, th = q8_taps(ksize, sigma)
        return sep_conv_u8(planes.contiguous(), tv, th, float(amount))
    blur = gaussian_blur_planes(planes, ksize, sigma)
    if planes.dtype == torch.float32:
        t = blur * _f32(-amount)  # f32(blur·β): an FMA with 0 addend
        return fma32(planes, _f32(1.0 + amount), t)
    minv, maxv = int_bounds(planes.dtype)
    src, blur = planes.to(torch.int32), blur.to(torch.int32)
    if amount == int(amount):
        out = src + int(amount) * (src - blur)
    else:
        out = _add_weighted_fma(src.to(torch.float32), blur.to(torch.float32), amount)
    return _narrow(out.clamp(minv, maxv), planes.dtype)


def _max_abs_val(dtype: torch.dtype) -> int:
    """Largest |value| of an integer image dtype (int16 → 32768)."""
    minv, maxv = int_bounds(dtype)
    return max(abs(minv), maxv)


def _raw_sep_conv_int(planes_i32: torch.Tensor, kx, ky, H: int, W: int) -> torch.Tensor:
    """Raw int32 separable correlation (REFLECT_101), zero taps skipped."""
    ph, pw = len(ky) // 2, len(kx) // 2
    p = _pad(planes_i32, ph, ph, pw, pw)
    v = sum(int(t) * p[:, i:i + H, :] for i, t in enumerate(ky) if int(t) != 0)
    return sum(int(t) * v[:, :, i:i + W] for i, t in enumerate(kx) if int(t) != 0)


def _combine_delta_int32(acc: torch.Tensor, B: int, idelta: int) -> torch.Tensor:
    """``clip(acc + idelta, INT32_MIN, INT32_MAX)`` without int32 wrap.

    ``|acc| ≤ B < 2³¹``: pre-clip acc into ``[INT32_MIN−δ, INT32_MAX−δ]``
    (bounds narrowed to ±B so they are representable), THEN add."""
    idelta = int(np.clip(idelta, -(2**31), 2**31 - 1))
    lo_eff = max(-(2**31) - idelta, -B)
    hi_eff = min(2**31 - 1 - idelta, B)
    if lo_eff > hi_eff:  # |δ| so large every pixel saturates the same way
        const = -(2**31) if idelta < 0 else 2**31 - 1
        return torch.full(acc.shape, const, dtype=torch.int32, device=acc.device)
    return acc.clamp(lo_eff, hi_eff) + idelta


def laplacian_planes(planes: torch.Tensor, ksize: int = 1, delta: float = 0.0) -> torch.Tensor:
    """``cv2.Laplacian`` — exact.  ``ksize=1``: the 4-neighbour stencil;
    ``ksize≥3``: Sobel-based ``d²x + d²y`` with raw integer sums and ONE
    final saturation.  uint8 → int16; uint16/int16 → int32; float32 →
    float32.  Integer kernels beyond the exact int32 range raise."""
    _check_dtype(planes)
    H, W = planes.shape[-2], planes.shape[-1]
    if ksize != 1:
        kx2, ky2 = deriv_kernels(2, 0, ksize)
        if planes.dtype == torch.float32:
            def rawf(kx, ky):
                ph, pw = len(ky) // 2, len(kx) // 2
                pd = _pad(planes, ph, ph, pw, pw)
                v = sum(_f32(float(t)) * pd[:, i:i + H, :]
                        for i, t in enumerate(ky) if float(t) != 0.0)
                return sum(_f32(float(t)) * v[:, :, i:i + W]
                           for i, t in enumerate(kx) if float(t) != 0.0)

            acc = rawf(kx2, ky2) + rawf(ky2, kx2)
            return acc + _f32(delta)
        maxval = _max_abs_val(planes.dtype)
        B = 2 * int(np.abs(ky2).sum()) * int(np.abs(kx2).sum()) * maxval
        if B >= 2**31:
            raise ValueError(
                f"laplacian ksize {ksize} exceeds the exact int32 range "
                f"for {planes.dtype}; convert to float32")
        x = planes.to(torch.int32)
        acc = _raw_sep_conv_int(x, kx2, ky2, H, W) + _raw_sep_conv_int(x, ky2, kx2, H, W)
        out = _combine_delta_int32(acc, B, int(np.round(float(delta))))
        if planes.dtype == torch.uint8:
            return out.clamp(-32768, 32767).to(torch.int16)
        return out
    if delta:
        raise ValueError("delta is only supported for ksize >= 3 (cv2 parity scope)")
    acc = torch.float32 if planes.dtype == torch.float32 else torch.int32
    p = _pad(planes.to(acc), 1, 1, 1, 1)
    lap = (p[:, :-2, 1:-1] + p[:, 2:, 1:-1] + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
           - 4 * p[:, 1:-1, 1:-1])
    if planes.dtype == torch.float32:
        return lap
    return lap.to(torch.int16) if planes.dtype == torch.uint8 else lap


def laplacian_sharpen_planes(planes: torch.Tensor) -> torch.Tensor:
    """Sharpen = src − Laplacian(src) (4-neighbour); saturating for integer
    dtypes."""
    if planes.dtype == torch.float32:
        return planes - laplacian_planes(planes)
    _check_dtype(planes)
    minv, maxv = int_bounds(planes.dtype)
    lap = laplacian_planes(planes).to(torch.int32)
    return _narrow((planes.to(torch.int32) - lap).clamp(minv, maxv), planes.dtype)


def box_blur_planes(planes: torch.Tensor, ksize=3) -> torch.Tensor:
    """``cv2.blur`` (normalized box filter), REFLECT_101 border.

    ``ksize``: int or (rows, cols), odd dims ≥ 1.  Integer dtypes: exact
    int32 window sums, then ``round(f32(S)·f32(1/area))`` saturated; float32:
    f32 window sums times ``f32(1/area)``."""
    kh, kw = _ksize_pair(ksize)
    if kh < 1 or kw < 1 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"ksize dims must be odd and >= 1, got {(kh, kw)}")
    if kh == 1 and kw == 1:
        return planes
    H, W = planes.shape[-2], planes.shape[-1]
    scale = _f32(1.0 / (kh * kw))
    if planes.dtype == torch.float32:
        p = _pad(planes, kh // 2, kh // 2, kw // 2, kw // 2)
        rows = sum(p[:, j:j + H, :] for j in range(kh))
        return sum(rows[:, :, j:j + W] for j in range(kw)) * scale
    if planes.dtype not in _INT_DTYPES:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    minv, maxv = int_bounds(planes.dtype)
    if kh * kw * max(abs(minv), maxv) >= 2**31:
        raise ValueError(
            f"box ksize {(kh, kw)} overflows the int32 window sums for "
            f"{planes.dtype} (area·maxval ≥ 2³¹); use a smaller kernel")
    p = _pad(planes.to(torch.int32), kh // 2, kh // 2, kw // 2, kw // 2)
    rows = sum(p[:, j:j + H, :] for j in range(kh))
    S = sum(rows[:, :, j:j + W] for j in range(kw))
    prod = S.to(torch.float32) * scale
    return _narrow(torch.round(prod).clamp(minv, maxv), planes.dtype)


def box_filter_planes(planes: torch.Tensor, ksize=3, normalize: bool = True) -> torch.Tensor:
    """``cv2.boxFilter``: normalized == :func:`box_blur_planes`; raw sums
    otherwise (int32 for integer dtypes, f32 for float32), REFLECT_101, with
    cv2's anchor for even sizes: ``k//2`` before, ``k−1−k//2`` after."""
    if normalize:
        return box_blur_planes(planes, ksize)
    _check_dtype(planes)
    kh, kw = _ksize_pair(ksize)
    acc = torch.float32 if planes.dtype == torch.float32 else torch.int32
    H, W = planes.shape[-2], planes.shape[-1]
    p = _pad(planes.to(acc), kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
    s = sum(p[:, i:i + H, :] for i in range(kh))
    return sum(s[:, :, j:j + W] for j in range(kw))


def sobel_planes(planes: torch.Tensor, dx: int = 1, dy: int = 0, ksize: int = 3,
                 scale: float = 1.0, delta: float = 0.0) -> torch.Tensor:
    """``cv2.Sobel`` / ``cv2.Scharr`` (``ksize=-1``), REFLECT_101.

    u8 → i16 (saturating), u16/i16 → i32, f32 → f32.  Integer inputs at
    ``scale == 1``: the exact int32 separable sum plus ``round(delta)`` with
    one saturation; ``scale ≠ 1`` or f32 input: the f32 separable conv with
    the scale folded into the horizontal taps, then rounded and saturated for
    integer inputs.  Integer kernels beyond the exact int32 range raise."""
    _check_dtype(planes)
    kx, ky = deriv_kernels(dx, dy, ksize)
    H, W = planes.shape[-2], planes.shape[-1]
    ph, pw = len(ky) // 2, len(kx) // 2
    if planes.dtype != torch.float32:
        maxval = _max_abs_val(planes.dtype)
        if int(np.abs(ky).sum()) * int(np.abs(kx).sum()) * maxval >= 2**31:
            raise ValueError(
                f"sobel ksize {ksize} exceeds the exact int32 range for "
                f"{planes.dtype}; convert to float32 for kernels this large")
    if planes.dtype == torch.float32 or scale != 1.0:
        p = _pad(planes.to(torch.float32), ph, ph, pw, pw)
        kxf = kx.astype(np.float64) * float(scale)
        v = sum(_f32(float(t)) * p[:, i:i + H, :] for i, t in enumerate(ky))
        acc = sum(_f32(float(t)) * v[:, :, i:i + W] for i, t in enumerate(kxf))
        if planes.dtype == torch.float32:
            return acc + _f32(delta)
        out = torch.round(acc + _f32(delta))
        if planes.dtype == torch.uint8:
            return out.clamp(-32768, 32767).to(torch.int16)
        # saturating, as an f32 of 2^31 converts to INT32_MAX
        return out.to(torch.float64).clamp(-(2.0**31), 2.0**31 - 1).to(torch.int32)
    acc = _raw_sep_conv_int(planes.to(torch.int32), kx, ky, H, W)
    B = int(np.abs(ky).sum()) * int(np.abs(kx).sum()) * maxval
    out = _combine_delta_int32(acc, B, int(np.round(float(delta))))
    if planes.dtype == torch.uint8:
        return out.clamp(-32768, 32767).to(torch.int16)
    return out


def _structure_tensor(planes: torch.Tensor, block_size: int, ksize: int):
    """The scaled f32 Sobel pair of cv2's corner functions."""
    f = planes.to(torch.float32)
    sc = _f32(1.0 / ((1 << (ksize - 1)) * block_size * 255))
    return sobel_planes(f, 1, 0, ksize) * sc, sobel_planes(f, 0, 1, ksize) * sc


def corner_harris_planes(planes: torch.Tensor, block_size: int = 2, ksize: int = 3,
                         k: float = 0.04) -> torch.Tensor:
    """``cv2.cornerHarris`` per plane (u8 → f32 response): f32 Sobel
    derivatives scaled by ``1/(2^(ksize-1)·block·255)``, unnormalized block
    sums, ``det − k·trace²``."""
    if planes.dtype != torch.uint8:
        raise TypeError("cornerHarris requires uint8 input")
    dx, dy = _structure_tensor(planes, block_size, ksize)
    cxx = box_filter_planes(dx * dx, block_size, normalize=False)
    cyy = box_filter_planes(dy * dy, block_size, normalize=False)
    cxy = box_filter_planes(dx * dy, block_size, normalize=False)
    tr = cxx + cyy
    return cxx * cyy - cxy * cxy - _f32(k) * (tr * tr)


def corner_min_eigen_val_planes(planes: torch.Tensor, block_size: int = 3,
                                ksize: int = 3) -> torch.Tensor:
    """``cv2.cornerMinEigenVal`` per plane (u8 → f32): the smaller
    structure-tensor eigenvalue, with cornerHarris's scaling."""
    if planes.dtype != torch.uint8:
        raise TypeError("cornerMinEigenVal requires uint8 input")
    dx, dy = _structure_tensor(planes, block_size, ksize)
    half = _f32(0.5)
    a = box_filter_planes(dx * dx, block_size, normalize=False) * half
    c = box_filter_planes(dy * dy, block_size, normalize=False) * half
    b = box_filter_planes(dx * dy, block_size, normalize=False)
    # the f32 square root correctly rounded on both devices: torch's
    # vectorised CPU sqrt is not, and the subtraction cancels on edges, so
    # its last bit shows; rounding the f64 root to f32 is exact (53 >= 2·24 + 2)
    root = torch.sqrt(((a - c) * (a - c) + b * b).to(torch.float64)).to(torch.float32)
    return (a + c) - root


def spatial_gradient_planes(planes: torch.Tensor, border: str = "reflect101"):
    """``cv2.spatialGradient`` per plane — the exact integer Sobel-3 pair
    (u8 → i16 dx, dy); REFLECT_101 border, or REPLICATE for any other
    ``border``."""
    if planes.dtype != torch.uint8:
        raise TypeError("spatialGradient requires uint8 input")
    H, W = planes.shape[-2], planes.shape[-1]
    p = _pad(planes.to(torch.int32), 1, 1, 1, 1, replicate=border != "reflect101")
    sy = p[:, 0:H, :] + 2 * p[:, 1:H + 1, :] + p[:, 2:H + 2, :]
    dx = (sy[:, :, 2:W + 2] - sy[:, :, 0:W]).to(torch.int16)
    sx = p[:, :, 0:W] + 2 * p[:, :, 1:W + 1] + p[:, :, 2:W + 2]
    dy = (sx[:, 2:H + 2, :] - sx[:, 0:H, :]).to(torch.int16)
    return dx, dy


def sqr_box_filter_planes(planes: torch.Tensor, ksize=3, normalize: bool = True) -> torch.Tensor:
    """``cv2.sqrBoxFilter`` per plane (→ f32): squares and window sums in
    int64 (f64 for float32), the f64 ``1/area`` scale, one f32 cast;
    REFLECT_101 with cv2's anchor for even sizes."""
    _check_dtype(planes)
    kh, kw = _ksize_pair(ksize)
    acc = torch.float64 if planes.dtype == torch.float32 else torch.int64
    x = planes.to(acc)
    H, W = planes.shape[-2], planes.shape[-1]
    p = _pad(x * x, kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
    s = sum(p[:, i:i + H, :] for i in range(kh))
    s = sum(s[:, :, j:j + W] for j in range(kw))
    if normalize:
        return (s.to(torch.float64) * (1.0 / (kh * kw))).to(torch.float32)
    return s.to(torch.float32)


def _stack_descale(S: torch.Tensor, r: int) -> torch.Tensor:
    """stackBlur's per-pass descale: Klingemann's truncating fixed point for
    r ≤ 4, half-to-even ``S / (r+1)²`` beyond."""
    if r <= 4:
        return (S * STACK_MUL[r]) >> STACK_SHR[r]
    den = (r + 1) * (r + 1)
    q = (2 * S + den) // (2 * den)
    tie = (2 * S + den) % (2 * den) == 0
    return torch.where(tie & (q % 2 == 1), q - 1, q)


def _stack_pass_last(x: torch.Tensor, r: int) -> torch.Tensor:
    """One stackBlur pass along the last axis: the triangle kernel of radius
    ``r`` as two running box sums of r + 1, REPLICATE border, descaled."""
    if r == 0:
        return x.to(torch.uint8)
    W = x.shape[-1]
    p = x.to(torch.int64).index_select(-1, torch.arange(-r, W + r, device=x.device).clamp(0, W - 1))
    zero = torch.zeros(p.shape[:-1] + (1,), dtype=torch.int64, device=x.device)
    c = torch.cat((zero, torch.cumsum(p, -1)), -1)
    b1 = c[..., r + 1:] - c[..., :-(r + 1)]
    c2 = torch.cat((zero, torch.cumsum(b1, -1)), -1)
    S = c2[..., r + 1:] - c2[..., :-(r + 1)]
    return _stack_descale(S, r).clamp(0, 255).to(torch.uint8)


def stack_blur_planes(planes: torch.Tensor, ksize) -> torch.Tensor:
    """``cv2.stackBlur`` on u8 planes: a triangle kernel per axis (two
    integer running sums), REPLICATE border, the pinned per-pass descale."""
    kh, kw = _ksize_pair(ksize)
    if kh < 1 or kw < 1 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("ksize dims must be odd and >= 1")
    if kh // 2 > 63 or kw // 2 > 63:
        raise ValueError("radius > 63 not supported (fixed-point table)")
    if planes.dtype != torch.uint8:
        raise TypeError("stack_blur is uint8 only (budgeted op)")
    out = _stack_pass_last(planes, kw // 2)
    out = _stack_pass_last(out.transpose(1, 2), kh // 2)
    return out.transpose(1, 2).contiguous()
