"""Colour conversion (``cv2.cvtColor``) on ``[..., H, W, C]`` tensors.

The counterpart of the JAX package's ``ops/color.py``, with the same thirteen
conversions, dtypes and pinned arithmetic: gray and YCrCb (u8/u16 fixed
point, f32 ``fma32`` chains), HSV and HLS (u8), XYZ (u8 fixed point, f32
matrix), Lab (u8 table fixed point with and without sRGB gamma, f32
analytic) and Luv (u8 packed trilinear forward, f32 inverse; f32 both ways).
Channels lie on the last axis.

Every u8 table lookup of the JAX package's ``_take1`` is one
:func:`~imageenhancement_mp_tpu_torch.kernels.take.take_table` call here (a
kernel launch on CUDA), for every table length: the sRGB and cube-root
tables, Lab's 36864-entry inverse cube table and Luv's 35937-entry grid
columns alike.  The HSV forward's two 256-entry divisor tables are indexed
with torch, as the JAX package leaves them to XLA.

Exactness: torch does not contract separate operations, so the JAX
package's ``two_prod(a, b)[0]`` is a plain ``a * b``; its ``df_div`` (a
correctly rounded f32 quotient) is a tensor ÷ tensor division, IEEE on the
CPU and on CUDA.  Division by a constant divides by a tensor on the
operand's device (torch's CUDA kernels multiply by a rounded reciprocal
when the divisor is a Python number).  torch has no ``cbrt``: :func:`_cbrt`
takes ``sign(x)·|x|^(1/3)``, so the f32 Lab and Luv forwards are float
paths with a stated tolerance, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.take import take_table
from imageenhancement_mp_tpu_torch.utils import color_tables as ct
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["cvt_gray_nhwc", "rgb_to_ycrcb_nhwc", "ycrcb_to_rgb_nhwc",
           "rgb_to_hsv_nhwc", "hsv_to_rgb_nhwc", "rgb_to_hls_nhwc", "hls_to_rgb_nhwc",
           "rgb_to_xyz_nhwc", "xyz_to_rgb_nhwc", "rgb_to_lab_nhwc", "lab_to_rgb_nhwc",
           "rgb_to_luv_nhwc", "luv_to_rgb_nhwc", "GRAY_CR", "GRAY_CG", "GRAY_CB"]

F32 = torch.float32
I32 = torch.int32

GRAY_CR, GRAY_CG = 9798, 19235          # round(0.299·2^15), round(0.587·2^15)
GRAY_CB = 32768 - GRAY_CR - GRAY_CG     # 3735: sum-preserving (pinned)

YCRCB_SHIFT = 14
YCRCB_CR, YCRCB_CG = 4899, 9617                 # round(0.299/0.587 · 2^14)
YCRCB_CB = (1 << 14) - YCRCB_CR - YCRCB_CG      # 1868: sum-preserving
YCRCB_C713 = 11682                              # round(0.713 · 2^14)
YCRCB_C564 = 9241                               # round(0.564 · 2^14)
YCRCB_INV = (22987, 11698, 5636, 29049)         # 1.403, 0.714, 0.344, 1.773


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    """The f32 constant ``v`` as a 0-dim tensor on ``like``'s device (a fill,
    not a host copy, which would wait for the stream)."""
    return torch.full((), v, dtype=F32, device=like.device)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """One IEEE f32 division; a constant divisor becomes a tensor first."""
    if not isinstance(b, torch.Tensor):
        b = _f(b, a)
    return a / b


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """The real cube root, odd like ``jnp.cbrt`` (0 → 0, negatives negative)."""
    return torch.sign(x) * torch.pow(x.abs(), _f(1.0 / 3.0, x))


def _order(order: str) -> tuple[int, int, int]:
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    return (0, 1, 2) if order == "rgb" else (2, 1, 0)


def _need3(img: torch.Tensor) -> None:
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {tuple(img.shape)}")


def _take1(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-pixel 1-D table lookup: one ``take_table`` for any table length.
    ``idx`` is int32 and already in range."""
    return take_table(idx.to(I32).contiguous(), tab)


def _on(dev: torch.device, arrays) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


# ------------------------------------------------------------------ gray


def cvt_gray_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(..2GRAY)`` on ``[..., H, W, C]``, C ∈ {3, 4} (alpha
    ignored); the channel axis is dropped.  u8/u16 15-bit fixed point
    (exact); f32 cv2's two-FMA chain over the channels in memory order."""
    if img.shape[-1] not in (3, 4):
        raise ValueError(f"expected a trailing channel axis of 3|4, got {tuple(img.shape)}")
    ri, gi, bi = _order(order)
    if img.dtype == F32:
        w = {ri: _f(0.299, img), gi: _f(0.587, img), bi: _f(0.114, img)}
        x0, x1, x2 = img[..., 0], img[..., 1], img[..., 2]
        return fma32(x2, w[2], fma32(x0, w[0], x1 * w[1]))
    if img.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    r, g, b = (img[..., c].to(I32) for c in (ri, gi, bi))
    acc = r * GRAY_CR + g * GRAY_CG + b * GRAY_CB + (1 << 14)
    return (acc >> 15).to(img.dtype)


# ---------------------------------------------------------------- YCrCb


def _delta(dtype: torch.dtype) -> int:
    return {torch.uint8: 128, torch.uint16: 32768}[dtype]


def rgb_to_ycrcb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(..., COLOR_{RGB,BGR}2YCrCb)`` on ``[..., H, W, 3]``."""
    _need3(img)
    ri, gi, bi = _order(order)
    if img.dtype == F32:
        w = {ri: _f(0.299, img), gi: _f(0.587, img), bi: _f(0.114, img)}
        x0, x1, x2 = img[..., 0], img[..., 1], img[..., 2]
        y = fma32(x0, w[0], fma32(x1, w[1], x2 * w[2]))
        half = torch.full_like(y, 0.5)
        cr = fma32(img[..., ri] - y, _f(0.713, img), half)
        cb = fma32(img[..., bi] - y, _f(0.564, img), half)
        return torch.stack([y, cr, cb], dim=-1)
    if img.dtype not in (torch.uint8, torch.uint16):
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    r, g, b = (img[..., c].to(I32) for c in (ri, gi, bi))
    half = 1 << (YCRCB_SHIFT - 1)
    y = (r * YCRCB_CR + g * YCRCB_CG + b * YCRCB_CB + half) >> YCRCB_SHIFT
    d = _delta(img.dtype)
    cr = (((r - y) * YCRCB_C713 + half) >> YCRCB_SHIFT) + d
    cb = (((b - y) * YCRCB_C564 + half) >> YCRCB_SHIFT) + d
    maxv = 2 * d - 1
    return torch.stack([v.clamp(0, maxv) for v in (y, cr, cb)], dim=-1).to(img.dtype)


def ycrcb_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(..., COLOR_YCrCb2{RGB,BGR})`` on ``[..., H, W, 3]``."""
    _need3(img)
    _order(order)
    c1, c2, c3, c4 = YCRCB_INV
    if img.dtype == F32:
        y, cr, cb = img[..., 0], img[..., 1], img[..., 2]
        dcr = cr - _f(0.5, img)
        dcb = cb - _f(0.5, img)
        r = fma32(dcr, _f(1.403, img), y)
        g = fma32(dcr, _f(-0.714, img), fma32(dcb, _f(-0.344, img), y))
        b = fma32(dcb, _f(1.773, img), y)
        out = [r, g, b]
    elif img.dtype in (torch.uint8, torch.uint16):
        d = _delta(img.dtype)
        maxv = 2 * d - 1
        half = 1 << (YCRCB_SHIFT - 1)
        y = img[..., 0].to(I32)
        dcr = img[..., 1].to(I32) - d
        dcb = img[..., 2].to(I32) - d
        r = y + ((dcr * c1 + half) >> YCRCB_SHIFT)
        g = y + ((dcr * (-c2) + dcb * (-c3) + half) >> YCRCB_SHIFT)
        b = y + ((dcb * c4 + half) >> YCRCB_SHIFT)
        out = [v.clamp(0, maxv) for v in (r, g, b)]
    else:
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    if order == "bgr":
        out = out[::-1]
    return torch.stack(out, dim=-1).to(img.dtype)


# ------------------------------------------------------------------ HSV
# forward = exact 12-bit fixed point (sdiv/hdiv tables); inverse = cv2's
# f32 sector chain with the SIMD body's truncating final ·255.


@functools.lru_cache(maxsize=None)
def _hsv_device_tabs(dev: torch.device) -> tuple:
    sdiv, hdiv = ct.hsv_tables()
    return _on(dev, (sdiv.astype(np.int32), hdiv.astype(np.int32)))


def _check_u8_3(img: torch.Tensor, what: str) -> None:
    if img.dtype != torch.uint8:
        raise TypeError(f"{what} is uint8-only here (cv2's 8u path), got {img.dtype}")
    _need3(img)


def rgb_to_hsv_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(..2HSV)`` on uint8 ``[..., H, W, 3]`` (H ∈ 0..179)."""
    _check_u8_3(img, "HSV")
    ri, gi, bi = _order(order)
    sdiv, hdiv = _hsv_device_tabs(img.device)
    r, g, b = (img[..., c].to(I32) for c in (ri, gi, bi))
    v = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (ct.HSV_SHIFT - 1)
    s = (diff * sdiv[v.long()] + half) >> ct.HSV_SHIFT
    h_raw = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_raw * hdiv[diff.long()] + half) >> ct.HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def hsv_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(COLOR_HSV2..)`` on uint8 — the SIMD-body model."""
    _check_u8_3(img, "HSV")
    _order(order)
    h = img[..., 0].to(F32) * _f(6.0 / 180.0, img)
    s = img[..., 1].to(F32) * _f(1.0 / 255.0, img)
    v = img[..., 2].to(F32) * _f(1.0 / 255.0, img)
    fl = torch.floor(h)
    sector = torch.remainder(fl.to(I32), 6)
    f = h - fl
    one = _f(1.0, img)
    # cv2's inner terms are single-rounded: fma(−s, f, 1), fma(−s, 1−f, 1)
    tab = [v, v * (one - s), v * fma32(-s, f, one), v * fma32(-s, one - f, one)]
    out = []
    for comp in range(3):
        val = tab[0]
        for k in range(6):
            val = torch.where(sector == k, tab[ct.HSV_SECTOR[k][comp]], val)
        out.append(torch.floor(val * _f(255.0, img)).clamp(0, 255))
    if order == "bgr":
        out = out[::-1]
    return torch.stack(out, dim=-1).to(torch.uint8)


# ------------------------------------------------------------------ HLS


def rgb_to_hls_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(..2HLS)`` on uint8 — exhaustively bit-exact: the two
    divisions are IEEE f32 quotients (the JAX package's ``df_div``)."""
    _check_u8_3(img, "HLS")
    ri, gi, bi = _order(order)
    f = img.to(F32) * _f(1.0 / 255.0, img)
    R, G, B = f[..., ri], f[..., gi], f[..., bi]
    v = torch.maximum(torch.maximum(R, G), B)
    vmin = torch.minimum(torch.minimum(R, G), B)
    diff = v - vmin
    live = diff > 0
    vsum = v + vmin
    l = vsum * _f(0.5, img)
    denom = torch.where(l < 0.5, vsum, _f(2.0, img) - vsum)
    den2 = torch.where(denom == 0, _f(1.0, img), denom)
    sval = torch.where(live, diff / den2, _f(0.0, img))
    L8 = torch.round(l * _f(255.0, img)).to(I32)
    S8 = torch.round(sval * _f(255.0, img)).clamp(0, 255).to(I32)
    d60 = torch.full_like(diff, 60.0) / torch.where(live, diff, _f(1.0, img))
    # branch select with cv2's r-first tie order
    is_r = v == R
    is_g = ~is_r & (v == G)
    X = torch.where(is_r, G - B, torch.where(is_g, B - R, R - G))
    C = torch.where(is_r, _f(0.0, img), torch.where(is_g, _f(120.0, img), _f(240.0, img)))
    h = fma32(X, d60, C)
    # the body re-FMAs a negative hue with +360 (single rounding)
    h = torch.where(h < 0, fma32(X, d60, torch.full_like(h, 360.0)), h)
    H8 = torch.where(v == vmin, torch.zeros_like(L8), torch.round(h * _f(0.5, img)).to(I32))
    return torch.stack([H8.clamp(0, 255), L8, S8], dim=-1).to(torch.uint8)


def hls_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(HLS2..)`` on uint8 — exhaustively bit-exact."""
    _check_u8_3(img, "HLS")
    _order(order)
    c = _f(1.0 / 255.0, img)
    L = img[..., 1].to(F32) * c
    S = img[..., 2].to(F32) * c
    one = _f(1.0, img)
    p2 = torch.where(L <= 0.5, L * (one + S), (L + S) - L * S)
    p1 = _f(2.0, img) * L - p2
    h6 = img[..., 0].to(F32) * _f(6.0 / 180.0, img)
    h6 = torch.where(h6 >= 6, h6 - _f(6.0, img), h6)
    sec = torch.floor(h6).to(I32)
    hf = h6 - sec.to(F32)
    d = p2 - p1
    t2 = p1 + d * (one - hf)
    t3 = p1 + d * hf
    tab = [p2, p1, t2, t3]
    gray = img[..., 2] == 0
    out = []
    for comp in range(3):  # b, g, r
        val = tab[0]
        for k in range(6):
            val = torch.where(sec == k, tab[ct.HLS_SECTOR[k][comp]], val)
        val = torch.where(gray, L, val)
        out.append(torch.round(val * _f(255.0, img)).clamp(0, 255))
    rgb = [out[2], out[1], out[0]]
    if order == "bgr":
        rgb = rgb[::-1]
    return torch.stack(rgb, dim=-1).to(torch.uint8)


# -------------------------------------------------------------- XYZ / Lab


@functools.lru_cache(maxsize=None)
def _lab_device_tabs(dev: torch.device) -> tuple:
    """The Lab tables as int32 tensors on ``dev`` (``minab`` an int)."""
    gamma_b, cbrt_b, y_b, ify_b, adiv, bdiv, minab, abxz, invg = ct.lab_tabs()
    tabs = _on(dev, [a.astype(np.int32) for a in (gamma_b, cbrt_b, y_b, ify_b, adiv, bdiv,
                                                    abxz, invg)])
    return (*tabs[:6], int(minab), *tabs[6:])


def _matrix_rows(ch, M: np.ndarray, like: torch.Tensor) -> list:
    Mf = M.astype(np.float32)
    return [ch[0] * _f(Mf[k, 0], like) + ch[1] * _f(Mf[k, 1], like)
            + ch[2] * _f(Mf[k, 2], like) for k in range(3)]


def rgb_to_xyz_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(RGB2XYZ)`` — u8 2^12 coefficients with a half-up shift
    (exact); f32 the matrix product (float tolerance)."""
    if img.shape[-1] != 3:
        raise TypeError("rgb_to_xyz requires [..,3]")
    ri, gi, bi = _order(order)
    if img.dtype == F32:
        return torch.stack(_matrix_rows([img[..., ri], img[..., gi], img[..., bi]],
                                        ct.XYZ_FWD, img), dim=-1)
    if img.dtype != torch.uint8:
        raise TypeError("rgb_to_xyz requires uint8 or float32 [..,3]")
    C = np.round(ct.XYZ_FWD * 4096).astype(np.int32)
    r, g, b = (img[..., c].to(I32) for c in (ri, gi, bi))
    chans = [(r * int(C[k, 0]) + g * int(C[k, 1]) + b * int(C[k, 2]) + 2048) >> 12
             for k in range(3)]
    return torch.stack([c.clamp(0, 255) for c in chans], dim=-1).to(torch.uint8)


def xyz_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(XYZ2RGB)`` — u8 2^12 coefficients (exact); f32 the
    inverse matrix product."""
    if img.shape[-1] != 3:
        raise TypeError("xyz_to_rgb requires [..,3]")
    _order(order)
    if img.dtype == F32:
        out = torch.stack(_matrix_rows([img[..., 0], img[..., 1], img[..., 2]],
                                       ct.XYZ_INV, img), dim=-1)
        return out.flip(-1) if order == "bgr" else out
    if img.dtype != torch.uint8:
        raise TypeError("xyz_to_rgb requires uint8 or float32 [..,3]")
    C = np.round(ct.XYZ_INV * 4096).astype(np.int32)
    x, y, z = (img[..., c].to(I32) for c in range(3))
    chans = [((x * int(C[k, 0]) + y * int(C[k, 1]) + z * int(C[k, 2]) + 2048) >> 12).clamp(0, 255)
             for k in range(3)]
    out = torch.stack(chans, dim=-1).to(torch.uint8)
    return out.flip(-1) if order == "bgr" else out


def rgb_to_lab_nhwc(img: torch.Tensor, order: str = "rgb", srgb: bool = True) -> torch.Tensor:
    """``cv2.cvtColor(RGB2LAB)`` — u8 through cv2's table fixed point, exact
    (``srgb=False`` is COLOR_LRGB2LAB, the linear-RGB variant), with six
    table lookups (three with ``srgb=False``); f32 the analytic CIE formulas."""
    if img.shape[-1] != 3:
        raise TypeError("rgb_to_lab requires [..,3]")
    ri, gi, bi = _order(order)
    if img.dtype == F32:
        r = torch.stack([img[..., ri], img[..., gi], img[..., bi]], dim=-1)
        if srgb:
            r = torch.where(r > 0.04045,
                            torch.pow(_div(r + _f(0.055, r), 1.055), _f(2.4, r)),
                            _div(r, 12.92))
        Mw = ct.XYZ_FWD / ct.LAB_WHITE[:, None]
        xyz = _matrix_rows([r[..., 0], r[..., 1], r[..., 2]], Mw, img)
        f = [torch.where(t > 0.008856, _cbrt(t), _f(7.787, t) * t + _f(16.0 / 116.0, t))
             for t in xyz]
        L = torch.where(xyz[1] > 0.008856, _f(116.0, img) * f[1] - _f(16.0, img),
                        _f(903.3, img) * xyz[1])
        return torch.stack([L, _f(500.0, img) * (f[0] - f[1]),
                            _f(200.0, img) * (f[1] - f[2])], dim=-1)
    if img.dtype != torch.uint8:
        raise TypeError("rgb_to_lab requires uint8 or float32 [..,3]")
    gamma_b, cbrt_b = _lab_device_tabs(img.device)[:2]
    if srgb:
        R, G, B = (_take1(gamma_b, img[..., c].to(I32)) for c in (ri, gi, bi))
    else:
        R, G, B = (img[..., c].to(I32) << 3 for c in (ri, gi, bi))
    C = ct.LAB_C_FWD

    def cb(k):
        acc = R * int(C[k, 0]) + G * int(C[k, 1]) + B * int(C[k, 2]) + 2048
        return _take1(cbrt_b, (acc >> 12).clamp(0, 3071))

    fX, fY, fZ = cb(0), cb(1), cb(2)
    Lscale = (116 * 255 + 50) // 100
    Lshift = -((16 * 255 * (1 << 15) + 50) // 100)
    L = (Lscale * fY + Lshift + (1 << 14)) >> 15
    a = (500 * (fX - fY) + (128 << 15) + (1 << 14)) >> 15
    b = (200 * (fY - fZ) + (128 << 15) + (1 << 14)) >> 15
    return torch.stack([L.clamp(0, 255), a.clamp(0, 255), b.clamp(0, 255)],
                       dim=-1).to(torch.uint8)


def lab_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb", srgb: bool = True) -> torch.Tensor:
    """``cv2.cvtColor(LAB2RGB)`` — u8 through cv2's integer inverse, exact
    (``srgb=False`` is COLOR_LAB2LRGB, the linear output truncating
    ``(v*255) >> 12``), with nine table lookups (six with ``srgb=False``);
    f32 the analytic float inverse."""
    if img.shape[-1] != 3:
        raise TypeError("lab_to_rgb requires [..,3]")
    _order(order)
    if img.dtype == F32:
        L, a, b = img[..., 0], img[..., 1], img[..., 2]
        fy = _div(L + _f(16.0, img), 116.0)
        fx, fz = fy + _div(a, 500.0), fy - _div(b, 200.0)

        def fi(t):
            return torch.where(t * t * t > 0.008856, t * t * t,
                               _div(t - _f(16.0 / 116.0, t), 7.787))

        x = fi(fx) * _f(ct.LAB_WHITE[0], img)
        y = torch.where(L > 8.0, fy * fy * fy, _div(L, 903.3))
        z = fi(fz) * _f(ct.LAB_WHITE[2], img)
        rgb = [torch.clamp_min(c, 0.0) for c in _matrix_rows([x, y, z], ct.XYZ_INV, img)]
        if srgb:
            rgb = [torch.where(c > 0.0031308,
                               _f(1.055, c) * torch.pow(c, _f(1 / 2.4, c)) - _f(0.055, c),
                               _f(12.92, c) * c) for c in rgb]
        out = torch.stack([c.clamp(0.0, 1.0) for c in rgb], dim=-1)
        return out.flip(-1) if order == "bgr" else out
    if img.dtype != torch.uint8:
        raise TypeError("lab_to_rgb requires uint8 or float32 [..,3]")
    _, _, y_b, ify_b, adiv, bdiv, minab, abxz, invg = _lab_device_tabs(img.device)
    LL, aa, bb = (img[..., c].to(I32) for c in range(3))
    y = _take1(y_b, LL)
    ify = _take1(ify_b, LL)
    n_ab = abxz.shape[0]
    x = _take1(abxz, (ify + _take1(adiv, aa) - minab).clamp(0, n_ab - 1))
    z = _take1(abxz, (ify - _take1(bdiv, bb) - minab).clamp(0, n_ab - 1))
    C = ct.LAB_C_INV
    chans = []
    for k in range(3):
        v = (x * int(C[k, 0]) + y * int(C[k, 1]) + z * int(C[k, 2]) + (1 << 13)) >> 14
        v = v.clamp(0, 4095)
        chans.append(_take1(invg, v) if srgb else (v * 255) >> 12)
    out = torch.stack(chans, dim=-1).to(torch.uint8)
    return out.flip(-1) if order == "bgr" else out


# ------------------------------------------------------------------ Luv


@functools.lru_cache(maxsize=None)
def _luv_device_tabs(dev: torch.device) -> tuple:
    """The 256-entry input table, the three grid columns ``[35937]`` and the
    per-channel stage and post roundings, as int32 tensors on ``dev``."""
    tab, T = ct.luv_u8_tabs()
    cols = T.reshape(-1, 3).T.astype(np.int32)
    rounding = np.array([[256, 0, 256], [0, 32, 32]], np.int32)
    return _on(dev, (tab.astype(np.int32), cols[0], cols[1], cols[2], rounding[0], rounding[1]))


def rgb_to_luv_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(RGB2Luv)`` — u8 through cv2's packed trilinear path
    (integer arithmetic around 25 table lookups: the input table, then eight
    corners × three grid columns); f32 the float formulas."""
    _order(order)
    if img.dtype not in (torch.uint8, F32):
        raise TypeError("rgb_to_luv_nhwc requires uint8/float32 NHWC input")
    if order == "bgr":
        img = img.flip(-1)
    if img.dtype == F32:
        x = img
        g = torch.where(x <= 0.04045, _div(x, 12.92),
                        torch.pow(_div(x + _f(0.055, x), 1.055), _f(2.4, x)))
        r_, g_, b_ = g[..., 0], g[..., 1], g[..., 2]
        X, Y, Z = _matrix_rows([r_, g_, b_], np.array(
            [[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
             [0.019334, 0.119193, 0.950227]]), img)
        L = torch.where(Y > 0.008856, _f(116.0, img) * _cbrt(Y) - _f(16.0, img),
                        _f(903.3, img) * Y)
        d = X + _f(15.0, img) * Y + _f(3.0, img) * Z
        dd = torch.clamp_min(d, 1e-30)
        up = torch.where(d > 0, _f(4.0, img) * X / dd, _f(0.0, img))
        vp = torch.where(d > 0, _f(9.0, img) * Y / dd, _f(0.0, img))
        return torch.stack([L, _f(13.0, img) * L * (up - _f(ct.LUV_UN, img)),
                            _f(13.0, img) * L * (vp - _f(ct.LUV_VN, img))], dim=-1)
    _need3(img)
    tab, *cols, R, P = _luv_device_tabs(img.device)  # R, P: stage and post rounding
    c = _take1(tab, img.to(I32))
    t = c >> 9
    f = c & 511
    t1 = torch.clamp_max(t + 1, 32)

    def corner(dp, dq, dr):
        ix = t1[..., 0] if dp else t[..., 0]
        iy = t1[..., 1] if dq else t[..., 1]
        iz = t1[..., 2] if dr else t[..., 2]
        idx3 = (ix * 33 + iy) * 33 + iz
        return torch.stack([_take1(col, idx3) for col in cols], dim=-1)

    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    m = {}
    for dq in (0, 1):
        for dr in (0, 1):
            m[dq, dr] = ((512 - fx) * corner(0, dq, dr) + fx * corner(1, dq, dr) + R) >> 9
    my0 = ((512 - fy) * m[0, 0] + fy * m[1, 0] + R) >> 9
    my1 = ((512 - fy) * m[0, 1] + fy * m[1, 1] + R) >> 9
    val = ((512 - fz) * my0 + fz * my1 + R) >> 9
    return ((val + P) >> 6).clamp(0, 255).to(torch.uint8)


def luv_to_rgb_nhwc(img: torch.Tensor, order: str = "rgb") -> torch.Tensor:
    """``cv2.cvtColor(Luv2RGB)`` — u8 unpacks to f32, applies the in-gamut
    u'/v' clamp and rounds (f32 ``pow``: the CPU and CUDA may differ by ±1 on
    razor ties); f32 the float inverse without the clamp."""
    _order(order)
    if img.dtype not in (torch.uint8, F32):
        raise TypeError("luv_to_rgb_nhwc requires uint8/float32 NHWC input")
    _need3(img)
    isf = img.dtype == F32
    if isf:
        L, u, v = img[..., 0], img[..., 1], img[..., 2]
    else:
        L = img[..., 0].to(F32) * _f(100.0 / 255.0, img)
        u = img[..., 1].to(F32) * _f(354.0 / 255.0, img) - _f(134.0, img)
        v = img[..., 2].to(F32) * _f(262.0 / 255.0, img) - _f(140.0, img)
    q = _div(L + _f(16.0, img), 116.0)
    Y = torch.where(L > 8.0, q * q * q, _div(L, 903.3))
    denom = torch.clamp_min(_f(13.0, img) * L, 1e-6)
    up = u / denom + _f(ct.LUV_UN, img)
    vp = v / denom + _f(ct.LUV_VN, img)
    if not isf:
        up = up.clamp(*ct.LUV_UP_RANGE)
        vp = vp.clamp(*ct.LUV_VP_RANGE)
    vp = torch.where(vp == 0, _f(1e-30, img), vp)
    X = _f(2.25, img) * Y * up / vp
    Z = Y * (_f(3.0, img) - _f(0.75, img) * up - _f(5.0, img) * vp) / vp
    r_ = _f(3.240479, img) * X - _f(1.53715, img) * Y - _f(0.498535, img) * Z
    g_ = _f(-0.969256, img) * X + _f(1.875991, img) * Y + _f(0.041556, img) * Z
    b_ = _f(0.055648, img) * X - _f(0.204043, img) * Y + _f(1.057311, img) * Z
    rgb = torch.clamp_min(torch.stack([r_, g_, b_], dim=-1), 0.0)
    rgb = torch.where(rgb <= 0.0031308, _f(12.92, img) * rgb,
                      _f(1.055, img) * torch.pow(torch.clamp_min(rgb, 1e-12), _f(1 / 2.4, img))
                      - _f(0.055, img))
    if not isf:
        rgb = torch.round(rgb * _f(255.0, img)).clamp(0, 255).to(torch.uint8)
    return rgb.flip(-1) if order == "bgr" else rgb
