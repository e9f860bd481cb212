"""OpenCV's ``photo`` module on torch tensors: the domain-transform filters
(``edgePreservingFilter``, ``detailEnhance``, ``stylization``,
``pencilSketch``), the HDR merges (Mertens, Debevec), the tonemaps
(plain, Reinhard, Drago, Mantiuk) and the TV-L1 denoiser.

The counterpart of the JAX package's ``ops/photo.py``, in plain PyTorch on
the input's device; ``merge_debevec_nhwc`` looks up its two 256-entry f32
tables through :func:`~imageenhancement_mp_tpu_torch.kernels.hist.apply_lut256`
(``apply_lut256_wide`` on CUDA).  The laws are pinned to ``ref/ops.py``:

* The recursive (RF) filter is a first-order IIR along each axis, forward
  and backward, three iterations: ``out = j + v·(carry − j)`` with the
  subtract, the multiply and the add each rounded to f32 (three torch ops a
  step, over all rows at once; never ``lerp`` or ``addcmul``).
* Sequential f32 sums (:func:`seq_cumsum`): the oracle's ``np.cumsum(...,
  dtype=f32)`` is a strict left-to-right chain.  torch's own ``cumsum``
  accumulates f32 in double on the CPU and is a parallel scan on CUDA, so
  the chain is a loop over the axis, one f32 add a step.  The NC filter's
  domain coordinates and box sums and pencilSketch's coordinates use it
  (one flipped ``searchsorted`` boundary moves a pencil count, and gray by
  ``round(255·shade_factor)``).
* ``V = a^dHdx`` is ``f32(pow(f64(a), f64(dHdx)))``: torch's f32 ``pow``
  differs from libm's ``powf`` by ulps on both devices, which the
  recursion amplifies.
* Square roots are ``f32(sqrt(f64(x)))``: torch's vectorised CPU ``sqrt`` is
  not correctly rounded.
* Every division is tensor ÷ tensor on one device (``scalar / tensor`` is a
  reciprocal and a multiply in torch, and so is a CUDA tensor divided by a
  host scalar); single-rounded FMAs are ``utils/fma.py::fma32``.
* Sums over channels and frames are written out in order, so the card and
  the CPU add in the same order; the tonemaps' means, minima and maxima are
  whole-image reductions that each device orders its own way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256
from imageenhancement_mp_tpu_torch.ops import color
from imageenhancement_mp_tpu_torch.ops.color import _f
from imageenhancement_mp_tpu_torch.ops.filters import _pad, laplacian_planes
from imageenhancement_mp_tpu_torch.ops.pyramid import pyr_down_planes, pyr_up_planes
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["seq_cumsum", "dt_derivatives", "dt_rf", "dt_nc", "edge_preserving_filter_nhwc",
           "detail_enhance_nhwc", "stylization_nhwc", "pencil_sketch_nhwc",
           "merge_mertens_nhwc", "merge_debevec_nhwc", "tonemap_nhwc", "tonemap_reinhard_nhwc",
           "tonemap_drago_nhwc", "tonemap_mantiuk_nhwc", "denoise_tvl1_stack"]

F32 = torch.float32
F64 = torch.float64


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root."""
    return torch.sqrt(x.to(F64)).to(F32)


def _sum_last3(x: torch.Tensor) -> torch.Tensor:
    """``(x0 + x1) + x2`` over a trailing axis of 3 (or ``x0`` for 1)."""
    if x.shape[-1] == 1:
        return x[..., 0]
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _sum_first(x: torch.Tensor) -> torch.Tensor:
    """The sum over axis 0 in index order."""
    s = x[0]
    for t in range(1, x.shape[0]):
        s = s + x[t]
    return s


def _sigma_h(sigma_s: float, i: int, n: int) -> float:
    return float(sigma_s * np.sqrt(3.0) * (2.0 ** (n - i - 1)) / np.sqrt(4.0 ** n - 1))


def seq_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Strictly sequential f32 cumsum along ``axis`` (``np.cumsum``'s order:
    ``c[0] = 0 + x[0]``, ``c[i] = c[i−1] + x[i]``), one add a step over every
    other index at once."""
    xm = x.movedim(axis, 0).contiguous()
    out = torch.empty_like(xm)
    if xm.shape[0]:
        torch.add(xm[0], 0.0, out=out[0])
    for i in range(1, xm.shape[0]):
        torch.add(out[i - 1], xm[i], out=out[i])
    return out.movedim(0, axis)


def _diff_l1(I: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``|∂x I|`` and ``|∂y I|`` summed over the channels, f32 ``[N,H,W-1]``
    and ``[N,H-1,W]``."""
    dIx = _sum_last3((I[:, :, 1:] - I[:, :, :-1]).abs())
    dIy = _sum_last3((I[:, 1:] - I[:, :-1]).abs())
    return dIx, dIy


def dt_derivatives(I: torch.Tensor, sigma_s: float, sigma_r: float):
    """Domain-transform derivatives ``1 + f32(σs/σr)·ΣC|∂I|`` of f32
    ``[N,H,W,C]``, the multiply and the add rounded apart."""
    ratio = _f(float(sigma_s) / float(sigma_r), I)
    one = _f(1.0, I)
    dIx, dIy = _diff_l1(I)
    return one + ratio * dIx, one + ratio * dIy


def _rf_sweep(J: torch.Tensor, V: torch.Tensor, axis: int) -> torch.Tensor:
    """One forward and one backward RF sweep along ``axis`` (1 or 2) of
    ``J [N,H,W,C]``; ``V`` holds the feedback coefficients between
    neighbours (one shorter on that axis, no channel axis)."""
    Jw = J.movedim(axis, 0).contiguous()            # [L, N, ·, C]
    Vw = V.movedim(axis, 0).unsqueeze(-1).contiguous()
    L = Jw.shape[0]
    tmp = torch.empty_like(Jw[0])
    for x in range(1, L):
        torch.sub(Jw[x - 1], Jw[x], out=tmp)
        tmp.mul_(Vw[x - 1])
        Jw[x].add_(tmp)
    for x in range(L - 2, -1, -1):
        torch.sub(Jw[x + 1], Jw[x], out=tmp)
        tmp.mul_(Vw[x])
        Jw[x].add_(tmp)
    return Jw.movedim(0, axis)


def dt_rf(J: torch.Tensor, dHdx: torch.Tensor, dVdy: torch.Tensor, sigma_s: float,
          iters: int = 3) -> torch.Tensor:
    """The recursive domain-transform filter on f32 ``[N,H,W,C]``."""
    dH, dV = dHdx.to(F64), dVdy.to(F64)
    for i in range(iters):
        a = float(np.float32(np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i, iters))))
        J = _rf_sweep(J, torch.pow(a, dH).to(F32), 2)
        J = _rf_sweep(J, torch.pow(a, dV).to(F32), 1)
    return J


def _bounds(ct: torch.Tensor, radius: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``searchsorted``-left of ``ct ∓ radius`` in each row of ``ct [.., n]``
    (rows flattened), ``hi`` capped at ``n``."""
    n = ct.shape[-1]
    rows = ct.reshape(-1, n).contiguous()
    lo = torch.searchsorted(rows, rows - radius, right=False)
    hi = torch.searchsorted(rows, rows + radius, right=False).clamp_max(n)
    return lo.reshape(ct.shape), hi.reshape(ct.shape)


def _nc_axis(J: torch.Tensor, ct: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """NC box mean along axis 2: ``J [N,H,W,C]``, ``ct [N,H,W]``."""
    N, H, W, C = J.shape
    lo, hi = _bounds(ct, radius)
    sat = torch.cat([torch.zeros((N, H, 1, C), dtype=F32, device=J.device),
                     seq_cumsum(J, 2)], dim=2)
    num = (sat.gather(2, hi[..., None].expand(N, H, W, C))
           - sat.gather(2, lo[..., None].expand(N, H, W, C)))
    cnt = (hi - lo).clamp_min(1).to(F32)
    return num / cnt[..., None]


def _coords(dHdx: torch.Tensor, dVdy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The transformed-domain coordinates: a 0 column (row) then the
    sequential f32 cumsum along the row (column)."""
    N, H, _ = dHdx.shape
    W = dVdy.shape[2]
    ctH = torch.cat([torch.zeros((N, H, 1), dtype=F32, device=dHdx.device),
                     seq_cumsum(dHdx, 2)], dim=2)
    ctV = torch.cat([torch.zeros((N, 1, W), dtype=F32, device=dVdy.device),
                     seq_cumsum(dVdy, 1)], dim=1)
    return ctH, ctV


def dt_nc(J: torch.Tensor, dHdx: torch.Tensor, dVdy: torch.Tensor, sigma_s: float,
          iters: int = 3) -> torch.Tensor:
    """The normalized-convolution domain-transform filter."""
    ctH, ctV = _coords(dHdx, dVdy)
    ctVt = ctV.transpose(1, 2)
    for i in range(iters):
        radius = _f(_sigma_h(sigma_s, i, iters) * np.sqrt(3.0), J)
        J = _nc_axis(J, ctH, radius)
        J = _nc_axis(J.transpose(1, 2), ctVt, radius).transpose(1, 2)
    return J


def _to_u8(J: torch.Tensor) -> torch.Tensor:
    """``clip(round(f64(J)·255))`` to u8, half to even (the oracle's f64
    product)."""
    return torch.round(J.to(F64) * 255.0).clamp(0, 255).to(torch.uint8)


def _unit(img: torch.Tensor) -> torch.Tensor:
    return img.to(F32) * _f(1.0 / 255.0, img)


def edge_preserving_filter_nhwc(img: torch.Tensor, flags: str = "recursive",
                                sigma_s: float = 60.0, sigma_r: float = 0.4) -> torch.Tensor:
    """``cv2.edgePreservingFilter`` on uint8 ``[N,H,W,3]``."""
    I = _unit(img)
    dHdx, dVdy = dt_derivatives(I, sigma_s, sigma_r)
    fn = dt_rf if flags == "recursive" else dt_nc
    return _to_u8(fn(I, dHdx, dVdy, sigma_s))


def detail_enhance_nhwc(img: torch.Tensor, sigma_s: float = 10.0, sigma_r: float = 0.15,
                        order: str = "rgb") -> torch.Tensor:
    """``cv2.detailEnhance`` on uint8 ``[N,H,W,3]``: the RF filter on the
    f32 Lab ``L/255``, ``L' = res + 3·(L − res)``, back through f32 Lab."""
    I = _unit(img)
    lab = color.rgb_to_lab_nhwc(I, order)
    L = lab[..., :1] * _f(1.0 / 255.0, I)
    dHdx, dVdy = dt_derivatives(L, sigma_s, sigma_r)
    res = dt_rf(L, dHdx, dVdy, sigma_s)
    Lout = (res + _f(3.0, I) * (L - res)) * _f(255.0, I)
    out = color.lab_to_rgb_nhwc(torch.cat([Lout, lab[..., 1:]], dim=-1), order)
    return _to_u8(out)


def stylization_nhwc(img: torch.Tensor, sigma_s: float = 60.0,
                     sigma_r: float = 0.45) -> torch.Tensor:
    """``cv2.stylization`` on uint8 ``[N,H,W,3]``: the NC filter darkened by
    ``1 − Σc sqrt(fma(gx, gx, gy·gy))`` of Sobel-3 gradients (REFLECT_101)."""
    I = _unit(img)
    N, H, W, C = I.shape
    dHdx, dVdy = dt_derivatives(I, sigma_s, sigma_r)
    res = dt_nc(I, dHdx, dVdy, sigma_s)
    p = _pad(res.permute(0, 3, 1, 2).reshape(N * C, H, W), 1, 1, 1, 1)
    two = _f(2.0, I)
    smooth_y = (p[:, :-2] + two * p[:, 1:-1]) + p[:, 2:]
    gx = smooth_y[:, :, 2:] - smooth_y[:, :, :-2]
    smooth_x = (p[:, :, :-2] + two * p[:, :, 1:-1]) + p[:, :, 2:]
    gy = smooth_x[:, 2:] - smooth_x[:, :-2]
    mag = _sqrt(fma32(gx, gx, gy * gy)).reshape(N, C, H, W).permute(0, 2, 3, 1)
    mag = _f(1.0, I) - _sum_last3(mag)
    return _to_u8(res * mag[..., None])


def _pen_axis(ct: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """cv2 pencilSketch's neighbour counts along the last axis of ``ct``:
    searchsorted-left bounds, and a line whose position 0 covers it all
    counts 0 there."""
    n = ct.shape[-1]
    lo, hi = _bounds(ct, radius)
    cnt = (hi - lo).to(F32)
    cnt[..., 0] = torch.where(hi[..., 0] == n, torch.zeros_like(cnt[..., 0]), cnt[..., 0])
    return cnt


def pencil_sketch_nhwc(img: torch.Tensor, sigma_s: float = 60.0, sigma_r: float = 0.07,
                       shade_factor: float = 0.02, order: str = "rgb"):
    """``cv2.pencilSketch`` on uint8 ``[N,H,W,3]`` → ``(gray [N,H,W],
    color [N,H,W,3])`` u8: the first-iteration NC neighbour counts ``pen``,
    ``sk = f32(pen·sf)``, gray ``round(f32(sk·255))``, colour the f32 YCrCb
    legs with Y replaced by ``sk``, each step one single-rounded FMA."""
    I = _unit(img)
    dHdx, dVdy = dt_derivatives(I, sigma_s, sigma_r)
    ctH, ctV = _coords(dHdx, dVdy)
    radius = _f(_sigma_h(sigma_s, 0, 3) * np.sqrt(3.0), I)
    pen = _pen_axis(ctH, radius) + _pen_axis(ctV.transpose(1, 2), radius).transpose(1, 2)
    sk = pen * _f(shade_factor, I)
    c255 = _f(255.0, I)
    gray = torch.round(sk * c255).clamp(0, 255).to(torch.uint8)
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    R, G, B = I[..., ri], I[..., gi], I[..., bi]

    def c(v):
        return _f(v, I)

    Y0 = fma32(B, c(0.114), fma32(G, c(0.587), R * c(0.299)))
    Cr = fma32(R - Y0, c(0.713), c(0.5))
    Cb = fma32(B - Y0, c(0.564), c(0.5))
    crm, cbm = Cr - c(0.5), Cb - c(0.5)
    Rp = fma32(crm, c(1.403), sk)
    Gp = fma32(crm, c(-0.714), fma32(cbm, c(-0.344), sk))
    Bp = fma32(cbm, c(1.773), sk)
    chans = [Rp, Gp, Bp] if order == "rgb" else [Bp, Gp, Rp]
    col = torch.round(torch.stack(chans, dim=-1) * c255).clamp(0, 255).to(torch.uint8)
    return gray, col


def merge_mertens_nhwc(stack: torch.Tensor, wcon: float, wsat: float,
                       wexp: float) -> torch.Tensor:
    """Mertens exposure fusion of a ``[T,H,W,3]`` u8 stack → f32
    ``[H,W,3]``: per-frame weights ``|Lap₁(gray)|^wcon · sat^wsat ·
    expo^wexp + 1e-12`` normalised across frames, Laplacian-pyramid blend
    at ``maxlevel = int(ln min(H, W) / ln 2)``."""
    T, H, W, C = stack.shape
    I = _unit(stack).permute(0, 3, 1, 2).contiguous()            # [T, 3, H, W]
    R, G, B = I[:, 0], I[:, 1], I[:, 2]
    gray = (R * _f(0.299, I) + G * _f(0.587, I)) + B * _f(0.114, I)
    contrast = laplacian_planes(gray, 1).abs()
    third = _f(1.0 / 3.0, I)
    mean = ((R + G) + B) * third
    sq = (I - mean[:, None]) ** 2
    sat = _sqrt(((sq[:, 0] + sq[:, 1]) + sq[:, 2]) * third)
    e = torch.exp(-((I - _f(0.5, I)) ** 2) * _f(1.0 / 0.08, I))
    expo = (e[:, 0] * e[:, 1]) * e[:, 2]
    w = (torch.pow(contrast, _f(wcon, I)) * torch.pow(sat, _f(wsat, I))
         * torch.pow(expo, _f(wexp, I))) + _f(1e-12, I)
    w = w / _sum_first(w)                                          # [T, H, W]
    maxlevel = int(np.log(min(H, W)) / np.log(2.0))

    def down(x):          # [T, c, h, w] or [T, h, w]
        d = pyr_down_planes(x.reshape(-1, x.shape[-2], x.shape[-1]))
        return d.reshape(x.shape[:-2] + d.shape[-2:])

    def up(x, hw):
        u = pyr_up_planes(x.reshape(-1, x.shape[-2], x.shape[-1]))[:, :hw[0], :hw[1]]
        return u.reshape(x.shape[:-2] + tuple(hw))

    gp_i, gp_w = [I], [w]
    for _ in range(maxlevel):
        gp_i.append(down(gp_i[-1]))
        gp_w.append(down(gp_w[-1]))
    res = []
    for lv in range(maxlevel + 1):
        lap = gp_i[lv] if lv == maxlevel else gp_i[lv] - up(gp_i[lv + 1], gp_i[lv].shape[-2:])
        res.append(_sum_first(lap * gp_w[lv][:, None]))
    out = res[maxlevel]
    for lv in range(maxlevel - 1, -1, -1):
        out = res[lv] + up(out[None], res[lv].shape[-2:])[0]
    return out.permute(1, 2, 0)


@functools.lru_cache(maxsize=None)
def _debevec_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The triangle weight ``min(z, 255 − z) + 1e-6`` and the response
    ``ln max(z, 1)`` as f32 ``[256]`` tables on ``dev``."""
    z = np.arange(256, dtype=np.float64)
    wt = (np.minimum(z, 255.0 - z) + 1e-6).astype(np.float32)
    g = np.log(np.maximum(z, 1.0)).astype(np.float32)
    return tuple(torch.from_numpy(t).to(dev) for t in (wt, g))


def merge_debevec_nhwc(stack: torch.Tensor, times) -> torch.Tensor:
    """Debevec HDR merge of a ``[T,H,W,3]`` u8 stack → f32 radiance
    ``exp(Σt w·(g(z) − ln t) / Σt w)`` with the joint weight (the channel
    mean of the triangle weights).  Both table lookups are one
    ``apply_lut256`` each over the stack as one plane."""
    T = stack.shape[0]
    wt, g = _debevec_tables(stack.device)
    flat = stack.contiguous().reshape(1, -1)
    wz = apply_lut256(flat, wt).reshape(stack.shape)
    gz = apply_lut256(flat, g).reshape(stack.shape)
    lt = np.log(np.asarray(times, np.float32)).astype(np.float32)
    wj = _sum_last3(wz)[..., None] / _f(3.0, wz)
    num = torch.stack([wj[t] * (gz[t] - _f(float(lt[t]), wz)) for t in range(T)])
    return torch.exp(_sum_first(num) / _sum_first(wj))


def tonemap_nhwc(img: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """``cv2.createTonemap(gamma).process``: global min-max normalize and
    ``pow(1/gamma)`` (through f64, so both devices round it alike); a
    constant image maps to zeros."""
    mn, mx = img.min(), img.max()
    x = (img - mn) / torch.maximum(mx - mn, _f(1e-38, img))
    out = torch.pow(x.to(F64), float(np.float32(1.0 / gamma))).to(F32)
    return torch.where(mx > mn, out, torch.zeros_like(out))


def _norm_minmax_f32(x: torch.Tensor) -> torch.Tensor:
    """cv2.normalize MINMAX per batch element: ``fma(x, scale, −mn·scale)``
    with ``scale = 1/(max − min)`` in f32."""
    mn = x.amin(dim=(1, 2, 3), keepdim=True)
    mx = x.amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.where(mx - mn > _f(1e-12, x), _f(1.0, x) / (mx - mn), _f(0.0, x))
    return fma32(x, scale, -mn * scale)


def _gray_f32(img: torch.Tensor) -> torch.Tensor:
    return ((img[..., 0] * _f(0.299, img) + img[..., 1] * _f(0.587, img))
            + img[..., 2] * _f(0.114, img))


def _renorm_finite(out: torch.Tensor) -> torch.Tensor:
    """The final normalize over the finite values (cv2's minMaxLoc skips
    NaN)."""
    fin = torch.isfinite(out)
    big = _f(3.4e38, out)
    mn = torch.where(fin, out, big).amin(dim=(1, 2, 3), keepdim=True)
    mx = torch.where(fin, out, -big).amax(dim=(1, 2, 3), keepdim=True)
    scale = torch.where(mx - mn > _f(1e-12, out), _f(1.0, out) / (mx - mn), _f(0.0, out))
    return fma32(out, scale, -mn * scale)


def tonemap_reinhard_nhwc(img: torch.Tensor, gamma: float = 1.0, intensity: float = 0.0,
                          light_adapt: float = 1.0, color_adapt: float = 0.0) -> torch.Tensor:
    """``cv2.createTonemapReinhard`` on ``(N, H, W, 3)`` f32 HDR."""
    f = np.float32
    img = _norm_minmax_f32(img.to(F32))
    gray = _gray_f32(img)
    log_img = torch.log(torch.clamp_min(gray, _f(1e-4, img)))
    log_mean = log_img.mean(dim=(1, 2), keepdim=True)
    log_min = log_img.amin(dim=(1, 2), keepdim=True)
    log_max = log_img.amax(dim=(1, 2), keepdim=True)
    key = (log_max - log_mean) / torch.clamp_min(log_max - log_min, _f(1e-30, img))
    map_key = _f(0.3, img) + _f(0.7, img) * torch.pow(key, _f(1.4, img))
    inten = _f(np.exp(-float(intensity)), img)
    chan_mean = img.mean(dim=(1, 2), keepdim=True)
    gray_mean = gray.mean(dim=(1, 2), keepdim=True)[..., None]
    ca, la = _f(color_adapt, img), _f(light_adapt, img)
    ca1 = _f(f(1) - f(color_adapt), img)
    la1 = _f(f(1) - f(light_adapt), img)
    glob = ca * chan_mean + ca1 * gray_mean
    adapt = ca * img + ca1 * gray[..., None]
    adapt = la * adapt + la1 * glob
    adapt = torch.pow(inten * adapt, map_key[..., None])
    out = img * (_f(1.0, img) / (adapt + img))
    out = _norm_minmax_f32(out)
    return torch.pow(out, _f(1.0 / gamma, img)) if gamma != 1.0 else out


def tonemap_drago_nhwc(img: torch.Tensor, gamma: float = 1.0, saturation: float = 1.0,
                       bias: float = 0.85) -> torch.Tensor:
    """``cv2.createTonemapDrago`` on ``(N, H, W, 3)`` f32 HDR; the final
    normalize skips non-finite values (the fractional pow of a negative
    normalize residue NaNs the global-min pixel, as in cv2)."""
    img = _norm_minmax_f32(img.to(F32))
    gray = _gray_f32(img)
    log_img = torch.log(torch.clamp_min(gray, _f(1e-4, img)))
    mean = torch.exp(log_img.sum(dim=(1, 2), keepdim=True)
                     / _f(log_img.shape[1] * log_img.shape[2], img))
    grays = gray / mean
    gmax = grays.amax(dim=(1, 2), keepdim=True)
    expo = _f(float(np.log(np.float32(bias)) / np.log(np.float32(0.5))), img)
    div = torch.log(_f(2.0, img) + _f(8.0, img) * torch.pow(grays / gmax, expo))
    mp = torch.log(grays + _f(1.0, img)) * (_f(1.0, img) / div)
    ratio = img / grays[..., None]
    ch = ratio if saturation == 1.0 else torch.pow(ratio, _f(saturation, img))
    out = _renorm_finite(ch * mp[..., None])
    return torch.pow(out, _f(1.0 / gamma, img)) if gamma != 1.0 else out


def tonemap_mantiuk_nhwc(img: torch.Tensor, gamma: float = 1.0, scale: float = 0.7,
                         saturation: float = 1.0) -> torch.Tensor:
    """``cv2.createTonemapMantiuk`` on ``(N, H, W, 3)`` f32 HDR, in its
    closed form ``L' = L^(scale^(1/0.4185))``; constant luminance maps to
    zeros through the normalize guard."""
    img = _norm_minmax_f32(img.to(F32))
    gray = _gray_f32(img)
    log_img = torch.log(torch.clamp_min(gray, _f(1e-4, img)))
    k = _f(float(np.float32(scale)) ** (1.0 / float(np.float32(0.4185))), img)
    new_gray = torch.exp(k * log_img)
    ratio = torch.where(gray[..., None] > 0, img / gray[..., None], _f(0.0, img))
    ch = ratio if saturation == 1.0 else torch.pow(ratio, _f(saturation, img))
    out = _renorm_finite(ch * new_gray[..., None])
    return torch.pow(out, _f(1.0 / gamma, img)) if gamma != 1.0 else out


def denoise_tvl1_stack(obs: torch.Tensor, lam: float = 1.0, niters: int = 30) -> torch.Tensor:
    """``cv2.denoise_TVL1`` on a ``(K, H, W)`` uint8 observation stack: the
    primal-dual iterations in f32 (dual step ``1 + σ`` on the first only,
    the last column's dual normalised on y alone, the divergence's x term
    then its y term added to zero, the relaxed primal stored back)."""
    if obs.dtype != torch.uint8:
        raise TypeError("denoise_tvl1_stack expects uint8 (K, H, W)")
    f = np.float32
    K, H, W = obs.shape
    sigma_v = f(1.0) / (f(8.0) * f(0.02))
    tau, theta = _f(0.02, obs), _f(1.0, obs)
    sigma, sigma0 = _f(sigma_v, obs), _f(f(1.0) + sigma_v, obs)
    one = _f(1.0, obs)
    ob = obs.to(F32) / _f(255.0, obs)
    X = ob[0]
    Px = torch.zeros((H, W), dtype=F32, device=obs.device)
    Py = torch.zeros_like(Px)
    Rs = torch.zeros((K, H, W), dtype=F32, device=obs.device)
    lamf = float(f(lam))
    rowsel = torch.clamp_max(torch.arange(H, device=obs.device) + 1, H - 1)
    zcol = torch.zeros((H, 1), dtype=F32, device=obs.device)
    for i in range(int(niters)):
        cs = sigma0 if i == 0 else sigma
        dxs = (X[:, 1:] - X[:, :-1]) * cs + Px[:, :-1]
        dy = (X[rowsel] - X) * cs + Py
        m = one / torch.clamp_min(_sqrt(dxs ** 2 + dy[:, :-1] ** 2), one)
        Px = torch.cat([dxs * m, zcol], dim=1)
        ml = one / torch.clamp_min(dy[:, -1].abs(), one)
        Py = torch.cat([dy[:, :-1] * m, (dy[:, -1] * ml)[:, None]], dim=1)
        Rs = torch.clamp(Rs + sigma * (X[None] - ob), -lamf, lamf)
        div = torch.zeros((H, W), dtype=F32, device=obs.device)
        div[:, 1:] += Px[:, 1:] - Px[:, :-1]
        div[1:, :] += Py[1:, :] - Py[:-1, :]
        X1 = (X + tau * div) - tau * _sum_first(Rs)
        X = X1 + theta * (X1 - X)
    return torch.round(X * _f(255.0, obs)).clamp(0, 255).to(torch.uint8)
