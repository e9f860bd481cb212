"""Plain PyTorch versions of OpenCV's laws, written from OpenCV's documented
behaviour (and the NumPy oracle that pins it), independent of the program:
no module of the port or of the JAX package is imported here.

Each function takes ``[B, H, W]`` planes on any device and returns new
planes.  ``precision`` names the float type of the steps that OpenCV
computes in float32 (the equalize and CLAHE LUT scales, the CLAHE blend and
addWeighted's two FMAs): ``torch.float32`` gives the reference, a lower
type (``torch.bfloat16``) gives the control that the check must refuse.
Integer steps (histograms, the Q8/Q16 Gaussians, the median) stay exact in
both.  Torch's elementwise ops round once per op and never contract a
multiply and an add, so the float32 steps round as the oracle's do.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_planes", "equalize_hist", "gaussian_taps", "gaussian_blur", "add_weighted",
           "unsharp_mask", "median_blur", "clahe", "plane_chunks"]

_MAXV = {torch.uint8: 255, torch.uint16: 65535}
# cv2's dyadic Gaussian tables (x256) for sigma <= 0; it uses them for u16 too (x65536).
_BINOMIAL = {1: [256], 3: [64, 128, 64], 5: [16, 64, 96, 64, 16],
             7: [8, 28, 56, 72, 56, 28, 8], 9: [4, 13, 30, 51, 60, 51, 30, 13, 4]}


def as_planes(batch: torch.Tensor):
    """``[N, H, W]`` (gray) or ``[N, H, W, C]`` (channels last) as ``[B, H,
    W]`` planes, and the function that puts planes back in the batch's
    layout."""
    if batch.dim() == 3:
        return batch, lambda planes: planes
    n, h, w, c = batch.shape
    planes = batch.permute(0, 3, 1, 2).reshape(n * c, h, w)
    return planes, lambda out: out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def plane_chunks(planes: torch.Tensor, max_pixels: int = 1 << 25):
    """Slices of at least one plane and about ``max_pixels`` pixels, so the
    reference's temporaries fit beside the pool at the timed sizes."""
    b, h, w = planes.shape
    step = max(1, max_pixels // (h * w))
    for i in range(0, b, step):
        yield planes[i:i + step]


def _reflect101(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of a REFLECT_101 pad of ``lo`` before and ``hi`` after ``n``."""
    i = torch.arange(-lo, n + hi, device=device)
    period = 2 * (n - 1) if n > 1 else 1
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _replicate(n: int, pad: int, device) -> torch.Tensor:
    return torch.arange(-pad, n + pad, device=device).clamp(0, n - 1)


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(torch.int32).to(dtype)


def equalize_hist(planes: torch.Tensor, precision=torch.float32) -> torch.Tensor:
    """``cv2.equalizeHist`` on u8 planes: ``lut[i] = round((cdf[i] − cdf[i0])
    · f32(255 / (total − hist[i0])))``, clipped, ``i0`` the least value
    present; a constant plane is left as it is."""
    b, h, w = planes.shape
    total = h * w
    idx = planes.to(torch.int64) + 256 * torch.arange(b, device=planes.device).view(b, 1, 1)
    hist = torch.bincount(idx.view(-1), minlength=256 * b).view(b, 256)
    i0 = (hist > 0).to(torch.int32).argmax(dim=1, keepdim=True)
    h0 = hist.gather(1, i0)
    cdf = hist.cumsum(1)
    num = torch.full_like(h0, 255, dtype=precision)
    scale = num / (total - h0).to(precision)
    lut = ((cdf - cdf.gather(1, i0)).to(precision) * scale).round().clamp(0, 255)
    lut = torch.where(h0 == total, torch.arange(256, device=planes.device), lut.to(torch.int64))
    return lut.to(torch.uint8).view(-1)[idx]


def gaussian_taps(ksize: int, sigma: float, q: int) -> list[int]:
    """cv2's fixed-point Gaussian taps at scale ``q`` (256 for u8, 65536
    for u16): the dyadic tables for sigma <= 0 and ksize <= 9, else the
    kernel's cumulative sums rounded at scale ``q`` and differenced."""
    if ksize % 2 == 0 or ksize < 1:
        raise ValueError(f"ksize must be odd and positive, got {ksize}")
    if sigma <= 0:
        if ksize in _BINOMIAL:
            return [t * (q // 256) for t in _BINOMIAL[ksize]]
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    i = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    v = np.exp(-(i * i) / (2.0 * sigma * sigma))
    cdf = np.round(np.cumsum(v / v.sum()) * q)
    return [int(t) for t in np.diff(np.concatenate([[0.0], cdf]))]


def gaussian_blur(planes: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    """``cv2.GaussianBlur`` on u8/u16 planes: separable integer sums of the
    Q8 (u8) or Q16 (u16) taps over a REFLECT_101 pad, one rounding shift."""
    dtype = planes.dtype
    q, shift = (256, 16) if dtype == torch.uint8 else (65536, 32)
    taps = gaussian_taps(ksize, sigma, q)
    if ksize == 1:
        return planes.clone()
    b, h, w = planes.shape
    r = ksize // 2
    acc = torch.int32 if dtype == torch.uint8 else torch.int64
    p = planes.to(acc)
    p = p.index_select(1, _reflect101(h, r, r, planes.device))
    p = p.index_select(2, _reflect101(w, r, r, planes.device))
    v = sum(t * p[:, j:j + h, :] for j, t in enumerate(taps))
    s = sum(t * v[:, :, j:j + w] for j, t in enumerate(taps))
    return _cast(((s + (1 << (shift - 1))) >> shift).clamp(0, _MAXV[dtype]), dtype)


def add_weighted(src: torch.Tensor, alpha: float, other: torch.Tensor, beta: float,
                 precision=torch.float32) -> torch.Tensor:
    """cv2's integer ``addWeighted(src, alpha, other, beta, 0)``: two
    single-rounded float FMAs, ``t = f(other·f(beta))``, ``acc = f(src·f(alpha)
    + t)``, then round half to even and saturate.  In float32 each FMA is
    emulated exactly in float64 (products of float32 values are exact there)."""
    dtype = src.dtype
    if precision == torch.float32:
        a = float(torch.tensor(alpha, dtype=torch.float32))
        be = float(torch.tensor(beta, dtype=torch.float32))
        t = (other.to(torch.float64) * be).to(torch.float32)
        acc = (src.to(torch.float64) * a + t.to(torch.float64)).to(torch.float32)
    else:
        t = other.to(precision) * torch.tensor(beta, dtype=precision)
        acc = src.to(precision) * torch.tensor(alpha, dtype=precision) + t
    return _cast(acc.round().clamp(0, _MAXV[dtype]), dtype)


def unsharp_mask(planes: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                 sigma: float = 0.0, precision=torch.float32) -> torch.Tensor:
    """``addWeighted(src, 1 + amount, GaussianBlur(src), −amount, 0)``."""
    blur = gaussian_blur(planes, ksize, sigma)
    return add_weighted(planes, 1.0 + amount, blur, -amount, precision)


def median_blur(planes: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """``cv2.medianBlur`` (replicated border): the middle of the sorted
    ``ksize²`` window."""
    b, h, w = planes.shape
    r = ksize // 2
    wide = planes.to(torch.int32)
    p = wide.index_select(1, _replicate(h, r, planes.device))
    p = p.index_select(2, _replicate(w, r, planes.device))
    taps = torch.stack([p[:, dy:dy + h, dx:dx + w] for dy in range(ksize) for dx in range(ksize)],
                       dim=-1)
    return _cast(taps.sort(dim=-1).values[..., ksize * ksize // 2], planes.dtype)


def _tile_luts(hist: torch.Tensor, area: int, clip: float, precision) -> torch.Tensor:
    """CLAHE stage B on ``[T, S]`` tile histograms: clip at
    ``max(int(clip·area/S), 1)``, add the excess' quotient to every bin and
    its remainder ``r`` to bins ``0, step, 2·step, …`` (``step = max(S // r,
    1)``, ``r`` of them), then ``round(cdf · f32(S−1) / f32(area))``."""
    n_bins = hist.shape[1]
    if clip > 0:
        clip_abs = max(int(clip * area / n_bins), 1)
        excess = (hist - clip_abs).clamp(min=0).sum(1, keepdim=True)
        hist = hist.clamp(max=clip_abs) + excess // n_bins
        r = excess % n_bins
        step = (n_bins // r.clamp(min=1)).clamp(min=1)
        i = torch.arange(n_bins, device=hist.device).view(1, -1)
        hist = hist + ((r > 0) & (i % step == 0) & (i // step < r)).to(hist.dtype)
    cdf = hist.cumsum(1)
    scale = (torch.tensor(float(n_bins - 1), dtype=precision)
             / torch.tensor(float(area), dtype=precision)).to(hist.device)
    return (cdf.to(precision) * scale).round().clamp(0, n_bins - 1).to(torch.int64)


def _coords(n: int, tile: int, ntiles: int, precision, device):
    """cv2's interpolation coordinates ``x·(1/tile) − 0.5`` in float32: the
    two tile indices (clamped) and the fraction (taken before clamping)."""
    inv = torch.tensor(1.0, dtype=precision) / torch.tensor(float(tile), dtype=precision)
    f = torch.arange(n, dtype=precision).mul(inv).sub(torch.tensor(0.5, dtype=precision))
    i0 = torch.floor(f)
    frac = f - i0
    i0 = i0.to(torch.int64)
    return (i0.clamp(0, ntiles - 1).to(device), (i0 + 1).clamp(0, ntiles - 1).to(device),
            frac.to(device))


def clahe(planes: torch.Tensor, clip_limit: float = 40.0, tile_grid=(8, 8),
          precision=torch.float32) -> torch.Tensor:
    """``cv2.createCLAHE(clip_limit, grid).apply`` on u8 (256 bins) and u16
    (65536 bins) planes: tile histograms (when a side does not divide, both
    sides are padded at the bottom/right by ``tiles − size % tiles`` with
    REFLECT_101), clipped tile LUTs, and the bilinear blend
    ``(1−fy)·((1−fx)·l00 + fx·l01) + fy·((1−fx)·l10 + fx·l11)``, rounded."""
    b, h, w = planes.shape
    dev = planes.device
    gh, gw = (int(t) for t in tile_grid)
    n_bins = _MAXV[planes.dtype] + 1
    if h % gh == 0 and w % gw == 0:
        padded = planes
    else:
        padded = planes.index_select(1, _reflect101(h, 0, gh - h % gh, dev))
        padded = padded.index_select(2, _reflect101(w, 0, gw - w % gw, dev))
    th, tw = padded.shape[1] // gh, padded.shape[2] // gw
    tiles = gh * gw
    ty = torch.arange(padded.shape[1], device=dev) // th
    tx = torch.arange(padded.shape[2], device=dev) // tw
    tile_id = (torch.arange(b, device=dev).view(b, 1, 1) * tiles + ty.view(1, -1, 1) * gw
               + tx.view(1, 1, -1))
    hist = torch.bincount((tile_id * n_bins + padded.to(torch.int64)).view(-1),
                          minlength=b * tiles * n_bins).view(b * tiles, n_bins)
    luts = _tile_luts(hist, th * tw, float(clip_limit), precision).view(-1)
    y0, y1, fy = _coords(h, th, gh, precision, dev)
    x0, x1, fx = _coords(w, tw, gw, precision, dev)
    base = torch.arange(b, device=dev).view(b, 1, 1) * tiles
    v = planes.to(torch.int64)

    def lut(ys, xs):
        return luts[((base + ys.view(1, -1, 1) * gw + xs.view(1, 1, -1)) * n_bins + v)].to(precision)

    one = torch.tensor(1.0, dtype=precision, device=dev)
    fx, fy = fx.view(1, 1, -1), fy.view(1, -1, 1)
    top = (one - fx) * lut(y0, x0) + fx * lut(y0, x1)
    bottom = (one - fx) * lut(y1, x0) + fx * lut(y1, x1)
    out = (one - fy) * top + fy * bottom
    return _cast(out.round().clamp(0, n_bins - 1), planes.dtype)
