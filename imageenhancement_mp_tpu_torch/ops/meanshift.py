"""``cv2.pyrMeanShiftFiltering``: colour mean-shift segmentation of u8
``[N, H, W, 3]`` images over a Gaussian pyramid, bit-exact.

The JAX package's ``ops/meanshift.py`` in plain PyTorch on the input's
device.  The law, pinned to ``ref/ops.py::pyr_mean_shift_filtering``
(segmentation.cpp): per level the radius ``sp_l = max(f32(sp / 2^level),
1)``; every pixel iterates a window of rows and columns ``cvRound(p ±
sp_l)`` clamped to the image, whose members are the pixels within
``cvRound(sr²)`` in squared colour distance of the current mean colour;
the new position and colour are ``cvRound(sum · fl64(1/count))`` (one f64
product, rounded half to even: ``torch.round(n·recip64[count])``), and a
pixel stops when it repeats its point or ``|Δx| + |Δy| + Σ Δc² ≤ ε``.
Going down, the smaller level's result is ``pyrUp``-expanded and only the
pixels under a mask are taken from the level's own iteration: flags at
``(2i+1, 2j−1)`` of the small image's pixels with a neighbour at colour
distance² ≥ ``max(isr2, 16)``, dilated 3×3.

The iteration is dense, as the JAX package's: every pixel of a level runs
``max_count`` rounds of the window scan with an active mask, one window row
of ``K = 2·ceil(sp_l) + 1`` columns at a time, and no round reads the
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.ops.pyramid import pyr_down_planes, pyr_up_planes

__all__ = ["pyr_mean_shift_planes"]


def _bound(base: torch.Tensor, off: float) -> torch.Tensor:
    """``cvRound(base + off)`` for integer ``base`` and a static ``off``:
    the f64 sum rounded half to even."""
    return torch.round(base.to(torch.float64) + off).to(torch.int64)


def _ms_iterate(src: torch.Tensor, sp: float, isr2: int, max_count: int,
                ethr: int) -> torch.Tensor:
    """Dense mean-shift colours ``[N, H, W, 3]`` int32 from every pixel of
    ``src`` (``[N, H, W, 3]`` int32)."""
    N, H, W, _ = src.shape
    dev = src.device
    K = 2 * int(math.ceil(sp)) + 1
    recip = torch.from_numpy(1.0 / np.arange(1, K * K + 1, dtype=np.float64))
    recip = torch.cat([torch.ones(1, dtype=torch.float64), recip]).to(dev)
    flat = src.reshape(-1, 3)
    base = (torch.arange(N, device=dev) * (H * W)).reshape(N, 1, 1, 1)
    offs = torch.arange(K, device=dev)
    y = torch.arange(H, device=dev).reshape(1, H, 1).expand(N, H, W).clone()
    x = torch.arange(W, device=dev).reshape(1, 1, W).expand(N, H, W).clone()
    c = src.clone()
    active = torch.ones((N, H, W), dtype=torch.bool, device=dev)
    for _ in range(max_count):
        minx = _bound(x, -sp).clamp_min(0)
        miny = _bound(y, -sp).clamp_min(0)
        maxx = _bound(x, sp).clamp_max(W - 1)
        maxy = _bound(y, sp).clamp_max(H - 1)
        xs = minx[..., None] + offs                      # [N, H, W, K]
        vx = xs <= maxx[..., None]
        col = base + xs.clamp_max(W - 1)
        cnt = torch.zeros((N, H, W), dtype=torch.int64, device=dev)
        s = torch.zeros((N, H, W, 3), dtype=torch.int64, device=dev)
        sx = torch.zeros((N, H, W), dtype=torch.int64, device=dev)
        sy = torch.zeros((N, H, W), dtype=torch.int64, device=dev)
        for oy in range(K):
            ys = miny + oy
            ok = vx & (ys <= maxy)[..., None]
            v = flat[col + (ys.clamp_max(H - 1) * W)[..., None]]  # [N, H, W, K, 3]
            d = v - c[..., None, :]
            sel = ok & ((d * d).sum(-1) <= isr2)
            cnt += sel.sum(-1)
            s += (v * sel[..., None]).sum(-2)
            sx += (xs * sel).sum(-1)
            sy += ys * sel.sum(-1)
        r = recip[cnt]
        x1 = torch.round(sx.to(torch.float64) * r).to(torch.int64)
        y1 = torch.round(sy.to(torch.float64) * r).to(torch.int64)
        c1 = torch.round(s.to(torch.float64) * r[..., None]).to(torch.int32)
        dc = c1 - c
        stop = ((x1 == x) & (y1 == y)) | (
            ((x1 - x).abs() + (y1 - y).abs() + (dc * dc).sum(-1)) <= ethr)
        upd = active & (cnt > 0)
        x = torch.where(upd, x1, x)
        y = torch.where(upd, y1, y)
        c = torch.where(upd[..., None], c1, c)
        active = upd & ~stop
    return c


def _propagation_mask(dst: torch.Tensor, H: int, W: int, isr22: int) -> torch.Tensor:
    """The pixels of a ``H × W`` level re-run from its own source: the
    small image's flags at ``(2i+1, 2j−1)``, dilated 3×3 (zero border)."""
    N, h1, w1, _ = dst.shape
    m = torch.zeros((N, H, W), dtype=torch.bool, device=dst.device)
    if h1 > 2 and w1 > 2:
        u = dst.to(torch.int32)
        t = u[:, 1:-1, 1:-1]
        flag = torch.zeros((N, h1 - 2, w1 - 2), dtype=torch.bool, device=dst.device)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di or dj:
                    dd = u[:, 1 + di:h1 - 1 + di, 1 + dj:w1 - 1 + dj] - t
                    flag |= (dd * dd).sum(-1) >= isr22
        m[:, 3:2 * h1 - 2:2, 1:2 * w1 - 4:2] = flag
        p = torch.nn.functional.pad(m, (1, 1, 1, 1))
        acc = m.clone()
        for di in range(3):
            for dj in range(3):
                acc |= p[:, di:di + H, dj:dj + W]
        m = acc
    return m


def pyr_mean_shift_planes(img: torch.Tensor, sp: float, sr: float, max_level: int,
                          max_count: int, epsilon: float) -> torch.Tensor:
    """``cv2.pyrMeanShiftFiltering(img, sp, sr, maxLevel, (COUNT+EPS,
    max_count, epsilon))`` for u8 ``[N, H, W, 3]`` images."""
    isr2 = int(np.rint(float(sr) * float(sr)))
    isr22 = max(isr2, 16)
    mc = min(max(int(max_count), 1), 100)
    # the integer step sum is at most ε when it is at most floor(ε)
    ethr = min(math.floor(max(float(epsilon), 0.0)), 2 ** 31 - 1)
    src_pyr = [img]
    for _ in range(int(max_level)):
        a = src_pyr[-1]
        N, h, w, _ = a.shape
        planes = pyr_down_planes(a.permute(0, 3, 1, 2).reshape(N * 3, h, w))
        src_pyr.append(planes.reshape(N, 3, *planes.shape[-2:]).permute(0, 2, 3, 1))
    dst = None
    for level in range(int(max_level), -1, -1):
        src = src_pyr[level].to(torch.int32)
        N, H, W, _ = src.shape
        sp_l = max(float(np.float32(float(sp) / (1 << level))), 1.0)
        ms = _ms_iterate(src, sp_l, isr2, mc, ethr)
        if dst is None:
            out = ms
        else:
            h1, w1 = dst.shape[1:3]
            up = pyr_up_planes(dst.permute(0, 3, 1, 2).reshape(N * 3, h1, w1))
            up = up.reshape(N, 3, 2 * h1, 2 * w1)[:, :, :H, :W].permute(0, 2, 3, 1)
            m = _propagation_mask(dst, H, W, isr22)
            out = torch.where(m[..., None], ms, up.to(torch.int32))
        dst = out.to(torch.uint8)
    return dst
