"""Sub-pixel patch extraction: ``cv2.getRectSubPix`` batched over centres.

The JAX package's ``ops/subpix.py`` in plain PyTorch on the input's device.
The law, pinned to ``ref/ops.py::get_rect_sub_pix``: ``x0 = f32(cx) −
f32((w−1)/2)``, ``ix = floor(x0)``, ``a = x0 − ix`` (the same for y, b), the
weights ``a11 = (1−a)(1−b)``, ``a12 = a(1−b)``, ``a21 = (1−a)b``,
``a22 = ab`` in f32, taps clamped to the image (REPLICATE).  cv2 5.0 sums
in one of three orders, chosen by channel count and output depth:

* u8 → u8: OpenCV's Q16 fixed point, ``w = cvRound(a·2^16)``,
  ``sat((Σ p·w + 2^15) >> 16)``;
* f32 → f32, one channel: the FMA chain
  ``fma(p11, a22, fma(p10, a21, fma(p01, a12, p00·a11)))``
  (``utils/fma.py::fma32``);
* u8 → f32, one channel: ``(p00·a11 + p01·a12) + (p10·a21 + p11·a22)``;
* more channels: ``((p00·a11 + p01·a12) + p10·a21) + p11·a22``;

each product rounded to f32 on its own (one torch op each).  A
``[H, W, 1]`` image takes the one-channel laws, as cv2 sees it.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["get_rect_sub_pix_planes"]


def get_rect_sub_pix_planes(img: torch.Tensor, centers: torch.Tensor, patch_w: int,
                            patch_h: int, out_f32: bool) -> torch.Tensor:
    """Extract one ``(patch_h, patch_w)`` patch per row of ``centers``
    (``[N, 2]`` f32 (x, y)) from one ``[H, W]`` or ``[H, W, C]`` u8/f32
    image → ``[N, h, w]`` / ``[N, h, w, C]``, u8 or f32."""
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"getRectSubPix supports u8/f32, got {img.dtype}")
    w, h = int(patch_w), int(patch_h)
    H, W = img.shape[0], img.shape[1]
    multi = img.dim() == 3 and img.shape[2] > 1
    f32 = torch.float32
    c = centers.to(img.device, f32).reshape(-1, 2)
    x0 = c[:, 0] - torch.tensor((w - 1) * 0.5, dtype=f32, device=img.device)
    y0 = c[:, 1] - torch.tensor((h - 1) * 0.5, dtype=f32, device=img.device)
    ix, iy = torch.floor(x0), torch.floor(y0)
    a, b = x0 - ix, y0 - iy
    a11 = (1 - a) * (1 - b)
    a12 = a * (1 - b)
    a21 = (1 - a) * b
    a22 = a * b
    xs = (ix.to(torch.int64)[:, None] + torch.arange(w + 1, device=img.device)).clamp(0, W - 1)
    ys = (iy.to(torch.int64)[:, None] + torch.arange(h + 1, device=img.device)).clamp(0, H - 1)
    P = img[ys[:, :, None], xs[:, None, :]]  # [N, h+1, w+1(, C)]
    taps = (P[:, :h, :w], P[:, :h, 1:], P[:, 1:, :w], P[:, 1:, 1:])
    ws = [t.reshape((-1, 1, 1) + (1,) * (img.dim() - 2)) for t in (a11, a12, a21, a22)]
    if not out_f32:
        q = [torch.round(t * 65536.0).to(torch.int32) for t in ws]
        s = sum(p.to(torch.int32) * wq for p, wq in zip(taps, q))
        return ((s + 32768) >> 16).clamp(0, 255).to(torch.uint8)
    fp = [p.to(f32) for p in taps]
    pr = [p * wt for p, wt in zip(fp, ws)]
    if multi:
        return ((pr[0] + pr[1]) + pr[2]) + pr[3]
    if img.dtype == torch.uint8:
        return (pr[0] + pr[1]) + (pr[2] + pr[3])
    e = [wt.expand_as(fp[0]) for wt in ws]
    return fma32(fp[3], e[3], fma32(fp[2], e[2], fma32(fp[1], e[1], pr[0])))
