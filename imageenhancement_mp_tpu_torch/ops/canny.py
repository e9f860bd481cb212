"""Edges and labels: ``cv2.Canny`` and ``cv2.connectedComponents`` on
``[B, H, W]`` planes.

The JAX package's ``ops/canny.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there).  The laws, pinned to ``ref/ops.py``:

* Canny: the replicate-border Sobel in int32 (aperture 7 scaled by 1/16 and
  rounded half to even), saturated to int16; the L1 magnitude or the L2
  ``gx² + gy²`` in int32 (at most 2·32767², inside int32) against
  thresholds floored to integers (squared first for L2); cv2's fixed-point
  non-maximum suppression (TG22 = 13573/2^15, its strict and non-strict
  comparisons); then the 8-connected hysteresis fixpoint, which grows the
  strong set through the kept weak pixels by one 3×3 dilation a step.  A
  chain of L weak pixels takes L steps, and steps past convergence change
  nothing, so the host reads whether anything changed only every
  :data:`CHECK_EVERY` steps.
* Connected components: min-label propagation with hooking and pointer
  jumping.  Each round every pixel takes the least label of its 4- or
  8-neighbourhood, the root its label points to takes the least such label
  over all the pixels pointing to it (a ``scatter_reduce("amin")``: the
  hook that joins two trees), then two rounds of "my label's label".  A
  label only decreases and stays in its component, so the fixpoint labels
  each component with its least raster index, the JAX package's fixpoint;
  the hooks bring it in a few rounds (8 on a 540×960 thresholded plane,
  where the neighbour minimum alone took 630).  Numbered as cv2 numbers
  them: 4-connected components by the raster rank of their first pixel,
  8-connected ones by their first 2×2 block in block-raster order (cv2's
  BBDT scan).
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.ops.filters import _pad
from imageenhancement_mp_tpu_torch.utils.taps import deriv_kernels

__all__ = ["canny_planes", "canny_candidates", "check_canny", "magnitude", "hysteresis",
           "connected_components_planes", "CHECK_EVERY"]

_TG22 = 13573
_SHIFT = 15
CHECK_EVERY = 16  # hysteresis steps between two reads of "did anything change"


def _sobel_replicate(planes: torch.Tensor, dx: int, dy: int, ksize: int) -> torch.Tensor:
    kx, ky = deriv_kernels(dx, dy, ksize)
    kxi, kyi = np.round(kx).astype(np.int64), np.round(ky).astype(np.int64)
    r = ksize // 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = _pad(planes.to(torch.int32), r, r, r, r, replicate=True)
    t = sum(int(kyi[i]) * p[:, i:i + H, :] for i in range(ksize))
    raw = sum(int(kxi[j]) * t[:, :, j:j + W] for j in range(ksize))
    if ksize == 7:
        # cv2 scales aperture-7 Sobel by 1/16 (exact in binary; rounded half
        # to even) so the gradients fit CV_16S
        raw = torch.round(raw.to(torch.float32) * (1.0 / 16.0)).to(torch.int32)
    return raw.clamp(-32768, 32767)


def _nms_keep(magv: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """cv2's fixed-point non-maximum suppression of the ``h`` rows of
    ``gx, gy`` over a magnitude extended by one row a side, ``magv = [B, h +
    2, W]``: the zero border above and below the frame, or on a row shard
    the neighbour shards' boundary rows.  The zero column border is padded
    here."""
    mp = torch.nn.functional.pad(magv, (1, 1))
    c = mp[:, 1:-1, 1:-1]
    left, right = mp[:, 1:-1, :-2], mp[:, 1:-1, 2:]
    up, down = mp[:, :-2, 1:-1], mp[:, 2:, 1:-1]
    ul, ur = mp[:, :-2, :-2], mp[:, :-2, 2:]
    dl, dr = mp[:, 2:, :-2], mp[:, 2:, 2:]
    ax = gx.abs()
    ay = gy.abs() << _SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((ax + ax) << _SHIFT)
    s_neg = (gx ^ gy) < 0
    d1 = torch.where(s_neg, ur, ul)
    d2 = torch.where(s_neg, dl, dr)
    return torch.where(ay < tg22x, (c > left) & (c >= right),
                       torch.where(ay > tg67x, (c > up) & (c >= down), (c > d1) & (c > d2)))


def check_canny(planes: torch.Tensor, aperture_size: int) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"cv2.Canny requires uint8 input, got {planes.dtype}")
    if aperture_size not in (3, 5, 7):
        raise ValueError(f"aperture_size must be 3, 5 or 7, got {aperture_size}")


def magnitude(gx: torch.Tensor, gy: torch.Tensor, threshold1: float, threshold2: float,
              aperture_size: int, l2_gradient: bool) -> tuple[torch.Tensor, int, int]:
    """The gradient magnitude (L1, or L2 squared) and the low and high
    thresholds it is compared with, as integers."""
    lo_t, hi_t = sorted((float(threshold1), float(threshold2)))
    if aperture_size == 7:
        lo_t, hi_t = lo_t / 16.0, hi_t / 16.0
    if l2_gradient:
        mag = gx * gx + gy * gy  # int16-saturated gradients: inside int32
        return mag, int(np.floor(lo_t * lo_t)), int(np.floor(hi_t * hi_t))
    return gx.abs() + gy.abs(), int(np.floor(lo_t)), int(np.floor(hi_t))


def canny_candidates(planes: torch.Tensor, threshold1: float, threshold2: float,
                     aperture_size: int = 3,
                     l2_gradient: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keep, strong)``: the pixels that survive non-maximum suppression
    above the low threshold, and those of them above the high one."""
    check_canny(planes, aperture_size)
    gx = _sobel_replicate(planes, 1, 0, aperture_size)
    gy = _sobel_replicate(planes, 0, 1, aperture_size)
    mag, lo_i, hi_i = magnitude(gx, gy, threshold1, threshold2, aperture_size, l2_gradient)
    keep = _nms_keep(torch.nn.functional.pad(mag, (0, 0, 1, 1)), gx, gy) & (mag > lo_i)
    return keep, keep & (mag > hi_i)


def _dilate8(mask: torch.Tensor) -> torch.Tensor:
    p = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    return (p[:, :-2, :-2] | p[:, :-2, 1:-1] | p[:, :-2, 2:] | p[:, 1:-1, :-2]
            | p[:, 1:-1, 2:] | p[:, 2:, :-2] | p[:, 2:, 1:-1] | p[:, 2:, 2:])


def hysteresis(keep: torch.Tensor, strong: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The 8-connected fixpoint from ``strong`` through ``keep``, and the
    steps it ran (a multiple of :data:`CHECK_EVERY`, the last block of them
    changing nothing).  A row shard floods its block with it, from the
    edges it has so far (``parallel/spatial.py::canny_spatial``)."""
    out, steps = strong, 0
    while True:
        before = out
        for _ in range(CHECK_EVERY):
            out = out | (keep & _dilate8(out))
        steps += CHECK_EVERY
        if torch.equal(out, before):
            return out, steps


def canny_planes(planes: torch.Tensor, threshold1: float, threshold2: float,
                 aperture_size: int = 3, l2_gradient: bool = False) -> torch.Tensor:
    """``cv2.Canny`` per plane on ``[B, H, W]`` uint8 — exact 0/255 edges."""
    keep, strong = canny_candidates(planes, threshold1, threshold2, aperture_size, l2_gradient)
    edges, _ = hysteresis(keep, strong)
    return edges.to(torch.uint8) * 255


def connected_components_planes(planes: torch.Tensor, connectivity: int = 8) -> torch.Tensor:
    """``cv2.connectedComponents`` per plane on ``[B, H, W]`` masks (nonzero
    is foreground) — int32 labels, 0 the background (module doc)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    N, H, W = planes.shape
    n = H * W
    if N * n == 0:
        return torch.zeros(planes.shape, dtype=torch.int32, device=planes.device)
    dev = planes.device
    inf = torch.tensor(n, dtype=torch.int64, device=dev)
    m = (planes != 0).reshape(N, n)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    lbl = torch.where(m, idx, inf)

    def mins(flat: torch.Tensor) -> torch.Tensor:
        p = torch.nn.functional.pad(flat.view(N, H, W), (1, 1, 1, 1), value=n)
        out = torch.minimum(torch.minimum(p[:, 1:-1, 1:-1], p[:, :-2, 1:-1]),
                            torch.minimum(p[:, 2:, 1:-1], p[:, 1:-1, :-2]))
        out = torch.minimum(out, p[:, 1:-1, 2:])
        if connectivity == 8:
            out = torch.minimum(out, torch.minimum(torch.minimum(p[:, :-2, :-2], p[:, :-2, 2:]),
                                                   torch.minimum(p[:, 2:, :-2], p[:, 2:, 2:])))
        return torch.where(m, out.reshape(N, n), inf)

    def jump(flat: torch.Tensor) -> torch.Tensor:
        return torch.gather(flat, 1, flat.clamp(max=n - 1))

    while True:
        near = mins(lbl)
        # only a pixel with a smaller label nearby hooks its root; the others
        # write their own slot, with no effect, so a large component's pixels
        # do not all contend for its root's atomic
        target = torch.where(near < lbl, lbl, idx)
        hooked = lbl.scatter_reduce(1, target, near, "amin")
        new = torch.where(m, jump(jump(torch.minimum(hooked, near))), inf)
        if torch.equal(new, lbl):
            break
        lbl = new
    root = lbl.clamp(max=n - 1)
    is_root = m & (lbl == idx)
    if connectivity == 4:
        rank = torch.cumsum(is_root.to(torch.int64), dim=1)
        out = torch.gather(rank, 1, root)
    else:
        blk = (idx // W >> 1) * ((W + 1) // 2) + (idx % W >> 1)
        minblk = torch.full((N, n), n, dtype=torch.int64, device=dev).scatter_reduce(
            1, root, torch.where(m, blk, inf).expand(N, n), "amin")
        key = torch.where(is_root, minblk, inf)
        order = torch.argsort(key, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order, idx.expand(N, n).contiguous())
        out = torch.gather(rank, 1, root) + 1
    return torch.where(m, out, 0).to(torch.int32).reshape(N, H, W)
