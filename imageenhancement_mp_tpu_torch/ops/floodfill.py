"""``cv2.floodFill``'s region growth as a fixpoint of shifted ORs, the law
of the JAX package's ``ops/floodfill.py``.

Whether a pixel joins through an edge depends only on the ORIGINAL pixel
values (fixed range: the pixel against the seed; floating range: the pixel
against the neighbour it is reached from), so the filled set is the one
fixpoint of "a pixel joins when a neighbour it accepts is in", whatever
the schedule.  The acceptance masks are built once; each step then ORs the
region shifted in each direction, gated by the masks, into the region.  The
region lives in a buffer with a ring of False around it, so each shift is a
view.  Steps past the fixpoint change nothing, so the host reads whether a
block of :data:`CHECK_EVERY` steps grew the region once a block (the
region only grows: its count is enough).
"""

from __future__ import annotations

import torch

__all__ = ["flood_region", "CHECK_EVERY"]

CHECK_EVERY = 16  # steps between two reads of the region's count

_NBRS4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
_NBRS8 = _NBRS4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def _shift_img(a: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """``[H, W, C]`` shifted by (di, dj): out[i, j] = a[i − di, j − dj],
    the vacated cells +inf, so any finite lo/up rejects them."""
    H, W, _ = a.shape
    out = torch.full_like(a, float("inf"))
    out[max(di, 0):H + min(di, 0), max(dj, 0):W + min(dj, 0)] = \
        a[max(-di, 0):H + min(-di, 0), max(-dj, 0):W + min(-dj, 0)]
    return out


def flood_region(img: torch.Tensor, blocked: torch.Tensor, seed_yx, lo: torch.Tensor,
                 up: torch.Tensor, connectivity: int = 4, fixed_range: bool = False):
    """Grow the flood region of ``[H, W, C]`` f32 pixels from ``seed_yx``
    through the pixels ``blocked`` does not mark.

    Returns ``(region [H, W] bool, n, rect, steps)``: the region on the
    pixels' device, its pixel count, its ``(x, y, w, h)`` rectangle (zeros
    when it is empty) and the steps the fixpoint ran (a multiple of
    :data:`CHECK_EVERY`, the last block growing nothing)."""
    H, W, C = img.shape
    nbrs = _NBRS8 if connectivity == 8 else _NBRS4
    lo = lo.to(img.device, torch.float32).view(1, 1, C)
    up = up.to(img.device, torch.float32).view(1, 1, C)
    free = ~blocked
    sy, sx = int(seed_yx[0]), int(seed_yx[1])
    if fixed_range:
        ref = img[sy, sx].view(1, 1, C)
        ok = ((img >= ref - lo) & (img <= ref + up)).all(2) & free
    else:
        oks = torch.stack([((img >= nv - lo) & (img <= nv + up)).all(2) & free
                           for nv in (_shift_img(img, di, dj) for di, dj in nbrs)])
    buf = torch.zeros((H + 2, W + 2), dtype=torch.bool, device=img.device)
    region = buf[1:H + 1, 1:W + 1]
    region[sy, sx] = free[sy, sx]
    # the region shifted by (di, dj): out[i, j] = region[i - di, j - dj]
    shifted = [buf[1 - di:1 - di + H, 1 - dj:1 - dj + W] for di, dj in nbrs]
    count, steps = -1, 0
    while True:
        for _ in range(CHECK_EVERY):
            grow = torch.stack(shifted)
            if fixed_range:
                grow = grow.any(0) & ok
            else:
                grow = (grow & oks).any(0)
            region |= grow
        steps += CHECK_EVERY
        n = int(region.sum())
        if n == count:
            break
        count = n
    if n == 0:
        return region, 0, (0, 0, 0, 0), steps
    ys, xs = region.any(1), region.any(0)
    iy = torch.arange(H, device=img.device)
    ix = torch.arange(W, device=img.device)
    x0, y0, x1, y1 = torch.stack([torch.where(xs, ix, W).amin(), torch.where(ys, iy, H).amin(),
                                  torch.where(xs, ix, -1).amax(),
                                  torch.where(ys, iy, -1).amax()]).tolist()
    return region, n, (x0, y0, x1 - x0 + 1, y1 - y0 + 1), steps
