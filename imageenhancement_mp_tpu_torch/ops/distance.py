"""``cv2.distanceTransform`` per plane: the two-pass chamfer over sheared
columns, the law of the JAX package's ``ops/distance.py``.

Cell (i, j) lives at sheared column q = shear·i + j (shear 2 for the 3×3
mask, 3 for the 5×5); every candidate of the forward raster pass then sits
in one of the ``depth`` columns before q (3 for the 3×3 mask, 7 for the
5×5), so the pass is a sweep over the Q = shear·(H−1) + W columns, each
column a vector step over the planes and rows.  Rounding to f32 is monotone
and ``min`` commutes with it, so any schedule that forms each candidate with
one rounded f32 add ``src + w`` gives the raster order's bits.

The field is stored column-major, ``[depth + Q, B, 2 + H]`` flattened:
``depth`` columns and 2 rows of ``FLT_MAX`` in front, so the rows above the
image read ``FLT_MAX``.  A candidate of cell (b, i) of column q lies at a
fixed flat offset from the column's start (column q − dq, row i − rows up),
so one index tensor ``[candidates + 1, B, H]`` of those offsets, the
column's own cell last, serves every column through ``torch.take`` on the
field from that column on.  Column q holds image rows ``lo(q)..hi(q)``
only, a contiguous range: a step reads and writes just that range, and the
cells outside the image are never written and stay ``FLT_MAX``
(``FLT_MAX + w`` rounds back to ``FLT_MAX``).  A step is three launches
whatever the batch: one ``take`` of the candidates and the column itself
(weight 0: ``x + 0`` is ``x``), one add of the weight vector, one ``amin``
written into the column.  Each column depends on the one before it, so a
pass is Q dependent steps, paced by the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["distance_transform_planes", "DIST_MASKS"]

FLT_MAX = float(np.float32(3.4028235e38))

DIST_MASKS = {
    ("l1", 3): (np.float32(1.0), np.float32(2.0), None),
    ("c", 3): (np.float32(1.0), np.float32(1.0), None),
    ("l2", 3): (np.float32(0.955), np.float32(1.3693), None),
    ("l2", 5): (np.float32(1.0), np.float32(1.4), np.float32(2.1969)),
}


def _neighbors(a, b, c) -> list:
    """cv2's forward candidates as (rows up, dj, weight): left, up, up-left,
    up-right, and for the 5×5 mask the eight knight moves' forward half."""
    n = [(0, -1, a), (1, 0, a), (1, -1, b), (1, 1, b)]
    if c is not None:
        n += [(1, -2, c), (1, 2, c), (2, -1, c), (2, 1, c)]
    return n


def _chamfer_pass(d: torch.Tensor, neigh: list, shear: int) -> torch.Tensor:
    """One forward chamfer pass over ``[B, H, W]`` f32 planes, column by
    sheared column (module doc)."""
    B, H, W = d.shape
    Q = shear * (H - 1) + W
    shifts = [(pi, shear * pi - dj) for pi, dj, _ in neigh] + [(0, 0)]
    depth = max(dq for _, dq in shifts)
    R = H + 2
    BR = B * R
    S = torch.full(((depth + Q) * BR,), FLT_MAX, dtype=torch.float32, device=d.device)
    # cell (b, i, j) -> S[(depth + shear*i + j)*BR + b*R + 2 + i]
    cells = S.as_strided((B, H, W), (R, shear * BR + 1, BR), depth * BR + 2)
    cells.copy_(d)
    cols = S.view(depth + Q, B, R)
    # candidate k of cell (b, i) of column q: (depth + q)*BR + 2 + c_k + b*R + i
    c = [-dq * BR - pi for pi, dq in shifts]
    idx = (torch.tensor(c, dtype=torch.int64).view(-1, 1, 1) - min(c)
           + torch.arange(B).view(1, -1, 1) * R + torch.arange(H).view(1, 1, -1)).to(d.device)
    w = torch.tensor([float(w) for _, _, w in neigh] + [0.0], dtype=torch.float32,
                     device=d.device).view(-1, 1, 1)
    base = depth * BR + 2 + min(c)
    for q in range(1, Q):
        lo = max(0, -(-(q - W + 1) // shear))
        hi = min(H - 1, q // shear) + 1
        cand = torch.take(S[base + q * BR:], idx[:, :, lo:hi])
        cand.add_(w)
        torch.amin(cand, 0, out=cols[depth + q, :, 2 + lo:2 + hi])
    return cells.contiguous()


def distance_transform_planes(planes: torch.Tensor, distance_type: str = "l2",
                              mask_size: int = 3, dst_type: str = "f32") -> torch.Tensor:
    """``cv2.distanceTransform`` per plane on ``[B, H, W]`` uint8: zero
    pixels are the sources, f32 out (u8 for L1: the field clipped to
    [0, 255] and truncated).  L1 and C use the 3×3 mask whatever
    ``mask_size`` says; untouched pixels stay ``FLT_MAX``."""
    if planes.dtype != torch.uint8:
        raise TypeError("distanceTransform requires uint8 input")
    dt = str(distance_type).lower()
    m = 3 if dt in ("l1", "c") else int(mask_size)
    a, b, c = DIST_MASKS[(dt, m)]
    shear = 2 if c is None else 3
    neigh = _neighbors(a, b, c)
    if planes.numel() == 0:
        d = torch.zeros(planes.shape, dtype=torch.float32, device=planes.device)
    else:
        d = torch.where(planes == 0, 0.0, FLT_MAX).to(torch.float32)
        d = _chamfer_pass(d, neigh, shear)
        d = _chamfer_pass(d.flip(1, 2), neigh, shear).flip(1, 2)
    if dst_type == "u8":
        return d.clamp(0, 255).to(torch.uint8)
    return d
