"""``cv2.HoughLines``' vote accumulator on the image's device, the law of
the JAX package's ``ops/hough.py``.

Each nonzero pixel (x, y) votes in every angle bin n for
``r = cvRound(fl32(fl32(x·cos_n) + fl32(y·sin_n))) + (numrho − 1)//2``.  The
two products are taken in f64, where a coordinate below 2^12 times an f32
table value is exact, and each is cast to f32 once: the correctly rounded
product.  The add is a separate f32 op on two f32 tensors, so no product
meets an add in one operation (an FMA would change the bits).
``torch.round`` rounds half to even, as ``cvRound`` does.  The votes are
counted with an integer ``bincount`` over ``n·numrho + r``, exact in any
order (``index_add_`` into an int32 accumulator with one more bin, where
the out-of-range votes go and are dropped, as the JAX package's
``mode="drop"`` drops them).  Only the nonzero pixels vote (one
``nonzero``, one sync); the angles
go in chunks so that a chunk's ``[angles, pixels]`` f64 products stay near
:data:`CHUNK_ELEMS` elements.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hough_accumulator", "CHUNK_ELEMS"]

CHUNK_ELEMS = 1 << 24  # f64 products per chunk of angles (128 MB)


def hough_accumulator(img: torch.Tensor, tabcos: np.ndarray, tabsin: np.ndarray,
                      numrho: int) -> torch.Tensor:
    """Vote accumulator ``[numangle, numrho]`` int32 for one ``[H, W]`` u8
    image, on its device (module doc)."""
    numangle = len(tabcos)
    dev = img.device
    ys, xs = torch.nonzero(img, as_tuple=True)
    xf, yf = xs.to(torch.float64), ys.to(torch.float64)
    tc = torch.from_numpy(np.asarray(tabcos, np.float32).astype(np.float64)).to(dev)
    ts = torch.from_numpy(np.asarray(tabsin, np.float32).astype(np.float64)).to(dev)
    c0 = (numrho - 1) // 2
    size = numangle * numrho
    acc = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    nnz = xf.numel()
    step = max(1, CHUNK_ELEMS // max(nnz, 1))
    for a0 in range(0, numangle, step):
        a1 = min(numangle, a0 + step)
        px = (tc[a0:a1, None] * xf[None, :]).to(torch.float32)
        py = (ts[a0:a1, None] * yf[None, :]).to(torch.float32)
        r = torch.round(px + py).to(torch.int64) + c0
        flat = torch.where((r >= 0) & (r < numrho),
                           r + torch.arange(a0, a1, device=dev)[:, None] * numrho, size)
        acc.index_add_(0, flat.view(-1), torch.ones(1, dtype=torch.int32,
                                                    device=dev).expand(flat.numel()))
    return acc[:size].view(numangle, numrho)
