"""Shape canonicalization for the batched op API.

Every op works on a stack of 2-D planes ``[B, H, W]`` (B = N·C), exactly as
the JAX package's ``utils/shapes.py`` does, with the same accepted
layouts and the same ambiguity rule:

    [H, W]          one grayscale image
    [H, W, C]       one multi-channel image (channels enhanced independently)
    [N, H, W]       batch of grayscale images
    [N, H, W, C]    batch of multi-channel images

AMBIGUITY: a 3-D input whose last dim is ≤ 4 is one ``[H, W, C]`` image.  A
batch of grayscale images narrower than 5 pixels ``[N, H, W≤4]`` would be
misread — pass ``[N, H, W, 1]`` or ``channels_last=False``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["treat_as_hwc", "as_vec", "as_planes", "host_array"]

Restore = Callable[[torch.Tensor], torch.Tensor]


def treat_as_hwc(img: torch.Tensor, channels_last: bool = True) -> bool:
    """A 3-D tensor is one ``[H, W, C]`` image iff ``channels_last`` and its
    last dim is ≤ 4 (the single layout rule of both packages)."""
    return img.dim() == 3 and channels_last and img.shape[-1] in (1, 2, 3, 4)


def as_vec(img: torch.Tensor, channels_last: bool = True) -> Tuple[torch.Tensor, Restore]:
    """Canonicalize to ``[N, H, W, C]`` vector-pixel batches (for ops whose
    cv2 semantics join the channels, such as fastNlMeansDenoising's joint
    SSD) and return the undo function.  The same ambiguity rule as
    :func:`as_planes`: a 3-D input is one ``[H, W, C]`` image iff
    :func:`treat_as_hwc`, otherwise a grayscale ``[N, H, W]`` batch (C = 1);
    4-D is always ``[N, H, W, C]``."""
    nd = img.dim()
    if nd == 2:
        return img[None, ..., None], lambda out: out[0, ..., 0]
    if nd == 3:
        if treat_as_hwc(img, channels_last):
            return img[None], lambda out: out[0]
        return img[..., None], lambda out: out[..., 0]
    if nd == 4:
        return img, lambda out: out
    raise ValueError(f"expected 2-4 dims ([N,]H,W[,C]), got shape {tuple(img.shape)}")


def as_planes(img: torch.Tensor, channels_last: bool = True) -> Tuple[torch.Tensor, Restore]:
    """Canonicalize to ``[B, H, W]`` and return a function undoing the reshape.

    The planes are not necessarily contiguous (``[H, W, C]`` gives a view);
    the ops make them contiguous on the tensor's own device."""
    nd = img.dim()
    if nd == 2:
        return img[None], lambda out: out[0]
    if nd == 3:
        if treat_as_hwc(img, channels_last):
            return torch.movedim(img, -1, 0), lambda out: torch.movedim(out, 0, -1)
        return img, lambda out: out
    if nd == 4:
        n, h, w, c = img.shape
        planes = torch.movedim(img, -1, 1).reshape(n * c, h, w)
        return planes, lambda out: torch.movedim(
            out.reshape(n, c, out.shape[-2], out.shape[-1]), 1, -1
        )
    raise ValueError(f"expected 2-4 dims ([N,]H,W[,C]), got shape {tuple(img.shape)}")


def host_array(x) -> np.ndarray:
    """``x`` as a NumPy array on the host: a tensor on any device is copied
    back (``np.asarray`` cannot read a CUDA tensor); anything else goes
    through ``np.asarray``.  For the small arguments read on the host:
    templates, kernels, histograms, points."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
