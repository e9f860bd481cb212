"""Thresholding: ``cv2.threshold`` and ``cv2.adaptiveThreshold`` parity.

The counterpart of the JAX package's ``ops/threshold.py``:

* :func:`threshold_planes` — the fixed threshold, an elementwise compare and
  select in plain PyTorch on both devices (the JAX package's is one fused XLA
  pass, no Pallas).  u16 and i16 are widened to int32 at entry: torch on the
  CPU has no u16 comparisons or ``clamp``.
* :func:`adaptive_threshold_planes` — ``mean`` in plain PyTorch on both
  devices (XLA in the JAX package); ``gaussian`` through
  ``kernels/athresh.py`` for every odd block size and every shape, with no
  counterpart of the JAX package's wide/narrow split
  (``supports_athresh_wide``) or its double-float XLA route.

Otsu and Triangle are host scans over device histograms; ``api.threshold``
runs them (``utils/thresholds.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from imageenhancement_mp_tpu_torch.kernels.athresh import adaptive_threshold_gaussian
from imageenhancement_mp_tpu_torch.utils.taps import gaussian_kernel
from imageenhancement_mp_tpu_torch.utils.thresholds import THRESH_TYPES

__all__ = ["threshold_planes", "adaptive_threshold_planes", "THRESH_TYPES", "gaussian_taps"]

# dtype -> (min, max) of its values (utils/ranges.py::int_bounds)
_INT_BOUNDS = {torch.uint8: (0, 255), torch.uint16: (0, 65535), torch.int16: (-32768, 32767)}


def threshold_planes(planes: torch.Tensor, thresh=0.0, maxval: float = 255.0,
                     type: str = "binary") -> torch.Tensor:
    """``cv2.threshold`` per plane (exact; see ref/ops.py ``threshold``).

    ``thresh``: a float (shared) or a tensor or array of per-plane
    thresholds ``[B]`` (the batched generalization of cv2's scalar — used by
    the Otsu/Triangle API path).
    """
    if type not in THRESH_TYPES:
        raise ValueError(f"type must be one of {THRESH_TYPES}, got {type!r}")
    scalar = np.isscalar(thresh)
    dev = planes.device
    if planes.dtype == torch.float32:
        t = (torch.tensor(np.float32(thresh), device=dev) if scalar
             else torch.as_tensor(thresh, device=dev).to(torch.float32))
        mv = torch.tensor(np.float32(maxval), device=dev)
        x = planes
    elif planes.dtype in _INT_BOUNDS:
        minv, maxv = _INT_BOUNDS[planes.dtype]
        if scalar:
            # clamp into the dtype's neighborhood BEFORE int32: comparisons
            # beyond the value range are constant anyway, and cv2/oracle
            # saturate rather than overflow (ref/ops.py threshold)
            t = torch.tensor(int(np.clip(np.floor(float(thresh)), minv - 1, maxv + 1)),
                             dtype=torch.int32, device=dev)
        else:
            t = torch.as_tensor(thresh, device=dev).to(torch.int32)
        mv = torch.tensor(int(np.clip(np.round(float(maxval)), minv, maxv)),
                          dtype=torch.int32, device=dev)
        x = planes.to(torch.int32)
    else:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    if not scalar:
        t = t[:, None, None]  # per-plane thresholds over [B, H, W]
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    if type == "binary":
        out = torch.where(x > t, mv, zero)
    elif type == "binary_inv":
        out = torch.where(x > t, zero, mv)
    elif type == "trunc":
        if planes.dtype != torch.float32 and scalar and np.floor(float(thresh)) < minv:
            # cv2's pinned special case: below-range thresh → TRUNC zeros
            out = torch.zeros_like(x)
        else:
            out = torch.minimum(x, t)
            if planes.dtype != torch.float32:
                out = out.clamp(minv, maxv)
    elif type == "tozero":
        out = torch.where(x > t, x, zero)
    else:  # tozero_inv
        out = torch.where(x > t, zero, x)
    return out.to(planes.dtype)


@functools.lru_cache(maxsize=64)
def gaussian_taps(block_size: int, device: torch.device) -> torch.Tensor:
    """cv2's float σ=0 kernel of ``block_size`` taps as an f64 tensor on
    ``device`` (host NumPy, so equal to ``ref/``'s bit for bit), uploaded
    once per block size and shared by every caller (read it, never write)."""
    return torch.from_numpy(gaussian_kernel(block_size, 0.0)).to(device)


def _box_mean(planes: torch.Tensor, bs: int) -> torch.Tensor:
    """cv2's box mean with BORDER_REPLICATE: the exact integer box sum S,
    then ``rint(f32(S)·f32(1/(bs·bs)))`` (ref/ops.py:1133-1143)."""
    _, H, W = planes.shape
    r = bs // 2
    dev = planes.device
    rows = torch.arange(-r, H + r, device=dev).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=dev).clamp(0, W - 1)
    p = planes.to(torch.int64).index_select(1, rows).index_select(2, cols)
    cv = F.pad(p.cumsum(dim=1), (0, 0, 1, 0))     # a 0 row ahead of the running sums
    v = cv[:, bs:bs + H] - cv[:, :H]              # column sums, [B, H, W + 2r]
    ch = F.pad(v.cumsum(dim=2), (1, 0))
    S = ch[:, :, bs:bs + W] - ch[:, :, :W]
    inv_area = torch.tensor(np.float32(1.0 / (bs * bs)), device=dev)
    return torch.round(S.to(torch.float32) * inv_area).to(torch.int64)


def adaptive_threshold_planes(planes: torch.Tensor, maxval: float = 255.0, method: str = "mean",
                              type: str = "binary", block_size: int = 3,
                              C: float = 0.0) -> torch.Tensor:
    """``cv2.adaptiveThreshold`` per plane — exact (uint8, like cv2).

    Pinned semantics (ref/ops.py ``adaptive_threshold``): local mean over
    ``block_size`` with BORDER_REPLICATE — the box mean with the blur
    f32-reciprocal model, the gaussian mean with cv2's FLOAT σ=0 kernel in
    f64; ``idelta = ceil(C)`` for binary, ``floor(C)`` for binary_inv;
    ``dst = src > mean − idelta ? maxval : 0`` (inverted for binary_inv),
    maxval saturated like threshold.
    """
    if planes.dtype != torch.uint8:
        raise TypeError(f"adaptive_threshold takes uint8 (like cv2), got {planes.dtype}")
    if type not in ("binary", "binary_inv"):
        raise ValueError(f"type must be binary|binary_inv, got {type!r}")
    if method not in ("mean", "gaussian"):
        raise ValueError(f"method must be mean|gaussian, got {method!r}")
    bs = int(block_size)
    if bs < 3 or bs % 2 == 0:
        raise ValueError(f"block_size must be odd and >= 3, got {bs}")
    idelta = int(np.ceil(C)) if type == "binary" else int(np.floor(C))
    mv = int(np.clip(np.round(float(maxval)), 0, 255))
    planes = planes.contiguous()
    if method == "gaussian":
        return adaptive_threshold_gaussian(planes, gaussian_taps(bs, planes.device), mv, idelta,
                                           type == "binary_inv")
    hit = planes.to(torch.int64) > _box_mean(planes, bs) - idelta
    if type == "binary_inv":
        hit = ~hit
    return torch.where(hit, mv, 0).to(torch.uint8)
