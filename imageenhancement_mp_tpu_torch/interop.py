"""State carried across from the JAX package.

The system has no weights.  Its only state is the fixed-point tap tables
(``utils/taps.py``, host NumPy in both packages) and the per-plane LUTs.
The JAX flagship keeps each plane's 256-entry LUT as ``[B, 2, 128]`` int32
(``lut2``, imageenhancement_mp_tpu/pipeline.py:210); the port keeps
``[B, 256]`` u8.  Inputs arrive as NumPy arrays, the format both packages
share; the tensors made here lie on the CPU until the caller moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["planes_from_numpy", "luts_from_lut2"]


def planes_from_numpy(arr: np.ndarray, channels_last: bool = True) -> torch.Tensor:
    """A NumPy image or batch → contiguous ``[B, H, W]`` CPU planes, in the
    plane order both packages' ``as_planes`` use."""
    planes, _ = as_planes(torch.from_numpy(np.ascontiguousarray(arr)), channels_last)
    return planes.contiguous()


def luts_from_lut2(lut2) -> torch.Tensor:
    """The JAX flagship's ``[B, 2, 128]`` int32 ``lut2`` → the port's
    ``[B, 256]`` u8 (row-major: entry v is ``lut2[b, v // 128, v % 128]``)."""
    a = np.asarray(lut2)
    if a.ndim != 3 or a.shape[1:] != (2, 128):
        raise ValueError(f"expected a [B, 2, 128] lut2, got {a.shape}")
    if a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError("lut2 entries must lie in 0..255 for a u8 LUT")
    return torch.from_numpy(a.reshape(a.shape[0], 256).astype(np.uint8))
