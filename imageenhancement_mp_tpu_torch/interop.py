"""State carried across from the JAX package.

The system has no weights.  Its only state is the fixed-point tap tables
(``utils/taps.py``, host NumPy in both packages), the per-plane LUTs and
CLAHE's per-tile LUTs.  The JAX flagship keeps each plane's 256-entry LUT
as ``[B, 2, 128]`` int32 (``lut2``, imageenhancement_mp_tpu/pipeline.py:210);
the port keeps ``[B, 256]`` u8.  JAX's CLAHE stage B returns ``[B·gh·gw, S]``
u8 or u16 tile LUTs, tiles in ``(b, ty, tx)`` order; the port's stage C reads
the same layout as a contiguous ``[B·gh·gw, S]`` tensor.  Inputs arrive as NumPy arrays, the format both packages
share; the tensors made here lie on the CPU until the caller moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["planes_from_numpy", "luts_from_lut2", "clahe_luts_from_jax"]


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


def clahe_luts_from_jax(luts, B: int, gh: int, gw: int) -> torch.Tensor:
    """JAX's CLAHE stage-B output (``ops/clahe.py::clahe_tile_luts`` over the
    tiles of B planes: ``[B·gh·gw, S]``, u8 with S = 256 or u16 with
    S = 65536) → the port's ``[B·gh·gw, S]`` CPU table for
    ``kernels/clahe.py::clahe_blend``."""
    a = np.asarray(luts)
    S = {np.dtype(np.uint8): 256, np.dtype(np.uint16): 65536}.get(a.dtype)
    if S is None or a.shape != (B * gh * gw, S):
        raise ValueError(f"expected [{B * gh * gw}, 256] u8 or [{B * gh * gw}, 65536] u16 "
                         f"tile LUTs, got {a.dtype} {a.shape}")
    return torch.from_numpy(a.copy())  # a writable, contiguous copy
