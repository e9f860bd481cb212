"""Point ops: ``cv2.LUT`` on u8 planes."""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256

__all__ = ["apply_lut_planes"]


def apply_lut_planes(planes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``cv2.LUT`` ≡ gather: u8 planes ``[B, ...]`` with a u8 ``[256]`` shared
    or ``[B, 256]`` per-plane table.  u16 planes and u16/i32/f32 tables are
    ROADMAP Queue 1 item 4."""
    if planes.dtype != torch.uint8 or lut.shape[-1] != 256:
        raise NotImplementedError(
            f"u8 planes with 256-entry tables only (got {planes.dtype} planes, "
            f"{tuple(lut.shape)} table); the rest is ROADMAP Queue 1 item 4")
    return apply_lut256(planes.contiguous(), lut.contiguous())
