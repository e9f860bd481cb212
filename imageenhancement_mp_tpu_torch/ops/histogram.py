"""Histograms (u8 and u16) and histogram equalization (u8), per plane and
pooled.

The counterpart of the JAX package's ``ops/histogram.py`` (:53-182).  u8
planes take one route for every size: per frame, the histogram kernel with
its equalize-LUT epilogue, then the LUT-apply kernel; pooled, the same
histogram kernel with one group of planes a channel (its epilogue builds
each channel's LUT from the pooled counts), then the LUT-apply kernel
(``kernels/hist.py``); across a mesh axis, the histogram kernel, a
``psum`` of the counts, the equalize-LUT kernel, the LUT-apply kernel.  u16
histograms are one ``torch.bincount`` over plane-offset indices on both
devices, as the JAX package scatters them in XLA.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels.hist import (
    apply_lut256,
    equalize_lut256,
    hist256,
    hist256_equalize_lut,
)
from imageenhancement_mp_tpu_torch.parallel.mesh import axis_size, psum

__all__ = ["histogram_256", "equalize_lut", "equalize_hist_planes", "equalize_hist_global_planes"]

_INT32_MAX = 2**31 - 1


def _check_u8(planes: torch.Tensor) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {planes.dtype}")


def histogram_256(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane exact histogram: ``[B, H, W]`` u8 → ``[B, 256]``, u16 →
    ``[B, 65536]``, int32."""
    if planes.dtype == torch.uint16:
        B = planes.shape[0]
        idx = planes.reshape(B, -1).to(torch.int64)
        idx = idx + 65536 * torch.arange(B, device=planes.device)[:, None]
        return torch.bincount(idx.reshape(-1), minlength=65536 * B).reshape(B, 65536).to(
            torch.int32)
    if planes.dtype != torch.uint8:
        raise TypeError(f"histograms take uint8 or uint16 planes, got {planes.dtype}")
    return hist256(planes.contiguous())


def equalize_lut(hist: torch.Tensor, total: int) -> torch.Tensor:
    """cv2.equalizeHist LUT from a ``[256]`` or ``[B, 256]`` int32 histogram
    of planes of ``total`` pixels: ``clip(rint(f32(cdf − h0)·f32(255/(N −
    h0))), 0, 255)``, with the identity for a constant plane."""
    if hist.dim() == 1:
        return equalize_lut256(hist[None].contiguous(), total)[0]
    return equalize_lut256(hist.contiguous(), total)


def equalize_hist_planes(planes: torch.Tensor) -> torch.Tensor:
    """``cv2.equalizeHist`` on each plane of ``[B, H, W]`` u8 — exact.  Two
    launches on CUDA: ``hist256_lut`` and ``apply_lut256``."""
    _check_u8(planes)
    planes = planes.contiguous()
    return apply_lut256(planes, hist256_equalize_lut(planes))


def _check_pool_total(total: int) -> None:
    # the pooled cdf lives in int32: past 2^31 pixels the LUT would wrap
    if total > _INT32_MAX:
        raise ValueError(
            f"pooled histogram covers {total} pixels, which overflows the int32 cdf "
            "(max 2^31-1, about 1035 1080p frames); split the batch into smaller "
            "pooling groups")


def equalize_hist_global_planes(planes: torch.Tensor, channels: int = 1,
                                axis_name=None) -> torch.Tensor:
    """Video-consistent hist-eq: ONE LUT per channel from the histogram
    pooled over all frames of ``[B, H, W]`` u8 planes.

    ``channels`` says the stack is ``B = N·channels`` planes in (frame-major,
    channel-minor) order, the ``as_planes`` layout of ``[N, H, W, C]``; each
    channel pools its own histogram across the N frames.  ``channels=1``
    pools one histogram over every plane.  Inside a sharded call
    (``parallel.mesh.run_sharded``) ``axis_name`` pools across the shards
    along that mesh axis too, with one ``psum``; the int32 cdf check counts
    the pixels of every shard.  On CUDA two launches unsharded
    (``hist256_lut`` with one group a channel, then ``apply_lut256``), three
    with ``axis_name`` (hist256, equalize_lut256 after the ``psum``,
    apply_lut256)."""
    _check_u8(planes)
    B, H, W = planes.shape
    channels = max(int(channels), 1)
    if B % channels:
        raise ValueError(f"plane count {B} not divisible by channels={channels}")
    n = B // channels
    total = n * H * W
    if axis_name is not None:
        total *= axis_size(axis_name)
    _check_pool_total(total)
    planes = planes.contiguous()
    if axis_name is None:
        luts = hist256_equalize_lut(planes, channels)  # [C, 256]
    else:
        hists = hist256(planes).reshape(n, channels, 256).sum(dim=0, dtype=torch.int32)
        luts = equalize_lut256(psum(hists, axis_name), total)
    if channels == 1:
        return apply_lut256(planes, luts[0])
    return apply_lut256(planes, luts.repeat(n, 1))  # plane i takes channel i % C's LUT
