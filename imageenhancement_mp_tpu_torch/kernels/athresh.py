"""Gaussian adaptive threshold on u8 planes: ``cv2.adaptiveThreshold`` with
``ADAPTIVE_THRESH_GAUSSIAN_C``.

:func:`adaptive_threshold_gaussian` replaces
the JAX package's ``kernels/dfconv.py::adaptive_threshold_gaussian_pallas``
with the CUDA kernel ``csrc/athresh.cu`` for every odd block size and every
shape.  The TPU kernel emulates f64 in double-float f32; this card has f64,
so neither the kernel nor :func:`adaptive_threshold_gaussian_plain` (torch
float64) is a double-float computation any more.

The law, pinned to ``ref/ops.py::adaptive_threshold`` (:1145-1157): the
separable f64 conv with cv2's float σ=0 taps and BORDER_REPLICATE, vertical
pass first, each pass ``acc = acc + p·k[d]`` for d ascending from 0.0, every
product and sum rounded once; ``mean = rint(acc)`` (half to even);
``hit = src > mean − idelta``; ``out = hit ? mv : 0`` (binary) or
``hit ? 0 : mv`` (binary_inv).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch

__all__ = ["MAX_TILED_TAPS", "adaptive_threshold_gaussian", "adaptive_threshold_gaussian_plain"]

# the kernel stages the halo of block sizes up to this in shared memory
# (csrc/athresh.cu kMaxTiledK); a larger block size takes its two-pass route
# through an f64 scratch, which the wrapper allocates
MAX_TILED_TAPS = 51
# src and the mean lie in 0..255, so an idelta beyond ±256 decides every
# pixel alike: clamped, it fits the kernel's int32 without changing a result
_IDELTA_BOUND = 512


def _check(planes: torch.Tensor, taps: torch.Tensor, mv: int) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"adaptive_threshold_gaussian expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"adaptive_threshold_gaussian expects [B, H, W] planes, "
                         f"got {tuple(planes.shape)}")
    if taps.dtype != torch.float64 or taps.dim() != 1 or taps.shape[0] < 3 \
            or taps.shape[0] % 2 == 0:
        raise ValueError(f"adaptive_threshold_gaussian: expected an odd [k >= 3] f64 tap vector, "
                         f"got {taps.dtype} {tuple(taps.shape)}")
    if taps.device != planes.device:
        raise ValueError(f"adaptive_threshold_gaussian: planes on {planes.device}, "
                         f"taps on {taps.device}")
    if not 0 <= mv <= 255:
        raise ValueError(f"adaptive_threshold_gaussian: maxval {mv} is not saturated to 0..255")


def adaptive_threshold_gaussian_plain(planes: torch.Tensor, taps: torch.Tensor, mv: int,
                                      idelta: int, inv: bool) -> torch.Tensor:
    mv, idelta = int(mv), int(idelta)
    _check(planes, taps, mv)
    B, H, W = planes.shape
    k = taps.shape[0]
    r = k // 2
    dev = planes.device
    rows_idx = torch.arange(-r, H + r, device=dev).clamp(0, H - 1)
    cols_idx = torch.arange(-r, W + r, device=dev).clamp(0, W - 1)
    p = planes.index_select(1, rows_idx).index_select(2, cols_idx).to(torch.float64)
    rows = torch.zeros((B, H, W + 2 * r), dtype=torch.float64, device=dev)
    for d in range(k):
        rows = rows + p[:, d:d + H, :] * taps[d]
    acc = torch.zeros((B, H, W), dtype=torch.float64, device=dev)
    for d in range(k):
        acc = acc + rows[:, :, d:d + W] * taps[d]
    hit = planes.to(torch.int64) > torch.round(acc).to(torch.int64) - idelta
    if inv:
        hit = ~hit
    return torch.where(hit, mv, 0).to(torch.uint8)


def adaptive_threshold_gaussian(planes: torch.Tensor, taps: torch.Tensor, mv: int, idelta: int,
                                inv: bool) -> torch.Tensor:
    """GAUSSIAN_C adaptive threshold over ``[B, H, W]`` u8 planes → u8.

    ``taps``: cv2's float σ=0 kernel as an f64 ``[k]`` tensor, k odd ≥ 3
    (``utils/taps.py::gaussian_kernel``); ``mv``: round(maxval) saturated to
    0..255; ``idelta``: ceil(C) for binary, floor(C) for binary_inv;
    ``inv``: binary_inv.
    """
    mv, inv = int(mv), bool(inv)
    idelta = max(-_IDELTA_BOUND, min(_IDELTA_BOUND, int(idelta)))
    _check(planes, taps, mv)
    if not on_cuda(planes, "adaptive_threshold_gaussian"):
        return adaptive_threshold_gaussian_plain(planes, taps, mv, idelta, inv)
    check_kernel_input("athresh", planes, taps)
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    k = taps.shape[0]
    scratch = (torch.empty((B, H, W), dtype=torch.float64, device=planes.device)
               if k > MAX_TILED_TAPS else None)
    launch("athresh", planes.device, planes.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), B, H, W, taps.data_ptr(), k, mv,
           idelta, int(inv))
    return out
