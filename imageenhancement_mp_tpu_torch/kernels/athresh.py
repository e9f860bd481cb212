"""Gaussian adaptive threshold on u8 planes: ``cv2.adaptiveThreshold`` with
``ADAPTIVE_THRESH_GAUSSIAN_C``.

:func:`adaptive_threshold_gaussian` replaces
the JAX package's ``kernels/dfconv.py::adaptive_threshold_gaussian_pallas``
with the CUDA kernel ``csrc/athresh.cu`` for every odd block size and every
shape.  The TPU kernel emulates f64 in double-float f32; this card has f64,
so neither the kernel nor :func:`adaptive_threshold_gaussian_plain` (torch
float64) is a double-float computation any more.

For block sizes ≤ 51 the kernel screens in f32 and recomputes in the
oracle's f64 order only the pixels whose f32 sum lies within a margin of the
decision boundary (:func:`screen_margin`); :func:`adaptive_threshold_screened_plain`
is that algorithm in plain PyTorch, and equals the plain version bit for bit.

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

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, host_derived, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch

__all__ = ["MAX_TILED_TAPS", "adaptive_threshold_gaussian", "adaptive_threshold_gaussian_plain",
           "adaptive_threshold_screened_plain", "screen_bounds", "screen_margin", "screen_sums"]

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


def _padded(planes: torch.Tensor, r: int, dtype: torch.dtype) -> torch.Tensor:
    _, H, W = planes.shape
    dev = planes.device
    rows_idx = torch.arange(-r, H + r, device=dev).clamp(0, H - 1)
    cols_idx = torch.arange(-r, W + r, device=dev).clamp(0, W - 1)
    return planes.index_select(1, rows_idx).index_select(2, cols_idx).to(dtype)


def _separable(p: torch.Tensor, taps: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The oracle's order in ``taps``' dtype: vertical then horizontal, each
    ``acc = acc + p·k[d]`` for d ascending from 0, every op rounded once."""
    k = taps.shape[0]
    rows = torch.zeros((p.shape[0], H, p.shape[2]), dtype=taps.dtype, device=p.device)
    for d in range(k):
        rows = rows + p[:, d:d + H, :] * taps[d]
    acc = torch.zeros((p.shape[0], H, W), dtype=taps.dtype, device=p.device)
    for d in range(k):
        acc = acc + rows[:, :, d:d + W] * taps[d]
    return acc


def _decide(hit: torch.Tensor, mv: int, inv: bool) -> torch.Tensor:
    return torch.where(hit != inv, mv, 0).to(torch.uint8)


def adaptive_threshold_gaussian_plain(planes: torch.Tensor, taps: torch.Tensor, mv: int,
                                      idelta: int, inv: bool) -> torch.Tensor:
    mv, idelta = int(mv), int(idelta)
    _check(planes, taps, mv)
    B, H, W = planes.shape
    acc = _separable(_padded(planes, taps.shape[0] // 2, torch.float64), taps, H, W)
    hit = planes.to(torch.int64) > torch.round(acc).to(torch.int64) - idelta
    return _decide(hit, mv, inv)


def _gamma(n: int, u: float) -> float:
    return n * u / (1 - n * u)


def screen_bounds(taps) -> tuple[float, float]:
    """``(b32, b64)``: bounds on ``|acc32 − A|`` and ``|acc64 − A|`` for the
    exact sum ``A`` over u8 planes, ``γ_{2k+2}(u)·255·(Σ|k|)²`` with u = 2⁻²⁴
    and 2⁻⁵³.  Each term of the separable sum meets at most k + 1 roundings
    a pass (its product, the sums after it, and the f32 rounding of its
    tap; the first sum adds to 0 and is exact), with or without fused
    multiply-adds.  Exact (0, 0) for taps that are multiples of 2⁻⁸, ≥ 0,
    summing to at most 1 (cv2's σ=0 tables at k 3/5/7/9): every f32 product
    and partial sum is then a multiple of 2⁻¹⁶ below 2⁸."""
    t = np.asarray(taps, dtype=np.float64)
    if np.all(t >= 0) and np.all(t * 256 == np.round(t * 256)) and t.sum() <= 1:
        return 0.0, 0.0
    k, s = t.shape[0], float(np.abs(t).sum())
    return (_gamma(2 * k + 2, 2.0 ** -24) * 255 * s * s,
            _gamma(2 * k + 2, 2.0 ** -53) * 255 * s * s)


def screen_margin(taps) -> float:
    """The screen's ε: twice ``b32 + b64`` (:func:`screen_bounds`), rounded
    up to an f32.  Where ``|acc32 − (m + ½)| > ε``, acc64 lies on the same
    side of ``m + ½`` as acc32, so the f32 decision is the oracle's."""
    eps = 2 * sum(screen_bounds(taps))
    e32 = np.float32(eps)
    if float(e32) < eps:  # compared in f64: NumPy compares f32 with a Python float in f32
        e32 = np.nextafter(e32, np.float32(np.inf))
    return float(e32)


def screen_sums(planes: torch.Tensor, taps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(acc32, acc64)``: the screen's f32 sum (f32 taps, each op rounded
    once) and the oracle's f64 sum."""
    B, H, W = planes.shape
    r = taps.shape[0] // 2
    acc32 = _separable(_padded(planes, r, torch.float32), taps.to(torch.float32), H, W)
    acc64 = _separable(_padded(planes, r, torch.float64), taps, H, W)
    return acc32, acc64


def adaptive_threshold_screened_plain(planes: torch.Tensor, taps: torch.Tensor, mv: int,
                                      idelta: int, inv: bool, margin: float | None = None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in plain PyTorch: ``(out, recomputed)``.

    The f32 screen decides ``hit = acc32 < m + ½`` (m = src + idelta − 1)
    where ``|acc32 − (m + ½)| > ε`` (``margin``, :func:`screen_margin` by
    default); the other pixels (``recomputed``) take the oracle's f64
    decision.  The kernel fuses its f32 products into its sums; both lie
    within :func:`screen_bounds`."""
    mv, idelta = int(mv), int(idelta)
    _check(planes, taps, mv)
    eps = screen_margin(taps.cpu().numpy()) if margin is None else float(margin)
    acc32, _ = screen_sums(planes, taps)
    b = planes.to(torch.float32) + torch.tensor(np.float32(idelta - 0.5), device=planes.device)
    d = acc32 - b
    screened = (d < -eps) | (d > eps)
    out = torch.where(screened, _decide(d < 0, mv, inv),
                      adaptive_threshold_gaussian_plain(planes, taps, mv, idelta, inv))
    return out, ~screened


def adaptive_threshold_gaussian(planes: torch.Tensor, taps: torch.Tensor, mv: int, idelta: int,
                                inv: bool, *, _margin: float | None = None,
                                _runtime: bool = False) -> torch.Tensor:
    """GAUSSIAN_C adaptive threshold over ``[B, H, W]`` u8 planes → u8.

    ``taps``: cv2's float σ=0 kernel as an f64 ``[k]`` tensor, k odd ≥ 3
    (``utils/taps.py::gaussian_kernel``); ``mv``: round(maxval) saturated to
    0..255; ``idelta``: ceil(C) for binary, floor(C) for binary_inv;
    ``inv``: binary_inv.

    For block sizes ≤ 51 the kernel screens in f32 with the margin
    :func:`screen_margin` (the bound is written out in ``screen_bounds`` and
    ``csrc/athresh.cu``) and recomputes the rest in the oracle's f64 order.
    ``_margin`` overrides the margin (``float("inf")`` recomputes every
    pixel) and ``_runtime`` takes the kernel's runtime instance at a block
    size that has a compile-time one: both are for the card checks and A/Bs.
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
    eps = host_derived(taps, "athresh margin", screen_margin) if _margin is None else _margin
    launch("athresh", planes.device, planes.data_ptr(), out.data_ptr(),
           None if scratch is None else scratch.data_ptr(), B, H, W, taps.data_ptr(), k, mv,
           idelta, int(inv), float(eps), int(bool(_runtime)))
    return out
