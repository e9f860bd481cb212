"""Separable u8 Gaussian with optional LUT prologue and unsharp epilogue.

:func:`sep_conv_u8` replaces both TPU conv kernels,
the JAX package's ``kernels/conv2.py::sep_conv5_wide`` (wide shapes,
LUT prologue) and the JAX package's ``kernels/conv.py::_sep_conv_planes``
(any shape), with one CUDA kernel (``csrc/conv.cu``) for every shape and
every odd ksize per axis.  :func:`sep_conv_u8_plain` is the same
function in plain PyTorch.

The host picks the kernel's instance and route (:func:`conv_route`): an
axis of more than 31 taps first loses the zero taps at its two ends (equal
runs, so the centre stays; :func:`trim_taps`), then a compile-time instance
for k 3, 5 or 7 on both axes, the runtime one for any other pair up to 31
taps, the wide one (:data:`WIDE`, its taps in a device buffer) where either
axis still has more; the horizontal pass on packed 16-bit lanes where the
taps reduced by their common power of two have scales ``qv·qh ≤ 256`` (the
JAX package's ``kernels/conv2.py::_reduce_taps`` rule), else in int32 on the
Q8 taps (exact f32 FMAs in the wide instance); and the epilogue
(:func:`epilogue_mode`): on lanes for an integral amount in [0, 127], where
cv2's two FMAs are exact, else the FMAs themselves.

The law, pinned to ``ref/ops.py``: cv2's Q8 taps, REFLECT_101 borders
(``numpy.pad(mode="reflect")``, reflecting again when the halo is deeper than
the plane), int32 accumulation, ``blur = (acc + 2^15) >> 16``; the unsharp
epilogue is cv2's two single-rounded f32 FMAs for every ``amount``::

    t = f32(blur · f32(−amount));  out = sat_u8(rint(f32(src · f32(1 + amount) + t)))
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda, stream_handle
from imageenhancement_mp_tpu_torch.kernels._build import launch
from imageenhancement_mp_tpu_torch.kernels.hist import apply_lut256_plain
from imageenhancement_mp_tpu_torch.utils.fma import fma32

__all__ = ["COMPILED_K", "ConvRoute", "RUNTIME_MAX_TAPS", "MAX_LANE_AMOUNT", "WIDE",
           "conv_route", "epilogue_mode", "reduce_taps", "reflect101", "sep_conv_u8",
           "sep_conv_u8_plain", "trim_taps", "unsharp_weights", "wide_tap_buffer"]

RUNTIME_MAX_TAPS = 31    # the most taps an axis passes by value (the runtime instance)
COMPILED_K = (3, 5, 7)   # kv = kh = k; every other pair runs the runtime or the wide instance
WIDE = -1                # the wide instance: any odd tap count, taps in device memory
MAX_LANE_AMOUNT = 127    # (1 + a)·255 + 256a ≤ 65535 keeps the epilogue's lanes apart


def unsharp_weights(amount: float) -> tuple[float, float]:
    """``(alpha, beta) = (f32(1 + amount), f32(−amount))``, each an exact f32
    value held in a Python float (kernels/conv2.py:226's narrowing)."""
    return float(np.float32(1.0 + amount)), float(np.float32(-amount))


def _check_taps(taps: Sequence[int], axis: str) -> tuple[int, ...]:
    t = tuple(int(v) for v in taps)
    if len(t) % 2 == 0:
        raise ValueError(f"{axis} taps: an odd count expected, got {len(t)}")
    # non-negative Q8 taps summing to at most 256 keep acc < 2^31 and blur ≤ 255
    if min(t) < 0 or sum(t) > 256:
        raise ValueError(f"{axis} taps must be >= 0 with a sum <= 256, got {t}")
    return t


def reduce_taps(taps: Sequence[int]) -> tuple[tuple[int, ...], int]:
    """Divide Q8 taps by their common power of two; return (taps, log2 q),
    q the reduced scale (the JAX package's ``kernels/conv2.py::_reduce_taps``)."""
    z = 8
    for t in taps:
        if t:
            z = min(z, (t & -t).bit_length() - 1)
    return tuple(t >> z for t in taps), 8 - z


def trim_taps(taps: Sequence[int]) -> tuple[int, ...]:
    """An axis of more than :data:`RUNTIME_MAX_TAPS` taps without the zero
    taps its two ends share (as many from each end, so the centre and every
    REFLECT_101 index stay); shorter axes as they are.  Exact: a zero tap
    adds nothing."""
    t = tuple(taps)
    if len(t) <= RUNTIME_MAX_TAPS:
        return t
    z = 0
    while 2 * z + 1 < len(t) and t[z] == 0 and t[-1 - z] == 0:
        z += 1
    return t[z:len(t) - z]


class ConvRoute(NamedTuple):
    """What the kernel runs for one tap pair."""
    instance: int              # 3, 5 or 7: the compile-time instance; 0: the runtime one;
                               # WIDE: the wide one
    packed: bool               # horizontal pass on 16-bit lanes (else int32)
    taps_v: tuple[int, ...]    # the taps the kernel multiplies by: trimmed past 31,
    taps_h: tuple[int, ...]    # reduced when packed
    shift: int                 # blur = (acc + 2^(shift-1)) >> shift; 16 on the int32 route

    def describe(self) -> str:
        inst = {0: "runtime", WIDE: "wide"}.get(self.instance, f"k{self.instance}")
        return f"{inst}/{'packed' if self.packed else 'int32'}"


def conv_route(taps_v: Sequence[int], taps_h: Sequence[int]) -> ConvRoute:
    """The instance and route for checked Q8 taps.  Packed where the reduced
    scales give ``qv·qh ≤ 256``: every vertical sum is then ≤ 255·qv and
    every horizontal one ≤ 255·qv·qh ≤ 65535, so neither pass carries across
    a lane, and ``(acc + q/2) >> log2 q`` is cv2's ``(acc8 + 2^15) >> 16``
    (``acc8 = acc·65536/q``).  Counted after :func:`trim_taps`: more than
    :data:`RUNTIME_MAX_TAPS` taps on either axis take the wide instance on
    the int32 route."""
    tv, th = trim_taps(taps_v), trim_taps(taps_h)
    if max(len(tv), len(th)) > RUNTIME_MAX_TAPS:
        return ConvRoute(WIDE, False, tv, th, 16)
    k = len(tv) if len(tv) == len(th) and len(tv) in COMPILED_K else 0
    (rv, lv), (rh, lh) = reduce_taps(tv), reduce_taps(th)
    if lv + lh <= 8:
        return ConvRoute(k, True, rv, rh, lv + lh)
    return ConvRoute(k, False, tv, th, 16)


@functools.lru_cache(maxsize=64)
def _launch_taps(tv: tuple[int, ...], th: tuple[int, ...]) -> tuple[ConvRoute, np.ndarray, np.ndarray]:
    """The route and its taps as int32 host arrays, kept per tap pair: the
    wrapper's host time is the paths' pace once the kernels are fast."""
    route = conv_route(tv, th)
    return route, *(np.ascontiguousarray(t, np.int32) for t in (route.taps_v, route.taps_h))


def wide_tap_buffer(tv: Sequence[int], th: Sequence[int]) -> np.ndarray:
    """What the wide instance reads: ``tv`` as int32, then ``th`` as f32
    (its horizontal pass runs exact f32 FMAs) zero-padded to a multiple of 8
    plus 8 (it reads the taps 8 at a time, and 8 past its segment), the f32
    bits held in int32."""
    thf = np.zeros(-(-len(th) // 8) * 8 + 8, np.float32)
    thf[:len(th)] = th
    return np.concatenate([np.asarray(tv, np.int32), thf.view(np.int32)])


@functools.lru_cache(maxsize=16)
def _device_taps(tv: tuple[int, ...], th: tuple[int, ...], device: torch.device,
                 stream: int) -> torch.Tensor:
    """The wide instance's taps (:func:`wide_tap_buffer` of the route's
    trimmed taps) as an int32 buffer on ``device``, made once per tap pair,
    device and stream and never written again.  Made on the stream whose
    launches read it, so the caching allocator reuses it only after they
    ran, once the cache drops it."""
    return torch.from_numpy(wide_tap_buffer(tv, th)).to(device)


def epilogue_mode(amount: float | None) -> tuple[int, int]:
    """``(mode, a)``: 0 writes the blur; 1 an integral ``amount`` a in
    [0, MAX_LANE_AMOUNT], where ``alpha = 1 + a`` and ``beta = −a`` are exact
    and every product is an integer below 2^24, so cv2's two FMAs are exact
    and equal ``clamp((1 + a)·src − a·blur, 0, 255)``; 2 the two FMAs."""
    if amount is None:
        return 0, 0
    if float(amount).is_integer() and 0 <= amount <= MAX_LANE_AMOUNT:
        return 1, int(amount)
    return 2, 0


def reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    """``numpy.pad(mode="reflect")`` source index of each padded index ``i``
    along an axis of ``n``: period 2(n−1), so a pad deeper than the axis
    reflects again; a 1-pixel axis repeats its only pixel."""
    if n == 1:
        return torch.zeros_like(i)
    m = 2 * (n - 1)
    i = torch.remainder(i, m)
    return torch.where(i >= n, m - i, i)


def sep_conv_u8_plain(planes: torch.Tensor, taps_v: Sequence[int], taps_h: Sequence[int],
                      amount: float | None = None,
                      luts: torch.Tensor | None = None) -> torch.Tensor:
    src = planes if luts is None else apply_lut256_plain(planes, luts)
    B, H, W = src.shape
    rv, rh = len(taps_v) // 2, len(taps_h) // 2
    rows = reflect101(torch.arange(-rv, H + rv, device=src.device), H)
    cols = reflect101(torch.arange(-rh, W + rh, device=src.device), W)
    p = src.to(torch.int32).index_select(1, rows).index_select(2, cols)
    v = sum(int(t) * p[:, j:j + H, :] for j, t in enumerate(taps_v))
    acc = sum(int(t) * v[:, :, j:j + W] for j, t in enumerate(taps_h))
    blur = ((acc + 32768) >> 16).clamp(max=255)
    if amount is None:
        return blur.to(torch.uint8)
    alpha, beta = (torch.tensor(w, dtype=torch.float32, device=src.device)
                   for w in unsharp_weights(amount))
    t = blur.to(torch.float32) * beta
    r = fma32(src.to(torch.float32), alpha, t)
    return torch.round(r).clamp(0, 255).to(torch.uint8)


def sep_conv_u8(planes: torch.Tensor, taps_v: Sequence[int], taps_h: Sequence[int],
                amount: float | None = None,
                luts: torch.Tensor | None = None) -> torch.Tensor:
    """Separable Q8 conv over ``[B, H, W]`` u8 planes → ``[B, H, W]`` u8.

    ``taps_v``/``taps_h``: cv2's Q8 integer taps per axis
    (``utils/taps.py::gaussian_kernel_fixed``), any odd count.
    ``amount``: None writes the blur; a float writes the unsharp epilogue
    ``addWeighted(src, 1+amount, blur, −amount)``.  ``luts``: optional
    ``[B, 256]`` u8 per-plane table applied to the pixels before the conv;
    ``src`` in the epilogue is then the mapped pixel.
    """
    if planes.dtype != torch.uint8:
        raise TypeError(f"sep_conv_u8 expects uint8 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"sep_conv_u8 expects [B, H, W] planes, got {tuple(planes.shape)}")
    tv, th = _check_taps(taps_v, "vertical"), _check_taps(taps_h, "horizontal")
    if luts is not None:
        if luts.dtype != torch.uint8 or luts.shape != (planes.shape[0], 256):
            raise ValueError(f"sep_conv_u8: expected [B, 256] u8 luts, got "
                             f"{luts.dtype} {tuple(luts.shape)}")
        if luts.device != planes.device:
            raise ValueError(f"sep_conv_u8: planes on {planes.device}, luts on {luts.device}")
    if not on_cuda(planes, "sep_conv_u8"):
        return sep_conv_u8_plain(planes, tv, th, amount, luts)
    check_kernel_input("sep_conv_u8", planes, *(() if luts is None else (luts,)))
    B, H, W = planes.shape
    out = torch.empty_like(planes)
    if out.numel() == 0:
        return out
    alpha, beta = (1.0, 0.0) if amount is None else unsharp_weights(amount)
    route, c_tv, c_th = _launch_taps(tv, th)
    dev_taps = (_device_taps(route.taps_v, route.taps_h, planes.device,
                             stream_handle(planes.device)).data_ptr()
                if route.instance == WIDE else None)
    mode, amount_i = epilogue_mode(amount)
    launch("sep_conv_u8", planes.device, planes.data_ptr(), out.data_ptr(), B, H, W,
           c_tv.ctypes.data, len(c_tv), c_th.ctypes.data, len(c_th), dev_taps,
           None if luts is None else luts.data_ptr(),
           route.instance, int(route.packed), route.shift, mode, amount_i, alpha, beta)
    return out
