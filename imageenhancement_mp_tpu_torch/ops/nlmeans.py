"""Non-local means denoising: ``cv2.fastNlMeansDenoising`` and its
``Multi`` variant on vector pixels — the counterpart of the JAX package's
``ops/nlmeans.py``, bit-exact like it.

For each of the T·s² search candidates (T temporal frames × s² spatial
offsets) a few torch ops form the integer squared (L2) or absolute (L1)
difference map of the shifted view against the target frame's, summed over
the pixel's channels (cv2's joint SSD), box-sums it over the t×t template
with two int32 cumulative sums, looks the fixed-point weight up in cv2's
LUT (one :func:`~imageenhancement_mp_tpu_torch.kernels.take.take_table`
per candidate, a kernel launch on CUDA) and accumulates Σw and Σw·v.  The
candidate loop is plain torch, as the JAX package keeps it in XLA.

* The cumulative sums are ``cumsum(dtype=torch.int32)``: they wrap on large
  frames, and the windowed difference recovers the exact t×t sum (< 2^31)
  by modular arithmetic, as in the JAX package (int32 keeps half the bytes
  of torch's default int64 promotion).
* u8 accumulates ``w·(v − 128)`` in int32 and ends with the exact
  ``128 + (Σw(v−128) + Σw/2) // Σw``; u16 (NORM_L1 only, FPM = INT_MAX)
  accumulates in int64.
* The frame is padded by ``s//2 + t//2`` with NumPy's ``reflect`` (cv2's
  REFLECT_101, reflected again where the pad exceeds the frame): reflected
  indices and a gather, so frames narrower than the pad work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from imageenhancement_mp_tpu_torch.kernels.take import take_table
from imageenhancement_mp_tpu_torch.utils.nlm_tables import nlm_weight_lut

__all__ = ["fast_nl_means_planes", "fast_nl_means_vec", "fast_nl_means_multi_vec",
           "fast_nl_means_u16_vec", "reflect_indices"]

I32, I64 = torch.int32, torch.int64


def reflect_indices(n: int, pad: int, device) -> torch.Tensor:
    """Source index of each of the ``n + 2·pad`` positions of NumPy's
    ``reflect`` pad of a length-``n`` axis (REFLECT_101, repeated)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _reflect_pad(x: torch.Tensor, pad: int, hdim: int) -> torch.Tensor:
    """``x`` padded by ``pad`` on the two axes ``hdim`` and ``hdim + 1``."""
    H, W = x.shape[hdim], x.shape[hdim + 1]
    x = x.index_select(hdim, reflect_indices(H, pad, x.device))
    return x.index_select(hdim + 1, reflect_indices(W, pad, x.device))


@functools.lru_cache(maxsize=64)
def _lut(h: float, t: int, s: int, cn: int, temporal: int, norm: str, maxval: int,
         dev: torch.device) -> tuple[torch.Tensor, int, int]:
    """cv2's weight LUT (its live prefix) on ``dev``, its bin shift and its
    last index."""
    w, bs, _ = nlm_weight_lut(h, t, s, cn, temporal=temporal, norm=norm, maxval=maxval)
    dtype = np.int64 if maxval > 255 else np.int32
    return torch.from_numpy(w.astype(dtype)).to(dev), bs, len(w) - 1


def _window_sums(d: torch.Tensor, t: int) -> torch.Tensor:
    """The t×t box sums of ``d [N, H+t−1, W+t−1]`` int32 → ``[N, H, W]``,
    through int32 integral images that may wrap."""
    c = torch.cumsum(torch.cumsum(d, dim=1, dtype=I32), dim=2, dtype=I32)
    c = F.pad(c, (1, 0, 1, 0))
    return c[:, t:, t:] - c[:, :-t, t:] - c[:, t:, :-t] + c[:, :-t, :-t]


def _check_windows(t: int, s: int) -> None:
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")


def fast_nl_means_multi_vec(stack: torch.Tensor, h: float = 10.0, template_window: int = 7,
                            search_window: int = 21, norm_type: str = "l2") -> torch.Tensor:
    """``cv2.fastNlMeansDenoisingMulti`` core on ``(T, N, H, W, C)`` uint8
    vector pixels: denoise the centre frame (index T//2) of each batch
    element with candidates from every frame of the temporal window.
    C ∈ {1, 2, 3, 4}; one joint SSD over the channels drives a weight shared
    by every channel."""
    if stack.dtype != torch.uint8:
        raise TypeError("fastNlMeansDenoising requires uint8 input")
    t, s = int(template_window), int(search_window)
    _check_windows(t, s)
    T, N, H, W, C = stack.shape
    if T % 2 == 0:
        raise ValueError("temporal window must be odd")
    if C not in (1, 2, 3, 4):
        raise ValueError(f"fastNlMeansDenoising supports 1-4 channels, got {C}")
    if norm_type not in ("l1", "l2"):
        raise ValueError(f"norm_type must be 'l1' or 'l2', got {norm_type!r}")
    th, sh = t // 2, s // 2
    border = sh + th
    lut, bs, cut = _lut(float(h), t, s, C, T, norm_type, 255, stack.device)
    p = _reflect_pad(stack.to(I32), border, 2)
    a = p[T // 2, :, border - th:border + H + th, border - th:border + W + th]
    est = torch.zeros((N, H, W, C), dtype=I32, device=stack.device)
    wsum = torch.zeros((N, H, W), dtype=I32, device=stack.device)
    for f in range(T):
        for dy in range(s):
            for dx in range(s):
                y0, x0 = border - th + dy - sh, border - th + dx - sh
                d = a - p[f, :, y0:y0 + H + 2 * th, x0:x0 + W + 2 * th]
                d = d.abs() if norm_type == "l1" else d * d
                ssd = _window_sums(d.sum(dim=-1, dtype=I32), t)
                ww = take_table(torch.clamp_max(ssd >> bs, cut), lut)
                v = p[f, :, border + dy - sh:border + dy - sh + H,
                      border + dx - sh:border + dx - sh + W]
                # accumulate v − 128 so Σw·v never crosses int32 even at Σw max
                est += ww[..., None] * (v - 128)
                wsum += ww
    # exact (Σwv + Σw/2) // Σw: v was biased by −128 in the loop (floor
    # division distributes exactly over multiples of the divisor)
    ws = torch.clamp_min(wsum, 1)
    num = est + (wsum >> 1)[..., None]
    out = 128 + torch.div(num, ws[..., None], rounding_mode="floor")
    return out.clamp(0, 255).to(torch.uint8)


def fast_nl_means_vec(img: torch.Tensor, h: float = 10.0, template_window: int = 7,
                      search_window: int = 21, norm_type: str = "l2") -> torch.Tensor:
    """``cv2.fastNlMeansDenoising`` on ``(N, H, W, C)`` uint8 vector pixels
    (C ∈ {1, 2, 3, 4}): one joint SSD over the channels drives a weight
    shared by every channel — cv2's multichannel semantics."""
    return fast_nl_means_multi_vec(img[None], h, template_window, search_window, norm_type)


def fast_nl_means_planes(planes: torch.Tensor, h: float = 10.0, template_window: int = 7,
                         search_window: int = 21) -> torch.Tensor:
    """``cv2.fastNlMeansDenoising`` per plane on ``(N, H, W)`` uint8."""
    return fast_nl_means_vec(planes[..., None], h, template_window, search_window)[..., 0]


def fast_nl_means_u16_vec(img: torch.Tensor, h: float = 10.0, template_window: int = 7,
                          search_window: int = 21) -> torch.Tensor:
    """``cv2.fastNlMeansDenoising`` on ``(N, H, W, C)`` uint16 vector pixels
    with NORM_L1 (cv2's only 16-bit norm): the LUT's multiplier is INT_MAX
    and Σw, Σw·v accumulate in int64.  The SAD integral images stay int32
    (true t×t sums ≤ t²·4·65535 < 2^31)."""
    if img.dtype != torch.uint16:
        raise TypeError("fast_nl_means_u16_vec requires uint16 input")
    t, s = int(template_window), int(search_window)
    _check_windows(t, s)
    N, H, W, C = img.shape
    if C not in (1, 2, 3, 4):
        raise ValueError(f"fastNlMeansDenoising supports 1-4 channels, got {C}")
    th, sh = t // 2, s // 2
    border = sh + th
    lut, bs, cut = _lut(float(h), t, s, C, 1, "l1", 65535, img.device)
    p = _reflect_pad(img.to(I32), border, 1)
    a = p[:, border - th:border + H + th, border - th:border + W + th]
    est = torch.zeros((N, H, W, C), dtype=I64, device=img.device)
    wsum = torch.zeros((N, H, W), dtype=I64, device=img.device)
    for dy in range(s):
        for dx in range(s):
            y0, x0 = border - th + dy - sh, border - th + dx - sh
            sad = (a - p[:, y0:y0 + H + 2 * th, x0:x0 + W + 2 * th]).abs().sum(dim=-1, dtype=I32)
            ww = take_table(torch.clamp_max(_window_sums(sad, t) >> bs, cut), lut)
            v = p[:, border + dy - sh:border + dy - sh + H, border + dx - sh:border + dx - sh + W]
            est += ww[..., None] * v.to(I64)
            wsum += ww
    ws = torch.clamp_min(wsum, 1)
    out = torch.div(est + (wsum >> 1)[..., None], ws[..., None], rounding_mode="floor")
    return out.clamp(0, 65535).to(torch.uint16)
