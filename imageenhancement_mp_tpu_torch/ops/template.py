"""Template matching: ``cv2.matchTemplate`` on ``[B, H, W]`` planes, all
six methods.

The JAX package's ``ops/template.py`` in plain PyTorch on the input's device
(it reaches no Pallas kernel there), with ``ref/ops.py::match_template``'s
arithmetic: the correlation and the window sums in f64, the method's formula
in f64, one cast to f32 at the end, and SQDIFF_NORMED clamped to [0, 1] as
cv2 clamps it.  The correlation is one f64 ``conv2d`` per template row (a
``1 × tw`` kernel each, so the CPU's unfolded copy stays one row of taps
deep); f64 also keeps cuDNN's TF32 and its Winograd/FFT algorithms out of
the sum.  The window sums add the window's rows, then its columns, in f64
(exact for integer planes).  The JAX package's f32 convolutions at highest precision are its
stand-in: it is within 3e-6 relative of ``ref/``.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.shapes import host_array

__all__ = ["match_template_planes", "METHODS"]

METHODS = ("sqdiff", "sqdiff_normed", "ccorr", "ccorr_normed", "ccoeff", "ccoeff_normed")
F64 = torch.float64


def _correlate(I: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Valid correlation of ``[N, H, W]`` f64 planes with a ``[th, tw]`` f64
    template: ``[N, H − th + 1, W − tw + 1]``, summed row by row."""
    th = T.shape[0]
    oh = I.shape[1] - th + 1
    x = I[:, None]
    acc = None
    for dy in range(th):
        part = torch.nn.functional.conv2d(x[:, :, dy:dy + oh, :], T[dy][None, None, None, :])
        acc = part if acc is None else acc + part
    return acc[:, 0]


def _window_sums(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The sum of every ``th × tw`` window of ``[N, H, W]`` f64 planes, rows
    then columns (no running sums: their differences would cancel)."""
    oh, ow = x.shape[1] - th + 1, x.shape[2] - tw + 1
    v = sum(x[:, dy:dy + oh, :] for dy in range(th))
    return sum(v[:, :, dx:dx + ow] for dx in range(tw))


def match_template_planes(planes: torch.Tensor, templ,
                          method: str = "ccoeff_normed") -> torch.Tensor:
    """``cv2.matchTemplate`` per plane on ``[N, H, W]`` → f32
    ``[N, H − th + 1, W − tw + 1]``; ``templ`` is a 2-D array (read as f32,
    as the JAX package reads it)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    T = host_array(templ).astype(np.float32)
    if T.ndim != 2:
        raise ValueError(f"template must be 2-D, got shape {T.shape}")
    th, tw = T.shape
    H, W = planes.shape[-2], planes.shape[-1]
    if th > H or tw > W:
        raise ValueError("template larger than image")
    I = planes.to(F64)
    T64 = T.astype(np.float64)
    ccorr = _correlate(I, torch.from_numpy(T64).to(planes.device))
    n = th * tw
    sT, sT2 = float(T64.sum()), float((T64 * T64).sum())
    if method == "ccorr":
        return ccorr.to(torch.float32)
    sI = _window_sums(I, th, tw)
    sI2 = _window_sums(I * I, th, tw)
    if method in ("sqdiff", "sqdiff_normed"):
        num = (sT2 - 2 * ccorr) + sI2
        if method == "sqdiff":
            return num.to(torch.float32)
        den = torch.sqrt(sT2 * sI2)
        r = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 1.0)
        return r.clamp(0.0, 1.0).to(torch.float32)
    if method == "ccorr_normed":
        den = torch.sqrt(sT2 * sI2)
        return torch.where(den > 0, ccorr / torch.where(den > 0, den, 1.0),
                           1.0).to(torch.float32)
    num = ccorr - sI * (sT / n)
    if method == "ccoeff":
        return num.to(torch.float32)
    den = torch.sqrt(max(sT2 - sT * sT / n, 0.0) * torch.clamp_min(sI2 - sI * sI / n, 0.0))
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-300), 0.0).to(torch.float32)
