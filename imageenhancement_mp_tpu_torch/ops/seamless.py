"""``seamlessClone`` (NORMAL_CLONE) on the device: the FFT-DST Poisson solve.

The counterpart of the JAX package's ``ops/seamless.py``, in plain PyTorch
on the input's device.  Two type-1 sine transforms per axis (odd-extension
real FFTs through ``torch.fft``, as the JAX package uses ``jnp.fft``), an
eigenvalue divide and the inverse transforms; the geometry (the mask's
bounding box, the paste rectangle) is the caller's host work.  f32
spectra: about one LSB from the f64 oracle ``ref/seamless.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["seamless_clone_patch"]

F32 = torch.float32


def _dst1(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Type-1 discrete sine transform along ``axis`` (unnormalised): the odd
    extension ``[0, a, 0, −a reversed]`` through ``rfft``."""
    a = a.movedim(axis, -1)
    n = a.shape[-1]
    z = torch.zeros(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device)
    ext = torch.cat([z, a, z, -a.flip(-1)], dim=-1)
    sp = torch.fft.rfft(ext, dim=-1)
    out = -sp.imag[..., 1:n + 1] / torch.full((), 2.0, dtype=F32, device=a.device)
    return out.movedim(-1, axis)


@functools.lru_cache(maxsize=64)
def _eigen(hh: int, ww: int, dev: torch.device) -> torch.Tensor:
    """The separable 5-point Laplacian's eigenvalues on an ``hh × ww``
    interior, f32 on ``dev``."""
    jj = np.arange(1, hh + 1)
    kk = np.arange(1, ww + 1)
    ev = (2.0 * np.cos(np.pi * jj / (hh + 1))[:, None]
          + 2.0 * np.cos(np.pi * kk / (ww + 1))[None, :] - 4.0)
    return torch.from_numpy(ev.astype(np.float32)).to(dev)


def _fgrad(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences, 0 in the last column (row)."""
    gx = torch.zeros_like(a)
    gy = torch.zeros_like(a)
    gx[..., :, :-1] = a[..., :, 1:] - a[..., :, :-1]
    gy[..., :-1, :] = a[..., 1:, :] - a[..., :-1, :]
    return gx, gy


def seamless_clone_patch(src_patch: torch.Tensor, dst_patch: torch.Tensor,
                         mask_patch: torch.Tensor) -> torch.Tensor:
    """Blend ``[C, h, w]`` u8 src/dst patches under a ``[h, w]`` bool mask:
    the guidance field (src gradients inside the mask, dst outside), its
    backward-difference divergence, the Dirichlet Poisson solve with dst's
    frame, ``clip(round(·))`` to u8."""
    c, h, w = src_patch.shape
    hh, ww = h - 2, w - 2
    s = src_patch.to(F32)
    d = dst_patch.to(F32)
    sgx, sgy = _fgrad(s)
    dgx, dgy = _fgrad(d)
    gx = torch.where(mask_patch, sgx, dgx)
    gy = torch.where(mask_patch, sgy, dgy)
    lap = torch.zeros_like(gx)
    lap[:, :, 1:] = gx[:, :, 1:] - gx[:, :, :-1]
    lap[:, :, :1] = gx[:, :, :1]
    lap[:, 1:, :] += gy[:, 1:, :] - gy[:, :-1, :]
    lap[:, :1, :] += gy[:, :1, :]
    rhs = lap[:, 1:-1, 1:-1].clone()
    rhs[:, 0, :] += -d[:, 0, 1:-1]
    rhs[:, -1, :] += -d[:, -1, 1:-1]
    rhs[:, :, 0] += -d[:, 1:-1, 0]
    rhs[:, :, -1] += -d[:, 1:-1, -1]
    t = _dst1(_dst1(rhs, 1), 2) / _eigen(hh, ww, s.device)
    scale = torch.full((), float(np.float32(4.0 / ((hh + 1) * (ww + 1)))), dtype=F32,
                       device=s.device)
    f = _dst1(_dst1(t, 1), 2) * scale
    out = d.clone()
    out[:, 1:-1, 1:-1] = f
    return torch.round(out).clamp(0, 255).to(torch.uint8)
