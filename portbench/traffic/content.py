"""The one generator of the benchmark's inputs: a traffic mix's JSON file
(``traffic/<name>.json``) in, a pool of distinct input batches on the device
out, the same pool for the same seed.

A mix gives the batch (``layout`` gray ``[N, H, W]`` or hwc ``[N, H, W, C]``,
``dtype``, ``bits`` of content, ``frames``, ``height``, ``width``,
``channels``), the closed loop's ``depth``, the pool's least size
(``pool.min_batches``, ``pool.min_bytes``: large enough that a call's input
is not sitting in the card's 50 MB L2), the batches checked after the window
(``sample``), the calls a traced run profiles (``trace_calls``) and the
content's parameters.

Content looks like camera frames, not like uniform noise (which gives flat
histograms and leaves hist-eq and CLAHE nothing to do): a smooth field, a
piecewise-constant mosaic and oriented step edges, band-limited texture,
then a dark, low-contrast exposure per frame (gain, offset, gamma), colour
tints per channel and sensor noise.  The exposures are stratified: the pool's
frames take evenly spaced quantiles of each range, in an order drawn from
the seed, so every seed offers the same spread of exposures and the work of
the data-dependent kernels does not swing with the seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["batch_shape", "frame_pixels", "pool_batches", "make_pool"]

_DTYPES = {"uint8": torch.uint8, "uint16": torch.uint16}


def batch_shape(mix: dict) -> tuple[int, ...]:
    """The shape of one batch that the mix hands to the entry point."""
    n, h, w = mix["frames"], mix["height"], mix["width"]
    if mix["layout"] == "gray":
        return (n, h, w)
    if mix["layout"] == "hwc":
        return (n, h, w, mix["channels"])
    raise ValueError(f"unknown layout {mix['layout']!r}")


def frame_pixels(mix: dict) -> int:
    """Frame pixels a batch carries: H·W per frame, channels not counted."""
    return mix["frames"] * mix["height"] * mix["width"]


def pool_batches(mix: dict) -> int:
    """How many distinct batches the pool holds."""
    nbytes = math.prod(batch_shape(mix)) * (1 if mix["dtype"] == "uint8" else 2)
    return max(mix["pool"]["min_batches"], -(-mix["pool"]["min_bytes"] // nbytes))


def _strata(count: int, lo: float, hi: float, g: torch.Generator, device) -> torch.Tensor:
    """``count`` evenly spaced quantiles of ``[lo, hi]`` in a seeded order."""
    order = torch.randperm(count, generator=g, device=device).to(torch.float32)
    return lo + (hi - lo) * (order + 0.5) / count


def _frames(count: int, chans: int, h: int, w: int, p: dict, exposure: torch.Tensor,
            g: torch.Generator, device) -> torch.Tensor:
    """``[count, chans, h, w]`` float32 frames in [0, 1]; ``exposure`` is
    ``[count, 3]`` (gain, offset, gamma)."""

    def noise(*shape):
        return torch.randn(*shape, generator=g, device=device)

    def up(lo: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "nearest":
            return F.interpolate(lo, size=(h, w), mode=mode)
        return F.interpolate(lo, size=(h, w), mode=mode, align_corners=False)

    s = p["field_weight"] * up(noise(count, 1, *p["field_grid"]), "bicubic")
    s += p["mosaic_weight"] * up(torch.rand(count, 1, *p["mosaic_grid"], generator=g,
                                            device=device), "nearest")
    yy = torch.linspace(-1.0, 1.0, h, device=device).view(1, 1, h, 1)
    xx = torch.linspace(-1.0, 1.0, w, device=device).view(1, 1, 1, w)
    for _ in range(p["edges"]):
        a, b, c = noise(3, count, 1, 1, 1).unbind(0)
        s += (p["edge_weight"] / p["edges"]) * (a * xx + b * yy + 0.5 * c > 0).to(torch.float32)
    step = p["texture_step"]
    s += p["texture_weight"] * up(noise(count, 1, -(-h // step), -(-w // step)), "bilinear")
    lo = s.amin(dim=(1, 2, 3), keepdim=True)
    hi = s.amax(dim=(1, 2, 3), keepdim=True)
    s = (s - lo) / (hi - lo + 1e-6)
    gain, offset, gamma = (exposure[:, i].view(count, 1, 1, 1) for i in range(3))
    v = offset + gain * s.pow(gamma)
    if chans > 1:
        t0, t1 = p["tint"]
        v = v * (t0 + (t1 - t0) * torch.rand(count, chans, 1, 1, generator=g, device=device))
    return (v + p["noise_sigma"] * noise(count, chans, h, w)).clamp_(0.0, 1.0)


def make_pool(mix: dict, seed: int, device, chunk_pixels: int = 1 << 24) -> list[torch.Tensor]:
    """The pool of distinct input batches for ``mix``, made on ``device``
    from ``seed`` in chunks of at most ``chunk_pixels`` pixels."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dtype = _DTYPES[mix["dtype"]]
    maxv = float((1 << mix["bits"]) - 1)
    n, h, w = mix["frames"], mix["height"], mix["width"]
    chans = mix["channels"] if mix["layout"] == "hwc" else 1
    p = mix["content"]
    count = pool_batches(mix)
    e = p["exposure"]
    exposure = torch.stack([_strata(count * n, *e[k], g, device)
                            for k in ("gain", "offset", "gamma")], dim=1)
    step = max(1, chunk_pixels // (h * w * chans))
    pool = []
    for b in range(count):
        batch = torch.empty(batch_shape(mix), dtype=dtype, device=device)
        for f0 in range(0, n, step):
            f1 = min(n, f0 + step)
            v = _frames(f1 - f0, chans, h, w, p, exposure[b * n + f0:b * n + f1], g, device)
            q = (v * maxv).round_().to(torch.int32).to(dtype)
            batch[f0:f1] = q[:, 0] if mix["layout"] == "gray" else q.permute(0, 2, 3, 1)
        pool.append(batch)
    return pool
