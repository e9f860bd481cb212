"""Plain reference of ``configs/denoise_clahe_sharpen.json``: per plane,
``cv2.medianBlur``, CLAHE, then unsharp mask, on u8 or u16 planes."""

from __future__ import annotations

import torch

from portbench.reference import plain

STAGES = ("median_blur", "clahe", "unsharp_mask")


def reference(batch: torch.Tensor, config: dict, precision=torch.float32) -> torch.Tensor:
    """The configuration's output for ``batch`` (``precision``: see ``plain``)."""
    names = tuple(name for name, _ in config["stages"])
    if names != STAGES:
        raise ValueError(f"this reference runs {STAGES}, the configuration states {names}")
    median, clahe, unsharp = (kwargs for _, kwargs in config["stages"])
    planes, restore = plain.as_planes(batch)
    out = []
    for chunk in plain.plane_chunks(planes, 1 << 23):
        x = plain.median_blur(chunk, **median)
        x = plain.clahe(x, precision=precision, **clahe)
        out.append(plain.unsharp_mask(x, precision=precision, **unsharp))
    return restore(torch.cat(out))
