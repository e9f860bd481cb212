"""Plain reference of ``configs/histeq_unsharp.json``: per plane,
``cv2.equalizeHist`` then unsharp mask."""

from __future__ import annotations

import torch

from portbench.reference import plain

STAGES = ("equalize_hist", "unsharp_mask")


def reference(batch: torch.Tensor, config: dict, precision=torch.float32) -> torch.Tensor:
    """The configuration's output for ``batch`` (``precision``: see ``plain``)."""
    names = tuple(name for name, _ in config["stages"])
    if names != STAGES:
        raise ValueError(f"this reference runs {STAGES}, the configuration states {names}")
    unsharp = config["stages"][1][1]
    planes, restore = plain.as_planes(batch)
    out = [plain.unsharp_mask(plain.equalize_hist(chunk, precision), precision=precision,
                              **unsharp)
           for chunk in plain.plane_chunks(planes)]
    return restore(torch.cat(out))
