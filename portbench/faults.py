"""Faults planted under the timed path, which the check must refuse, and the
control: the reference in the program's place at a lower precision.

Each takes the program's callable and returns a broken one: a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced.  (A cell on one chip has no exchange between chips.)
"""

from __future__ import annotations

import torch

__all__ = ["FAULTS", "control"]


def unchanged(entry):
    """The input returned as the output: the pipeline does nothing."""
    return lambda batch: batch


def half_batch(entry):
    """Only the first half of the batch's frames processed; the rest passed
    through as they came."""
    def run(batch):
        half = batch.shape[0] // 2
        return torch.cat([entry(batch[:half]), batch[half:]])
    return run


def altered(entry):
    """One pixel of each output changed in its lowest bit."""
    def run(batch):
        out = entry(batch).clone(memory_format=torch.contiguous_format)
        flat = out.view(-1)
        k = flat.numel() // 3
        flat[k] = (flat[k].to(torch.int32) ^ 1).to(out.dtype)
        return out
    return run


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


def control(reference, config: dict, precision=torch.bfloat16):
    """The reference computed with its float32 steps in ``precision``."""
    return lambda batch: reference(batch, config, precision=precision)
