"""The integer dtype value-range table (the JAX package's ``utils/ranges.py``
for torch dtypes)."""

from __future__ import annotations

import torch

__all__ = ["int_bounds"]

_BOUNDS = {
    torch.uint8: (0, 255),
    torch.uint16: (0, 65535),
    torch.int16: (-32768, 32767),
}


def int_bounds(dtype: torch.dtype) -> tuple[int, int]:
    """(min, max) representable value of an integer image dtype."""
    return _BOUNDS[dtype]
