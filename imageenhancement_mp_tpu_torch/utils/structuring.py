"""``cv2.getStructuringElement`` as NumPy: rect, ellipse and cross masks.

A verbatim copy of ``get_structuring_element`` in the JAX package's
``ref/ops.py``, copied, not imported, because importing the JAX package's
``ref`` runs that package's ``__init__`` and so imports JAX.
``tests/test_torch_morphology.py`` pins it to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_structuring_element"]


def get_structuring_element(shape: str, ksize) -> np.ndarray:
    """``cv2.getStructuringElement`` — bit-exact over a 15x15 size
    sweep.  ``shape``: rect | ellipse | cross; ``ksize`` = (rows, cols)
    row-major; default anchor (rows//2, cols//2).  Degenerate rows=1
    ellipse keeps only the anchor column (r=0 → dx=0), like cv2."""
    rows, cols = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) \
        else (int(ksize), int(ksize))
    if shape == "rect":
        return np.ones((rows, cols), np.uint8)
    if shape == "cross":
        k = np.zeros((rows, cols), np.uint8)
        k[rows // 2, :] = 1
        k[:, cols // 2] = 1
        return k
    if shape == "ellipse":
        r, c = rows // 2, cols // 2
        inv = 1.0 / (r * r) if r > 0 else 0.0
        k = np.zeros((rows, cols), np.uint8)
        for i in range(rows):
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.round(c * np.sqrt(max(r * r - dy * dy, 0) * inv)))
                k[i, max(c - dx, 0):min(c + dx + 1, cols)] = 1
        return k
    raise ValueError(f"unknown shape {shape!r} (rect|ellipse|cross)")
