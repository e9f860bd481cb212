"""The point ops' host tables, as NumPy arrays: gamma, log and
convertScaleAbs.

A verbatim copy of ``gamma_lut_host`` and ``log_lut_host`` (the JAX
package's ``ops/pointwise.py:57-68``, equal to ``ref/ops.py``'s
``gamma_lut`` and ``log_lut``) and of ``ref/ops.py``'s ``gamma_lut16``,
``log_lut16`` and ``convert_scale_abs_lut`` (:187-214).  It is copied, not
imported, because importing the JAX package's ``ref`` runs that package's
``__init__`` and so imports JAX.  ``tests/test_torch_pointwise.py`` pins each
copy to the original, bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gamma_lut_host", "gamma_lut16", "log_lut_host", "log_lut16",
           "convert_scale_abs_lut"]


def gamma_lut_host(gamma: float) -> np.ndarray:
    """Static power-law LUT ``s = 255·(r/255)^γ`` in f64 (exact; SURVEY.md §2 #1)."""
    r = np.arange(256, dtype=np.float64) / 255.0
    return np.clip(np.round(255.0 * np.power(r, gamma)), 0, 255).astype(np.uint8)


def gamma_lut16(gamma: float) -> np.ndarray:
    """65536-entry power-law LUT for uint16 (single source for oracle+device)."""
    r = np.arange(65536, dtype=np.float64) / 65535.0
    return np.clip(np.round(65535.0 * np.power(r, gamma)), 0, 65535).astype(np.uint16)


def log_lut_host() -> np.ndarray:
    """Static log LUT ``s = c·log(1+r)``, ``c = 255/log 256`` (SURVEY.md §2 #2)."""
    c = 255.0 / np.log(256.0)
    return np.clip(np.round(c * np.log1p(np.arange(256, dtype=np.float64))), 0, 255).astype(
        np.uint8
    )


def log_lut16() -> np.ndarray:
    """65536-entry log LUT for uint16."""
    c = 65535.0 / np.log(65536.0)
    return np.clip(
        np.round(c * np.log1p(np.arange(65536, dtype=np.float64))), 0, 65535
    ).astype(np.uint16)


def convert_scale_abs_lut(alpha: float, beta: float, n: int, offset: int = 0) -> np.ndarray:
    """convertScaleAbs LUT with cv2's single-rounded f32-FMA semantics.
    ``offset`` shifts the value domain (−32768 for int16 inputs; the LUT is
    then indexed by ``v − offset``)."""
    i = np.arange(n, dtype=np.float64) + offset
    fma = np.float32(i * float(np.float32(alpha)) + float(np.float32(beta)))
    return np.clip(np.abs(np.round(fma.astype(np.float64))), 0, 255).astype(np.uint8)
