"""cv2's automatic thresholds, as NumPy host scans over 256-bin histograms.

A verbatim copy of the JAX package's ``ref/ops.py`` ``_THRESH_TYPES``,
``otsu_threshold`` and ``triangle_threshold``, which ``api.threshold`` of the
JAX package runs on the host over the device histograms (api.py:563-571).
Copied, not imported: importing the JAX package's ``ref`` imports JAX.
``tests/test_torch_threshold.py`` pins each copy to the original.
"""

from __future__ import annotations

import numpy as np

__all__ = ["THRESH_TYPES", "otsu_threshold", "triangle_threshold"]

THRESH_TYPES = ("binary", "binary_inv", "trunc", "tozero", "tozero_inv")


def otsu_threshold(hist: np.ndarray, total: int) -> int:
    """``cv2.THRESH_OTSU`` threshold from a 256-bin histogram — exact
    transcription of cv2's double recurrence (incl. its quirk of leaving
    ``mu1`` scaled when an endpoint iteration is skipped); 0/200 fuzz
    mismatches vs cv2."""
    flt_eps = float(np.float32(1.1920929e-07))
    scale = 1.0 / total
    mu = 0.0
    for i in range(256):
        mu += i * (hist[i] * scale)
    mu1 = 0.0
    q1 = 0.0
    max_sigma = -1.0
    max_val = 0
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < flt_eps or max(q1, q2) > 1.0 - flt_eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return max_val


def triangle_threshold(hist: np.ndarray) -> int:
    """``cv2.THRESH_TRIANGLE`` threshold from a 256-bin histogram — exact
    transcription of cv2's geometric algorithm (note ``b = left_bound −
    max_ind`` is NEGATIVE in cv2's line-distance form); 0/300 fuzz
    mismatches vs cv2."""
    h = np.asarray(hist, dtype=np.int64).copy()
    i = 0
    while i < 256 and h[i] == 0:
        i += 1
    left_bound = i if i < 256 else 0
    if left_bound > 0:
        left_bound -= 1
    i = 255
    while i > 0 and h[i] == 0:
        i -= 1
    right_bound = i
    if right_bound < 255:
        right_bound += 1
    maxv = 0
    max_ind = 0
    for i in range(256):
        if h[i] > maxv:
            maxv = int(h[i])
            max_ind = i
    isflipped = False
    if max_ind - left_bound < right_bound - max_ind:
        isflipped = True
        h = h[::-1].copy()
        left_bound = 255 - right_bound
        max_ind = 255 - max_ind
    thresh = left_bound
    a = float(maxv)
    b = float(left_bound - max_ind)
    dist = 0.0
    for i in range(left_bound + 1, max_ind + 1):
        tempdist = a * i + b * h[i]
        if tempdist > dist:
            dist = tempdist
            thresh = i
    thresh -= 1
    if isflipped:
        thresh = 255 - thresh
    return int(thresh)
