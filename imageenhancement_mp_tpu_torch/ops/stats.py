"""Device scalar statistics: ``cv2.PSNR``, ``cv2.norm``, ``cv2.meanStdDev``,
``cv2.minMaxLoc`` and ``cv2.moments`` as reductions that return 0-d tensors
on the input's device (no ``.item()``, no host sync).

The JAX package's ``ops/stats.py`` in plain PyTorch.  Its double-float
``df_sum`` trees exist because the TPU has no f64; here integer inputs
(u8/u16/i16) sum exactly in int64 and everything else in f64, and each
returned entry is rounded once to f32, as the f64 oracle ``ref/ops.py``
rounded to f32.  ``min_max_loc`` keeps cv2's first-occurrence rule (torch's
``argmin``/``argmax`` return the first index of a tie) and (x, y) order;
``moments_plane`` keeps ``MOMENT_KEYS``' 24 entries and cv2's completion
formulas in the oracle's order.
"""

from __future__ import annotations

import torch

__all__ = ["MOMENT_KEYS", "exact_int", "int_sums", "psnr_arrays", "norm_arrays",
           "mean_std_dev_arrays", "min_max_loc_plane", "raw_moments", "moments_plane"]

_EXACT = (torch.uint8, torch.uint16, torch.int16, torch.bool)
_DBL_EPS = 2.220446049250313e-16  # DBL_EPSILON: cv2's degenerate-m00 gate

MOMENT_KEYS = (
    "m00", "m10", "m01", "m20", "m11", "m02", "m30", "m21", "m12", "m03",
    "mu20", "mu11", "mu02", "mu30", "mu21", "mu12", "mu03",
    "nu20", "nu11", "nu02", "nu30", "nu21", "nu12", "nu03",
)


def exact_int(x: torch.Tensor) -> bool:
    """True when ``x``'s values and their squares sum exactly in int64."""
    return x.dtype in _EXACT


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE f64 quotient of a tensor by a tensor (a Python ``scalar / tensor``
    in torch is a reciprocal and a multiply, two roundings)."""
    b = b if isinstance(b, torch.Tensor) else torch.full_like(a, float(b))
    return a / b


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float64)


def _ints(x: torch.Tensor, other: torch.Tensor = None) -> torch.Tensor:
    """``x`` (``x − other`` when given) flattened to int64, exact."""
    d = x.reshape(-1).to(torch.int64)
    return d if other is None else d - other.reshape(-1).to(torch.int64)


def int_sums(x: torch.Tensor, other: torch.Tensor = None) -> tuple[torch.Tensor, torch.Tensor,
                                                                    torch.Tensor]:
    """(Σ|d|, Σd, Σd²) as exact int64 0-d tensors of an integer tensor ``x``
    (``d = x − other`` when ``other`` is given)."""
    d = _ints(x, other)
    return d.abs().sum(), d.sum(), (d * d).sum()


def psnr_arrays(a: torch.Tensor, b: torch.Tensor, max_val: float = 255.0) -> torch.Tensor:
    """``cv2.PSNR`` over the whole of ``a`` and ``b`` → 0-d f32 (``inf`` on
    identical inputs): the squared-error sum exact in int64 for integer
    inputs (f64 otherwise), ``10·log10(R²/MSE)`` in f64, one f32 rounding."""
    if a.shape != b.shape:
        raise ValueError("inputs must share shape")
    if exact_int(a) and exact_int(b):
        sq = int_sums(a, b)[2].to(torch.float64)
    else:
        d = _f64(a) - _f64(b)
        sq = (d * d).sum()
    mse = _div(sq, float(a.numel()))
    r2 = torch.full_like(mse, float(max_val) * float(max_val))
    val = 10.0 * torch.log10(_div(r2, mse))
    return torch.where(mse == 0, torch.full_like(val, float("inf")), val).to(torch.float32)


def norm_arrays(a: torch.Tensor, norm_type: str = "l2", other: torch.Tensor = None) -> torch.Tensor:
    """``cv2.norm(a[, other])`` over the whole tensor → 0-d f32: l1 and l2
    sums exact in int64 for integer inputs (f64 otherwise), the root in f64,
    one f32 rounding; inf the exact largest magnitude."""
    if norm_type not in ("l1", "l2", "inf"):
        raise ValueError(f"unknown norm {norm_type!r} (l1|l2|inf)")
    if other is not None and other.shape != a.shape:
        raise ValueError("inputs must share shape")
    if exact_int(a) and (other is None or exact_int(other)):
        d = _ints(a, other)
    else:
        d = _f64(a) if other is None else _f64(a) - _f64(other)
    if norm_type == "inf":
        return d.abs().amax().to(torch.float32)
    if norm_type == "l1":
        return d.abs().sum().to(torch.float32)
    return torch.sqrt((d * d).sum().to(torch.float64)).to(torch.float32)


def mean_std_dev_arrays(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``cv2.meanStdDev`` over the whole tensor → (mean, population std) 0-d
    f32.  Integer inputs: Σx and Σx² exact in int64; with ``Σx = q·n + r``
    the variance's numerator ``Σx² − (Σx)²/n = (Σx² − q²n − 2qr) − r²/n``
    keeps its integer part exact, so only the last division and the root
    round in f64.  Float inputs: the two-pass f64 form of the oracle."""
    n = img.numel()
    if exact_int(img):
        _, sx, sxx = int_sums(img)
        q = torch.div(sx, n, rounding_mode="floor")
        r = sx - q * n
        k = (sxx - q * q * n - 2 * q * r).to(torch.float64)
        m2 = k - _div((r * r).to(torch.float64), float(n))
        mean = _div(sx.to(torch.float64), float(n))
    else:
        x = _f64(img)
        mean = _div(x.sum(), float(n))
        d = x - mean
        m2 = (d * d).sum()
    var = _div(m2, float(n)).clamp_min(0.0)
    return mean.to(torch.float32), torch.sqrt(var).to(torch.float32)


def min_max_loc_plane(arr: torch.Tensor):
    """``cv2.minMaxLoc`` on a 2-D map → ``(min f32, max f32, min_x, min_y,
    max_x, max_y)`` 0-d tensors, coordinates int32, first occurrence in
    row-major order."""
    if arr.dim() != 2:
        raise ValueError("min_max_loc expects a 2-D array")
    w = arr.shape[1]
    flat = arr.reshape(-1)
    if flat.dtype == torch.uint16:  # no argmin for uint16 on the CPU
        flat = flat.to(torch.int32)
    imn, imx = torch.argmin(flat), torch.argmax(flat)
    return (flat[imn].to(torch.float32), flat[imx].to(torch.float32),
            (imn % w).to(torch.int32), torch.div(imn, w, rounding_mode="floor").to(torch.int32),
            (imx % w).to(torch.int32), torch.div(imx, w, rounding_mode="floor").to(torch.int32))


def _split_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of int64 terms, each below 2^62, as the f64
    nearest the exact sum: the high and low 31-bit halves sum apart (no
    overflow below 2^31 terms) and meet in one f64 add."""
    hi = (t >> 31).sum(-1)
    lo = (t & ((1 << 31) - 1)).sum(-1)
    return hi.to(torch.float64) * float(1 << 31) + lo.to(torch.float64)


def raw_moments(img: torch.Tensor, binary_image: bool = False) -> dict:
    """The ten raw moments ``m_pq = Σ x^p·y^q·I`` (p + q ≤ 3) of a 2-D image
    as f64 0-d tensors.  Integer images: each row's ``Σ_x x^p·I`` exactly in
    int64 and the column sums through :func:`_split_sum`, so each moment is
    the f64 nearest its exact value (the oracle's f64 sums are exact at the
    sizes where they do not round); float images: f64 sums."""
    if img.dim() != 2:
        raise ValueError("moments expects a single-channel image")
    H, W = img.shape
    dev = img.device
    if binary_image:
        img = img != 0
    m = {}
    if exact_int(img) and _int_rows_fit(img.dtype, W, H):
        I = img.to(torch.int64)
        x = torch.arange(W, dtype=torch.int64, device=dev)
        y = torch.arange(H, dtype=torch.int64, device=dev)
        for p in range(4):
            c = (I * x ** p).sum(-1)  # [H], exact
            for q in range(4 - p):
                m[f"m{p}{q}"] = _split_sum(c * y ** q)
        return m
    I = img.to(torch.float64)
    x = torch.arange(W, dtype=torch.float64, device=dev)
    y = torch.arange(H, dtype=torch.float64, device=dev)
    for p in range(4):
        for q in range(4 - p):
            m[f"m{p}{q}"] = ((x ** p)[None, :] * (y ** q)[:, None] * I).sum()
    return m


def _int_rows_fit(dtype: torch.dtype, W: int, H: int) -> bool:
    """Whether every int64 term of :func:`raw_moments` (a row's
    ``Σ_x x^p·I`` times ``y^q``, p + q ≤ 3) stays below 2^62."""
    vmax = {torch.bool: 1, torch.uint8: 255, torch.uint16: 65535, torch.int16: 32768}[dtype]
    return vmax * W * max(W - 1, H - 1, 1) ** 3 < 2 ** 62


def moments_plane(img: torch.Tensor, binary_image: bool = False) -> torch.Tensor:
    """``cv2.moments`` of a 2-D image → ``f32[24]`` ordered like
    ``MOMENT_KEYS``: the raw moments of :func:`raw_moments`, cv2's central
    and normalised completion in f64 in the oracle's order, one f32
    rounding per entry."""
    m = raw_moments(img, binary_image)
    m00 = m["m00"]
    ok = m00.abs() > _DBL_EPS
    one = torch.ones_like(m00)
    inv = torch.where(ok, _div(one, torch.where(ok, m00, one)), torch.zeros_like(m00))
    cx = torch.where(ok, m["m10"] * inv, torch.zeros_like(m00))
    cy = torch.where(ok, m["m01"] * inv, torch.zeros_like(m00))
    mu20 = m["m20"] - m["m10"] * cx
    mu11 = m["m11"] - m["m10"] * cy
    mu02 = m["m02"] - m["m01"] * cy
    mu30 = m["m30"] - cx * (3 * mu20 + cx * m["m10"])
    mu21 = m["m21"] - cx * (2 * mu11 + cx * m["m01"]) - cy * mu20
    mu12 = m["m12"] - cy * (2 * mu11 + cy * m["m10"]) - cx * mu02
    mu03 = m["m03"] - cy * (3 * mu02 + cy * m["m01"])
    s2 = inv * inv
    s3 = s2 * torch.sqrt(inv.abs())
    vals = [m[k] for k in MOMENT_KEYS[:10]] + [mu20, mu11, mu02, mu30, mu21, mu12, mu03,
                                                mu20 * s2, mu11 * s2, mu02 * s2,
                                                mu30 * s3, mu21 * s3, mu12 * s3, mu03 * s3]
    return torch.stack(vals).to(torch.float32)
