"""Per-element arithmetic: ``cv2.add/subtract/absdiff/multiply/divide``, the
bitwise ops, ``min``/``max``/``compare``, the ``accumulate*`` family and
``blendLinear`` on torch tensors of any shape.

The JAX package's ``ops/arith.py`` and the ``api.py`` closures for
accumulate and blendLinear, in plain PyTorch on the input's device (they
reach no Pallas kernel there).  The laws, pinned to ``ref/ops.py``:

* integer ``add``/``subtract``/``absdiff``: the exact int32 result,
  saturated;
* integer ``multiply``/``divide``: the f64 product ``a·b·scale`` or quotient
  ``a·scale / b`` (``b == 0`` → 0), then ``saturate_cast``: round half to
  even, a value outside int32 becomes INT_MIN (x86 ``cvtsd2si``, so a huge
  product saturates to the dtype's minimum), then clamp.  The H100 has f64,
  so the double-float products the JAX package needs on the TPU are gone
  and integer ``divide`` has no ±1 budget;
* f32: ``a + b``, ``(a·b)·f32(scale)``, ``(a·f32(scale)) / b`` (IEEE ±inf
  and nan), one torch op per rounding;
* the accumulators: ``acc + f32(src)``, ``acc + f32(src)²``,
  ``acc + f32(src1)·f32(src2)``, ``acc·f32(1−α) + src·f32(α)`` — every
  product rounded on its own, never an ``addcmul``;
* ``blend_linear``: ``(src1·w1 + src2·w2) / (w1 + w2 + 1e-5)`` with both
  products rounded to f32, the f32 sum and an IEEE division; u8 rounds half
  to even and saturates.

torch on the CPU has no ``minimum``, comparisons or ``bitwise_not`` for
``torch.uint16``, so integer inputs widen to int32 at entry and narrow at
exit.
"""

from __future__ import annotations

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.utils.ranges import int_bounds

__all__ = ["arith_arrays", "ARITH_OPS", "COMPARE_OPS", "accumulate_arrays", "blend_linear_arrays"]

_INT = (torch.uint8, torch.uint16, torch.int16)
COMPARE_OPS = ("eq", "gt", "ge", "lt", "le", "ne")
_CMP = {"eq": torch.eq, "gt": torch.gt, "ge": torch.ge, "lt": torch.lt, "le": torch.le,
        "ne": torch.ne}
_BITWISE = {"bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
            "bitwise_xor": torch.bitwise_xor}
ARITH_OPS = ("add", "subtract", "absdiff", "multiply", "divide", "minimum", "maximum",
             "bitwise_not") + tuple(_BITWISE) + COMPARE_OPS


def _check(a: torch.Tensor, b: torch.Tensor = None) -> None:
    if a.dtype not in _INT + (torch.float32,):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {a.dtype}")
    if b is not None and (b.dtype != a.dtype or b.shape != a.shape):
        raise ValueError("inputs must share dtype and shape")


def _sat_int(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Clamp an exact int32 result to ``dtype``'s range."""
    lo, hi = int_bounds(dtype)
    return v.clamp(lo, hi).to(dtype)


def _sat_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """cv2's ``saturate_cast<T>(double)`` of an f64 tensor: round half to
    even, INT_MIN for a value outside int32, then clamp."""
    r = torch.round(v)
    r = torch.where((v >= 2.0 ** 31) | (v < -(2.0 ** 31)), -(2.0 ** 31), r)
    lo, hi = int_bounds(dtype)
    return r.clamp(lo, hi).to(dtype)


def arith_arrays(op: str, a: torch.Tensor, b: torch.Tensor = None,
                 scale: float = 1.0) -> torch.Tensor:
    """One elementwise cv2 arithmetic op on tensors of any shape."""
    if op not in ARITH_OPS:
        raise ValueError(f"unknown arithmetic op {op!r}")
    _check(a, None if op == "bitwise_not" else b)
    is_f32 = a.dtype == torch.float32
    if op == "bitwise_not" or op in _BITWISE:
        if is_f32:
            raise TypeError("bitwise ops support integer dtypes")
        ai = a.to(torch.int32)
        if op == "bitwise_not":
            # ~a in the dtype: max − a unsigned, −1 − a signed
            return ((int_bounds(a.dtype)[1] if a.dtype != torch.int16 else -1) - ai).to(a.dtype)
        return _BITWISE[op](ai, b.to(torch.int32)).to(a.dtype)
    if is_f32:
        if op in COMPARE_OPS:
            return torch.where(_CMP[op](a, b), 255, 0).to(torch.uint8)
        if op == "minimum":
            return torch.minimum(a, b)
        if op == "maximum":
            return torch.maximum(a, b)
        if op == "add":
            return a + b
        if op in ("subtract", "absdiff"):
            return (a - b).abs() if op == "absdiff" else a - b
        sc = torch.tensor(float(np.float32(scale)), dtype=torch.float32, device=a.device)
        if op == "multiply":
            return (a * b) * sc
        return (a * sc) / b
    if op in ("multiply", "divide"):
        a64, b64 = a.to(torch.float64), b.to(torch.float64)
        if op == "multiply":
            return _sat_cast(a64 * b64 * float(scale), a.dtype)
        zero = b64 == 0
        q = (a64 * float(scale)) / torch.where(zero, 1.0, b64)
        return _sat_cast(torch.where(zero, 0.0, q), a.dtype)
    ai, bi = a.to(torch.int32), b.to(torch.int32)
    if op in COMPARE_OPS:
        return torch.where(_CMP[op](ai, bi), 255, 0).to(torch.uint8)
    if op == "minimum":
        return torch.minimum(ai, bi).to(a.dtype)
    if op == "maximum":
        return torch.maximum(ai, bi).to(a.dtype)
    r = ai + bi if op == "add" else ai - bi
    return _sat_int(r.abs() if op == "absdiff" else r, a.dtype)


def _masked(acc: torch.Tensor, new: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return new
    m = torch.as_tensor(np.asarray(mask)) if not isinstance(mask, torch.Tensor) else mask
    m = m.to(acc.device) != 0
    if m.dim() == acc.dim() - 1:
        m = m[..., None]
    return torch.where(m, new, acc)


def accumulate_arrays(op: str, src: torch.Tensor, acc: torch.Tensor, src2: torch.Tensor = None,
                      alpha: float = 0.0, mask=None) -> torch.Tensor:
    """``cv2.accumulate`` (``acc``), ``accumulateSquare`` (``sq``),
    ``accumulateProduct`` (``product``, with ``src2``) or
    ``accumulateWeighted`` (``weighted``, with ``alpha``): the new f32
    accumulator; pixels where ``mask`` is 0 keep ``acc``."""
    if acc.dtype != torch.float32:
        raise TypeError(f"accumulator must be float32, got {acc.dtype}")
    s = src.to(torch.float32)
    if op == "acc":
        new = acc + s
    elif op == "sq":
        new = acc + s * s
    elif op == "product":
        new = acc + s * src2.to(torch.float32)
    elif op == "weighted":
        al = torch.tensor(float(np.float32(alpha)), dtype=torch.float32, device=acc.device)
        be = torch.tensor(float(np.float32(1.0 - np.float64(alpha))), dtype=torch.float32,
                          device=acc.device)
        new = acc * be + s * al
    else:
        raise ValueError(f"unknown accumulate op {op!r}")
    return _masked(acc, new, mask)


def _weights(w, like: torch.Tensor) -> torch.Tensor:
    w = w if isinstance(w, torch.Tensor) else torch.as_tensor(np.asarray(w))
    return w.to(like.device, torch.float32)


def blend_linear_arrays(src1: torch.Tensor, src2: torch.Tensor, weights1,
                        weights2) -> torch.Tensor:
    """``cv2.blendLinear`` on ``[H, W]`` or ``[H, W, C]`` u8/f32 sources with
    ``[H, W]`` f32 weights shared across the channels."""
    if src1.shape != src2.shape:
        raise ValueError("sources must share shape")
    if src1.dtype not in (torch.uint8, torch.float32) or src2.dtype != src1.dtype:
        raise TypeError(f"blendLinear supports uint8/float32, got {src1.dtype}")
    w1, w2 = _weights(weights1, src1), _weights(weights2, src1)
    if w1.shape != src1.shape[:2] or w2.shape != src1.shape[:2]:
        raise ValueError("weights must be [H,W] f32 matching the sources")
    den = (w1 + w2) + torch.tensor(float(np.float32(1e-5)), dtype=torch.float32,
                                   device=src1.device)
    if src1.dim() == 3:
        w1, w2, den = w1[..., None], w2[..., None], den[..., None]
    num = src1.to(torch.float32) * w1 + src2.to(torch.float32) * w2
    out = num / den
    if src1.dtype == torch.uint8:
        return torch.round(out).clamp(0, 255).to(torch.uint8)
    return out
