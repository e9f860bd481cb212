"""The port's per-element arithmetic, accumulators and blendLinear
(ops/arith.py and the api) held to ref/ at 0 and to the JAX package: 0
everywhere except where JAX documents otherwise (integer divide: ±1 on
half-even ties, its f32 quotient of a double-float; f32 divide: XLA:CPU's
reciprocal-based f32 division; accumulateSquare, accumulateProduct and
accumulateWeighted where the product is not exact in f32, and f32
blendLinear: 1 f32 ulp, XLA:CPU contracts products into FMAs, ROADMAP R4).  Inputs come from numpy
seeds: three 64×131 planes per dtype with the dtype's extremes and zero
divisors planted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.ref import ops as ref_ops

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]
SHAPE = (3, 64, 131)


def _pair(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        a = (rng.random(SHAPE) * 500 - 100).astype(np.float32)
        b = (rng.random(SHAPE) * 500 - 100).astype(np.float32)
        a[0, 0, :3] = [0, 1e30, -1e-30]
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max + 1, SHAPE).astype(dtype)
        b = rng.integers(info.min, info.max + 1, SHAPE).astype(dtype)
        a[0, 0, :2] = [info.min, info.max]
        b[0, 1, :2] = [info.max, info.max]
        a[0, 1, :2] = [info.max, info.min]
    b[0, 0, :5] = 0  # zero divisors
    return a, b


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest difference in units of the f32 spacing at ``want`` (NaN and
    infinities must sit at the same places)."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    d = np.abs(got[fin].astype(np.float64) - want[fin]) / np.spacing(np.abs(want[fin]))
    return float(d.max()) if d.size else 0.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("op", ["add", "subtract", "absdiff", "minimum", "maximum"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_saturating_ops_match_ref_and_jax(dtype, op):
    a, b = _pair(dtype, 10 + DTYPES.index(dtype))
    got = getattr(tie, op)(_t(a), _t(b))
    assert got.dtype == _t(a).dtype
    got = got.numpy()
    np.testing.assert_array_equal(got, getattr(ref_ops, op)(a, b))
    np.testing.assert_array_equal(got, np.asarray(getattr(ie, op)(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("scale", [1.0, 0.37, 3.5, 1 / 255])
@pytest.mark.parametrize("op", ["multiply", "divide"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scaled_ops_match_ref_and_jax(dtype, op, scale):
    """The f64 product or quotient and saturate_cast: 0 against ref/.  JAX
    reaches the same product through double-floats (0), its integer
    quotient is f32 (±1 on ties) and its f32 division reciprocal-based."""
    a, b = _pair(dtype, 20 + DTYPES.index(dtype))
    got = getattr(tie, op)(_t(a), _t(b), scale).numpy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        want = getattr(ref_ops, op)(a, b, scale)
    np.testing.assert_array_equal(got, want)
    jx = np.asarray(getattr(ie, op)(jnp.asarray(a), jnp.asarray(b), scale))
    if dtype == np.float32 and op == "divide":
        assert _ulps(got, jx) <= 2
    elif op == "divide":
        assert np.abs(got.astype(np.int64) - jx).max() <= 1
    else:
        np.testing.assert_array_equal(got, jx)


@pytest.mark.parametrize("dtype,a,b,scale,want", [
    (np.uint16, 60000, 60000, 1.0, 0),          # 3.6e9 past int32: INT_MIN, then 0
    (np.uint16, 40000, 50000, 0.5, 65535),      # 1e9 fits int32: saturates to max
    (np.int16, 32767, 32767, 4.0, -32768),      # 4.3e9: INT_MIN, clamped to the min
    (np.int16, -32768, 32767, 2.0, -32768),     # −2.1e9 fits: the min anyway
    (np.uint8, 200, 250, 1e6, 0),               # 5e10: INT_MIN, then 0
    (np.uint8, 3, 5, 0.1, 2),                   # 1.5 ties to 2 (half to even)
    (np.uint8, 5, 5, 0.1, 2),                   # 2.5 ties to 2
])
def test_multiply_int_min_rule(dtype, a, b, scale, want):
    x, y = np.full((2, 3), a, dtype), np.full((2, 3), b, dtype)
    got = tie.multiply(_t(x), _t(y), scale).numpy()
    np.testing.assert_array_equal(got, ref_ops.multiply(x, y, scale))
    assert (got == want).all()


@pytest.mark.parametrize("op", ["eq", "gt", "ge", "lt", "le", "ne"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_compare_matches_ref_and_jax(dtype, op):
    a, b = _pair(dtype, 30 + DTYPES.index(dtype))
    b[1] = a[1]  # ties
    got = tie.compare(_t(a), _t(b), op)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref_ops.compare(a, b, op))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ie.compare(jnp.asarray(a),
                                                                     jnp.asarray(b), op)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_bitwise_match_ref_and_jax(dtype):
    a, b = _pair(dtype, 40 + DTYPES.index(dtype))
    for op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        got = getattr(tie, op)(_t(a), _t(b)).numpy()
        np.testing.assert_array_equal(got, getattr(ref_ops, op)(a, b), err_msg=op)
        np.testing.assert_array_equal(got, np.asarray(getattr(ie, op)(jnp.asarray(a),
                                                                      jnp.asarray(b))))
    got = tie.bitwise_not(_t(a)).numpy()
    np.testing.assert_array_equal(got, ref_ops.bitwise_not(a))
    np.testing.assert_array_equal(got, np.asarray(ie.bitwise_not(jnp.asarray(a))))


def test_uint16_ops_widen_on_the_cpu():
    """torch on the CPU has no minimum, comparisons or bitwise_not for
    uint16 (torch 2.13); the port widens to int32 around them."""
    a = torch.tensor([1, 60000], dtype=torch.uint16)
    b = torch.tensor([60000, 1], dtype=torch.uint16)
    np.testing.assert_array_equal(tie.minimum(a, b).numpy(), [1, 1])
    np.testing.assert_array_equal(tie.maximum(a, b).numpy(), [60000, 60000])
    np.testing.assert_array_equal(tie.compare(a, b, "gt").numpy(), [0, 255])
    np.testing.assert_array_equal(tie.bitwise_not(a).numpy(), [65534, 5535])


def test_arith_rejects():
    a = torch.zeros((4, 5), dtype=torch.float32)
    with pytest.raises(TypeError):
        tie.bitwise_and(a, a)
    with pytest.raises(TypeError):
        tie.bitwise_not(a)
    with pytest.raises(ValueError):
        tie.compare(a, a, "gte")
    with pytest.raises(ValueError):
        tie.add(a, torch.zeros((4, 6), dtype=torch.float32))
    with pytest.raises(ValueError):
        tie.add(a, torch.zeros((4, 5), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tie.add(torch.zeros((4, 5), dtype=torch.int32), torch.zeros((4, 5), dtype=torch.int32))


def _acc_inputs(src_dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if src_dtype == np.float32:
        src = (rng.random(shape) * 300 - 50).astype(np.float32)
        src2 = (rng.random(shape) * 3).astype(np.float32)
    else:
        hi = np.iinfo(src_dtype).max + 1
        src = rng.integers(0, hi, shape).astype(src_dtype)
        src2 = rng.integers(0, hi, shape).astype(src_dtype)
    acc = (rng.random(shape) * 1000).astype(np.float32)
    mask = rng.integers(0, 2, shape[:2]).astype(np.uint8)
    return src, src2, acc, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(37, 41), (37, 41, 3)])
@pytest.mark.parametrize("src_dtype", [np.uint8, np.uint16, np.float32])
def test_accumulators_match_ref_and_jax(src_dtype, shape, masked):
    src, src2, acc, mask = _acc_inputs(src_dtype, shape, 50 + len(shape))
    m = mask if masked else None
    tm = _t(mask) if masked else None
    cases = [("accumulate", (src,), ()), ("accumulate_square", (src,), ()),
             ("accumulate_product", (src, src2), ())]
    cases += [("accumulate_weighted", (src,), (al,)) for al in (0.5, 0.1, 0.013, 0.9)]
    for name, srcs, extra in cases:
        got = getattr(tie, name)(*map(_t, srcs), _t(acc), *extra, tm)
        assert got.dtype == torch.float32
        got = got.numpy()
        np.testing.assert_array_equal(got, getattr(ref_ops, name)(*srcs, acc, *extra, m),
                                      err_msg=f"{name} {extra}")
        jx = np.asarray(getattr(ie, name)(*map(jnp.asarray, srcs), jnp.asarray(acc), *extra,
                                          None if m is None else jnp.asarray(m)))
        if name != "accumulate":
            # XLA:CPU contracts acc + product into an FMA (ROADMAP R4): one
            # rounding of the largest term apart where a product is not
            # exact in f32 (u16², f32)
            terms = [np.abs(acc)] + [np.abs(srcs[0].astype(np.float32)
                                            * srcs[-1].astype(np.float32))]
            big = np.maximum(*terms) if name != "accumulate_weighted" else np.maximum(
                terms[0], np.abs(srcs[0].astype(np.float32)))
            big = np.maximum(big, np.abs(jx))
            assert (np.abs(got.astype(np.float64) - jx) <= np.spacing(big)).all(), (name, extra)
        else:
            np.testing.assert_array_equal(got, jx, err_msg=name)
        if masked:
            keep = (mask == 0) if len(shape) == 2 else (mask == 0)[..., None].repeat(3, -1)
            np.testing.assert_array_equal(got[keep], acc[keep])


def test_accumulate_rejects_non_f32_accumulator():
    with pytest.raises(TypeError):
        tie.accumulate(torch.zeros(3, 4, dtype=torch.uint8), torch.zeros(3, 4, dtype=torch.float64))


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_blend_linear_matches_ref_and_jax(dtype, channels):
    rng = np.random.default_rng(60 + channels)
    shape = (53, 67) + ((channels,) if channels else ())
    if dtype == np.uint8:
        s1, s2 = (rng.integers(0, 256, shape).astype(np.uint8) for _ in range(2))
    else:
        s1, s2 = ((rng.random(shape) * 255).astype(np.float32) for _ in range(2))
    w1 = rng.random(shape[:2]).astype(np.float32)
    w2 = rng.random(shape[:2]).astype(np.float32)
    w1[0, :4] = 0
    w2[0, :2] = 0  # den = 1e-5 where both are 0
    got = tie.blend_linear(_t(s1), _t(s2), w1, w2)
    assert got.dtype == _t(s1).dtype
    got = got.numpy()
    np.testing.assert_array_equal(got, ref_ops.blend_linear(s1, s2, w1, w2))
    np.testing.assert_array_equal(got, tie.blend_linear(_t(s1), _t(s2), _t(w1), _t(w2)).numpy())
    jx = np.asarray(ie.blend_linear(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(w1),
                                    jnp.asarray(w2)))
    if dtype == np.float32:
        assert _ulps(got, jx) <= 1
    else:
        np.testing.assert_array_equal(got, jx)


def test_blend_linear_rejects():
    a = torch.zeros((5, 6), dtype=torch.uint8)
    w = np.ones((5, 6), np.float32)
    with pytest.raises(ValueError):
        tie.blend_linear(a, torch.zeros((5, 7), dtype=torch.uint8), w, w)
    with pytest.raises(TypeError):
        tie.blend_linear(a.to(torch.uint16), a.to(torch.uint16), w, w)
    with pytest.raises(ValueError):
        tie.blend_linear(a, a, np.ones((5, 5), np.float32), w)
