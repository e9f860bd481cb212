"""The port's device statistics (ops/stats.py: psnr, norm, mean_std_dev,
min_max_loc, moments_device) held to the f64 oracle ref/ and to the JAX
package: every scalar within one f32 ulp of ref/'s f64 value rounded to f32,
and within the 1e-6 relative JAX's docstrings state of JAX's scalars (its
double-float sums, one f32 rounding); the integer sums under them (the
squared-error sum, Σx and Σx², the raw moments of u8 planes at these sizes)
equal ref/'s exact sums.  Also the host copy of compare_hist (pinned to
ref/), torch's first-index ties under min_max_loc, and the PSNR of the main
path's output."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.pipeline import equalize_unsharp as jax_equalize_unsharp
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.ops import stats
from imageenhancement_mp_tpu_torch.utils import tracking

DTYPES = [np.uint8, np.uint16, np.int16, np.float32]


def _img(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.random(shape) * 2 - 0.5).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _close_to_ref(got: torch.Tensor, want: float, what=""):
    """Within one f32 ulp of the f64 value rounded to f32."""
    assert got.dim() == 0 and got.dtype == torch.float32, what
    g, w = float(got), np.float32(want)
    if np.isinf(w):
        assert g == w, what
        return
    assert abs(g - float(w)) <= float(np.spacing(np.abs(w))), (what, g, float(w))


def _close_to_jax(got: torch.Tensor, jx, rel=1e-6, what=""):
    g, j = float(got), float(np.asarray(jx))
    if np.isinf(j):
        assert g == j, what
        return
    assert abs(g - j) <= rel * max(abs(j), 1e-30), (what, g, j)


@pytest.mark.parametrize("dtype", DTYPES)
def test_psnr_matches_ref_and_jax(dtype):
    a = _img(dtype, (2, 37, 131), 1)
    b = _img(dtype, (2, 37, 131), 2)
    b[0, :3] = a[0, :3]
    for mv in (255.0, 65535.0, 1.0):
        got = tie.psnr(torch.from_numpy(a), torch.from_numpy(b), mv)
        _close_to_ref(got, ref.psnr(a, b, mv), (dtype, mv))
        _close_to_jax(got, ie.psnr(jnp.asarray(a), jnp.asarray(b), mv), what=(dtype, mv))
    same = tie.psnr(torch.from_numpy(a), torch.from_numpy(a))
    assert float(same) == float("inf") and ref.psnr(a, a) == float("inf")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16])
def test_integer_sums_equal_ref_exact_sums(dtype):
    """Σ|d|, Σd, Σd² in int64 equal ref/'s f64 sums, exact at this size."""
    a = _img(dtype, (3, 64, 131), 3)
    b = _img(dtype, (3, 64, 131), 4)
    s1, s, s2 = (int(v) for v in stats.int_sums(torch.from_numpy(a), torch.from_numpy(b)))
    d = a.astype(np.float64) - b.astype(np.float64)
    assert (s1, s, s2) == (np.abs(d).sum(), d.sum(), (d * d).sum())
    _, sx, sxx = (int(v) for v in stats.int_sums(torch.from_numpy(a)))
    x = a.astype(np.float64)
    assert (sx, sxx) == (x.sum(), (x * x).sum())


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_matches_ref_and_jax(dtype):
    a = _img(dtype, (2, 37, 131), 5)
    b = _img(dtype, (2, 37, 131), 6)
    for nt in ("l1", "l2", "inf"):
        got = tie.norm(torch.from_numpy(a), nt)
        _close_to_ref(got, ref.norm(a, nt), (dtype, nt))
        _close_to_jax(got, ie.norm(jnp.asarray(a), nt), what=(dtype, nt))
        got = tie.norm(torch.from_numpy(a), nt, torch.from_numpy(b))
        _close_to_ref(got, ref.norm(a, nt, b), (dtype, nt, "diff"))
        _close_to_jax(got, ie.norm(jnp.asarray(a), nt, jnp.asarray(b)), what=(dtype, nt))
    with pytest.raises(ValueError):
        tie.norm(torch.from_numpy(a), "l3")


@pytest.mark.parametrize("shape", [(64, 131), (2, 37, 131), (1, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mean_std_dev_matches_ref_and_jax(dtype, shape):
    a = _img(dtype, shape, 7)
    m, s = tie.mean_std_dev(torch.from_numpy(a))
    wm, ws = ref.mean_std_dev(a)
    _close_to_ref(m, wm, (dtype, "mean"))
    _close_to_ref(s, ws, (dtype, "std"))
    jm, js = ie.mean_std_dev(jnp.asarray(a))
    _close_to_jax(m, jm, what="mean")
    _close_to_jax(s, js, rel=2e-6, what="std")


def test_mean_std_dev_constant_and_near_constant():
    """The variance's integer part is exact: 0 on a constant plane, and the
    cancellation of a large mean leaves the right small spread."""
    c = np.full((50, 70), 65535, np.uint16)
    m, s = tie.mean_std_dev(torch.from_numpy(c))
    assert float(m) == 65535.0 and float(s) == 0.0
    c[0, 0] = 65534
    m, s = tie.mean_std_dev(torch.from_numpy(c))
    _close_to_ref(m, ref.mean_std_dev(c)[0])
    _close_to_ref(s, ref.mean_std_dev(c)[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_min_max_loc_matches_ref_and_jax(dtype):
    a = _img(dtype, (37, 131), 8)
    mn, mx, (ix, iy), (ax, ay) = tie.min_max_loc(torch.from_numpy(a))
    assert mn.dtype == mx.dtype == torch.float32 and ix.dtype == ay.dtype == torch.int32
    want = ref_ops.min_max_loc(a)
    assert (float(mn), float(mx), (int(ix), int(iy)), (int(ax), int(ay))) == (
        float(np.float32(want[0])), float(np.float32(want[1])), want[2], want[3])
    jmn, jmx, jmin, jmax = ie.min_max_loc(jnp.asarray(a))
    assert (int(ix), int(iy), int(ax), int(ay)) == tuple(int(v) for v in (*jmin, *jmax))


def test_min_max_loc_first_occurrence():
    """cv2 keeps the first minimum and maximum in row-major order; torch's
    argmin/argmax document the first index of a tie: pinned here."""
    a = np.zeros((20, 30), np.uint8) + 7
    for y, x in ((3, 17), (3, 2), (11, 0), (19, 29)):
        a[y, x] = 200
    for y, x in ((5, 9), (4, 28), (18, 1)):
        a[y, x] = 1
    _, _, mloc, xloc = tie.min_max_loc(torch.from_numpy(a))
    assert (int(mloc[0]), int(mloc[1])) == (28, 4)
    assert (int(xloc[0]), int(xloc[1])) == (2, 3)
    assert (mloc[0].item(), mloc[1].item()) == ref_ops.min_max_loc(a)[2]
    flat = torch.tensor([3.0, 1.0, 1.0, 9.0, 9.0])
    assert int(torch.argmin(flat)) == 1 and int(torch.argmax(flat)) == 3


def _moment_cases():
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:61, 0:87]
    blob = np.clip(255 * np.exp(-((xx - 50) ** 2 + (yy - 20) ** 2) / 200.0), 0, 255)
    return [("u8 random", rng.integers(0, 256, (61, 87), dtype=np.uint8), False),
            ("u8 blob", blob.astype(np.uint8), False),
            ("u8 blob binary", blob.astype(np.uint8), True),
            ("u16", rng.integers(0, 65536, (61, 87)).astype(np.uint16), False),
            ("i16", rng.integers(-32768, 32768, (61, 87)).astype(np.int16), False),
            ("f32", rng.random((61, 87)).astype(np.float32), False),
            ("zeros", np.zeros((61, 87), np.uint8), False)]


# JAX compiles moments per dtype: it is compared on these cases only
JAX_MOMENT_CASES = (0, 1, 2, 5)


@pytest.mark.parametrize("case", range(7))
def test_moments_device_matches_ref_and_jax(case):
    label, img, binary = _moment_cases()[case]
    got = tie.moments_device(torch.from_numpy(img), binary)
    want = ref_ops.moments(img, binary)
    assert list(got) == list(stats.MOMENT_KEYS) and len(got) == 24
    for k in stats.MOMENT_KEYS:
        _close_to_ref(got[k], want[k], (label, k))
    if img.dtype == np.uint8:
        raw = stats.raw_moments(torch.from_numpy(img), binary)
        for k, v in raw.items():
            assert float(v) == want[k], (label, k)
    if case not in JAX_MOMENT_CASES:
        return
    jx = ie.moments_device(jnp.asarray(img), binary)
    inv = 1.0 / want["m00"] if want["m00"] else 0.0
    for k in stats.MOMENT_KEYS:
        j = float(np.asarray(jx[k]))
        # JAX's double-float completion: 2e-6 of the value, and the f64
        # cancellation of a central moment (≈ 1e-16 of its raw moment,
        # normalised like it) where the exact value is near 0
        raw = abs(want["m" + k[2:]]) if k[0] != "m" or k[1] == "u" else 0.0
        order = int(k[-2]) + int(k[-1])
        norm = abs(inv) ** (1 + order / 2) if k[:2] == "nu" else 1.0
        slack = 1e-12 * raw * norm
        assert abs(float(got[k]) - j) <= 2e-6 * max(abs(j), abs(want[k])) + slack, (label, k)


def test_moments_int_path_bound():
    """4K u8 planes take the exact int64 route; 4K u16 the f64 one."""
    assert stats._int_rows_fit(torch.uint8, 3840, 2160)
    assert not stats._int_rows_fit(torch.uint16, 3840, 2160)


@pytest.mark.parametrize("method", ["correl", "chisqr", "intersect", "bhattacharyya"])
def test_compare_hist_copy_pinned(method):
    rng = np.random.default_rng(10)
    for _ in range(6):
        h1 = rng.random(32) * rng.integers(0, 2, 32)
        h2 = rng.random(32)
        assert tracking.compare_hist(h1, h2, method) == ref_ops.compare_hist(h1, h2, method)
        got = tie.compare_hist(torch.from_numpy(h1), torch.from_numpy(h2), method)
        assert got == ie.compare_hist(h1, h2, method)
    z = np.zeros(8)
    assert tracking.compare_hist(z, z, method) == ref_ops.compare_hist(z, z, method)
    with pytest.raises(ValueError):
        tie.compare_hist(np.ones(4), np.ones(5), method)


def test_psnr_of_the_main_path():
    """The chain a user scores: psnr(frames, equalize_unsharp(frames))."""
    rng = np.random.default_rng(11)
    x = rng.integers(40, 200, (2, 48, 131), dtype=np.uint8)
    out = tie.equalize_unsharp(torch.from_numpy(x))
    want_out = np.stack([ref.unsharp_mask(ref.equalize_hist(p)) for p in x])
    np.testing.assert_array_equal(out.numpy(), want_out)
    got = tie.psnr(torch.from_numpy(x), out)
    _close_to_ref(got, ref.psnr(x, want_out))
    _close_to_jax(got, ie.psnr(jnp.asarray(x), jax_equalize_unsharp(jnp.asarray(x))))
    m, s = tie.mean_std_dev(out)
    _close_to_ref(m, ref.mean_std_dev(want_out)[0])
    _close_to_ref(s, ref.mean_std_dev(want_out)[1])
