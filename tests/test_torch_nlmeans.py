"""The port's non-local means (ops/nlmeans.py, utils/nlm_tables.py and the
api's four ``fast_nl_means_denoising*`` functions) held to the JAX package,
with its K12 weight lookups in interpret mode (``config.use_pallas_kernels
= True``), and to ref/: 0 LSB everywhere, both norms, cn ∈ {1, 2, 3, 4},
temporal windows of 1 and 3 frames, u16 with NORM_L1, frames smaller than
the pad, and integral images that wrap int32.  Small sizes (s ≤ 7, t ≤ 5,
planes ≤ 48×48 apart from the one wrap case): the JAX side runs K12 in
interpret mode inside a loop of T·s² steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.ops import nlmeans as jnlm
from imageenhancement_mp_tpu.pipeline import make_pipeline as jax_make_pipeline
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import take as kt
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY
from imageenhancement_mp_tpu_torch.ops import nlmeans as tnlm
from imageenhancement_mp_tpu_torch.utils.nlm_tables import nlm_weight_lut


def _noisy(shape, seed, sigma=12.0):
    """A smooth pattern plus Gaussian noise, u8: the kind of image NLMeans is
    for, where many candidates weigh above the cutoff.  A last axis of at
    most 4 (on 3-D and larger shapes) holds the channels."""
    rng = np.random.default_rng(seed)
    vec = len(shape) >= 3 and shape[-1] <= 4
    H, W = shape[-3:-1] if vec else shape[-2:]
    yy, xx = np.mgrid[0:H, 0:W]
    base = 128 + 60 * np.sin(yy / 4.0) + 50 * np.cos(xx / 5.0)
    if vec:
        base = base[..., None]
    return np.clip(base + rng.normal(0, sigma, shape), 0, 255).astype(np.uint8)


@pytest.fixture
def pallas_on():
    config.use_pallas_kernels = True
    try:
        yield
    finally:
        config.use_pallas_kernels = None


# -- the weight LUT -----------------------------------------------------------------

LUT_CASES = [(h, t, s, cn, T, norm, 255) for h, t, s in ((3.0, 3, 5), (25.0, 5, 9))
             for cn in (1, 2, 3, 4) for T in (1, 3) for norm in ("l1", "l2")]
LUT_CASES += [(10.0, 7, 21, cn, 1, norm, 255) for cn in (1, 3) for norm in ("l1", "l2")]
LUT_CASES += [(h, t, s, cn, 1, "l1", 65535) for h, t, s in ((3000.0, 3, 5), (600.0, 7, 21))
              for cn in (1, 3)]


@pytest.mark.parametrize("h,t,s,cn,T,norm,maxval", LUT_CASES)
def test_lut_copy_equals_ref(h, t, s, cn, T, norm, maxval):
    w, bs, amd = nlm_weight_lut(h, t, s, cn, temporal=T, norm=norm, maxval=maxval)
    rw, rbs, ramd = ref_ops._nlm_weight_lut(h, t, s, cn, temporal=T, norm=norm, maxval=maxval)
    assert (bs, amd) == (rbs, ramd) and w.dtype == rw.dtype
    np.testing.assert_array_equal(w, rw)


@pytest.mark.parametrize("maxval", [255, 65535])
def test_interop_nlm_lut_from_jax(maxval):
    """The LUT the JAX package's ops/nlmeans.py builds (int32 for u8, int64
    for u16) through interop equals the port's, bit for bit."""
    h, norm = (10.0, "l2") if maxval == 255 else (3000.0, "l1")
    w, bs, _ = ref_ops._nlm_weight_lut(h, 5, 9, 2, norm=norm, maxval=maxval)
    jax_lut = w.astype(np.int32 if maxval == 255 else np.int64)
    lut, got_bs, cut = interop.nlm_lut_from_jax(jax_lut, h, 5, 9, 2, 1, norm, maxval)
    mine = tnlm._lut(h, 5, 9, 2, 1, norm, maxval, torch.device("cpu"))
    assert (got_bs, cut) == mine[1:] == (bs, len(w) - 1)
    assert lut.dtype == mine[0].dtype and torch.equal(lut, mine[0])
    with pytest.raises(ValueError):
        interop.nlm_lut_from_jax(jax_lut[:-1], h, 5, 9, 2, 1, norm, maxval)
    with pytest.raises(ValueError):
        interop.nlm_lut_from_jax(w.astype(np.float64), h, 5, 9, 2, 1, norm, maxval)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 30])
@pytest.mark.parametrize("pad", [0, 1, 4, 13, 40])
def test_reflect_indices_match_numpy(n, pad):
    """NumPy's ``reflect`` pad (REFLECT_101, reflected again where the pad
    exceeds the axis), which F.pad refuses beyond the axis length."""
    want = np.pad(np.arange(n), pad, mode="reflect")
    np.testing.assert_array_equal(tnlm.reflect_indices(n, pad, "cpu").numpy(), want)


# -- the ops against JAX ------------------------------------------------------------

@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("cn", [1, 2, 3, 4])
def test_vec_matches_jax(pallas_on, cn, norm):
    x = _noisy((2, 23, 29, cn), 10 + cn)
    h, t, s = 6.0 + 3 * cn, 3, 7
    want = np.asarray(jnlm.fast_nl_means_vec(jnp.asarray(x), h, t, s, norm))
    got = tnlm.fast_nl_means_vec(torch.from_numpy(x), h, t, s, norm)
    assert got.dtype == torch.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("T,cn", [(1, 1), (3, 1), (3, 2), (3, 3)])
def test_multi_vec_matches_jax(pallas_on, T, cn, norm):
    x = _noisy((T, 2, 17, 21, cn), 20 + T + cn)
    want = np.asarray(jnlm.fast_nl_means_multi_vec(jnp.asarray(x), 8.0, 5, 5, norm))
    got = tnlm.fast_nl_means_multi_vec(torch.from_numpy(x), 8.0, 5, 5, norm)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cn", [1, 3])
def test_u16_l1_matches_jax_and_ref(pallas_on, cn):
    """u16 NORM_L1: the int64 LUT and int64 accumulators."""
    rng = np.random.default_rng(30 + cn)
    x = np.clip(_noisy((19, 22, cn), 30).astype(np.int64) * 257
                + rng.integers(-900, 900, (19, 22, cn)), 0, 65535).astype(np.uint16)
    want = np.asarray(jie.fast_nl_means_denoising(x, 2500.0, 3, 5, norm_type="l1"))
    got = tie.fast_nl_means_denoising(torch.from_numpy(x), 2500.0, 3, 5, norm_type="l1")
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.fast_nl_means_denoising(x, 2500.0, 3, 5,
                                                                             norm_type="l1"))


@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (2, 9), (6, 5)])
def test_frames_smaller_than_the_pad(pallas_on, shape):
    """A pad of s//2 + t//2 = 5 and more than the frame: reflected again."""
    x = _noisy(shape, 40)
    want = np.asarray(jie.fast_nl_means_denoising(x, 12.0, 3, 7))
    got = tie.fast_nl_means_denoising(torch.from_numpy(x), 12.0, 3, 7).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref.fast_nl_means_denoising(x, 12.0, 3, 7))


def test_wrapping_integral_images_stay_exact(pallas_on):
    """cn = 4 at 0/255 extremes on 150×150: the int32 cumulative sums of a
    candidate's differences pass 2^31 and wrap; the windowed differences
    are still the exact sums."""
    rng = np.random.default_rng(50)
    x = (rng.integers(0, 2, (150, 150, 4)) * 255).astype(np.uint8)
    assert ((x[:, 1:].astype(np.int64) - x[:, :-1]) ** 2).sum() > 2**31
    got = tie.fast_nl_means_denoising(torch.from_numpy(x), 300.0, 3, 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jie.fast_nl_means_denoising(x, 300.0, 3, 3)))
    np.testing.assert_array_equal(got, ref.fast_nl_means_denoising(x, 300.0, 3, 3))


# -- the api against JAX and ref/ -----------------------------------------------------

@pytest.mark.parametrize("shape", [(21, 26), (21, 26, 3), (3, 21, 26), (2, 21, 26, 2)])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_api_denoising_matches_jax(pallas_on, shape, norm):
    x = _noisy(shape, 60)
    got = tie.fast_nl_means_denoising(torch.from_numpy(x), 9.0, 3, 5, norm_type=norm).numpy()
    np.testing.assert_array_equal(got, np.asarray(jie.fast_nl_means_denoising(x, 9.0, 3, 5,
                                                                               norm_type=norm)))
    if len(shape) == 2 or shape[-1] <= 4 and len(shape) == 3:
        np.testing.assert_array_equal(got, ref.fast_nl_means_denoising(x, 9.0, 3, 5,
                                                                       norm_type=norm))


@pytest.mark.parametrize("shape,order", [((18, 23, 3), "rgb"), ((2, 18, 23, 3), "bgr")])
def test_api_colored_matches_jax_and_ref(pallas_on, shape, order):
    x = _noisy(shape, 70)
    got = tie.fast_nl_means_denoising_colored(torch.from_numpy(x), 5.0, 7.0, 3, 5, order).numpy()
    want = jie.fast_nl_means_denoising_colored(x, 5.0, 7.0, 3, 5, order)
    np.testing.assert_array_equal(got, np.asarray(want))
    one = x[-1] if x.ndim == 4 else x
    np.testing.assert_array_equal(got[-1] if x.ndim == 4 else got,
                                  ref.fast_nl_means_denoising_colored(one, 5.0, 7.0, 3, 5, order))


@pytest.mark.parametrize("shape", [(5, 17, 20), (5, 17, 20, 3)])
def test_api_multi_matches_jax_and_ref(pallas_on, shape):
    """Frame 2 of 5 with a window of 3; a list of frames as well as a stack."""
    x = _noisy(shape, 80)
    got = tie.fast_nl_means_denoising_multi(torch.from_numpy(x), 2, 3, 7.0, 3, 5).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jie.fast_nl_means_denoising_multi(x, 2, 3, 7.0, 3, 5)))
    np.testing.assert_array_equal(got, ref.fast_nl_means_denoising_multi(list(x), 2, 3, 7.0, 3, 5))
    as_list = tie.fast_nl_means_denoising_multi([torch.from_numpy(f) for f in x], 2, 3, 7.0, 3,
                                                5).numpy()
    np.testing.assert_array_equal(as_list, got)


@pytest.mark.parametrize("frames", ["list", "stack"])
def test_api_multi_rejects_numpy_frames(frames):
    """NumPy frames raise TypeError, naming the tensor expected: the frames
    are never copied to the CPU behind the caller's back."""
    x = _noisy((3, 9, 11), 81)
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.fast_nl_means_denoising_multi(list(x) if frames == "list" else x, 1, 3)


def test_api_colored_multi_matches_jax_and_ref(pallas_on):
    x = _noisy((3, 16, 19, 3), 90)
    got = tie.fast_nl_means_denoising_colored_multi(torch.from_numpy(x), 1, 3, 4.0, 6.0, 3, 5,
                                                    "bgr").numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jie.fast_nl_means_denoising_colored_multi(x, 1, 3, 4.0, 6.0, 3, 5, "bgr")))
    np.testing.assert_array_equal(got, ref.fast_nl_means_denoising_colored_multi(
        list(x), 1, 3, 4.0, 6.0, 3, 5, "bgr"))


def test_api_rejects_what_jax_rejects():
    g = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising(g, 10.0, 4, 21)
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising(g, norm_type="l3")
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising(g.to(torch.uint16))  # u16 needs NORM_L1
    with pytest.raises(TypeError):
        tie.fast_nl_means_denoising(g.float())
    with pytest.raises(TypeError):
        tie.fast_nl_means_denoising_colored(torch.zeros((8, 9, 3), dtype=torch.uint16))
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising_colored(torch.zeros((8, 9, 4), dtype=torch.uint8))
    frames = torch.zeros((3, 8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising_multi(frames, 1, 2)
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising_multi(frames, 0, 3)
    with pytest.raises(TypeError):
        tie.fast_nl_means_denoising_multi(frames.to(torch.int16), 1, 3)
    with pytest.raises(ValueError):
        tie.fast_nl_means_denoising_colored_multi(frames, 1, 3)


# -- the registry, make_pipeline and K12's launches per call -----------------------

def test_registry_and_make_pipeline(pallas_on):
    assert OP_REGISTRY["fast_nl_means"] is tnlm.fast_nl_means_planes
    x = _noisy((2, 19, 24, 3), 100)
    stages = [("fast_nl_means", {"h": 9.0, "template_window": 3, "search_window": 5}),
              ("median_blur", {"ksize": 3})]
    got = tie.make_pipeline(stages)(torch.from_numpy(x))
    want = jax_make_pipeline(stages)(x)
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


TAKES = {  # call -> take_table launches: one per JAX _take1/_lut_take evaluation
    "denoising": (lambda x: tie.fast_nl_means_denoising(x[0, ..., 0], 10.0, 3, 5), 25),
    "denoising_cn3": (lambda x: tie.fast_nl_means_denoising(x[0], 10.0, 3, 5), 25),
    "colored": (lambda x: tie.fast_nl_means_denoising_colored(x[0], 3.0, 3.0, 3, 5), 3 + 50 + 6),
    "multi": (lambda x: tie.fast_nl_means_denoising_multi(x[..., 0], 1, 3, 3.0, 3, 5), 75),
    "colored_multi": (lambda x: tie.fast_nl_means_denoising_colored_multi(
        x, 1, 3, 3.0, 3.0, 3, 5), 3 + 150 + 6),  # the Lab legs convert the stack at once
    "u16": (lambda x: tie.fast_nl_means_denoising(x[0, ..., 0].to(torch.uint16), 3000.0, 3, 5,
                                                  norm_type="l1"), 25),
}


@pytest.mark.parametrize("name", list(TAKES))
def test_take_table_calls_per_call(monkeypatch, name):
    call, n = TAKES[name]
    calls = []
    monkeypatch.setattr(kt, "on_cuda", lambda t, what: calls.append(what) or False)
    call(torch.from_numpy(_noisy((3, 9, 11, 3), 110)))
    assert calls == ["take_table"] * n
