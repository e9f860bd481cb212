"""The port's histogram-family plain versions (kernels/hist.py, ops/histogram.py)
held to the JAX package — its Pallas kernels in interpret mode and its XLA
LUT build — and to ref/, at 0 LSB: every step is integer or a pinned f32 law."""

import functools

import jax
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.kernels.hist import (
    apply_lut256_pallas,
    equalize_hist_pallas,
    hist256_pallas,
)
from imageenhancement_mp_tpu.ops.histogram import equalize_lut as jax_equalize_lut
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.ops import histogram as thist
from imageenhancement_mp_tpu_torch.ops.pointwise import apply_lut_planes

SHAPES = [(2, 64, 256), (1, 37, 131)]


def _planes(shape, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", SHAPES + [(3, 1000)])
def test_hist256_matches_pallas_and_bincount(shape):
    x = _planes(shape, 11)
    got = khist.hist256(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (shape[0], 256)
    want = np.stack([np.bincount(p.ravel(), minlength=256) for p in x])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(hist256_pallas(x, interpret=True)))
    np.testing.assert_array_equal(thist.histogram_256(torch.from_numpy(x)).numpy(), want)


def _lut_cases():
    rng = np.random.default_rng(12)
    # a plane of 37x131 px; with these 64 rows a scale taken as
    # reciprocal-then-multiply instead of one IEEE division is off by 1
    total = 37 * 131
    rand = rng.multinomial(total, rng.dirichlet(np.full(256, 0.3)), size=64)
    low_empty = np.bincount(_planes((37, 131), 13, 100, 201).ravel(), minlength=256)[None]
    constant = np.zeros((1, 256), np.int64)
    constant[0, 77] = total
    top_only = np.zeros((1, 256), np.int64)
    top_only[0, 254], top_only[0, 255] = total - 1, 1
    return {"random": rand, "low_empty": low_empty, "constant": constant, "top_only": top_only}, total


@pytest.mark.parametrize("case", ["random", "low_empty", "constant", "top_only"])
def test_equalize_lut_matches_jax(case):
    cases, total = _lut_cases()
    hists = cases[case].astype(np.int32)
    got = khist.equalize_lut256(torch.from_numpy(hists), total)
    want = np.asarray(jax.vmap(functools.partial(jax_equalize_lut, total=total))(hists))
    np.testing.assert_array_equal(got.numpy(), want)
    # the ops-level entry takes one [256] histogram too
    np.testing.assert_array_equal(
        thist.equalize_lut(torch.from_numpy(hists[0]), total).numpy(), want[0])
    if case == "constant":
        np.testing.assert_array_equal(got.numpy()[0], np.arange(256))


@pytest.mark.parametrize("shape", SHAPES)
def test_equalize_hist_planes_matches_pallas_and_ref(shape):
    x = _planes(shape, 14)
    x[0, :3] = 255  # a few saturated rows keep the top bins busy
    got = thist.equalize_hist_planes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(equalize_hist_pallas(x, interpret=True)))
    np.testing.assert_array_equal(got, np.stack([ref.equalize_hist(p) for p in x]))


def test_equalize_hist_planes_constant_plane():
    x = np.full((2, 37, 131), 9, np.uint8)
    got = thist.equalize_hist_planes(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.stack([ref.equalize_hist(p) for p in x]))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_lut256_matches_pallas(shape, shared):
    x = _planes(shape, 15)
    lut_shape = (256,) if shared else (shape[0], 256)
    lut = _planes(lut_shape, 16)
    got = khist.apply_lut256(torch.from_numpy(x), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, np.asarray(apply_lut256_pallas(x, lut, interpret=True)))
    np.testing.assert_array_equal(
        apply_lut_planes(torch.from_numpy(x), torch.from_numpy(lut)).numpy(), got)


def test_hist_family_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        khist.hist256(x.to(torch.int16))
    with pytest.raises(TypeError):
        thist.histogram_256(x.to(torch.int16))
    with pytest.raises(TypeError):
        thist.equalize_hist_planes(x.to(torch.float32))
    with pytest.raises(TypeError):
        khist.equalize_lut256(torch.zeros((1, 256), dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        khist.equalize_lut256(torch.zeros((1, 256), dtype=torch.int32), 2**31)
    with pytest.raises(TypeError):
        khist.apply_lut256(x, torch.zeros(256, dtype=torch.int64))
    with pytest.raises(ValueError):
        khist.apply_lut256(x, torch.zeros((2, 256), dtype=torch.uint8))
    with pytest.raises(ValueError):
        apply_lut_planes(x.to(torch.uint16), torch.zeros(256, dtype=torch.uint16))
    with pytest.raises(ValueError):
        khist.hist256(x.to("meta"))


# -- pooled equalizeHist in one count launch: hist256_lut with groups ----------

@pytest.mark.parametrize("frames,channels,kind", [(4, 1, "random"), (4, 3, "narrow"),
                                                   (1, 3, "random"), (3, 2, "constant")])
def test_grouped_luts_match_jax_pooled_equalize(frames, channels, kind):
    """hist256_equalize_lut(planes, C) (its plain version here) applied to
    the ``as_planes`` stack equals the JAX package's
    equalize_hist_global_planes at 0 LSB; C = 1 pools every plane, C = B
    is today's per-frame hist256_equalize_lut, and the pooled op takes the
    grouped route."""
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes as jax_pooled

    B = frames * channels
    lo, hi = {"random": (0, 256), "narrow": (100, 105), "constant": (77, 78)}[kind]
    x = _planes((B, 23, 41), frames * 10 + channels, lo, hi)
    t = torch.from_numpy(x)
    luts = khist.hist256_equalize_lut(t, channels)
    assert luts.shape == (channels, 256) and luts.dtype == torch.uint8
    got = khist.apply_lut256(t, luts.repeat(frames, 1)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_pooled(x, channels=channels)))
    np.testing.assert_array_equal(thist.equalize_hist_global_planes(t, channels).numpy(), got)
    pooled = khist.hist256_equalize_lut(t, 1)
    np.testing.assert_array_equal(khist.apply_lut256(t, pooled[0]).numpy(),
                                  np.asarray(jax_pooled(x, channels=1)))
    np.testing.assert_array_equal(khist.hist256_equalize_lut(t, B).numpy(),
                                  khist.hist256_equalize_lut(t).numpy())
    per_frame = khist.equalize_lut256_plain(khist.hist256_plain(t), 23 * 41)
    np.testing.assert_array_equal(khist.hist256_equalize_lut(t, B).numpy(), per_frame.numpy())


def test_grouped_count_dispatch(monkeypatch):
    """With on_cuda and launch stubbed: the grouped LUT is one hist256_lut
    launch carrying the group count, into [C, 256]; the scratch holds a row
    for every block of every plane of a group; the pooled op launches
    hist256_lut (groups = channels) then apply_lut256, and per frame the
    group count is B."""
    launches = []
    monkeypatch.setattr(khist, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(khist, "launch", lambda *args: launches.append(args))
    x = torch.zeros((24, 60, 70), dtype=torch.uint8)
    out = khist.hist256_equalize_lut(x, 3)
    assert out.shape == (3, 256) and out.dtype == torch.uint8
    name, _, xp, op, B, n, groups, blocks, grid_y, partial, tickets = launches[-1]
    assert (name, xp, op, B, n, groups) == ("hist256_lut", x.data_ptr(), out.data_ptr(), 24,
                                            4200, 3)
    assert (blocks, grid_y) == khist.hist256_plan(24, 4200) and partial and tickets
    khist.hist256_equalize_lut(x)
    assert launches[-1][6] == 24
    launches.clear()
    thist.equalize_hist_global_planes(x, 3)
    assert [a[0] for a in launches] == ["hist256_lut", "apply_lut256"] and launches[0][6] == 3
    launches.clear()
    thist.equalize_hist_global_planes(x)  # one group: every plane pooled
    assert [a[0] for a in launches] == ["hist256_lut", "apply_lut256"] and launches[0][6] == 1
    with pytest.raises(ValueError, match="groups"):
        khist.hist256_equalize_lut(x, 5)
