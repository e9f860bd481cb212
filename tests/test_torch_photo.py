"""OpenCV's photo module in the port (ops/photo.py, utils/photo_host.py):
the domain-transform filters, pencilSketch, TV-L1 and decolor against the
NumPy oracle ref/ and the JAX package on the CPU.

Tolerances: pencilSketch gray and colour at 0; edgePreservingFilter (both
flags), detailEnhance, stylization and denoise_TVL1 at ±1 (the count of
differing pixels printed); decolor at the JAX package's budgets (gray ±1,
the Lab boost ≤ 8), its solver's weights equal to ref's bit for bit.  The
JAX cases stay at 48×48 or smaller (its lax.scan chains compile per shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from detseed import seed
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref import ops as ref_ops
from imageenhancement_mp_tpu_torch.ops import photo
from imageenhancement_mp_tpu_torch.utils import photo_host


def _img(rng, h, w):
    """The JAX package's photo-test image: uniform noise over a normal field."""
    base = rng.integers(0, 256, (h, w, 3)).astype(np.float64)
    return np.clip(base * 0.6 + rng.normal(80, 40, (h, w, 3)), 0, 255).astype(np.uint8)


def _within(got, want, lsb, what):
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(want).astype(np.int64))
    print(f"{what}: max {int(d.max())}, {int((d > 0).sum())} of {d.size} values differ")
    assert int(d.max()) <= lsb, what


def test_seq_cumsum_is_numpys_chain():
    """The sequential f32 cumsum equals np.cumsum(dtype=f32) bit for bit on
    every axis, where torch's own cumsum (f64 accumulation on the CPU) does
    not."""
    rng = np.random.default_rng(seed("seq_cumsum"))
    x = (rng.random((3, 257, 5)) * 7 + 1).astype(np.float32)
    for axis in range(3):
        got = photo.seq_cumsum(torch.from_numpy(x), axis).numpy()
        np.testing.assert_array_equal(got, np.cumsum(x, axis, dtype=np.float32))
    assert not np.array_equal(torch.cumsum(torch.from_numpy(x), 1).numpy(),
                              np.cumsum(x, 1, dtype=np.float32))


@pytest.mark.parametrize("flags", ["recursive", "normconv"])
@pytest.mark.parametrize("case", range(3))
def test_edge_preserving_filter_matches_ref_and_jax(flags, case):
    rng = np.random.default_rng(seed("epf", flags, case))
    h, w = int(rng.integers(14, 49)), int(rng.integers(14, 49))
    img = _img(rng, h, w)
    ss, sr = float(rng.uniform(8, 160)), float(rng.uniform(0.05, 0.8))
    got = tie.edge_preserving_filter(torch.from_numpy(img), flags, ss, sr)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    _within(got, ref.edge_preserving_filter(img, flags, ss, sr), 1, f"{flags} vs ref")
    _within(got, jie.edge_preserving_filter(jnp.asarray(img), flags, ss, sr), 1,
            f"{flags} vs JAX")


def test_edge_preserving_filter_batch_is_per_frame():
    rng = np.random.default_rng(seed("epf", "batch"))
    img = _img(rng, 30, 34)
    two = np.stack([img, img[::-1].copy()])
    got = tie.edge_preserving_filter(torch.from_numpy(two), "recursive", 55.0, 0.35).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], tie.edge_preserving_filter(torch.from_numpy(two[i]), "recursive",
                                               55.0, 0.35).numpy())
        _within(got[i], ref.edge_preserving_filter(two[i], "recursive", 55.0, 0.35), 1,
                "batched recursive vs ref")


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_detail_enhance_matches_ref_and_jax(order):
    rng = np.random.default_rng(seed("detail", order))
    img = _img(rng, 33, 41)
    ss, sr = float(rng.uniform(5, 60)), float(rng.uniform(0.05, 0.4))
    got = tie.detail_enhance(torch.from_numpy(img), ss, sr, order)
    _within(got, ref.detail_enhance(img, ss, sr, order), 1, "detail_enhance vs ref")
    _within(got, jie.detail_enhance(jnp.asarray(img), ss, sr, order), 1, "detail_enhance vs JAX")


@pytest.mark.parametrize("case", range(2))
def test_stylization_matches_ref_and_jax(case):
    rng = np.random.default_rng(seed("styl", case))
    img = _img(rng, int(rng.integers(16, 49)), int(rng.integers(16, 49)))
    ss, sr = float(rng.uniform(20, 150)), float(rng.uniform(0.1, 0.6))
    got = tie.stylization(torch.from_numpy(img), ss, sr)
    _within(got, ref.stylization(img, ss, sr), 1, "stylization vs ref")
    _within(got, jie.stylization(jnp.asarray(img), ss, sr), 1, "stylization vs JAX")


@pytest.mark.parametrize("case", range(8))
def test_pencil_sketch_matches_ref_and_jax_exactly(case):
    """Gray and colour at 0, the half-white image (the position-0 coverage
    quirk) and random shade factors included."""
    rng = np.random.default_rng(seed("pencil", case))
    h, w = int(rng.integers(2, 48)), int(rng.integers(2, 48))
    if case % 4 == 0:
        img = np.zeros((h, w, 3), np.uint8)
        img[h // 2:, w // 2:] = 255
    else:
        img = _img(rng, h, w)
    if case % 3 == 0:
        ss, sr, sf = 60.0, 0.07, 0.02
    else:
        ss, sr, sf = (float(rng.uniform(1, 150)), float(rng.uniform(0.01, 0.9)),
                      float(rng.uniform(0.0, 0.25)))
    order = "bgr" if case % 2 else "rgb"
    g, c = tie.pencil_sketch(torch.from_numpy(img), ss, sr, sf, order)
    wg, wc = ref.pencil_sketch(img, ss, sr, sf, order=order)
    np.testing.assert_array_equal(g.numpy(), wg)
    np.testing.assert_array_equal(c.numpy(), wc)
    jg, jc = jie.pencil_sketch(jnp.asarray(img), ss, sr, sf, order)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_pencil_sketch_batch_is_per_frame():
    rng = np.random.default_rng(seed("pencil", "batch"))
    img = _img(rng, 41, 37)
    two = np.stack([img, img[::-1, ::-1].copy()])
    g, c = tie.pencil_sketch(torch.from_numpy(two))
    for i in range(2):
        wg, wc = ref.pencil_sketch(two[i])
        np.testing.assert_array_equal(g[i].numpy(), wg)
        np.testing.assert_array_equal(c[i].numpy(), wc)


def test_domain_transform_rejects_what_jax_rejects():
    z8 = torch.zeros((8, 8, 3), dtype=torch.uint8)
    for fn in (tie.edge_preserving_filter, tie.detail_enhance, tie.stylization,
               tie.pencil_sketch):
        with pytest.raises(TypeError):
            fn(z8.float())
        with pytest.raises(ValueError):
            fn(torch.zeros((8, 8), dtype=torch.uint8))
        with pytest.raises(TypeError, match="torch.Tensor"):
            fn(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        tie.edge_preserving_filter(z8, "bogus")
    with pytest.raises(ValueError):
        tie.pencil_sketch(z8, order="bogus")
    with pytest.raises(ValueError):
        tie.detail_enhance(z8, order="hsv")


@pytest.mark.parametrize("case", range(4))
def test_denoise_tvl1_matches_ref_and_jax(case):
    rng = np.random.default_rng(seed("tvl1", case))
    H, W = int(rng.integers(8, 49)), int(rng.integers(8, 49))
    K = 1 + case % 3
    obs = [np.clip(rng.normal(128, 40, (H, W)), 0, 255).astype(np.uint8) for _ in range(K)]
    lam, it = float(rng.uniform(0.3, 2.5)), int(rng.integers(2, 40))
    frames = [torch.from_numpy(o) for o in obs]
    got = tie.denoise_tvl1(frames if case % 2 else torch.stack(frames), lam, it)
    assert got.dtype == torch.uint8 and got.shape == (H, W)
    _within(got, ref.denoise_tvl1(obs, lam, it), 1, "denoise_tvl1 vs ref")
    _within(got, jie.denoise_tvl1(obs, lam, it), 1, "denoise_tvl1 vs JAX")


def test_denoise_tvl1_one_frame_and_rejects():
    rng = np.random.default_rng(seed("tvl1", "one"))
    o = np.clip(rng.normal(128, 40, (17, 23)), 0, 255).astype(np.uint8)
    got = tie.denoise_tvl1(torch.from_numpy(o), 1.0, 30)
    _within(got, ref.denoise_tvl1([o], 1.0, 30), 1, "one [H,W] observation vs ref")
    with pytest.raises(TypeError):
        tie.denoise_tvl1([torch.zeros((4, 4), dtype=torch.uint16)])
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.denoise_tvl1([np.zeros((4, 4), np.uint8)])
    with pytest.raises(ValueError):
        tie.denoise_tvl1([torch.zeros((4, 4), dtype=torch.uint8)], lam=0.0)


def _decolor_image(rng, H, W):
    """A smooth colour field with noise, as the JAX package's decolor test."""
    small = rng.normal(128, 60, (max(H // 8, 2), max(W // 8, 2), 3))
    ys = np.linspace(0, small.shape[0] - 1, H)
    xs = np.linspace(0, small.shape[1] - 1, W)
    base = small[np.round(ys).astype(int)][:, np.round(xs).astype(int)]
    return np.clip(base + rng.normal(0, 8, (H, W, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_decolor_matches_ref_and_jax(order):
    rng = np.random.default_rng(seed("decolor", order))
    img = _decolor_image(rng, 37, 45)
    g, b = tie.decolor(torch.from_numpy(img), order)
    assert g.dtype == torch.uint8 and g.shape == img.shape[:2] and b.shape == img.shape
    wg, wb = ref.decolor(img, order)
    _within(g, wg, 1, "decolor gray vs ref")
    _within(b, wb, 8, "decolor boost vs ref")
    jg, jb = jie.decolor(img, order)
    _within(g, jg, 1, "decolor gray vs JAX")
    _within(b, jb, 8, "decolor boost vs JAX")


def test_decolor_weights_are_refs_bit_for_bit(monkeypatch):
    """The host solver's weights equal ref's, below the 800 rows plus columns
    cap and above it; there ref's 2-D ``resize`` is applied per channel (it
    raises on [H, W, 3] by itself)."""
    rng = np.random.default_rng(seed("decolor", "weights"))
    small = _decolor_image(rng, 41, 53).astype(np.float32) / np.float32(255.0)
    w, combs = photo_host.decolor_weights(small)
    w_ref, combs_ref = ref.decolor_weights(small)
    np.testing.assert_array_equal(w, w_ref)
    assert combs == combs_ref
    big = _decolor_image(rng, 430, 390).astype(np.float32) / np.float32(255.0)
    plane_resize = ref_ops.resize
    monkeypatch.setattr(ref_ops, "resize", lambda a, dsize, interp: np.stack(
        [plane_resize(a[..., c], dsize, interp) for c in range(a.shape[-1])], -1))
    np.testing.assert_array_equal(photo_host.decolor_weights(big)[0],
                                  ref_ops.decolor_weights(big)[0])


def test_decolor_rejects():
    with pytest.raises(TypeError):
        tie.decolor(torch.zeros((8, 8), dtype=torch.uint8))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.decolor(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        tie.decolor(torch.zeros((8, 8, 3), dtype=torch.uint8), order="hsv")
