"""The HDR family in the port: align_mtb, the Mertens and Debevec merges and
the four tonemaps against the NumPy oracle ref/ and the JAX package on the
CPU, and the kernels the family's device path launches.

Tolerances: align_mtb bit for bit (shifts and crops); merge_mertens 1e-4
and merge_debevec 1e-4 relative (tests/test_photo.py's budgets for the JAX
package); tonemap 6e-8 (its stated bound); Reinhard, Drago and Mantiuk 5e-5
on values finite in both, more than 99.9 % finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from detseed import seed
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu_torch.kernels import hist as khist
from imageenhancement_mp_tpu_torch.kernels import take as ktake


def _exposures(rng, H, W, n):
    base = np.clip(rng.normal(128, 60, (H, W, 3)), 0, 255)
    return [np.clip(base * s + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
            for s in np.linspace(0.3, 2.0, n)]


def _bracket(rng, H, W, shifts):
    """A textured scene under three exposures, each frame moved by (dy, dx)."""
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    scene = (128 + 50 * np.sin(xx / 5.0) * np.cos(yy / 7.0) + 20 * np.sin(xx / 17.0 + yy / 11.0)
             + rng.normal(0, 8, yy.shape))
    out = []
    for s, (dy, dx) in zip((-5, 0, 4), shifts):
        f = np.clip(scene[8 + dy:8 + dy + H, 8 + dx:8 + dx + W] * np.exp(s * 0.15), 0, 255)
        f = f.astype(np.uint8)
        out.append(np.dstack([f, np.roll(f, 1, 1), np.roll(f, 2, 1)]))
    return out


@pytest.mark.parametrize("case", range(3))
def test_align_mtb_matches_ref(case):
    rng = np.random.default_rng(seed("alignmtb", case))
    H, W = int(rng.integers(90, 160)), int(rng.integers(90, 160))
    shifts = [(int(rng.integers(-6, 7)), int(rng.integers(-6, 7))) for _ in range(3)]
    frames = _bracket(rng, H, W, shifts)
    for cut in (False, True):
        want = ref.align_mtb(frames, cut=cut)
        for arg in (torch.from_numpy(np.stack(frames)), [torch.from_numpy(f) for f in frames]):
            got = tie.align_mtb(arg, cut=cut)
            assert len(got) == 3
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w)


def test_align_mtb_then_mertens():
    rng = np.random.default_rng(seed("alignmtb", "flow"))
    frames = _bracket(rng, 64, 80, [(2, -3), (0, 0), (-1, 2)])
    aligned = tie.align_mtb(torch.from_numpy(np.stack(frames)))
    fused = tie.merge_mertens(aligned)
    want = ref.merge_mertens(ref.align_mtb(frames))
    assert float(np.abs(fused.numpy() - want).max()) <= 1e-4
    with pytest.raises(ValueError):
        tie.align_mtb(torch.zeros((3, 8, 8), dtype=torch.uint8))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tie.align_mtb(frames)


def _mertens_stream(case):
    """The JAX package's Mertens test inputs (tests/test_photo.py), drawn
    without cv2: the case-th of its three brackets."""
    rng = np.random.default_rng(seed("mertens"))
    for _ in range(case + 1):
        H, W = int(rng.integers(24, 64)), int(rng.integers(24, 64))
        base = np.clip(rng.normal(128, 60, (H, W, 3)), 0, 255)
        n = int(rng.integers(2, 5))
        frames = [np.clip(base * s + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
                  for s in np.linspace(0.3, 2.0, n)]
    return frames


@pytest.mark.parametrize("case", range(3))
def test_merge_mertens_matches_ref_and_jax(case):
    """Against ref on fresh brackets of 2–4 frames and on the JAX package's
    test brackets, against the JAX package on its test brackets (on some
    others its f32 XLA program is 9e-4 from ref, the port 6e-6)."""
    rng = np.random.default_rng(seed("mertens", case))
    H, W = int(rng.integers(24, 49)), int(rng.integers(24, 49))
    frames = _exposures(rng, H, W, 2 + case)
    weights = ((1.0, 1.0, 0.0), (0.5, 2.0, 1.0), (1.0, 0.0, 1.0))[case]
    got = tie.merge_mertens(torch.from_numpy(np.stack(frames)), *weights)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    assert float(np.abs(got.numpy() - ref.merge_mertens(frames, *weights)).max()) <= 1e-4
    frames = _mertens_stream(case)
    for w in ((1.0, 1.0, 0.0), (0.5, 2.0, 1.0)):
        got = tie.merge_mertens([torch.from_numpy(f) for f in frames], *w).numpy()
        assert float(np.abs(got - ref.merge_mertens(frames, *w)).max()) <= 1e-4
        assert float(np.abs(got - np.asarray(jie.merge_mertens(frames, *w))).max()) <= 1e-4


@pytest.mark.parametrize("case", range(3))
def test_merge_debevec_matches_ref_and_jax(case):
    rng = np.random.default_rng(seed("debevec", case))
    H, W = int(rng.integers(16, 49)), int(rng.integers(16, 49))
    base = np.clip(rng.normal(120, 70, (H, W, 3)), 0, 255)
    n = 2 + case
    times = np.sort(rng.uniform(0.01, 2.0, n)).astype(np.float32)
    frames = [np.clip(base * (t * 3) + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)
              for t in times]
    got = tie.merge_debevec([torch.from_numpy(f) for f in frames], times).numpy()
    for want in (ref.merge_debevec(frames, times), np.asarray(jie.merge_debevec(frames, times))):
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-4)
        assert float(rel.max()) <= 1e-4


def test_merges_reject_what_jax_rejects():
    z = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.merge_debevec(z, [0.1])
    for fn in (tie.merge_mertens, lambda s: tie.merge_debevec(s, [0.1, 0.2])):
        with pytest.raises(TypeError):
            fn(z.float())
        with pytest.raises(ValueError):
            fn(z[0])
        with pytest.raises(TypeError, match="torch.Tensor"):
            fn(z.numpy())


def test_tonemap_matches_ref_and_jax():
    rng = np.random.default_rng(seed("tonemap"))
    hdr = (rng.random((20, 22, 3)).astype(np.float32) * 8.0 + 0.01).astype(np.float32)
    for g in (1.0, 2.2, 0.7):
        got = tie.tonemap(torch.from_numpy(hdr), g).numpy()
        assert float(np.abs(got - ref.tonemap(hdr, g)).max()) <= 6e-8
        assert float(np.abs(got - np.asarray(jie.tonemap(jnp.asarray(hdr), g))).max()) <= 6e-8
    assert torch.all(tie.tonemap(torch.ones((4, 4, 3))) == 0)


@pytest.mark.parametrize("which", ["reinhard", "drago", "mantiuk"])
def test_tonemaps_match_ref_and_jax(which):
    """The JAX package's device-vs-oracle input (tests/test_photo.py): where
    the oracle NaNs a negative normalize residue, its renormalization moves
    and both devices' closed forms differ from it by ~1e-3 on other inputs."""
    rng = np.random.default_rng(seed("tonemapdev"))
    hdr = (rng.random((19, 23, 3)).astype(np.float32) * 12.0 + 0.01)
    fn_t, fn_j, fn_r, kw = {
        "reinhard": (tie.tonemap_reinhard, jie.tonemap_reinhard, ref.tonemap_reinhard,
                     dict(gamma=2.2, intensity=0.5, light_adapt=0.8, color_adapt=0.4)),
        "drago": (tie.tonemap_drago, jie.tonemap_drago, ref.tonemap_drago,
                  dict(gamma=1.5, saturation=1.2, bias=0.9)),
        "mantiuk": (tie.tonemap_mantiuk, jie.tonemap_mantiuk, ref.tonemap_mantiuk,
                    dict(gamma=1.5, scale=0.8, saturation=1.2))}[which]
    got = fn_t(torch.from_numpy(hdr), **kw).numpy()
    for want in (fn_r(hdr, **kw), np.asarray(fn_j(jnp.asarray(hdr), **kw))):
        m = np.isfinite(want) & np.isfinite(got)
        assert float(np.abs(got[m] - want[m]).max()) <= 5e-5
        assert m.mean() > 0.999
    hdr2 = (np.random.default_rng(seed("tonemap", which)).random((23, 29, 3)).astype(np.float32)
            * 30.0 + 0.05)
    got = fn_t(torch.from_numpy(hdr2), **kw).numpy()
    want = np.asarray(fn_j(jnp.asarray(hdr2), **kw))
    m = np.isfinite(want) & np.isfinite(got)
    assert float(np.abs(got[m] - want[m]).max()) <= 5e-5 and m.mean() > 0.999
    with pytest.raises(TypeError):
        fn_t(torch.zeros((4, 4, 3), dtype=torch.float64))


@pytest.mark.parametrize("which", ["reinhard", "drago", "mantiuk"])
def test_tonemaps_reject_gray_with_value_error(which):
    """A gray plane raises ValueError, as the JAX package's tonemaps do (so
    the CLI's ``tonemap`` op on a gray frame exits with a clean error)."""
    fn_t, fn_j = {"reinhard": (tie.tonemap_reinhard, jie.tonemap_reinhard),
                  "drago": (tie.tonemap_drago, jie.tonemap_drago),
                  "mantiuk": (tie.tonemap_mantiuk, jie.tonemap_mantiuk)}[which]
    gray = np.random.default_rng(seed("tonemapgray", which)).random((11, 13)).astype(np.float32)
    with pytest.raises(ValueError):
        fn_j(jnp.asarray(gray))
    with pytest.raises(ValueError):
        fn_t(torch.from_numpy(gray))


def test_device_path_launches_the_kernels(monkeypatch):
    """With the launch stubbed and CUDA assumed: decolor launches take_table
    15 times (u8 rgb2lab 6, lab2rgb 9) and merge_debevec apply_lut256_wide
    twice (its two f32 tables), and neither calls a plain version."""
    launches = []
    for mod in (ktake, khist):
        monkeypatch.setattr(mod, "on_cuda", lambda t, what: True)
        monkeypatch.setattr(mod, "launch", lambda *args: launches.append(args[0]))

    def no_plain(*args):
        raise AssertionError("a plain version ran")

    monkeypatch.setattr(ktake, "take_table_plain", no_plain)
    monkeypatch.setattr(khist, "apply_lut256_plain", no_plain)
    rng = np.random.default_rng(seed("launches"))
    img = torch.from_numpy(rng.integers(0, 256, (12, 14, 3), dtype=np.uint8))
    g, b = tie.decolor(img)
    assert g.shape == (12, 14) and b.shape == (12, 14, 3)
    assert launches == ["take_table"] * 15
    launches.clear()
    stack = torch.from_numpy(rng.integers(0, 256, (3, 12, 14, 3), dtype=np.uint8))
    assert tie.merge_debevec(stack, [0.1, 0.4, 1.6]).shape == (12, 14, 3)
    assert launches == ["apply_lut256_wide"] * 2
