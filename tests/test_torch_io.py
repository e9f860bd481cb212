"""The port's frame IO (imageenhancement_mp_tpu_torch/io/) against the JAX
package's io/: the same native sources, the same decoded arrays and
failures for PGM/PPM/PNG (8 and 16 bit) and corrupt frames, the same encoded
bytes, through the native build and the pure-Python fallback."""

from pathlib import Path

import numpy as np
import pytest

from imageenhancement_mp_tpu import io as jio
from imageenhancement_mp_tpu.io import writer as jwriter
from imageenhancement_mp_tpu_torch import io as tio
from imageenhancement_mp_tpu_torch.io import loader as tloader
from imageenhancement_mp_tpu_torch.io import writer as twriter

ROOT = Path(__file__).resolve().parents[1]


def test_native_sources_are_the_jax_copies():
    for name in ("frameloader.cpp", "framewriter.cpp"):
        ours = ROOT / "imageenhancement_mp_tpu_torch" / "io" / "native" / name
        theirs = ROOT / "imageenhancement_mp_tpu" / "io" / "native" / name
        assert ours.read_bytes() == theirs.read_bytes()


def test_libraries_build_under_build_dir():
    assert tloader._LIB.parent == ROOT / "build" / "ie_torch_io"
    assert twriter._LIB.parent == ROOT / "build" / "ie_torch_io"
    if tio.FrameLoader([]).native:
        assert tloader._LIB.is_file()
        assert not list((ROOT / "imageenhancement_mp_tpu_torch" / "io").rglob("*.so"))


def _frames(rng):
    return [rng.integers(0, 256, (17, 23), dtype=np.uint8),
            rng.integers(0, 256, (9, 14, 3), dtype=np.uint8),
            rng.integers(0, 65536, (11, 8), dtype=np.uint16),
            rng.integers(0, 65536, (6, 10, 3), dtype=np.uint16),
            rng.integers(0, 256, (13, 7, 4), dtype=np.uint8),
            rng.integers(0, 256, (5, 12, 2), dtype=np.uint8)]


def _files(tmp_path, rng):
    """Frames written by the JAX package's fallback encoder, in every
    format both loaders read, and three corrupt files."""
    paths, want = [], []
    for i, f in enumerate(_frames(rng)):
        exts = [".png"] + ([".pgm" if f.ndim == 2 else ".ppm"] if f.ndim == 2 or
                           f.shape[2] == 3 else [])
        for ext in exts:
            p = tmp_path / f"f{i}{ext}"
            p.write_bytes(jwriter.encode_frame(str(p), f))
            paths.append(p)
            want.append(f)
    for name, data in (("bad.pgm", b"P5\ngarbage"), ("bad.png", b"\x89PNG\r\n\x1a\n\0\0"),
                       ("missing.ppm", None)):
        p = tmp_path / name
        if data is not None:
            p.write_bytes(data)
        paths.insert(3, p)
        want.insert(3, None)
    return paths, want


@pytest.mark.parametrize("force", [False, True], ids=["native", "fallback"])
def test_loader_decodes_as_jax(tmp_path, rng, force):
    paths, want = _files(tmp_path, rng)
    ours = list(tio.FrameLoader(paths, threads=3, force_fallback=force, on_error="sentinel"))
    theirs = list(jio.FrameLoader(paths, threads=3, force_fallback=force, on_error="sentinel"))
    assert len(ours) == len(theirs) == len(paths)
    for o, t, w in zip(ours, theirs, want):
        if w is None:
            assert isinstance(o, tio.FrameError) and isinstance(t, jio.FrameError)
            assert str(o) == str(t) and o.code == t.code
        else:
            assert o.dtype == t.dtype == w.dtype
            np.testing.assert_array_equal(o, t)
            np.testing.assert_array_equal(o, w)
    with pytest.raises(tio.FrameError):
        list(tio.FrameLoader(paths, force_fallback=force))


@pytest.mark.parametrize("force", [False, True], ids=["native", "fallback"])
def test_writer_encodes_as_jax(tmp_path, rng, force):
    frames = _frames(rng)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    names = []
    with tio.FrameWriter(threads=2, force_fallback=force) as ours, \
            jio.FrameWriter(threads=2, force_fallback=force) as theirs:
        assert ours.native == theirs.native
        for i, f in enumerate(frames):
            for ext in (".png", ".pgm" if f.ndim == 2 else ".ppm", ".raw"):
                if ext == ".ppm" and f.shape[2] != 3:
                    continue
                names.append(f"f{i}{ext}")
                ours.save(tmp_path / "t" / names[-1], f)
                theirs.save(tmp_path / "j" / names[-1], f)
        for w in (ours, theirs):  # a write that fails: reported at the flush
            w.save(tmp_path / "no" / "such" / "dir.png", frames[0])
    assert len(ours.failures) == len(theirs.failures) == 1
    assert str(ours.failures[0]) == str(theirs.failures[0])
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    for n, f in zip([n for n in names if n.endswith(".png")], frames):
        np.testing.assert_array_equal(next(iter(tio.FrameLoader([tmp_path / "t" / n]))), f)
    for f in frames:
        assert twriter.encode_frame("x.png", f) == jwriter.encode_frame("x.png", f)
    with pytest.raises(TypeError):
        twriter.encode_frame("x.png", frames[0].astype(np.int16))


def test_bounded_map_keeps_order():
    got = list(tloader.bounded_map(lambda x: x * x, range(50), threads=3))
    assert got == [x * x for x in range(50)]
