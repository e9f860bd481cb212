"""The port's CLI (imageenhancement_mp_tpu_torch/cli.py) on the CPU: every case
of the JAX package's tests/test_cli.py through ``main(argv)`` in-process with
``--device cpu``, every ``--op`` of the grammar against the JAX CLI's
``_apply_ops`` called in-process, one run as a subprocess that imports
neither JAX nor the JAX package, and the clean errors without a CUDA device
or without cv2 and Pillow.

Tolerance: 0 LSB against JAX's ``_apply_ops``, except where the port's tests
already allow ±1 against JAX (CLAHE: XLA:CPU contracts FMAs, ROADMAP R4;
bilateral; the general area and cubic resizes, JAX's f32 passes against the
oracle's f64/int64 sums; the domain-transform filters, JAX's tree cumsum):
there ±1 against JAX and 0 against ref/.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import cli as jcli
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu_torch import cli
from imageenhancement_mp_tpu_torch.io import FrameLoader, FrameWriter

ROOT = Path(__file__).resolve().parents[1]


def _run(args, capsys, stage_seconds=None):
    rc = cli.main([*map(str, args), "--device", "cpu"], stage_seconds)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _run_cli(tmp_path, img, ops, capsys):
    inp, out = tmp_path / "in.npy", tmp_path / "out.npy"
    np.save(inp, img)
    rc, _, err = _run([inp, "-o", out, *[a for op in ops for a in ("--op", op)]], capsys)
    assert rc == 0, err[-500:]
    return np.load(out)


def _write_pgm(p, a):
    with open(p, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        f.write(a.tobytes())


# -- tests/test_cli.py, case by case ---------------------------------------------

def test_cli_pipeline(tmp_path, rng, capsys):
    img = rng.integers(0, 256, (48, 56), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["median:3", "unsharp:1.0"], capsys)
    np.testing.assert_array_equal(got, ref.unsharp_mask(ref.median_blur(img, 3), 1.0))


def test_cli_unknown_op(tmp_path, rng, capsys):
    inp = tmp_path / "in.npy"
    np.save(inp, rng.integers(0, 256, (8, 8), dtype=np.uint8))
    rc, _, err = _run([inp, "--op", "bogus"], capsys)
    assert rc == 2 and "unknown op" in err


def test_cli_batch_mode(tmp_path, rng, capsys):
    ins = []
    for i in range(3):
        p = tmp_path / f"b{i}.npy"
        np.save(p, rng.integers(0, 256, (24, 31), dtype=np.uint8))
        ins.append(p)
    outdir = tmp_path / "outs"
    split = {}
    rc, _, err = _run([*ins, "-o", outdir, "--op", "stretch"], capsys, split)
    assert rc == 0, err[-400:]
    assert len(list(outdir.glob("*.npy"))) == 3
    for p in ins:
        np.testing.assert_array_equal(np.load(outdir / f"{p.stem}_out.npy"),
                                      ref.contrast_stretch(np.load(p)))
    assert split["frames"] == 3 and set(split) == {*cli.STAGES, "frames"}
    assert all(split[k] >= 0 for k in cli.STAGES)


def test_cli_u16_input_clean_error(tmp_path, rng, capsys):
    # histeq rejects u16: must exit 2 with a clean message, not a traceback
    inp = tmp_path / "u16.npy"
    np.save(inp, rng.integers(0, 65536, (16, 16), dtype=np.uint16))
    rc, _, err = _run([inp], capsys)
    assert rc == 2
    assert "error:" in err and "Traceback" not in err


def test_cli_batch_color_roundtrip(tmp_path, rng, capsys):
    cv2 = pytest.importorskip("cv2")
    # red ramp written via cv2 (BGR) -> batch identity-ish op -> read back
    img = np.zeros((16, 16, 3), np.uint8)
    img[..., 2] = np.arange(16, dtype=np.uint8)[None, :] * 10  # red in BGR
    paths = []
    for i in range(2):
        p = tmp_path / f"c{i}.png"
        assert cv2.imwrite(str(p), img)
        paths.append(p)
    outdir = tmp_path / "o"
    rc, _, err = _run([*paths, "-o", outdir, "--op", "median:3"], capsys)
    assert rc == 0, err[-400:]
    back = cv2.imread(str(outdir / "c0_out.png"))
    # red channel must still carry the ramp (no R/B swap)
    assert back[..., 2].max() > 100 and back[..., 0].max() == 0


def test_cli_batch_recovers_from_corrupt_frame(tmp_path, rng, capsys):
    """One corrupt file mid-batch must not abort the remaining frames."""
    ins = []
    for i in range(4):
        p = tmp_path / f"r{i}.pgm"
        if i == 1:
            p.write_bytes(b"P5\ngarbage")
        else:
            _write_pgm(p, rng.integers(0, 256, (16, 20), dtype=np.uint8))
        ins.append(p)
    outdir = tmp_path / "outs"
    rc, out, err = _run([*ins, "-o", outdir, "--op", "stretch"], capsys)
    assert rc == 1, (rc, err[-400:])
    assert sorted(f.name for f in outdir.glob("*.pgm")) == [
        "r0_out.pgm", "r2_out.pgm", "r3_out.pgm"]
    assert "wrote 3 files" in out and "(1 failed)" in out
    assert "r1.pgm" in err


def test_cli_single_image_pillow_color_order(tmp_path, rng, monkeypatch, capsys):
    """With only Pillow available, single-image color IO must round-trip
    without an R/B swap (the loader returns RGB; _save must not assume BGR)."""
    pytest.importorskip("PIL")
    from PIL import Image

    img = np.zeros((12, 12, 3), np.uint8)
    img[..., 0] = 200  # red in RGB
    inp = tmp_path / "in.png"
    Image.fromarray(img).save(inp)
    out = tmp_path / "out.png"
    monkeypatch.setitem(sys.modules, "cv2", None)  # simulate Pillow-only env
    rc, _, err = _run([inp, "-o", out, "--op", "median:3"], capsys)
    assert rc == 0, err[-500:]
    back = np.asarray(Image.open(out))
    assert back[..., 0].min() >= 190 and back[..., 2].max() == 0


def test_cli_batch_bgra_channel_order(tmp_path, rng, capsys):
    """Mixed-ext batch forces the cv2 fallback loader (BGRA order); the
    write-behind path must swap only B<->R — alpha stays in place."""
    cv2 = pytest.importorskip("cv2")
    rgba = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
    png = tmp_path / "a.png"
    cv2.imwrite(str(png), rgba)  # cv2 takes BGRA; file stores RGBA faithfully
    npy = tmp_path / "b.npy"
    np.save(npy, rng.integers(0, 256, (20, 24), dtype=np.uint8))
    outdir = tmp_path / "out"
    rc, _, err = _run([png, npy, "-o", outdir, "--op", "gamma:1.0"], capsys)  # identity op
    assert rc == 0, err[-500:]
    got = cv2.imread(str(outdir / "a_out.png"), cv2.IMREAD_UNCHANGED)  # BGRA
    np.testing.assert_array_equal(got, rgba)  # all four channels in place


def test_cli_gray_then_equalize(tmp_path, rng, capsys):
    """--op gray converts RGB (npy loads as RGB) then feeds the 8-bit-only
    equalize — the reference's canonical front path."""
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["gray", "histeq"], capsys)
    want = ref.equalize_hist(ref.cvt_gray(img, "rgb"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_cli_gray_rejects_gray_input(tmp_path, rng, capsys):
    inp = tmp_path / "in.npy"
    np.save(inp, rng.integers(0, 256, (8, 9), dtype=np.uint8))
    rc, _, err = _run([inp, "-o", tmp_path / "o.npy", "--op", "gray"], capsys)
    assert rc == 2
    assert "gray needs a color image" in err


def test_cli_resize(tmp_path, rng, capsys):
    """resize:H:W[:interp] — u8 bilinear is the pinned bit-exact path."""
    img = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["resize:23:31"], capsys)
    np.testing.assert_array_equal(got, ref.resize(img, (23, 31), "linear"))
    got = _run_cli(tmp_path, img, ["resize:20:25:area"], capsys)
    np.testing.assert_array_equal(got, ref.resize(img, (20, 25), "area"))


# -- every --op against the JAX CLI's _apply_ops ----------------------------------

# (spec, input): "G" a 24x31 gray frame, "C" a 24x31x3 one
OPS = [("gray", "C"), ("eqluma", "C"), ("gamma", "G"), ("gamma:0.5", "C"), ("log", "G"),
       ("stretch", "G"), ("histeq", "G"), ("histeq", "C"), ("clahe", "G"),
       ("clahe:2.0:4:4", "G"), ("gauss", "G"), ("gauss:7:1.5", "C"), ("lapsharp", "G"),
       ("unsharp", "G"), ("unsharp:1.5:3", "C"), ("median", "G"), ("median:5", "C"),
       ("box", "G"), ("box:5", "G"), ("thresh", "G"), ("thresh:100:200:binary_inv", "G"),
       ("sharpen2d", "G"), ("flip", "G"), ("flip:0", "C"), ("rotate", "G"),
       ("rotate:180", "G"), ("canny", "G"), ("warprot", "G"), ("warprot:30:0.9", "C"),
       ("warprot:30:0.9:cubic", "G"), ("resize:20:25", "G"), ("resize:20:25:area", "G"),
       ("resize:30:40:cubic", "G"), ("pyrdown", "G"), ("pyrup", "G"), ("epf", "C"),
       ("epf:normconv", "C"), ("detail", "C"), ("stylize", "C"), ("pencil", "C"),
       ("pencil:60:0.07:0.02:color", "C"), ("nlmeans:10:5:7", "G"), ("warppolar", "G"),
       ("warppolar:40:30:12", "G"), ("tonemap", "C"), ("tonemap:reinhard:1.5", "C"),
       ("sobel", "G"), ("sobel:0:1:5", "G"), ("erode", "G"), ("dilate", "G"), ("open", "G"),
       ("close", "G"), ("gradient", "G"), ("tophat", "G"), ("blackhat:5:2", "G"),
       ("athresh", "G"), ("athresh:gaussian:binary_inv:5:3", "G"), ("otsu", "G"),
       ("triangle:200:binary_inv", "G"), ("bilateral", "G"), ("bilateral:5:30:10", "C")]
# where JAX may be 1 off: the oracle's call
REF = {
    "clahe": lambda x: ref.clahe(x, 40.0, (8, 8)),
    "clahe:2.0:4:4": lambda x: ref.clahe(x, 2.0, (4, 4)),
    "bilateral": lambda x: ref.bilateral_filter(x, 5, 50.0, 50.0),
    "bilateral:5:30:10": lambda x: ref.bilateral_filter(x, 5, 30.0, 10.0),
    "resize:20:25:area": lambda x: ref.resize(x, (20, 25), "area"),
    "resize:30:40:cubic": lambda x: ref.resize(x, (30, 40), "cubic"),
    "epf": lambda x: ref.edge_preserving_filter(x, "recursive", 60.0, 0.4),
    "epf:normconv": lambda x: ref.edge_preserving_filter(x, "normconv", 60.0, 0.4),
    "detail": lambda x: ref.detail_enhance(x, 10.0, 0.15),
    "stylize": lambda x: ref.stylization(x, 60.0, 0.45),
}


def _grammar_names() -> set[str]:
    """The op names the JAX CLI's _apply_ops dispatches on, from its source."""
    tree = ast.parse((ROOT / "imageenhancement_mp_tpu" / "cli.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_apply_ops")
    names = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Compare) and isinstance(n.left, ast.Name) and n.left.id == "name":
            c = n.comparators[0]
            if isinstance(c, ast.Constant):
                names.add(c.value)
            elif isinstance(c, ast.Tuple):
                names.update(e.value for e in c.elts)
    return names


def test_every_op_of_the_grammar_is_covered():
    names = _grammar_names()
    assert len(names) == 40
    assert {spec.split(":")[0] for spec, _ in OPS} == names
    assert set(REF) <= {spec for spec, _ in OPS}


@pytest.mark.parametrize("spec, kind", OPS, ids=[f"{s}-{k}" for s, k in OPS])
def test_op_matches_the_jax_cli(spec, kind):
    rng = np.random.default_rng(sum(map(ord, spec)))
    x = rng.integers(0, 256, (24, 31) if kind == "G" else (24, 31, 3), dtype=np.uint8)
    got = cli._apply_ops(tie, torch.from_numpy(x), [spec]).numpy()
    want = np.asarray(jcli._apply_ops(jie, x, [spec]))
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if spec in REF:
        assert d.max() <= 1
        np.testing.assert_array_equal(got, REF[spec](x))
    else:
        np.testing.assert_array_equal(got, want)


def test_ops_keep_the_device_and_chain(rng):
    """A pipeline of specs runs on the tensor's device, each op on the last
    one's output; the BGR order reaches gray's coefficients."""
    x = rng.integers(0, 256, (24, 31, 3), dtype=np.uint8)
    got = cli._apply_ops(tie, torch.from_numpy(x), ["gray", "median:3", "histeq"],
                         rgb_order=False)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), ref.equalize_hist(ref.median_blur(ref.cvt_gray(x, "bgr"), 3)))


# -- entry points ---------------------------------------------------------------

def test_module_runs_without_jax(tmp_path, rng):
    """``python -m`` on the CPU exits 0; a ``-c`` wrapper around main finds
    neither JAX nor the JAX package in sys.modules afterwards."""
    img = rng.integers(0, 256, (20, 24), dtype=np.uint8)
    np.save(tmp_path / "in.npy", img)
    r = subprocess.run([sys.executable, "-m", "imageenhancement_mp_tpu_torch.cli",
                        str(tmp_path / "in.npy"), "-o", str(tmp_path / "a.npy"),
                        "--device", "cpu", "--op", "median:3"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-500:]
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), ref.median_blur(img, 3))
    code = ("import sys; import imageenhancement_mp_tpu_torch.cli as c; "
            "rc = c.main(sys.argv[1:]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'imageenhancement_mp_tpu')]; "
            "assert not bad, bad; raise SystemExit(rc)")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "in.npy"), "-o",
                        str(tmp_path / "b.npy"), "--device", "cpu", "--op", "histeq",
                        "--op", "unsharp"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-500:]
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  ref.unsharp_mask(ref.equalize_hist(img), 1.0))


def test_default_device_without_cuda_exits_2(tmp_path, rng, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs there")
    inp = tmp_path / "in.npy"
    np.save(inp, rng.integers(0, 256, (8, 8), dtype=np.uint8))
    assert cli.main([str(inp), "-o", str(tmp_path / "o.npy")]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "--device cpu" in err
    assert not (tmp_path / "o.npy").exists()


def test_no_cv2_no_pillow(tmp_path, rng, monkeypatch, capsys):
    """The chip machine's case: .npy, .pgm, .ppm and .png run through the
    frame loader and writer; a single non-.npy output fails with the JAX
    CLI's clean error."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    frames = [rng.integers(0, 256, (18, 23), dtype=np.uint8),
              rng.integers(0, 256, (18, 23, 3), dtype=np.uint8)]
    ins = [tmp_path / "g.png", tmp_path / "c.png"]
    with FrameWriter(threads=2) as fw:
        for p, f in zip(ins, frames):
            fw.save(p, f)
    outdir = tmp_path / "o"
    rc, out, err = _run([*ins, "-o", outdir, "--op", "histeq"], capsys)
    assert rc == 0, err[-400:]
    back = list(FrameLoader([outdir / "g_out.png", outdir / "c_out.png"]))
    for b, f in zip(back, frames):
        np.testing.assert_array_equal(b, tie.equalize_hist(torch.from_numpy(f)).numpy())
    np.save(tmp_path / "in.npy", frames[0])
    with pytest.raises(SystemExit, match="error: writing non-.npy images needs"):
        cli.main([str(tmp_path / "in.npy"), "-o", str(tmp_path / "o.png"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="error: reading non-.npy images needs"):
        cli.main([str(ins[0]), "-o", str(tmp_path / "o.npy"), "--device", "cpu"])
