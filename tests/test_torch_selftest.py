"""The port's CUDA self-check (imageenhancement_mp_tpu_torch/selftest.py) on
the CPU: its rows are the JAX selftest's by name plus the 128x256 rows, its arrays are the JAX selftest's draws, and each row's plain
path equals the JAX row's oracle expression (ref/) on them.

Tolerance against ref/: 0 LSB for every row except three, each at the JAX
row's budget of 1: match_tpl (the f32 response quantized to 1e-3; the port
is within 3e-6 of ref/, which can move a value across a rounding edge of
the quantization), hsv/inv (the port follows cv2's single-rounded terms,
ref/'s hsv_to_rgb is the plain chain: ROADMAP R6) and luv/inv (u8
luv2rgb is an f32 ``pow`` where ref/ computes in f64, so
tests/test_torch_color.py holds it to JAX at ±1).  Never looser than the
JAX row's budget.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ref.ops import _equalize_lut
from imageenhancement_mp_tpu_torch import selftest as st

SIZE = (48, 53)  # the JAX package's test_selftest_passes_on_cpu size
JAX_SELFTEST = Path(__file__).resolve().parents[1] / "imageenhancement_mp_tpu" / "selftest.py"
WIDE_ROWS = ["wide/gauss3", "wide/gauss5", "wide/gauss7", "wide/gauss15", "wide/gauss37/s6",
             "wide/eq_unsharp", "wide/clahe", "wide/clahe/u16"]
TOL = {"match_tpl": 1, "hsv/inv": 1, "luv/inv": 1}


def _jax_rows() -> dict[str, int]:
    """The JAX selftest's (name, budget) pairs, read from its source."""
    tree = ast.parse(JAX_SELFTEST.read_text())
    return {n.elts[0].value: n.elts[3].value for n in ast.walk(tree)
            if isinstance(n, ast.Tuple) and len(n.elts) == 4
            and isinstance(n.elts[0], ast.Constant) and isinstance(n.elts[0].value, str)}


JAX_ROWS = _jax_rows()


def _jax_draws(size, seed):
    """The JAX selftest's draws, in its order (selftest.py:36-38, 60-64,
    286, 302, 340, 357-359, 385-386)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size, dtype=np.uint8)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)
    img2 = rng.integers(0, 256, size, dtype=np.uint8)
    wblend1 = (rng.random(size) * 4).astype(np.float32)
    wblend2 = (rng.random(size) * 4).astype(np.float32)
    rgb = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    img16 = rng.integers(0, 65536, size, dtype=np.uint16)
    imgs16 = rng.integers(-32768, 32768, size, dtype=np.int16)
    vid = rng.integers(0, 256, (3, *size, 2), dtype=np.uint8)
    sp_cs = np.stack([rng.uniform(4, size[1] - 5, 12),
                      rng.uniform(4, size[0] - 5, 12)], axis=1).astype(np.float32)
    sp_f = (rng.random(size) * 255).astype(np.float32)
    lk_next = np.roll(img, (2, -1), (0, 1))
    lk_pts = np.stack([rng.uniform(12, size[1] - 13, 8),
                       rng.uniform(12, size[0] - 13, 8)], 1).astype(np.float32)
    return dict(img=img, lut=lut, img2=img2, wblend1=wblend1, wblend2=wblend2, rgb=rgb,
                img16=img16, imgs16=imgs16, vid=vid, sp_cs=sp_cs, sp_f=sp_f, lk_next=lk_next,
                lk_pts=lk_pts), rng


def _oracles(a, size) -> dict:
    """The JAX selftest's oracle expressions (its ``ref_fn`` of each row),
    unchanged but for lk/track's err where status is not 1 (the JAX row
    takes its device's value there; the port's rows zero it), and the
    oracles of the 128x256 rows."""
    img, img2, rgb, lut = a["img"], a["img2"], a["rgb"], a["lut"]
    wblend1, wblend2, img16, imgs16 = a["wblend1"], a["wblend2"], a["img16"], a["imgs16"]
    vid, sp_cs, sp_f, lk_next, lk_pts = a["vid"], a["sp_cs"], a["sp_f"], a["lk_next"], a["lk_pts"]
    mh, mw = min(40, size[0]), min(44, size[1])

    def _quant_mt(r):
        return np.round(np.asarray(r) * 1000).astype(np.int32)

    def _swirl_maps(size):
        h, w = size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        mx = (xx + 3.0 * np.sin(yy / 7.0)).astype(np.float32)
        my = (yy + 2.0 * np.cos(xx / 9.0)).astype(np.float32)
        return mx, my

    def _persp_matrix(size):
        h, w = size
        src = [(0, 0), (w - 1.0, 0), (w - 1.0, h - 1.0), (0, h - 1.0)]
        dst = [(3.5, 2.0), (w - 5.0, 4.5), (w - 2.0, h - 3.0), (1.0, h - 6.5)]
        return ref.get_perspective_transform(src, dst)

    def _luma_oracle():
        ycc = ref.rgb_to_ycrcb(rgb)
        y = ref.equalize_hist(ycc[..., 0])
        return ref.ycrcb_to_rgb(np.concatenate([y[..., None], ycc[..., 1:]], axis=-1))

    def _spatial_oracle():
        crop = img[: size[0] - size[0] % 4, : size[1] - size[1] % 4]
        return ref.unsharp_mask(ref.clahe(ref.median_blur(crop, 3), 2.0, (4, 4)), 1.0)

    def _pooled_oracle():
        out = np.empty_like(vid)
        for c in range(vid.shape[-1]):
            stack = vid[..., c]
            hist = np.bincount(stack.ravel(), minlength=256)
            out[..., c] = _equalize_lut(hist, stack.size)[stack]
        return out

    def _subpix_oracle(src, pt):
        return np.stack([
            ref.get_rect_sub_pix(src, (5, 4), (float(cx), float(cy)),
                                 patch_type=pt).reshape(
                (4, 5) if src.ndim == 2 else (4, 5, 3))
            for cx, cy in sp_cs])

    def _lk_ref():
        p, s, e = ref.calc_optical_flow_pyr_lk(img, lk_next, lk_pts, (11, 11), 2, 30, 0.01)
        st_ = np.asarray(s)
        ed = np.asarray(e).copy().view(np.int32)
        ed[st_ != 1] = 0  # err defined only for st=1
        return np.concatenate([p.view(np.int32).reshape(-1), st_.astype(np.int32), ed])

    wide, wide16 = a["wide"], a["wide16"]
    return {
        "apply_lut": lambda: ref.apply_lut(img, lut),
        "gamma 2.2": lambda: ref.gamma_transform(img, 2.2),
        "log": lambda: ref.log_transform(img),
        "stretch": lambda: ref.contrast_stretch(img),
        "scale_abs": lambda: ref.convert_scale_abs(img, 1.3, -7.0),
        "histogram": lambda: ref.calc_hist(img),
        "equalize": lambda: ref.equalize_hist(img),
        "clahe": lambda: ref.clahe(img, 2.0, (8, 8)),
        "gauss5": lambda: ref.gaussian_blur(img, 5, 0.0),
        "gauss5/s1.5": lambda: ref.gaussian_blur(img, 5, 1.5),
        "laplacian": lambda: ref.laplacian(img),
        "lap_sharpen": lambda: ref.laplacian_sharpen(img),
        "unsharp": lambda: ref.unsharp_mask(img, 1.0),
        "median3": lambda: ref.median_blur(img, 3),
        "median5": lambda: ref.median_blur(img, 5),
        "add_weighted": lambda: ref.add_weighted(img, 1.7, img2, -0.6, 41.25),
        "cvt_gray": lambda: ref.cvt_gray(rgb),
        "box5": lambda: ref.box_blur(img, 5),
        "bilateral": lambda: ref.bilateral_filter(img, 5, 30.0, 6.0),
        "thresh/otsu": lambda: ref.threshold(img, method="otsu")[1],
        "eq_luma": _luma_oracle,
        "athresh/gauss": lambda: ref.adaptive_threshold(img, 255.0, "gaussian", "binary", 11,
                                                        2.0),
        "morph/open": lambda: ref.morphology(img, "open", (3, 5)),
        "sobel5": lambda: ref.sobel(img, 1, 1, 5),
        "hsv/fwd": lambda: ref.rgb_to_hsv(rgb),
        "hsv/inv": lambda: ref.hsv_to_rgb(ref.rgb_to_hsv(rgb)),
        "lab/fwd": lambda: ref.rgb_to_lab(rgb),
        "lab/inv": lambda: ref.lab_to_rgb(ref.rgb_to_lab(rgb)),
        "xyz/fwd": lambda: ref.rgb_to_xyz(rgb),
        "clahe_lab": lambda: ref.lab_to_rgb(np.concatenate(
            [ref.clahe(ref.rgb_to_lab(rgb)[..., 0], 2.0, (4, 4))[..., None],
             ref.rgb_to_lab(rgb)[..., 1:]], axis=-1)),
        "pyr_down": lambda: ref.pyr_down(img),
        "pyr_up": lambda: ref.pyr_up(img),
        "filter2d": lambda: ref.filter2d(img, np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]])),
        "resize/lin": lambda: ref.resize(img, (size[0] * 3 // 4, size[1] * 5 // 7)),
        "resize/area": lambda: ref.resize(img, (size[0] * 3 // 7, size[1] * 2 // 5), "area"),
        "resize/cubic": lambda: ref.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7), "cubic"),
        "rotate90": lambda: ref.rotate(img, "90cw"),
        "canny": lambda: ref.canny(img, 60.0, 160.0),
        "nlmeans": lambda: ref.fast_nl_means_denoising(img, 12.0, 5, 9),
        "remap": lambda: ref.remap(img, *_swirl_maps(size)),
        "remap/cubic": lambda: ref.remap(img, *_swirl_maps(size), "cubic"),
        "remap/lancz": lambda: ref.remap(img, *_swirl_maps(size), "lanczos4"),
        "match_tpl": lambda: _quant_mt(ref.match_template(img, img2[:7, :9], "ccoeff_normed")),
        "warp/rot30": lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 30.0, 0.9), size),
        "warp/cubic": lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 20.0, 1.1), size,
            "cubic"),
        "warp/pcubic": lambda: ref.warp_perspective(img, _persp_matrix(size), size, "cubic"),
        "warp/lancz": lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), -25.0, 0.95), size,
            "lanczos4"),
        "warp/persp": lambda: ref.warp_perspective(img, _persp_matrix(size), size),
        "luv/fwd": lambda: ref.rgb_to_luv(rgb),
        "luv/inv": lambda: ref.luv_to_rgb(ref.rgb_to_luv(rgb)),
        "hls/fwd": lambda: ref.rgb_to_hls(rgb),
        "hls/inv": lambda: ref.hls_to_rgb(ref.rgb_to_hls(rgb)),
        "resize/lanczos": lambda: ref.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7),
                                             "lanczos4"),
        "warp_polar": lambda: ref.warp_polar(
            img, (size[1] * 3 // 4, 64), (size[1] / 2, size[0] / 2), 40.0),
        "warp_polar/inv": lambda: ref.warp_polar(
            img, (size[1], size[0]), (size[1] / 2, size[0] / 2), 40.0, log=True, inverse=True),
        "nlmeans/color": lambda: ref.fast_nl_means_denoising_colored(
            np.asarray(rgb)[:min(48, size[0]), :min(52, size[1])], 10.0, 14.0, 3, 9),
        "decolor": lambda: ref.decolor(np.asarray(rgb))[0],
        "tvl1": lambda: ref.denoise_tvl1([img, img2], 1.0, 20),
        "nlmeans/u16": lambda: ref.fast_nl_means_denoising(
            (img.astype(np.uint16) * 257), 900.0, 5, 9, "l1"),
        "nlmeans/multi": lambda: ref.fast_nl_means_denoising_multi(
            [np.asarray(img)[:mh, :mw], np.asarray(img2)[:mh, :mw],
             np.asarray(img)[size[0] - mh:, size[1] - mw:]], 1, 3, 15.0, 3, 9),
        "photo/epf_rf": lambda: ref.edge_preserving_filter(np.asarray(rgb)[:mh, :mw],
                                                           "recursive", 55.0, 0.35),
        "photo/styliz": lambda: ref.stylization(np.asarray(rgb)[:mh, :mw], 60.0, 0.45),
        "photo/pencil": lambda: np.concatenate(
            [a_[..., None] if a_.ndim == 2 else a_
             for a_ in ref.pencil_sketch(np.asarray(rgb)[:mh, :mw])], -1),
        "spatgrad": lambda: np.stack(ref.spatial_gradient(np.asarray(img))),
        "sqr_box5": lambda: ref.sqr_box_filter(np.asarray(img), 5).view(np.int32),
        "blend/u8": lambda: ref.blend_linear(np.asarray(img), np.asarray(img2), wblend1,
                                             wblend2),
        "blend/f32": lambda: ref.blend_linear(img.astype(np.float32), img2.astype(np.float32),
                                              wblend1, wblend2).view(np.int32),
        "dist/l2m3": lambda: ref.distance_transform(
            (np.asarray(img) > 12).astype(np.uint8), "l2", 3).view(np.int32),
        "dist/l1u8": lambda: ref.distance_transform(
            (np.asarray(img) > 12).astype(np.uint8), "l1", 3, "u8"),
        "floodfill": lambda: ref.flood_fill(
            np.asarray(img), (size[1] // 2, size[0] // 2), 200, 35, 35)[1],
        "goodfeats": lambda: ref.good_features_to_track(np.asarray(img), 25, 0.05, 7.0),
        "houghlines": lambda: ref.hough_lines(
            (np.asarray(img) > 200).astype(np.uint8) * 255, 1.0, np.pi / 180, 12).view(np.int32),
        "gauss5/u16": lambda: ref.gaussian_blur(img16, 5, 0.0),
        "gauss13/u16/s2": lambda: ref.gaussian_blur(img16, 13, 2.0),
        "median3/u16": lambda: ref.median_blur(img16, 3),
        "median5/u16": lambda: ref.median_blur(img16, 5),
        "clahe/u16": lambda: ref.clahe(img16, 2.0, (4, 4)),
        "unsharp/u16": lambda: ref.unsharp_mask(img16, 1.0),
        "median5/i16": lambda: ref.median_blur(imgs16, 5),
        "stretch/i16": lambda: ref.contrast_stretch(imgs16, (-20.5, 512.0)),
        "gauss5/i16": lambda: ref.gaussian_blur(imgs16, 5, 0.0),
        "lap_sharp/i16": lambda: ref.laplacian_sharpen(imgs16),
        "spatial/cfg5": _spatial_oracle,
        "equalize/pool": _pooled_oracle,
        "subpix/u8": lambda: _subpix_oracle(img, "u8"),
        "subpix/u8rgb": lambda: _subpix_oracle(rgb, "u8"),
        "subpix/f32": lambda: _subpix_oracle(sp_f, "f32").view(np.int32),
        "lk/track": _lk_ref,
        "meanshift/pyr": lambda: ref.pyr_mean_shift_filtering(rgb, 3.0, 20.0, 1),
        "wide/gauss3": lambda: ref.gaussian_blur(wide, 3, 0.0),
        "wide/gauss5": lambda: ref.gaussian_blur(wide, 5, 0.0),
        "wide/gauss7": lambda: ref.gaussian_blur(wide, 7, 0.0),
        "wide/gauss15": lambda: ref.gaussian_blur(wide, 15, 0.0),
        "wide/gauss37/s6": lambda: ref.gaussian_blur(wide, 37, 6.0),
        "wide/eq_unsharp": lambda: ref.unsharp_mask(ref.equalize_hist(wide), 1.0),
        "wide/clahe": lambda: ref.clahe(wide, 2.0, (8, 8)),
        "wide/clahe/u16": lambda: ref.clahe(wide16, 2.0, (8, 8)),
    }


def test_row_names_are_the_jax_rows_less_spatial_plus_wide():
    """The JAX selftest's 89 rows, spatial/cfg5 among them, then the wide
    rows (the name is older than the spatial row)."""
    names = [r[0] for r in st.selftest_rows(SIZE, 0)]
    assert len(JAX_ROWS) == 89 and "spatial/cfg5" in JAX_ROWS
    assert names == list(JAX_ROWS) + WIDE_ROWS
    assert set(st.BUDGETS) <= set(names)


@pytest.mark.parametrize("size, seed", [(SIZE, 0), ((128, 131), 0), ((37, 64), 5)])
def test_arrays_are_the_jax_draws(size, seed):
    want, rng = _jax_draws(size, seed)
    got = st.selftest_arrays(size, seed)
    for k, v in want.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # the 128x256 images come after every JAX draw
    np.testing.assert_array_equal(got["wide"], rng.integers(0, 256, st.WIDE_SIZE, dtype=np.uint8))
    np.testing.assert_array_equal(got["wide16"],
                                  rng.integers(0, 65536, st.WIDE_SIZE, dtype=np.uint16))


ROWS = st.selftest_rows(SIZE, 0)
ORACLES = _oracles(st.selftest_arrays(SIZE, 0), SIZE)


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_row_plain_path_equals_the_jax_oracle(row):
    name, fn, inputs = row
    tol = TOL.get(name, 0)
    assert tol <= JAX_ROWS.get(name, 0)
    got = st.as_lsb(fn(*[torch.from_numpy(x.copy()) for x in inputs]))
    want = st.as_lsb(ORACLES[name]())
    lsb = st.max_lsb(got, want)
    assert lsb is not None, (got.shape, want.shape)
    assert lsb <= tol


def test_budgets_are_chip_smoke_limits():
    """Card-against-CPU budgets: 0 but for the rows chip_smoke.py holds to
    a stated float limit; none above 1."""
    assert st.BUDGETS == {"match_tpl": 1, "luv/inv": 1, "photo/epf_rf": 1,
                          "photo/styliz": 1, "decolor": 1, "tvl1": 1}


def test_as_lsb_and_max_lsb():
    t = torch.tensor([1.0, -2.0], dtype=torch.float32)
    np.testing.assert_array_equal(st.as_lsb((st._bits(t), torch.tensor([3], dtype=torch.uint8))),
                                  np.concatenate([t.numpy().view(np.int32), [3]]).astype(np.int64))
    assert st.max_lsb(np.array([1, 5]), np.array([2, 3])) == 2
    assert st.max_lsb(np.zeros(2, np.int64), np.zeros(3, np.int64)) is None


def test_check_rows_records_each_row(capsys):
    """The comparison loop, CPU against CPU: every row within its budget,
    one record and one line a row; a row whose two runs differ fails."""
    results = []
    assert st.check_rows(ROWS[:6], torch.device("cpu"), True, results)
    assert [r["name"] for r in results] == [r[0] for r in ROWS[:6]]
    assert all(r["lsb"] == 0 and r["launches"] == {} for r in results)
    assert capsys.readouterr().err.count("OK") == 6
    calls = []

    def flaky(x):
        calls.append(x.device)
        return x + len(calls) * 2

    assert not st.check_rows([("gamma 2.2", flaky, (np.zeros(3, np.int32),))],
                             torch.device("cpu"), False, results)
    assert results[-1]["lsb"] == 2 and results[-1]["budget"] == 0


def test_main_without_cuda_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the selftest runs there")
    assert st.main(["--size", "16x16"]) == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        st.run_selftest((16, 16), 0)
