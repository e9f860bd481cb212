"""CUDA self-check: run every op on the card against the plain path.

Operational health check for deployments, before serving traffic: the JAX
package's selftest (its ``selftest.py``) on the port.  Each row runs once on
``cuda:0`` and once on CPU copies of the same inputs, where every kernel
wrapper runs its plain PyTorch version, and the card must reproduce the CPU
within the row's budget: 0 LSB for every integer path, and the limits that
``chip_smoke.py`` holds the float paths to (:data:`BUDGETS`).  The rows
are the JAX selftest's, by name and on the same arrays (drawn in its order
from ``np.random.default_rng(seed)``; ``spatial/cfg5`` row-shards config 5
over a 1-device mesh of the run's device), plus rows on a 128x256 image that
reach the conv
kernel's k 3/5/7, runtime and wide instances, ``equalize_unsharp`` and the u8
and u16 CLAHE blends.  The tests hold the plain path to the NumPy oracle.

Run: ``python -m imageenhancement_mp_tpu_torch.selftest [--size HxW] [--seed N]``
Exit code 0 = all rows within budget (``SELFTEST PASS``), 1 = any violation
(``SELFTEST FAIL``), 2 = no CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

WIDE_SIZE = (128, 256)

# card against CPU, max |LSB| (f32 outputs compared as their bits count
# ulps); rows not named here are held at 0
BUDGETS = {
    "match_tpl": 1,       # quantized to 1e-3; chip_smoke: 3e-6 relative
    "luv/inv": 1,         # u8 luv2rgb, chip_smoke phase 9
    "photo/epf_rf": 1,    # the domain-transform filters, phase 14
    "photo/styliz": 1,
    "decolor": 1,         # decolor's gray, phase 14
    "tvl1": 1,            # phase 14
}


def selftest_arrays(size=(128, 131), seed: int = 0) -> dict[str, np.ndarray]:
    """The selftest's inputs: the JAX selftest's draws in its order, then
    the 128x256 ``wide`` images, and the arrays derived without a draw."""
    h, w = size
    rng = np.random.default_rng(seed)
    a = {"img": rng.integers(0, 256, size, dtype=np.uint8),
         "lut": rng.integers(0, 256, 256, dtype=np.uint8)}
    a["img2"] = rng.integers(0, 256, size, dtype=np.uint8)
    a["wblend1"] = (rng.random(size) * 4).astype(np.float32)
    a["wblend2"] = (rng.random(size) * 4).astype(np.float32)
    a["rgb"] = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    a["img16"] = rng.integers(0, 65536, size, dtype=np.uint16)
    a["imgs16"] = rng.integers(-32768, 32768, size, dtype=np.int16)
    a["vid"] = rng.integers(0, 256, (3, *size, 2), dtype=np.uint8)
    a["sp_cs"] = np.stack([rng.uniform(4, w - 5, 12),
                           rng.uniform(4, h - 5, 12)], axis=1).astype(np.float32)
    a["sp_f"] = (rng.random(size) * 255).astype(np.float32)
    a["lk_pts"] = np.stack([rng.uniform(12, w - 13, 8),
                            rng.uniform(12, h - 13, 8)], 1).astype(np.float32)
    a["wide"] = rng.integers(0, 256, WIDE_SIZE, dtype=np.uint8)
    a["wide16"] = rng.integers(0, 65536, WIDE_SIZE, dtype=np.uint16)
    a["lk_next"] = np.roll(a["img"], (2, -1), (0, 1))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a["swirl_x"] = (xx + 3.0 * np.sin(yy / 7.0)).astype(np.float32)
    a["swirl_y"] = (yy + 2.0 * np.cos(xx / 9.0)).astype(np.float32)
    return a


def _bits(t) -> torch.Tensor:
    """An f32 output's bit patterns as int32 (a budget then counts ulps)."""
    if isinstance(t, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(t).view(np.int32))
    return t.contiguous().view(torch.int32)


def _quant_mt(r: torch.Tensor) -> torch.Tensor:
    # quantize the f32 response to 1e-3 so the LSB check applies
    return torch.round(r * 1000).to(torch.int32)


def selftest_rows(size=(128, 131), seed: int = 0) -> list:
    """``(name, fn, inputs)`` rows: ``fn`` takes the NumPy ``inputs`` as
    tensors on one device and returns a tensor, an array or a tuple of
    them, integer-valued (f32 outputs through their bits)."""
    import imageenhancement_mp_tpu_torch as ie

    a = selftest_arrays(size, seed)
    h, w = size
    img, img2, rgb = a["img"], a["img2"], a["rgb"]
    img16, imgs16 = a["img16"], a["imgs16"]
    mh, mw = min(40, h), min(44, w)  # temporal-NLMeans crop
    u8 = torch.uint8
    sharpen = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
    rot30 = ie.get_rotation_matrix_2d((w / 2, h / 2), 30.0, 0.9)
    rot20 = ie.get_rotation_matrix_2d((w / 2, h / 2), 20.0, 1.1)
    rot25 = ie.get_rotation_matrix_2d((w / 2, h / 2), -25.0, 0.95)
    persp = ie.get_perspective_transform(
        [(0, 0), (w - 1.0, 0), (w - 1.0, h - 1.0), (0, h - 1.0)],
        [(3.5, 2.0), (w - 5.0, 4.5), (w - 2.0, h - 3.0), (1.0, h - 6.5)])
    swirl = (img, a["swirl_x"], a["swirl_y"])

    def spatial_cfg5(x):
        """Config 5 row-sharded on a 1-device mesh: the halo self-border,
        the psum and all_gather and the sharded call, end to end."""
        from imageenhancement_mp_tpu_torch.parallel.mesh import Mesh
        from imageenhancement_mp_tpu_torch.parallel.spatial import make_spatial_pipeline

        pipe = make_spatial_pipeline([("median_blur", {"ksize": 3}),
                                      ("clahe", {"clip_limit": 2.0, "tile_grid": (4, 4)}),
                                      ("unsharp_mask", {"amount": 1.0})], Mesh([x.device], ("y",)))
        return pipe(x[: h - h % 4, : w - w % 4][None])[0]

    def crop(c):
        return c[:mh, :mw].contiguous()

    def pencil(c):
        g, col = ie.pencil_sketch(crop(c))
        return torch.cat([g[..., None], col], -1)

    def nlm_multi(x, y):
        return ie.fast_nl_means_denoising_multi(
            torch.stack([x[:mh, :mw], y[:mh, :mw], x[h - mh:, w - mw:]]), 1, 3, 15.0, 3, 9)

    def lk(x, nxt, pts):
        p, s, e = ie.calc_optical_flow_pyr_lk(x, nxt, pts, (11, 11), 2)
        # err is defined only where status is 1
        return _bits(p).reshape(-1), s.to(torch.int32), torch.where(s == 1, _bits(e), 0)

    rows = [
        ("apply_lut", lambda x, lut: ie.apply_lut(x, lut), (img, a["lut"])),
        ("gamma 2.2", lambda x: ie.gamma(x, 2.2), (img,)),
        ("log", ie.log_transform, (img,)),
        ("stretch", ie.contrast_stretch, (img,)),
        ("scale_abs", lambda x: ie.convert_scale_abs(x, 1.3, -7.0), (img,)),
        ("histogram", ie.histogram, (img,)),
        ("equalize", ie.equalize_hist, (img,)),
        ("clahe", lambda x: ie.clahe(x, 2.0, (8, 8)), (img,)),
        ("gauss5", lambda x: ie.gaussian_blur(x, 5), (img,)),
        ("gauss5/s1.5", lambda x: ie.gaussian_blur(x, 5, 1.5), (img,)),
        ("laplacian", ie.laplacian, (img,)),
        ("lap_sharpen", ie.laplacian_sharpen, (img,)),
        ("unsharp", lambda x: ie.unsharp_mask(x, 1.0), (img,)),
        ("median3", lambda x: ie.median_blur(x, 3), (img,)),
        ("median5", lambda x: ie.median_blur(x, 5), (img,)),
        ("add_weighted", lambda x, y: ie.add_weighted(x, 1.7, y, -0.6, 41.25), (img, img2)),
        ("cvt_gray", ie.cvt_gray, (rgb,)),
        ("box5", lambda x: ie.box_blur(x, 5), (img,)),
        ("bilateral", lambda x: ie.bilateral_filter(x, 5, 30.0, 6.0), (img,)),
        ("thresh/otsu", lambda x: ie.threshold(x, method="otsu")[1], (img,)),
        ("eq_luma", ie.equalize_luma, (rgb,)),
        ("athresh/gauss",
         lambda x: ie.adaptive_threshold(x, 255.0, "gaussian", "binary", 11, 2.0), (img,)),
        ("morph/open", lambda x: ie.morphology_ex(x, "open", (3, 5)), (img,)),
        ("sobel5", lambda x: ie.sobel(x, 1, 1, 5), (img,)),
        ("hsv/fwd", lambda c: ie.cvt_color(c, "rgb2hsv"), (rgb,)),
        ("hsv/inv", lambda c: ie.cvt_color(ie.cvt_color(c, "rgb2hsv"), "hsv2rgb"), (rgb,)),
        ("lab/fwd", lambda c: ie.cvt_color(c, "rgb2lab"), (rgb,)),
        ("lab/inv", lambda c: ie.cvt_color(ie.cvt_color(c, "rgb2lab"), "lab2rgb"), (rgb,)),
        ("xyz/fwd", lambda c: ie.cvt_color(c, "rgb2xyz"), (rgb,)),
        ("clahe_lab", lambda c: ie.clahe_lab(c, 2.0, (4, 4)), (rgb,)),
        ("pyr_down", ie.pyr_down, (img,)),
        ("pyr_up", ie.pyr_up, (img,)),
        ("filter2d", lambda x: ie.filter2d(x, sharpen), (img,)),
        ("resize/lin", lambda x: ie.resize(x, (h * 3 // 4, w * 5 // 7)), (img,)),
        ("resize/area", lambda x: ie.resize(x, (h * 3 // 7, w * 2 // 5), "area"), (img,)),
        ("resize/cubic", lambda x: ie.resize(x, (h * 5 // 8, w * 9 // 7), "cubic"), (img,)),
        ("rotate90", lambda x: ie.rotate(x, "90cw"), (img,)),
        ("canny", lambda x: ie.canny(x, 60.0, 160.0), (img,)),
        ("nlmeans", lambda x: ie.fast_nl_means_denoising(x, 12.0, 5, 9), (img,)),
        ("remap", ie.remap, swirl),
        ("remap/cubic", lambda x, mx, my: ie.remap(x, mx, my, "cubic"), swirl),
        ("remap/lancz", lambda x, mx, my: ie.remap(x, mx, my, "lanczos4"), swirl),
        ("match_tpl",
         lambda x, y: _quant_mt(ie.match_template(x, y[:7, :9], "ccoeff_normed")), (img, img2)),
        ("warp/rot30", lambda x: ie.warp_affine(x, rot30, size), (img,)),
        ("warp/cubic", lambda x: ie.warp_affine(x, rot20, size, "cubic"), (img,)),
        ("warp/pcubic", lambda x: ie.warp_perspective(x, persp, size, "cubic"), (img,)),
        ("warp/lancz", lambda x: ie.warp_affine(x, rot25, size, "lanczos4"), (img,)),
        ("warp/persp", lambda x: ie.warp_perspective(x, persp, size), (img,)),
        ("luv/fwd", lambda c: ie.cvt_color(c, "rgb2luv"), (rgb,)),
        ("luv/inv", lambda c: ie.cvt_color(ie.cvt_color(c, "rgb2luv"), "luv2rgb"), (rgb,)),
        ("hls/fwd", lambda c: ie.cvt_color(c, "rgb2hls"), (rgb,)),
        ("hls/inv", lambda c: ie.cvt_color(ie.cvt_color(c, "rgb2hls"), "hls2rgb"), (rgb,)),
        ("resize/lanczos",
         lambda x: ie.resize(x, (h * 5 // 8, w * 9 // 7), "lanczos4"), (img,)),
        ("warp_polar", lambda x: ie.warp_polar(x, (w * 3 // 4, 64), (w / 2, h / 2), 40.0),
         (img,)),
        ("warp_polar/inv", lambda x: ie.warp_polar(x, (w, h), (w / 2, h / 2), 40.0,
                                                   log=True, inverse=True), (img,)),
        ("nlmeans/color", lambda c: ie.fast_nl_means_denoising_colored(
            c[:min(48, h), :min(52, w)].contiguous(), 10.0, 14.0, 3, 9), (rgb,)),
        ("decolor", lambda c: ie.decolor(c)[0], (rgb,)),
        ("tvl1", lambda x, y: ie.denoise_tvl1([x, y], 1.0, 20), (img, img2)),
        ("nlmeans/u16", lambda x: ie.fast_nl_means_denoising(
            (x.to(torch.int32) * 257).to(torch.uint16), 900.0, 5, 9, norm_type="l1"), (img,)),
        ("nlmeans/multi", nlm_multi, (img, img2)),
        ("photo/epf_rf",
         lambda c: ie.edge_preserving_filter(crop(c), "recursive", 55.0, 0.35), (rgb,)),
        ("photo/styliz", lambda c: ie.stylization(crop(c), 60.0, 0.45), (rgb,)),
        ("photo/pencil", pencil, (rgb,)),
        ("spatgrad", lambda x: torch.stack(ie.spatial_gradient(x)), (img,)),
        ("sqr_box5", lambda x: _bits(ie.sqr_box_filter(x, 5)), (img,)),
        ("blend/u8", ie.blend_linear, (img, img2, a["wblend1"], a["wblend2"])),
        ("blend/f32", lambda x, y, w1, w2: _bits(ie.blend_linear(
            x.to(torch.float32), y.to(torch.float32), w1, w2)),
         (img, img2, a["wblend1"], a["wblend2"])),
        ("dist/l2m3", lambda x: _bits(ie.distance_transform((x > 12).to(u8), "l2", 3)), (img,)),
        ("dist/l1u8", lambda x: ie.distance_transform((x > 12).to(u8), "l1", dst_type="u8"),
         (img,)),
        ("floodfill", lambda x: ie.flood_fill(x, (w // 2, h // 2), 200, 35, 35)[1], (img,)),
        # corner features: the selected corners' integer pixel coordinates
        ("goodfeats", lambda x: ie.good_features_to_track(x, 25, 0.05, 7.0), (img,)),
        ("houghlines", lambda x: _bits(ie.hough_lines(
            (x > 200).to(u8) * 255, 1.0, np.pi / 180, 12)), (img,)),
        ("gauss5/u16", lambda x: ie.gaussian_blur(x, 5), (img16,)),
        ("gauss13/u16/s2", lambda x: ie.gaussian_blur(x, 13, 2.0), (img16,)),
        ("median3/u16", lambda x: ie.median_blur(x, 3), (img16,)),
        ("median5/u16", lambda x: ie.median_blur(x, 5), (img16,)),
        ("clahe/u16", lambda x: ie.clahe(x, 2.0, (4, 4)), (img16,)),
        ("unsharp/u16", lambda x: ie.unsharp_mask(x, 1.0), (img16,)),
        ("median5/i16", lambda x: ie.median_blur(x, 5), (imgs16,)),
        ("stretch/i16", lambda x: ie.contrast_stretch(x, (-20.5, 512.0)), (imgs16,)),
        ("gauss5/i16", lambda x: ie.gaussian_blur(x, 5), (imgs16,)),
        ("lap_sharp/i16", ie.laplacian_sharpen, (imgs16,)),
        ("spatial/cfg5", spatial_cfg5, (img,)),
        # pooled (video-mode) equalization: per-channel LUTs across frames
        ("equalize/pool", lambda v: ie.equalize_hist(v, per_frame=False), (a["vid"],)),
        ("subpix/u8", lambda x, cs: ie.get_rect_sub_pix(x, (5, 4), cs), (img, a["sp_cs"])),
        ("subpix/u8rgb", lambda c, cs: ie.get_rect_sub_pix(c, (5, 4), cs), (rgb, a["sp_cs"])),
        ("subpix/f32", lambda f, cs: _bits(ie.get_rect_sub_pix(f, (5, 4), cs)),
         (a["sp_f"], a["sp_cs"])),
        ("lk/track", lk, (img, a["lk_next"], a["lk_pts"])),
        ("meanshift/pyr", lambda c: ie.pyr_mean_shift_filtering(c, 3.0, 20.0, 1), (rgb,)),
        # the 128x256 rows: the conv kernel's k 3, 5 and 7 instances, its
        # runtime one (ksize 15) and its wide one (37 taps at sigma 6, 33
        # after trimming), equalize_unsharp, and the u8 and u16 CLAHE blends
        ("wide/gauss3", lambda x: ie.gaussian_blur(x, 3), (a["wide"],)),
        ("wide/gauss5", lambda x: ie.gaussian_blur(x, 5), (a["wide"],)),
        ("wide/gauss7", lambda x: ie.gaussian_blur(x, 7), (a["wide"],)),
        ("wide/gauss15", lambda x: ie.gaussian_blur(x, 15), (a["wide"],)),
        ("wide/gauss37/s6", lambda x: ie.gaussian_blur(x, 37, 6.0), (a["wide"],)),
        ("wide/eq_unsharp", ie.equalize_unsharp, (a["wide"],)),
        ("wide/clahe", lambda x: ie.clahe(x, 2.0, (8, 8)), (a["wide"],)),
        ("wide/clahe/u16", lambda x: ie.clahe(x, 2.0, (8, 8)), (a["wide16"],)),
    ]
    return rows


def as_lsb(out) -> np.ndarray:
    """A row's output as one int64 array on the host."""
    if isinstance(out, (tuple, list)):
        return np.concatenate([as_lsb(o).ravel() for o in out])
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return np.asarray(out).astype(np.int64)


def max_lsb(got: np.ndarray, want: np.ndarray) -> int | None:
    """max |got − want|, or None where the shapes differ."""
    if got.shape != want.shape:
        return None
    return int(np.abs(got - want).max()) if got.size else 0


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def check_rows(rows, device: torch.device, verbose: bool = True,
               results: list | None = None) -> bool:
    """Run each ``(name, fn, inputs)`` row on ``device`` with the launch
    counters at 0 just before, then on CPU copies of its inputs; True when
    each row is within its budget.  ``results``, where given, receives one
    dict a row: name, max LSB (None where the shapes differ), budget, the
    kernel launches of the run on ``device`` and its seconds."""
    from imageenhancement_mp_tpu_torch.kernels import launch_counts, reset_launch_counts

    cpu = torch.device("cpu")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ok = True
    for name, fn, inputs in rows:
        budget = BUDGETS.get(name, 0)
        g = [_on(x, device) for x in inputs]
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = as_lsb(fn(*g))
        seconds = time.perf_counter() - t0
        launches = {k: c for k, c in launch_counts.items() if c}
        want = as_lsb(fn(*[_on(x, cpu) for x in inputs]))
        lsb = max_lsb(got, want)
        passed = lsb is not None and lsb <= budget
        ok &= passed
        if results is not None:
            results.append({"name": name, "lsb": lsb, "budget": budget,
                            "launches": launches, "seconds": seconds})
        if verbose:
            shown = f"max-LSB={lsb}" if lsb is not None else (
                f"shape {got.shape} against {want.shape}")
            kernels = " ".join(f"{k}={c}" for k, c in launches.items())
            print(f"  {name:16s} {shown} (budget {budget}) {'OK' if passed else 'FAIL'}"
                  + (f"  [{kernels}]" if kernels else ""), file=sys.stderr)
    return ok


def run_selftest(size=(128, 131), seed: int = 0, verbose: bool = True,
                 results: list | None = None) -> bool:
    """Every row on ``cuda:0`` against the CPU (:func:`check_rows`); True
    when each is within its budget.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the selftest checks a CUDA card; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    if verbose:
        print(f"selftest on {torch.cuda.get_device_name(dev)} (cuda), image {size}, "
              f"wide rows {WIDE_SIZE}", file=sys.stderr)
    return check_rows(selftest_rows(size, seed), dev, verbose, results)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="imageenhancement_mp_tpu_torch.selftest")
    ap.add_argument("--size", default="128x131")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the selftest checks a CUDA card, and torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    h, w = (int(v) for v in args.size.split("x"))
    ok = run_selftest((h, w), args.seed)
    print("SELFTEST PASS" if ok else "SELFTEST FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
