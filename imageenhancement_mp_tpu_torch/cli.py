"""Command line: ``python -m imageenhancement_mp_tpu_torch.cli <image> --op clahe ...``

The JAX package's demo CLI (its ``cli.py``) on the port: host-side image IO
(cv2/Pillow/.npy, and the native frame loader and writer of ``io/`` for a
batch), one op or a pipeline of ops on the chosen device, save the result.
The same ``--op`` grammar, defaults, messages and exit codes.  ``--device``
(default ``cuda``) picks the device; without a CUDA device the CLI exits 2
unless it is given ``--device cpu``.  A frame goes to the device once and
comes back once, before it is saved.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# a batch run's stages, the keys of main's ``stage_seconds``: waiting on the
# loader's prefetch, H2D, the ops (synchronised), D2H, queueing on the
# writer and its final flush
STAGES = ("decode", "h2d", "device", "d2h", "encode")


def _load(path: str) -> tuple[np.ndarray, bool]:
    """Load an image; returns ``(array, rgb_order)`` where ``rgb_order``
    records the channel order the backend produced (cv2 -> BGR, PIL -> RGB,
    .npy -> treated as RGB) so _save can write colors correctly."""
    if path.endswith(".npy"):
        return np.load(path), True
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img, False
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(
                "error: reading non-.npy images needs opencv-python or Pillow "
                "(pip install 'imageenhancement-mp-tpu[io]')"
            )
        return np.asarray(Image.open(path)), True


def _save(path: str, img: np.ndarray, rgb_order: bool = False) -> None:
    """Write an image; ``rgb_order`` says color channels are R,G,B (the
    native FrameLoader convention) rather than cv2's B,G,R."""
    if path.endswith(".npy"):
        np.save(path, img)
        return
    try:
        import cv2

        if rgb_order and img.ndim == 3 and img.shape[-1] >= 3:
            img = np.ascontiguousarray(img[..., ::-1])  # cv2.imwrite expects BGR
        cv2.imwrite(path, img)
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(
                "error: writing non-.npy images needs opencv-python or Pillow "
                "(pip install 'imageenhancement-mp-tpu[io]')"
            )
        if not rgb_order and img.ndim == 3 and img.shape[-1] >= 3:
            img = np.ascontiguousarray(img[..., ::-1])  # PIL expects RGB
        Image.fromarray(img).save(path)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # contiguous and writable first: torch.from_numpy takes no negative
    # strides, and a CPU tensor shares the array's memory
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _apply_ops(ie, out: torch.Tensor, specs, rgb_order: bool = True) -> torch.Tensor:
    """Apply a spec list to one tensor, on its device; returns the result
    there or raises ValueError.

    ``rgb_order`` records the loaded channel order so ``gray`` converts
    with the right coefficients (cv2-loaded frames are BGR)."""
    for spec in specs:
        name, _, rest = spec.partition(":")
        ps = rest.split(":") if rest else []
        if name == "gray":
            if out.dim() < 3 or out.shape[-1] not in (3, 4):
                raise ValueError("gray needs a color image (C=3|4)")
            out = ie.cvt_gray(out, "rgb" if rgb_order else "bgr")
        elif name == "eqluma":
            if out.dim() < 3 or out.shape[-1] != 3:
                raise ValueError("eqluma needs a color image (C=3)")
            out = ie.equalize_luma(out, "rgb" if rgb_order else "bgr")
        elif name == "gamma":
            out = ie.gamma(out, float(ps[0]) if ps else 2.2)
        elif name == "log":
            out = ie.log_transform(out)
        elif name == "stretch":
            out = ie.contrast_stretch(out)
        elif name == "histeq":
            out = ie.equalize_hist(out)
        elif name == "clahe":
            clip = float(ps[0]) if ps else 40.0
            grid = (int(ps[1]), int(ps[2])) if len(ps) >= 3 else (8, 8)
            out = ie.clahe(out, clip, grid)
        elif name == "gauss":
            out = ie.gaussian_blur(out, int(ps[0]) if ps else 5, float(ps[1]) if len(ps) > 1 else 0.0)
        elif name == "lapsharp":
            out = ie.laplacian_sharpen(out)
        elif name == "unsharp":
            out = ie.unsharp_mask(out, float(ps[0]) if ps else 1.0, int(ps[1]) if len(ps) > 1 else 5)
        elif name == "median":
            out = ie.median_blur(out, int(ps[0]) if ps else 3)
        elif name == "box":
            out = ie.box_blur(out, int(ps[0]) if ps else 3)
        elif name == "thresh":
            _, out = ie.threshold(
                out, float(ps[0]) if ps else 127.0,
                float(ps[1]) if len(ps) > 1 else 255.0,
                ps[2] if len(ps) > 2 else "binary",
            )
        elif name == "sharpen2d":
            # the classic 5-point sharpening mask via the generic filter2d
            out = ie.filter2d(out, ((0, -1, 0), (-1, 5, -1), (0, -1, 0)))
        elif name == "flip":
            out = ie.flip(out, int(ps[0]) if ps else 1)
        elif name == "rotate":
            out = ie.rotate(out, ps[0] if ps else "90cw")
        elif name == "canny":
            out = ie.canny(out, float(ps[0]) if ps else 50.0,
                           float(ps[1]) if len(ps) > 1 else 150.0)
        elif name == "warprot":
            # warprot:angle[:scale] — rotate about the center via warpAffine
            # (linear: the JAX CLI's branch that would read an interpolation
            # never runs)
            ang = float(ps[0]) if ps else 15.0
            sc = float(ps[1]) if len(ps) > 1 else 1.0
            h, w = out.shape[0], out.shape[1]
            M = ie.get_rotation_matrix_2d((w / 2, h / 2), ang, sc)
            out = ie.warp_affine(out, M, (h, w))
        elif name == "resize":
            if len(ps) < 2:
                raise ValueError("resize needs resize:H:W[:interp]")
            out = ie.resize(out, (int(ps[0]), int(ps[1])),
                            ps[2] if len(ps) > 2 else "linear")
        elif name == "pyrdown":
            out = ie.pyr_down(out)
        elif name == "epf":
            out = ie.edge_preserving_filter(
                out, ps[0] if ps else "recursive",
                float(ps[1]) if len(ps) > 1 else 60.0,
                float(ps[2]) if len(ps) > 2 else 0.4)
        elif name == "detail":
            out = ie.detail_enhance(out,
                                    float(ps[0]) if ps else 10.0,
                                    float(ps[1]) if len(ps) > 1 else 0.15)
        elif name == "stylize":
            out = ie.stylization(out,
                                 float(ps[0]) if ps else 60.0,
                                 float(ps[1]) if len(ps) > 1 else 0.45)
        elif name == "pencil":
            g, c = ie.pencil_sketch(out,
                                    float(ps[0]) if ps else 60.0,
                                    float(ps[1]) if len(ps) > 1 else 0.07,
                                    float(ps[2]) if len(ps) > 2 else 0.02)
            out = c if len(ps) > 3 and ps[3] == "color" else g
        elif name == "nlmeans":
            out = ie.fast_nl_means_denoising(
                out, float(ps[0]) if ps else 10.0,
                int(ps[1]) if len(ps) > 1 else 7,
                int(ps[2]) if len(ps) > 2 else 21)
        elif name == "warppolar":
            h, w = out.shape[0], out.shape[1]
            out = ie.warp_polar(
                out, (int(ps[0]) if ps else w, int(ps[1]) if len(ps) > 1 else h),
                (w / 2, h / 2),
                float(ps[2]) if len(ps) > 2 else min(h, w) / 2)
        elif name == "tonemap":
            # HDR display map on a u8 frame treated as radiance; the scale
            # to [0, 1] and the quantisation back run in NumPy on the host,
            # as the JAX CLI runs them (a CUDA tensor divided by a Python
            # float is a reciprocal times the tensor: two roundings)
            host = out.cpu().numpy()
            hdr = (host.astype("float32") / 255.0) if host.dtype != "float32" else host
            which = ps[0] if ps else "drago"
            if which == "reinhard":
                t = ie.tonemap_reinhard(_to_device(hdr, out.device),
                                        float(ps[1]) if len(ps) > 1 else 1.0)
            else:
                t = ie.tonemap_drago(_to_device(hdr, out.device),
                                     float(ps[1]) if len(ps) > 1 else 1.0)
            q = np.clip(np.round(t.cpu().numpy() * 255.0), 0, 255).astype("uint8")
            out = _to_device(q, out.device)
        elif name == "pyrup":
            out = ie.pyr_up(out)
        elif name == "sobel":
            # classic displayable gradient: |Sobel| scaled back to u8
            g = ie.sobel(out, int(ps[0]) if ps else 1,
                         int(ps[1]) if len(ps) > 1 else 0,
                         int(ps[2]) if len(ps) > 2 else 3)
            out = ie.convert_scale_abs(g)
        elif name in ("erode", "dilate", "open", "close", "gradient", "tophat", "blackhat"):
            out = ie.morphology_ex(out, name, int(ps[0]) if ps else 3,
                                   int(ps[1]) if len(ps) > 1 else 1)
        elif name == "athresh":
            out = ie.adaptive_threshold(
                out, 255.0, ps[0] if ps else "mean",
                ps[1] if len(ps) > 1 else "binary",
                int(ps[2]) if len(ps) > 2 else 11,
                float(ps[3]) if len(ps) > 3 else 2.0,
            )
        elif name in ("otsu", "triangle"):
            _, out = ie.threshold(
                out, 0.0, float(ps[0]) if ps else 255.0,
                ps[1] if len(ps) > 1 else "binary", method=name,
            )
        elif name == "bilateral":
            out = ie.bilateral_filter(
                out, int(ps[0]) if ps else 5,
                float(ps[1]) if len(ps) > 1 else 50.0,
                float(ps[2]) if len(ps) > 2 else 50.0,
            )
        else:
            raise ValueError(f"unknown op {name!r}")
    return out


def _timed(items, stages: dict, key: str):
    """Yield from ``items``, adding the seconds each ``next`` takes to
    ``stages[key]``."""
    it = iter(items)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        stages[key] += time.perf_counter() - t0
        if item is None:
            return
        yield item


def _batch_mode(args, ie, device: torch.device, stages: dict) -> int:
    """Stream many files: native prefetch -> per-frame pipeline on the
    device -> native write-behind into outdir (encode/disk IO overlaps
    device compute on both ends).

    Per-frame decode failures are yielded as FrameError sentinels (not
    raised through the generator), so one corrupt file never aborts the
    rest of the batch; encode/write failures surface the same way from
    the writer's flush().  The seconds of each of :data:`STAGES` are
    added to ``stages``, and the frames written to ``stages["frames"]``.
    """
    from pathlib import Path

    from imageenhancement_mp_tpu_torch.io import FrameError, FrameWriter

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    native_exts = {".pgm", ".ppm", ".png", ".jpg", ".jpeg"}
    use_native = all(Path(p).suffix.lower() in native_exts for p in args.input)
    if use_native:
        from imageenhancement_mp_tpu_torch.io import FrameLoader

        frames = ((f, True) for f in FrameLoader(args.input, threads=4, on_error="sentinel"))
    else:
        from imageenhancement_mp_tpu_torch.io.loader import bounded_map

        def safe_load(path):
            try:
                return _load(path)
            except SystemExit:
                raise  # missing IO backend: not a per-frame condition
            except Exception as e:
                return FrameError(str(path), cause=e), False

        frames = bounded_map(safe_load, args.input, threads=4)
    specs = args.op or ["histeq"]
    for k in STAGES:
        stages.setdefault(k, 0.0)
    n = failed = 0
    writer = None  # created lazily: the first-use g++ build is not free
    try:
        for path, (frame, rgb_order) in zip(args.input, _timed(frames, stages, "decode")):
            if isinstance(frame, FrameError):
                print(f"error: frame decode failed: {frame}", file=sys.stderr)
                failed += 1
                continue
            if frame.dtype not in (np.uint8, np.uint16) or frame.ndim < 2:
                print(f"skipping {path}: unsupported decoded form", file=sys.stderr)
                failed += 1
                continue
            t0 = time.perf_counter()
            x = _to_device(frame, device)
            _sync(device)
            t1 = time.perf_counter()
            try:
                out = _apply_ops(ie, x, specs, rgb_order=rgb_order)
            except (ValueError, TypeError) as e:
                print(f"error: {path}: {e}", file=sys.stderr)
                return 2
            _sync(device)
            t2 = time.perf_counter()
            out = out.cpu().numpy()
            t3 = time.perf_counter()
            stages["h2d"] += t1 - t0
            stages["device"] += t2 - t1
            stages["d2h"] += t3 - t2
            dst = outdir / (Path(path).stem + "_out" + Path(path).suffix)
            if dst.suffix.lower() in native_exts and (
                out.ndim == 2 or (out.ndim == 3 and out.shape[-1] <= 4)
            ):
                # async write-behind; FrameWriter takes RGB(A) order.  A
                # BGR(A) frame swaps only its first three channels — alpha
                # stays in place.
                img = out
                if not rgb_order and out.ndim == 3 and out.shape[-1] >= 3:
                    img = out[..., [2, 1, 0, *range(3, out.shape[-1])]]
                if writer is None:
                    writer = FrameWriter(threads=4)
                writer.save(dst, img)
            else:
                _save(str(dst), out, rgb_order=rgb_order)
            stages["encode"] += time.perf_counter() - t3
            n += 1
    finally:
        t0 = time.perf_counter()
        if writer is not None:
            for err in writer.flush():
                print(f"error: frame write failed: {err}", file=sys.stderr)
                failed += 1
                n -= 1
            writer.close()
        stages["encode"] += time.perf_counter() - t0
        stages["frames"] = stages.get("frames", 0) + n
    print(f"wrote {n} files to {outdir}" + (f" ({failed} failed)" if failed else ""))
    return 0 if n and not failed else (1 if failed else 2)


def _device(name: str) -> torch.device:
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise argparse.ArgumentTypeError(str(e))
    if dev.type not in ("cuda", "cpu"):
        raise argparse.ArgumentTypeError(f"the port runs on cuda or cpu, not {name!r}")
    return dev


def main(argv: list[str] | None = None, stage_seconds: dict | None = None) -> int:
    """The command line; ``stage_seconds``, where given, receives a batch
    run's seconds by stage (:data:`STAGES`) and its frames written."""
    p = argparse.ArgumentParser(
        prog="imageenhancement_mp_tpu_torch",
        description="PyTorch/CUDA image enhancement (demo CLI)",
    )
    p.add_argument(
        "input",
        nargs="+",
        help="input image(s) (.png/.jpg/.pgm/.ppm/.npy); multiple files "
        "stream through the pipeline with prefetch + write-behind",
    )
    p.add_argument(
        "-o",
        "--output",
        default="out.png",
        help="output path (single input) or output directory (multiple)",
    )
    p.add_argument(
        "--op",
        action="append",
        default=None,
        help="op to apply, repeatable to build a pipeline "
        "(gray | eqluma | gamma:2.2 | log | stretch | histeq | clahe[:clip[:gh[:gw]]] | "
        "gauss[:k[:sigma]] | box[:k] | bilateral[:d[:sc[:ss]]] | lapsharp | "
        "unsharp[:amount[:k]] | median[:k] | thresh[:t[:mv[:type]]] | "
        "otsu[:mv[:type]] | triangle[:mv[:type]] | "
        "athresh[:method[:type[:bs[:C]]]] | "
        "erode|dilate|open|close|gradient|tophat|blackhat[:k[:iters]] | "
        "sobel[:dx[:dy[:k]]] | pyrdown | pyrup | sharpen2d | "
        "epf[:flags[:ss[:sr]]] | detail[:ss[:sr]] | stylize[:ss[:sr]] | "
        "pencil[:ss[:sr[:shade[:color]]]] | "
        "nlmeans[:h[:t[:s]]] | warppolar[:dw[:dh[:maxr]]] | "
        "warprot[:deg[:scale]] (linear) | tonemap[:drago|reinhard[:gamma]])",
    )
    p.add_argument(
        "--device",
        type=_device,
        default="cuda",
        help="device to run the ops on: cuda (the default; cuda:N picks a card) or cpu",
    )
    args = p.parse_args(argv)
    device = args.device
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False); "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    import imageenhancement_mp_tpu_torch as ie

    if len(args.input) > 1:
        return _batch_mode(args, ie, device, {} if stage_seconds is None else stage_seconds)

    img, rgb_order = _load(args.input[0])
    if img.dtype not in (np.uint8, np.uint16):
        print(f"error: expected uint8/uint16 input, got {img.dtype}", file=sys.stderr)
        return 2
    try:
        out = _apply_ops(ie, _to_device(img, device), args.op or ["histeq"], rgb_order=rgb_order)
    except (ValueError, TypeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out = out.cpu().numpy()
    _save(args.output, out, rgb_order=rgb_order)
    print(f"wrote {args.output} {out.shape} {out.dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
