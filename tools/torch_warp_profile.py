#!/usr/bin/env python3
"""The warp kernel (K11 warp_gather_u8) and the CLAHE blend (K7/K8
clahe_blend) of the port, and the calls they serve, on one CUDA card: trees
timed in turns, then each tree profiled.

    git archive HEAD imageenhancement_mp_tpu_torch | tar -x -C build/parent
    python3 tools/torch_warp_profile.py [--parent build/parent] [--tree LABEL=PATH ...]
    python3 tools/torch_warp_profile.py --ab

Each tree (the parent under ``--parent``, any ``--tree``, this checkout) is
timed in a process of its own, in the order parent, trees, this, then back
(parent, this, this, parent for two), on 2x2160x3840 from numpy seed 60:
warp_gather_u8 on the maps route (the rot15 field, cached polar maps,
random maps) and, where the tree has it, on the matrix route (rot15 linear
and nearest, a homography); clahe_blend u8 and u16 (grid 8x8, clip 2);
warp_affine rot15, warp_perspective, warp_polar (cached maps), remap
(random maps), config 5 (get_preset("denoise_clahe_sharpen")), clahe on
1x2160x3840x3 (config 4) and clahe_lab 1x2160x3840x3.  Each is the median of
20 runs of 10 calls between CUDA events, back to back and device-paced (a
sleep kernel holds the device while the host enqueues the run, so the events
see the kernels alone).  Then, for each tree, warp_affine rot15,
warp_perspective and config 5 under torch.profiler: device time per call by
kernel, the device's busy share, the host's enqueue time per call.

``--ab`` instead times this checkout against copies of it under
``build/warp_ab/`` with one design choice changed each (AB_VARIANTS, text
edits of ``csrc/warp.cu``, ``csrc/clahe.cu`` and ``kernels/clahe.py``; only
``hist.cu``, ``warp.cu`` and ``clahe.cu`` are built in the copies), in turns:
K11's matrix route (rot15 linear and nearest, the identity) and maps route
(random maps), and clahe_blend u8, device-paced.  Two copies take out the
tap loads or the coordinate arithmetic (their outputs are wrong: they
measure what remains), the others keep the result, which each holds to the
plain version first.  Every line carries the card's name and power limit.
Exits non-zero when torch sees no CUDA device.
"""
import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "imageenhancement_mp_tpu_torch"
CALLS, RUNS = 10, 20
SLEEP_CYCLES = 4_000_000  # about 2 ms at 1.98 GHz: longer than the host's enqueue of CALLS calls


_W, _C, _CP = "kernels/csrc/warp.cu", "kernels/csrc/clahe.cu", "kernels/clahe.py"
_NO_TAP_LOADS = (_W, """      t[k][0] = __ldg(p);
      if (!kNearest) {
        t[k][1] = __ldg(p + 1);
        t[k][2] = __ldg(p + g.W);
        t[k][3] = __ldg(p + g.W + 1);
      }""", """      t[k][0] = uint32_t(reinterpret_cast<uintptr_t>(p)) & 255u;
      if (!kNearest) {
        t[k][1] = (t[k][0] + 1) & 255u;
        t[k][2] = (t[k][0] + 7) & 255u;
        t[k][3] = (t[k][0] + 9) & 255u;
      }""")
_NO_COORDS = (_W, """          X = clip_coord(X);
          Y = clip_coord(Y);""", """          X = clip_coord(float(col) + 0.25f);
          Y = clip_coord(float(row) + 0.75f);""")
_MATRIX_LAYOUT = """  static constexpr int kLX = kSource == kMaps ? 32 : 16;
  static constexpr int kPx = kSource == kMaps ? 1 : 4;
  static constexpr int kMinBlocks = kSource == kMaps ? 6 : 3;  // 40 / 80 registers"""
# label -> (edits, result kept): one design choice changed in each
AB_VARIANTS = {
    "K11 without tap loads": ([_NO_TAP_LOADS], False),
    "K11 without coordinate arithmetic": ([_NO_COORDS], False),
    "K11 without either": ([_NO_TAP_LOADS, _NO_COORDS], False),
    "K11 matrix route, lanes 8 x 4": (
        [(_W, _MATRIX_LAYOUT, _MATRIX_LAYOUT.replace(": 16;", ": 8;"))], True),
    "K11 matrix route, the maps route's layout (32 x 1, one pixel)": (
        [(_W, _MATRIX_LAYOUT, _MATRIX_LAYOUT.replace(": 16;", ": 32;").replace(": 4;", ": 1;")
          .replace(": 3;", ": 6;"))], True),
    "K11 maps route, the matrix route's layout (16 x 2, four pixels)": (
        [(_W, _MATRIX_LAYOUT, _MATRIX_LAYOUT.replace("? 32 :", "? 16 :").replace("? 1 :", "? 4 :")
          .replace("? 6 :", "? 3 :"))], True),
    "clahe_blend u8, 64 registers": ([(_C, "kBlendMinBlocks = 4;", "kBlendMinBlocks = 8;")], True),
    "clahe_blend u8, 2 rows ahead": ([(_C, "kRowsAhead = 4;", "kRowsAhead = 2;")], True),
    "clahe_blend u8, 8-row bands": ([(_CP, "16, 1024, 16, 16", "16, 1024, 16, 8")], True),
}


def ab_tree(label: str, edits) -> Path:
    """This checkout's package under build/warp_ab/ with ``edits`` applied,
    building only hist.cu, warp.cu and clahe.cu."""
    out = ROOT / "build" / "warp_ab" / re.sub(r"\W+", "_", label).strip("_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / PKG, out / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for src in (out / PKG / "kernels" / "csrc").glob("*.cu"):
        if src.name not in ("hist.cu", "warp.cu", "clahe.cu"):
            src.unlink()
    edits = list(edits) + [("kernels/_build.py", "        fn = getattr(lib, name)\n",
                            "        fn = getattr(lib, name, None)\n        if fn is None:\n"
                            "            continue\n")]
    for rel, old, new in edits:
        path = out / PKG / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"torch_warp_profile: --ab cannot patch {rel} for {label!r}")
        path.write_text(text.replace(old, new))
    return out


def measure_ab(root: Path, check: bool) -> dict:
    """Device-paced times of the A/B cases in the tree under ``root`` (ms),
    each held to its plain version first where ``check``."""
    np, torch, port = _setup(root)
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import warp as kw
    from imageenhancement_mp_tpu_torch.ops import clahe as tc
    from imageenhancement_mp_tpu_torch.utils import warp_coords as wc

    dev = torch.device("cuda", 0)
    g4 = torch.from_numpy(np.random.default_rng(60).integers(0, 256, (2, 2160, 3840),
                                                             dtype=np.uint8)).to(dev)
    Mi15 = wc.invert_affine(wc.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0))
    eye = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    gen = torch.Generator(device=dev).manual_seed(0)
    mx = (torch.rand((2160, 3840), generator=gen, device=dev) * 3844 - 2).contiguous()
    my = (torch.rand((2160, 3840), generator=gen, device=dev) * 2164 - 2).contiguous()
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    tabs = (*tc._coord_tables(2160, geo[2], geo[0], dev),
            *tc._coord_tables(3840, geo[3], geo[1], dev))
    l8 = kc.clahe_lut(kc.hist256_tiles(g4, *geo), geo[2] * geo[3], 2.0)
    cases = {
        "K11 matrix, rot15": (lambda: kw.warp_matrix_u8(g4, Mi15, 2160, 3840),
                              lambda: kw.warp_matrix_u8_plain(g4, Mi15, 2160, 3840)),
        "K11 matrix, rot15 nearest": (lambda: kw.warp_matrix_u8(g4, Mi15, 2160, 3840, False, True),
                                      lambda: kw.warp_matrix_u8_plain(g4, Mi15, 2160, 3840, False,
                                                                      True)),
        "K11 matrix, identity": (lambda: kw.warp_matrix_u8(g4, eye, 2160, 3840),
                                 lambda: g4),
        "K11 maps, random": (lambda: kw.warp_gather_u8(g4, mx, my),
                             lambda: kw.warp_gather_u8_plain(g4, mx, my)),
        "clahe_blend u8 8x8": (lambda: kc.clahe_blend(g4, l8, 8, 8, *tabs),
                               lambda: kc.clahe_blend_plain(g4, l8, 8, 8, *tabs)),
    }
    out = {}
    for name, (fn, plain) in cases.items():
        if check and not torch.equal(fn(), plain()):
            raise SystemExit(f"torch_warp_profile: {name} differs from its plain version in {root}")
        for _ in range(3):
            fn()
        times = []
        for _ in range(RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        out[name] = statistics.median(times)
    return out


def _setup(root: Path):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import imageenhancement_mp_tpu_torch as port

    assert Path(port.__file__).resolve().parent == root / PKG
    return np, torch, port


def _cases(np, torch, port) -> dict:
    """name -> call, on this tree's package; the matrix route only where the
    tree has it."""
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import warp as kw
    from imageenhancement_mp_tpu_torch.ops import clahe as tc
    from imageenhancement_mp_tpu_torch.ops import warp as tw
    from imageenhancement_mp_tpu_torch.utils import warp_coords as wc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(60)
    g4 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    g16 = torch.from_numpy(rng.integers(0, 65536, (2, 2160, 3840)).astype(np.uint16)).to(dev)
    rgb = torch.from_numpy(rng.integers(0, 256, (1, 2160, 3840, 3), dtype=np.uint8)).to(dev)
    M15 = wc.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0)
    Mi15 = wc.invert_affine(M15)
    Hp = np.array([[1.0, 0.05, -5.0], [0.02, 0.98, 3.0], [2e-4, 1e-4, 1.0]])
    Mp = wc.invert_perspective(Hp)
    gen = torch.Generator(device=dev).manual_seed(0)
    mx = (torch.rand((2160, 3840), generator=gen, device=dev) * 3844 - 2).contiguous()
    my = (torch.rand((2160, 3840), generator=gen, device=dev) * 2164 - 2).contiguous()
    f15 = tw.affine_field(Mi15, 2160, 3840, dev)
    polar = ((1920, 2160), (1920.0, 1080.0), 1900.0)
    pm = tw.polar_maps(2160, 3840, *polar, False, False, dev)
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    tabs = (*tc._coord_tables(2160, geo[2], geo[0], dev), *tc._coord_tables(3840, geo[3], geo[1], dev))
    l8 = kc.clahe_lut(kc.hist256_tiles(g4, *geo), geo[2] * geo[3], 2.0)
    l16 = kc.clahe_lut(kc.tile_hists_plain(g16, *geo), geo[2] * geo[3], 2.0)
    cfg5 = port.get_preset("denoise_clahe_sharpen")
    cases = {
        "K11 maps, rot15 field": lambda: kw.warp_gather_u8(g4, *f15),
        "K11 maps, polar": lambda: kw.warp_gather_u8(g4, *pm),
        "K11 maps, random": lambda: kw.warp_gather_u8(g4, mx, my),
    }
    if hasattr(kw, "warp_matrix_u8"):
        cases.update({
            "K11 matrix, rot15": lambda: kw.warp_matrix_u8(g4, Mi15, 2160, 3840),
            "K11 matrix, rot15 nearest": lambda: kw.warp_matrix_u8(g4, Mi15, 2160, 3840, False,
                                                                   True),
            "K11 matrix, homography": lambda: kw.warp_matrix_u8(g4, Mp, 2160, 3840, True),
        })
    cases.update({
        "clahe_blend u8 8x8": lambda: kc.clahe_blend(g4, l8, 8, 8, *tabs),
        "clahe_blend u16 8x8": lambda: kc.clahe_blend(g16, l16, 8, 8, *tabs),
        "warp_affine rot15": lambda: port.warp_affine(g4, M15, (2160, 3840)),
        "warp_perspective": lambda: port.warp_perspective(g4, Hp, (2160, 3840)),
        "warp_polar, cached maps": lambda: port.warp_polar(g4, *polar),
        "remap, random maps": lambda: port.remap(g4, mx, my),
        "config 5": lambda: cfg5(g4),
        "clahe 1x2160x3840x3 (config 4)": lambda: port.clahe(rgb, 2.0, (8, 8)),
        "clahe_lab 1x2160x3840x3": lambda: port.clahe_lab(rgb, 2.0, (8, 8)),
    })
    return cases


def measure(root: Path) -> dict:
    """Back-to-back and device-paced times of every case in the tree under
    ``root`` (ms)."""
    np, torch, port = _setup(root)

    def time_ms(fn, device_paced: bool) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if device_paced:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        return statistics.median(times)

    out = {}
    for name, fn in _cases(np, torch, port).items():
        out[f"{name}, back to back"] = time_ms(fn, False)
        out[f"{name}, device-paced"] = time_ms(fn, True)
    return out


def profile(root: Path, label: str, smi: str) -> None:
    """torch.profiler split and busy share, and host enqueue time per call."""
    np, torch, port = _setup(root)
    from torch.autograd import DeviceType

    cases = _cases(np, torch, port)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name in ("warp_affine rot15", "warp_perspective", "config 5"):
        fn = cases[name]
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            enqueue.append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels: dict[str, list] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                k = kernels.setdefault(ev.name, [0.0, 0])
                k[0] += ev.time_range.elapsed_us()
                k[1] += 1
        rows = sorted(((t, key, n) for key, (t, n) in kernels.items()), reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"[{label}] {name} 2x2160x3840 u8: host enqueue {statistics.median(enqueue):.1f} us "
              f"per call (median of {RUNS} runs of {CALLS}); under torch.profiler {CALLS} calls: "
              f"wall {wall_us / CALLS:.1f} us per call, device busy {busy / CALLS:.1f} us per call "
              f"({100 * busy / wall_us:.1f} %)  [{smi}]")
        for dt, key, n in rows[:8]:
            print(f"    {dt / CALLS:9.2f} us per call  {100 * dt / busy:5.1f} %  x{n / CALLS:g}  "
                  f"{key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another tree, timed between the parent and this one")
    ap.add_argument("--ab", action="store_true",
                    help="time this checkout against copies with one design choice changed each")
    ap.add_argument("--measure-ab", type=Path, help=argparse.SUPPRESS)  # one A/B tree, in a child
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    ap.add_argument("--inspect", type=Path, help=argparse.SUPPRESS)  # profile, in a child
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    ap.add_argument("--smi", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_warp_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return
    if args.measure_ab:
        print(json.dumps(measure_ab(args.measure_ab.resolve(), args.check)))
        return
    if args.inspect:
        profile(args.inspect.resolve(), args.label, args.smi)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.ab:
        ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits), keep)
                                       for label, (edits, keep) in AB_VARIANTS.items()]
        builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                    "from imageenhancement_mp_tpu_torch.kernels import _build; "
                                    "_build.library()", str(root)]) for _, root, _ in ab]
        if any(b.wait() for b in builds):
            raise SystemExit("torch_warp_profile: a build of the A/B trees failed")
        times: dict[str, list[dict]] = {}
        for label, root, keep in ab + ab[::-1]:
            child = subprocess.run([sys.executable, __file__, "--measure-ab", str(root)]
                                   + (["--check"] if keep else []), check=True,
                                   capture_output=True, text=True)
            times.setdefault(label, []).append(json.loads(child.stdout.strip().splitlines()[-1]))
        for label, rs in times.items():
            print(f"  {label}: " + "; ".join(f"{k} {' / '.join(f'{r[k]:.4f}' for r in rs)}"
                                           for k in rs[0]) + f" ms, device-paced  [{smi}]")
        return
    trees = [("this", ROOT)]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees.insert(-1, (label, Path(path).resolve()))
    if len(trees) > 1:
        trees = trees + trees[::-1]
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__, "--measure", str(root)], check=True,
                               capture_output=True, text=True)
        result = json.loads(child.stdout.strip().splitlines()[-1])
        runs.setdefault(label, []).append(result)
        print(f"{label} ({root}) done", flush=True)
    keys = dict.fromkeys(k for rs in runs.values() for r in rs for k in r)
    for key in keys:
        cells = {label: [r[key] for r in rs if key in r] for label, rs in runs.items()}
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                       for label, ts in cells.items() if ts) + f"  [{smi}]")
    for label, root in dict(trees).items():
        subprocess.run([sys.executable, __file__, "--inspect", str(root), "--label", label,
                        "--smi", smi], check=True)


if __name__ == "__main__":
    main()
