#!/usr/bin/env python3
"""The port's median kernels (K6 median_blur, K14 median_unsharp) and config 5
on one CUDA card: two trees timed in turns, then config 5 under torch.profiler.

    git archive HEAD imageenhancement_mp_tpu_torch | tar -x -C build/parent
    python3 tools/torch_median_profile.py --parent build/parent

Each tree (the parent under ``--parent``, this checkout) is timed in a process
of its own, in the order parent, this, this, parent: median_blur at k 3 and 5
on 2x2160x3840 u8, u16 and i16, median_unsharp(5, 1.0, 5) and the median ->
sep_conv_u8 chain on 2x2160x3840 u8, and config 5
(get_preset("denoise_clahe_sharpen")) on the same input, each the median of 20
runs of 10 back-to-back calls between CUDA events.  Without ``--parent`` only
this tree is timed.  Then this tree's config 5 runs under torch.profiler: the
device time per call by kernel and the device's busy share.  Last, the
SASS opcode histogram of this tree's median kernels (cuobjdump of the built
library): the min/max of the schedule beside the staging, byte permutes and
memory instructions around it.  Exits non-zero when torch sees no CUDA
device.
"""
import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(root: Path) -> dict:
    """Times of the median paths of the package under ``root`` (ms)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.kernels import fused as kfused
    from imageenhancement_mp_tpu_torch.kernels import median as kmedian

    assert Path(port.__file__).resolve().parent == root / "imageenhancement_mp_tpu_torch"
    dev = torch.device("cuda", 0)

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        return statistics.median(times)

    rng = np.random.default_rng(50)
    out = {}
    for dtype in (np.uint8, np.uint16, np.int16):
        info = np.iinfo(dtype)
        g = torch.from_numpy(rng.integers(info.min, info.max + 1, (2, 2160, 3840)).astype(dtype))
        g = g.to(dev)
        for k in (3, 5):
            out[f"median_blur({k}) {dtype.__name__}"] = time_ms(lambda: kmedian.median_blur(g, k))
    g = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    taps = kfused.fused_taps(5)
    pipe = port.get_preset("denoise_clahe_sharpen")
    out["median_unsharp(5, 1.0, 5)"] = time_ms(lambda: kfused.median_unsharp(g, 5, 1.0, 5))
    out["median -> sep_conv_u8 chain"] = time_ms(
        lambda: kconv.sep_conv_u8(kmedian.median_blur(g, 5), taps, taps, 1.0))
    out["config 5 get_preset"] = time_ms(lambda: pipe(g))
    return out


def profile_config5() -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import imageenhancement_mp_tpu_torch as port

    g = torch.from_numpy(np.random.default_rng(50).integers(0, 256, (2, 2160, 3840),
                                                            dtype=np.uint8)).to("cuda")
    pipe = port.get_preset("denoise_clahe_sharpen")
    calls = 10
    for _ in range(3):
        pipe(g)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            pipe(g)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us()
            k[1] += 1
    rows = sorted(((t, name, n) for name, (t, n) in kernels.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"config 5 get_preset 2x2160x3840 u8, {calls} back-to-back calls under torch.profiler: "
          f"wall {wall_us / calls / 1e3:.4f} ms per call, device busy {busy / calls / 1e3:.4f} ms "
          f"per call ({100 * busy / wall_us:.1f} %)")
    for dt, key, n in rows:
        print(f"    {dt / calls / 1e3:9.4f} ms per call  {100 * dt / busy:5.1f} %  x{n / calls:g}  "
              f"{key[:90]}")


def sass_histogram() -> None:
    sys.path.insert(0, str(ROOT))
    from imageenhancement_mp_tpu_torch.kernels import _build

    lib = _build.library()._name
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "median" in m.group(1) else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m and m.group(1) != "NOP":
            counts[name][m.group(1)] += 1
    for name, c in counts.items():
        print(f"SASS {name[:90]}: {sum(c.values())} instructions; " +
              ", ".join(f"{op} {n}" for op, n in c.most_common(14)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_median_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    trees = [("this", ROOT)]
    if args.parent:
        parent = ("parent", args.parent.resolve())
        trees = [parent, trees[0], trees[0], parent]
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__, "--measure", str(root)], check=True,
                               capture_output=True, text=True)
        result = json.loads(child.stdout.strip().splitlines()[-1])
        runs.setdefault(label, []).append(result)
        print(f"{label} ({root}): " + ", ".join(f"{k} {v:.4f}" for k, v in result.items()))
    for key in runs["this"][0]:
        cells = {label: [r[key] for r in rs] for label, rs in runs.items()}
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                       for label, ts in cells.items()) + f"  [{smi}]")
    profile_config5()
    sass_histogram()


if __name__ == "__main__":
    main()
