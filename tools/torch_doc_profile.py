#!/usr/bin/env python3
"""The document pipeline's two kernels (K10 bilateral, K9 Gaussian adaptive
threshold) and the calls they serve on one CUDA card: trees timed in turns,
the like-for-like A/Bs of the routes kept, each tree profiled, and the
kernels' SASS.

    git archive HEAD imageenhancement_mp_tpu_torch | tar -x -C build/parent
    python3 tools/torch_doc_profile.py --parent build/parent [--tree LABEL=PATH ...] [--abs-table]

Each tree (the parent under ``--parent``, any ``--tree``, this checkout) is
timed in a process of its own, in the order parent, trees, this, then back
(parent, this, this, parent for two), on 2x2160x3840 u8 from numpy seed 60:
bilateral_gray (d 9, sigma 75/75) and adaptive_threshold_gaussian (block
11, C 2) through their wrappers, back to back and device-paced (a sleep
kernel holds the device while the host enqueues, so the events see only
the kernels); bilateral_filter(9, 75, 75), adaptive_threshold(gaussian,
binary, 11, 2) and make_pipeline(bilateral -> adaptive_threshold) back to
back; each the median of 20 runs of 10 calls between CUDA events.
``--abs-table`` adds a tree made here from this checkout's package with the
bilateral colour table in the 256-entry |v - c| layout in place of the
511-entry signed one (the table-layout A/B).  In trees whose wrappers take
``_runtime``, the A/Bs of the compile-time instances against the runtime
instance on the same inputs (bilateral d 9 = radius 4, athresh block 11),
device-paced, in turns A B B A, and athresh with the f64 recompute forced
on every pixel.  Then, for each tree, once: the pipeline under
torch.profiler (device time per call by kernel, the device's busy share)
and the SASS opcode histogram of each bilateral and athresh kernel (cuobjdump
of the tree's built library) with its registers and spills from nvcc.log.
Exits non-zero when torch sees no CUDA device.
"""
import argparse
import collections
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
CALLS = 10
SLEEP_CYCLES = 4_000_000  # about 2 ms at 1.98 GHz: longer than the host's enqueue of CALLS calls
# csrc/bilateral.cu's signed-table lines and their 256-entry |v - c| counterparts
ABS_TABLE = [
    ("constexpr int kLutFloats = 511 * 32;", "constexpr int kLutFloats = 256 * 32;"),
    ("  return *reinterpret_cast<const float*>(lut + (vkey + ckey));",
     "  return *reinterpret_cast<const float*>(\n"
     "      lut + ((uint32_t(abs(int(vkey - ckey))) << 7) + (threadIdx.x & 31) * 4));"),
    ("__device__ __forceinline__ uint32_t vkey_of(uint32_t w) { return w << 7; }",
     "__device__ __forceinline__ uint32_t vkey_of(uint32_t w) { return w; }"),
    ("__device__ __forceinline__ uint32_t ckey_of(uint32_t c, uint32_t lane4) "
     "{ return ((255u - c) << 7) + lane4; }",
     "__device__ __forceinline__ uint32_t ckey_of(uint32_t c, uint32_t) { return c; }"),
    ("    lut[k] = lut_g[abs(e - 255)];", "    lut[k] = lut_g[e];"),
]


def abs_table_tree() -> Path:
    """This checkout's package under build/doc_abs_table with the 256-entry
    abs colour table in csrc/bilateral.cu."""
    out = ROOT / "build" / "doc_abs_table"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / PKG, out / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    src = out / PKG / "kernels" / "csrc" / "bilateral.cu"
    text = src.read_text()
    for old, new in ABS_TABLE:
        if old not in text:
            raise SystemExit(f"torch_doc_profile: --abs-table cannot patch bilateral.cu: {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return out


def _setup(root: Path):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import imageenhancement_mp_tpu_torch as port

    assert Path(port.__file__).resolve().parent == root / PKG
    return np, torch, port


def _inputs(np, torch, port):
    from imageenhancement_mp_tpu_torch.ops import bilateral as tbil
    from imageenhancement_mp_tpu_torch.ops import threshold as tthr

    dev = torch.device("cuda", 0)
    g4 = torch.from_numpy(np.random.default_rng(60).integers(0, 256, (2, 2160, 3840),
                                                             dtype=np.uint8)).to(dev)
    pipe = port.make_pipeline([
        ("bilateral", {"d": 9, "sigma_color": 75.0, "sigma_space": 75.0}),
        ("adaptive_threshold", {"method": "gaussian", "block_size": 11, "C": 2.0}),
    ])
    return g4, tbil.bilateral_tables(9, 75.0, 75.0, 1, dev), tthr.gaussian_taps(11, dev), pipe


def measure(root: Path) -> dict:
    """Times of the two kernels and their calls in the package under ``root``
    (ms)."""
    np, torch, port = _setup(root)
    from imageenhancement_mp_tpu_torch.kernels import athresh as kathr
    from imageenhancement_mp_tpu_torch.kernels import bilateral as kbil

    def time_ms(fn, device_paced: bool = False) -> float:
        """Median of 20 runs of CALLS calls between CUDA events.  Device-paced:
        a sleep kernel ahead of the first event holds the device while the host
        enqueues the run, so the events see the kernels back to back."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
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

    g4, bil9, taps11, pipe = _inputs(np, torch, port)
    bil = lambda **kw: kbil.bilateral_gray(g4, *bil9, **kw)
    ath = lambda **kw: kathr.adaptive_threshold_gaussian(g4, taps11, 255, 2, False, **kw)
    out = {}
    for label, fn in (("bilateral_gray d9", bil), ("athresh block 11", ath)):
        out[f"{label}"] = time_ms(fn)
        out[f"{label}, device-paced"] = time_ms(fn, True)
    out["bilateral_filter(9, 75, 75)"] = time_ms(lambda: port.bilateral_filter(g4, 9, 75.0, 75.0))
    out["adaptive_threshold(gaussian, 11, 2)"] = time_ms(
        lambda: port.adaptive_threshold(g4, 255.0, "gaussian", "binary", 11, 2.0))
    out["make_pipeline(bilateral -> adaptive_threshold)"] = time_ms(lambda: pipe(g4))
    out["make_pipeline(bilateral -> adaptive_threshold), device-paced"] = time_ms(
        lambda: pipe(g4), True)
    if "_runtime" in (kbil.bilateral_gray.__kwdefaults__ or {}):
        variants = {
            "bilateral d9, compile-time instance (R 4)": lambda: bil(),
            "bilateral d9, runtime instance": lambda: bil(_runtime=True),
            "athresh block 11, compile-time instance": lambda: ath(),
            "athresh block 11, runtime instance": lambda: ath(_runtime=True),
        }
        # each route held to the plain version first
        want_b = kbil.bilateral_gray_plain(g4, *bil9)
        want_a = kathr.adaptive_threshold_gaussian_plain(g4, taps11, 255, 2, False)
        for key, fn in variants.items():
            assert torch.equal(fn(), want_b if key.startswith("bilateral") else want_a), key
        runs: dict[str, list] = {k: [] for k in variants}
        for order in (list(variants), list(variants)[::-1]):
            for key in order:
                runs[key].append(time_ms(variants[key], True))
        out.update({f"{k}, device-paced, in turns": statistics.median(v) for k, v in runs.items()})
        forced = lambda: ath(_margin=float("inf"))
        assert torch.equal(forced(), want_a)
        out["athresh block 11, f64 recompute forced on every pixel, device-paced"] = time_ms(
            forced, True)
    return out


def profile(root: Path, label: str) -> None:
    """torch.profiler split, busy share and host time per call of the pipeline."""
    np, torch, port = _setup(root)
    from torch.autograd import DeviceType

    g4, _, _, pipe = _inputs(np, torch, port)
    fn = lambda: pipe(g4)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    enqueue, wall = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append((t1 - t0) / CALLS * 1e6)
        wall.append((time.perf_counter() - t0) / CALLS * 1e6)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.time_range.elapsed_us()
            k[1] += 1
    rows = sorted(((t, key, n) for key, (t, n) in kernels.items()), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[{label}] make_pipeline(bilateral -> adaptive_threshold) 2x2160x3840: host enqueue "
          f"{statistics.median(enqueue):.1f} us per call, synchronised wall "
          f"{statistics.median(wall):.1f} us per call (medians of 20 runs of {CALLS} calls); "
          f"under torch.profiler {CALLS} calls: wall {prof_us / CALLS:.1f} us per call, device "
          f"busy {busy / CALLS:.1f} us per call ({100 * busy / prof_us:.1f} %)")
    for dt, key, n in rows:
        print(f"    {dt / CALLS:9.2f} us per call  {100 * dt / busy:5.1f} %  x{n / CALLS:g}  "
              f"{key[:90]}")


def sass(root: Path, label: str) -> None:
    """SASS opcode histogram of each bilateral and athresh kernel, and
    ptxas's registers and spills for it."""
    sys.path.insert(0, str(root))
    from imageenhancement_mp_tpu_torch.kernels import _build

    lib = Path(_build.library()._name)
    entry = ""
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif ("bilateral" in entry or "athresh" in entry) and ("Used" in line or "spill" in line):
            name = re.search(r"'(\S+)'", entry)
            print(f"[{label}] ptxas {name.group(1) if name else entry}: "
                  f"{line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if ("bilateral" in m.group(1) or "athresh" in m.group(1)) else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m and not m.group(1).startswith("NOP"):
            counts[name][m.group(1)] += 1
    for name, c in counts.items():
        print(f"[{label}] SASS {name[:90]}: {sum(c.values())} instructions besides NOPs; " +
              ", ".join(f"{op} {n}" for op, n in c.most_common(14)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another tree, timed between the parent and this one")
    ap.add_argument("--abs-table", action="store_true",
                    help="add this tree with the 256-entry abs bilateral colour table")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    ap.add_argument("--inspect", type=Path, help=argparse.SUPPRESS)  # profile and SASS, in a child
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_doc_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return
    if args.inspect:
        profile(args.inspect.resolve(), args.label)
        sass(args.inspect.resolve(), args.label)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    trees = [("this", ROOT)]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees.insert(-1, (label, Path(path).resolve()))
    if args.abs_table:
        trees.insert(-1, ("abs-table", abs_table_tree()))
    if len(trees) > 1:
        trees = trees + trees[::-1]
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__, "--measure", str(root)], check=True,
                               capture_output=True, text=True)
        result = json.loads(child.stdout.strip().splitlines()[-1])
        runs.setdefault(label, []).append(result)
        print(f"{label} ({root}): " + ", ".join(f"{k} {v:.4f}" for k, v in result.items()),
              flush=True)
    keys = dict.fromkeys(k for rs in runs.values() for r in rs for k in r)
    for key in keys:
        cells = {label: [r[key] for r in rs if key in r] for label, rs in runs.items()}
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                       for label, ts in cells.items() if ts) + f"  [{smi}]")
    for label, root in dict(trees).items():
        subprocess.run([sys.executable, __file__, "--inspect", str(root), "--label", label],
                       check=True)


if __name__ == "__main__":
    main()
