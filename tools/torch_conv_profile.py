#!/usr/bin/env python3
"""The port's separable conv (K2/K3 sep_conv_u8) and the paths it serves on
one CUDA card: trees timed in turns, each profiled, and the kernel's SASS.

    git archive HEAD imageenhancement_mp_tpu_torch | tar -x -C build/parent
    python3 tools/torch_conv_profile.py --parent build/parent [--tree LABEL=PATH ...]

Each tree (the parent under ``--parent``, any ``--tree``, this checkout) is
timed in a process of its own, in the order parent, trees, this, then back
(parent, this, this, parent for two): sep_conv_u8 on 8x1080x1920 u8 (k 5
sigma 0 with per-plane LUTs and amount 1, k 5 sigma 1.5, k 7, k 31), back to
back through the wrapper and device-paced (a sleep kernel holds the device
while the host enqueues, so the events see only the kernels);
equalize_unsharp(1.0, 5) on 8x1080x1920 and 2x2160x3840, config 5
(get_preset("denoise_clahe_sharpen")) and gaussian_blur(5) on 2x2160x3840;
each the median of 20 runs of 10 calls between CUDA events.  Then the host's
µs to enqueue one call of the main path's conv and of equalize_unsharp, with
the device idle, held busy, and with the C calls replaced by no-ops (the
Python alone).  In trees whose wrapper has ``conv_route``, the k 5 instance
through the C entry point on each horizontal route (packed, int32) and each
amount-1 epilogue (lanes, two FMAs), device-paced, in turns.  Without
``--parent`` only this tree is timed.  Then, for each tree, once:
equalize_unsharp on 8x1080x1920 and config 5 under torch.profiler (device
time per call by kernel and the device's busy share), the host's time to
enqueue one call and the synchronised wall time per call outside the
profiler, and the SASS opcode histogram of each sep_conv_u8 kernel instance
(cuobjdump of the tree's built library) with its registers and spills from
nvcc.log.  Exits non-zero when torch sees no CUDA device.

    python3 tools/torch_conv_profile.py --wide --parent build/parent \
        [--variants tools/conv_wide_split.json]

times the wide instance instead (more than 31 taps on an axis after
trimming) at the tap sets of WIDE_CASES on 8x1080x1920 u8, blur and amount
1, device-paced, each tree in a process of its own in turns (parent, this,
this, parent), each set first held to the plain version on small planes and
at full size; then, in this tree, the yardstick (two separable f32
F.conv2d calls, TF32 off, on the reflect-padded planes, timed and checked
against the plain version) and the wide instance against the runtime one
on the tap sets of RUNTIME_CASES (at most 31 taps after trimming), both
through the C entry point, held to the plain version, device-paced, in
turns.  ``--variants FILE.json`` ({name: [[old, new], ...]}) adds copies of
this tree under build/variants/<name> whose csrc/conv.cu has each ``old``
(which must occur) replaced by ``new``, timed as trees beside this one;
their results are reported against the plain version, not held to it, so a
copy may drop a part of the kernel (tools/conv_wide_split.json drops the
horizontal taps, the vertical rounds and the vertical pass's copies into
shared memory, one each, to split the kernel's time).
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
CALLS = 10
SLEEP_CYCLES = 4_000_000  # about 2 ms at 1.98 GHz: longer than the host's enqueue of CALLS calls
# the C entry point's (mode, integral amount) for amount 1, by epilogue
EPILOGUES = {"lanes": (1, 1), "two-FMA": (2, 0)}


def _setup(root: Path):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import imageenhancement_mp_tpu_torch as port

    assert Path(port.__file__).resolve().parent == root / "imageenhancement_mp_tpu_torch"
    return np, torch, port


def measure(root: Path) -> dict:
    """Times of the conv and its paths in the package under ``root`` (ms),
    and the host's µs per call (keys ending in "us")."""
    np, torch, port = _setup(root)
    from imageenhancement_mp_tpu_torch.kernels import _build, conv as kconv, hist as khist
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    dev = torch.device("cuda", 0)
    time_ms = lambda fn, device_paced=False: _time_ms(torch, fn, device_paced)

    def host_us(fn, device_busy: bool) -> float:
        """Median host µs to enqueue one of CALLS calls, the device idle at the
        start of each run or held busy by a sleep kernel the whole run."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            if device_busy:
                torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    rng = np.random.default_rng(60)
    x8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(dev)
    l8 = torch.from_numpy(rng.integers(0, 256, (8, 256), dtype=np.uint8)).to(dev)
    g4 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    out = {}
    for label, ks, sigma, lut in (("k5 sigma 0, LUT, amount 1", 5, 0.0, l8),
                                  ("k5 sigma 1.5, amount 1", 5, 1.5, None),
                                  ("k7, amount 1", 7, 0.0, None), ("k31, amount 1", 31, 0.0, None)):
        tv, th = q8_taps(ks, sigma)
        fn = lambda: kconv.sep_conv_u8(x8, tv, th, 1.0, lut)
        out[f"sep_conv_u8 8x1080x1920 {label}"] = time_ms(fn)
        out[f"sep_conv_u8 8x1080x1920 {label}, device-paced"] = time_ms(fn, True)
    pipe = port.get_preset("denoise_clahe_sharpen")
    eq8 = lambda: port.equalize_unsharp(x8, 1.0, 5, 0.0)
    out["equalize_unsharp 8x1080x1920"] = time_ms(eq8)
    out["equalize_unsharp 2x2160x3840"] = time_ms(lambda: port.equalize_unsharp(g4, 1.0, 5, 0.0))
    out["config 5 get_preset 2x2160x3840"] = time_ms(lambda: pipe(g4))
    out["gaussian_blur(5) 2x2160x3840"] = time_ms(lambda: port.gaussian_blur(g4, 5))

    # host enqueue: the main path's conv alone and the whole path, the device
    # idle or busy; then with the C call replaced by a no-op (the Python alone)
    tv, th = q8_taps(5, 0.0)
    conv = lambda: kconv.sep_conv_u8(x8, tv, th, 1.0, l8)
    for name, fn in (("sep_conv_u8 k5 LUT amount 1", conv), ("equalize_unsharp 8x1080x1920", eq8)):
        out[f"host {name}, device idle, us"] = host_us(fn, False)
        out[f"host {name}, device busy, us"] = host_us(fn, True)
    launch = kconv.launch
    for mod in (kconv, khist):
        mod.launch = lambda *args: None
    try:
        out["host sep_conv_u8 k5 LUT amount 1, no C call, us"] = host_us(conv, True)
        out["host equalize_unsharp 8x1080x1920, no C calls, us"] = host_us(eq8, True)
    finally:
        for mod in (kconv, khist):
            mod.launch = launch
    if hasattr(kconv, "conv_route"):
        out.update(routes(torch, np, _build, kconv, x8, l8, tv, th, time_ms))
    return out


# the wide instance's cases: (label, ksize, sigma) of q8_taps on u8
WIDE_CASES = (("ksize 33 sigma 0", 33, 0.0), ("sigma 6 (37 taps)", 0, 6.0),
              ("sigma 10 (61 taps)", 0, 10.0), ("sigma 20 (121 taps)", 0, 20.0),
              ("sigma 45 (271 taps)", 0, 45.0), ("sigma 90 (541 taps)", 0, 90.0))


def _time_ms(torch, fn, device_paced: bool = False) -> float:
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


def measure_wide(root: Path, strict: bool = True) -> dict:
    """The tree's sep_conv_u8 at each WIDE_CASES tap set on 8x1080x1920 u8,
    blur and amount 1, device-paced (ms), and each set's route (str); each
    set first held to the plain version at 0 LSB, or (not ``strict``) its
    largest difference from it reported."""
    np, torch, port = _setup(root)
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(61)
    x8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(dev)
    small = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
             for s in ((2, 64, 300), (1, 37, 131), (1, 5, 9))]
    out = {}
    for label, ks, sigma in WIDE_CASES:
        tv, th = q8_taps(ks, sigma)
        out[f"{label} route"] = kconv.conv_route(tv, th).describe()
        worst = 0
        for x in small + [x8]:
            for amount in (None, 1.0, 0.5):
                got = kconv.sep_conv_u8(x, tv, th, amount)
                want = kconv.sep_conv_u8_plain(x, tv, th, amount)
                err = int((got.int() - want.int()).abs().max())
                if err and strict:
                    raise AssertionError(f"{root}: {label} {tuple(x.shape)} amount {amount}: "
                                         f"max abs err {err}")
                worst = max(worst, err)
        if not strict:
            out[f"{label} max abs err vs plain"] = str(worst)
        for amount in (None, 1.0):
            key = f"sep_conv_u8 8x1080x1920 {label}, {'blur' if amount is None else 'amount 1'}"
            out[key] = _time_ms(torch, lambda: kconv.sep_conv_u8(x8, tv, th, amount), True)
    return out


def wide_yardstick(smi: str) -> None:
    """Two separable f32 F.conv2d calls (TF32 off, cuDNN's choice of
    algorithm) on the reflect-padded 8x1080x1920 planes at each WIDE_CASES
    tap set: their time, device-paced, and whether (acc + 2^15) >> 16 of
    their sums equals the plain version (exact sums)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    x8 = torch.from_numpy(np.random.default_rng(61).integers(0, 256, (8, 1080, 1920),
                                                             dtype=np.uint8)).to(dev)
    for label, ks, sigma in WIDE_CASES:
        tv, th = q8_taps(ks, sigma)
        wv = torch.tensor(tv, dtype=torch.float32, device=dev).view(1, 1, -1, 1)
        wh = torch.tensor(th, dtype=torch.float32, device=dev).view(1, 1, 1, -1)
        pad = (len(th) // 2, len(th) // 2, len(tv) // 2, len(tv) // 2)

        def conv2d():
            p = F.pad(x8.view(8, 1, *x8.shape[1:]).float(), pad, mode="reflect")
            return F.conv2d(F.conv2d(p, wv), wh)

        acc = conv2d().view(x8.shape)
        blur = ((acc.double() + 32768) / 65536).floor().clamp(max=255).to(torch.uint8)
        err = int((blur.int() - kconv.sep_conv_u8_plain(x8, tv, th).int()).abs().max())
        integral = bool(torch.equal(acc, acc.round()))
        print(f"  yardstick F.pad + two f32 F.conv2d (TF32 off) at 8x1080x1920 {label}: "
              f"{_time_ms(torch, conv2d, True):.4f} ms device-paced; sums integral {integral}, "
              f"blur vs the plain version max abs err {err}  [{smi}]")


# sets of at most 31 taps after trimming, which take the runtime instance:
# (label, ksize, sigma) of q8_taps
RUNTIME_CASES = (("ksize 25 sigma 0", 25, 0.0), ("ksize 29 sigma 0", 29, 0.0),
                 ("ksize 31 sigma 0", 31, 0.0), ("ksize 33 sigma 0 (31 trimmed)", 33, 0.0),
                 ("sigma 5.1 (33 taps, 29 trimmed)", 0, 5.1),
                 ("33x5 sigma 0 (31x5 trimmed)", (33, 5), 0.0))


def wide_vs_runtime(smi: str) -> None:
    """This tree's wide instance against the runtime one (the route
    conv_route picks) at each RUNTIME_CASES tap set on 8x1080x1920 u8, blur
    and amount 1, through the C entry point; each held to the plain version
    at 0 LSB, then timed device-paced in turns A B B A."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.kernels._build import launch
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    dev = torch.device("cuda", 0)
    x8 = torch.from_numpy(np.random.default_rng(62).integers(0, 256, (8, 1080, 1920),
                                                             dtype=np.uint8)).to(dev)
    out_t = torch.empty_like(x8)
    for label, ks, sigma in RUNTIME_CASES:
        tv, th = q8_taps(ks, sigma)
        r = kconv.conv_route(tv, th)
        wv, wh = kconv.trim_taps(tv), kconv.trim_taps(th)
        buf = torch.from_numpy(kconv.wide_tap_buffer(wv, wh)).to(dev)
        kinds = {"runtime": (r.taps_v, r.taps_h, None, r.instance, int(r.packed), r.shift),
                 "wide": (wv, wh, buf.data_ptr(), kconv.WIDE, 0, 16)}
        for amount in (None, 1.0):
            mode, amount_i = kconv.epilogue_mode(amount)
            alpha, beta = (1.0, 0.0) if amount is None else kconv.unsharp_weights(amount)
            want = kconv.sep_conv_u8_plain(x8, tv, th, amount)
            fns = {}
            for kind, (ctv, cth, dtaps, inst, packed, shift) in kinds.items():
                c_tv, c_th = (np.ascontiguousarray(t, np.int32) for t in (ctv, cth))

                def fn(c_tv=c_tv, c_th=c_th, dtaps=dtaps, inst=inst, packed=packed, shift=shift):
                    launch("sep_conv_u8", dev, x8.data_ptr(), out_t.data_ptr(), *x8.shape,
                           c_tv.ctypes.data, len(c_tv), c_th.ctypes.data, len(c_th), dtaps, None,
                           inst, packed, shift, mode, amount_i, alpha, beta)
                fn()
                err = int((out_t.int() - want.int()).abs().max())
                if err:
                    raise AssertionError(f"{label} {kind} amount {amount}: max abs err {err}")
                fns[kind] = fn
            runs = {k: [] for k in fns}
            for order in (list(fns), list(fns)[::-1]):
                for kind in order:
                    runs[kind].append(_time_ms(torch, fns[kind], True))
            print(f"  {label} ({len(wv)}x{len(wh)} taps) at 8x1080x1920, "
                  f"{'blur' if amount is None else 'amount 1'}, device-paced: " + "; ".join(
                      f"{kind} ({r.describe() if kind == 'runtime' else 'wide/f32'}) "
                      f"{' / '.join(f'{t:.4f}' for t in ts)} ms" for kind, ts in runs.items())
                  + f"  [{smi}]")


def variant_tree(name: str, subs: list) -> Path:
    """A copy of this tree's package under build/variants/<name> with each
    [old, new] of ``subs`` replaced in csrc/conv.cu."""
    pkg = "imageenhancement_mp_tpu_torch"
    d = ROOT / "build" / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(ROOT / pkg, d / pkg, ignore=shutil.ignore_patterns("__pycache__"))
    src = d / pkg / "kernels" / "csrc" / "conv.cu"
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in csrc/conv.cu")
        text = text.replace(old, new)
    src.write_text(text)
    return d


def routes(torch, np, _build, kconv, x, luts, tv, th, time_ms) -> dict:
    """The k 5 instance on the same inputs through the C entry point, device-paced,
    on each horizontal route (packed on reduced taps, int32 on cv2's Q8 taps)
    and each epilogue the entry point takes for amount 1, timed in turns
    A B .. B A; the median of the two turns.  Each is first held against the
    plain version."""
    lib = _build.library()
    sig = _build._SIGNATURES["ie_sep_conv_u8"]
    out_t = torch.empty_like(x)
    want = kconv.sep_conv_u8_plain(x, tv, th, 1.0, luts)
    rv, lv = kconv.reduce_taps(tv)
    rh, lh = kconv.reduce_taps(th)
    keep = []
    variants = {}
    for route, taps_v, taps_h, shift in (("packed", rv, rh, lv + lh), ("int32", tv, th, 16)):
        for mode in EPILOGUES:
            c_tv, c_th = (np.ascontiguousarray(t, np.int32) for t in (taps_v, taps_h))
            keep += [c_tv, c_th]
            # trees with the wide instance take its device taps (null here) after th
            wide = (None,) if len(sig) == 19 else ()
            args = (x.data_ptr(), out_t.data_ptr(), *x.shape, c_tv.ctypes.data, len(tv),
                    c_th.ctypes.data, len(th), *wide, luts.data_ptr(), 5, int(route == "packed"),
                    shift, *EPILOGUES[mode], 2.0, -1.0)
            assert len(args) + 1 == len(sig)
            stream = torch.cuda.current_stream().cuda_stream
            fn = lambda args=args: lib.ie_sep_conv_u8(*args, stream)
            assert fn() == 0
            err = int((out_t.int() - want.int()).abs().max())
            assert err == 0, (route, mode, err)
            variants[f"sep_conv_u8 k5 instance, {route} route, {mode} epilogue, device-paced"] = fn
    runs: dict[str, list] = {k: [] for k in variants}
    for order in (list(variants), list(variants)[::-1]):
        for key in order:
            runs[key].append(time_ms(variants[key], True))
    return {k: statistics.median(v) for k, v in runs.items()}


def profile(root: Path, label: str) -> None:
    """torch.profiler split, busy share and host time per call of
    equalize_unsharp 8x1080x1920 and config 5 2x2160x3840."""
    np, torch, port = _setup(root)
    from torch.autograd import DeviceType

    rng = np.random.default_rng(60)
    x8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to("cuda")
    g4 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to("cuda")
    pipe = port.get_preset("denoise_clahe_sharpen")
    for name, fn in (("equalize_unsharp 8x1080x1920", lambda: port.equalize_unsharp(x8, 1.0, 5, 0.0)),
                     ("config 5 get_preset 2x2160x3840", lambda: pipe(g4))):
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
        print(f"[{label}] {name}: host enqueue {statistics.median(enqueue):.1f} us per call, "
              f"synchronised wall {statistics.median(wall):.1f} us per call (medians of 20 runs "
              f"of {CALLS} calls); under torch.profiler {CALLS} calls: wall "
              f"{prof_us / CALLS:.1f} us per call, device busy {busy / CALLS:.1f} us per call "
              f"({100 * busy / prof_us:.1f} %)")
        for dt, key, n in rows:
            print(f"    {dt / CALLS:9.2f} us per call  {100 * dt / busy:5.1f} %  x{n / CALLS:g}  "
                  f"{key[:90]}")


def sass(root: Path, label: str) -> None:
    """SASS opcode histogram of each sep_conv_u8 kernel instance, and
    ptxas's registers and spills for it."""
    sys.path.insert(0, str(root))
    from imageenhancement_mp_tpu_torch.kernels import _build

    lib = Path(_build.library()._name)
    entry = ""
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "sep_conv" in entry and ("Used" in line or "spill" in line):
            name = re.search(r"'(\S+)'", entry)
            print(f"[{label}] ptxas {name.group(1) if name else entry}: "
                  f"{line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, collections.Counter] = {}
    span: dict[str, int] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "sep_conv" in m.group(1) else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and m:
            span[name] = int(m.group(1), 16) // 16 + 1
            if m.group(2) != "NOP":
                counts[name][m.group(2)] += 1
    for name, c in counts.items():
        print(f"[{label}] SASS {name[:90]}: {sum(c.values())} instructions besides NOPs "
              f"({span.get(name, 0)} slots of 16 bytes); " +
              ", ".join(f"{op} {n}" for op, n in c.most_common(16)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another tree, timed between the parent and this one")
    ap.add_argument("--wide", action="store_true",
                    help="time the wide instance at WIDE_CASES instead, its yardstick, and it "
                         "against the runtime instance at RUNTIME_CASES")
    ap.add_argument("--variants", type=Path, metavar="FILE.json",
                    help="with --wide: copies of this tree with csrc/conv.cu edited, "
                         "{name: [[old, new], ...]}, timed as trees")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    ap.add_argument("--measure-wide", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--lenient", action="store_true", help=argparse.SUPPRESS)  # a variant
    ap.add_argument("--inspect", type=Path, help=argparse.SUPPRESS)  # profile and SASS, in a child
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variants and not args.wide:
        ap.error("--variants goes with --wide")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return
    if args.measure_wide:
        print(json.dumps(measure_wide(args.measure_wide.resolve(), not args.lenient)))
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
    variants = json.loads(args.variants.read_text()) if args.variants else {}
    for name, subs in variants.items():
        trees.insert(-1, (name, variant_tree(name, subs)))
    if len(trees) > 1:
        trees = trees + trees[::-1]
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__,
                                "--measure-wide" if args.wide else "--measure", str(root),
                                *(["--lenient"] if label in variants else [])],
                               capture_output=True, text=True)
        if child.returncode:
            raise SystemExit(f"{label} ({root}) failed:\n{child.stdout}\n{child.stderr}")
        result = json.loads(child.stdout.strip().splitlines()[-1])
        runs.setdefault(label, []).append(result)
        print(f"{label} ({root}): " + ", ".join(
            f"{k} {v}" if isinstance(v, str) else f"{k} {v:.4f}" for k, v in result.items()))
    for key in runs["this"][0]:
        if isinstance(runs["this"][0][key], str):
            continue
        cells = {label: [r[key] for r in rs if key in r] for label, rs in runs.items()}
        unit = "us" if key.endswith(" us") else "ms"
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} {unit}"
                                       for label, ts in cells.items() if ts) + f"  [{smi}]")
    if args.wide:
        wide_yardstick(smi)
        wide_vs_runtime(smi)
        return
    for label, root in dict(trees).items():
        subprocess.run([sys.executable, __file__, "--inspect", str(root), "--label", label],
                       check=True)


if __name__ == "__main__":
    main()
