#!/usr/bin/env python3
"""Where the time of the port's LUT-family paths and of the fused median ->
unsharp goes, on one CUDA card.

    python3 tools/torch_lut_profile.py

Runs back-to-back calls under torch.profiler of config 2
(get_preset("gamma_stretch") on 32x1080x1920x3 u8), pooled
equalize_hist(per_frame=False) on 8x1080x1920x3 u8, median_unsharp(5, 1.0,
5) on 2x2160x3840 u8 and the two-kernel chain it replaces (median ->
sep_conv_u8) on the same input, and prints for each the device time per call
by kernel, the device's busy share of the window, and the host's time per
call without the profiler.  Exits non-zero when torch sees no CUDA device.
"""
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import torch
from torch.autograd import DeviceType

import imageenhancement_mp_tpu_torch as port
from imageenhancement_mp_tpu_torch.kernels import conv as kconv
from imageenhancement_mp_tpu_torch.kernels import fused as kfused
from imageenhancement_mp_tpu_torch.kernels import median as kmedian

if not torch.cuda.is_available():
    raise SystemExit("torch_lut_profile: torch.cuda.is_available() is False")
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                      "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(smi)
rng = np.random.default_rng(30)
rgb32 = torch.from_numpy(rng.integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)).to(dev)
rgb8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8)).to(dev)
g4k = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
pipe = port.get_preset("gamma_stretch")
taps = kfused.fused_taps(5)
paths = {
    "config 2 get_preset('gamma_stretch') 32x1080x1920x3 u8": lambda: pipe(rgb32),
    "equalize_hist(per_frame=False) 8x1080x1920x3 u8":
        lambda: port.equalize_hist(rgb8, per_frame=False),
    "median_unsharp(5, 1.0, 5) 2x2160x3840 u8": lambda: kfused.median_unsharp(g4k, 5, 1.0, 5),
    "median -> sep_conv_u8 chain 2x2160x3840 u8":
        lambda: kconv.sep_conv_u8(kmedian.median_blur(g4k, 5), taps, taps, 1.0),
}
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
calls = 10
for label, fn in paths.items():
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
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
    print(f"{label}, {calls} back-to-back calls under torch.profiler: wall "
          f"{wall_us / calls / 1e3:.4f} ms per call, device busy {busy / calls / 1e3:.4f} ms per "
          f"call ({100 * busy / wall_us:.1f} %), {sum(r[2] for r in rows) / calls:g} kernels "
          "per call")
    for dt, key, n in rows[:12]:
        print(f"    {dt / calls / 1e3:9.4f} ms per call  {100 * dt / busy:5.1f} %  x{n / calls:g}  "
              f"{key[:90]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    print(f"    {(time.perf_counter() - t0) / calls * 1e3:.4f} ms per call on the host clock, "
          f"synchronised (no profiler)  [{smi}]")
