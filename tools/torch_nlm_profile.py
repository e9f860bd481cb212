#!/usr/bin/env python3
"""Where the time of the port's colour and non-local-means paths goes, on one
CUDA card.

    python3 tools/torch_nlm_profile.py

1. Runs fast_nl_means_denoising(h=10, 7, 21) on a 1080x1920 u8 frame (2
   calls) and cvt_color rgb2lab on 32x1080x1920x3 u8 (5 calls) back to back
   under torch.profiler and prints the device time per call by kernel, the
   device's busy share of the window, and take_table's share; then the
   host's time per call without the profiler.
2. Times take_table alone at one NLMeans lookup (1x1080x1920 int32 indices,
   the 529-entry LUT): 1000 back-to-back launches on the host clock (the
   wrapper's cost per launch) and on CUDA events.
Exits non-zero when torch sees no CUDA device.
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
from imageenhancement_mp_tpu_torch.kernels import take as ktake
from imageenhancement_mp_tpu_torch.ops import nlmeans as tnlm

if not torch.cuda.is_available():
    raise SystemExit("torch_nlm_profile: torch.cuda.is_available() is False")
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                      "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
print(smi)
rng = np.random.default_rng(23)
yy, xx = np.ogrid[0:1080, 0:1920]
frame = np.clip(128 + 60 * np.sin(yy / 9.0) + 50 * np.cos(xx / 13.0)
                + rng.normal(0, 8.0, (1080, 1920)), 0, 255).astype(np.uint8)
gray = torch.from_numpy(frame).to(dev)
rgb = torch.from_numpy(rng.integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)).to(dev)
paths = {
    "fast_nl_means_denoising(h=10, 7, 21) 1080x1920 u8":
        (lambda: port.fast_nl_means_denoising(gray, 10.0, 7, 21), 2),
    "cvt_color rgb2lab 32x1080x1920x3 u8": (lambda: port.cvt_color(rgb, "rgb2lab"), 5),
}
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
for label, (fn, calls) in paths.items():
    for _ in range(2):
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
    take_us = sum(t for t, name, _ in rows if "take_table" in name)
    print(f"{label}, {calls} back-to-back calls under torch.profiler: wall "
          f"{wall_us / calls / 1e3:.3f} ms per call, device busy {busy / calls / 1e3:.3f} ms per "
          f"call ({100 * busy / wall_us:.1f} %), take_table {take_us / calls / 1e3:.3f} ms "
          f"({100 * take_us / busy:.1f} % of the device time), {sum(r[2] for r in rows) / calls:g} "
          f"kernels per call")
    for dt, key, n in rows[:10]:
        print(f"    {dt / calls / 1e3:9.3f} ms per call  {100 * dt / busy:5.1f} %  x{n / calls:g}  "
              f"{key[:90]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    print(f"    {(time.perf_counter() - t0) / calls * 1e3:.3f} ms per call on the host clock, "
          f"synchronised (no profiler)  [{smi}]")

lut = tnlm._lut(10.0, 7, 21, 1, 1, "l2", 255, dev)[0]
idx = torch.randint(0, lut.numel(), (1, 1080, 1920), device=dev, dtype=torch.int32)
for _ in range(10):
    ktake.take_table(idx, lut)
torch.cuda.synchronize()
s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
t0 = time.perf_counter()
s.record()
for _ in range(1000):
    ktake.take_table(idx, lut)
e.record()
host_us = (time.perf_counter() - t0) / 1000 * 1e6
e.synchronize()
print(f"take_table at (1, 1080, 1920), {lut.numel()}-entry LUT, 1000 back-to-back launches: "
      f"host {host_us:.2f} us per launch to enqueue, {s.elapsed_time(e):.3f} ms in all on the "
      f"device clock ({s.elapsed_time(e):.3f} us per launch)  [{smi}]")
