#!/usr/bin/env python3
"""Where the time of the port's warp paths goes, on one CUDA card.

    python3 tools/torch_warp_profile.py

1. Times warp_affine (rot15, 2x2160x3840 u8) as the port builds its field
   (per-row tables on the device, no clamp where no coordinate can reach
   it) against the field's first version (per-row tables made in host NumPy
   and copied per call, a clamp pass per coordinate), in turns (first,
   port, port, first): CUDA events around 10 back-to-back calls, median of
   20, and the host's enqueue time per call.
2. Runs 20 back-to-back calls of warp_affine rot15, warp_polar (cached maps)
   and remap (random maps) at 2x2160x3840 u8 under torch.profiler and prints
   the device time per call by kernel, the device's busy share of the
   window, and the host's enqueue time per call without the profiler.
Exits non-zero when torch sees no CUDA device.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np
import torch
from torch.autograd import DeviceType

import imageenhancement_mp_tpu_torch as port
from imageenhancement_mp_tpu_torch.kernels import warp as kwarp
from imageenhancement_mp_tpu_torch.utils import warp_coords as wc

if not torch.cuda.is_available():
    raise SystemExit("torch_warp_profile: torch.cuda.is_available() is False")
dev = torch.device("cuda", 0)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
print(smi)
gen = torch.Generator(device=dev).manual_seed(0)
x = torch.randint(0, 256, (2, 2160, 3840), generator=gen, device=dev, dtype=torch.uint8)
M = wc.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0)
Mi = wc.invert_affine(M)


def hybrid_host(a, b, c, oh, ow, device):
    """The field's first version: row tables made in host NumPy and copied
    to the device per call (a synchronising copy)."""
    a, b, c = np.float32(a), np.float32(b), np.float32(c)
    ys = np.arange(oh, dtype=np.float32)
    nb = ow - ow % 16
    ax = torch.arange(ow, dtype=torch.float64, device=device) * float(a)
    crow = torch.from_numpy((b * ys + c).astype(np.float64)).to(device)[:, None]
    brow = torch.from_numpy((b * ys).astype(np.float64)).to(device)[:, None]
    out = torch.empty((oh, ow), dtype=torch.float32, device=device)
    out[:, :nb] = ax[None, :nb] + crow
    out[:, nb:] = (ax[None, nb:] + brow).to(torch.float32) + float(c)
    return out


def host_tables_path(t):
    Mf = Mi.astype(np.float32)
    sx, sy = (hybrid_host(*Mf[r], 2160, 3840, dev).clamp_(-2e9, 2e9) for r in (0, 1))
    return kwarp.warp_gather_u8(t, sx, sy)


def port_path(t):
    return port.warp_affine(t, M, (2160, 3840))


assert torch.equal(host_tables_path(x), port_path(x))


def time_ms(fn, runs=20, calls=10):
    for _ in range(3):
        fn()
    ts = []
    for _ in range(runs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    q = statistics.quantiles(ts, n=4)
    return q[1], q[2] - q[0]


for label, fn in (("first version", host_tables_path), ("port", port_path),
                  ("port", port_path), ("first version", host_tables_path)):
    m, iqr = time_ms(lambda: fn(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn(x)
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    print(f"warp_affine rot15 2x2160x3840, field {label}: {m:.4f} ms (IQR {iqr:.4f}), host "
          f"enqueue {host_ms:.4f} ms per call  [{smi}]")

mx4 = (torch.rand((2160, 3840), generator=gen, device=dev) * 3844 - 2).contiguous()
my4 = (torch.rand((2160, 3840), generator=gen, device=dev) * 2164 - 2).contiguous()
paths = {
    "warp_affine rot15": port_path,
    "warp_polar((1920, 2160), (1920, 1080), 1900), cached maps":
        lambda t: port.warp_polar(t, (1920, 2160), (1920.0, 1080.0), 1900.0),
    "remap linear, random maps": lambda t: port.remap(t, mx4, my4),
}
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
for label, fn in paths.items():
    for _ in range(5):
        fn(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(20):
            fn(x)
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
    print(f"{label}, 20 back-to-back calls under torch.profiler: wall {wall_us / 20:.2f} us per "
          f"call, device busy {busy / 20:.2f} us per call ({100 * busy / wall_us:.1f} %)")
    for dt, key, n in rows[:8]:
        print(f"    {dt / 20:9.2f} us per call  {100 * dt / busy:5.1f} %  x{n / 20:g}  {key[:90]}")
    # host time to enqueue one call (no sync inside the window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn(x)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    print(f"    host enqueue {((t1 - t0) / 20) * 1e3:.4f} ms per call (no profiler)")
