#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (imageenhancement_mp_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the Python, torch and CUDA versions and the card's name and power
   limit from nvidia-smi; exits non-zero when torch sees no CUDA device.
2. Builds the kernels from imageenhancement_mp_tpu_torch/kernels/csrc with
   nvcc (sm_90a) into build/ie_torch_kernels/ and prints the build time and
   ptxas's register and shared-memory report.
3. Holds each kernel against its plain PyTorch version on the card, at 0 LSB,
   over the CPU tests' cases plus 1080x1920 and a 1100x1080x1920 batch
   (flat offsets past 2^31), and times both at the main path's shapes.
4. Drives the main path through the public functions — equalize_unsharp at
   8x1080x1920 and 2x2160x3840 and equalize_hist at 8x1080x1920, u8 from
   numpy seed 0 — with the launch counters set to 0 just before and read
   just after; fails if any kernel was not launched.  Holds the results
   against the plain path on the card and one 1080p frame against the plain
   path on the CPU, at 0 LSB, then times equalize_unsharp (kernel path vs
   plain path, CUDA events around 10 back-to-back calls, median of 20 such
   runs after 3 warm-up calls).
5. Prints a one-line JSON per-kernel summary, then, as the last line,
   {"ok": true, "device": {...}}.

Every check raises on failure; nothing is caught.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = "imageenhancement_mp_tpu_torch"
KERNELS = ("hist256", "equalize_lut256", "apply_lut256", "sep_conv_u8")
SOURCES = {
    "hist256": f"{PKG}/kernels/csrc/hist.cu",
    "equalize_lut256": f"{PKG}/kernels/csrc/hist.cu",
    "apply_lut256": f"{PKG}/kernels/csrc/hist.cu",
    "sep_conv_u8": f"{PKG}/kernels/csrc/conv.cu",
}
REPLACES = {
    "hist256": "imageenhancement_mp_tpu/kernels/hist.py:156",
    "equalize_lut256": "imageenhancement_mp_tpu/kernels/hist.py:572",
    "apply_lut256": "imageenhancement_mp_tpu/kernels/hist.py:228",
    "sep_conv_u8": "imageenhancement_mp_tpu/kernels/conv2.py:326",
}
# each timed run is CALLS_PER_RUN back-to-back calls between two CUDA events:
# the steady state of a stream of batches, which an isolated call (whose
# host enqueue time lands between its events) overstates
TIMED_RUNS, WARMUPS, CALLS_PER_RUN = 20, 3, 10


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64).to(a.device)).abs().max())


def time_ms(fn) -> tuple[float, float]:
    """Median and interquartile range over TIMED_RUNS runs of the per-call
    time of ``fn`` (ms), each run timing CALLS_PER_RUN back-to-back calls
    with two CUDA events."""
    for _ in range(WARMUPS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_RUN):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS_PER_RUN)
    q1, q2, q3 = statistics.quantiles(times, n=4)
    return q2, q3 - q1


def main() -> None:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
    from imageenhancement_mp_tpu_torch.kernels import conv as kconv
    from imageenhancement_mp_tpu_torch.kernels import hist as khist
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    if Path(port.__file__).resolve().parent != ROOT / PKG:
        raise SystemExit(f"chip_smoke: imported {port.__file__}, not this checkout's {PKG}")
    if "jax" in sys.modules:
        raise SystemExit("chip_smoke: JAX was imported")
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}  count {torch.cuda.device_count()}  "
          f"capability {torch.cuda.get_device_capability(0)}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib._name}")
    log = (Path(lib._name).parent / "nvcc.log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line:
                print("  ptxas:", line.split(":", 1)[-1].strip())

    # -- 3. each kernel against its plain version, on the card -----------------
    rng = np.random.default_rng(0)
    err = dict.fromkeys(KERNELS, 0)

    def on_card(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand_u8(shape, lo=0, hi=256) -> torch.Tensor:
        return on_card(rng.integers(lo, hi, shape, dtype=np.uint8))

    def misaligned(x: torch.Tensor) -> torch.Tensor:
        """The same values at a storage offset of 1 byte (contiguous)."""
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    def check(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        e = max_err(got, want)
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} {what}: kernel vs plain max abs err {e}")

    before = dict(launch_counts)
    shapes = [(2, 64, 256), (1, 37, 131), (3, 5, 9), (1, 1, 1), (8, 1080, 1920)]
    planes_cases = [rand_u8(s) for s in shapes]
    planes_cases += [rand_u8((2, 64, 256), 100, 201),                  # empty low range
                     torch.full((2, 37, 131), 77, dtype=torch.uint8, device=dev),  # constant
                     rand_u8((3, 1000)),                                # [B, P] rows
                     misaligned(rand_u8((1, 37, 131)))]
    for x in planes_cases:
        what = f"{tuple(x.shape)} offset {x.storage_offset()}"
        h = khist.hist256(x)
        check("hist256", h, khist.hist256_plain(x), what)
        total = x[0].numel()
        luts = khist.equalize_lut256(h, total)
        check("equalize_lut256", luts, khist.equalize_lut256_plain(h, total), what)
        check("apply_lut256", khist.apply_lut256(x, luts), khist.apply_lut256_plain(x, luts), what)
        shared = luts[0].contiguous()
        check("apply_lut256", khist.apply_lut256(x, shared),
              khist.apply_lut256_plain(x, shared), what + " shared table")
    # random histograms straight into the LUT kernel (rows sum to total)
    hr = on_card(rng.multinomial(5000, rng.dirichlet(np.full(256, 0.3)), size=64).astype(np.int32))
    check("equalize_lut256", khist.equalize_lut256(hr, 5000),
          khist.equalize_lut256_plain(hr, 5000), "random histograms")
    # mismatched in/out alignment in the LUT apply
    xm = misaligned(rand_u8((2, 64, 256)))
    lm = rand_u8((2, 256))
    check("apply_lut256", khist.apply_lut256(xm, lm), khist.apply_lut256_plain(xm, lm),
          "misaligned input")

    conv_cases = []
    for shape in [(2, 64, 256), (1, 37, 131), (1, 5, 9), (1, 1, 1)]:
        for ks, sg in [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0), ((3, 5), 0.0), (5, 1.5),
                       (5, 2.3), (31, 0.0), ((1, 31), 0.0)]:
            for amount in (None, 1.0, 0.5, -1.0, 100.0):
                conv_cases.append((shape, ks, sg, amount))
    conv_cases += [((8, 1080, 1920), 5, 0.0, amount) for amount in (None, 1.0)]
    conv_cases += [((8, 1080, 1920), 7, 2.3, 0.5)]
    for shape, ks, sg, amount in conv_cases:
        x = rand_u8(shape)
        tv, th = q8_taps(ks, sg)
        for luts in (None, rand_u8((shape[0], 256))):
            what = f"{shape} k={ks} sigma={sg} amount={amount} lut={luts is not None}"
            check("sep_conv_u8", kconv.sep_conv_u8(x, tv, th, amount, luts),
                  kconv.sep_conv_u8_plain(x, tv, th, amount, luts), what)
    # a batch past 2^31 bytes: the kernels' flat offsets must be 64-bit;
    # the plain versions run on the last two planes only
    tv5, th5 = q8_taps(5, 0.0)
    big = rand_u8((1100, 1080, 1920))
    tail = big[-2:]
    hb = khist.hist256(big)
    check("hist256", hb[-2:], khist.hist256_plain(tail), "1100x1080x1920, last planes")
    lb = khist.equalize_lut256(hb, big[0].numel())
    check("apply_lut256", khist.apply_lut256(big, lb)[-2:],
          khist.apply_lut256_plain(tail, lb[-2:]), "1100x1080x1920, last planes")
    check("sep_conv_u8", kconv.sep_conv_u8(big, tv5, th5, 1.0, lb)[-2:],
          kconv.sep_conv_u8_plain(tail, tv5, th5, 1.0, lb[-2:]), "1100x1080x1920, last planes")
    del big, tail, hb, lb
    torch.cuda.synchronize()
    for name in KERNELS:
        if launch_counts[name] <= before[name]:
            raise AssertionError(f"{name}: the comparison phase launched no kernel")
    print("kernels vs plain on the card: 0 LSB over "
          f"{len(planes_cases)} plane cases and {2 * len(conv_cases)} conv cases")

    # per-kernel time at the main path's shape, kernel vs plain
    x8 = planes_cases[4]
    total8 = x8[0].numel()
    h8 = khist.hist256(x8)
    l8 = khist.equalize_lut256(h8, total8)
    timed = {
        "hist256": (lambda: khist.hist256(x8), lambda: khist.hist256_plain(x8)),
        "equalize_lut256": (lambda: khist.equalize_lut256(h8, total8),
                            lambda: khist.equalize_lut256_plain(h8, total8)),
        "apply_lut256": (lambda: khist.apply_lut256(x8, l8),
                         lambda: khist.apply_lut256_plain(x8, l8)),
        "sep_conv_u8": (lambda: kconv.sep_conv_u8(x8, tv5, th5, 1.0, l8),
                        lambda: kconv.sep_conv_u8_plain(x8, tv5, th5, 1.0, l8)),
    }
    ms = {}
    for name, (kfn, pfn) in timed.items():
        (k_ms, k_iqr), (p_ms, p_iqr) = time_ms(kfn), time_ms(pfn)
        ms[name] = (k_ms, p_ms)
        print(f"  {name} at {tuple(x8.shape) if name != 'equalize_lut256' else tuple(h8.shape)}: "
              f"kernel {k_ms:.4f} ms (IQR {k_iqr:.4f}), plain {p_ms:.4f} ms (IQR {p_iqr:.4f})  [{smi}]")

    # -- 4. the main path through the public functions -------------------------
    x1080 = np.random.default_rng(0).integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    x4k = np.random.default_rng(0).integers(0, 256, (2, 2160, 3840), dtype=np.uint8)
    g1080, g4k = on_card(x1080), on_card(x4k)
    torch.cuda.synchronize()
    reset_launch_counts()
    out1080 = port.equalize_unsharp(g1080, 1.0, 5, 0.0)
    out4k = port.equalize_unsharp(g4k, 1.0, 5, 0.0)
    eq1080 = port.equalize_hist(g1080)
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    print(f"main path launches: {launches}")
    for name in KERNELS:
        if launches[name] < 1:
            raise AssertionError(f"the main path never launched {name}")

    def plain_equalize_unsharp(planes: torch.Tensor) -> torch.Tensor:
        luts = khist.equalize_lut256_plain(khist.hist256_plain(planes), planes[0].numel())
        return kconv.sep_conv_u8_plain(planes, tv5, th5, 1.0, luts)

    for out, x in ((out1080, g1080), (out4k, g4k)):
        if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
            raise AssertionError(f"equalize_unsharp output {tuple(out.shape)} {out.dtype} {out.device}")
        e = max_err(out, plain_equalize_unsharp(x))
        print(f"equalize_unsharp {tuple(x.shape)}: kernel path vs plain path on the card, max abs err {e}")
        if e:
            raise AssertionError("equalize_unsharp kernel path differs from the plain path")
    eq_plain = khist.apply_lut256_plain(g1080, khist.equalize_lut256_plain(
        khist.hist256_plain(g1080), g1080[0].numel()))
    if max_err(eq1080, eq_plain):
        raise AssertionError("equalize_hist kernel path differs from the plain path")
    cpu_frame = port.equalize_unsharp(torch.from_numpy(x1080[:1]), 1.0, 5, 0.0)
    e = max_err(out1080[:1].cpu(), cpu_frame)
    print(f"equalize_unsharp one 1080p frame: card vs plain path on the CPU, max abs err {e}")
    if e:
        raise AssertionError("equalize_unsharp on the card differs from the CPU plain path")
    if out1080.float().std() == 0:
        raise AssertionError("equalize_unsharp output is constant")

    for label, x in (("8x1080x1920", g1080), ("2x2160x3840", g4k)):
        k_ms, k_iqr = time_ms(lambda: port.equalize_unsharp(x, 1.0, 5, 0.0))
        p_ms, p_iqr = time_ms(lambda: plain_equalize_unsharp(x))
        gpix = x.numel() / 1e9
        print(f"equalize_unsharp {label} u8: kernel path {k_ms:.4f} ms (IQR {k_iqr:.4f}) = "
              f"{gpix / (k_ms / 1e3):.3f} GPix/s, plain path {p_ms:.4f} ms (IQR {p_iqr:.4f}) = "
              f"{gpix / (p_ms / 1e3):.3f} GPix/s, max abs err 0  [{smi}]")

    summary = {"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n], "replaces": REPLACES[n],
         "launches": launches[n], "max_abs_err": err[n], "ms": ms[n][0], "plain_ms": ms[n][1]}
        for n in KERNELS]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
