#!/usr/bin/env python3
"""Phase 15 of chip_smoke.py alone: distanceTransform on a burst of 1080p
masks, floodFill on 1080p gray and RGB frames, HoughLines on a 1080p Canny
map, and the host helpers (HoughLinesP, findContours, the shape
descriptors, matchShapes) at 480x640, card against CPU, each with its ms per
call, device launches per call and busy share.

    python3 tools/torch_phase15.py              # on one GPU
    python3 tools/torch_phase15.py --rehearse   # on the CPU, small sizes

None of these functions launches a kernel of the port (the counters stay
at 0); torch.profiler counts every torch kernel event in this fresh
process.  ``--rehearse`` runs the same phase on the CPU at a tenth of the
sizes (the 480x640 helpers at 96x128) with the timers stubbed: it catches
Python faults before a chip run.  Without ``--rehearse`` it exits non-zero
when no CUDA device is present.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SMALL = {"distance": (2, 108, 192), "flood": (108, 192), "flood_crop": (54, 96),
         "hough": (108, 192), "hough_threshold": 40, "contours": (96, 128)}


def rehearse() -> None:
    """Phase 15 on the CPU at SMALL sizes, the timers returning at once
    after one call."""
    import imageenhancement_mp_tpu_torch as port

    def drive(label, fn, expect):
        out = fn()
        print(f"{label} launches: {{}}")
        return out, {}

    def family_line(label, fn, smi, runs=5, calls=2, warmups=cs.WARMUPS):
        fn()
        return 1.0

    def time_ms(fn, runs=cs.TIMED_RUNS, calls=cs.CALLS_PER_RUN, warmups=cs.WARMUPS):
        fn()
        return 1.0, 0.0

    cs.family_line = family_line
    cs.time_ms = time_ms
    t0 = time.perf_counter()
    cs.contours_and_shapes(port, torch.device("cpu"), "cpu rehearsal",
                           lambda a: torch.from_numpy(np.ascontiguousarray(a)), drive, SMALL)
    print(f"torch_phase15 --rehearse: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--rehearse" in sys.argv[1:]:
        rehearse()
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase15: torch.cuda.is_available() is False")
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi)
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)

    def drive(label, fn, expect):
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = dict(launch_counts)
        want = {n: expect.get(n, 0) for n in got}
        print(f"{label} launches: { {n: c for n, c in got.items() if c} }")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        return out, got

    cs.contours_and_shapes(
        port, dev, smi, lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), drive)
    print(f"torch_phase15: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
