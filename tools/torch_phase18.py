#!/usr/bin/env python3
"""Phase 18 of chip_smoke.py alone: the port's clock (profiling.py) on
equalize_unsharp, configs 2, 3 and 5 at full width.  Each path's chain
replayed as CUDA graphs is held to the eager chain on the card and to the
CPU plain chain at 2x270x480, at 0; then time_op, time_op_chained, the
back-to-back and sleep-paced event clocks, torch.profiler's kernel sum and
the bytes bound on one line a path; time_op on merge_mertens over a list of
three 4K exposures and in a closure, each at least the call's device time;
Otsu must make time_op_chained raise.

    python3 tools/torch_phase18.py              # on one GPU
    python3 tools/torch_phase18.py --rehearse   # on the CPU, small sizes

``--rehearse`` runs the same phase on the CPU at small sizes (the chains run
eagerly there, the event clocks are stubbed).  It catches Python faults
before a chip run.  Without ``--rehearse`` it exits non-zero when no CUDA
device is present.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SMALL = {"equalize_unsharp": (2, 54, 96), "config 2": (4, 54, 96, 3), "config 3": (2, 54, 96),
         "config 5": (2, 108, 192), "small": (2, 27, 48), "bracket": (54, 96)}


def rehearse() -> None:
    """Phase 18 on the CPU at SMALL sizes."""
    cs.time_ms = lambda fn, runs=0, calls=0, warmups=0: (fn(), 1.0, 0.0)[1:]
    cs.paced_ms = lambda fn, cycles, runs=0, calls=0: (fn(), 1.0)[1]
    cs.device_split = lambda fn, calls=0, warmups=0: (fn(), 1.0, 1.0, [])[1:]
    cs.host_us = lambda dev, fn, calls=0, rounds=0: (fn(), 1.0)[1]
    cs.P18_TARGET_SECS = 0.02
    t0 = time.perf_counter()
    cs.the_clock("cpu rehearsal", torch.device("cpu"), SMALL)
    print(f"torch_phase18 --rehearse: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--rehearse" in sys.argv[1:]:
        rehearse()
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase18: torch.cuda.is_available() is False")
    from imageenhancement_mp_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi)
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    cs.the_clock(smi, torch.device("cuda", 0))
    print(f"torch_phase18: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
