#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone: the port's entry points.  The selftest
on the card (every row within its budget, the 128x256 rows' kernels), the
CLI's batch mode on 1080p PNM and PNG frames (the wall time a frame split by
stage) and its single-image mode on a 4K .npy through config 5's ops, card
against CPU byte for byte.

    python3 tools/torch_phase16.py              # on one GPU
    python3 tools/torch_phase16.py --rehearse   # on the CPU, small sizes

``--rehearse`` runs the same phase on the CPU at small sizes: the selftest's
rows through ``selftest.check_rows`` on the CPU, the CLI's ``--device cuda``
runs on the CPU, no launch expected.  It catches Python faults before a chip
run.  Without ``--rehearse`` it exits non-zero when no CUDA device is
present.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SMALL = {"selftest": (48, 53), "frame": (108, 192), "single": (216, 384)}


def rehearse() -> None:
    """Phase 16 on the CPU at SMALL sizes."""
    from imageenhancement_mp_tpu_torch import cli, selftest

    def drive(label, fn, expect):
        out = fn()
        print(f"{label} launches: {{}}")
        return out, {}

    def run_selftest(size, seed, verbose=True, results=None):
        return selftest.check_rows(selftest.selftest_rows(size, seed), torch.device("cpu"),
                                   verbose, results)

    selftest.run_selftest = run_selftest
    cs.WIDE_LAUNCHES = {k: {} for k in cs.WIDE_LAUNCHES}
    cli._device = lambda name: torch.device("cpu")
    t0 = time.perf_counter()
    cs.entry_points("cpu rehearsal", drive, SMALL)
    print(f"torch_phase16 --rehearse: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--rehearse" in sys.argv[1:]:
        rehearse()
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase16: torch.cuda.is_available() is False")
    from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    smi = cs.nvidia_smi_line()
    print(smi)
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")

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

    cs.entry_points(smi, drive)
    print(f"torch_phase16: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
