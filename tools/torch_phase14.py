#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py alone: OpenCV's photo module (the
domain-transform filters, the HDR bracket chain, decolor, TV-L1, phase
correlation, seamless clone, inpaint) card against CPU, each with its ms
per call, device launches per call and busy share.

    python3 tools/torch_phase14.py              # on one GPU
    python3 tools/torch_phase14.py --rehearse   # on the CPU, small sizes

On a GPU it builds the kernels first (merge_debevec launches
apply_lut256_wide, decolor take_table); torch.profiler counts every kernel
event in this fresh process.  ``--rehearse`` runs the same phase on the
CPU at a tenth of the sizes (the 480x640 inpaint at 96x128), with the
launches counted by stubbed ``on_cuda`` (which return False, so the plain
versions run) and the timers stubbed: it catches Python faults and the
launch counts before a chip run.  Without ``--rehearse`` it exits non-zero
when no CUDA device is present.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SMALL = {"photo": (108, 192), "bracket": (216, 384), "tvl1": (3, 108, 192),
         "clone": ((40, 60), (108, 192)), "inpaint": (96, 128)}


def rehearse() -> None:
    """Phase 14 on the CPU at SMALL sizes: each kernel module's ``on_cuda``
    counts a launch and returns False, the timers return at once."""
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import hist as khist
    from imageenhancement_mp_tpu_torch.kernels import take as ktake

    counts: dict = {}

    def counting(t, name):
        counts[name] = counts.get(name, 0) + 1
        return False

    for mod in (khist, ktake):
        mod.on_cuda = counting

    def drive(label, fn, expect):
        counts.clear()
        out = fn()
        got = {n: c for n, c in counts.items() if c}
        print(f"{label} launches: {got}")
        if got != {n: c for n, c in expect.items() if c}:
            raise AssertionError(f"{label}: launches {got}, expected {expect}")
        return out, got

    def family_line(label, fn, smi, runs=5, calls=2, warmups=cs.WARMUPS):
        fn()
        return 1.0

    cs.family_line = family_line
    cs.BRACKET_SHIFTS = ((1, -2), (0, 0), (-1, 2))
    cs.PHASE_SHIFT = (-2, 3)
    t0 = time.perf_counter()
    cs.photo_and_hdr(port, torch.device("cpu"), "cpu rehearsal",
                     lambda a: torch.from_numpy(np.ascontiguousarray(a)), drive, SMALL)
    print(f"torch_phase14 --rehearse: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--rehearse" in sys.argv[1:]:
        rehearse()
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase14: torch.cuda.is_available() is False")
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

    cs.photo_and_hdr(
        port, dev, smi, lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), drive)
    print(f"torch_phase14: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
