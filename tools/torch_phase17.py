#!/usr/bin/env python3
"""Phase 17 of chip_smoke.py alone: the port's mesh (parallel/).  Config 5
batch-sharded over a 1-device mesh and over four shards on the one card,
the pooled equalize, config 5 row-sharded on an 8K frame (u8 and u16), the
16 non-pointwise spatial twins on a 4K frame, the geometry twins (resize,
warpAffine, remap, warpPolar, Canny) on the 8K frame and stream_frames(mesh=),
each held to the unsharded call at 0 LSB with its launches counted, the
back-to-back ms and host us a call of the unsharded and sharded calls, and
warp_gather_u8's matrix route with a shard's first row against its plain
version.

    python3 tools/torch_phase17.py              # on one GPU
    python3 tools/torch_phase17.py --rehearse   # on the CPU, small sizes

``--rehearse`` runs the same phase on the CPU at small sizes (meshes whose
entries are the CPU, the timing stubbed, no launch expected).  It catches
Python faults before a chip run.  Without ``--rehearse`` it exits non-zero
when no CUDA device is present.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SMALL = {"batch": (4, 64, 96), "pool": (8, 27, 48), "scan": (128, 192), "twin": (64, 96),
         "half": (64, 96), "area": (48, 80)}


def rehearse() -> None:
    """Phase 17 on the CPU at SMALL sizes."""
    def drive(label, fn, expect):
        out = fn()
        print(f"{label} launches: {{}}")
        return out, {}

    cs.time_ms = lambda fn, runs=0, calls=0, warmups=0: (fn(), 1.0, 0.0)[1:]
    cs.host_us = lambda dev, fn, calls=0, rounds=0: (fn(), 1.0)[1]
    t0 = time.perf_counter()
    cs.mesh_sharding("cpu rehearsal", drive, torch.device("cpu"), SMALL)
    print(f"torch_phase17 --rehearse: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--rehearse" in sys.argv[1:]:
        rehearse()
        return
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase17: torch.cuda.is_available() is False")
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

    cs.mesh_sharding(smi, drive, torch.device("cuda", 0))
    print(f"torch_phase17: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
