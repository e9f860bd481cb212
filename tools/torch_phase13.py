#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py alone on one GPU: the arithmetic, statistics,
tracking, CamShift and segmentation families card against CPU, each with
its ms per call, device launches per call and busy share.

    python3 tools/torch_phase13.py

Builds the kernels first (the statistics chain launches hist256_lut and
sep_conv_u8, the CamShift chain apply_lut256).  torch.profiler counts every
kernel event in this fresh process; inside the whole chip_smoke.py it keeps
fewer (PERF.md section 7).  Exits non-zero without a CUDA device.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase13: torch.cuda.is_available() is False")
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

    cs.arith_stats_and_tracking(
        port, dev, smi, lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev), drive)
    print(f"torch_phase13: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
