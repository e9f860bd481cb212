"""Readings that set the limits of a cell's check, at the cell's own size:
the program over many seeds, the control (the reference in the program's
place, its float32 steps in bfloat16) and the planted faults over a few, all
in one process, each a short window through the harness.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 --control-seeds 4 5 6 \
        --seconds 2 [--faults]

Prints one line per reading.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    reference = harness.load_module("reference", cell.config_name).reference
    program = harness.program_entry(cell.config)
    runs = [("program", seed, program) for seed in args.seeds]
    runs += [("control", seed, faults.control(reference, cell.config))
             for seed in args.control_seeds]
    if args.faults:
        seed = (args.control_seeds or args.seeds)[0]
        runs += [(name, seed, fault(program)) for name, fault in faults.FAULTS.items()]
    for kind, seed, entry in runs:
        t = time.perf_counter()
        record = harness.run_cell(cell, seed, args.seconds, False, device,
                                  harness.CudaClock(device), t, entry=entry)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "run": kind, "seed": seed,
                          "calls": record["calls"], **record["checks"],
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
