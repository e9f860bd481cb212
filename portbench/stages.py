"""Where a cell's device time goes by the program's stages: short traced
runs of a cell through the harness, their traces reduced by ``devtrace``
and by ``spans.py``, and the stage readers (``metrics/*_roofline.py``,
``metrics/launch_host_us.py``) applied to each record.

    python3 portbench/stages.py --workload <name> --seeds 1 2 3 --seconds 2

Prints one JSON line per seed: device ms a traced call by stage, the
device's idle share of the traced window, the unattributed share of busy,
program spans a call, the host µs of a traced call (under the profiler),
the readers' values, the top idle gaps and the checks; a seed whose run
raises prints its error instead.  A program without spans reads all its
device time as unattributed.  The benchmark's own runs never run this.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

READERS = ("equalize_hist_roofline", "unsharp_mask_roofline", "median_blur_roofline",
           "clahe_roofline", "layout_roofline", "launch_host_us")


def traced(run_calls, launch_counts) -> dict:
    """``devtrace.profile_calls`` that also keeps the program's spans
    (``program``) and the host µs of each traced call (``enqueue_us``)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import devtrace, spans

    before = dict(launch_counts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_calls, t_returns, _ = run_calls()
    hand = sum(n - before.get(k, 0) for k, n in launch_counts.items())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    trace = devtrace.reduce_trace(events, len(t_calls), hand)
    trace["program"] = spans.reduce_spans(events)
    trace["spans"] = sum(e.get("cat") == "user_annotation" and e["name"].startswith("ie.")
                         for e in events)
    trace["enqueue_us"] = [(r - t) * 1e6 for t, r in zip(t_calls, t_returns)]
    return trace


def summary(record: dict, load_module) -> dict:
    """The line of one seed's ``record``."""
    trace = record["trace"]
    calls, program = trace["calls"], trace["program"]
    stage_s = sum(s["device_s"] for s in program["stages"].values())
    return {
        "calls": calls, "busy_ms_call": 1e3 * trace["busy_s"] / calls,
        "stages_ms_call": {k: 1e3 * v["device_s"] / calls for k, v in program["stages"].items()},
        "ops_call": {k: v["ops"] / calls for k, v in program["stages"].items()},
        "device_idle_pct": 100 * (1 - trace["busy_s"] / trace["window_s"]),
        "unattributed_pct_busy": 100 * program["unattributed_s"] / trace["busy_s"],
        "stages_over_busy": stage_s / trace["busy_s"],
        "launches_call": len(program["launch_us"]) / calls,
        "spans_call": trace["spans"] / calls,
        "traced_enqueue_us": statistics.median(trace["enqueue_us"]),
        "metrics": {name: load_module("metrics", name).read(record) for name in READERS},
        "idle_gaps_ms_call": [[n, 1e3 * s / calls] for n, s in trace["idle_gaps"][:4]],
        "checks": record["checks"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 3
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts

    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    failed = 0
    for seed in args.seeds:
        t = time.perf_counter()
        try:
            record = harness.run_cell(cell, seed, args.seconds, True, device,
                                      harness.CudaClock(device), t,
                                      tracer=lambda rc: traced(rc, launch_counts))
        except Exception as e:  # one seed's failure is reported; the others still run
            traceback.print_exc()
            print(json.dumps({"workload": cell.name, "seed": seed, "error": repr(e)}), flush=True)
            failed += 1
            continue
        finally:
            torch.cuda.empty_cache()
        record["device_kind"] = torch.cuda.get_device_name(device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          **summary(record, harness.load_module),
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root: the benchmark and the program
    sys.exit(main())
