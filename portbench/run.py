"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a part of the window profiled).
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks``, the numbers compared with their limits, last);
the last lines of standard error are the same checks.  Without as many CUDA
devices as the cell asks for, or with JAX or the JAX package loaded at the
end, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout's root: the benchmark and the program

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "imageenhancement_mp_tpu"})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def card_state() -> str | None:
    """The card's power limit, SM clock and temperature as ``nvidia-smi``
    reads them right after the window, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm,temperature.gpu",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def result_line(cell, record: dict, trace: bool, load_module) -> dict:
    """The result object of a run's ``record``: the cell's end-to-end
    metrics (``trace`` false) or per-layer metrics (true) as their readers
    give them, the device, and the numbers compared with their limits."""
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": record["checks"][name], "limit": limit}
              for name, limit in cell.config["limits"].items()}
    device = {"platform": "gpu", "kind": record["device_kind"], "count": cell.chips,
              "memory_peak_bytes": record["memory_peak_bytes"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": record["calls"], "failed": record["checks"]["failed"],
              "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
        result["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["card"] = record.get("card")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import devtrace, harness

    parts = {"import_torch": time.perf_counter() - T_START}
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    parts["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts
    parts["import_program"] = time.perf_counter() - t

    def tracer(run_calls):
        return devtrace.profile_calls(run_calls, launch_counts)

    record = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                              harness.CudaClock(device), T_START, tracer=tracer,
                              setup_parts=parts)
    record["device_kind"] = torch.cuda.get_device_name(device)
    record["card"] = card_state()
    result = result_line(cell, record, bool(args.trace), harness.load_module)
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of {', '.join(bad)} were loaded in this process", file=sys.stderr)
        return 4
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in record["setup_parts"].items())
          + f" / check {record['check_s']:.3f} / enqueue_us median "
          f"{statistics.median(record['enqueue_us']):.1f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
