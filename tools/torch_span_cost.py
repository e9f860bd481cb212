#!/usr/bin/env python3
"""Host cost of the port's spans (``imageenhancement_mp_tpu_torch/tracing.py``)
with no profiler recording: ns per ``with span(...)`` block, for a constant
name (the entry, layout and stage spans) and for the name built per launch
(``_build.launch``), beside an empty function call; then the same two spans
under a CPU profiler for scale.

    python3 tools/torch_span_cost.py [--number 1000000]

Prints one JSON line.  Times are the least of five repeats, in ns per block
with the empty call's cost taken off.  Multiply by a call's spans (one root,
two ``ie.layout``, one ``ie.op.*`` a stage, one ``ie.launch.*`` a hand-kernel
launch) for the cost a call.
"""

import argparse
import json
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from imageenhancement_mp_tpu_torch.tracing import span  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--number", type=int, default=1_000_000)
    n = ap.parse_args().number
    kernel = "sep_conv_u8"

    def empty():
        pass

    def stage():
        with span("ie.layout"):
            pass

    def launch():
        with span("ie.launch." + kernel):
            pass

    def ns(fn, number):
        return min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e9

    base = ns(empty, n)
    out = {"empty_call_ns": base, "stage_span_ns": ns(stage, n) - base,
           "launch_span_ns": ns(launch, n) - base}
    with profile(activities=[ProfilerActivity.CPU]):
        m = max(n // 100, 100)
        out["profiled_stage_span_ns"] = ns(stage, m) - base
        out["profiled_launch_span_ns"] = ns(launch, m) - base
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
