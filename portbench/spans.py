"""The program's own spans in a trace: device time by stage, host time by
kernel launch.

The port marks each call under a torch profiler (``imageenhancement_mp_tpu_
torch/tracing.py``): a root span, ``ie.layout`` around the canonical planes
in and out, one ``ie.op.<name>`` a stage and ``ie.launch.<kernel>`` around
each hand-kernel launch.  Each device operation (a kernel, a copy or a fill)
is given to a stage through the runtime call that launched it, matched by
``correlation``: the innermost ``ie.layout`` or ``ie.op.*`` span that holds
that call on its thread.  A stage's device time is the union of its
operations' intervals; operations with no stage span around their launch
(the program's outside a stage, or a program without spans) are
``unattributed``.  Reads the Chrome export that ``devtrace`` reads.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from portbench.devtrace import DEVICE_CATS, _union

__all__ = ["STAGE_PREFIXES", "LAUNCH_PREFIX", "reduce_spans", "stage_roofline"]

STAGE_PREFIXES = ("ie.layout", "ie.op.")
LAUNCH_PREFIX = "ie.launch."
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def _stage_of_calls(calls: list[dict], stages: list[dict]) -> dict:
    """``correlation`` of each runtime call -> the name of the innermost stage
    span that holds it on its thread (calls in no stage span left out).
    The profiler's spans on one thread nest, so a stack holds those open."""
    by_tid: dict = defaultdict(lambda: ([], []))
    for s in stages:
        by_tid[s["tid"]][0].append(s)
    for c in calls:
        by_tid[c["tid"]][1].append(c)
    out = {}
    for spans, tid_calls in by_tid.values():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        tid_calls.sort(key=lambda e: e["ts"])
        open_: list = []
        j = 0
        for c in tid_calls:
            t = c["ts"]
            while j < len(spans) and spans[j]["ts"] <= t:
                s = spans[j]
                while open_ and open_[-1]["ts"] + open_[-1]["dur"] < s["ts"]:
                    open_.pop()
                open_.append(s)
                j += 1
            while open_ and open_[-1]["ts"] + open_[-1]["dur"] < t:
                open_.pop()
            if open_:
                out[c["args"]["correlation"]] = open_[-1]["name"]
    return out


def reduce_spans(events: list[dict]) -> dict:
    """The program's spans of a Chrome trace's ``events``: ``stages`` (each
    stage span's name -> ``device_s``, the union of its device operations'
    intervals, and ``ops``, their count; 0 for a stage that launched
    nothing), ``unattributed_s`` (the union of the device operations
    launched outside every stage span) and ``launch_us`` (the duration of
    each ``ie.launch.*`` span, in order of start)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    program = [e for e in spans if e.get("cat") == "user_annotation"
               and e["name"].startswith("ie.")]
    stages = [e for e in program if e["name"].startswith(STAGE_PREFIXES)]
    calls = [e for e in spans if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})]
    stage_of = _stage_of_calls(calls, stages)
    intervals: dict = {s["name"]: [] for s in stages}
    intervals[None] = []
    for op in device:
        name = stage_of.get(op.get("args", {}).get("correlation"))
        intervals[name].append((op["ts"], op["ts"] + op["dur"]))

    def seconds(iv):
        return sum(e - s for s, e in _union(iv)) / 1e6

    unattributed = intervals.pop(None)
    return {"stages": {name: {"device_s": seconds(iv), "ops": len(iv)}
                       for name, iv in sorted(intervals.items())},
            "unattributed_s": seconds(unattributed),
            "launch_us": [e["dur"] for e in sorted(program, key=lambda e: e["ts"])
                          if e["name"].startswith(LAUNCH_PREFIX)]}


def stage_roofline(record: dict, span: str, floor_bytes: int) -> float | None:
    """A stage's share, in %, of its bytes roofline: ``floor_bytes`` at the
    card's published memory bandwidth (``peaks.json``) over the stage's
    device time a traced call (``record["trace"]["program"]``, from
    :func:`reduce_spans`).  None where the stage left no device time or the
    card has no peak."""
    trace = record.get("trace") or {}
    stage = trace.get("program", {}).get("stages", {}).get(span)
    peak = PEAKS.get(record.get("device_kind"))
    if not stage or not stage["device_s"] or peak is None:
        return None
    return 100.0 * floor_bytes / peak["hbm_bytes_per_s"] / (stage["device_s"] / trace["calls"])
