"""The traced part of a run: torch.profiler over a fixed number of calls,
reduced to what the per-layer readers and the result's ``breakdown`` need.

The trace is read from its Chrome export.  Device operations are the
events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; busy time
is the union of their intervals; the window runs from the first
``portbench.call`` span to the end of the last device operation.  A kernel
is one of the program's hand kernels unless the runtime call that launched
it (matched by ``correlation``) lies inside an ``aten::`` op: torch's own
kernels are launched from inside its ops, the port's through ctypes.  The
trace is refused, and the run with it, when it lost events: fewer kernels
than launch calls, or fewer hand kernels than the program's own launch
counter (``kernels/_build.py::launch_counts``) counted over the same calls.
"""

from __future__ import annotations

import bisect
import heapq
import json
import tempfile
from collections import defaultdict
from pathlib import Path

__all__ = ["TraceLost", "profile_calls", "reduce_trace"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class TraceLost(RuntimeError):
    """The profiler dropped events: the traced numbers would under-read."""


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _inside_ops(launches: list[dict], ops: list[dict]) -> list[dict]:
    """The launch events that an ``aten::`` op of their thread contains."""
    by_tid: dict = defaultdict(list)
    for op in ops:
        by_tid[op["tid"]].append((op["ts"], op["ts"] + op["dur"]))
    spans = {tid: _union(iv) for tid, iv in by_tid.items()}
    starts = {tid: [s for s, _ in iv] for tid, iv in spans.items()}
    out = []
    for ev in launches:
        iv = spans.get(ev["tid"], [])
        j = bisect.bisect_right(starts.get(ev["tid"], []), ev["ts"]) - 1
        if j >= 0 and ev["ts"] <= iv[j][1]:
            out.append(ev)
    return out


def _host_labels(starts: list[float], host: list[dict]) -> list[str]:
    """What the host was doing at each of the sorted times ``starts``: the
    outermost and the innermost span that contain it."""
    ordered = sorted(host, key=lambda e: e["ts"])
    active: list = []
    labels, j = [], 0
    for t in starts:
        while j < len(ordered) and ordered[j]["ts"] <= t:
            e = ordered[j]
            heapq.heappush(active, (e["ts"] + e["dur"], e["ts"], -e["dur"], e["name"]))
            j += 1
        while active and active[0][0] <= t:
            heapq.heappop(active)
        if not active:
            labels.append("harness loop")
            continue
        inside = sorted((ts, neg, name) for _, ts, neg, name in active)
        outer, inner = inside[0][2], inside[-1][2]
        labels.append(outer if outer == inner else f"{outer} > {inner}")
    return labels


def reduce_trace(events: list[dict], calls: int, hand_launches: int | None) -> dict:
    """The numbers of a trace of ``calls`` calls: window and busy seconds,
    device ops, hand kernels, the top device ops and idle gaps."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in device if e["cat"] == "kernel"]
    host = [e for e in spans if e.get("cat") in HOST_CATS]
    launches = [e for e in host if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e["name"]]
    ops = [e for e in host if e["cat"] == "cpu_op" and e["name"].startswith("aten::")]
    call_spans = [e for e in host if e["name"] == "portbench.call"]
    if len(kernels) < len(launches):
        raise TraceLost(f"{len(launches)} kernel launches but {len(kernels)} kernels in the trace")
    torch_corr = {e.get("args", {}).get("correlation") for e in _inside_ops(launches, ops)}
    hand = [k for k in kernels if k.get("args", {}).get("correlation") not in torch_corr]
    if hand_launches is not None and len(hand) != hand_launches:
        raise TraceLost(f"the program counted {hand_launches} hand-kernel launches, "
                        f"the trace holds {len(hand)}")
    if not call_spans or not device:
        return {"calls": calls, "kernels": len(kernels), "hand_kernels": len(hand),
                "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    w0 = min(e["ts"] for e in call_spans)
    w1 = max(max(e["ts"] + e["dur"] for e in device), max(e["ts"] + e["dur"] for e in call_spans))
    busy = [(max(s, w0), min(e, w1)) for s, e in _union(
        [(e["ts"], e["ts"] + e["dur"]) for e in device]) if e > w0 and s < w1]
    busy_us = sum(e - s for s, e in busy)
    by_name: dict = defaultdict(float)
    for e in device:
        by_name[e["name"][:160]] += e["dur"] / 1e6
    gaps = []
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle: dict = defaultdict(float)
    for (s, e), label in zip(gaps, _host_labels([s for s, _ in gaps], host)):
        idle[label] += (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"calls": calls, "kernels": len(kernels), "hand_kernels": len(hand),
            "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def profile_calls(run_calls, launch_counts: dict | None) -> dict:
    """Profile ``run_calls()`` (which makes the traced calls, each in a
    ``portbench.call`` span, and waits for them) and reduce its trace;
    ``launch_counts`` is the program's counter of hand-kernel launches."""
    from torch.profiler import ProfilerActivity, profile

    before = dict(launch_counts) if launch_counts is not None else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls = len(run_calls()[0])
    hand = None
    if before is not None:
        hand = sum(n - before.get(k, 0) for k, n in launch_counts.items())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return reduce_trace(events, calls, hand)
