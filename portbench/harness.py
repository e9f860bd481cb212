"""One run of one cell: set-up, the timed closed loop, the traced part, and
the check of the outputs against the plain reference.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that entry names, its traffic mix in
``traffic/<traffic>.json``, its reference in ``reference/<config>.py`` and
each metric's reader in ``metrics/<metric>.py``.  A later change adds a cell,
a mix, a configuration or a metric by adding files and entries.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from portbench.traffic import content

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROGRAM = "imageenhancement_mp_tpu_torch"

__all__ = ["Cell", "load_cell", "load_module", "program_entry", "CudaClock", "Sampler",
           "closed_loop", "run_cell", "compare"]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark file, with its configuration, its
    mix and the metrics it reports."""
    spec = json.loads(Path(spec_path).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, w["chips"], w["config"], config, w["traffic"], traffic,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by its path (names
    may hold ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}._{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def program_entry(config: dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """The program's callable that the configuration names: ``callable``
    (``module:function`` with ``kwargs``) or a ``factory`` called with
    ``args`` that returns it.  Only the port's modules may be named."""
    entry = config["entry"]
    target = entry.get("factory") or entry["callable"]
    module_name, func_name = target.split(":")
    if module_name.split(".")[0] != PROGRAM:
        raise ValueError(f"entry {target!r} is not in {PROGRAM}")
    fn = getattr(importlib.import_module(module_name), func_name)
    if "factory" in entry:
        return fn(*entry.get("args", []), **entry.get("kwargs", {}))
    kwargs = entry.get("kwargs", {})
    return lambda batch: fn(batch, **kwargs)


class CudaClock:
    """Completion times of the device's work on the host's clock.

    Each call gets a CUDA event after it, from a small ring that is reused
    once an event has been read, so the window allocates no object a call.
    Two anchors, recorded when the device is idle (so an event runs as it is
    queued), map the events' device timestamps onto ``time.perf_counter``:
    the start of the window and its end, which also corrects a drift between
    the two clocks."""

    def __init__(self, device: torch.device):
        self.device = device
        self.h0 = self.scale = None
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.free: list = []

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        self.h0 = time.perf_counter()
        self.e0.record()

    def mark(self):
        event = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def wait(self, mark) -> None:
        mark.synchronize()

    def read(self, mark) -> float:
        """Seconds from the start anchor to ``mark`` (complete), on the
        device's clock; the event goes back to the ring."""
        t = self.e0.elapsed_time(mark) / 1e3
        self.free.append(mark)
        return t

    def finish(self) -> None:
        torch.cuda.synchronize(self.device)
        h1 = time.perf_counter()
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        e1.synchronize()
        self.scale = (h1 - self.h0) / (self.e0.elapsed_time(e1) / 1e3)

    def to_host(self, t: float) -> float:
        return self.h0 + self.scale * t


class Sampler:
    """A seeded uniform sample of ``k`` calls' outputs (reservoir sampling):
    the outputs that are checked once the window has closed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 0x5A17])
        self.kept: list[tuple[int, torch.Tensor]] = []
        self.seen = 0

    def offer(self, pool_index: int, out: torch.Tensor) -> None:
        if self.seen < self.k:
            self.kept.append((pool_index, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (pool_index, out)
        self.seen += 1


def closed_loop(entry, pool, depth: int, clock, calls: int | None = None,
                seconds: float | None = None, first: int = 0, sampler: Sampler | None = None,
                annotate: bool = False) -> tuple[list, list, list]:
    """Call ``entry`` on ``pool[i % len(pool)]`` with at most ``depth`` batches
    outstanding: before it submits a batch it waits until the batch ``depth``
    calls back is complete.  Runs ``calls`` calls, or until ``seconds`` have
    passed since the first, then waits for all.  Returns three lists of
    floats, one entry a call: the host time of the call, of its return, and
    of its completion on ``clock``'s scale."""
    record_function = None
    if annotate:
        from torch.profiler import record_function
    pending: deque = deque()
    t_calls: list = []
    t_returns: list = []
    t_done: list = []

    def complete():
        mark = pending.popleft()
        clock.wait(mark)
        t_done.append(clock.read(mark))

    t_first = time.perf_counter()
    i = first
    while True:
        if calls is not None and i - first >= calls:
            break
        if seconds is not None and time.perf_counter() - t_first >= seconds:
            break
        if len(pending) >= depth:
            if annotate:
                with record_function("portbench.wait"):
                    complete()
            else:
                complete()
        k = i % len(pool)
        t_call = time.perf_counter()
        if annotate:
            with record_function("portbench.call"):
                out = entry(pool[k])
        else:
            out = entry(pool[k])
        t_returns.append(time.perf_counter())
        t_calls.append(t_call)
        pending.append(clock.mark())
        if sampler is not None:
            sampler.offer(k, out)
        del out
        i += 1
    while pending:
        complete()
    return t_calls, t_returns, t_done


def compare(kept, pool, reference) -> dict:
    """Hold each kept output to the reference of its input: the largest
    difference in LSB and the count of pixels that differ (shape or type
    that differs: every pixel)."""
    worst, mismatched, failed = 0, 0, 0
    while kept:
        k, out = kept.pop()
        want = reference(pool[k])
        if out.shape != want.shape or out.dtype != want.dtype:
            worst, bad = max(worst, 1 << 16), want.numel()
        else:
            diff = (out.to(torch.int32) - want.to(torch.int32)).abs_()
            worst = max(worst, int(diff.max()))
            bad = int(diff.count_nonzero())
        mismatched += bad
        failed += bad > 0
        del out, want
    return {"max_abs_lsb": worst, "mismatched_px": mismatched, "failed": failed}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             clock, t_start: float, entry=None, tracer=None, setup_parts=None) -> dict:
    """One run: pool and warm-up (set-up), the window of ``seconds``, with a
    traced part in its middle when ``trace``, then the check.  ``entry``
    replaces the program's callable (the control, or a fault in a test);
    ``tracer(run_calls)`` profiles the traced part; ``setup_parts`` holds
    the seconds of the set-up's earlier parts.  Returns the run's record for
    the metric readers."""
    mix = cell.traffic
    if entry is None:
        entry = program_entry(cell.config)
    parts = dict(setup_parts or {})
    parts["to_pool"] = time.perf_counter() - t_start - sum(parts.values())

    def part(name, since):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        parts[name] = time.perf_counter() - since

    t = time.perf_counter()
    pool = content.make_pool(mix, seed, device)
    part("pool", t)
    depth = mix["depth"]
    t = time.perf_counter()
    clock.start()
    closed_loop(entry, pool, depth, clock, calls=1)
    part("first_call", t)
    t = time.perf_counter()
    closed_loop(entry, pool, depth, clock, calls=max(2 * len(pool), 16))
    part("warm_up", t)
    record = {"setup_s": time.perf_counter() - t_start, "setup_parts": parts}
    sampler = Sampler(mix["sample"], seed)
    gc.collect()
    gc.freeze()  # the set-up's objects: no collection in the window walks them
    clock.start()
    if trace:
        half = closed_loop(entry, pool, depth, clock, seconds=seconds / 2, sampler=sampler)
        n_half = len(half[0])

        def traced_calls():
            return closed_loop(entry, pool, depth, clock, calls=mix["trace_calls"],
                               first=n_half, annotate=True)

        record["trace"] = tracer(traced_calls)
        rest = closed_loop(entry, pool, depth, clock, seconds=seconds / 2,
                           first=n_half + mix["trace_calls"], sampler=sampler)
        t_calls, t_returns, t_done = (a + b for a, b in zip(half, rest))
    else:
        t_calls, t_returns, t_done = closed_loop(entry, pool, depth, clock, seconds=seconds,
                                                 sampler=sampler)
    clock.finish()
    gc.unfreeze()
    completed = [clock.to_host(t) for t in t_done]
    record.update(
        calls=len(t_calls),
        window_s=max(completed) - t_calls[0],
        frame_pixels=content.frame_pixels(mix) * len(t_calls),
        latency_ms=[(c - t) * 1e3 for t, c in zip(t_calls, completed)],
        enqueue_us=[(r - t) * 1e6 for t, r in zip(t_calls, t_returns)],
        input_bytes=pool[0].numel() * pool[0].element_size(),
    )
    kept = sampler.kept
    record["output_bytes"] = kept[0][1].numel() * kept[0][1].element_size()
    if device.type == "cuda":
        record["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del entry
    reference = load_module("reference", cell.config_name).reference
    t = time.perf_counter()
    record["checks"] = compare(kept, pool, lambda batch: reference(batch, cell.config))
    record["check_s"] = time.perf_counter() - t
    return record
