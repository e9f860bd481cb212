"""The run without the look for a chip: discovery by name, the closed loop,
the sample, the check and its faults, the traced part's reduction."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch

from portbench import devtrace, faults, harness

from .conftest import HostClock, small_cell
from .test_portbench_reference import CELLS

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _run(cell, entry=None, seed=3, seconds=0.15, trace=False, tracer=None):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), HostClock(),
                            time.perf_counter(), entry=entry, tracer=tracer)


def test_benchmark_file_names_only_files_that_exist():
    assert SPEC["command"] == ["python3", "portbench/run.py"] and SPEC["paths"] == ["portbench"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith("portbench/") and (harness.ROOT / c["file"]).is_file()
        assert (harness.HERE / "reference" / f"{c['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_load_cell_finds_config_mix_and_metrics(name):
    cell = harness.load_cell(name)
    assert cell.config_name in name and cell.traffic_name in name
    assert [m["name"] for m in cell.end_to_end] == ["throughput_gpix_s", "batch_p95_ms", "setup_s"]
    assert len(cell.per_layer) == 4
    assert cell.config["limits"] == {"max_abs_lsb": 0, "mismatched_px": 0}


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
    with pytest.raises(ValueError):
        harness.program_entry({"entry": {"callable": "imageenhancement_mp_tpu.pipeline:x"}})


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_exact(name):
    record = _run(small_cell(name))
    assert record["checks"] == {"max_abs_lsb": 0, "mismatched_px": 0, "failed": 0}
    assert record["calls"] >= 1 and len(record["latency_ms"]) == record["calls"]
    assert record["frame_pixels"] == record["calls"] * small_cell(name).traffic["frames"] * \
        small_cell(name).traffic["height"] * small_cell(name).traffic["width"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_faults_come_out_not_correct(name, fault):
    cell = small_cell(name)
    record = _run(cell, entry=faults.FAULTS[fault](harness.program_entry(cell.config)))
    checks = record["checks"]
    assert checks["max_abs_lsb"] > cell.config["limits"]["max_abs_lsb"]
    assert checks["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    cell = small_cell(name)
    reference = harness.load_module("reference", cell.config_name).reference
    record = _run(cell, entry=faults.control(reference, cell.config))
    assert record["checks"]["max_abs_lsb"] >= 1


def test_closed_loop_keeps_depth_outstanding():
    outstanding, peak = [], [0]

    class Clock(HostClock):
        def mark(self):
            outstanding.append(1)
            peak[0] = max(peak[0], len(outstanding))
            return len(outstanding)

        def wait(self, mark):
            outstanding.pop()

    clock = Clock()
    clock.start()
    t_calls, t_returns, t_done = harness.closed_loop(lambda x: x, [torch.zeros(1)] * 3, 2,
                                                     clock, calls=9)
    assert len(t_calls) == len(t_returns) == len(t_done) == 9
    assert peak[0] == 2 and not outstanding


def test_sample_is_drawn_from_the_seed():
    def kept(seed):
        s = harness.Sampler(4, seed)
        for i in range(500):
            s.offer(i % 7, torch.tensor(i))
        return [int(t) for _, t in s.kept]

    assert kept(9) == kept(9) and kept(9) != kept(10) and len(set(kept(2**33))) == 4


def _trace_events():
    """A synthetic Chrome trace: two calls, a torch kernel (launched inside
    an aten op) and a hand kernel (launched outside) each."""
    ev = []
    for c, t0 in enumerate((0.0, 100.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "portbench.call", "tid": 1,
                   "ts": t0, "dur": 30.0})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "tid": 1,
                   "ts": t0 + 2, "dur": 10.0})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                   "ts": t0 + 5, "dur": 2.0, "args": {"correlation": 10 * c + 1}})
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                   "ts": t0 + 20, "dur": 2.0, "args": {"correlation": 10 * c + 2}})
        ev.append({"ph": "X", "cat": "kernel", "name": "void at::copy_kernel", "tid": 7,
                   "ts": t0 + 10, "dur": 20.0, "args": {"correlation": 10 * c + 1}})
        ev.append({"ph": "X", "cat": "kernel", "name": "hist256_kernel", "tid": 7,
                   "ts": t0 + 30, "dur": 40.0, "args": {"correlation": 10 * c + 2}})
    return ev


def test_reduce_trace_reads_busy_idle_and_hand_kernels():
    t = devtrace.reduce_trace(_trace_events(), 2, hand_launches=2)
    assert t["kernels"] == 4 and t["hand_kernels"] == 2
    assert t["window_s"] == pytest.approx(170e-6) and t["busy_s"] == pytest.approx(120e-6)
    assert t["device_ops"][0] == ["hist256_kernel", pytest.approx(80e-6)]
    assert sum(s for _, s in t["idle_gaps"]) == pytest.approx(50e-6)
    labels = dict(t["idle_gaps"])
    assert labels == {"harness loop": pytest.approx(40e-6), "portbench.call": pytest.approx(10e-6)}


def test_reduce_trace_refuses_lost_events():
    events = _trace_events()
    with pytest.raises(devtrace.TraceLost):
        devtrace.reduce_trace(events, 2, hand_launches=3)
    lost = [e for e in events if e.get("args", {}).get("correlation") != 12 or e["cat"] != "kernel"]
    with pytest.raises(devtrace.TraceLost):
        devtrace.reduce_trace(lost, 2, hand_launches=1)


def test_traced_run_on_the_cpu_reads_no_device():
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts

    cell = small_cell(CELLS[0])
    record = _run(cell, trace=True,
                  tracer=lambda run_calls: devtrace.profile_calls(run_calls, launch_counts))
    assert record["trace"]["calls"] == cell.traffic["trace_calls"]
    assert record["trace"]["kernels"] == 0 and record["checks"]["failed"] == 0
