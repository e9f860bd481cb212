"""The program's spans read from a trace (``spans.py``): device operations
given to stages through ``correlation``, a union per stage, the
unattributed rest, the launch spans; the stage readers' floors; and
``devtrace.reduce_trace`` unchanged beside them but for the idle gaps'
labels, which name the program's innermost span."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import devtrace, harness, spans, stages

from .conftest import HostClock, small_cell
from .test_portbench_harness import _trace_events


def _x(cat, name, ts, dur, corr=None, tid=1):
    ev = {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _program_trace():
    """Two calls of config 5's shape: a layout copy launched inside an aten
    op, two hand kernels each inside ``ie.launch.*`` inside ``ie.op.clahe``,
    two overlapping torch kernels of ``ie.op.unsharp_mask`` and a fill
    launched in the root span outside every stage."""
    ev = []
    for c, t0 in enumerate((0.0, 200.0)):
        k = 10 * c
        ev += [_x("user_annotation", "portbench.call", t0, 100),
               _x("user_annotation", "ie.pipeline", t0 + 1, 98),
               _x("user_annotation", "ie.layout", t0 + 2, 8),
               _x("cpu_op", "aten::copy_", t0 + 3, 6),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 4, 1, k + 1),
               _x("kernel", "elementwise_kernel", t0 + 20, 10, k + 1, tid=7),
               _x("user_annotation", "ie.op.clahe", t0 + 11, 29),
               _x("user_annotation", "ie.launch.tile_luts256", t0 + 12, 4),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 13, 2, k + 2),
               _x("kernel", "hist256_tiles_kernel", t0 + 30, 15, k + 2, tid=7),
               _x("user_annotation", "ie.launch.clahe_blend", t0 + 20, 3),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 21, 1, k + 3),
               _x("kernel", "clahe_blend_u8_kernel", t0 + 45, 15, k + 3, tid=7),
               _x("user_annotation", "ie.op.unsharp_mask", t0 + 41, 39),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 50, 1, k + 4),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 55, 1, k + 5),
               _x("kernel", "vectorized_elementwise_kernel", t0 + 60, 20, k + 4, tid=7),
               _x("kernel", "vectorized_elementwise_kernel", t0 + 70, 15, k + 5, tid=8),
               _x("cuda_runtime", "cudaMemsetAsync", t0 + 90, 1, k + 6),
               _x("gpu_memset", "Memset (Device)", t0 + 85, 3, k + 6, tid=7)]
    return ev


def test_device_ops_go_to_the_innermost_stage_by_correlation():
    got = spans.reduce_spans(_program_trace())
    assert got["stages"] == {
        "ie.layout": {"device_s": pytest.approx(20e-6), "ops": 2},
        "ie.op.clahe": {"device_s": pytest.approx(60e-6), "ops": 4},  # through ie.launch.*
        "ie.op.unsharp_mask": {"device_s": pytest.approx(50e-6), "ops": 4},  # 2 x union 25
    }
    assert got["unattributed_s"] == pytest.approx(6e-6)
    assert got["launch_us"] == [4, 3, 4, 3]


def test_a_program_without_spans_is_all_unattributed():
    ev = [e for e in _program_trace() if not e["name"].startswith("ie.")]
    got = spans.reduce_spans(ev)
    assert got["stages"] == {} and got["launch_us"] == []
    assert got["unattributed_s"] == pytest.approx(2 * (10 + 15 + 15 + 25 + 3) * 1e-6)


def test_reduce_trace_keeps_its_keys_and_labels_gaps_by_program_span():
    plain = devtrace.reduce_trace(_trace_events(), 2, hand_launches=2)
    ev = _trace_events()
    for t0 in (0.0, 100.0):
        ev += [_x("user_annotation", "ie.pipeline", t0, 29),
               _x("user_annotation", "ie.op.clahe", t0 + 15, 10)]
    spanned = devtrace.reduce_trace(ev, 2, hand_launches=2)
    assert list(spanned) == list(plain)
    assert {k: v for k, v in spanned.items() if k != "idle_gaps"} == \
        {k: v for k, v in plain.items() if k != "idle_gaps"}
    assert dict(spanned["idle_gaps"]) == {"harness loop": pytest.approx(40e-6),
                                          "portbench.call > ie.pipeline": pytest.approx(10e-6)}
    got = spans.reduce_spans(ev)  # the hand kernel in the stage, torch's copy outside it
    assert got["stages"] == {"ie.op.clahe": {"device_s": pytest.approx(80e-6), "ops": 2}}
    assert got["unattributed_s"] == pytest.approx(40e-6)


B = 64 * 1080 * 1920
HBM = 3.35e12


def _record(stages_s, launch_us=(10.0, 30.0, 20.0), calls=4, kind="NVIDIA H100 80GB HBM3"):
    program = {"stages": {k: {"device_s": v * calls, "ops": 1} for k, v in stages_s.items()},
               "unattributed_s": 0.0, "launch_us": list(launch_us)}
    return {"input_bytes": B, "output_bytes": B, "device_kind": kind,
            "trace": {"calls": calls, "busy_s": 1.0, "program": program}}


FLOORS = {"equalize_hist_roofline": ("ie.op.equalize_hist", B),
          "unsharp_mask_roofline": ("ie.op.unsharp_mask", 2 * B),
          "median_blur_roofline": ("ie.op.median_blur", 2 * B),
          "clahe_roofline": ("ie.op.clahe", 2 * B),
          "layout_roofline": ("ie.layout", 2 * B)}


@pytest.mark.parametrize("name", sorted(FLOORS))
def test_stage_roofline_floor_and_nothing_to_read(name):
    read = harness.load_module("metrics", name).read
    span, floor_bytes = FLOORS[name]
    assert read(_record({span: 0.0005})) == pytest.approx(100 * floor_bytes / HBM / 0.0005)
    assert read(_record({"ie.op.other": 0.0005})) is None
    assert read(_record({span: 0.0})) is None
    assert read(_record({span: 0.0005}, kind="cpu")) is None
    assert read({"input_bytes": B, "output_bytes": B, "device_kind": "cpu", "trace": None}) is None
    no_program = _record({span: 0.0005})
    del no_program["trace"]["program"]  # the trace as the harness reduces it today
    assert read(no_program) is None


def test_launch_host_us_is_the_median_launch_span():
    read = harness.load_module("metrics", "launch_host_us").read
    assert read(_record({})) == 20.0
    assert read(_record({}, launch_us=())) is None
    assert read({"trace": None}) is None


def test_a_cpu_trace_of_the_pipeline_has_its_stages_and_no_device_ops():
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts

    cell = small_cell("denoise_clahe_sharpen.u16-4k-b2")
    record = harness.run_cell(cell, 11, 0.1, True, torch.device("cpu"), HostClock(),
                              time.perf_counter(),
                              tracer=lambda rc: stages.traced(rc, launch_counts))
    trace = record["trace"]
    program = trace["program"]
    want = {"ie.layout"} | {f"ie.op.{name}" for name, _ in cell.config["stages"]}
    assert set(program["stages"]) == want
    assert all(s == {"device_s": 0.0, "ops": 0} for s in program["stages"].values())
    assert program["unattributed_s"] == 0.0 and program["launch_us"] == []
    assert trace["spans"] == trace["calls"] * (len(want) + 2)  # root and a second ie.layout
    assert len(trace["enqueue_us"]) == trace["calls"] == cell.traffic["trace_calls"]
    record["device_kind"] = "cpu"
    assert all(harness.load_module("metrics", name).read(record) is None
               for name in stages.READERS)
