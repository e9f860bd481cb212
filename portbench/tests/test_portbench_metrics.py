"""Each metric's reader on a record, and the bytes floor of the roofline."""

from __future__ import annotations

import pytest

from portbench import harness

TRACE = {"calls": 4, "kernels": 10, "hand_kernels": 8, "busy_s": 0.002, "window_s": 0.0025,
         "device_ops": [], "idle_gaps": []}
RECORD = {"setup_s": 9.5, "calls": 1000, "window_s": 10.0, "frame_pixels": 1000 * 64 * 1080 * 1920,
          "latency_ms": [float(i) for i in range(1, 101)], "enqueue_us": [50.0, 70.0, 60.0],
          "input_bytes": 64 * 1080 * 1920, "output_bytes": 64 * 1080 * 1920,
          "device_kind": "NVIDIA H100 80GB HBM3", "trace": TRACE}


def read(name, record=RECORD):
    return harness.load_module("metrics", name).read(record)


def test_end_to_end_readers():
    assert read("throughput_gpix_s") == pytest.approx(13.27104)
    assert read("batch_p95_ms") == pytest.approx(95.05)
    assert read("setup_s") == 9.5


def test_per_layer_readers():
    assert read("host_enqueue_us") == 60.0
    assert read("device_kernels_per_call") == 2.5
    assert read("device_idle_pct") == pytest.approx(20.0)
    # 2 B/px at 3.35 TB/s over 0.5 ms of busy time a call
    assert read("call_roofline") == pytest.approx(100 * 2 * 64 * 1080 * 1920 / 3.35e12 / 0.0005)


def test_bytes_floor_counts_each_byte_once():
    floor = harness.load_module("metrics", "call_roofline").floor_seconds
    assert floor(64 * 1080 * 1920, 64 * 1080 * 1920, 3.35e12) == pytest.approx(79.24e-6, rel=1e-3)
    # RGB: 16 frames of 1080p x 3 in and out
    assert floor(16 * 1080 * 1920 * 3, 16 * 1080 * 1920 * 3, 3.35e12) == pytest.approx(59.43e-6,
                                                                                        rel=1e-3)


@pytest.mark.parametrize("name", ["device_kernels_per_call", "device_idle_pct", "call_roofline"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert read(name, {**RECORD, "trace": None}) is None
    assert read(name, {**RECORD, "trace": {**TRACE, "kernels": 0, "busy_s": 0.0}}) is None


def test_roofline_reads_nothing_on_a_card_without_a_peak():
    assert read("call_roofline", {**RECORD, "device_kind": "cpu"}) is None
