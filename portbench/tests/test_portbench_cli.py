"""``run.py`` as a checkout runs it: no result and a code other than 0
without CUDA or without the program; the result line's keys; the no-JAX
check; and, on a card, a small run through the CUDA clock and the tracer."""

from __future__ import annotations

import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import devtrace, harness
from portbench import run as run_py

from .conftest import HostClock, small_cell

ARGS = ["--workload", "histeq_unsharp.gray1080p-b64", "--seed", str(2**31 + 7), "--seconds", "1",
        "--trace", "0"]


def _call(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_exits_without_a_result_when_cuda_is_missing():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    done = _call(harness.ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "CUDA" in done.stderr


def test_exits_without_a_result_in_a_checkout_of_only_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _call(tmp_path)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageenhancement_mp_tpu_torch_like", object())
    assert "imageenhancement_mp_tpu" not in run_py.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run_py.forbidden_modules() == ["jaxlib"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts

    cell = small_cell("histeq_unsharp.gray1080p-b64")
    record = harness.run_cell(cell, 8, 0.1, trace, torch.device("cpu"), HostClock(),
                              time.perf_counter(),
                              tracer=lambda rc: devtrace.profile_calls(rc, launch_counts))
    record.update(device_kind="test", memory_peak_bytes=0)
    result = run_py.result_line(cell, record, trace, harness.load_module)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[:5] == keys and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) == {"host_enqueue_us"}  # no device on the CPU
    else:
        assert set(result["metrics"]) == {"throughput_gpix_s", "batch_p95_ms", "setup_s"}
    assert result["checks"] == {"max_abs_lsb": {"value": 0, "limit": 0},
                                "mismatched_px": {"value": 0, "limit": 0}}


@pytest.mark.chip
@pytest.mark.parametrize("name", ["histeq_unsharp.gray1080p-b64", "denoise_clahe_sharpen.u16-4k-b2"])
def test_small_run_on_the_card(cuda_device, name):
    from imageenhancement_mp_tpu_torch.kernels._build import launch_counts

    cell = small_cell(name)
    record = harness.run_cell(cell, 2**31 + 1, 0.5, True, cuda_device,
                              harness.CudaClock(cuda_device), time.perf_counter(),
                              tracer=lambda rc: devtrace.profile_calls(rc, launch_counts))
    assert record["checks"]["failed"] == 0
    assert record["trace"]["hand_kernels"] > 0 and record["trace"]["busy_s"] > 0
    assert all(lat > 0 for lat in record["latency_ms"])
