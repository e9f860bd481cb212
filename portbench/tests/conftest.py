"""Fixtures of the benchmark's CPU tests.  Imports no JAX: the run drives
only the port and the plain references."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


class HostClock:
    """The harness's clock on the CPU, where every call has finished when it
    returns: a mark is the host time after the call.  Like the CUDA clock,
    it reads a mark only after ``start``."""

    started = False

    def start(self):
        self.started = True

    def mark(self):
        return time.perf_counter()

    def wait(self, mark):
        pass

    def read(self, mark):
        if not self.started:
            raise ValueError("read before start")
        return mark

    def finish(self):
        pass

    def to_host(self, t):
        return t


SMALL = {"gray1080p-b64": (3, 37, 131), "gray4k-b16": (2, 48, 64), "rgb1080p-b16": (2, 33, 70),
         "u16-4k-b2": (2, 40, 72)}


def small_cell(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json with its mix cut to a few small
    frames, a small pool and few traced calls."""
    cell = copy.deepcopy(harness.load_cell(name))
    n, h, w = SMALL[cell.traffic_name]
    cell.traffic.update(frames=n, height=h, width=w, trace_calls=3, sample=3,
                        pool={"min_batches": 3, "min_bytes": 0})
    return cell


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
