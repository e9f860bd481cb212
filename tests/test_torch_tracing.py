"""The port's spans (``tracing.py``): under a torch profiler each call of the
two benchmarked entries is one root span holding ``ie.layout``, one
``ie.op.<stage>`` a configured stage in order and ``ie.layout``, and each
hand-kernel launch an ``ie.launch.<kernel>`` span; with no profiler the
spans enter no ``record_function``; outputs and launch counts are the same
either way."""

import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu_torch import tracing
from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts
from imageenhancement_mp_tpu_torch.models.presets import get_preset

CONFIGS = Path(__file__).resolve().parents[1] / "portbench" / "configs"


def _stages(config: str) -> list[str]:
    return [name for name, _ in json.loads((CONFIGS / f"{config}.json").read_text())["stages"]]


def _batch(shape, dtype, seed):
    hi = 4096 if dtype == torch.uint16 else 256
    return torch.from_numpy(np.random.default_rng(seed).integers(0, hi, shape)).to(dtype)


# (entry, its root span, the benchmark configuration it runs, input)
CASES = {
    "eq_unsharp_gray": (tie.equalize_unsharp, "ie.equalize_unsharp", "histeq_unsharp",
                        ((2, 24, 40), torch.uint8)),
    "eq_unsharp_rgb": (tie.equalize_unsharp, "ie.equalize_unsharp", "histeq_unsharp",
                       ((2, 20, 36, 3), torch.uint8)),
    "config5_u8": (get_preset("denoise_clahe_sharpen"), "ie.pipeline", "denoise_clahe_sharpen",
                   ((2, 32, 40), torch.uint8)),
    "config5_u16": (get_preset("denoise_clahe_sharpen"), "ie.pipeline", "denoise_clahe_sharpen",
                    ((2, 32, 40), torch.uint16)),
}


def _trace(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("ie.")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_call_is_a_root_span_with_layout_and_stages_in_order(case, tmp_path):
    entry, root, config, (shape, dtype) = CASES[case]
    x = _batch(shape, dtype, 1)
    _, spans = _trace(lambda: [entry(x), entry(x)], tmp_path)
    roots = sorted((e for e in spans if e["name"] == root), key=lambda e: e["ts"])
    assert len(roots) == 2
    want = ["ie.layout"] + [f"ie.op.{s}" for s in _stages(config)] + ["ie.layout"]
    inner_all = 0
    for r in roots:
        inner = sorted((e for e in spans if e is not r and r["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= r["ts"] + r["dur"]), key=lambda e: e["ts"])
        assert [e["name"] for e in inner] == want
        inner_all += len(inner)
    assert inner_all == len(spans) - 2  # no span of the program outside a call's root


def test_no_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(tracing, "record_function", refuse)
    noop = tracing.span("ie.a")
    assert noop is tracing.span("ie.b") and isinstance(noop, contextlib.nullcontext)
    for entry, _, _, (shape, dtype) in CASES.values():
        assert entry(_batch(shape, dtype, 2)).dtype == dtype


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_equal_with_and_without_the_profiler(case, tmp_path):
    entry, _, _, (shape, dtype) = CASES[case]
    x = _batch(shape, dtype, 3)
    traced, spans = _trace(lambda: entry(x), tmp_path)
    assert spans
    plain = entry(x)
    assert traced.dtype == plain.dtype and torch.equal(traced, plain)


def test_launch_is_a_span_under_the_profiler_and_counts_once_either_way(monkeypatch, tmp_path):
    calls = []
    lib = SimpleNamespace(ie_hist256=lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: SimpleNamespace(cuda_stream=7))
    before = launch_counts["hist256"]
    _build.launch("hist256", torch.device("cpu"), 1, 2)
    assert launch_counts["hist256"] == before + 1
    _, spans = _trace(lambda: _build.launch("hist256", torch.device("cpu"), 3, 4), tmp_path)
    assert [e["name"] for e in spans] == ["ie.launch.hist256"]
    assert launch_counts["hist256"] == before + 2
    assert calls == [(1, 2, 7), (3, 4, 7)]
