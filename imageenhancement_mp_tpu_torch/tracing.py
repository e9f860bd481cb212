"""Spans of the port on the profiler's clock.

``span(name)`` marks a part of a call (the entry, the layout, a stage, a
kernel launch) with ``torch.profiler.record_function`` while a torch
profiler is recording, so the span lands in the same trace as the device
operations it launched, tied to them by the runtime calls' ``correlation``.
With no profiler recording it returns one shared no-op context, and costs
one boolean read: an unguarded ``record_function`` enters the profiler's
dispatcher on every call whether or not anything records.

The check reads ``torch.autograd.profiler._is_profiler_enabled``, the flag
every profiler started from Python (``torch.profiler.profile``,
``torch.autograd.profiler.profile``, ``emit_nvtx``) sets while it runs: a
module attribute read, about a tenth of the cost of asking the C++ side
(``torch._C._autograd._profiler_enabled()``), which would also see a
profiler started from C++ alone, which nothing here starts.

Span names: ``ie.equalize_unsharp`` and ``ie.pipeline`` (a call's root),
``ie.layout`` (canonical planes in and out), ``ie.op.<name>`` (one stage,
its ``OP_REGISTRY`` name) and ``ie.launch.<kernel>`` (one hand-kernel launch,
the name ``kernels._build.launch_counts`` counts it under).
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span"]

_NOOP = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a torch profiler records, else a
    shared no-op context manager."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NOOP
