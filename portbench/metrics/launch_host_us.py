"""Median host time of one hand-kernel launch: the duration of the
``ie.launch.*`` spans (``kernels/_build.py::launch``: the stream lookup and
the ctypes call) of the traced calls, in µs, the profiler's cost included."""

import statistics


def read(record: dict) -> float | None:
    launches = (record.get("trace") or {}).get("program", {}).get("launch_us")
    return statistics.median(launches) if launches else None
