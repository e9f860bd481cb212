"""Kernels on the device per call: the profiler's kernel events of the
traced calls (torch's and the port's), over those calls."""


def read(record: dict) -> float | None:
    trace = record.get("trace")
    if not trace or not trace["kernels"]:
        return None
    return trace["kernels"] / trace["calls"]
