"""Median host time of one call into the entry point, with no synchronise:
what the host spends to queue a batch (the harness's clock around each call
of the window outside the traced part, where the profiler would add its own
cost)."""

import statistics


def read(record: dict) -> float | None:
    return statistics.median(record["enqueue_us"]) if record["enqueue_us"] else None
