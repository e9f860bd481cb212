"""A call's share of its bytes roofline: the least time the card could take
to read each input byte once and write each output byte once, at the
published memory bandwidth (``peaks.json``), over the call's device-busy
time (the union of device operations in the traced window, over its calls).

The floor is worked out from the shapes and dtypes alone, so it reads the
same work whatever kernels implement it.  Every stage of these pipelines
does a handful of integer operations a byte, far below the card's
operations-per-byte balance, so bytes bound the call.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())


def floor_seconds(input_bytes: int, output_bytes: int, bytes_per_s: float) -> float:
    """Least time to move a call's bytes: each input byte read once and each
    output byte written once."""
    return (input_bytes + output_bytes) / bytes_per_s


def read(record: dict) -> float | None:
    trace = record.get("trace")
    peak = PEAKS.get(record.get("device_kind"))
    if not trace or not trace["busy_s"] or peak is None:
        return None
    floor = floor_seconds(record["input_bytes"], record["output_bytes"], peak["hbm_bytes_per_s"])
    return 100.0 * floor / (trace["busy_s"] / trace["calls"])
