"""The 95th percentile over all batches of the window of the time from the
call into the entry point to the batch's output being complete on the
device (a CUDA event after the call, on the host's clock)."""

import numpy as np


def read(record: dict) -> float | None:
    return float(np.percentile(record["latency_ms"], 95))
