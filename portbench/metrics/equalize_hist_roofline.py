"""The ``equalize_hist`` stage's share of its bytes roofline: each input
byte read once; its output, one LUT a plane, counted as 0 (a lower bound),
over the device time of the operations launched inside ``ie.op.equalize_hist``
a traced call."""

from portbench.spans import stage_roofline


def read(record: dict) -> float | None:
    return stage_roofline(record, "ie.op.equalize_hist", record["input_bytes"])
