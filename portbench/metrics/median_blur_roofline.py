"""The ``median_blur`` stage's share of its bytes roofline: each input byte read
once and each output byte written once (the stage keeps the call's plane
shape and dtype), over the device time of the operations launched inside
``ie.op.median_blur`` a traced call."""

from portbench.spans import stage_roofline


def read(record: dict) -> float | None:
    return stage_roofline(record, "ie.op.median_blur",
                          record["input_bytes"] + record["output_bytes"])
