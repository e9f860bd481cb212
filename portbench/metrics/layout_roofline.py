"""The layout's share of its bytes roofline: the HWC batch read once and
its planes written once (2 × the input bytes), over the device time of the
operations launched inside ``ie.layout`` a traced call.  Gray batches copy
nothing there: no device time, no reading."""

from portbench.spans import stage_roofline


def read(record: dict) -> float | None:
    return stage_roofline(record, "ie.layout", 2 * record["input_bytes"])
