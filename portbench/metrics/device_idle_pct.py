"""Share of the traced window in which no operation runs on the device."""


def read(record: dict) -> float | None:
    trace = record.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
