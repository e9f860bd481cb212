"""Frame pixels (H·W, channels not counted) of every batch completed in the
window, over the window: from the first call to the last completion."""


def read(record: dict) -> float | None:
    return record["frame_pixels"] / record["window_s"] / 1e9
