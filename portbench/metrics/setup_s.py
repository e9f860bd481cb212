"""Seconds from the start of the process (the first line of ``run.py``) to
the first timed call: imports, CUDA, the kernel library (built on a
checkout's first run), the input pool and the warm-up calls."""


def read(record: dict) -> float | None:
    return record["setup_s"]
