"""Host-side IO runtime: native prefetching frame loader + async writer."""

from imageenhancement_mp_tpu_torch.io.loader import FrameError, FrameLoader
from imageenhancement_mp_tpu_torch.io.writer import FrameWriter

__all__ = ["FrameError", "FrameLoader", "FrameWriter"]
