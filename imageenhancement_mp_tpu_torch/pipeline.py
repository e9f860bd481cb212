"""Pipelines: named op chains (``make_pipeline``), the fused main path
(``equalize_unsharp``), and a streaming loop that overlaps host-to-device
copies with compute (``stream_frames``)."""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.conv import sep_conv_u8
from imageenhancement_mp_tpu_torch.kernels.hist import hist256_equalize_lut
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY
from imageenhancement_mp_tpu_torch.ops.filters import q8_taps
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["OP_REGISTRY", "make_pipeline", "stream_frames", "equalize_unsharp"]

Stage = tuple[str, dict[str, Any]]
_DTYPES = (torch.uint8, torch.uint16, torch.int16, torch.float32)


def _normalize_stages(stages: Sequence[Stage | str]) -> tuple:
    """Validate and freeze stage specs: ``name`` or ``(name, kwargs)``."""
    norm = []
    for s in stages:
        name, kwargs = (s, {}) if isinstance(s, str) else s
        fn = OP_REGISTRY[name]  # KeyError for an unknown name
        kwargs = dict(kwargs)
        if "backend" in kwargs:
            raise TypeError(f"stage {name!r}: the port's ops take no 'backend' argument")
        norm.append((fn, kwargs))
    return tuple(norm)


def make_pipeline(stages: Sequence[Stage | str], channels_last: bool = True,
                  mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Compose named stages into one callable over batched images
    ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or ``[N,H,W,C]``, per plane.

    ``stages``: a sequence of ``name`` or ``(name, kwargs)``, names from
    :data:`OP_REGISTRY`.  ``channels_last=False`` reads 3-D inputs as
    ``[N, H, W]`` even when W ≤ 4.  Example (config 5)::

        pipe = make_pipeline([
            ("median_blur", {"ksize": 5}),
            ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
            ("unsharp_mask", {"amount": 1.0}),
        ])
        out = pipe(batch_u8)

    The stages run one after another on the input's device, each through
    its kernels on CUDA.  ``mesh`` (multi-GPU) is not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError("make_pipeline(mesh=...) is ROADMAP Queue 1 item 12")
    chain = _normalize_stages(stages)

    def run(img: torch.Tensor) -> torch.Tensor:
        if img.dtype not in _DTYPES:
            raise TypeError(f"expected uint8/uint16/int16/float32 image tensor, got {img.dtype}")
        planes, restore = as_planes(img, channels_last=channels_last)
        for fn, kwargs in chain:
            planes = fn(planes, **kwargs)
        return restore(planes)

    return run


def stream_frames(pipe: Callable[[torch.Tensor], torch.Tensor],
                  frames: Iterable[np.ndarray | torch.Tensor], depth: int = 2, *,
                  device: str | torch.device) -> Iterator[torch.Tensor]:
    """Run ``pipe`` over host frames or batches, yielding its outputs on
    ``device`` in order, with up to ``depth`` batches in flight.

    ``frames``: NumPy arrays or CPU tensors.  On ``device="cpu"`` each is
    simply passed to ``pipe``.  On a CUDA device each batch is copied into one
    of ``depth`` pinned host buffers and sent with a non-blocking copy on a
    dedicated copy stream.  Batch t+1 is sent before batch t's pipeline is
    queued, so its copy overlaps batch t's compute; the compute stream waits
    on an event recorded after each copy, and ``record_stream`` keeps the
    device input alive until its compute is done.  A pinned buffer is
    refilled only after its previous copy ended.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"stream_frames: no path for device {dev}")

    def host(frame) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) else frame
        if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
            raise TypeError("stream_frames takes NumPy arrays or CPU tensors")
        return t

    if dev.type == "cpu":
        for frame in frames:
            yield pipe(host(frame))
        return

    compute = torch.cuda.current_stream(dev)
    copy_stream = torch.cuda.Stream(dev)
    pinned: list[torch.Tensor | None] = [None] * depth
    copied: list[torch.cuda.Event | None] = [None] * depth

    def send(i: int, frame) -> tuple[torch.Tensor, torch.cuda.Event]:
        """Stage batch ``i`` in its pinned slot and queue its copy."""
        src, slot = host(frame), i % depth
        if copied[slot] is not None:
            copied[slot].synchronize()  # the slot's previous copy has left it
        buf = pinned[slot]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = pinned[slot] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        with torch.cuda.stream(copy_stream):
            on_dev = buf.to(dev, non_blocking=True)
            event = copied[slot] = torch.cuda.Event()
            event.record(copy_stream)
        return on_dev, event

    batches = enumerate(frames)
    following = next(batches, None)
    sent = None if following is None else send(*following)
    pending: deque = deque()
    while sent is not None:
        on_dev, event = sent
        following = next(batches, None)
        sent = None if following is None else send(*following)
        compute.wait_event(event)
        on_dev.record_stream(compute)
        with torch.cuda.stream(compute):
            pending.append(pipe(on_dev))
        if len(pending) >= depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def equalize_unsharp(img: torch.Tensor, amount: float = 1.0, ksize: int = 5,
                     sigma: float = 0.0) -> torch.Tensor:
    """hist-eq → unsharp on u8 images ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or
    ``[N,H,W,C]``, per plane; equal to
    ``ref.unsharp_mask(ref.equalize_hist(p), amount, ksize, sigma)``.

    Two launches for every shape: the histogram kernel, whose epilogue
    builds each plane's equalize LUT from its finished counts, then ONE conv
    pass that applies each plane's LUT as it loads the pixels, runs the
    Gaussian and writes the unsharp epilogue — two reads of the image and
    one write.  Any odd ``ksize``, including 1.
    """
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")
    planes, restore = as_planes(img)
    planes = planes.contiguous()
    tv, th = q8_taps(int(ksize), float(sigma))
    luts = hist256_equalize_lut(planes)
    return restore(sep_conv_u8(planes, tv, th, float(amount), luts=luts))
