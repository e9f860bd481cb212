"""Pipelines: named op chains (``make_pipeline``, on one device or over a
mesh), the fused main path (``equalize_unsharp``), and a streaming loop that
overlaps host-to-device copies with compute (``stream_frames``)."""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels.conv import sep_conv_u8
from imageenhancement_mp_tpu_torch.kernels.hist import hist256_equalize_lut
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY
from imageenhancement_mp_tpu_torch.ops.filters import q8_taps
from imageenhancement_mp_tpu_torch.parallel.mesh import Mesh, ShardedTensor, _split, run_sharded
from imageenhancement_mp_tpu_torch.tracing import span
from imageenhancement_mp_tpu_torch.utils.shapes import as_planes

__all__ = ["OP_REGISTRY", "make_pipeline", "stream_frames", "equalize_unsharp"]

Stage = tuple[str, dict[str, Any]]
_DTYPES = (torch.uint8, torch.uint16, torch.int16, torch.float32)


def _normalize_stages(stages: Sequence[Stage | str]) -> tuple:
    """Validate and freeze stage specs: ``name`` or ``(name, kwargs)``, as
    ``(name, fn, kwargs)``."""
    norm = []
    for s in stages:
        name, kwargs = (s, {}) if isinstance(s, str) else s
        fn = OP_REGISTRY[name]  # KeyError for an unknown name
        kwargs = dict(kwargs)
        if "backend" in kwargs:
            raise TypeError(f"stage {name!r}: the port's ops take no 'backend' argument")
        norm.append((name, fn, kwargs))
    return tuple(norm)


def _planes_count(shape: tuple, channels_last: bool) -> int:
    """Leading dim of the canonical ``[B, H, W]`` planes stack for ``shape``."""
    nd = len(shape)
    if nd == 2:
        return 1
    if nd == 3:
        return shape[-1] if channels_last and shape[-1] in (1, 2, 3, 4) else shape[0]
    if nd == 4:
        return shape[0] * shape[-1]
    raise ValueError(f"expected 2-4 dims ([N,]H,W[,C]), got shape {tuple(shape)}")


def _layout(shape: tuple, channels_last: bool) -> tuple[bool, int]:
    """``(batch, rows)``: whether ``shape`` is a batch of frames (its
    leading dim counts frames) and the dimension that holds the rows."""
    nd = len(shape)
    hwc = nd == 4 or (nd == 3 and channels_last and shape[-1] in (1, 2, 3, 4))
    return nd == 4 or (nd == 3 and not hwc), nd - (3 if hwc else 2)


def _mesh_spec(shape: tuple, channels_last: bool, mesh: Mesh, shard: str,
               axis_name: str | None):
    """The split ``stream_frames`` gives a frame or batch of ``shape`` for
    ``make_pipeline(mesh=mesh, shard=shard, axis_name=axis_name)``: a
    partition spec, or None where a single frame stays whole (batch
    sharding)."""
    ax = axis_name or mesh.axis_names[0]
    batch, rows = _layout(shape, channels_last)
    if shard == "spatial":
        return (None,) * rows + (ax,)
    return (ax,) if batch else None


def make_pipeline(stages: Sequence[Stage | str], channels_last: bool = True, mesh: Mesh = None,
                  shard: str = "batch",
                  axis_name: str | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
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
    its kernels on CUDA.  Under a torch profiler a call is one ``ie.pipeline``
    span holding ``ie.layout`` (planes in), one ``ie.op.<name>`` a stage and
    ``ie.layout`` (planes out) (``tracing.py``).

    **A mesh** (``parallel/mesh.py``): the same stages run once per shard,
    each shard's part on its device —

    * ``shard="batch"``: planes split on the leading dim (no collective; a
      stage that pools, such as ``equalize_hist_global`` given
      ``axis_name``, psums across the shards).  The plane count N·C must
      divide by the mesh axis' size.
    * ``shard="spatial"``: each frame's rows split across the mesh, stage
      names from ``parallel.spatial.SPATIAL_OP_REGISTRY``; H must divide by
      the axis' size.

    ``axis_name`` defaults to the mesh's first axis.  A plain tensor in
    gives a plain tensor out, on the mesh's first device; a
    ``ShardedTensor`` split as ``stream_frames(..., mesh=mesh)`` splits it
    (``parallel.sharding.device_put_sharded_batch`` for batches,
    ``parallel.spatial.device_put_spatial`` for planes) stays where it lies
    and comes back in the same form.  Every sharded call equals the
    unsharded one bit for bit.
    """
    if mesh is None:
        chain = [(f"ie.op.{name}", fn, kwargs) for name, fn, kwargs in _normalize_stages(stages)]

        def run(img: torch.Tensor) -> torch.Tensor:
            if img.dtype not in _DTYPES:
                raise TypeError(f"expected uint8/uint16/int16/float32 image tensor, got {img.dtype}")
            with span("ie.pipeline"):
                with span("ie.layout"):
                    planes, restore = as_planes(img, channels_last=channels_last)
                for stage, fn, kwargs in chain:
                    with span(stage):
                        planes = fn(planes, **kwargs)
                with span("ie.layout"):
                    return restore(planes)

        return run
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if shard not in ("batch", "spatial"):
        raise ValueError(f"shard must be 'batch' or 'spatial', got {shard!r}")
    ax = axis_name or mesh.axis_names[0]
    if ax not in mesh.shape:
        raise ValueError(f"axis {ax!r} is not an axis of {mesh}")
    n = mesh.shape[ax]
    if shard == "spatial":
        from imageenhancement_mp_tpu_torch.parallel.spatial import spatial_chain

        local = spatial_chain(stages, ax)
        spec = (None, ax, None)
    else:
        norm = _normalize_stages(stages)

        def local(planes: torch.Tensor) -> torch.Tensor:
            for _, fn, kwargs in norm:
                planes = fn(planes, **kwargs)
            return planes

        spec = (ax,)
    over_planes = run_sharded(local, mesh, spec, spec)

    def run_mesh(img):
        if img.dtype not in _DTYPES:
            raise TypeError(f"expected uint8/uint16/int16/float32 image tensor, got {img.dtype}")
        if shard == "spatial":
            h = img.shape[_layout(img.shape, channels_last)[1]]
            if h % n:
                raise ValueError(f"spatial sharding needs H divisible by the mesh ({ax}={n}); "
                                 f"got H={h}")
        else:
            b = _planes_count(img.shape, channels_last)
            if b % n:
                raise ValueError(
                    f"batch sharding needs the plane count (N·C={b}) divisible by the mesh "
                    f"({n} devices); pad the batch or use shard='spatial' for single/narrow "
                    "batches")
        if isinstance(img, ShardedTensor):
            want = _mesh_spec(img.shape, channels_last, mesh, shard, ax)
            if want is None or img.mesh is not mesh or img.spec[:len(want)] != want or any(
                    img.spec[len(want):]):
                raise ValueError(f"input split as {img.spec} over {img.mesh}; this pipeline "
                                 f"takes {want} over {mesh}")

            def per_block(block: torch.Tensor) -> torch.Tensor:
                planes, restore = as_planes(block, channels_last=channels_last)
                return restore(local(planes))

            return run_sharded(per_block, mesh, img.spec, img.spec)(img)
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(over_planes(planes))

    return run_mesh


def stream_frames(pipe: Callable, frames: Iterable[np.ndarray | torch.Tensor], depth: int = 2,
                  mesh: Mesh = None, shard: str = "batch", axis_name: str | None = None,
                  channels_last: bool = True, *,
                  device: str | torch.device | None = None) -> Iterator:
    """Run ``pipe`` over host frames or batches, yielding its outputs in
    order, with up to ``depth`` batches in flight.

    ``frames``: NumPy arrays or CPU tensors, sent to ``device`` or, given a
    ``mesh`` (and the ``shard``, ``axis_name`` and ``channels_last`` given
    to ``make_pipeline``), split as that pipeline takes them: each part goes
    straight to its shard's device, never through the first device, and
    ``pipe`` gets a ``ShardedTensor`` (a single frame under batch sharding
    stays whole, on the mesh's first device).  On the CPU each batch is
    simply passed to ``pipe``.  On CUDA each part is copied into one of
    ``depth`` pinned host buffers and sent with a non-blocking copy on its
    device's copy stream.  Batch t+1 is sent before batch t's pipeline is
    queued, so its copy overlaps batch t's compute; each device's compute
    stream waits on an event recorded after each copy, and ``record_stream``
    keeps the device input alive until its compute is done.  A pinned buffer
    is refilled only after its previous copy ended.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if (mesh is None) == (device is None):
        raise ValueError("stream_frames takes a device or a mesh: exactly one of them")
    if mesh is None:
        dev = torch.device(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"stream_frames: no path for device {dev}")
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a parallel.mesh.Mesh, got {type(mesh).__name__}")

    def host(frame) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(frame)) if isinstance(frame, np.ndarray) else frame
        if not isinstance(t, torch.Tensor) or t.device.type != "cpu":
            raise TypeError("stream_frames takes NumPy arrays or CPU tensors")
        return t

    def parts(t: torch.Tensor):
        """``(host parts, their devices, assemble)``: ``assemble`` makes
        ``pipe``'s input from the parts on their devices."""
        spec = None if mesh is None else _mesh_spec(t.shape, channels_last, mesh, shard,
                                                     axis_name)
        if spec is None:
            return [t], [dev if mesh is None else mesh.first_device], lambda got: got[0]
        return (_split(t, mesh, spec), mesh.device_list,
                lambda got: ShardedTensor(mesh, spec, got))

    devices = [dev] if mesh is None else mesh.device_list
    if devices[0].type == "cpu":
        for frame in frames:
            views, _, assemble = parts(host(frame))
            yield pipe(assemble([v.contiguous() for v in views]))
        return

    compute = {d: torch.cuda.current_stream(d) for d in devices}
    copy_streams = {d: torch.cuda.Stream(d) for d in compute}
    pinned: list[list] = [[] for _ in range(depth)]
    copied: list[list] = [[] for _ in range(depth)]

    def send(i: int, frame):
        """Stage batch ``i``'s parts in its pinned slot and queue their copies."""
        views, devs, assemble = parts(host(frame))
        slot = i % depth
        for event in copied[slot]:
            event.synchronize()  # the slot's previous copies have left it
        bufs = pinned[slot]
        if [(b.shape, b.dtype) for b in bufs] != [(v.shape, v.dtype) for v in views]:
            bufs = pinned[slot] = [torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                                   for v in views]
        sent = []
        for buf, v, d in zip(bufs, views, devs):
            buf.copy_(v)
            with torch.cuda.stream(copy_streams[d]):
                on_dev = buf.to(d, non_blocking=True)
                event = torch.cuda.Event()
                event.record(copy_streams[d])
            sent.append((on_dev, event, d))
        copied[slot] = [e for _, e, _ in sent]
        return sent, assemble

    batches = enumerate(frames)
    following = next(batches, None)
    sent = None if following is None else send(*following)
    pending: deque = deque()
    while sent is not None:
        got, assemble = sent
        following = next(batches, None)
        sent = None if following is None else send(*following)
        for on_dev, event, d in got:
            compute[d].wait_event(event)
            on_dev.record_stream(compute[d])
        with contextlib.ExitStack() as stack:
            for s in compute.values():
                stack.enter_context(torch.cuda.stream(s))
            pending.append(pipe(assemble([on_dev for on_dev, _, _ in got])))
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
    one write.  Any odd ``ksize``, including 1.  Under a torch profiler a
    call is one ``ie.equalize_unsharp`` span holding ``ie.layout`` (planes
    in, and the copy of HWC planes), ``ie.op.equalize_hist``,
    ``ie.op.unsharp_mask`` and ``ie.layout`` (planes out); the taps, which
    check ``ksize`` before any kernel launch, lie between the first two.
    """
    if img.dtype != torch.uint8:
        raise TypeError(f"expected uint8 image tensor, got {img.dtype}")
    with span("ie.equalize_unsharp"):
        with span("ie.layout"):
            planes, restore = as_planes(img)
            planes = planes.contiguous()
        tv, th = q8_taps(int(ksize), float(sigma))
        with span("ie.op.equalize_hist"):
            luts = hist256_equalize_lut(planes)
        with span("ie.op.unsharp_mask"):
            out = sep_conv_u8(planes, tv, th, float(amount), luts=luts)
        with span("ie.layout"):
            return restore(out)
