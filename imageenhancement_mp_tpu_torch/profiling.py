"""Timing helpers encoding the measurement method of the port (the JAX
package's ``profiling.py`` in PyTorch, on the device of the tensors given).

Observability layer: wall-clock timing with warm-up and the median (or
min) of blocked calls, throughput conversion, and the chain clock.  Two
rules carried over from the JAX package's method (its docs/DESIGN.md §9):

* never fetch results to the host before you are done timing (a host read
  waits for the stream and puts its round trip into the reading);
* always block on the result each iteration: medians over blocked calls
  are stable, means over asynchronous launches are not.

A call is blocked with ``torch.cuda.synchronize`` on every CUDA device
that holds a tensor of its arguments or of its result (tensors in tuples,
lists and dicts included), or on the current device where neither holds
one and CUDA is initialized (a closure's work); a CPU call has nothing to
block on.  The chain clock
(:func:`time_op_chained`, the JAX package's docs/DESIGN.md §9b) replays a
CUDA graph of chained applications, so the host's launch work, which paces
short calls of this port, drops out of its reading.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from imageenhancement_mp_tpu_torch.kernels import stream_workspaces

__all__ = ["time_op", "time_op_chained", "throughput_gpixs"]

_MASK32 = 0xFFFFFFFF
# applications captured in one CUDA graph: a chain of n replays a block of
# this many k = n // _BLOCK times, then one block of the remainder
_BLOCK = 64


def _tensor_device(t: torch.Tensor) -> torch.device:
    return t.device


def _cuda_devices(obj, found: set) -> set:
    """``found`` with the CUDA device of every tensor in ``obj``: a tensor,
    or tuples, lists and dicts of them at any depth."""
    if isinstance(obj, torch.Tensor):
        dev = _tensor_device(obj)
        if dev.type == "cuda":
            found.add(dev)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _cuda_devices(o, found)
    elif isinstance(obj, dict):
        for o in obj.values():
            _cuda_devices(o, found)
    return found


def time_op(
    fn: Callable, *args, iters: int = 10, warmup: int = 3, reduce: str = "median"
) -> float:
    """Wall-clock seconds per call of ``fn(*args)`` (device-blocked).

    Every call, warm-up and timed, blocks on what it did, as the JAX
    package's ``block_until_ready`` does: ``torch.cuda.synchronize`` on each
    CUDA device that holds a tensor of the arguments or of the result
    (walking tuples, lists and dicts), else, where CUDA is initialized, on
    the current device (a closure's tensors are nowhere in sight); a CPU
    call is not blocked.  The result never leaves the device.  ``reduce``:
    "median" (default) or "min".  The min is the robust estimate of what
    the machine can do (timeit-style): host jitter only ever inflates a
    call.
    """
    arg_devices = _cuda_devices(args, set())

    def call() -> None:
        devices = _cuda_devices(fn(*args), set(arg_devices))
        for dev in sorted(devices, key=str):
            torch.cuda.synchronize(dev)
        if not devices and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts) if reduce == "min" else np.median(ts))


def throughput_gpixs(shape, secs: float) -> float:
    """Pixels/second in GPix/s for an array of ``shape`` processed in ``secs``."""
    return float(np.prod(shape)) / secs / 1e9


def _liveness(c: torch.Tensor) -> torch.Tensor:
    """The chain's result, which reads every element of the final carry: the
    wraparound uint32 sum of an integer carry (its int64 sum masked to 32
    bits, the same value: torch has no uint32 sum on the CPU), the f32 sum
    of a floating one."""
    if c.dtype.is_floating_point:
        return c.sum(dtype=torch.float32)
    return c.sum(dtype=torch.int64) & _MASK32


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a type torch's CPU sums and bitwise ops take: uint16 as
    int16, the same bits."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _fold(c: torch.Tensor, y: torch.Tensor) -> None:
    """Fold one data-dependent bit of the whole output ``y`` into the
    carry's first element, in place: the low bit of the wraparound uint32
    sum of an integer ``y`` (its parity, which a sum in ``y``'s own type
    keeps: a wider one would first cast a copy of ``y``), of the f32 sum's
    bits of a floating one; XORed into an integer carry, ``bit · 1e-30``
    added to a floating one (small enough never to change the op's work)."""
    if y.dtype.is_floating_point:
        bit = y.sum(dtype=torch.float32).view(torch.int32) & 1
    else:
        y = _bits(y)
        bit = y.sum(dtype=y.dtype) & 1
    head = c.view(-1)[:1]
    if c.dtype.is_floating_point:
        head.add_(bit.to(c.dtype) * 1e-30)
    else:
        head = _bits(head)
        head.bitwise_xor_(bit.to(head.dtype))


def _chain_step(fn: Callable, x: torch.Tensor, mode: str) -> tuple[Callable, bool]:
    """The chain's step for ``fn`` at ``x`` and whether it updates its
    carry in place: ``fn`` itself when ``fn`` keeps ``x``'s shape, dtype and
    strides and ``mode`` is "auto", else the refeed step (``fn`` on the
    carry, one bit of its output folded into the carry's first element).
    Calls ``fn(x)`` once to read the output's shape, dtype and strides."""
    y = fn(x)
    if (y.shape == x.shape and y.dtype == x.dtype and y.stride() == x.stride()
            and mode != "refeed"):
        return fn, False

    def step(c: torch.Tensor) -> torch.Tensor:
        _fold(c, fn(c))
        return c

    return step, True


def _carry(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


def _run_eager(step: Callable, in_place: bool, x0: torch.Tensor, n: int) -> torch.Tensor:
    c = _carry(x0) if in_place else x0
    for _ in range(n):
        c = step(c)
    return _liveness(c)


def _chain_eager(fn: Callable, x: torch.Tensor, n: int, mode: str = "auto") -> torch.Tensor:
    """The chain's scalar computed eagerly on ``x``'s device: the plain path
    of :func:`_chain_program` on CPU tensors and, on a CUDA tensor, the
    reference its graph is held to."""
    step, in_place = _chain_step(fn, x, mode)
    return _run_eager(step, in_place, x, n)


# one capture stream a device, as torch.cuda.graph keeps one: the kernels'
# per-stream workspaces (kernels/__init__.py) are made once for it
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    with _CAPTURE_LOCK:
        if dev not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        return _CAPTURE_STREAMS[dev]


class _GraphChain:
    """``n`` chained applications of ``fn`` captured as CUDA graphs on a side
    stream and replayed on the current one: a block of ``L = min(n, _BLOCK)``
    applications replayed ``n // L`` times and one block of ``n % L``.

    The carry is one static buffer: ``__call__`` copies ``x0`` into it and
    each block reads it and writes its last output back into it (one copy a
    block; none in refeed mode, whose step updates the buffer in place), so
    replays stay data-dependent.  Intermediates come from the graphs' one
    private pool, where each application's input is freed once its output
    exists: a block holds a few outputs, never ``n``.  ``fn`` runs once on
    the capture stream before capture (torch's rule), which also fills the
    host caches (``kernels.host_derived``) and the capture stream's
    workspaces; the workspaces are kept here while the graphs live.
    """

    def __init__(self, fn: Callable, x: torch.Tensor, n: int, mode: str):
        dev = x.device
        name = getattr(fn, "__qualname__", None) or repr(fn)
        self.buf = _carry(x)
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            step, _ = _chain_step(fn, x, mode)
            step(self.buf)  # the fold's operations too
        torch.cuda.current_stream(dev).wait_stream(stream)
        L = max(1, min(n, _BLOCK))
        self.graphs, pool, caller = [], None, torch.cuda.current_stream(dev)
        for length, reps in ((L, n // L), (n % L, 1)):
            if length == 0 or reps == 0:
                continue
            g = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(g, pool=pool, stream=stream):
                    c = self.buf
                    for _ in range(length):
                        c = step(c)
                    if c is not self.buf:
                        self.buf.copy_(c)
                    del c
            except RuntimeError as e:  # what reads the host cannot be captured
                torch.cuda.set_stream(caller)  # a failed capture_end skips the stream's exit
                raise RuntimeError(
                    f"time_op_chained: {name} cannot be captured in a CUDA graph "
                    f"({type(e).__name__}: {e}); time it with time_op") from e
            pool = g.pool()
            self.graphs.append((g, reps))
        with torch.cuda.stream(stream):
            self.workspaces = stream_workspaces(dev)

    def __call__(self, x0: torch.Tensor) -> torch.Tensor:
        self.buf.copy_(x0)
        for g, reps in self.graphs:
            for _ in range(reps):
                g.replay()
        return _liveness(self.buf)


def _chain_program(fn: Callable, x: torch.Tensor, n: int, mode: str = "auto") -> Callable:
    """A program applying ``fn`` ``n`` times as a data-dependent chain,
    called on an input like ``x``; it returns a 0-d tensor on ``x``'s device.

    Each application's input depends on the previous application's full
    output, so the ``n`` applications run one after another; the result is
    a wraparound full reduction of the final carry, so every element of
    every intermediate is live.  See the JAX package's docs/DESIGN.md §9b.

    ``mode``: "auto" chains outputs directly when ``fn`` keeps shape,
    dtype and strides (honest memory traffic: each output is the next
    carry); "refeed" forces the carry-bit variant: ``fn`` is applied to the
    ORIGINAL input with one data-dependent element folded in, so the data
    statistics stay realistic every iteration (for data-dependent ops whose
    timing would drift as chained data degenerates).  An ``fn`` that
    changes shape, dtype or strides gets refeed too: a channels-last frame
    returned as a view of channel planes would let the next application
    skip its transpose (a JAX array has no strides, so the JAX package
    needs no such rule).  The fold reads the whole output, an extra read
    that makes refeed a slightly conservative (over-) estimate.

    On a CUDA tensor the chain is captured in CUDA graphs (:class:`_GraphChain`:
    blocks of at most ``_BLOCK`` applications, since capture runs each
    application's host work once and a graph's size grows with its
    launches) and a call replays them with no host work between
    applications.  A ``fn`` that reads the host (Otsu/Triangle's scans,
    Canny's hysteresis, ``flood_fill``) cannot be captured: this raises a
    ``RuntimeError`` and never falls back to an eager chain.  Tables that
    ``fn`` reads from a cache must stay cached while the program lives.
    On a CPU tensor the chain runs eagerly.
    """
    if x.device.type == "cuda":
        return _GraphChain(fn, x, n, mode)
    step, in_place = _chain_step(fn, x, mode)
    return lambda x0: _run_eager(step, in_place, x0, n)


def time_op_chained(
    fn: Callable,
    x,
    *,
    n_lo: int = 2,
    n_hi: int | None = None,
    target_secs: float = 1.0,
    repeats: int = 3,
    mode: str = "auto",
    max_chain: int = 16384,
) -> float:
    """Seconds per call of ``fn(x)`` on the device alone (the chain clock).

    A short call of this port is paced by the host's launch work, so a
    blocked wall-clock call reads the host, not the device.  This clock
    instead:

    1. chains ``n`` applications of ``fn`` with a hard data dependence
       between them and replays them as CUDA graphs (``_chain_program``);
    2. fences by reading the program's scalar result to the host with
       ``.item()``: the bytes exist only after the whole chain has run;
    3. times two chain lengths ``n_lo < n_hi`` and returns
       ``(t_hi - t_lo) / (n_hi - n_lo)``, cancelling every per-call constant
       (the carry's copy, the reduction, the fence's round trip).

    ``n_hi`` is auto-sized so the differenced device time is ~``target_secs``
    (default 1 s), which dominates launch jitter by orders of magnitude.
    ``repeats`` takes the min wall time per chain length: real device
    execution is the physical floor; noise only ever inflates.  An ``fn``
    that reads the host cannot be chained on the card: this raises
    ``RuntimeError``; time such ops with :func:`time_op`.  On a CPU tensor
    the chain runs eagerly.
    """
    def t_of(n: int) -> float:
        g = _chain_program(fn, x, n, mode)
        g(x).item()  # capture + warm (also fences)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            g(x).item()
            best = min(best, time.perf_counter() - t0)
        return best

    auto_size = n_hi is None
    if auto_size:
        # probe with a short chain to size the long one.  t_probe/probe_n
        # still contains the per-call constant/probe_n, so this FIRST
        # estimate only bounds n_hi from below — the differenced re-size
        # loop after the first (t_lo, t_hi) pair removes the constant and
        # grows the chain until the differenced device time dominates jitter.
        probe_n = max(n_lo + 1, 4)
        t_probe = t_of(probe_n)
        per = max(t_probe / probe_n, 1e-7)
        n_hi = int(np.clip(target_secs / per, n_lo + 8, max_chain))
    t_lo = t_of(n_lo)
    t_hi = t_of(n_hi)
    if auto_size:
        for _ in range(3):
            diff = t_hi - t_lo
            if diff >= 0.25 * target_secs or n_hi >= max_chain:
                break
            if diff <= 0:  # pure noise — grow geometrically
                n_next = min(n_hi * 8, max_chain)
            else:
                per_op = max(diff / (n_hi - n_lo), 1e-9)
                n_next = int(np.clip(target_secs / per_op, n_hi + 1, max_chain))
            if n_next <= n_hi:
                break
            n_hi = n_next
            t_hi = t_of(n_hi)
    return max((t_hi - t_lo) / (n_hi - n_lo), 1e-12)
