"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version.

Dispatch is by device, with no switch: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  ``launch_counts`` holds one plain
integer per kernel wrapper, raised by one at each launch and nowhere else, so
a run can show that it went through the kernels.
"""

from __future__ import annotations

import threading
import weakref

import torch

from imageenhancement_mp_tpu_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts", "on_cuda", "check_kernel_input",
           "host_derived", "stream_handle", "stream_workspace", "stream_workspaces"]


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel and no plain path for device {t.device}")


def check_kernel_input(name: str, *tensors: torch.Tensor) -> None:
    """What every launch needs: one CUDA device and contiguous tensors.  Any
    number of planes: the kernels stride over planes on a capped grid axis."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


# (tensor id, key) -> (weak reference, version, value): see host_derived.
# Shard threads (parallel/mesh.py) share it: every access holds the lock.
_HOST_CACHE: dict[tuple, tuple] = {}
_HOST_LOCK = threading.Lock()


def host_derived(t: torch.Tensor, key: str, fn):
    """``fn`` of ``t``'s values as a NumPy array, computed once per tensor
    (and its version counter) and ``key``: a wrapper that needs a table's
    values on the host copies it once, not once per call, which would wait
    for the stream."""
    with _HOST_LOCK:
        hit = _HOST_CACHE.get((id(t), key))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    value = fn(t.detach().cpu().numpy())  # outside the lock: it waits for the stream
    with _HOST_LOCK:
        if len(_HOST_CACHE) > 64:
            for k in [k for k, v in _HOST_CACHE.items() if v[0]() is None]:
                del _HOST_CACHE[k]
        _HOST_CACHE[(id(t), key)] = (weakref.ref(t), t._version, value)
    return value


def stream_handle(device: torch.device) -> int:
    """The handle ``torch.cuda.current_stream(device).cuda_stream`` gives,
    without building a Stream object (4 us a call on the card's host); 0 off
    CUDA."""
    return torch._C._cuda_getCurrentRawStream(device.index) if device.type == "cuda" else 0


# (device, stream, zeroed) -> the stream's int32 buffer: see stream_workspace;
# shard threads share it, every access holds the lock
_WORKSPACES: dict[tuple, torch.Tensor] = {}
_WORKSPACE_LOCK = threading.Lock()
_WORKSPACE_KEYS = 128  # the most buffers kept: two a stream


def stream_workspace(device: torch.device, n: int, zeroed: bool) -> torch.Tensor:
    """At least ``n`` int32 words of one of the two buffers a stream keeps
    for the count kernels' handoff (csrc/hist_count.cuh::last_of_group):
    ``zeroed``, the arrival counters, zeroed when made or grown and left at
    0 by every launch; else the scratch rows, never zeroed.  Launches on
    one stream run in order, so each stream keeps one of each for all its
    launches and two streams never share one.  The least recently used
    beyond ``_WORKSPACE_KEYS`` is dropped (the caching allocator reuses its
    memory only on its own stream, after the launches queued there)."""
    key = (device, stream_handle(device), zeroed)
    with _WORKSPACE_LOCK:
        t = _WORKSPACES.pop(key, None)
        if t is None or t.numel() < n:
            size = max(n, 1024, 0 if t is None else 2 * t.numel())
            t = (torch.zeros if zeroed else torch.empty)(size, dtype=torch.int32, device=device)
        _WORKSPACES[key] = t  # the most recently used last
        while len(_WORKSPACES) > _WORKSPACE_KEYS:
            del _WORKSPACES[next(iter(_WORKSPACES))]
    return t


def stream_workspaces(device: torch.device) -> list[torch.Tensor]:
    """The buffers :func:`stream_workspace` keeps for ``device``'s current
    stream.  A CUDA graph captured on that stream writes them at every
    replay: its holder keeps these references, so the LRU cannot free them
    under it."""
    handle = stream_handle(device)
    with _WORKSPACE_LOCK:
        return [t for (d, s, _), t in _WORKSPACES.items() if d == device and s == handle]
