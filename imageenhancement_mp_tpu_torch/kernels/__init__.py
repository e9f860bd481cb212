"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), each beside its plain
PyTorch version.

Dispatch is by device, with no switch: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  ``launch_counts`` holds one plain
integer per kernel wrapper, raised by one at each launch and nowhere else, so
a run can show that it went through the kernels.
"""

from __future__ import annotations

import weakref

import torch

from imageenhancement_mp_tpu_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts", "on_cuda", "check_kernel_input",
           "host_derived"]


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


# (tensor id, key) -> (weak reference, version, value): see host_derived
_HOST_CACHE: dict[tuple, tuple] = {}


def host_derived(t: torch.Tensor, key: str, fn):
    """``fn`` of ``t``'s values as a NumPy array, computed once per tensor
    (and its version counter) and ``key``: a wrapper that needs a table's
    values on the host copies it once, not once per call, which would wait
    for the stream."""
    hit = _HOST_CACHE.get((id(t), key))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    value = fn(t.detach().cpu().numpy())
    if len(_HOST_CACHE) > 64:
        for k in [k for k, v in _HOST_CACHE.items() if v[0]() is None]:
            del _HOST_CACHE[k]
    _HOST_CACHE[(id(t), key)] = (weakref.ref(t), t._version, value)
    return value
