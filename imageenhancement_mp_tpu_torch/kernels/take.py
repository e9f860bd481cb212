"""Per-element table lookup: :func:`take_table`, beside its plain version.

It replaces two Pallas kernels of the JAX package's ``kernels/hist.py``:
``take_table_pallas`` (K12; the lookups of ``ops/color.py::_take1`` and
``ops/nlmeans.py::_lut_take``) and ``_probe_dg`` (K15, the dynamic-gather
probe: ``take_along_axis`` on one ``[8, 128]`` int32 table, which is the
per-plane case with B = 8 and L = 128).  The TPU kernel served tables of at
most 4096 entries and left longer ones to XLA; the CUDA kernel
``csrc/take.cu`` serves every length: a table of at most
:data:`SMEM_TABLE_BYTES` from shared memory, a longer one through L1/L2.

Indices are clamped into ``[0, L)`` in the kernel and in the plain version
alike; every caller already clamps, so this changes no result.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel, any other device raises.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda
from imageenhancement_mp_tpu_torch.kernels._build import launch

__all__ = ["SMEM_TABLE_BYTES", "take_table", "take_table_plain"]

# csrc/take.cu's kSmemTableBytes: tables up to this size sit in shared memory
SMEM_TABLE_BYTES = 64 * 1024
TABLE_DTYPES = (torch.int32, torch.int64)


def _check(idx: torch.Tensor, table: torch.Tensor) -> bool:
    """Validate the arguments; True for a table per plane."""
    if table.dtype not in TABLE_DTYPES:
        raise TypeError(f"take_table: int32 or int64 tables only, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"take_table: int32 indices only, got {idx.dtype}")
    if idx.dim() < 1:
        raise ValueError("take_table: indices must be [B, ...]")
    if table.dim() == 1:
        per_plane = False
    elif table.dim() == 2 and table.shape[0] == idx.shape[0]:
        per_plane = True
    else:
        raise ValueError(f"take_table: expected a [L] or [B, L] table for indices "
                         f"{tuple(idx.shape)}, got {tuple(table.shape)}")
    if table.shape[-1] < 1 or table.shape[-1] >= 2**31:
        raise ValueError(f"take_table: table length {table.shape[-1]} is not in [1, 2^31)")
    if table.device != idx.device:
        raise ValueError(f"take_table: indices on {idx.device}, table on {table.device}")
    return per_plane


def take_table_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    per_plane = _check(idx, table)
    L = table.shape[-1]
    i = idx.to(torch.int64).clamp(0, L - 1)
    if per_plane:
        B = idx.shape[0]
        i = i.reshape(B, -1) + L * torch.arange(B, device=idx.device)[:, None]
    return torch.take(table, i).reshape(idx.shape)


def take_table(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[b, ...] = table[b][clamp(idx[b, ...], 0, L − 1)]`` with ``idx``
    ``[B, ...]`` int32 and ``table`` ``[L]`` (shared by all planes) or
    ``[B, L]`` (one per plane), int32 or int64; the output has ``idx``'s
    shape and the table's dtype."""
    per_plane = _check(idx, table)
    if not on_cuda(idx, "take_table"):
        return take_table_plain(idx, table)
    check_kernel_input("take_table", idx, table)
    out = torch.empty(idx.shape, dtype=table.dtype, device=idx.device)
    if out.numel() == 0:
        return out
    # a shared table reads every index the same way: one flat plane
    B = idx.shape[0] if per_plane else 1
    launch("take_table", idx.device, idx.data_ptr(), table.data_ptr(), out.data_ptr(), B,
           idx.numel() // B, table.shape[-1], int(per_plane), table.element_size())
    return out
