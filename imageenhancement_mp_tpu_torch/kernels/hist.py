"""Histogram-family kernels on u8 planes, each beside its plain PyTorch version.

* :func:`hist256` — exact per-plane 256-bin histogram (replaces
  the JAX package's ``kernels/hist.py::hist256_pallas``).
* :func:`hist256_equalize_lut` — cv2's equalizeHist LUT of each plane in
  one launch of the same kernel, its epilogue building the LUT from the
  plane's finished histogram (the histogram and LUT phases of
  ``equalize_hist_pallas``, which are one ``pallas_call`` there too); with
  ``groups`` C, one LUT per group of planes ``b % C`` from their pooled
  counts, still one launch (pooled equalizeHist).
* :func:`equalize_lut256` — cv2's equalizeHist LUT from a histogram held in
  memory (``ops/histogram.py::equalize_lut``; pooled across a mesh axis).
* :func:`apply_lut256` — ``cv2.LUT`` with a u8, u16, i16, i32 or f32 table,
  shared or per plane (replaces ``apply_lut256_pallas``: u8 tables launch
  ``apply_lut256``, the others ``apply_lut256_wide``).
* :func:`apply_luts_multi` — K per-plane tables applied in one read of the
  planes (replaces ``apply_luts_multi_pallas``).

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel in ``csrc/hist.cu``, any other device raises.  Nothing
moves a tensor between devices.
"""

from __future__ import annotations

import torch

from imageenhancement_mp_tpu_torch.kernels import check_kernel_input, on_cuda, stream_workspace
from imageenhancement_mp_tpu_torch.kernels._build import launch

__all__ = [
    "hist256", "hist256_plain", "hist256_plan", "HIST_GRID_BLOCKS", "MAX_GRID_Y",
    "hist256_equalize_lut", "hist256_equalize_lut_plain", "handoff_scratch",
    "equalize_lut256", "equalize_lut256_plain",
    "apply_lut256", "apply_lut256_plain",
    "apply_luts_multi", "apply_luts_multi_plain", "take_rows",
]


def _check_u8_planes(planes: torch.Tensor, name: str) -> None:
    if planes.dtype != torch.uint8:
        raise TypeError(f"{name} expects uint8 planes, got {planes.dtype}")
    if planes.dim() < 2:
        raise ValueError(f"{name} expects [B, H, W] or [B, P] planes, got {tuple(planes.shape)}")


# --- hist256 ---------------------------------------------------------------

# The counting kernels' grid (csrc/hist_count.cuh): blocks of 256 threads,
# three on each of an H100's 132 SMs (two and four a SM were not faster on
# all three kinds of plane, tools/torch_hist_profile.py --ab).
HIST_GRID_BLOCKS = 3 * 132
MAX_GRID_Y = 65535  # planes (hist256) or bands (hist256_tiles) beyond it stride


def hist256_plan(B: int, n: int) -> tuple[int, int]:
    """``(blocks per plane, grid_y)`` of ``hist256`` on ``B`` planes of ``n``
    pixels: one wave of resident blocks over all planes, at least one plane
    per block and one 16-pixel vector per thread; planes stride over
    ``grid_y``."""
    per_plane = max(1, min(HIST_GRID_BLOCKS // B, -(-(n // 16) // 256)))
    return per_plane, min(B, MAX_GRID_Y)


def hist256_plain(planes: torch.Tensor) -> torch.Tensor:
    B = planes.shape[0]
    idx = planes.reshape(B, -1).to(torch.int64)
    idx = idx + 256 * torch.arange(B, device=planes.device)[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=256 * B)
    return counts.reshape(B, 256).to(torch.int32)


# scratch rows a launch takes from its stream's workspace (4 MB); more come
# from the caching allocator
WORKSPACE_ROWS = 4096


def handoff_scratch(device: torch.device, groups: int, members: int) -> tuple:
    """``(rows, partial, tickets)`` for a count kernel whose ``groups``
    groups (planes or tiles) are counted by ``members`` blocks each
    (csrc/hist_count.cuh::last_of_group): pointers to ``[groups, members,
    256]`` scratch rows and to ``groups`` arrival counters at 0, from the
    stream's two buffers (kernels/__init__.py::stream_workspace); past
    ``WORKSPACE_ROWS`` rows the rows come from the caching allocator and
    ``rows`` holds them: keep it until the launch is queued.  A group of one
    block needs neither: ``(None, 0, 0)``."""
    if members == 1:
        return None, 0, 0
    n_rows = groups * members
    tickets = stream_workspace(device, groups, zeroed=True).data_ptr()
    if n_rows <= WORKSPACE_ROWS:
        return None, stream_workspace(device, n_rows * 256, zeroed=False).data_ptr(), tickets
    rows = torch.empty((n_rows, 256), dtype=torch.int32, device=device)
    return rows, rows.data_ptr(), tickets


def _count_planes(name: str, planes: torch.Tensor, out: torch.Tensor, groups: int) -> None:
    """Launch ``hist256`` (``out`` the histograms, ``groups`` = B) or
    ``hist256_lut`` (``out`` the equalize LUTs of ``groups`` groups of
    planes ``b % groups``) on non-empty CUDA planes: one launch, ``out``
    written whole."""
    B = planes.shape[0]
    n = planes.numel() // B
    if n * (B // groups) >= 2**31:
        raise ValueError(f"{name}: a group of {n * (B // groups)} pixels overflows the int32 "
                         "counts")
    blocks, grid_y = hist256_plan(B, n)
    rows, partial, tickets = handoff_scratch(planes.device, groups, B // groups * blocks)
    lut_groups = () if name == "hist256" else (groups,)
    launch(name, planes.device, planes.data_ptr(), out.data_ptr(), B, n, *lut_groups, blocks,
           grid_y, partial, tickets)
    del rows  # queued: the caching allocator reuses it in stream order


def hist256(planes: torch.Tensor) -> torch.Tensor:
    """Exact per-plane histogram: ``[B, H, W]`` or ``[B, P]`` u8 → ``[B, 256]`` int32."""
    _check_u8_planes(planes, "hist256")
    if not on_cuda(planes, "hist256"):
        return hist256_plain(planes)
    check_kernel_input("hist256", planes)
    B = planes.shape[0]
    if not planes.numel():
        return torch.zeros((B, 256), dtype=torch.int32, device=planes.device)
    out = torch.empty((B, 256), dtype=torch.int32, device=planes.device)
    _count_planes("hist256", planes, out, B)
    return out


def _groups(planes: torch.Tensor, groups: int | None) -> int:
    B = planes.shape[0]
    C = B if groups is None else int(groups)
    if B and (C < 1 or B % C):
        raise ValueError(f"hist256_equalize_lut: {B} planes do not split into {C} groups")
    return C


def hist256_equalize_lut_plain(planes: torch.Tensor, groups: int | None = None) -> torch.Tensor:
    B = planes.shape[0]
    C = _groups(planes, groups)
    h = hist256_plain(planes)
    if C != B:
        h = h.reshape(B // C, C, 256).sum(dim=0, dtype=torch.int32)
    return equalize_lut256_plain(h, planes.numel() // C if B else 0)


def hist256_equalize_lut(planes: torch.Tensor, groups: int | None = None) -> torch.Tensor:
    """cv2's equalizeHist LUT of each plane: ``[B, H, W]`` or ``[B, P]`` u8 →
    ``[B, 256]`` u8, equal to ``equalize_lut256(hist256(planes), H·W)``.
    With ``groups`` C (dividing B): ``[C, 256]``, row g the LUT of the
    counts pooled over planes ``g, g + C, g + 2C, ...`` (``total = (B/C)·H·W``),
    as pooled equalizeHist over ``[N, H, W, C]`` frames takes them.  On CUDA
    one launch (``hist256_lut``) counts the planes and builds each LUT from
    its group's finished counts; no histogram is kept."""
    _check_u8_planes(planes, "hist256_equalize_lut")
    C = _groups(planes, groups)
    if not on_cuda(planes, "hist256_lut"):
        return hist256_equalize_lut_plain(planes, C)
    check_kernel_input("hist256_lut", planes)
    if not planes.numel():  # no pixels: the identity, as equalize_lut256 gives at total 0
        return torch.arange(256, dtype=torch.uint8, device=planes.device).repeat(C, 1)
    out = torch.empty((C, 256), dtype=torch.uint8, device=planes.device)
    _count_planes("hist256_lut", planes, out, C)
    return out


# --- equalize_lut256 -------------------------------------------------------

def _check_hists(hists: torch.Tensor, total: int) -> None:
    if hists.dtype != torch.int32 or hists.dim() != 2 or hists.shape[1] != 256:
        raise TypeError(f"expected [B, 256] int32 histograms, got {hists.dtype} {tuple(hists.shape)}")
    if not 0 <= total < 2**31:
        raise ValueError(f"total {total} does not fit the int32 cdf")


def equalize_lut256_plain(hists: torch.Tensor, total: int) -> torch.Tensor:
    cdf = torch.cumsum(hists, dim=1)
    # i0 (the first nonzero bin) = the count of bins whose cdf is still 0;
    # cdf[i0] is then hist[i0]
    i0 = (cdf == 0).sum(dim=1, keepdim=True).clamp(max=255)
    h0 = cdf.gather(1, i0)
    denom = (total - h0).clamp(min=1).to(torch.float32)
    # a tensor numerator: `255.0 / denom` is reciprocal-then-multiply in
    # torch, which rounds twice; this is one IEEE f32 division
    scale = torch.full_like(denom, 255.0) / denom
    lut = torch.round((cdf - h0).to(torch.float32) * scale).clamp(0, 255).to(torch.uint8)
    identity = torch.arange(256, dtype=torch.uint8, device=hists.device).expand_as(lut)
    return torch.where(h0 == total, identity, lut)


def equalize_lut256(hists: torch.Tensor, total: int) -> torch.Tensor:
    """cv2's equalizeHist LUTs: ``[B, 256]`` int32 histograms of planes of
    ``total`` pixels → ``[B, 256]`` u8,
    ``clip(rint(f32(cdf − h0)·f32(255/(total − h0))), 0, 255)`` with h0 the
    first nonzero bin's count, and the identity for a constant plane."""
    total = int(total)
    _check_hists(hists, total)
    if not on_cuda(hists, "equalize_lut256"):
        return equalize_lut256_plain(hists, total)
    check_kernel_input("equalize_lut256", hists)
    out = torch.empty((hists.shape[0], 256), dtype=torch.uint8, device=hists.device)
    if hists.shape[0]:
        launch("equalize_lut256", hists.device, hists.data_ptr(), out.data_ptr(),
               hists.shape[0], total)
    return out


# --- apply_lut256 and apply_luts_multi --------------------------------------

# table dtype -> bytes per entry; the kernels copy entries bit for bit
LUT_BYTES = {torch.uint8: 1, torch.uint16: 2, torch.int16: 2, torch.int32: 4, torch.float32: 4}


def _check_lut_dtype(luts: torch.Tensor, name: str) -> None:
    if luts.dtype not in LUT_BYTES:
        raise TypeError(f"{name}: tables of uint8/uint16/int16/int32/float32, got {luts.dtype}")


def _check_luts(planes: torch.Tensor, luts: torch.Tensor, name: str) -> None:
    _check_lut_dtype(luts, name)
    shared = luts.shape == (256,)
    if not shared and luts.shape != (planes.shape[0], 256):
        raise ValueError(f"{name}: expected a [256] or [B, 256] table, got {tuple(luts.shape)}")
    if luts.device != planes.device:
        raise ValueError(f"{name}: planes on {planes.device}, table on {luts.device}")


def take_rows(luts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``luts[idx]`` for one ``[S]`` table, ``luts[b, idx[b]]`` for ``[B, S]``
    tables, with int64 ``idx`` ``[B, n]``.  16-bit tables go through their
    int16 bits: torch's CPU gather has no uint16."""
    t = luts.view(torch.int16) if luts.dtype == torch.uint16 else luts
    out = t[idx] if t.dim() == 1 else t.gather(1, idx)
    return out.view(luts.dtype)


def apply_lut256_plain(planes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    B = planes.shape[0]
    return take_rows(luts, planes.reshape(B, -1).to(torch.int64)).reshape(planes.shape)


def apply_lut256(planes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """``cv2.LUT`` on u8 planes ``[B, ...]`` with a ``[256]`` (shared) or
    ``[B, 256]`` (per plane) table of u8, u16, i16, i32 or f32; returns
    ``planes.shape`` in the table's dtype, each entry copied as it is.  A u8
    table launches ``apply_lut256``, a wider one ``apply_lut256_wide``."""
    _check_u8_planes(planes, "apply_lut256")
    _check_luts(planes, luts, "apply_lut256")
    name = "apply_lut256" if luts.dtype == torch.uint8 else "apply_lut256_wide"
    if not on_cuda(planes, name):
        return apply_lut256_plain(planes, luts)
    check_kernel_input(name, planes, luts)
    out = torch.empty(planes.shape, dtype=luts.dtype, device=planes.device)
    B = planes.shape[0]
    n = planes.numel() // B if B else 0
    if n:
        wide = () if luts.dtype == torch.uint8 else (LUT_BYTES[luts.dtype],)
        launch(name, planes.device, planes.data_ptr(), luts.data_ptr(),
               0 if luts.dim() == 1 else 256, out.data_ptr(), B, n, *wide)
    return out


def apply_luts_multi_plain(planes: torch.Tensor, luts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return tuple(apply_lut256_plain(planes, luts[:, k]) for k in range(luts.shape[1]))


def apply_luts_multi(planes: torch.Tensor, luts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """K tables applied to the same u8 planes in one read: ``[B, ...]`` u8 ×
    ``[B, K, 256]`` tables (u8, u16, i16, i32 or f32), K ≥ 1 → a K-tuple of
    ``planes.shape`` tensors in the table dtype (views of one ``[K, B, ...]``
    tensor on CUDA)."""
    _check_u8_planes(planes, "apply_luts_multi")
    _check_lut_dtype(luts, "apply_luts_multi")
    if luts.dim() != 3 or luts.shape[0] != planes.shape[0] or luts.shape[2] != 256 \
            or luts.shape[1] < 1:
        raise ValueError(f"apply_luts_multi: expected [B, K >= 1, 256] tables for "
                         f"{planes.shape[0]} planes, got {tuple(luts.shape)}")
    if luts.device != planes.device:
        raise ValueError(f"apply_luts_multi: planes on {planes.device}, tables on {luts.device}")
    if not on_cuda(planes, "apply_luts_multi"):
        return apply_luts_multi_plain(planes, luts)
    check_kernel_input("apply_luts_multi", planes, luts)
    B, K = luts.shape[:2]
    out = torch.empty((K,) + tuple(planes.shape), dtype=luts.dtype, device=planes.device)
    n = planes.numel() // B if B else 0
    if n:
        launch("apply_luts_multi", planes.device, planes.data_ptr(), luts.data_ptr(), K,
               out.data_ptr(), B, n, LUT_BYTES[luts.dtype])
    return tuple(out.unbind(0))
