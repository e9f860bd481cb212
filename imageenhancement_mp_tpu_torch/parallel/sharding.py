"""Batch sharding: planes split on their leading dimension over a mesh axis.

The counterpart of the JAX package's ``parallel/sharding.py``.  Every
enhancement but the pooled histogram is independent per plane, so a sharded
pipeline needs no collective; :func:`equalize_hist_global_sharded` pools its
histograms across the shards with one ``psum``.
"""

from __future__ import annotations

from typing import Callable

import torch

from imageenhancement_mp_tpu_torch.parallel.mesh import (Mesh, ShardedTensor, device_put,
                                                         make_mesh, run_sharded)

__all__ = ["make_mesh", "shard_pipeline", "device_put_sharded_batch",
           "equalize_hist_global_sharded"]


def shard_pipeline(planes_fn: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh,
                   axis_name: str = "batch") -> Callable:
    """``planes_fn`` (``[B,H,W] → [B,H,W]``) over the mesh's ``axis_name``,
    planes split on the leading dimension; B must divide by the axis size."""
    return run_sharded(planes_fn, mesh, (axis_name,), (axis_name,))


def equalize_hist_global_sharded(mesh: Mesh, axis_name: str = "batch",
                                 channels: int = 1) -> Callable:
    """Video-consistent hist-eq over a sharded ``[B,H,W]`` u8 batch: each
    shard's histograms pool across the mesh with a ``psum`` and every frame
    maps through the same LUT.  ``channels > 1``: the planes are frame-major,
    channel-minor ``B = N·channels`` stacks and each channel pools its own
    histogram across frames and shards."""
    from imageenhancement_mp_tpu_torch.ops.histogram import equalize_hist_global_planes

    def fn(planes: torch.Tensor) -> torch.Tensor:
        return equalize_hist_global_planes(planes, channels=channels, axis_name=axis_name)

    return run_sharded(fn, mesh, (axis_name,), (axis_name,))


def device_put_sharded_batch(batch, mesh: Mesh, axis_name: str = "batch") -> ShardedTensor:
    """Place a batch (tensor or NumPy array) on the mesh, split along its
    leading dimension."""
    return device_put(batch, mesh, (axis_name,))
