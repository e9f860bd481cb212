"""PyTorch/CUDA port of imageenhancement_mp_tpu (first slice).

The fused hist-eq → unsharp main path and the u8 ops it is made of, on torch
tensors.  A CPU tensor runs plain PyTorch; a CUDA tensor runs the
hand-written Hopper kernels in ``kernels/csrc`` (built with nvcc at first
use), or raises.  This package imports neither JAX nor imageenhancement_mp_tpu.
"""

from imageenhancement_mp_tpu_torch.api import (
    equalize_hist,
    equalize_unsharp,
    gaussian_blur,
    unsharp_mask,
)

__all__ = ["equalize_hist", "equalize_unsharp", "gaussian_blur", "unsharp_mask"]
