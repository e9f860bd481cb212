"""Enhancement pipeline presets, as the JAX package's ``models/presets.py``
names them.

The system has no neural models: its "models" are enhancement recipes
(BASELINE.json:6-12).  ``PRESETS`` is a verbatim copy of the JAX package's
table; :func:`get_preset` builds one through ``pipeline.make_pipeline``.
Every preset's stages are ported; ``denoise_sharpen`` stays two ops, as in
the JAX package (its fused kernel is ``kernels/fused.py::median_unsharp``).
"""

from __future__ import annotations

from imageenhancement_mp_tpu_torch.pipeline import make_pipeline

__all__ = ["PRESETS", "get_preset"]

# The five judged configs (BASELINE.json:6-12)
PRESETS: dict[str, list] = {
    # config 1/2: point ops
    "histeq": [("equalize_hist", {})],
    "gamma_stretch": [("gamma", {"gamma": 2.2}), ("contrast_stretch", {})],
    # config 3: fused spatial filters
    "sharpen": [("unsharp_mask", {"amount": 1.0, "ksize": 5})],
    # config 4
    "clahe": [("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)})],
    # config 5: full streaming pipeline
    "denoise_clahe_sharpen": [
        ("median_blur", {"ksize": 5}),
        ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
        ("unsharp_mask", {"amount": 1.0, "ksize": 5}),
    ],
    # two-stage denoise+sharpen (stateless chain; also available as the
    # fused Pallas kernel kernels.fused.median_unsharp_pallas)
    "denoise_sharpen": [
        ("median_blur", {"ksize": 5}),
        ("unsharp_mask", {"amount": 1.0, "ksize": 5}),
    ],
    # north-star pipeline (BASELINE.json:2)
    "histeq_unsharp": [("equalize_hist", {}), ("unsharp_mask", {"amount": 1.0, "ksize": 5})],
}


def get_preset(name: str, mesh=None, shard: str = "batch", axis_name: str | None = None):
    """Build the pipeline of a named preset; ``mesh``, ``shard`` and
    ``axis_name`` shard it over a device mesh (``pipeline.make_pipeline``)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return make_pipeline(PRESETS[name], mesh=mesh, shard=shard, axis_name=axis_name)
