"""The port's registry and api against the JAX package's: the same 40
registry names, each callable through make_pipeline on a small u8 plane;
the inspection chain (resize area → tophat 15 → Canny, then connected
components) through make_pipeline at 0 LSB against JAX's make_pipeline and
the ref/ chain; the 19 api functions of the registry's slice, the 32 of
the arithmetic, statistics and tracking slice, the 16 of the photo slice
and the 23 of the distance, flood-fill, Hough and contour slice with JAX's
parameter names and defaults; the 133 names of the port's api.__all__:
every public function of JAX's api.py and equalize_unsharp."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import api as jax_api
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import OP_REGISTRY as JAX_REGISTRY
from imageenhancement_mp_tpu.pipeline import make_pipeline as jax_make_pipeline
from imageenhancement_mp_tpu_torch import api as port_api
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY

NEW_API = ("add_weighted", "integral", "apply_color_map", "calc_back_project", "filter2d",
           "sep_filter2d", "pyr_down", "pyr_up", "resize", "flip", "rotate", "transpose", "canny",
           "connected_components", "erode", "dilate", "morphology_ex", "get_structuring_element",
           "match_template")
SLICE18_API = ("add", "subtract", "absdiff", "multiply", "divide", "bitwise_and", "bitwise_or",
               "bitwise_xor", "bitwise_not", "minimum", "maximum", "compare", "accumulate",
               "accumulate_square", "accumulate_product", "accumulate_weighted", "blend_linear",
               "psnr", "norm", "mean_std_dev", "min_max_loc", "moments_device", "compare_hist",
               "get_gaussian_kernel", "get_deriv_kernels", "get_rect_sub_pix", "corner_sub_pix",
               "good_features_to_track", "calc_optical_flow_pyr_lk", "mean_shift", "cam_shift",
               "pyr_mean_shift_filtering")
SLICE19_API = ("edge_preserving_filter", "detail_enhance", "stylization", "pencil_sketch",
               "merge_mertens", "tonemap", "decolor", "denoise_tvl1", "tonemap_reinhard",
               "tonemap_drago", "tonemap_mantiuk", "align_mtb", "merge_debevec",
               "phase_correlate", "inpaint", "seamless_clone")
SLICE20_API = ("gabor_kernel", "distance_transform", "flood_fill", "hough_lines",
               "hough_lines_p", "find_contours", "contour_area", "arc_length", "bounding_rect",
               "contour_moments", "moments", "hu_moments", "match_shapes", "convex_hull",
               "is_contour_convex", "point_polygon_test", "convexity_defects", "min_area_rect",
               "box_points", "min_enclosing_circle", "fit_line", "fit_ellipse", "approx_poly_dp")


def _chain(oh, ow):
    return [("resize", {"dsize": (oh, ow), "interpolation": "area"}),
            ("morphology", {"op": "tophat", "ksize": 15}),
            ("canny", {"threshold1": 50.0, "threshold2": 150.0})]


def test_registry_equals_jax():
    assert set(OP_REGISTRY) == set(JAX_REGISTRY) and len(OP_REGISTRY) == 40


def test_api_names_and_signatures():
    assert len(port_api.__all__) == len(set(port_api.__all__)) == 133
    assert len(SLICE18_API) == len(set(SLICE18_API)) == 32
    assert len(SLICE19_API) == len(set(SLICE19_API)) == 16
    assert len(SLICE20_API) == len(set(SLICE20_API)) == 23
    jax_public = {n for n, f in inspect.getmembers(jax_api, inspect.isfunction)
                  if f.__module__ == jax_api.__name__ and not n.startswith("_")}
    assert len(jax_public) == 132
    assert set(port_api.__all__) == jax_public | {"equalize_unsharp"}
    for name in NEW_API + SLICE18_API + SLICE19_API + SLICE20_API:
        mine = inspect.signature(getattr(port_api, name)).parameters
        theirs = inspect.signature(getattr(jax_api, name)).parameters
        assert list(mine) == list(theirs), name
        assert [p.default for p in mine.values()] == [p.default for p in theirs.values()], name
        assert getattr(tie, name) is getattr(port_api, name)


@pytest.mark.parametrize("shape,dsize", [((2, 64, 96), (32, 48)), ((1, 60, 90), (23, 37))])
def test_inspection_chain_matches_jax_and_ref(shape, dsize):
    """2x2 area (the half-up path) and a general area downscale."""
    rng = np.random.default_rng(81)
    yy, xx = np.mgrid[0:shape[1], 0:shape[2]]
    base = 128 + 60 * np.sin(yy / 5.0) + 50 * np.cos(xx / 7.0)
    x = np.clip(base + rng.normal(0, 10, shape), 0, 255).astype(np.uint8)
    pipe = tie.make_pipeline(_chain(*dsize))
    got = pipe(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_make_pipeline(_chain(*dsize))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    chain = np.stack([ref.canny(ref.morphology(ref.resize(p, dsize, "area"), "tophat", 15),
                                50.0, 150.0) for p in x])
    np.testing.assert_array_equal(got, chain)
    assert got.any()
    labels = tie.connected_components(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(labels, np.asarray(ie.connected_components(jnp.asarray(got))))
    np.testing.assert_array_equal(labels, np.stack([ref.connected_components(p, 8) for p in got]))


# one stage of each name, with the arguments it needs, on a small u8 plane
STAGES = {
    "bilateral": {"d": 5}, "threshold": {"thresh": 100.0}, "adaptive_threshold": {},
    "resize": {"dsize": (12, 20)}, "warp_affine": {"M": np.array([[1.0, 0.1, 2.0],
                                                                  [0.0, 1.0, -1.0]]),
                                                   "dsize": (20, 30)},
    "warp_perspective": {"M": np.eye(3), "dsize": (20, 30)},
    "warp_polar": {"dsize": (20, 30), "center": (15.0, 10.0), "max_radius": 9.0},
    "remap": {"map_x": np.tile(np.arange(30, dtype=np.float32), (20, 1)),
              "map_y": np.tile(np.arange(20, dtype=np.float32)[:, None], (1, 30))},
    "undistort": {"K": np.array([[20.0, 0, 15], [0, 20.0, 10], [0, 0, 1]]),
                  "dist": np.array([0.1, 0.0, 0.0, 0.0])},
    "canny": {"threshold1": 20.0, "threshold2": 60.0},
    "calc_back_project": {"hist": np.arange(16.0)}, "filter2d": {"kernel": np.ones((3, 3)) / 9},
    "match_template": {"templ": np.ones((3, 4), np.float32)}, "gamma": {"gamma": 0.5},
    "fast_nl_means": {"h": 10.0, "template_window": 3, "search_window": 5},
    "box_filter": {"ksize": 3}, "stack_blur": {"ksize": 3},
}


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_every_registry_name_runs_through_make_pipeline(name):
    x = np.random.default_rng(82).integers(0, 256, (1, 20, 30), dtype=np.uint8)
    out = tie.make_pipeline([(name, STAGES.get(name, {}))])(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.numel() > 0
