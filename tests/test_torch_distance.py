"""distanceTransform in the port (ops/distance.py and api.distance_transform)
on CPU tensors against the NumPy oracle ref/, the JAX package's device op
(``ie.distance_transform``) and cv2.

Tolerance 0: every f32 distance has the oracle's bits (``_ulp32 == 0``), the
u8 field is equal.  Against cv2 the port is bitwise for L1, C and L2 with
the 5×5 mask; L2 with the 3×3 mask follows cv2's portable float law, which
the default build's IPP route misses by ≤ 2e-6 relative
(tests/test_distance.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from detseed import seed

import imageenhancement_mp_tpu as ie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu_torch.ops.distance import DIST_MASKS, distance_transform_planes

cv2 = pytest.importorskip("cv2")

_CVDT = {"l1": cv2.DIST_L1, "c": cv2.DIST_C, "l2": cv2.DIST_L2}
_PAIRS = [("l1", 3), ("c", 3), ("l2", 3), ("l2", 5)]


def _ulp32(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()) if a.size else 0


def test_mask_weights_are_refs():
    from imageenhancement_mp_tpu.ref import ops as rops

    assert DIST_MASKS.keys() == rops._DIST_MASKS.keys()
    for k, v in DIST_MASKS.items():
        for a, b in zip(v, rops._DIST_MASKS[k]):
            assert (a is None and b is None) or (a.dtype == b.dtype == np.float32 and a == b)


@pytest.mark.parametrize("dt", ["l1", "c", "l2"])
@pytest.mark.parametrize("mask", [3, 5])
def test_port_vs_ref_and_cv2(dt, mask):
    """tests/test_distance.py::test_ref_vs_cv2's cases (its seed, 40
    images of 4-79 rows and columns with sources at density 0.5, 0.1, 0.02
    or 0.003): the port equals ref/ at 0 and cv2 as ref/ does."""
    rng = np.random.default_rng(seed("distance", dt, mask))
    for t in range(40):
        H, W = int(rng.integers(4, 80)), int(rng.integers(4, 80))
        p = [0.5, 0.1, 0.02, 0.003][t % 4]
        img = (rng.random((H, W)) > p).astype(np.uint8) * int(rng.integers(1, 256))
        got = tie.distance_transform(torch.from_numpy(img), dt, mask).numpy()
        assert got.dtype == np.float32
        assert _ulp32(got, ref.distance_transform(img, dt, mask)) == 0, (t, H, W)
        want = cv2.distanceTransform(img, _CVDT[dt], mask)
        if dt == "l2" and mask == 3:
            rel = np.abs(got.astype(np.float64) - want) / np.maximum(want, 1e-6)
            assert rel.max() <= 2e-6, (t, rel.max())
        else:
            assert _ulp32(got, want) == 0, (t, H, W, p)


@pytest.mark.parametrize("dt,mask,dst", [("l1", 3, "f32"), ("c", 3, "f32"), ("l2", 3, "f32"),
                                         ("l2", 5, "f32"), ("l1", 3, "u8")])
def test_batch_vs_jax_device_op(dt, mask, dst):
    """tests/test_distance.py::test_device_vs_ref's batch: the port against
    JAX's device op (one compile of its scan each, 5-17 s) and ref/ per
    plane."""
    rng = np.random.default_rng(seed("distance_dev"))
    img = (rng.random((2, 33, 41)) > 0.08).astype(np.uint8) * 255
    got = tie.distance_transform(torch.from_numpy(img), dt, mask, dst).numpy()
    want = np.asarray(ie.distance_transform(jnp.asarray(img), dt, mask, dst))
    assert got.dtype == want.dtype == (np.uint8 if dst == "u8" else np.float32)
    for n in range(2):
        oracle = ref.distance_transform(img[n], dt, mask, dst)
        if dst == "f32":
            assert _ulp32(got[n], want[n]) == _ulp32(got[n], oracle) == 0
        else:
            np.testing.assert_array_equal(got[n], want[n])
            np.testing.assert_array_equal(got[n], oracle)


def test_u8_saturates_as_cv2():
    """tests/test_distance.py::test_ref_edge_cases' wide strip: the L1
    field passes 255 and saturates there."""
    wide = np.full((5, 400), 255, np.uint8)
    wide[0, 0] = 0
    got = tie.distance_transform(torch.from_numpy(wide), "l1", 3, "u8").numpy()
    np.testing.assert_array_equal(
        got, cv2.distanceTransform(wide, cv2.DIST_L1, 3, dstType=cv2.CV_8U))
    np.testing.assert_array_equal(got, ref.distance_transform(wide, "l1", 3, "u8"))
    assert got.dtype == np.uint8 and got.max() == 255


def test_edge_cases():
    nz = np.full((7, 9), 255, np.uint8)
    got = tie.distance_transform(torch.from_numpy(nz), "l2", 3).numpy()
    np.testing.assert_array_equal(got, cv2.distanceTransform(nz, cv2.DIST_L2, 3))
    assert (got == np.float32(3.4028235e38)).all()          # FLT_MAX everywhere
    az = np.zeros((7, 9), np.uint8)
    assert tie.distance_transform(torch.from_numpy(az), "l1", 3).numpy().max() == 0
    # one row, one column: the sheared columns hold a single cell
    for shape in [(1, 17), (17, 1), (2, 2)]:
        x = np.full(shape, 9, np.uint8)
        x.flat[0] = 0
        for dt, mask in _PAIRS:
            got = distance_transform_planes(torch.from_numpy(x[None]), dt, mask)[0].numpy()
            want = cv2.distanceTransform(x, _CVDT[dt], mask)
            tol = 2e-6 if (dt, mask) == ("l2", 3) else 0.0
            np.testing.assert_allclose(got, want, rtol=tol, atol=0)


@pytest.mark.parametrize("shape,channels_last", [((12, 17, 3), True), ((3, 12, 17), False),
                                                 ((2, 12, 17, 2), True)])
def test_layouts_per_plane(shape, channels_last):
    """[H,W,C], [N,H,W] and [N,H,W,C] inputs: each plane is ref/'s field."""
    rng = np.random.default_rng(seed("torch_distance_layout", shape))
    img = (rng.random(shape) > 0.1).astype(np.uint8) * 7
    got = tie.distance_transform(torch.from_numpy(img), "l2", 5,
                                 channels_last=channels_last).numpy()
    assert got.shape == img.shape
    planes = np.moveaxis(img, -1, 0 if img.ndim == 3 else 1) if channels_last else img
    out = np.moveaxis(got, -1, 0 if img.ndim == 3 else 1) if channels_last else got
    for p, o in zip(planes.reshape(-1, 12, 17), out.reshape(-1, 12, 17)):
        assert _ulp32(o, ref.distance_transform(p, "l2", 5)) == 0


def test_api_validation():
    img = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tie.distance_transform(img, "l3")
    with pytest.raises(ValueError):
        tie.distance_transform(img, "l2", 7)
    with pytest.raises(ValueError):
        tie.distance_transform(img, "l2", 3, dst_type="u8")
    with pytest.raises(ValueError):
        tie.distance_transform(img, "l1", 3, dst_type="u16")
    with pytest.raises(TypeError):
        tie.distance_transform(img.float())
    with pytest.raises(TypeError):
        tie.distance_transform(np.zeros((4, 4), np.uint8))
