"""Row sharding (imageenhancement_mp_tpu_torch/parallel/spatial.py) on CPU
meshes, held to the JAX package's parallel/spatial.py on its 8 virtual CPU
devices and to the port's own unsharded ops.

Every twin on a mesh that names the CPU 8 times equals JAX's twin on the
same numpy-seeded planes at 0 LSB, but CLAHE: ±1 against JAX on the CPU
(ROADMAP R4), 0 against ref/; and the f32 stretch over a range that does
not start at 0, where JAX's twin is one ulp off JAX's own unsharded op
(ROADMAP R11): the port equals the unsharded op at 0.  Every twin equals the port's unsharded op at
0 LSB on meshes of 1, 2 and 8 entries.  JAX's outputs come from one
shard_map program per dtype, computed once per module: each compile costs
seconds.  Also: the halo exchange stitched against np.pad, the 2-D
batch × rows mesh, the registry (all 24 names run), and the errors (halo
height, CLAHE geometry, collectives outside a sharded call, a shard's
exception reaching the caller).  The geometry twins are in
tests/test_torch_spatial_geom.py."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops import pointwise as jpoint
from imageenhancement_mp_tpu.parallel import spatial as jsp
from imageenhancement_mp_tpu.parallel.sharding import make_mesh as jax_make_mesh
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY
from imageenhancement_mp_tpu_torch.parallel import mesh as tmesh
from imageenhancement_mp_tpu_torch.parallel import spatial as tsp

SHAPE = (2, 64, 56)
K3 = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
MORPH = ("erode", "dilate", "open", "close", "gradient", "tophat", "blackhat")

# case id -> (dtype, op name (its twin is <name>_spatial), args)
CASES = {
    "gauss3": ("u8", "gaussian_blur", (3, 0.0)),
    "gauss5": ("u8", "gaussian_blur", (5, 0.0)),
    "gauss7": ("u8", "gaussian_blur", (7, 0.0)),
    "gauss5/s1.7": ("u8", "gaussian_blur", (5, 1.7)),
    "gauss0/s2": ("u8", "gaussian_blur", (0, 2.0)),  # 13 taps: halo 6 of an 8-row shard
    "unsharp1": ("u8", "unsharp_mask", (1.0, 5, 0.0)),
    "unsharp0.7": ("u8", "unsharp_mask", (0.7, 5, 0.0)),
    "median3": ("u8", "median_blur", (3,)),
    "median5": ("u8", "median_blur", (5,)),
    "box3": ("u8", "box_blur", (3,)),
    "box5x7": ("u8", "box_blur", ((5, 7),)),
    "bilateral": ("u8", "bilateral", (5, 30.0, 6.0)),
    "athresh/gauss": ("u8", "adaptive_threshold", (255.0, "gaussian", "binary", 11, 2.0)),
    "athresh/mean": ("u8", "adaptive_threshold", (200.0, "mean", "binary_inv", 5, -3.0)),
    **{f"morph/{op}": ("u8", "morphology", (op, (3, 5), 2)) for op in MORPH},
    "erode": ("u8", "erode", (3, 2)),
    "dilate": ("u8", "dilate", ((5, 3), 1)),
    "sobel11": ("u8", "sobel", (1, 1, 5)),
    "scharr01": ("u8", "sobel", (0, 1, -1)),
    "filter2d": ("u8", "filter2d", (K3, 2.5)),
    "lap_sharp": ("u8", "laplacian_sharpen", ()),
    "equalize": ("u8", "equalize_hist", ()),
    "stretch": ("u8", "contrast_stretch", ((0.0, 255.0),)),
    "stretch/range": ("u8", "contrast_stretch", ((30.5, 200.25),)),
    "clahe8x8": ("u8", "clahe", (2.0, (8, 8))),  # one tile row a shard
    "clahe16x4": ("u8", "clahe", (3.0, (16, 4))),  # two tile rows a shard
    "gauss5/s1.3/u16": ("u16", "gaussian_blur", (5, 1.3)),
    "unsharp1/u16": ("u16", "unsharp_mask", (1.0, 5, 0.0)),
    "median3/u16": ("u16", "median_blur", (3,)),
    "median5/u16": ("u16", "median_blur", (5,)),
    "box3/u16": ("u16", "box_blur", (3,)),
    "morph/gradient/u16": ("u16", "morphology", ("gradient", 3, 1)),
    "stretch/u16": ("u16", "contrast_stretch", ((0.0, 65535.0),)),
    "clahe8x8/u16": ("u16", "clahe", (2.0, (8, 8))),
    "box3/i16": ("i16", "box_blur", (3,)),
    "box5x7/i16": ("i16", "box_blur", ((5, 7),)),
    "median5/i16": ("i16", "median_blur", (5,)),
    "morph/tophat/i16": ("i16", "morphology", ("tophat", 3, 1)),
    "stretch/i16": ("i16", "contrast_stretch", ((-20.5, 512.0),)),
    "stretch/f32": ("f32", "contrast_stretch", ((0.0, 255.0),)),
    "stretch/f32/range": ("f32", "contrast_stretch", ((30.5, 200.25),)),
}
# ROADMAP R11: JAX's f32 stretch twin (its spatial.py:390-397) is one ulp
# off JAX's unsharded op where the range does not start at 0; the port
# follows the unsharded law
R11 = {"stretch/f32/range"}


def _planes(dtype: str) -> np.ndarray:
    rng = np.random.default_rng({"u8": 2301, "u16": 2302, "i16": 2303, "f32": 2304}[dtype])
    if dtype == "f32":
        return rng.normal(100.0, 40.0, SHAPE).astype(np.float32)
    np_dtype = {"u8": np.uint8, "u16": np.uint16, "i16": np.int16}[dtype]
    info = np.iinfo(np_dtype)
    return rng.integers(info.min, info.max, SHAPE, endpoint=True).astype(np_dtype)


PLANES = {d: _planes(d) for d in ("u8", "u16", "i16", "f32")}


def _twin(module, op: str):
    return getattr(module, f"{op}_spatial")


@pytest.fixture(scope="module")
def jax_outputs():
    """Every case's JAX twin on the 8 virtual devices: one program a dtype."""
    mesh = jax_make_mesh(8, axis_name="y")
    out = {}
    for dtype, planes in PLANES.items():
        ids = [c for c, (d, _, _) in CASES.items() if d == dtype]

        def fn(p, ids=ids):
            return tuple(_twin(jsp, CASES[c][1])(p, *CASES[c][2], axis_name="y") for c in ids)

        spec = P(None, "y", None)
        run = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=(spec,) * len(ids),
                                    check_vma=False))
        out.update(zip(ids, (np.asarray(o) for o in run(planes))))
    return out


@pytest.fixture(scope="module")
def meshes():
    made = {n: tmesh.make_mesh(n, "y", device="cpu") for n in (1, 2, 8)}
    yield made
    for m in made.values():
        m.close()


def _port_twin(case: str, mesh) -> np.ndarray:
    dtype, op, args = CASES[case]
    fn = tsp.shard_spatial(lambda p: _twin(tsp, op)(p, *args, axis_name="y"), mesh)
    return fn(torch.from_numpy(PLANES[dtype])).numpy()


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.float64) - np.asarray(b).astype(np.float64)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_twin_equals_the_jax_twin_on_eight_devices(case, meshes, jax_outputs):
    got = _port_twin(case, meshes[8])
    want = jax_outputs[case]
    assert got.dtype == want.dtype and got.shape == want.shape
    if case in R11:
        dtype, op, args = CASES[case]
        unsharded = np.asarray(jpoint.contrast_stretch_planes(jnp.asarray(PLANES[dtype]), *args))
        np.testing.assert_array_equal(got, unsharded)
        assert np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max() == 1
    elif CASES[case][1] == "clahe":
        assert _maxdiff(got, want) <= 1  # R4: XLA:CPU's blend
        planes = PLANES[CASES[case][0]]
        np.testing.assert_array_equal(got, np.stack([ref.clahe(p, *CASES[case][2]) for p in planes]))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_equals_the_unsharded_op(case, n, meshes):
    dtype, op, args = CASES[case]
    want = OP_REGISTRY[op](torch.from_numpy(PLANES[dtype]), *args).numpy()
    np.testing.assert_array_equal(_port_twin(case, meshes[n]), want)


@pytest.mark.parametrize("mode, r, np_mode", [("reflect", 1, "reflect"), ("reflect", 3, "reflect"),
                                              ("edge", 2, "edge"), ("edge", 8, "edge"),
                                              ("const", 3, "constant")])
def test_halo_exchange_stitches_to_np_pad(mode, r, np_mode, meshes):
    """Each shard's extended block is its rows of the frame padded whole."""
    planes = PLANES["u8"]
    h = SHAPE[1] // 8
    ext = tmesh.run_sharded(lambda p: tsp.halo_exchange(p, r, "y", mode, const_val=7),
                            meshes[8], (None, "y"), (None, "y"))(torch.from_numpy(planes)).numpy()
    ext = ext.reshape(SHAPE[0], 8, h + 2 * r, SHAPE[2])
    kw = {"constant_values": 7} if np_mode == "constant" else {}
    want = np.pad(planes, ((0, 0), (r, r), (0, 0)), mode=np_mode, **kw)
    for i in range(8):
        np.testing.assert_array_equal(ext[:, i], want[:, i * h:i * h + h + 2 * r])


def test_halo_height_and_mode_errors(meshes):
    x = torch.from_numpy(PLANES["u8"][:1, :16])  # 2 rows a shard
    with pytest.raises(ValueError, match="too small for halo radius 3"):
        tsp.shard_spatial(lambda p: tsp.gaussian_blur_spatial(p, 7), meshes[8])(x)
    with pytest.raises(ValueError, match="too small for halo radius 2 with mode 'reflect'"):
        tsp.shard_spatial(lambda p: tsp.gaussian_blur_spatial(p, 5), meshes[8])(x)
    # replicate needs h >= r only: median 5 on 2-row shards
    got = tsp.shard_spatial(lambda p: tsp.median_blur_spatial(p, 5), meshes[8])(x)
    np.testing.assert_array_equal(got.numpy(), OP_REGISTRY["median_blur"](x, 5).numpy())
    with pytest.raises(ValueError, match="mode must be"):
        tsp.shard_spatial(lambda p: tsp.halo_exchange(p, 1, "y", "wrap"), meshes[8])(x)
    with pytest.raises(ValueError, match="odd kernel height"):
        tsp.shard_spatial(lambda p: tsp.erode_spatial(p, (2, 3)), meshes[2])(x)


def test_clahe_geometry_errors(meshes):
    x = torch.from_numpy(PLANES["u8"][:1])
    with pytest.raises(ValueError, match="tile rows 4 divisible by mesh size 8"):
        tsp.shard_spatial(lambda p: tsp.clahe_spatial(p, 2.0, (4, 4)), meshes[8])(x)
    with pytest.raises(ValueError, match="divisible geometry"):
        tsp.shard_spatial(lambda p: tsp.clahe_spatial(p, 2.0, (8, 5)), meshes[8])(x)
    with pytest.raises(TypeError, match="uint8/uint16"):
        tsp.shard_spatial(lambda p: tsp.clahe_spatial(p), meshes[2])(x.to(torch.int16))


@pytest.fixture(scope="module")
def jax_2d():
    """JAX's 2-D (batch, y) = (2, 4) mesh: equalize → Gaussian 5."""
    mesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 4), ("batch", "y"))
    planes = PLANES["u8"][:, :32].repeat(2, axis=0)  # 4 planes

    def chain(p):
        return jsp.gaussian_blur_spatial(jsp.equalize_hist_spatial(p, axis_name="y"), 5,
                                         axis_name="y")

    x = jsp.device_put_spatial(planes, mesh, axis_name="y", batch_axis="batch")
    return planes, np.asarray(jsp.shard_spatial(chain, mesh, axis_name="y",
                                                batch_axis="batch")(x))


def test_batch_times_rows_on_a_2d_mesh(jax_2d):
    planes, want = jax_2d
    mesh = tmesh.Mesh(np.array([torch.device("cpu")] * 8, dtype=object).reshape(2, 4),
                      ("batch", "y"))
    try:
        def chain(p):
            return tsp.gaussian_blur_spatial(tsp.equalize_hist_spatial(p, axis_name="y"), 5,
                                             axis_name="y")

        x = tsp.device_put_spatial(planes, mesh, axis_name="y", batch_axis="batch")
        got = tsp.shard_spatial(chain, mesh, axis_name="y", batch_axis="batch")(x)
        assert isinstance(got, tmesh.ShardedTensor) and got.spec == ("batch", "y", None)
        got = got.gather().numpy()
        np.testing.assert_array_equal(got, want)
        unsharded = OP_REGISTRY["gaussian_blur"](OP_REGISTRY["equalize_hist"](
            torch.from_numpy(planes)), 5)
        np.testing.assert_array_equal(got, unsharded.numpy())
    finally:
        mesh.close()


# a stage's arguments where the op has required ones
_STAGE_KW = {
    "gamma": {"gamma": 0.8}, "threshold": {"thresh": 100.0}, "filter2d": {"kernel": K3},
    "resize": {"dsize": (32, 40), "interpolation": "cubic"},
    "warp_affine": {"M": ((0.9, 0.1, 3.0), (-0.1, 0.9, 5.0)), "dsize": (48, 56)},
    "remap": {"map_x": np.tile(np.linspace(-1.0, 57.0, 60, dtype=np.float32), (40, 1)),
              "map_y": np.tile(np.linspace(-1.0, 65.0, 40, dtype=np.float32)[:, None], (1, 60))},
    "canny": {"threshold1": 50.0, "threshold2": 150.0},
}


def test_registry_names(meshes):
    """JAX's 24 names, and every one runs: its one-stage pipeline on a mesh
    of 2 equals the unsharded op of the same name."""
    assert set(tsp.SPATIAL_OP_REGISTRY) == set(jsp.SPATIAL_OP_REGISTRY)
    assert len(tsp.SPATIAL_OP_REGISTRY) == 24
    x = torch.from_numpy(PLANES["u8"])
    for name in tsp.SPATIAL_OP_REGISTRY:
        kw = _STAGE_KW.get(name, {})
        got = tsp.make_spatial_pipeline([(name, kw)], meshes[2])(x)
        assert torch.equal(got, OP_REGISTRY[name](x, **kw)), name


def test_spatial_pipeline_stage_errors(meshes):
    with pytest.raises(KeyError, match="unknown spatial op"):
        tsp.make_spatial_pipeline(["nope"], meshes[2])
    with pytest.raises(TypeError, match="backend"):
        tsp.make_spatial_pipeline([("median_blur", {"backend": "xla"})], meshes[2])


@pytest.mark.parametrize("call", [
    lambda x: tmesh.psum(x, "y"), lambda x: tmesh.pmin(x, "y"), lambda x: tmesh.pmax(x, "y"),
    lambda x: tmesh.all_gather(x, "y"), lambda x: tmesh.ppermute(x, "y", [(0, 1)]),
    lambda x: tmesh.shift(x, x, "y"),
    lambda x: tmesh.axis_index("y"), lambda x: tmesh.axis_size("y"),
    lambda x: tsp.equalize_hist_spatial(x)])
def test_collectives_raise_outside_a_sharded_call(call, meshes):
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(NameError, match="unbound axis name"):
        call(x)
    # and inside one, on an axis the mesh does not name
    with pytest.raises(NameError, match="unbound axis name: 'x'"):
        tmesh.run_sharded(lambda p: tmesh.psum(p, "x"), meshes[2], (None, "y"), (None, "y"))(x)


def test_a_shard_exception_reaches_the_caller(meshes):
    """Shard 5 raises while the others wait in a psum: the call raises that
    exception, no thread hangs, and the mesh serves the next call."""
    def fn(p):
        if tmesh.axis_index("y") == 5:
            raise ArithmeticError("shard 5 failed")
        return tmesh.psum(p, "y")

    done = []

    def call():
        with pytest.raises(ArithmeticError, match="shard 5 failed"):
            tmesh.run_sharded(fn, meshes[8], (None, "y"), (None, "y"))(
                torch.zeros((1, 8, 4), dtype=torch.int32))
        done.append(True)

    t = threading.Thread(target=call)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and done == [True]
    ones = torch.ones((1, 8, 4), dtype=torch.int32)
    got = tmesh.run_sharded(lambda p: tmesh.psum(p, "y"), meshes[8], (None, "y"), (None, "y"))(ones)
    assert torch.equal(got, torch.full((1, 8, 4), 8, dtype=torch.int32))


def test_collectives_on_a_mesh():
    """psum, pmin, pmax, all_gather (stacked and tiled), ppermute and shift
    in shard order, axis_index and axis_size, on a 2-D mesh within each
    group."""
    mesh = tmesh.Mesh([["cpu"] * 4] * 2, ("b", "y"))
    try:
        def fn(p):
            b, i = tmesh.axis_index("b"), tmesh.axis_index("y")
            v = torch.tensor([[10 * b + i]], dtype=torch.int32)
            assert tmesh.axis_size("y") == 4 and tmesh.axis_size(("b", "y")) == 8
            assert tmesh.axis_index(("b", "y")) == 4 * b + i
            out = [tmesh.psum(v, "y"), tmesh.pmin(v, "y"), tmesh.pmax(v, "y"),
                   tmesh.all_gather(v, "y", axis=1, tiled=True),
                   tmesh.all_gather(v, "y")[:, :, 0].T,
                   tmesh.ppermute(v, "y", [(k, (k + 1) % 4) for k in range(4)]),
                   tmesh.psum(v, ("b", "y"))]
            above, below = tmesh.shift(v, -v, "y")
            out += [torch.full_like(v, -1) if above is None else above,
                    torch.full_like(v, -1) if below is None else below]
            return torch.cat(out, dim=1)[None]

        got = tmesh.run_sharded(fn, mesh, ("b", "y"), ("b", "y"))(
            torch.zeros((2, 4, 1), dtype=torch.int32)).numpy()
        for b in range(2):
            for i in range(4):
                row = got[b, i]
                vals = [10 * b + k for k in range(4)]
                assert list(row) == [sum(vals), min(vals), max(vals), *vals, *vals,
                                     10 * b + (i - 1) % 4, 40 + 12,
                                     vals[i - 1] if i else -1, -vals[i + 1] if i < 3 else -1]
    finally:
        mesh.close()
