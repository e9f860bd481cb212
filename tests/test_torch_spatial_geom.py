"""The geometry twins of row sharding (imageenhancement_mp_tpu_torch/
parallel/spatial.py: resize, warpAffine, remap, warpPolar and Canny) on CPU
meshes, held to the port's own unsharded ops and to the JAX package's
parallel/spatial.py on its 8 virtual CPU devices.

* Every twin equals the port's unsharded op on the gathered frame at 0 LSB
  on meshes that name the CPU 1, 2 and 8 times: resize in every
  interpolation (area by integer factors, the general area downscale and an
  area upscale) on u8/u16/i16/f32, warpAffine in four interpolations under
  both borders on the four dtypes, remap, warpPolar (forward, inverse, log)
  and Canny on planes whose weak chains cross shard boundaries.
* Against JAX's twins on 8 devices, with tests/test_spatial_geom.py's own
  tolerances: 0 for u8 and nearest and for the integer warps, ±1 for the
  u16/i16 resizes and 1e-2 of the largest value for f32 lerps, cubic and
  Lanczos-4 (XLA:CPU contracts multiply-adds into FMAs, ROADMAP R4).  JAX's
  outputs come from one shard_map program a dtype, computed once per module.
* ``warp_matrix_u8``'s ``row0`` (the kernel's first frame row): the plain
  version's rows equal the matching rows of the whole call, and the CUDA
  branch (launch stubbed) passes each shard's first row.
* ``run_sharded`` with several inputs; the registry's ``remap`` stage, which
  takes whole maps and equals the unsharded remap, where JAX's stage renders
  ``n·oh`` rows (ROADMAP R12); the errors.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.parallel import spatial as jsp
from imageenhancement_mp_tpu.parallel.sharding import make_mesh as jax_make_mesh
from imageenhancement_mp_tpu_torch.kernels import warp as kw
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY
from imageenhancement_mp_tpu_torch.ops import canny as tcanny
from imageenhancement_mp_tpu_torch.ops import warp as twarp
from imageenhancement_mp_tpu_torch.parallel import mesh as tmesh
from imageenhancement_mp_tpu_torch.parallel import spatial as tsp
from imageenhancement_mp_tpu_torch.pipeline import make_pipeline
from imageenhancement_mp_tpu_torch.utils import warp_coords
from imageenhancement_mp_tpu_torch.utils.warp_coords import (get_rotation_matrix_2d,
                                                              invert_affine, invert_perspective)

SHAPE = (2, 64, 48)
DTYPES = ("u8", "u16", "i16", "f32")
ROT = get_rotation_matrix_2d((20.0, 24.0), 25.0, 0.9)
POLAR_CENTER, POLAR_RADIUS = (23.5, 30.25), 28.0
MAPS_HW = (32, 36)

RESIZE = {  # case -> (interpolation, dsize) from 64 x 48
    "nearest": ("nearest", (40, 28)),
    "linear": ("linear", (40, 28)),
    "linear/up": ("linear", (96, 80)),
    "cubic": ("cubic", (56, 44)),
    "lanczos4": ("lanczos4", (56, 44)),
    "area/int": ("area", (32, 24)),
    "area/int3x4": ("area", (16, 12)),
    "area/general": ("area", (24, 20)),
    "area/up": ("area", (96, 70)),
}
WARPS = [(interp, border, bv) for interp in ("nearest", "linear", "cubic", "lanczos4")
         for border, bv in (("constant", 7.0), ("replicate", 0.0))]
POLAR = [(False, False, (40, 64)), (True, False, (40, 64)), (False, True, (48, 64)),
         (True, True, (48, 64))]
CANNY = [(3, False), (3, True), (5, False), (7, True)]
REMAPS = {"u8": ("nearest", "linear", "cubic", "lanczos4"), "u16": ("linear",),
          "i16": ("linear",), "f32": ("linear",)}


def _planes(dtype: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "f32":
        return (rng.random(SHAPE) * 500 - 100).astype(np.float32)
    np_dtype = {"u8": np.uint8, "u16": np.uint16, "i16": np.int16}[dtype]
    info = np.iinfo(np_dtype)
    return rng.integers(info.min, info.max, SHAPE, endpoint=True).astype(np_dtype)


def _edge_planes() -> np.ndarray:
    """Blocks of 8x8 plus noise: weak edge chains that cross the 8-row shards."""
    rng = np.random.default_rng(2410)
    base = rng.integers(0, 256, (2, 8, 6)).astype(np.uint8)
    planes = np.stack([np.kron(b, np.ones((8, 8), np.uint8)) for b in base])
    noise = rng.integers(0, 30, planes.shape)
    return np.clip(planes.astype(np.int32) + noise, 0, 255).astype(np.uint8)


PLANES = {d: _planes(d, 2400 + i) for i, d in enumerate(DTYPES)}
EDGES = _edge_planes()
_rng = np.random.default_rng(2420)
MAP_X = (_rng.random(MAPS_HW) * 52 - 2).astype(np.float32)
MAP_Y = (_rng.random(MAPS_HW) * 68 - 2).astype(np.float32)

# case id -> (dtype, input name, the port's twin as a function of the local
# block (and map blocks), JAX's twin likewise)
CASES = {}
for _d in DTYPES:
    for _c, (_i, _s) in RESIZE.items():
        CASES[f"resize/{_c}/{_d}"] = (
            _d, "planes", lambda p, *m, i=_i, s=_s: tsp.resize_spatial(p, s, i),
            lambda p, *m, i=_i, s=_s: jsp.resize_spatial(p, s, i))
    for _i, _b, _v in WARPS:
        CASES[f"warp/{_i}/{_b}/{_d}"] = (
            _d, "planes",
            lambda p, *m, i=_i, b=_b, v=_v: tsp.warp_affine_spatial(p, ROT, (64, 52), i, b, v),
            lambda p, *m, i=_i, b=_b, v=_v: jsp.warp_affine_spatial(p, ROT, (64, 52), i, b, v))
    for _i in REMAPS[_d]:
        CASES[f"remap/{_i}/{_d}"] = (
            _d, "planes", lambda p, mx, my, i=_i: tsp.remap_spatial(p, mx, my, i, "replicate"),
            lambda p, mx, my, i=_i: jsp.remap_spatial(p, mx, my, i, "replicate"))
for _log, _inv, _s in POLAR:
    CASES[f"polar/log={_log}/inverse={_inv}"] = (
        "u8", "planes",
        lambda p, *m, l=_log, v=_inv, s=_s: tsp.warp_polar_spatial(
            p, s, POLAR_CENTER, POLAR_RADIUS, l, v),
        lambda p, *m, l=_log, v=_inv, s=_s: jsp.warp_polar_spatial(
            p, s, POLAR_CENTER, POLAR_RADIUS, l, v))
for _a, _l2 in CANNY:
    CASES[f"canny/{_a}/{'L2' if _l2 else 'L1'}"] = (
        "u8", "edges", lambda p, *m, a=_a, l=_l2: tsp.canny_spatial(p, 40.0, 120.0, a, l),
        lambda p, *m, a=_a, l=_l2: jsp.canny_spatial(p, 40.0, 120.0, a, l))

# JAX's twins on 8 devices: every case but the cubic and Lanczos-4 warps of
# u16/i16 and under the constant border (each costs JAX seconds of compile;
# tests/test_spatial_geom.py takes those two under replicate on u8 and f32)
JAX_CASES = [c for c in CASES if not (
    c.startswith(("warp/cubic/", "warp/lanczos4/"))
    and (c.endswith(("/u16", "/i16")) or "/constant/" in c))]


def _input(case: str) -> np.ndarray:
    dtype, name = CASES[case][:2]
    return EDGES if name == "edges" else PLANES[dtype]


def _unsharded(case: str) -> torch.Tensor:
    """The port's unsharded op on the whole frame (and whole maps)."""
    x = torch.from_numpy(_input(case))
    kind, rest = case.split("/", 1)
    if kind == "resize":
        interp, dsize = RESIZE[rest.rsplit("/", 1)[0]]
        return OP_REGISTRY["resize"](x, dsize, interp)
    if kind == "warp":
        interp, border = rest.split("/")[:2]
        bv = 7.0 if border == "constant" else 0.0
        return OP_REGISTRY["warp_affine"](x, ROT, (64, 52), interp, border, bv)
    if kind == "remap":
        return twarp.remap_planes(x, MAP_X, MAP_Y, rest.split("/")[0], "replicate")
    if kind == "polar":
        log, inv, dsize = POLAR[[f"log={a}/inverse={b}" for a, b, _ in POLAR].index(rest)]
        return twarp.warp_polar_planes(x, dsize, POLAR_CENTER, POLAR_RADIUS, log, inv)
    ap, norm = rest.split("/")
    return tcanny.canny_planes(x, 40.0, 120.0, int(ap), norm == "L2")


@pytest.fixture(scope="module")
def meshes():
    made = {n: tmesh.make_mesh(n, "y", device="cpu") for n in (1, 2, 8)}
    yield made
    for m in made.values():
        m.close()


def _port_twin(case: str, mesh) -> np.ndarray:
    fn = CASES[case][2]
    run = tmesh.run_sharded(fn, mesh, [(None, "y"), ("y",), ("y",)], (None, "y"))
    return run(torch.from_numpy(_input(case)), MAP_X, MAP_Y).numpy()


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's twins of JAX_CASES on 8 virtual devices: one program a dtype."""
    mesh = jax_make_mesh(8, axis_name="y")
    out = {}
    for dtype in DTYPES:
        ids = [c for c in JAX_CASES if CASES[c][0] == dtype]

        def fn(p, e, mx, my, ids=ids):
            return tuple(CASES[c][3](e if CASES[c][1] == "edges" else p, mx, my) for c in ids)

        rows = P(None, "y", None)
        run = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(rows, rows, P("y", None),
                                                              P("y", None)),
                                    out_specs=(rows,) * len(ids), check_vma=False))
        out.update(zip(ids, (np.asarray(o) for o in run(PLANES[dtype], EDGES, MAP_X, MAP_Y))))
    return out


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_twin_equals_the_unsharded_op(case, n, meshes):
    want = _unsharded(case).numpy()
    got = _port_twin(case, meshes[n])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _tolerance(case: str, want: np.ndarray) -> float:
    """tests/test_spatial_geom.py's bound for the case.  Its resize cases have
    no general area downscale: there JAX sums in f32 matmuls and the port in
    f64, ±1 (tests/test_torch_resize.py's bound), and the port is held to
    ref/ at 0 by :func:`_assert_area_matches_ref`."""
    dtype = CASES[case][0]
    kind, interp = case.split("/")[:2]
    if case.startswith("resize/area/general/") and dtype != "f32":
        return 1.0
    if dtype == "u8" or interp == "nearest" or kind in ("remap", "polar", "canny"):
        return 0.0
    if kind == "warp" and interp in ("linear", "nearest"):
        return 0.0
    if dtype == "f32":
        return 1e-2 * max(1.0, float(np.abs(want).max()))
    return 1.0


@pytest.mark.parametrize("case", JAX_CASES)
def test_twin_matches_the_jax_twin_on_eight_devices(case, meshes, jax_outputs):
    got, want = _port_twin(case, meshes[8]), jax_outputs[case]
    assert got.dtype == want.dtype and got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert d <= _tolerance(case, want), d
    if case.startswith("resize/area/general/") and CASES[case][0] != "f32":
        _assert_area_matches_ref(_input(case), got, (24, 20))


def _area_cells(shape: tuple, dsize) -> list:
    """ref/'s cells of the general area downscale of ``shape`` (H, W) to
    ``dsize``: ``(dy, dx, ys, xs, outer weights)`` each."""
    (oh, ow), (H, W) = dsize, shape
    sy, sx = H / oh, W / ow
    cells = []
    for dy in range(oh):
        ys = np.arange(int(np.floor(dy * sy)), min(int(np.ceil((dy + 1) * sy)), H))
        wy = np.minimum(ys + 1, min((dy + 1) * sy, H)) - np.maximum(ys, dy * sy)
        for dx in range(ow):
            xs = np.arange(int(np.floor(dx * sx)), min(int(np.ceil((dx + 1) * sx)), W))
            wx = np.minimum(xs + 1, min((dx + 1) * sx, W)) - np.maximum(xs, dx * sx)
            cells.append((dy, dx, ys, xs, np.outer(wy, wx)))
    return cells


def _tie_count(x: np.ndarray, dsize) -> int:
    """The cells whose weighted mean lies within 1e-9 of a half: there the
    order of the f64 sum decides the rounding."""
    H, W = x.shape[1:]
    cell = float(np.float32(1.0 / ((H / dsize[0]) * (W / dsize[1]))))
    n = 0
    for p in x:
        for _, _, ys, xs, w in _area_cells((H, W), dsize):
            mean = float(np.sum(p[np.ix_(ys, xs)] * w, dtype=np.longdouble)) * cell
            n += abs(mean - np.floor(mean) - 0.5) < 1e-9
    return n


def _assert_area_matches_ref(x: np.ndarray, got: np.ndarray, dsize) -> None:
    """The general area downscale against ref/ at 0: the port sums each cell's
    terms in ref/'s order, ties included."""
    want = np.stack([ref.resize(p, dsize, "area") for p in x])
    np.testing.assert_array_equal(got, want)


# general area downscales with cells of 4-9, 12-20 and 130-140 terms, each to
# its mesh sizes (the output rows divide among the shards)
TIE_GEOMETRIES = {"64x80->40x32": ((64, 80), (40, 32), (2, 8)),
                  "80x64->32x20": ((80, 64), (32, 20), (2, 8)),
                  "128x80->10x8": ((128, 80), (10, 8), (2,))}


def _tie_planes(dtype: str, shape: tuple, dsize, seed: int) -> np.ndarray:
    """Two planes built so that most area cells tie: values that are
    multiples of 10 (each term's exact value a whole number), then, cell by
    cell, the pixel of the largest weight set to the value of its type,
    among 1024, that puts the cell's exact mean on a half."""
    np_dtype = {"u8": np.uint8, "u16": np.uint16, "i16": np.int16}[dtype]
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(seed)
    x = (rng.integers(info.min // 10, info.max // 10, (2, *shape), endpoint=True) * 10)
    area = (shape[0] / dsize[0]) * (shape[1] / dsize[1])
    lo = max(info.min, -512)
    cand = np.arange(lo, min(info.max, lo + 1023) + 1, dtype=np.longdouble)
    for p in x:
        for _, _, ys, xs, w in _area_cells(shape, dsize):
            k = np.unravel_index(np.argmax(w), w.shape)
            y, xx = ys[k[0]], xs[k[1]]
            p[y, xx] = 0
            rest = np.sum(p[np.ix_(ys, xs)] * w, dtype=np.longdouble)
            mean = (rest + cand * np.longdouble(w[k])) / np.longdouble(area)
            off = np.abs(mean - np.floor(mean) - 0.5)
            p[y, xx] = int(cand[np.argmin(off)])
    return x.astype(np_dtype)


@pytest.mark.parametrize("dtype", ["u8", "u16", "i16"])
@pytest.mark.parametrize("geometry", list(TIE_GEOMETRIES))
def test_general_area_ties_match_ref(geometry, dtype, meshes):
    """On planes built to tie, the general area downscale equals ref/ at 0,
    unsharded and row-sharded."""
    shape, dsize, sizes = TIE_GEOMETRIES[geometry]
    x = _tie_planes(dtype, shape, dsize, 2500 + len(dtype) + shape[0])
    assert _tie_count(x, dsize) >= x.shape[0] * dsize[0] * dsize[1] // 4
    got = OP_REGISTRY["resize"](torch.from_numpy(x), dsize, "area").numpy()
    _assert_area_matches_ref(x, got, dsize)
    for n in sizes:
        run = tmesh.run_sharded(lambda p: tsp.resize_spatial(p, dsize, "area"), meshes[n],
                                [(None, "y")], (None, "y"))
        np.testing.assert_array_equal(run(torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("oh, ow", [(24, 33), (16, 32), (9, 17)])
def test_warp_matrix_rows_are_the_whole_calls_rows(perspective, nearest, oh, ow):
    """The plain version at row0 equals the rows of the row0 = 0 call (ow % 16
    of 1, 0 and 1: the field's tail law too)."""
    x = torch.from_numpy(PLANES["u8"])
    Mi = (invert_perspective(np.array([[0.9, -0.2, 4.0], [0.15, 1.1, -2.0], [3e-3, -2e-3, 1.0]]))
          if perspective else invert_affine(ROT))
    whole = kw.warp_matrix_u8_plain(x, Mi, oh, ow, perspective, nearest, "constant", 9)
    for row0, rows in ((0, oh), (1, oh - 1), (oh // 3, oh // 3), (oh - 1, 1)):
        got = kw.warp_matrix_u8_plain(x, Mi, rows, ow, perspective, nearest, "constant", 9, row0)
        torch.testing.assert_close(got, whole[:, row0:row0 + rows], rtol=0, atol=0)
        assert torch.equal(kw.warp_matrix_u8(x, Mi, rows, ow, perspective, nearest, "constant",
                                             9, row0), got)


_PERSPECTIVE = invert_perspective(np.array([[0.9, -0.2, 4.0], [0.15, 1.1, -2.0],
                                            [3e-3, -2e-3, 1.0]]))
COORD_LAWS = {  # name -> f(Mi, oh, ow, row0): rows [row0, row0 + oh) of a taller output
    "warp_affine_coords_int": lambda Mi, oh, ow, r: warp_coords.warp_affine_coords_int(
        Mi, oh, ow, r),
    "warp_affine_nn_coords_int": lambda Mi, oh, ow, r: warp_coords.warp_affine_nn_coords_int(
        Mi, oh, ow, r),
    "warp_affine_coords_cubic_f32": lambda Mi, oh, ow, r:
        warp_coords.warp_affine_coords_cubic_f32(Mi, oh, ow, r),
    "affine_field": lambda Mi, oh, ow, r: [t.numpy() for t in kw.affine_field(
        Mi, oh, ow, "cpu", r)],
    "perspective_field": lambda Mi, oh, ow, r: [t.numpy() for t in kw.perspective_field(
        _PERSPECTIVE, oh, ow, "cpu", r)],
}


@pytest.mark.parametrize("law", list(COORD_LAWS))
def test_coordinate_rows_are_the_whole_tables_rows(law):
    """Each coordinate law at a first row equals those rows of the whole
    table, bit for bit (ow = 33: the hybrid field's tail law too)."""
    Mi, oh, ow = invert_affine(ROT), 37, 33
    whole = COORD_LAWS[law](Mi, oh, ow, 0)
    for row0, rows in ((0, oh), (5, 12), (36, 1), (18, 19)):
        for got, want in zip(COORD_LAWS[law](Mi, rows, ow, row0), whole):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want[row0:row0 + rows])


def test_shards_pass_their_first_row_to_the_kernel(monkeypatch, meshes):
    """On a CUDA tensor (on_cuda and launch stubbed) each shard of a u8
    linear warpAffine launches warp_gather_u8 once, on the matrix route, for
    its oh/n rows from frame row idx·oh/n."""
    launches = []
    monkeypatch.setattr(kw, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kw, "launch", lambda *args: launches.append(args))
    x = torch.from_numpy(PLANES["u8"])
    tsp.shard_spatial(lambda p: tsp.warp_affine_spatial(p, ROT, (64, 52)), meshes[8])(x)
    assert len(launches) == 8
    for idx, (name, _, *args) in enumerate(launches):  # the shards take turns in rank order
        assert name == "warp_gather_u8" and args[1] is None and args[2] is None
        assert tuple(args[4:10]) == (2, 64, 48, 8, 52, 8 * idx)  # B, H, W, oh, ow, row0
        assert args[13] == 1  # the affine route


def test_run_sharded_with_several_inputs(meshes):
    """A list of specs: one input each, split as ``shard_map``'s in_specs;
    ShardedTensors in give a ShardedTensor out; a tuple stays one spec."""
    a = torch.arange(2 * 16 * 3, dtype=torch.int32).reshape(2, 16, 3)
    b = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3) * 100
    c = torch.tensor([7], dtype=torch.int32)

    def fn(x, y, z):
        return x + y[None] + z + tmesh.axis_index("y")

    run = tmesh.run_sharded(fn, meshes[8], [(None, "y"), ("y",), None], (None, "y"))
    want = a + b[None] + 7 + torch.arange(8, dtype=torch.int32).repeat_interleave(2)[None, :, None]
    assert torch.equal(run(a, b, c), want)
    assert torch.equal(run(a.numpy(), b.numpy(), c.numpy()), want)
    sharded = [tmesh.device_put(t, meshes[8], s) for t, s in
               ((a, (None, "y")), (b, ("y",)), (c, None))]
    got = run(*sharded)
    assert isinstance(got, tmesh.ShardedTensor) and torch.equal(got.gather(), want)
    assert torch.equal(run(sharded[0], b, c), want)  # mixed: a plain result
    with pytest.raises(TypeError, match="takes 3 inputs, got 2"):
        run(a, b)
    with pytest.raises(ValueError, match="split as"):
        run(sharded[1], b, c)
    one = tmesh.run_sharded(lambda x: x * 2, meshes[2], (None, "y"), (None, "y"))
    assert torch.equal(one(a), a * 2)


def test_remap_stage_takes_whole_maps(meshes):
    """R12: the registry's remap stage equals the unsharded remap on every
    mesh; JAX's stage reads the whole maps as each shard's block and renders
    8·oh rows."""
    x = PLANES["u8"][:1, :16, :20]
    mx = (np.random.default_rng(2430).random((16, 20)) * 22 - 1).astype(np.float32)
    my = (np.random.default_rng(2431).random((16, 20)) * 18 - 1).astype(np.float32)
    want = twarp.remap_planes(torch.from_numpy(x), mx, my).numpy()
    for n, mesh in meshes.items():
        for maps in ((mx, my), (torch.from_numpy(mx), torch.from_numpy(my))):
            stage = [("remap", {"map_x": maps[0], "map_y": maps[1]})]
            got = tsp.make_spatial_pipeline(stage, mesh)(torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, want)
            got = make_pipeline(stage, channels_last=False, mesh=mesh, shard="spatial")(
                torch.from_numpy(x)).numpy()
            np.testing.assert_array_equal(got, want)
    jax_pipe = jsp.make_spatial_pipeline([("remap", {"map_x": mx, "map_y": my})],
                                         jax_make_mesh(8, axis_name="y"))
    assert np.asarray(jax_pipe(jsp.device_put_spatial(
        x, jax_make_mesh(8, axis_name="y")))).shape == (1, 8 * 16, 20)


def test_geometry_stages_in_a_chain(meshes):
    """Geometry stages change the block's height and width inside a chain:
    median → resize → Canny through make_pipeline(mesh=, shard="spatial"),
    an HWC frame, against the unsharded pipeline."""
    stages = [("median_blur", {"ksize": 3}), ("resize", {"dsize": (48, 40),
                                                       "interpolation": "area"}),
              ("canny", {"threshold1": 30.0, "threshold2": 90.0}),
              ("warp_affine", {"M": ROT, "dsize": (32, 44), "interpolation": "nearest"})]
    frame = torch.from_numpy(np.ascontiguousarray(np.moveaxis(EDGES, 0, -1)))  # (64, 48, 2)
    want = make_pipeline(stages)(frame)
    for n in (2, 8):
        got = make_pipeline(stages, mesh=meshes[n], shard="spatial")(frame)
        assert got.shape == (32, 44, 2)
        assert torch.equal(got, want)


def test_geometry_errors(meshes):
    x = torch.from_numpy(PLANES["u8"][:1, :16])  # 2 rows a shard on 8
    run8 = lambda fn: tsp.shard_spatial(fn, meshes[8])(x)  # noqa: E731
    with pytest.raises(ValueError, match="output height 42 divisible by the 8-shard"):
        run8(lambda p: tsp.resize_spatial(p, (42, 20)))
    with pytest.raises(ValueError, match="output height 12 divisible by the 8-shard"):
        run8(lambda p: tsp.warp_affine_spatial(p, ROT, (12, 20)))
    with pytest.raises(ValueError, match="output height 20 must divide the 8-shard"):
        run8(lambda p: tsp.warp_polar_spatial(p, (16, 20), (8.0, 8.0), 6.0))
    with pytest.raises(ValueError, match="maps' 12 rows divisible by the 8-shard"):
        tsp.make_spatial_pipeline([("remap", {"map_x": MAP_X[:12], "map_y": MAP_Y[:12]})],
                                  meshes[8])(x)
    # a halo higher than the shard: Lanczos-4 halving 16 rows reads 3 rows
    # past a 2-row shard, Canny's aperture 7 three
    with pytest.raises(ValueError, match="shard height 2 too small for halo radius 3"):
        run8(lambda p: tsp.resize_spatial(p, (8, 32), "lanczos4"))
    with pytest.raises(ValueError, match="shard height 2 too small for halo radius 3"):
        run8(lambda p: tsp.canny_spatial(p, 40.0, 120.0, 7))
    with pytest.raises(TypeError, match="requires uint8"):
        tsp.shard_spatial(lambda p: tsp.canny_spatial(p, 40.0, 120.0), meshes[2])(
            x.to(torch.int16))
    with pytest.raises(TypeError, match="uint8/uint16/int16/float32"):
        run8(lambda p: tsp.resize_spatial(p.to(torch.int32), (8, 16)))
    with pytest.raises(ValueError, match="unknown interpolation"):
        run8(lambda p: tsp.resize_spatial(p, (8, 16), "bilinear"))
    with pytest.raises(ValueError, match="unknown border"):
        run8(lambda p: tsp.warp_affine_spatial(p, ROT, (8, 16), "linear", "wrap"))
    with pytest.raises(ValueError, match="aperture_size must be 3, 5 or 7"):
        run8(lambda p: tsp.canny_spatial(p, 40.0, 120.0, 4))


def test_shard_tables_cache_keys_each_shard():
    """Four shards on one device get four cache entries, apart from the
    unsharded tables, and each shard's rebased tables index its halo block."""
    from imageenhancement_mp_tpu_torch.ops import resize as tr

    dev = torch.device("cpu")
    tabs = [tr.shard_row_tables("cubic", 64, 56, 4, i, 3, dev) for i in range(4)]
    assert len({id(t) for t in tabs}) == 4
    assert all(t is tr.shard_row_tables("cubic", 64, 56, 4, i, 3, dev) for i, t in enumerate(tabs))
    whole = tr._tables("cubic", 64, 56, dev)
    for i, (yi, yc, yf) in enumerate(tabs):
        assert yi.shape == (4, 14) and int(yi.min()) >= 0 and int(yi.max()) < 16 + 2 * 3
        assert torch.equal(yi + (16 * i - 3), whole[0][:, 14 * i:14 * (i + 1)])
        assert torch.equal(yc, whole[1][:, 14 * i:14 * (i + 1)])


def test_area_band_matches_the_oracle_weights():
    """The general area downscale's band tables hold ref/'s overlap weights
    in its order, padded with the band's last line at weight 0."""
    from imageenhancement_mp_tpu_torch.ops import resize as tr

    for n, on in ((64, 24), (36, 20), (4320, 1728), (7, 3)):
        idx, w = tr._area_band(n, on)
        scale = n / on
        for d in range(on):
            y0, y1 = d * scale, min((d + 1) * scale, n)
            ys = np.arange(int(np.floor(y0)), min(int(np.ceil(y1)), n))
            wy = np.minimum(ys + 1, y1) - np.maximum(ys, y0)
            k = len(ys)
            np.testing.assert_array_equal(idx[:k, d], ys)
            np.testing.assert_array_equal(w[:k, d], wy)
            assert (idx[k:, d] == ys[-1]).all() and (w[k:, d] == 0).all()
    for dtype in ("u8", "u16", "i16"):
        x = PLANES[dtype]
        got = OP_REGISTRY["resize"](torch.from_numpy(x), (24, 20), "area").numpy()
        _assert_area_matches_ref(x, got, (24, 20))
