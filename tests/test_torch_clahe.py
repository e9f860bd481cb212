"""The port's CLAHE (kernels/clahe.py plain stages, ops/clahe.py, the api)
held to ref/ at 0 LSB and to the JAX package: stage A and stage B at 0 LSB,
stage C and the whole op within ±1 of JAX on the CPU, the budget of ROADMAP
R4 (XLA:CPU contracts the blend's f32 multiply-adds into FMAs, ops/clahe.py
:139-144; the port rounds each operation once, as ref/ and cv2 do)."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import config, ref
from imageenhancement_mp_tpu.kernels.clahe_u16 import clahe_blend_quad_pallas, uniform_quadrant_split
from imageenhancement_mp_tpu.kernels.hist import hist256_pallas
from imageenhancement_mp_tpu.ops import clahe as jclahe
from imageenhancement_mp_tpu_torch import interop
from imageenhancement_mp_tpu_torch.kernels import clahe as kclahe
from imageenhancement_mp_tpu_torch.ops import clahe as tclahe

# (shape, grid): most from tests/test_clahe_u16.py:61-82, two non-divisible,
# and the R2 geometry (tile 82, grid (2, 2)) where the JAX quad kernel is wrong
GEOMETRIES = [
    ((2, 64, 256), (8, 2)),
    ((1, 30, 256), (2, 2)),
    ((1, 64, 384), (4, 3)),
    ((1, 37, 131), (8, 8)),
    ((1, 20, 250), (2, 2)),
    ((1, 164, 164), (2, 2)),
]
DIVISIBLE_U8 = GEOMETRIES[:3]
R2 = ((1, 164, 164), (2, 2))
HI = {np.uint8: 256, np.uint16: 65536}


def _img(shape, dtype, seed):
    return np.random.default_rng(seed).integers(0, HI[dtype], shape).astype(dtype)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _ref(x, clip, grid):
    return np.stack([ref.clahe(p, clip, grid) for p in x])


def _jax_tile_luts(x, clip, grid):
    """JAX's stage A (XLA route) and stage B over the padded planes →
    ``[B·gh·gw, S]`` LUTs and the geometry."""
    B, H, W = x.shape
    gh, gw, th, tw = tclahe.tile_geometry(H, W, grid)
    S = HI[x.dtype.type]
    padded = np.pad(x, ((0, 0), (0, gh * th - H), (0, gw * tw - W)), mode="reflect")
    hists = np.concatenate([np.asarray(jclahe._tile_hists(p, gh, gw, th, tw, S)) for p in padded])
    return np.asarray(jclahe.clahe_tile_luts(hists, th * tw, clip, S)), (gh, gw, th, tw)


@pytest.mark.parametrize("n,tile,ntiles", [(64, 8, 8), (37, 5, 8), (2160, 270, 8), (3840, 480, 8),
                                           (164, 82, 2), (250, 126, 2), (1, 1, 8)])
def test_interp_coords_equal_jax(n, tile, ntiles):
    """Bit for bit: the same host NumPy f32 evaluation."""
    for got, want in zip(tclahe._interp_coords(n, tile, ntiles),
                         jclahe._interp_coords(n, tile, ntiles)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clip", [0.0, 2.0, 40.0])
@pytest.mark.parametrize("S", [256, 65536])
def test_stage_b_matches_jax_clahe_tile_luts(S, clip):
    """0 LSB on random histograms: integer clip and redistribution, then
    one f32 product and a half-even round in both."""
    rng = np.random.default_rng(51)
    area = 37 * 131 if S == 256 else 270 * 48
    peaked = rng.dirichlet(np.full(S, 0.05 if S == 256 else 0.01), size=6)
    hists = np.stack([rng.multinomial(area, p) for p in peaked]).astype(np.int32)
    hists[0] = 0
    hists[0, 7] = area  # a constant tile
    got = kclahe.clahe_lut(torch.from_numpy(hists), area, clip)
    want = np.asarray(jclahe.clahe_tile_luts(hists, area, clip, S))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tclahe.clahe_tile_luts(torch.from_numpy(hists), area, clip).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape,grid", GEOMETRIES)
def test_stage_a_matches_per_tile_bincount(shape, grid, dtype):
    """0 LSB: the reflected pad is read by index, never copied."""
    x = _img(shape, dtype, 52)
    B, H, W = shape
    gh, gw, th, tw = tclahe.tile_geometry(H, W, grid)
    S = HI[dtype]
    padded = np.pad(x, ((0, 0), (0, gh * th - H), (0, gw * tw - W)), mode="reflect")
    want = np.stack([np.bincount(p[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].ravel(),
                                 minlength=S)
                     for p in padded for ty in range(gh) for tx in range(gw)])
    t = torch.from_numpy(x)
    got = kclahe.hist256_tiles(t, gh, gw, th, tw) if dtype == np.uint8 else \
        kclahe.tile_hists_plain(t, gh, gw, th, tw)
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.uint8 and (H, W) == (gh * th, gw * tw):
        tiles = x.reshape(B, gh, th, gw, tw).transpose(0, 1, 3, 2, 4).reshape(B * gh * gw, th * tw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(hist256_pallas(tiles, interpret=True)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape,grid", GEOMETRIES)
def test_stage_c_on_jax_luts_matches_ref(shape, grid, dtype):
    """Stage C fed JAX's stage-B LUTs through ``clahe_luts_from_jax``: 0 LSB
    against ref/; within ±1 (R4) of the JAX quad kernel in interpret mode
    where its guard admits the geometry (u8 only: the u16 chain is slow in
    interpret mode), except the R2 case, where that kernel is wrong."""
    x = _img(shape, dtype, 53)
    clip = 2.0
    luts, (gh, gw, th, tw) = _jax_tile_luts(x, clip, grid)
    tl = interop.clahe_luts_from_jax(luts, shape[0], gh, gw)
    got = tclahe.blend_tile_luts(torch.from_numpy(x), tl, gh, gw, th, tw).numpy()
    np.testing.assert_array_equal(got, _ref(x, clip, grid))
    H, W = shape[1:]
    y0, _, fy = jclahe._interp_coords(H, th, gh)
    x0, _, fx = jclahe._interp_coords(W, tw, gw)
    quad = ((H, W) == (gh * th, gw * tw) and uniform_quadrant_split(y0, gh, th)
            and uniform_quadrant_split(x0, gw, tw))
    if dtype == np.uint8 and quad and (shape, grid) != R2:
        jq = np.asarray(clahe_blend_quad_pallas(x, luts, gh, gw, fy, fx, interpret=True))
        assert _maxdiff(got, jq) <= 1


@pytest.mark.parametrize("clip", [2.0, 40.0])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape,grid", GEOMETRIES)
def test_clahe_planes_matches_ref_and_jax(shape, grid, dtype, clip):
    """The whole op: 0 LSB against ref/ (R2 geometry included), within ±1
    (R4) of the JAX package's XLA route."""
    x = _img(shape, dtype, 54)
    got = tclahe.clahe_planes(torch.from_numpy(x), clip, grid).numpy()
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, _ref(x, clip, grid))
    assert _maxdiff(got, jclahe.clahe_planes(x, clip, grid)) <= 1


@pytest.mark.parametrize("shape,grid", DIVISIBLE_U8)
def test_clahe_matches_jax_pallas_route(shape, grid):
    """Divisible u8 shapes through JAX's Pallas route (K1 → stage B → K7 or
    K8, interpret mode): within ±1 (R4)."""
    x = _img(shape, np.uint8, 55)
    got = tclahe.clahe_planes(torch.from_numpy(x), 2.0, grid).numpy()
    config.use_pallas_kernels = True
    try:
        want = np.asarray(jclahe.clahe_planes(x, 2.0, grid))
    finally:
        config.use_pallas_kernels = None
    assert _maxdiff(got, want) <= 1


def test_r2_does_not_carry_over():
    """ROADMAP R2: on a 164×164 plane with a (2, 2) grid the JAX quad kernel
    passes its guard and is wrong by more than ±1; the port has one route
    for every geometry and equals ref/ at 0 LSB."""
    (shape, grid) = R2
    x = _img(shape, np.uint8, 56)
    want = _ref(x, 2.0, grid)
    np.testing.assert_array_equal(tclahe.clahe_planes(torch.from_numpy(x), 2.0, grid).numpy(), want)
    config.use_pallas_kernels = True
    try:
        jax_quad = np.asarray(jclahe.clahe_planes(x, 2.0, grid))
    finally:
        config.use_pallas_kernels = None
    assert _maxdiff(jax_quad, want) > 1


@pytest.mark.parametrize("shape", [(37, 131, 3), (2, 64, 256), (1, 16, 40, 3)])
def test_api_clahe_matches_jax_api_and_ref(shape):
    """Per layout: 0 LSB against ref/ per plane, within ±1 (R4) of
    ``imageenhancement_mp_tpu.clahe``."""
    x = _img(shape, np.uint8, 57)
    got = tie.clahe(torch.from_numpy(x), 2.0, (4, 4)).numpy()
    assert _maxdiff(got, jie.clahe(x, 2.0, (4, 4))) <= 1
    if len(shape) == 3 and shape[-1] == 3:
        for c in range(3):
            np.testing.assert_array_equal(got[..., c], ref.clahe(x[..., c], 2.0, (4, 4)))


def test_tiny_planes_match_ref():
    """Planes smaller than the grid: the pad reflects again (numpy's rule)."""
    for shape, grid in [((1, 1, 1), (8, 8)), ((1, 2, 3), (2, 2)), ((2, 3, 2), (4, 4))]:
        for dtype in (np.uint8, np.uint16):
            x = _img(shape, dtype, 58)
            got = tclahe.clahe_planes(torch.from_numpy(x), 40.0, grid).numpy()
            np.testing.assert_array_equal(got, _ref(x, 40.0, grid), err_msg=f"{shape} {grid}")


def test_clahe_rejects_what_it_does_not_take():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tclahe.clahe_planes(x.to(torch.int16))
    with pytest.raises(ValueError):
        tclahe.clahe_planes(x, 2.0, (0, 2))
    with pytest.raises(TypeError):
        kclahe.hist256_tiles(x.to(torch.uint16), 2, 2, 4, 4)
    with pytest.raises(ValueError):
        kclahe.hist256_tiles(x, 2, 2, 3, 4)  # tiles do not cover the plane
    with pytest.raises(TypeError):
        kclahe.clahe_lut(torch.zeros((2, 128), dtype=torch.int32), 16, 2.0)
    with pytest.raises(ValueError):
        kclahe.clahe_lut(torch.zeros((2, 256), dtype=torch.int32), 0, 2.0)
    luts = torch.zeros((4, 256), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tclahe.blend_tile_luts(x, luts[:3], 2, 2, 4, 4)
    with pytest.raises(ValueError):
        interop.clahe_luts_from_jax(np.zeros((4, 256), np.uint16), 1, 2, 2)
    with pytest.raises(ValueError):
        tclahe.clahe_planes(x.to("meta"))
