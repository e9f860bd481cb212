"""The warp kernel's matrix routes (``kernels/warp.py::warp_matrix_u8``):
the coordinates that ``csrc/warp.cu`` computes per pixel from the affine or
perspective matrix, and the dispatch of ``warp_affine`` / ``warp_perspective``.

* A NumPy mirror of the kernel's per-pixel arithmetic, in its order of
  operations (per row ``f32(b·y)`` and ``f32(b·y + c)``; per pixel the f64
  product ``a·x``, one f64 add, one cast to f32; the tail's f32 add of ``c``;
  the IEEE f32 division of perspective, 0 where the denominator is 0; the
  clip to ±2e9), equals ``ref/ops.py::warp_affine_coords_f32`` /
  ``warp_perspective_coords_f32`` and the port's ``affine_field`` /
  ``perspective_field`` bit for bit: ``ow % 16`` in {0, 1, 7, 15} (the tail
  law runs), corners past ±2e9, a perspective row whose denominator is 0,
  random matrices.
* On a CUDA u8 tensor (``on_cuda`` and ``launch`` stubbed), ``warp_affine``
  and ``warp_perspective`` with linear or nearest make exactly one
  ``warp_gather_u8`` launch with the f32 matrix and no maps, and build no
  field; on the CPU they equal the JAX package's XLA route (and ``ref/``,
  which keeps no ±2e9 clip, on matrices that stay inside it).
"""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu as jie
import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu.ref import ops as ref
from imageenhancement_mp_tpu_torch.kernels import warp as kw
from imageenhancement_mp_tpu_torch.ops import warp as tw
from torch_warp_cases import HOMOGRAPHY, ROT31, img

LIMIT = np.float32(2e9)
SIZES = [(5, 16), (7, 17), (9, 23), (6, 31), (4, 48), (3, 1)]  # ow % 16: 0, 1, 7, 15, 0, 1


def _form_mirror(a, b, c, oh: int, ow: int) -> np.ndarray:
    """One linear form as the kernel computes it, pixel by pixel."""
    a, b, c = np.float32(a), np.float32(b), np.float32(c)
    nb = ow - ow % 16
    out = np.empty((oh, ow), np.float32)
    for y in range(oh):
        by = np.float32(b * np.float32(y))      # __fmul_rn(b, y)
        crow = np.float32(by + c)               # __fadd_rn(by, c)
        for x in range(ow):
            ax = np.float64(a) * np.float64(x)  # __dmul_rn (exact here)
            if x < nb:                          # body
                out[y, x] = np.float32(ax + np.float64(crow))
            else:                               # tail
                out[y, x] = np.float32(np.float32(ax + np.float64(by)) + c)
    return out


def coords_mirror(Mi, oh: int, ow: int, perspective: bool):
    """The kernel's (sx, sy) of the inverse matrix ``Mi``, clipped."""
    Mf = np.asarray(Mi, np.float64).reshape((3, 3) if perspective else (2, 3)).astype(np.float32)
    nx, ny = (_form_mirror(*Mf[r], oh, ow) for r in (0, 1))
    if perspective:
        den = _form_mirror(*Mf[2], oh, ow)
        with np.errstate(divide="ignore", invalid="ignore"):
            nx = np.where(den != 0, nx / den, np.float32(0)).astype(np.float32)
            ny = np.where(den != 0, ny / den, np.float32(0)).astype(np.float32)
    return tuple(np.clip(s, -LIMIT, LIMIT) for s in (nx, ny))


def _rng_matrix(seed: int, perspective: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    M = np.eye(3)
    M[:2, :2] += rng.normal(0, 0.4, (2, 2))
    M[:2, 2] = rng.normal(0, 30, 2)
    if perspective:
        M[2, :2] = rng.normal(0, 2e-3, 2)
    return M if perspective else M[:2]


AFFINE = {
    "rot31": ref.invert_affine(ROT31),
    "rot15": ref.invert_affine(ref.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0)),
    "far corners": np.array([[3e6, 1e5, -1e9], [-2e5, 4e6, 7e8]]),
    "past the clip": np.array([[2.5e8, -3e8, 1.9e9], [1e9, 2e9, -2.1e9]]),
    "fractional": np.array([[0.3333333, 0.1, 0.7], [-0.123, 0.987654, -3.5]]),
    **{f"random {s}": _rng_matrix(s, False) for s in range(4)},
}
PERSPECTIVE = {
    "homography": ref.invert_perspective(HOMOGRAPHY),
    "zero denominator row": np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0], [0.0, 1.0, -3.0]]),
    "zero denominator column": np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0], [1.0, 0.0, -5.0]]),
    "far": np.array([[3e6, 1e5, -1e9], [-2e5, 4e6, 7e8], [1e-3, -2e-3, 0.5]]),
    "strong": ref.invert_perspective(np.array([[0.9, -0.2, 4.0], [0.15, 1.1, -2.0],
                                               [3e-3, -2e-3, 1.0]])),
    **{f"random {s}": _rng_matrix(s, True) for s in range(4)},
}


@pytest.mark.parametrize("oh,ow", SIZES)
@pytest.mark.parametrize("name", list(AFFINE))
def test_affine_mirror_equals_ref_and_field(name, oh, ow):
    Mi = AFFINE[name]
    got = coords_mirror(Mi, oh, ow, False)
    want = ref.warp_affine_coords_f32(Mi, oh, ow)
    field = kw.affine_field(Mi, oh, ow, "cpu")
    for g, w, f in zip(got, want, field):
        np.testing.assert_array_equal(g, np.clip(w, -LIMIT, LIMIT))
        np.testing.assert_array_equal(g, np.clip(f.numpy(), -LIMIT, LIMIT))


@pytest.mark.parametrize("oh,ow", SIZES)
@pytest.mark.parametrize("name", list(PERSPECTIVE))
def test_perspective_mirror_equals_ref_and_field(name, oh, ow):
    Mi = PERSPECTIVE[name]
    got = coords_mirror(Mi, oh, ow, True)
    want = ref.warp_perspective_coords_f32(Mi, oh, ow)
    field = kw.perspective_field(Mi, oh, ow, "cpu")
    for g, w, f in zip(got, want, field):
        np.testing.assert_array_equal(g, np.clip(w, -LIMIT, LIMIT))
        np.testing.assert_array_equal(g, f.numpy())


def test_cases_reach_the_adversarial_branches():
    """The matrices above do reach the clip, a zero denominator and the tail."""
    sx, sy = coords_mirror(AFFINE["past the clip"], 9, 23, False)
    assert (np.abs(sx) == LIMIT).any() and (np.abs(sy) == LIMIT).any()
    Mf = PERSPECTIVE["zero denominator row"].astype(np.float32)
    assert (_form_mirror(*Mf[2], 6, 31) == 0).any()
    Mf = PERSPECTIVE["zero denominator column"].astype(np.float32)
    assert (_form_mirror(*Mf[2], 6, 31) == 0).any()


def test_floor_and_rint_through_the_magic_add():
    """The kernel's floor (round-down add of 1.5·2^23) and rint (round-to-
    nearest add) of coordinates below 2^22: the sum lies in [2^23, 2^24), where
    the f32 ulp is 1, so its bits minus 0x4B400000 are the integer."""
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.uniform(-4e6, 4e6, 20000), rng.integers(-4e6, 4e6, 2000) + 0.5,
                        [-0.5, 0.5, 1.5, -1.5, 2.5, -4194303.5, 4194303.5, -0.0, 0.0]])
    X = X.astype(np.float32)
    X = X[np.abs(X) < 2**22]
    magic = np.float64(12582912.0)
    down = np.floor(X.astype(np.float64) + magic)           # exact: round down to the ulp of 1
    near = np.rint(X.astype(np.float64) + magic)            # exact in f64, half to even
    to_bits = lambda v: v.astype(np.float32).view(np.int32) - 0x4B400000  # noqa: E731
    np.testing.assert_array_equal(to_bits(down), np.floor(X).astype(np.int64))
    np.testing.assert_array_equal(to_bits(near), np.rint(X).astype(np.int64))
    np.testing.assert_array_equal((down - magic).astype(np.float32), np.floor(X))


# -- dispatch on a CUDA tensor (the launch stubbed) -----------------------------

def _no_field(*args, **kwargs):
    raise AssertionError("a field was built on the matrix route")


MATRIX_CALLS = {  # name -> (call, source, nearest, replicate, border value)
    "affine linear": (lambda x: tie.warp_affine(x, ROT31, (9, 11)), 1, 0, 0, 0),
    "affine nearest replicate": (lambda x: tie.warp_affine(
        x, ROT31, (9, 11), "nearest", "replicate"), 1, 1, 1, 0),
    "perspective linear": (lambda x: tie.warp_perspective(x, HOMOGRAPHY, (9, 11)), 2, 0, 0, 0),
    "perspective nearest, border 300": (lambda x: tie.warp_perspective(
        x, HOMOGRAPHY, (9, 11), "nearest", "constant", 300.0), 2, 1, 0, 255),
}


@pytest.mark.parametrize("name", list(MATRIX_CALLS))
def test_matrix_route_launches_once_without_a_field(monkeypatch, name):
    call, source, nearest, replicate, bval = MATRIX_CALLS[name]
    launches = []
    monkeypatch.setattr(kw, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(kw, "launch", lambda *args: launches.append(args))
    for module in (kw, tw):
        monkeypatch.setattr(module, "affine_field", _no_field)
        monkeypatch.setattr(module, "perspective_field", _no_field)
    x = torch.from_numpy(img((3, 10, 12), np.uint8, 2))
    out = call(x)
    assert out.shape == (3, 9, 11) and out.dtype == torch.uint8
    assert len(launches) == 1
    kernel, device, *args = launches[0]
    assert kernel == "warp_gather_u8" and device == x.device
    assert args[1] is None and args[2] is None  # no maps
    assert tuple(args[4:10]) == (3, 10, 12, 9, 11, 0)  # B, H, W, oh, ow, row0
    assert tuple(args[10:14]) == (nearest, replicate, bval, source)
    M = np.asarray(ROT31 if source == 1 else HOMOGRAPHY, np.float64)
    Mi = ref.invert_affine(M) if source == 1 else ref.invert_perspective(M)
    want = list(np.asarray(Mi, np.float64).astype(np.float32).reshape(-1))
    want += [0.0] * (9 - len(want))
    assert args[14:] == [float(v) for v in want]


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("border,bv", [("constant", 9.0), ("replicate", 0.0)])
@pytest.mark.parametrize("name", ["far corners", "past the clip", "random 1"])
def test_cpu_affine_matches_jax_and_ref(name, border, bv, interp):
    x = img((2, 24, 40), np.uint8, 40)
    Mi = AFFINE[name]
    for oh, ow in ((21, 33), (17, 32)):
        got = tie.warp_affine(torch.from_numpy(x), Mi, (oh, ow), interp, border, bv,
                              inverse_map=True).numpy()
        want = np.asarray(jie.warp_affine(x, Mi, (oh, ow), interp, border, bv, inverse_map=True))
        np.testing.assert_array_equal(got, want)
        if name.startswith("random"):  # ref/ keeps no ±2e9 clip: far matrices go to JAX only
            np.testing.assert_array_equal(got, np.stack([
                    ref.warp_affine(p, Mi, (oh, ow), interp, border, bv, inverse_map=True)
                for p in x]))


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("border,bv", [("constant", 9.0), ("replicate", 0.0)])
@pytest.mark.parametrize("name", ["zero denominator column", "far", "random 2"])
def test_cpu_perspective_matches_jax_and_ref(name, border, bv, interp):
    x = img((2, 24, 40), np.uint8, 41)
    Mi = PERSPECTIVE[name]
    for oh, ow in ((21, 33), (17, 32)):
        got = tie.warp_perspective(torch.from_numpy(x), Mi, (oh, ow), interp, border, bv,
                                   inverse_map=True).numpy()
        want = np.asarray(jie.warp_perspective(x, Mi, (oh, ow), interp, border, bv,
                                               inverse_map=True))
        np.testing.assert_array_equal(got, want)
        if name.startswith("random"):  # ref/ keeps no ±2e9 clip: far matrices go to JAX only
            np.testing.assert_array_equal(got, np.stack([
                    ref.warp_perspective(p, Mi, (oh, ow), interp, border, bv, inverse_map=True)
                for p in x]))


def test_matrix_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4), dtype=torch.uint8)
    Mi = np.eye(3)[:2]
    with pytest.raises(TypeError):
        kw.warp_matrix_u8(x.to(torch.int16), Mi, 4, 4)
    with pytest.raises(ValueError):
        kw.warp_matrix_u8(x, Mi, 0, 4)
    with pytest.raises(ValueError):
        kw.warp_matrix_u8(x, Mi, 4, 4, border="reflect")
    with pytest.raises(ValueError):
        kw.warp_matrix_u8(x, Mi, 4, 4, border_value=256)
    np.testing.assert_array_equal(kw.warp_matrix_u8(x + 7, Mi, 3, 5, border="replicate").numpy(),
                                  np.full((1, 3, 5), 7, np.uint8))
