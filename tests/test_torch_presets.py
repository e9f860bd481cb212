"""Config 5 through the port's presets, make_pipeline and stream_frames, held
to the ref/ chain at 0 LSB and to the JAX ``get_preset`` within its own
budget of ±2 (tests/test_configs_full.py:61: CLAHE's ±1 on XLA:CPU, ROADMAP
R4, can move the unsharp pass by one more); and the rules: CPU tensors never
reach the kernel build, what the port does not take raises."""

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.models.presets import get_preset as jax_get_preset
from imageenhancement_mp_tpu_torch.kernels import _build, launch_counts, reset_launch_counts
from imageenhancement_mp_tpu_torch.models.presets import PRESETS
from imageenhancement_mp_tpu_torch.ops import OP_REGISTRY

KERNELS = {"hist256", "equalize_lut256", "apply_lut256", "sep_conv_u8",
           "median", "hist256_tiles", "clahe_lut", "clahe_blend", "bilateral", "athresh",
           "warp_gather_u8", "take_table", "apply_lut256_wide", "apply_luts_multi",
           "median_unsharp", "hist65536_tiles", "hist256_lut", "tile_luts256",
           "tile_luts65536"}


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _ref_config5(p):
    return ref.unsharp_mask(ref.clahe(ref.median_blur(p, 5), 2.0, (8, 8)), 1.0, 5, 0.0)


def _maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 37, 131, 3)])
def test_config5_preset_matches_ref_and_jax(shape):
    """0 LSB against the ref/ chain per plane; ±2 against JAX's preset."""
    x = _img(shape, 61)
    got = tie.get_preset("denoise_clahe_sharpen")(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.uint8
    planes = x if len(shape) == 3 else np.moveaxis(x, -1, 1).reshape(-1, *shape[1:3])
    got_planes = got if len(shape) == 3 else np.moveaxis(got, -1, 1).reshape(-1, *shape[1:3])
    np.testing.assert_array_equal(got_planes, np.stack([_ref_config5(p) for p in planes]))
    assert _maxdiff(got, jax_get_preset("denoise_clahe_sharpen")(x)) <= 2


@pytest.mark.parametrize("name", ["histeq", "sharpen", "clahe", "denoise_sharpen", "histeq_unsharp",
                                  "gamma_stretch"])
def test_other_ported_presets_match_jax(name):
    """The other presets: within ±1 (R4) of JAX where CLAHE is a stage, 0 LSB
    elsewhere."""
    x = _img((2, 32, 96), 62)
    got = tie.get_preset(name)(torch.from_numpy(x)).numpy()
    budget = 1 if name == "clahe" else 0
    assert _maxdiff(got, jax_get_preset(name)(x)) <= budget


def test_make_pipeline_runs_stages_in_order():
    """A hand-built chain equals the ops called one after another."""
    x = torch.from_numpy(_img((2, 40, 72), 63))
    pipe = tie.make_pipeline(["median_blur", ("clahe", {"clip_limit": 3.0, "tile_grid": (2, 3)}),
                              ("gaussian_blur", {"ksize": 3})])
    want = tie.gaussian_blur(tie.clahe(tie.median_blur(x), 3.0, (2, 3)), 3)
    np.testing.assert_array_equal(pipe(x).numpy(), want.numpy())
    u16 = torch.from_numpy(np.random.default_rng(63).integers(0, 65536, (1, 40, 72)).astype(np.uint16))
    pipe16 = tie.make_pipeline([("median_blur", {"ksize": 5}), "clahe"])
    np.testing.assert_array_equal(pipe16(u16).numpy(), tie.clahe(tie.median_blur(u16, 5)).numpy())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stream_frames_on_cpu_equals_direct_calls(depth):
    """In order, one output per input, each equal to the direct call."""
    pipe = tie.get_preset("denoise_clahe_sharpen")
    frames = [_img((2, 24, 40), 64 + i) for i in range(4)] + [torch.from_numpy(_img((24, 40), 70))]
    outs = list(tie.stream_frames(pipe, frames, depth, device="cpu"))
    assert len(outs) == len(frames)
    for out, f in zip(outs, frames):
        want = pipe(f if isinstance(f, torch.Tensor) else torch.from_numpy(f))
        assert out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_registry_names_and_errors():
    """Every name of the JAX registry is ported (40); an unknown one raises
    KeyError."""
    from imageenhancement_mp_tpu.ops import OP_REGISTRY as JAX_REGISTRY
    assert set(OP_REGISTRY) == set(JAX_REGISTRY) and len(OP_REGISTRY) == 40
    assert all(callable(fn) for fn in OP_REGISTRY.values())
    with pytest.raises(KeyError):
        OP_REGISTRY["no_such_op"]


def test_what_the_port_does_not_take_raises():
    with pytest.raises(TypeError, match="backend"):
        tie.make_pipeline([("median_blur", {"ksize": 5, "backend": "xla"})])
    assert callable(tie.make_pipeline(["gamma", "erode"]))  # every registry name builds
    with pytest.raises(KeyError):
        tie.get_preset("no_such_preset")
    with pytest.raises(KeyError):
        tie.make_pipeline(["no_such_op"])
    with pytest.raises(TypeError, match="Mesh"):
        tie.get_preset("denoise_clahe_sharpen", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tie.make_pipeline(["clahe"], mesh=object())
    pipe = tie.get_preset("clahe")
    with pytest.raises(TypeError):
        pipe(torch.zeros((8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        list(tie.stream_frames(pipe, [np.zeros((8, 8), np.uint8)], 0, device="cpu"))
    with pytest.raises(ValueError):
        list(tie.stream_frames(pipe, [np.zeros((8, 8), np.uint8)], device="meta"))
    with pytest.raises(TypeError):
        list(tie.stream_frames(pipe, [[1, 2]], device="cpu"))
    assert set(PRESETS) == {"histeq", "gamma_stretch", "sharpen", "clahe",
                            "denoise_clahe_sharpen", "denoise_sharpen", "histeq_unsharp"}


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    """Every config 5 and config 2 entry point on CPU tensors: all launch
    counters stay at 0 and the build is never called."""
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    reset_launch_counts()
    x = _img((2, 24, 40), 71)
    tie.get_preset("denoise_clahe_sharpen")(torch.from_numpy(x))
    list(tie.stream_frames(tie.get_preset("denoise_clahe_sharpen"), [x, x], device="cpu"))
    tie.clahe(torch.from_numpy(x.astype(np.uint16) * 257))
    tie.median_blur(torch.from_numpy(x.astype(np.int16)), 5)
    tie.get_preset("gamma_stretch")(torch.from_numpy(x))
    tie.equalize_hist(torch.from_numpy(x), per_frame=False)
    assert set(launch_counts) == KERNELS
    assert launch_counts == dict.fromkeys(KERNELS, 0)
