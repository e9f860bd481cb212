"""Batch sharding and the mesh front door (imageenhancement_mp_tpu_torch/
parallel/mesh.py, parallel/sharding.py, make_pipeline/get_preset/
stream_frames(mesh=)) on CPU meshes, held to the JAX package on its 8
virtual CPU devices and to the port's unsharded calls; and the host state
that shard threads share, under 8 threads at once.

Tolerances: 0 LSB against the port's unsharded call and against ref/;
against JAX 0 but where CLAHE is a stage: ±1 for CLAHE alone (ROADMAP R4),
±2 for config 5, whose unsharp pass can move CLAHE's ±1 by one more
(tests/test_configs_full.py:61, as tests/test_torch_presets.py holds the
unsharded preset).  JAX's programs are built once per module."""

import ctypes
import sys
import threading
import types

import numpy as np
import pytest
import torch

import imageenhancement_mp_tpu_torch as tie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.models.presets import get_preset as jax_get_preset
from imageenhancement_mp_tpu.parallel import sharding as jsh
from imageenhancement_mp_tpu.pipeline import stream_frames as jax_stream_frames
from imageenhancement_mp_tpu.ref.ops import _equalize_lut
from imageenhancement_mp_tpu_torch import kernels
from imageenhancement_mp_tpu_torch.kernels import _build
from imageenhancement_mp_tpu_torch.parallel import mesh as tmesh
from imageenhancement_mp_tpu_torch.parallel import sharding as tsh
from imageenhancement_mp_tpu_torch.parallel import spatial as tsp

CONFIG5 = "denoise_clahe_sharpen"


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


GRAY = _img((8, 32, 40), 2401)  # 8 planes: one a shard
RGB = _img((8, 32, 40, 3), 2402)  # 24 planes
FRAME = _img((2, 64, 56), 2403)  # row sharding: 8 rows a shard
STREAM = [_img((8, 32, 40), 2404 + i) for i in range(3)]
POOL = {1: _img((16, 37, 43), 2410), 3: _img((16 * 3, 21, 26), 2411)}


def _maxdiff(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _ref_config5(planes):
    return np.stack([ref.unsharp_mask(ref.clahe(ref.median_blur(p, 5), 2.0, (8, 8)), 1.0, 5, 0.0)
                     for p in planes])


@pytest.fixture(scope="module")
def jax_out():
    """JAX's sharded programs on its 8 virtual CPU devices, run once."""
    batch, rows = jsh.make_mesh(8), jsh.make_mesh(8, axis_name="y")
    pipe = jax_get_preset(CONFIG5, mesh=batch)
    spipe = jax_get_preset(CONFIG5, mesh=rows, shard="spatial")
    out = {"gray": np.asarray(pipe(jsh.device_put_sharded_batch(GRAY, batch))),
           "rgb": np.asarray(pipe(RGB)),
           "frame": np.asarray(spipe(FRAME)),
           "stream": [np.asarray(o) for o in jax_stream_frames(pipe, STREAM, 2, mesh=batch)]}
    for c, x in POOL.items():
        out[f"pool{c}"] = np.asarray(jsh.equalize_hist_global_sharded(batch, channels=c)(
            jsh.device_put_sharded_batch(x, batch)))
    return out


@pytest.fixture(scope="module")
def meshes():
    made = {(n, ax): tmesh.make_mesh(n, ax, device="cpu") for n in (1, 2, 8)
            for ax in ("batch", "y")}
    yield made
    for m in made.values():
        m.close()


@pytest.mark.parametrize("name", ["gray", "rgb"])
def test_batch_config5_equals_jax_and_ref(name, meshes, jax_out):
    x = GRAY if name == "gray" else RGB
    got = tie.get_preset(CONFIG5, mesh=meshes[8, "batch"])(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.uint8
    planes = lambda a: a if a.ndim == 3 else np.moveaxis(a, -1, 1).reshape(-1, *a.shape[1:3])
    np.testing.assert_array_equal(planes(got), _ref_config5(planes(x)))
    assert _maxdiff(got, jax_out[name]) <= 2


def test_spatial_config5_equals_jax_and_ref(meshes, jax_out):
    pipe = tie.make_pipeline(tie.models.presets.PRESETS[CONFIG5], mesh=meshes[8, "y"],
                             shard="spatial")
    got = pipe(torch.from_numpy(FRAME)).numpy()
    np.testing.assert_array_equal(got, _ref_config5(FRAME))
    assert _maxdiff(got, jax_out["frame"]) <= 2


@pytest.mark.parametrize("channels", [1, 3])
def test_pooled_equalize_equals_jax_and_the_pooled_oracle(channels, meshes, jax_out):
    x = POOL[channels]
    got = tsh.equalize_hist_global_sharded(meshes[8, "batch"], channels=channels)(
        tsh.device_put_sharded_batch(x, meshes[8, "batch"]))
    assert isinstance(got, tmesh.ShardedTensor)
    got = got.gather().numpy()
    np.testing.assert_array_equal(got, jax_out[f"pool{channels}"])
    want = np.empty_like(x)
    for c in range(channels):
        stack = x[c::channels]
        want[c::channels] = _equalize_lut(np.bincount(stack.ravel(), minlength=256),
                                          stack.size)[stack]
    np.testing.assert_array_equal(got, want)


def test_get_preset_through_stream_frames(meshes, jax_out):
    """Three batches through stream_frames(mesh=): each part sent to its
    shard; the outputs in order, sharded, equal to JAX's stream and to the
    unsharded preset; the spatial variant too."""
    mesh = meshes[8, "batch"]
    outs = list(tie.stream_frames(tie.get_preset(CONFIG5, mesh=mesh), STREAM, 2, mesh=mesh))
    single = tie.get_preset(CONFIG5)
    assert len(outs) == 3
    for f, o, j in zip(STREAM, outs, jax_out["stream"]):
        assert isinstance(o, tmesh.ShardedTensor) and o.spec == ("batch", None, None)
        got = o.gather().numpy()
        np.testing.assert_array_equal(got, single(torch.from_numpy(f)).numpy())
        assert _maxdiff(got, j) <= 2
    rows = meshes[8, "y"]
    souts = list(tie.stream_frames(tie.get_preset(CONFIG5, mesh=rows, shard="spatial"), STREAM,
                                   2, mesh=rows, shard="spatial"))
    for f, o in zip(STREAM, souts):
        assert o.spec == (None, "y", None)
        np.testing.assert_array_equal(o.gather().numpy(), single(torch.from_numpy(f)).numpy())


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("layout", ["gray", "rgb", "single_rgb"])
def test_batch_mesh_equals_the_unsharded_call(layout, n, meshes):
    x = {"gray": GRAY, "rgb": RGB, "single_rgb": RGB[0, :, :, :2]}[layout]
    if layout == "single_rgb" and n == 8:
        x = RGB[:2].reshape(2, 32, 120)  # 2 planes do not split 8 ways
        with pytest.raises(ValueError, match=r"plane count \(N·C=2\) divisible"):
            tie.get_preset(CONFIG5, mesh=meshes[n, "batch"])(torch.from_numpy(x))
        return
    got = tie.get_preset(CONFIG5, mesh=meshes[n, "batch"])(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), tie.get_preset(CONFIG5)(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("layout", ["planes", "hw", "hwc", "nhwc"])
def test_spatial_mesh_equals_the_unsharded_call(layout, n, meshes):
    x = {"planes": FRAME, "hw": FRAME[0], "hwc": RGB[0, :, :, :3],
         "nhwc": RGB[:2]}[layout]
    stages = [("median_blur", {"ksize": 3}), ("equalize_hist", {}),
              ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 4)}), ("unsharp_mask", {})]
    pipe = tie.make_pipeline(stages, mesh=meshes[n, "y"], shard="spatial")
    want = tie.make_pipeline(stages)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(pipe(torch.from_numpy(x)).numpy(), want)
    # the same rows, sent as stream_frames sends them: the result stays sharded
    (out,) = tie.stream_frames(pipe, [x], mesh=meshes[n, "y"], shard="spatial")
    np.testing.assert_array_equal(out.gather().numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_pooled_and_flagship_equal_the_unsharded_call(n, meshes):
    mesh = meshes[n, "batch"]
    x = torch.from_numpy(POOL[1])
    got = tsh.equalize_hist_global_sharded(mesh)(x)  # plain in, plain out
    np.testing.assert_array_equal(got.numpy(), tie.equalize_hist(x, per_frame=False).numpy())
    flagship = tsh.shard_pipeline(
        lambda p: tie.unsharp_mask(tie.equalize_hist(p), 1.0, 5, 0.0), mesh)
    np.testing.assert_array_equal(flagship(torch.from_numpy(GRAY)).numpy(),
                                  tie.equalize_unsharp(torch.from_numpy(GRAY)).numpy())
    # pooled as a pipeline stage, across the shards by its axis_name
    pipe = tie.make_pipeline([("equalize_hist_global", {"axis_name": "batch"})], mesh=mesh)
    np.testing.assert_array_equal(pipe(torch.from_numpy(GRAY)).numpy(),
                                  tie.equalize_hist(torch.from_numpy(GRAY), per_frame=False).numpy())


def test_return_contract(meshes):
    """Plain in gives plain out on the mesh's first device; sharded in
    gives the same split back, its parts where they were."""
    mesh = meshes[8, "batch"]
    pipe = tie.get_preset(CONFIG5, mesh=mesh)
    x = tsh.device_put_sharded_batch(GRAY, mesh)
    assert x.shape == GRAY.shape and x.dtype == torch.uint8 and x.spec == ("batch", None, None)
    out = pipe(x)
    assert isinstance(out, tmesh.ShardedTensor) and out.spec == x.spec
    assert all(b.shape == (1, 32, 40) for b in out.blocks)
    plain = pipe(torch.from_numpy(GRAY))
    assert isinstance(plain, torch.Tensor) and plain.device == mesh.first_device
    np.testing.assert_array_equal(out.gather().numpy(), plain.numpy())
    with pytest.raises(ValueError, match="this pipeline takes"):
        pipe(tsp.device_put_spatial(GRAY, meshes[8, "batch"], axis_name="batch"))


def test_mesh_and_front_door_errors(meshes):
    with pytest.raises(ValueError, match="requested 1 devices, have 0"):
        if torch.cuda.device_count():
            pytest.skip("a CUDA device is present")
        tmesh.make_mesh(1)
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.Mesh(["cpu", "meta"], ("x",))
    with pytest.raises(ValueError, match="distinct axis names"):
        tmesh.Mesh([["cpu"] * 2] * 2, ("x", "x"))
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.make_mesh(0, device="cpu")
    batch, rows = meshes[8, "batch"], meshes[8, "y"]
    with pytest.raises(ValueError, match="divisible"):
        tie.make_pipeline([("gamma", {"gamma": 2.2})], mesh=batch)(torch.zeros((3, 16, 16),
                                                                                dtype=torch.uint8))
    with pytest.raises(ValueError, match="spatial sharding needs H divisible"):
        tie.make_pipeline([("gamma", {"gamma": 2.2})], mesh=rows, shard="spatial")(
            torch.zeros((2, 36, 16), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shard must be"):
        tie.make_pipeline(["gamma"], mesh=batch, shard="rows")
    with pytest.raises(ValueError, match="not an axis"):
        tie.get_preset(CONFIG5, mesh=batch, axis_name="y")
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        tsh.device_put_sharded_batch(np.zeros((3, 4, 4), np.uint8), batch)
    with pytest.raises(ValueError, match="exactly one"):
        list(tie.stream_frames(lambda x: x, [GRAY], device="cpu", mesh=batch))
    with pytest.raises(ValueError, match="exactly one"):
        list(tie.stream_frames(lambda x: x, [GRAY]))
    with pytest.raises(RuntimeError, match="inside a shard of the same mesh"):
        tsh.shard_pipeline(lambda p: tsh.shard_pipeline(lambda q: q, batch)(p), batch)(
            torch.zeros((64, 4, 4), dtype=torch.uint8))


# -- host state that shard threads share, 8 threads at once -------------------

THREADS = 8


def _together(fn, n: int = THREADS) -> list:
    """``fn(i)`` on ``n`` threads released at once; their results in order.
    A short switch interval makes the interpreter interleave them often."""
    start, results, errors = threading.Barrier(n), [None] * n, []

    def one(i):
        start.wait()
        try:
            results[i] = fn(i)
        except BaseException as exc:  # recorded, raised below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    if errors:
        raise errors[0]
    return results


FAKE_NVCC = """#!{python}
import subprocess, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
out = args[args.index("-o") + 1]
if "-shared" in args:
    sys.exit(subprocess.call(["gcc", "-shared", "-o", out] + [a for a in args if a.endswith(".o")]))
sys.exit(subprocess.call(["gcc", "-x", "c", "-fPIC", "-c", "-o", out, args[-1]]))
"""


def test_library_builds_once_under_threads(tmp_path, monkeypatch):
    """8 threads ask for the library at once: one build (one compiler call
    a source, one link), one loaded library for all."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("".join(f"int {name}(void) {{ return 0; }}\n"
                                       for name in _build._SIGNATURES)
                               + 'const char* ie_error_string(int e) { return "none"; }\n')
    (csrc / "b.cu").write_text("int ie_unused(void) { return 1; }\n")
    log = tmp_path / "nvcc.calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    _build._load.cache_clear()
    try:
        libs = _together(lambda i: _build.library())
        assert all(lib is libs[0] for lib in libs) and isinstance(libs[0], ctypes.CDLL)
        calls = log.read_text().splitlines()
        assert len(calls) == 3 and sum("-shared" in c for c in calls) == 1
        assert libs[0].ie_error_string(0) == b"none"
    finally:
        _build._load.cache_clear()


def test_launch_counts_lose_no_launch_under_threads(monkeypatch):
    fake = types.SimpleNamespace(ie_median=lambda *a: 0, ie_error_string=lambda e: b"")
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: threading.Lock())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launch_counts()
    per_thread = 4000
    _together(lambda i: [_build.launch("median", torch.device("cpu")) for _ in range(per_thread)])
    try:
        assert kernels.launch_counts["median"] == THREADS * per_thread
        assert sum(kernels.launch_counts.values()) == THREADS * per_thread
    finally:
        kernels.reset_launch_counts()


def test_host_derived_under_threads():
    """Each tensor's value computed once while it lives, right for every
    thread, while other threads insert and prune."""
    def work(i):
        kept, calls = [], []
        for k in range(300):
            t = torch.full((3,), i * 1000 + k)
            got = kernels.host_derived(t, "sum", lambda a: (calls.append(1), int(a.sum()))[1])
            assert got == 3 * (i * 1000 + k)
            if k % 2:
                kept.append(t)  # the others die: the prune drops them
        n_calls = len(calls)
        for t in kept:
            assert kernels.host_derived(t, "sum", lambda a: calls.append(1)) == int(t.sum())
        return n_calls, len(calls)

    for first, after in _together(work):
        assert first == 300 and after == 300


def test_stream_workspace_under_threads(monkeypatch):
    """8 threads on one stream get its one buffer; the one that needs more
    grows it, zeroed; the dict keeps its bound."""
    monkeypatch.setattr(kernels, "_WORKSPACES", {})
    cpu = torch.device("cpu")
    got = _together(lambda i: kernels.stream_workspace(cpu, 100, zeroed=True))
    assert all(t is got[0] for t in got) and got[0].numel() >= 100
    grown = _together(lambda i: kernels.stream_workspace(cpu, 4096 if i == 3 else 8, zeroed=True))
    assert grown[3].numel() >= 4096 and not grown[3].any()
    assert len(kernels._WORKSPACES) == 1
