"""imageenhancement_mp_tpu_torch/profiling.py on the CPU, held to the JAX
package's profiling.py.

* ``time_op`` and ``throughput_gpixs``: the port's copy of
  tests/test_pipeline.py::test_profiling_helpers.
* The chain's scalar (``_chain_program``): equal to JAX's at 0 for integer
  ops (histeq chained and refed, a shape-changing area resize) at n = 1, 2
  and 5, and within a relative 1e-5 for f32 gamma (the f32 sums run in
  another order).
* The chain law: each application's input is the previous output (auto),
  or the original input with at most its first element changed (refeed,
  also where the output's strides differ from the input's).
* ``time_op_chained``: a fixed ``n_hi`` gives a positive time; automatic
  sizing never exceeds ``max_chain``.
* ``time_op`` blocks on what the call did (the JAX package's
  ``block_until_ready``), with ``torch.cuda.synchronize`` and the device
  of a tensor stubbed: a CUDA tensor in a list argument, in a tuple result,
  in a closure's result, on two devices; the current device for a closure
  that returns no tensor once CUDA is initialized; nothing on the CPU.

The CUDA graph path runs on the card only (chip_smoke.py's phase 18).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu import profiling as jprof
from imageenhancement_mp_tpu.models.presets import get_preset as jax_get_preset
from imageenhancement_mp_tpu.ops import pointwise as jpoint
from imageenhancement_mp_tpu.ops import resize as jresize
from imageenhancement_mp_tpu_torch import profiling as tprof
from imageenhancement_mp_tpu_torch.models.presets import get_preset
from imageenhancement_mp_tpu_torch.ops import pointwise as tpoint
from imageenhancement_mp_tpu_torch.ops import resize as tresize


def _u8(seed: int, shape=(2, 32, 32)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_time_op_and_throughput():
    img = torch.from_numpy(_u8(0))
    pipe = get_preset("histeq")
    secs = tprof.time_op(pipe, img, iters=2, warmup=1)
    assert secs > 0
    assert tprof.throughput_gpixs(img.shape, secs) > 0
    assert tprof.time_op(pipe, img, iters=3, warmup=0, reduce="min") > 0
    assert tprof.throughput_gpixs((2, 1000, 1000), 2e-3) == pytest.approx(1.0)


def test_exports_match_jax():
    import inspect

    assert tprof.__all__ == jprof.__all__
    for name in tprof.__all__:
        assert (inspect.signature(getattr(tprof, name))
                == inspect.signature(getattr(jprof, name))), name


# case -> (port fn, JAX fn, input, mode)
INT_CASES = {
    "histeq/auto": (get_preset("histeq"), jax_get_preset("histeq"), _u8(1), "auto"),
    "histeq/refeed": (get_preset("histeq"), jax_get_preset("histeq"), _u8(2), "refeed"),
    "resize_area_16x16": (lambda p: tresize.resize_planes(p, (16, 16), "area"),
                          lambda p: jresize.resize_planes(p, (16, 16), "area"), _u8(3), "auto"),
}


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("case", list(INT_CASES))
def test_chain_matches_jax(case, n):
    fn, jfn, x, mode = INT_CASES[case]
    want = int(jprof._chain_program(jfn, jnp.asarray(x), n, mode)(jnp.asarray(x)))
    got = tprof._chain_program(fn, torch.from_numpy(x), n, mode)(torch.from_numpy(x))
    assert got.dtype == torch.int64 and got.ndim == 0
    assert int(got) == want
    assert int(tprof._chain_eager(fn, torch.from_numpy(x), n, mode)) == want


@pytest.mark.parametrize("n", [1, 2, 5])
def test_chain_matches_jax_f32(n):
    x = (np.random.default_rng(4).random((2, 32, 32)) * 255).astype(np.float32)
    want = float(jprof._chain_program(lambda p: jpoint.gamma_planes(p, 0.8), jnp.asarray(x),
                                      n)(jnp.asarray(x)))
    got = tprof._chain_program(lambda p: tpoint.gamma_planes(p, 0.8), torch.from_numpy(x),
                               n)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-5)


class _Recorder:
    """``fn`` that records each input and returns a changed copy (the same
    shape and dtype, or a 2x2-subsampled plane)."""

    def __init__(self, shrink: bool):
        self.inputs, self.outputs, self.shrink = [], [], shrink

    def __call__(self, c: torch.Tensor) -> torch.Tensor:
        self.inputs.append(c.clone())
        y = (c[..., ::2, ::2] if self.shrink else c) + 1
        self.outputs.append(y.clone())
        return y


@pytest.mark.parametrize("n", [1, 3, 5])
def test_chain_is_data_dependent(n):
    x = torch.from_numpy(_u8(5, (2, 8, 8)))
    rec = _Recorder(shrink=False)
    got = tprof._chain_program(rec, x, n)(x)
    chain = rec.inputs[1:]  # the first call reads the output's shape and dtype
    assert len(chain) == n and torch.equal(chain[0], x)
    for prev_out, inp in zip(rec.outputs[1:], chain[1:]):
        assert torch.equal(inp, prev_out)
    assert int(got) == int(rec.outputs[-1].to(torch.int64).sum()) & 0xFFFFFFFF
    for shrink, mode in ((False, "refeed"), (True, "auto")):
        rec = _Recorder(shrink)
        tprof._chain_program(rec, x, n, mode)(x)
        chain = rec.inputs[1:]
        assert len(chain) == n
        for inp in chain:
            diff = (inp != x).reshape(-1)
            assert not diff[1:].any()
        # the first element flips with the parity of the previous output
        for prev_out, prev_in, inp in zip(rec.outputs[1:], chain, chain[1:]):
            bit = int(prev_out.to(torch.int64).sum()) & 1
            assert int(inp.reshape(-1)[0]) == int(prev_in.reshape(-1)[0]) ^ bit
    assert torch.equal(x, torch.from_numpy(_u8(5, (2, 8, 8))))  # the caller's input untouched


def test_chain_keeps_the_input_layout():
    """Config 2 returns channels-last frames as a view of channel planes:
    the chain refeeds the caller's layout instead of chaining that view,
    which would skip the next call's transpose."""
    x = torch.from_numpy(_u8(7, (2, 8, 8, 3)))
    pipe = get_preset("gamma_stretch")
    assert pipe(x).stride() != x.stride()
    strides = []

    def fn(c):
        strides.append(c.stride())
        return pipe(c)

    tprof._chain_program(fn, x, 3)(x)
    assert strides == [x.stride()] * 4


def test_refeed_folds_into_floats_and_unsigned_16():
    """The folded bit is the parity of the output's wraparound uint32 sum
    (integers of every width and sign) or the low bit of its f32 sum."""
    x16 = torch.from_numpy(np.arange(16, dtype=np.uint16).reshape(1, 4, 4))
    c = x16.clone()
    tprof._fold(c, torch.ones(3, dtype=torch.int16))
    assert int(c[0, 0, 0]) == 1 and torch.equal(c.reshape(-1)[1:], x16.reshape(-1)[1:])
    rng = np.random.default_rng(8)
    for dtype in (np.uint8, np.int8, np.uint16, np.int16, np.int32):
        info = np.iinfo(dtype)
        for size in (1, 2, 1001):
            y = rng.integers(info.min, info.max, size, endpoint=True).astype(dtype)
            c = torch.zeros(3, dtype=torch.int32)
            tprof._fold(c, torch.from_numpy(y))
            assert int(c[0]) == int(y.astype(np.uint32).sum(dtype=np.uint32)) & 1, (dtype, size)
    xf = torch.zeros((2, 3), dtype=torch.float32)
    tprof._fold(xf, torch.tensor([1.5], dtype=torch.float32))  # f32 1.5: low bit 0
    assert float(xf[0, 0]) == 0.0
    tprof._fold(xf, torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32))  # low bit 1
    assert xf[0, 0].item() == float(np.float32(1e-30)) and not xf.reshape(-1)[1:].any()


def test_time_op_chained_sizes(monkeypatch):
    x = torch.from_numpy(_u8(6))
    pipe = get_preset("histeq")
    assert tprof.time_op_chained(pipe, x, n_hi=6, repeats=1) > 0
    lengths = []
    program = tprof._chain_program

    def recording(fn, x, n, mode="auto"):
        lengths.append(n)
        return program(fn, x, n, mode)

    monkeypatch.setattr(tprof, "_chain_program", recording)
    assert tprof.time_op_chained(pipe, x, target_secs=0.02, max_chain=64) > 0
    assert lengths and max(lengths) <= 64


def _stub_cuda(monkeypatch, on_card: list, initialized: bool) -> list:
    """``torch.cuda.synchronize`` recorded and the tensors of ``on_card``
    seen on ``cuda:i`` (i their index there); returns the record."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialized)
    real = tprof._tensor_device

    def device(t):
        hit = [i for i, c in enumerate(on_card) if c is t]
        return torch.device("cuda", hit[0]) if hit else real(t)

    monkeypatch.setattr(tprof, "_tensor_device", device)
    return synced


@pytest.mark.parametrize("case", ["list argument", "tuple result", "closure result",
                                  "dict in a list", "two devices"])
def test_time_op_blocks_on_the_cuda_work_of_each_call(monkeypatch, case):
    frames = [torch.zeros(4), torch.ones(4)]
    out = torch.zeros(2)
    card0, card1 = torch.zeros(3), torch.zeros(3)
    if case == "list argument":  # merge_mertens-like: frames in a list, a CPU result
        on, fn, args, want = [card0], lambda fs: fs[1] + 1, ([frames[0], card0],), {0}
    elif case == "tuple result":
        on, fn, args, want = [card0], lambda x: (out, card0), (frames[0],), {0}
    elif case == "closure result":
        on, fn, args, want = [card0], lambda: card0, (), {0}
    elif case == "dict in a list":
        on, fn, args, want = [card0], lambda: [{"a": (out, card0)}], (), {0}
    else:
        on, fn, args, want = [card0, card1], lambda x: card1, (card0,), {0, 1}
    synced = _stub_cuda(monkeypatch, on, initialized=True)
    assert tprof.time_op(fn, *args, iters=2, warmup=1) >= 0
    assert len(synced) == 3 * len(want)  # every call, warm-up and timed
    assert {d.index for d in synced} == want and all(d.type == "cuda" for d in synced)


def test_time_op_blocks_a_closure_on_the_current_device(monkeypatch):
    """No CUDA tensor in sight: the current device once CUDA is initialized
    (a closure's kernels), nothing before (a CPU call)."""
    synced = _stub_cuda(monkeypatch, [], initialized=True)
    tprof.time_op(lambda: None, iters=3, warmup=2)
    assert synced == [None] * 5
    synced = _stub_cuda(monkeypatch, [], initialized=False)
    tprof.time_op(lambda x: x + 1, torch.zeros(3), iters=3, warmup=2)
    assert synced == []
