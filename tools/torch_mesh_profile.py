#!/usr/bin/env python3
"""Host cost of the port's mesh runner (parallel/mesh.py) on one GPU.

    python3 tools/torch_mesh_profile.py

Times, back to back (CUDA events around a few calls) and on the host clock
(the calls queued, before the stream is waited for), config 5 on
4x2160x3840 u8 batch-sharded and on one 4320x7680 u8 frame row-sharded:
unsharded, on a 1-device mesh, and as four shards on the one card (a mesh
that names cuda:0 four times; not a scaling figure).  The four-shard calls
run under two schedules, in turns (turns, free, free, turns):

* ``turns``: the shipped ``mesh._Schedule``, one shard running at a time
  (shard 0 on the calling thread), handing the turn on at each collective;
* ``free``: the same threads running at once, meeting at a barrier for each
  collective (this file's ``free_schedule``, the first design).

Beside them the runner alone (an identity function through
``run_sharded``), the sequential floor: the same shards' calls made one after
another on the calling thread (batch sharding needs no collective), and the
device's busy share of the four-shard calls under torch.profiler, and
cProfile's split of shard 0's thread (the calling thread) over ten
row-sharded calls.  Exits non-zero without a CUDA device.
"""

import cProfile
import io
import pstats
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


class _AnyRank:
    """A turn that every rank holds."""

    def __eq__(self, other) -> bool:
        return True


def free_schedule(pmesh):
    """The first design as a ``_Schedule``: every shard thread runs at once
    and each collective meets at a barrier."""

    class FreeSchedule(pmesh._Schedule):
        def __init__(self, mesh):
            self.barrier = threading.Barrier(mesh.size)
            super().__init__(mesh)

        def run(self, fn, blocks):
            streams = ({d: torch.cuda.current_stream(d) for d in self.mesh.device_list}
                       if self.mesh.first_device.type == "cuda" else {})
            with self._lock:
                self.call += 1
                self.job = (fn, blocks, streams)
                self.turn = _AnyRank()
                self.done = [False] * self.n
                self.error = None
                for wake in self._wake[1:]:
                    wake.notify()
            self._shard(0, fn, blocks[0])
            with self._lock:
                while not all(self.done):
                    self._wake[0].wait()
                error, outs = self.error, self.outs
                self.job, self.outs, self.error = None, [None] * self.n, None
            self.barrier.reset()
            if error is not None:
                raise error
            return outs

        def _hand_on(self, rank):
            if all(self.done):
                self._wake[0].notify()

        def _fail(self, exc):
            super()._fail(exc)
            self.barrier.abort()

        def swap(self, rank, value):
            self.slots[0][rank] = value
            self.barrier.wait()
            values = list(self.slots[0])
            self.barrier.wait()
            return values

    return FreeSchedule


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_profile: torch.cuda.is_available() is False")
    import imageenhancement_mp_tpu_torch as port
    from imageenhancement_mp_tpu_torch.kernels import _build
    from imageenhancement_mp_tpu_torch.models.presets import PRESETS
    from imageenhancement_mp_tpu_torch.parallel import mesh as pmesh

    smi = cs.nvidia_smi_line()
    print(smi)
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    shipped, free = pmesh._Schedule, free_schedule(pmesh)
    one = pmesh.make_mesh(1)
    four = pmesh.Mesh([dev] * 4, ("batch",))
    rows = pmesh.Mesh([dev] * 4, ("y",))
    single = port.get_preset("denoise_clahe_sharpen")
    g = torch.from_numpy(cs.noisy((4,), 2160, 3840, (), 1701, 10.0)).to(dev)
    g8 = torch.from_numpy(cs.noisy((), 4320, 7680, (), 1703, 10.0)).to(dev)
    batch4 = port.get_preset("denoise_clahe_sharpen", mesh=four)
    rows4 = port.make_pipeline(PRESETS["denoise_clahe_sharpen"], mesh=rows, shard="spatial")
    cases = {
        "batch 4x2160x3840 unsharded": lambda: single(g),
        "batch 4x2160x3840 1-device mesh": (
            lambda p: lambda: p(g))(port.get_preset("denoise_clahe_sharpen", mesh=one)),
        "batch 4x2160x3840 sequential floor (4 calls of 1 frame)":
            lambda: [single(g[i:i + 1]) for i in range(4)],
        "batch 4x2160x3840 4 shards": lambda: batch4(g),
        "runner alone (identity) 4x2160x3840 1-device mesh":
            (lambda f: lambda: f(g))(pmesh.run_sharded(lambda p: p, one, ("batch",), ("batch",))),
        "runner alone (identity) 4x2160x3840 4 shards":
            (lambda f: lambda: f(g))(pmesh.run_sharded(lambda p: p, four, ("batch",), ("batch",))),
        "rows 4320x7680 unsharded": lambda: single(g8),
        "rows 4320x7680 4 shards": lambda: rows4(g8),
    }

    def measure(label: str, fn) -> None:
        ms, iqr = cs.time_ms(fn, runs=10, calls=4)
        host = cs.host_us(dev, fn, 10)
        print(f"{label}: {ms:.4f} ms a call back to back (IQR {iqr:.4f}), host {host:.1f} us "
              f"a call  [{smi}]")

    try:
        for label, fn in cases.items():
            if "4 shards" not in label:
                measure(label, fn)
        for turn, schedule in enumerate(("turns", "free", "free", "turns")):
            for m in (four, rows):
                m.close()  # its next call starts threads of this schedule
            pmesh._Schedule = shipped if schedule == "turns" else free
            for label, fn in cases.items():
                if "4 shards" in label:
                    measure(f"{label}, {schedule} (turn {turn})", fn)
        for m in (four, rows):
            m.close()
        pmesh._Schedule = shipped
        for label, fn in cases.items():
            if "4 shards" in label:
                print(f"{label}, turns: {cs.busy_share(fn, 4)}")
        # shard 0 runs on this thread: where its host time goes, the waits
        # for the other shards' turns included
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(10):
            rows4(g8)
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
        print("rows 4320x7680 4 shards, turns, 10 calls under cProfile (shard 0's thread):")
        print(out.getvalue())
    finally:
        pmesh._Schedule = shipped
        for m in (one, four, rows):
            m.close()


if __name__ == "__main__":
    main()
