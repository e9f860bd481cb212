"""A single-controller device mesh, its sharded calls and its collectives.

The counterpart of ``jax.sharding.Mesh``, ``jax.shard_map`` and the
``jax.lax`` collectives that the JAX package's ``parallel/`` uses.  As in
JAX, one call takes the whole input and returns the whole result:
:func:`run_sharded` splits the input along named mesh axes, moves each part
to its shard's device and calls ``fn(local)`` once per shard, on a thread of
its own from a pool the mesh owns (inline on a 1-device mesh); the shards
take turns on the host, one running at a time, so they never contend for
the interpreter lock, and their device work overlaps as queued.  Inside
``fn`` the collectives (:func:`psum`, :func:`pmin`, :func:`pmax`,
:func:`all_gather`, :func:`ppermute`, :func:`shift`,
:func:`axis_index`, :func:`axis_size`) act on a named axis: they read the shard from the
thread's context and raise ``NameError`` outside a sharded call, as JAX
raises on an unbound axis.  On a 2-D mesh the collectives of one axis stay
within the group of shards that share the other axes' coordinates.

Collectives move exact values with ``.to(device)`` and reduce in shard
order, so a sharded op whose collectives carry integers (histograms, min
and max, LUT tables, halo rows) equals its unsharded twin bit for bit.

A device may appear more than once: a mesh that names the CPU 8 times is the
tests' stand-in for JAX's 8 virtual CPU devices, and one that names
``cuda:0`` four times runs every split, halo and gather on one card.  Each
shard thread runs on the caller's current stream of every mesh device, so
a sharded call queues its work where an unsharded call would.

Why threads and not ``torch.distributed``: a process group has each rank
call with its own part, which is another call contract, and NCCL cannot put
two ranks on one card, so a card could never run a mesh of more than one
shard.
"""

from __future__ import annotations

import itertools
import math
import threading
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "ShardedTensor", "make_mesh", "device_put", "run_sharded", "axis_index",
           "axis_size", "psum", "pmin", "pmax", "all_gather", "ppermute", "shift"]

# a partition spec: per leading dimension, the mesh axis it is split over or
# None; dimensions past its end are not split
Spec = Sequence


class Mesh:
    """A grid of devices with named axes: ``Mesh(devices, axis_names)``,
    ``devices`` a nested sequence of ``torch.device`` (or names) whose
    nesting depth is ``len(axis_names)``.  All devices are CPU or all CUDA.

    ``shape`` maps each axis name to its size, in order; ``size`` is the
    shard count.  Shard ``rank`` is the row-major position in the grid.  The
    shard threads start at the first sharded call; :meth:`close` ends them."""

    def __init__(self, devices, axis_names: Sequence[str]):
        raw = np.array(devices, dtype=object)
        grid = np.empty(raw.shape, dtype=object)
        for i in np.ndindex(raw.shape):
            grid[i] = torch.device(raw[i])
        names = tuple(axis_names)
        if grid.ndim != len(names) or len(set(names)) != len(names) or grid.size == 0:
            raise ValueError(f"a mesh of {grid.shape} devices needs {grid.ndim} distinct axis "
                             f"names, got {names}")
        types = {d.type for d in grid.flat}
        if types not in ({"cpu"}, {"cuda"}):
            raise ValueError(f"a mesh's devices are all CPU or all CUDA, got {sorted(types)}")
        self.devices = grid
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))
        self.size = grid.size
        self.device_list = list(grid.flat)  # by rank
        self.coords = [dict(zip(names, map(int, c))) for c in np.ndindex(grid.shape)]  # by rank
        self._call = threading.Lock()  # one sharded call at a time
        self._schedule: _Schedule | None = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list]})"

    @property
    def first_device(self) -> torch.device:
        """Where a plain result lands: the device of shard 0."""
        return self.device_list[0]

    def rank(self, coords: dict) -> int:
        """The rank at the coordinates ``coords`` (axis name → index)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def close(self) -> None:
        """End the shard threads (a later call starts them anew)."""
        with self._call:
            if self._schedule is not None:
                self._schedule.stop()
                self._schedule = None

    def _run(self, fn: Callable, blocks: list) -> list:
        """``fn(blocks[r])`` for every rank ``r``, each in a shard context,
        the shards taking turns (:class:`_Schedule`); the outputs by rank.
        The first exception of any shard ends the others' waits and is
        raised here."""
        ctx = getattr(_LOCAL, "shard", None)
        if ctx is not None and ctx.mesh is self:
            raise RuntimeError("a sharded call cannot run inside a shard of the same mesh")
        with self._call:
            if self._schedule is None:
                self._schedule = _Schedule(self)
            return self._schedule.run(fn, blocks)


class _Aborted(Exception):
    """Raised in a shard whose call another shard's exception ended."""


_RETURNED_EARLY = "a shard returned before a collective that the other shards reached"


class _Schedule:
    """A mesh's shard threads and the turns they take.

    The calling thread runs shard 0; one thread a rank runs each other
    shard.  The shards take turns on the host, one running at a time, in
    rank order: a shard runs until it reaches a collective or returns, then
    hands the turn to the next shard still running.  Threads that ran at
    once would hand the interpreter lock to each other at every torch call
    (each releases it), which costs more host time than the shards' own
    work; the device work they queue runs as it would.  A collective's
    values are read once every shard has posted its own; two slot rows,
    since a shard posts round k + 1 only after every shard has read round
    k.  A worker runs on the caller's current stream of each mesh device."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.n = mesh, mesh.size
        self._lock = threading.Lock()
        self._wake = [threading.Condition(self._lock) for _ in range(self.n)]
        self.call = 0  # calls started
        self.stopping = False
        self.job = None
        self.turn = 0
        self.done = [True] * self.n
        self.posted = [0] * self.n
        self.slots = ([None] * self.n, [None] * self.n)
        self.outs: list = [None] * self.n
        self.error: BaseException | None = None
        self._threads = [threading.Thread(target=self._worker, args=(r,), daemon=True,
                                          name=f"mesh-shard-{r}") for r in range(1, self.n)]
        for t in self._threads:
            t.start()

    def run(self, fn: Callable, blocks: list) -> list:
        streams = {}
        if self.n > 1 and self.mesh.first_device.type == "cuda":
            for d in self.mesh.device_list:
                streams.setdefault(d, torch.cuda.current_stream(d))
        with self._lock:
            self.call += 1
            self.job = (fn, blocks, streams)
            self.turn = 0
            self.done = [False] * self.n
            self.posted = [0] * self.n
            self.error = None
        self._shard(0, fn, blocks[0])  # on the caller's thread and streams
        with self._lock:
            while not all(self.done):
                self._wake[0].wait()
            error, outs = self.error, self.outs
            self.job, self.outs, self.error = None, [None] * self.n, None
            self.slots = ([None] * self.n, [None] * self.n)
        if error is not None:
            raise error
        return outs

    def stop(self) -> None:
        with self._lock:
            self.stopping = True
            for wake in self._wake:
                wake.notify_all()
        for t in self._threads:
            t.join()

    def _worker(self, rank: int) -> None:
        seen = 0
        while True:
            with self._lock:
                while not self.stopping and not (
                        self.call > seen and (self.turn == rank or self.error is not None)):
                    self._wake[rank].wait()
                if self.stopping:
                    return
                seen = self.call
                if self.error is not None:  # the call failed before this shard's turn
                    self.done[rank] = True
                    self._hand_on(rank)
                    continue
                fn, blocks, streams = self.job
            own = self.mesh.device_list[rank]
            for d in sorted(streams, key=lambda d: d == own):  # own last: the current device
                torch.cuda.set_stream(streams[d])
            self._shard(rank, fn, blocks[rank])

    def _shard(self, rank: int, fn: Callable, block) -> None:
        prev = getattr(_LOCAL, "shard", None)
        _LOCAL.shard = _Shard(self.mesh, self.mesh.coords[rank], rank, self)
        out = exc = None
        try:
            out = fn(block)
        except BaseException as e:  # raised from the call by run()
            exc = e
        finally:
            _LOCAL.shard = prev
        with self._lock:
            self.outs[rank] = out
            self.done[rank] = True
            if exc is not None:
                self._fail(exc)
            elif any(not d and p > self.posted[rank] for d, p in zip(self.done, self.posted)):
                self._fail(RuntimeError(_RETURNED_EARLY))
            self._hand_on(rank)

    def _wait(self, rank: int, ready: Callable[[], bool]) -> None:
        while self.error is None and not ready():
            self._wake[rank].wait()
        if self.error is not None:
            raise _Aborted()

    def _hand_on(self, rank: int) -> None:
        """The turn to the next shard after ``rank`` that still runs; when
        none does, wake the caller (shard 0's thread)."""
        for k in range(1, self.n + 1):
            nxt = (rank + k) % self.n
            if not self.done[nxt]:
                self.turn = nxt
                self._wake[nxt].notify()
                return
        self._wake[0].notify()

    def _fail(self, exc: BaseException) -> None:
        if self.error is None:
            self.error = exc
        for wake in self._wake:
            wake.notify_all()

    def swap(self, rank: int, value) -> list:
        """Post ``value`` for this round; every shard's value of the round."""
        with self._lock:
            k = self.posted[rank]
            self.slots[k % 2][rank] = value
            self.posted[rank] = k + 1
            if any(d and p <= k for d, p in zip(self.done, self.posted)):
                self._fail(RuntimeError(_RETURNED_EARLY))
            self._hand_on(rank)
            self._wait(rank, lambda: self.turn == rank and min(self.posted) > k)
            return list(self.slots[k % 2])


class _Shard:
    """A shard's context: its mesh, coordinates, rank and schedule."""

    def __init__(self, mesh: Mesh, coords: dict, rank: int, schedule: _Schedule):
        self.mesh, self.coords, self.rank, self.schedule = mesh, coords, rank, schedule

    def group(self, names: tuple) -> list[int]:
        """The ranks that share this shard's coordinates on every axis not
        in ``names``, ordered row-major by their coordinates on ``names``."""
        coords = dict(self.coords)
        ranks = []
        for idx in itertools.product(*[range(self.mesh.shape[a]) for a in names]):
            coords.update(zip(names, idx))
            ranks.append(self.mesh.rank(coords))
        return ranks


_LOCAL = threading.local()


def _bound(axis_name) -> tuple[_Shard, tuple]:
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    shard = getattr(_LOCAL, "shard", None)
    if shard is None or any(a not in shard.mesh.shape for a in names):
        raise NameError(f"unbound axis name: {axis_name!r}; collectives run inside a sharded "
                        "call (run_sharded) over a mesh that names the axis")
    return shard, names


def axis_size(axis_name) -> int:
    """The number of shards along ``axis_name`` (a name or a tuple of names)."""
    shard, names = _bound(axis_name)
    return math.prod(shard.mesh.shape[a] for a in names)


def axis_index(axis_name) -> int:
    """This shard's position along ``axis_name``."""
    shard, names = _bound(axis_name)
    index = 0
    for a in names:
        index = index * shard.mesh.shape[a] + shard.coords[a]
    return index


def _gather_group(x, axis_name) -> list:
    """Every value of this shard's group along ``axis_name``, in order."""
    shard, names = _bound(axis_name)
    values = shard.schedule.swap(shard.rank, x)
    return [values[r] for r in shard.group(names)]


def _reduce(x: torch.Tensor, axis_name, op) -> torch.Tensor:
    parts = _gather_group(x, axis_name)
    acc = parts[0].to(x.device)
    for p in parts[1:]:
        acc = op(acc, p.to(x.device))
    return acc


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of ``x`` over the shards along ``axis_name``, in shard order."""
    return _reduce(x, axis_name, torch.add)


def pmin(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the shards along ``axis_name``."""
    return _reduce(x, axis_name, torch.minimum)


def pmax(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the shards along ``axis_name``."""
    return _reduce(x, axis_name, torch.maximum)


def all_gather(x: torch.Tensor, axis_name, axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """The shards' ``x`` along ``axis_name``, stacked on a new dimension
    ``axis`` or, ``tiled``, concatenated along ``axis``."""
    parts = [p.to(x.device) for p in _gather_group(x, axis_name)]
    return torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)


def ppermute(x: torch.Tensor, axis_name, perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``x`` of the shard at index ``src`` for each ``(src, dst)`` pair of
    ``perm``, received by the shard at index ``dst``; zeros where no pair
    names this shard as ``dst``."""
    parts = _gather_group(x, axis_name)
    me = axis_index(axis_name)
    src = [s for s, d in perm if d == me]
    if len(src) > 1:
        raise ValueError(f"ppermute: index {me} receives from {src}")
    return parts[src[0]].to(x.device) if src else torch.zeros_like(x)


def shift(to_next: torch.Tensor, to_prev: torch.Tensor, axis_name) -> tuple:
    """Both neighbour shifts along ``axis_name`` in one exchange:
    ``(from_prev, from_next)``, the previous shard's ``to_next`` and the
    next shard's ``to_prev``, each None at its end of the axis.  What the
    two ``ppermute`` calls with pairs ``(i, i+1)`` and ``(i+1, i)`` give, but
    one round of the schedule instead of two."""
    parts = _gather_group((to_next, to_prev), axis_name)
    i = axis_index(axis_name)
    from_prev = parts[i - 1][0].to(to_next.device) if i > 0 else None
    from_next = parts[i + 1][1].to(to_prev.device) if i + 1 < len(parts) else None
    return from_prev, from_next


def make_mesh(n_devices: int | None = None, axis_name: str = "batch",
              device: str | torch.device = "cuda") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` CUDA devices (all of them by
    default); ``ValueError`` when there are fewer.  ``device="cpu"`` gives a
    mesh of ``n_devices`` entries (1 by default) that are all the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        n = 1 if n_devices is None else int(n_devices)
        devices = [torch.device("cpu")] * n
    elif dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        raise ValueError(f"make_mesh: no mesh of {dev.type} devices")
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    return Mesh(devices, (axis_name,))


def _spec(spec, ndim: int) -> tuple:
    """``spec`` as a tuple of ``ndim`` entries (a name alone is ``(name,)``)."""
    spec = (spec,) if isinstance(spec, str) or spec is None else tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"partition spec {spec} is longer than the {ndim} dimensions")
    return spec + (None,) * (ndim - len(spec))


class ShardedTensor:
    """A tensor split over a mesh: ``blocks[r]`` is the part that rank ``r``
    holds, on its device; a mesh axis that ``spec`` does not name holds the
    same part at each of its coordinates.  :meth:`gather` assembles the
    whole tensor."""

    def __init__(self, mesh: Mesh, spec: Spec, blocks: list):
        first = blocks[0]
        self.mesh, self.blocks = mesh, list(blocks)
        self.spec = _spec(spec, first.dim())
        self.shape = torch.Size(s * (mesh.shape[a] if a else 1)
                                for s, a in zip(first.shape, self.spec))
        self.dtype = first.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"ShardedTensor({tuple(self.shape)}, {self.dtype}, spec={self.spec}, {self.mesh})"

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's first device by default)."""
        dev = self.mesh.first_device if device is None else torch.device(device)
        split = [(dim, a) for dim, a in enumerate(self.spec) if a is not None]

        def build(coords: dict, k: int) -> torch.Tensor:
            if k == len(split):  # coordinate 0 on the axes the spec does not split
                return self.blocks[self.mesh.rank({a: coords.get(a, 0)
                                                   for a in self.mesh.axis_names})].to(dev)
            dim, a = split[k]
            parts = [build({**coords, a: i}, k + 1) for i in range(self.mesh.shape[a])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

        return build({}, 0)


def device_put(x, mesh: Mesh, spec: Spec) -> ShardedTensor:
    """Split ``x`` (a tensor or NumPy array) along ``spec`` and place each
    part on its shard's device, contiguous."""
    return _place(_split(x, mesh, spec), mesh, spec)


def _split(x, mesh: Mesh, spec: Spec) -> list:
    """The views of ``x`` that each rank holds."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    spec = _spec(spec, x.dim())
    named = [a for a in spec if a is not None]
    if len(named) != len(set(named)):
        raise ValueError(f"partition spec {spec} names an axis twice")
    for dim, a in enumerate(spec):
        if a is None:
            continue
        if a not in mesh.shape:
            raise ValueError(f"partition spec {spec} names {a!r}, not an axis of {mesh}")
        if x.shape[dim] % mesh.shape[a]:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} is not divisible by mesh "
                             f"axis {a!r} of size {mesh.shape[a]}")
    views = []
    for coords in mesh.coords:
        v = x
        for dim, a in enumerate(spec):
            if a is not None:
                n = x.shape[dim] // mesh.shape[a]
                v = v.narrow(dim, coords[a] * n, n)
        views.append(v)
    return views


def _place(views: list, mesh: Mesh, spec: Spec) -> ShardedTensor:
    return ShardedTensor(mesh, spec, [v.to(d).contiguous()
                                      for v, d in zip(views, mesh.device_list)])


def run_sharded(fn: Callable, mesh: Mesh, in_spec, out_spec: Spec) -> Callable:
    """``fn`` over ``mesh``, as ``shard_map``: the returned callable takes a
    tensor (or NumPy array), splits it along ``in_spec``, calls ``fn`` on
    each shard's part on its device and assembles the parts of the result
    along ``out_spec`` into one tensor on the mesh's first device.  Given a
    :class:`ShardedTensor` split along ``in_spec`` it uses the parts where
    they lie and returns the result as a :class:`ShardedTensor`.

    ``in_spec`` a list of specs, one an input (as ``shard_map``'s
    ``in_specs``): the callable takes that many inputs and ``fn`` gets each
    shard's part of each; the result is a :class:`ShardedTensor` when every
    input is one.  A tuple is one spec."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
    specs = in_spec if isinstance(in_spec, list) else [in_spec]

    def parts(x, spec) -> list:
        if isinstance(x, ShardedTensor):
            if x.mesh is not mesh or x.spec != _spec(spec, x.ndim):
                raise ValueError(f"input split as {x.spec} over {x.mesh}; this call takes "
                                 f"{_spec(spec, x.ndim)} over {mesh}")
            return x.blocks
        return device_put(x, mesh, spec).blocks

    def call(*xs):
        if len(xs) != len(specs):
            raise TypeError(f"this sharded call takes {len(specs)} inputs, got {len(xs)}")
        blocks = [parts(x, spec) for x, spec in zip(xs, specs)]
        outs = mesh._run(lambda own: fn(*own), list(zip(*blocks)))
        result = ShardedTensor(mesh, out_spec, outs)
        return result if all(isinstance(x, ShardedTensor) for x in xs) else result.gather()

    return call
