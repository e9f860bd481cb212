"""The median networks of ``csrc/median.cu`` (K6) and ``csrc/fused.cu``
(K14) as data, and the generator of ``csrc/median_networks.cuh``.

    python -m imageenhancement_mp_tpu_torch.kernels.median_networks

rewrites the header from the schedules built here.  The module is plain
Python (no torch): the CPU tests prove every schedule right (the 0-1
principle over every 0/1 window, and random windows with ties) and check
that the committed header is this module's rendering byte for byte, so the
card runs the network that was proved.

A schedule is a list of ``min``, ``max``, ``min3`` and ``max3`` operations in
static single assignment over the taps of a footprint.  Its design follows
A. Adams, "Fast Median Filters Using Separable Sorting Networks", ACM TOG
40(4), SIGGRAPH 2021: work that neighbouring windows share is done once.

* A thread computes a 2 x 2 tile of outputs in each 16-bit lane.  The two
  output rows share k - 1 rows of every window (the core); each output adds
  its own top or bottom row.
* The core's columns are sorted once per footprint column, then merged
  across columns (Batcher's odd-even merge).  Neighbouring output columns
  share k - 1 columns: the even output merges its own first column onto the
  shared k - 1, the odd one its own last column.  The extra rows are merged
  across columns the same way.
* Each output is then one rank selection from two sorted lists: the median
  is ``max over i + j = m of min(a_i, b_j)`` (``m = k*k // 2``, an index past
  a list's end reads +inf), so it costs one ``min`` per term and a ``max3``
  tree.
* Every operation whose result cannot reach an output is pruned; a ``min``
  or ``max`` whose only use is another of its kind fuses into ``min3`` or
  ``max3`` (one VIMNMX3 instruction on sm_90).

Each output's dependency cone lies inside its own k x k window, so the same
schedule is right at any position of any plane.  The single-output schedules
(a 1 x 1 tile) serve ``fused.cu``'s entries at REFLECT_101-mapped
coordinates, which are not laid out as tiles.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Schedule", "SCHEDULES", "TILE", "build_schedule", "cone", "evaluate", "render",
           "HEADER"]

HEADER = Path(__file__).resolve().parent / "csrc" / "median_networks.cuh"
TILE = 2  # outputs per lane along each axis

# A wire is ("t", r, c): the tap at footprint row r, column c; or ("v", i):
# the result of operation i.
Wire = tuple


@dataclass(frozen=True)
class Schedule:
    """``ops[i] = (kind, args)`` defines wire ("v", i); ``outputs`` maps each
    output (r, c) of the tile to its wire.  Output (r, c)'s window is
    footprint rows r .. r + k - 1 and columns c .. c + k - 1."""

    name: str
    k: int
    rows: int
    cols: int
    ops: tuple
    outputs: tuple

    @property
    def footprint(self) -> tuple[int, int]:
        return self.rows + self.k - 1, self.cols + self.k - 1

    @property
    def ops_per_output(self) -> float:
        return len(self.ops) / (self.rows * self.cols)

    def window(self, r: int, c: int) -> frozenset:
        return frozenset(("t", r + i, c + j) for i in range(self.k) for j in range(self.k))


class _Builder:
    """Static single assignment with common subexpressions merged."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []
        self._memo: dict[tuple, Wire] = {}

    def op(self, kind: str, *args: Wire) -> Wire:
        args = tuple(sorted(set(args)))
        if len(args) == 1:
            return args[0]
        key = (kind, args)
        if key not in self._memo:
            self._memo[key] = ("v", len(self.ops))
            self.ops.append(key)
        return self._memo[key]

    def merge(self, a: list, b: list) -> list:
        """Batcher's odd-even merge of two sorted lists."""
        if not a or not b:
            return list(a or b)
        if len(a) == 1 and len(b) == 1:
            return [self.op("min", a[0], b[0]), self.op("max", a[0], b[0])]
        even = self.merge(a[0::2], b[0::2])
        odd = self.merge(a[1::2], b[1::2])
        out = [even[0]]
        for i in range(1, max(len(even), len(odd) + 1)):
            if i < len(even) and i - 1 < len(odd):
                out += [self.op("min", odd[i - 1], even[i]), self.op("max", odd[i - 1], even[i])]
            else:
                out.append(even[i] if i < len(even) else odd[i - 1])
        return out

    def select(self, a: list, b: list, m: int) -> Wire:
        """The m-th smallest (from 0) of sorted a and sorted b together."""
        terms = []
        for i in range(max(0, m - len(b)), min(m, len(a)) + 1):
            j = m - i
            terms.append(a[i] if j == len(b) else b[j] if i == len(a) else
                         self.op("min", a[i], b[j]))
        return self.op("max", *terms)


def _split(lo: int, hi: int, k: int) -> int:
    """Where a range of footprint rows or columns splits: a whole window
    peels its own end (the first for an even start, the last for an odd one)
    off the k - 1 it shares with its neighbour; a shorter range splits in
    the middle."""
    if hi - lo == k:
        return lo + 1 if lo % 2 == 0 else hi - 1
    return lo + (hi - lo) // 2


def _lower(ops: list, outputs: dict) -> tuple[tuple, dict]:
    """Prune what no output reads, split n-ary maxima into a max3 tree, fuse
    a binary min/max whose only use is another of its kind into min3/max3,
    and renumber in topological order."""
    live, stack = set(), [w for w in outputs.values() if w[0] == "v"]
    while stack:
        i = stack.pop()[1]
        if i not in live:
            live.add(i)
            stack += [a for a in ops[i][1] if a[0] == "v"]
    # new graph: node id -> [kind, args]; the old ops keep their ids
    nodes = {i: [ops[i][0], list(ops[i][1])] for i in sorted(live)}
    next_id = len(ops)
    for i in sorted(live):
        kind, args = nodes[i]
        while len(args) > 3:
            groups = [args[j:j + 3] for j in range(0, len(args), 3)]
            args = []
            for g in groups:
                if len(g) == 1:
                    args.append(g[0])
                else:
                    nodes[next_id] = [kind, g]
                    args.append(("v", next_id))
                    next_id += 1
        nodes[i][1] = args
    uses: dict[int, int] = {}
    for kind, args in nodes.values():
        for a in args:
            if a[0] == "v":
                uses[a[1]] = uses.get(a[1], 0) + 1
    for w in outputs.values():
        if w[0] == "v":
            uses[w[1]] = uses.get(w[1], 0) + 1
    for i in sorted(nodes):
        if i not in nodes or len(nodes[i][1]) != 2:
            continue
        kind, args = nodes[i]
        for a in args:
            inner = nodes.get(a[1]) if a[0] == "v" else None
            if inner and inner[0] == kind and len(inner[1]) == 2 and uses[a[1]] == 1:
                nodes[i][1] = sorted(set([b for b in args if b != a] + inner[1]))
                del nodes[a[1]]
                break
    # topological order: depth-first from the outputs
    index: dict[int, int] = {}
    final: list[tuple] = []

    def emit(w: Wire) -> Wire:
        if w[0] == "t":
            return w
        if w[1] not in index:
            kind, args = nodes[w[1]]
            new_args = tuple(emit(a) for a in args)
            index[w[1]] = len(final)
            final.append((kind + ("3" if len(args) == 3 else ""), new_args))
        return ("v", index[w[1]])

    new_outputs = {rc: emit(w) for rc, w in outputs.items()}
    return tuple(final), new_outputs


def build_schedule(k: int, rows: int, cols: int) -> Schedule:
    """The schedule of a ``rows`` x ``cols`` tile of k x k medians (k odd;
    rows, cols in {1, 2})."""
    b = _Builder()

    @functools.cache
    def merged(r0: int, r1: int, c0: int, c1: int) -> tuple:
        """The taps of footprint rows r0..r1-1, columns c0..c1-1, sorted."""
        if r1 - r0 == 1 and c1 - c0 == 1:
            return (("t", r0, c0),)
        if c1 - c0 == 1:
            m = (r0 + r1) // 2
            return tuple(b.merge(list(merged(r0, m, c0, c1)), list(merged(m, r1, c0, c1))))
        m = _split(c0, c1, k)
        return tuple(b.merge(list(merged(r0, r1, c0, m)), list(merged(r0, r1, m, c1))))

    outputs = {}
    for r in range(rows):
        for c in range(cols):
            # the window's own row and the k - 1 rows it shares with the other output row
            m = _split(r, r + k, k) if rows > 1 else r + 1
            outputs[(r, c)] = b.select(list(merged(r, m, c, c + k)),
                                       list(merged(m, r + k, c, c + k)), k * k // 2)
    ops, outs = _lower(b.ops, outputs)
    kind = "tile" if rows * cols > 1 else "single"
    return Schedule(f"median_{kind}{k}", k, rows, cols, ops, tuple(sorted(outs.items())))


SCHEDULES = tuple(build_schedule(k, n, n) for n in (TILE, 1) for k in (5, 3))


def cone(s: Schedule, out: Wire) -> frozenset:
    """The taps that wire ``out`` depends on."""
    taps, seen, stack = set(), set(), [out]
    while stack:
        w = stack.pop()
        if w[0] == "t":
            taps.add(w)
        elif w[1] not in seen:
            seen.add(w[1])
            stack += s.ops[w[1]][1]
    return frozenset(taps)


def evaluate(s: Schedule, tap, mn, mx) -> dict:
    """Run the schedule: ``tap(r, c)`` gives a footprint tap's value,
    ``mn``/``mx`` are binary min and max; returns {(r, c): value}."""
    vals: list = []

    def get(w: Wire):
        return tap(w[1], w[2]) if w[0] == "t" else vals[w[1]]

    for kind, args in s.ops:
        f = mn if kind.startswith("min") else mx
        v = get(args[0])
        for a in args[1:]:
            v = f(v, get(a))
        vals.append(v)
    return {rc: get(w) for rc, w in s.outputs}


_PREAMBLE = """\
// Generated by imageenhancement_mp_tpu_torch/kernels/median_networks.py from
// the schedules it builds; do not edit.  Re-render with
//   python -m imageenhancement_mp_tpu_torch.kernels.median_networks
// tests/test_torch_median_networks.py proves every output of every schedule
// on every 0/1 window (the 0-1 principle) and checks that this file is the
// module's rendering.
//
// median_tile<K, V>: the K x K medians of a 2 x 2 tile of outputs from a
// (K + 1) x (K + 1) footprint t, in each lane of V.  Window (r, c) is
// t[r .. r + K - 1][c .. c + K - 1].  The two output rows share K - 1 rows
// of every window and neighbouring columns K - 1 columns; the schedule sorts
// and merges those once (A. Adams, "Fast Median Filters Using Separable
// Sorting Networks", ACM TOG 40(4), 2021).
// median_single<K, V>: one K x K median (fused.cu's reflected entries).
//
{counts}
#pragma once

#include <cstdint>

namespace {{

// Two 16-bit lanes per register, so one VIMNMX orders two pixels: unsigned
// lanes for u8 (widened) and u16, signed lanes for i16.  The three-way forms
// are one VIMNMX3 each on sm_90.
struct LanesU16 {{
  using T = uint32_t;
  static __device__ __forceinline__ T mn(T a, T b) {{ return __vminu2(a, b); }}
  static __device__ __forceinline__ T mx(T a, T b) {{ return __vmaxu2(a, b); }}
  static __device__ __forceinline__ T mn3(T a, T b, T c) {{ return __vimin3_u16x2(a, b, c); }}
  static __device__ __forceinline__ T mx3(T a, T b, T c) {{ return __vimax3_u16x2(a, b, c); }}
}};

struct LanesS16 {{
  using T = uint32_t;
  static __device__ __forceinline__ T mn(T a, T b) {{ return __vmins2(a, b); }}
  static __device__ __forceinline__ T mx(T a, T b) {{ return __vmaxs2(a, b); }}
  static __device__ __forceinline__ T mn3(T a, T b, T c) {{ return __vimin3_s16x2(a, b, c); }}
  static __device__ __forceinline__ T mx3(T a, T b, T c) {{ return __vimax3_s16x2(a, b, c); }}
}};

// One value per register (any of u8, u16, i16 held as int).
struct ScalarInt {{
  using T = int;
  static __device__ __forceinline__ T mn(T a, T b) {{ return min(a, b); }}
  static __device__ __forceinline__ T mx(T a, T b) {{ return max(a, b); }}
  static __device__ __forceinline__ T mn3(T a, T b, T c) {{ return __vimin3_s32(a, b, c); }}
  static __device__ __forceinline__ T mx3(T a, T b, T c) {{ return __vimax3_s32(a, b, c); }}
}};

// A thread's 2 x 4 outputs: lane 0 holds columns 0 and 1, lane 1 columns 2
// and 3, so footprint column j pairs the staged elements e[j] (lane 0) and
// e[j + 2] (lane 1).  lane_pairs forms the six pairs of e[0..7] from two
// 32-bit (u8) or 64-bit (u16, i16) shared-memory loads; p is 4- (u8) or
// 8-byte (16-bit) aligned.  u8 is widened into the 16-bit lanes.
__device__ __forceinline__ void lane_pairs(const uint8_t* p, uint32_t (&q)[6]) {{
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 4);
  const uint32_t mid = __byte_perm(w0, w1, 0x5432);  // e2 e3 e4 e5
  q[0] = __byte_perm(w0, 0, 0x4240);
  q[1] = __byte_perm(w0, 0, 0x4341);
  q[2] = __byte_perm(mid, 0, 0x4240);
  q[3] = __byte_perm(mid, 0, 0x4341);
  q[4] = __byte_perm(w1, 0, 0x4240);
  q[5] = __byte_perm(w1, 0, 0x4341);
}}

template <typename T16>
__device__ __forceinline__ void lane_pairs(const T16* p, uint32_t (&q)[6]) {{
  static_assert(sizeof(T16) == 2, "16-bit elements");
  const uint2 a = *reinterpret_cast<const uint2*>(p);      // e0 e1 | e2 e3
  const uint2 b = *reinterpret_cast<const uint2*>(p + 4);  // e4 e5 | e6 e7
  q[0] = __byte_perm(a.x, a.y, 0x5410);
  q[1] = __byte_perm(a.x, a.y, 0x7632);
  q[2] = __byte_perm(a.y, b.x, 0x5410);
  q[3] = __byte_perm(a.y, b.x, 0x7632);
  q[4] = __byte_perm(b.x, b.y, 0x5410);
  q[5] = __byte_perm(b.x, b.y, 0x7632);
}}

// Output column e (0..3) of an output row of the tile: lane e >> 1 of o[e & 1].
__device__ __forceinline__ uint32_t lane_output(const uint32_t (&o)[2], int e) {{
  return (o[e & 1] >> (16 * (e >> 1))) & 0xffffu;
}}
"""

_CALL = {"min": "mn", "max": "mx", "min3": "mn3", "max3": "mx3"}


def _render_schedule(s: Schedule) -> str:
    fh, fw = s.footprint
    name = lambda w: f"t[{w[1]}][{w[2]}]" if w[0] == "t" else f"v{w[1]}"  # noqa: E731
    if s.rows * s.cols > 1:
        sig = (f"__device__ __forceinline__ void {s.name}(const typename V::T (&t)[{fh}][{fw}], "
               f"typename V::T (&o)[{s.rows}][{s.cols}]) {{")
    else:
        sig = f"__device__ __forceinline__ typename V::T {s.name}(const typename V::T (&t)[{fh}][{fw}]) {{"
    lines = ["", "template <class V>", sig, "  using T = typename V::T;"]
    for i, (kind, args) in enumerate(s.ops):
        lines.append(f"  const T v{i} = V::{_CALL[kind]}({', '.join(map(name, args))});")
    if s.rows * s.cols > 1:
        lines += [f"  o[{r}][{c}] = {name(w)};" for (r, c), w in s.outputs]
    else:
        lines.append(f"  return {name(s.outputs[0][1])};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def render() -> str:
    """The text of ``csrc/median_networks.cuh``."""
    counts = "\n".join(
        f"// {s.name}: {s.rows}x{s.cols} outputs, {len(s.ops)} operations, "
        f"{s.ops_per_output:g} per output" + (" (two lanes: half an instruction each)"
                                              if s.rows * s.cols > 1 else "")
        for s in SCHEDULES)
    body = "".join(_render_schedule(s) for s in SCHEDULES)
    tail = """
template <int K, class V>
__device__ __forceinline__ void median_tile(const typename V::T (&t)[K + 1][K + 1],
                                            typename V::T (&o)[2][2]) {
  if constexpr (K == 3) {
    median_tile3<V>(t, o);
  } else {
    median_tile5<V>(t, o);
  }
}

template <int K, class V>
__device__ __forceinline__ typename V::T median_single(const typename V::T (&t)[K][K]) {
  if constexpr (K == 3) {
    return median_single3<V>(t);
  } else {
    return median_single5<V>(t);
  }
}

}  // namespace
"""
    return _PREAMBLE.format(counts=counts) + body + tail


if __name__ == "__main__":
    HEADER.write_text(render())
    for s in SCHEDULES:
        print(f"{s.name}: {len(s.ops)} operations, {s.ops_per_output:g} per output")
