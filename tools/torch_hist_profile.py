#!/usr/bin/env python3
"""K1's two counting kernels of the port (hist256, hist256_tiles) and the
main paths they serve, on one CUDA card: trees timed in turns, then each
tree profiled.

    git archive HEAD imageenhancement_mp_tpu_torch | tar -x -C build/parent
    python3 tools/torch_hist_profile.py [--parent build/parent] [--tree LABEL=PATH ...]
    python3 tools/torch_hist_profile.py --ab

Each tree (the parent under ``--parent``, any ``--tree``, this checkout) is
timed in a process of its own, in the order parent, trees, this, then back
(parent, this, this, parent for two): hist256 on 8x1080x1920 and
hist256_tiles on 2x2160x3840 (grid 8x8), each on random, smooth and
constant planes (chip_smoke.py::k1_planes, numpy seed 61), each call with
its output's zero fill; equalize_unsharp on 8x1080x1920 and config 5
(get_preset("denoise_clahe_sharpen")) on 2x2160x3840, random.  Each is the
median of 20 runs of 10 calls between CUDA events, back to back and
device-paced (a sleep kernel holds the device while the host enqueues the
run, so the events see the kernels alone).  Then, for each tree,
equalize_unsharp and config 5 under torch.profiler: device time per call by
kernel, the device's busy share, the host's enqueue time per call.

The fused kernels (hist256_lut through hist256_equalize_lut, 8x1080x1920;
tile_luts256, config 5's tiles at clip 2.0) are timed on the three kinds
of plane beside them; a tree without them (the parent) runs its own route
there, the zero fill, the count kernel and the 256-entry scan kernel.
Each measuring process also reads the host's enqueue time per call of
both paths (10 calls between two host clock reads, the device left to run
them), so ``--turns N`` (N rounds of parent, this, this, parent) gives 2N
processes per tree.

    python3 tools/torch_hist_profile.py --abfold --parent build/parent
    python3 tools/torch_hist_profile.py --host --parent build/parent

``--host`` prints, per tree in turns, the host's us per call of hist256,
the fused count + LUT and tiles + LUT wrappers (the parent's three-op
routes there), equalize_lut256 and their pieces (torch.empty and
torch.zeros of a histogram, the current stream's handle two ways, the
handoff's scratch and counters), with the launch made and stubbed.

``--abfold`` times the fused kernels, the count-only kernels and both
paths device-paced, each held to its plain version first, in this
checkout (design (b): each block's 256 partial bins stored whole into
scratch rows, the group's last block summing them in 16-byte loads) and in
copies with one choice of the handoff changed (FOLD_AB_VARIANTS: (a)
atomics into a per-stream accumulator kept at zero, read back by the last
block; (b) with the first scalar tail, or 4 or 16 loads in flight; (c) the
tiles' band blocks as one thread-block cluster summing through
distributed shared memory, no ticket), and the parent, in turns.

``--ab`` instead times this checkout against copies of it under
``build/hist_ab/`` with one design choice changed each (AB_VARIANTS, text
edits of ``csrc/hist_count.cuh``, ``kernels/hist.py`` and
``kernels/clahe.py``; only ``hist.cu`` and ``clahe.cu`` are built in the
copies), and the parent under ``--parent`` if given, in turns (this,
copies, parent, then back): both kernels on the three kinds of plane,
device-paced, each held to its plain version first; then the SASS opcode
histogram of both kernels in this tree and in the copy with design (a).
The copies of designs (a), (b) and (c) carry their counters' code (_WARP,
_COUNT_BYTES, _MATCH); the shipped header holds design (d), a copy of the
bins per lane index.

u16 CLAHE:

    python3 tools/torch_hist_profile.py --u16 --parent build/parent
    python3 tools/torch_hist_profile.py --ab16 --parent build/parent

``--u16`` replaces K1's cases: each tree's u16 stage A (hist65536_tiles,
or tile_hists_plain in a tree without it), stages A and B (tile_luts65536,
or hist65536_tiles then clahe_lut), the u16 blend and the whole
clahe call on 2x2160x3840 (grid 8x8) on random, smooth, constant and
12-bit planes (chip_smoke.py::u16_planes), pooled equalize_hist on
8x1080x1920 gray and RGB, and _lut_cases: clahe_lut at
S = 65536 on those planes' tiles and at S = 256 on config 5's, K5 and K13
(apply_lut256 with u8, f32 and i16 tables, warm and L2-cold;
apply_luts_multi K = 9 with u8 and f32 tables) on 8x1080x1920, in turns,
back to back and device-paced; then each tree's clahe u16 and pooled
equalize_hist calls under torch.profiler.

    python3 tools/torch_hist_profile.py --ablut --parent build/parent

``--ablut`` times _lut_cases device-paced in this checkout against copies
with one choice of stage B at S = 65536 (cluster size, threads a block) or
of K5's wide route (chunks in flight, blocks a SM, streaming stores)
changed each (LUT_AB_VARIANTS), and the parent, in turns, each held to its
plain versions first.  ``--ab16`` times
u16 stage A and the u16 blend on the five kinds of plane in this checkout
against copies with one design choice changed each (_ab16_variants: chunk
size, pixels and threads a block, four-array staging, the walk without the
one-chunk path, † copies without staging loads or blend arithmetic; stage
A's cluster of 4 blocks a tile, its threads and loads, the flat-vector
atomic, vectors of two values in two adds, constant-increment adds, and
its first cluster design, the value split with remote atomics), and
the parent with ``--parent``, in turns; stage A and stages A + B
(``tile_luts65536``, or a tree's ``hist65536_tiles`` then ``clahe_lut``)
each held to their plain versions first.  A copy that does not build or
run is reported and skipped.  Every line carries the card's name and power
limit.  Exits non-zero when torch sees no CUDA device.
"""
import argparse
import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "imageenhancement_mp_tpu_torch"
CALLS, RUNS = 10, 20
SLEEP_CYCLES = 4_000_000  # about 2 ms at 1.98 GHz: longer than the host's enqueue of CALLS calls
KINDS = ("random", "smooth", "constant")

_H, _KH, _KC = "kernels/csrc/hist_count.cuh", "kernels/hist.py", "kernels/clahe.py"
_HC, _CC = "kernels/csrc/hist.cu", "kernels/csrc/clahe.cu"
_STRUCT = "struct HistCounter {"
# (b): per-thread 8-bit counters.  Thread t owns the word column cnt[v >> 2][t]
# and adds 1 << 8 (v & 3) with a load, add and store (or one atomicAdd):
# every lane of a warp hits its own bank.  Rounds of 15 vectors (240 pixels)
# per thread keep each counter below 256; flush() then sums them into a
# register total of bin threadIdx.x (16-bit lanes, at most 61440).  Odd
# bytes go to 256 shared 32-bit bins after the counters.
_COUNT_BYTES = r"""
template <bool kAtomic>
struct CountBytes {
  static constexpr int kSmemBytes = 64 * kCountThreads * 4 + 256 * 4;
  uint32_t* cnt;
  uint32_t* extra;
  uint32_t total;
  __device__ __forceinline__ void begin(uint32_t* smem) {
    cnt = smem;
    extra = smem + 64 * kCountThreads;
    total = 0;
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += kCountThreads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void add_one(uint32_t v) { atomicAdd(&extra[v], 1u); }
  __device__ __forceinline__ void add_word(uint32_t* col, uint32_t w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = (w >> (8 * i)) & 255u;
      if (kAtomic) atomicAdd(&col[(v >> 2) * kCountThreads], 1u << ((v & 3u) * 8));
      else col[(v >> 2) * kCountThreads] += 1u << ((v & 3u) * 8);
    }
  }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    uint32_t* col = cnt + threadIdx.x;
    add_word(col, v.x);
    add_word(col, v.y);
    add_word(col, v.z);
    add_word(col, v.w);
  }
  __device__ __forceinline__ void flush() {
    __syncthreads();
    const int t = threadIdx.x, j = t & 3, row = t >> 2;
    uint4* words = reinterpret_cast<uint4*>(cnt + row * kCountThreads);
    uint32_t lo = 0, hi = 0;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const int q = 4 * ((k + row) & 15) + j;
      const uint4 w = words[q];
      words[q] = make_uint4(0, 0, 0, 0);
      lo += (w.x & 0x00FF00FFu) + (w.y & 0x00FF00FFu) + (w.z & 0x00FF00FFu) + (w.w & 0x00FF00FFu);
      hi += ((w.x >> 8) & 0x00FF00FFu) + ((w.y >> 8) & 0x00FF00FFu) +
            ((w.z >> 8) & 0x00FF00FFu) + ((w.w >> 8) & 0x00FF00FFu);
    }
    lo += __shfl_xor_sync(0xffffffffu, lo, 1);
    hi += __shfl_xor_sync(0xffffffffu, hi, 1);
    lo += __shfl_xor_sync(0xffffffffu, lo, 2);
    hi += __shfl_xor_sync(0xffffffffu, hi, 2);
    const uint32_t pick = (j & 1) ? hi : lo;
    total += (j & 2) ? pick >> 16 : pick & 0xFFFFu;
    __syncthreads();
  }
  __device__ __forceinline__ uint32_t bin_total() const { return total + extra[threadIdx.x]; }
};
"""
# (c): (a) with the lanes of one value found by __match_any_sync; every lane
# of the warp calls it together, an invalid lane with a key of its own
_MATCH = r"""
struct CountWarpMatch : CountWarpAtomics {
  __device__ __forceinline__ void add_one(uint32_t v, bool valid) {
    const uint32_t lane = threadIdx.x & 31;
    const uint32_t peers = __match_any_sync(0xffffffffu, valid ? v : 256u + lane);
    if (valid && lane == uint32_t(__ffs(peers) - 1)) atomicAdd(&mine[v], uint32_t(__popc(peers)));
  }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) add_one((w[i / 4] >> (8 * (i % 4))) & 255u, valid);
  }
};
"""
# (a): per-warp bins, the parent's scheme: each warp counts into its own 256
# bins with one shared atomic per pixel (lanes of one value merge in the
# atomic; lanes of different values in one bank take a pass each)
_WARP = r"""
struct CountWarpAtomics {
  static constexpr int kSmemBytes = (kCountThreads / 32) * 256 * 4;
  uint32_t* bins;
  uint32_t* mine;
  __device__ __forceinline__ void begin(uint32_t* smem) {
    bins = smem;
    mine = smem + (threadIdx.x >> 5) * 256;
    for (int i = threadIdx.x; i < kSmemBytes / 4; i += kCountThreads) smem[i] = 0;
  }
  __device__ __forceinline__ void add_one(uint32_t v) { atomicAdd(&mine[v], 1u); }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) add_one((w[i / 4] >> (8 * (i % 4))) & 255u);
  }
  __device__ __forceinline__ uint32_t bin_total() const {
    uint32_t s = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) s += bins[w * 256 + threadIdx.x];
    return s;
  }
};
"""
_LOOP = """  while (cur.ok[0]) {
    VecGroup<N> next;
    load(next);
#pragma unroll
    for (int u = 0; u < N; ++u) c.add_vec(cur.v[u], cur.ok[u]);
    cur = next;
  }"""
_ROUNDS = """  while (__syncthreads_or(cur.ok[0])) {
    for (int k = 0; k < 15; k += N) {
      VecGroup<N> next;
      load(next);
#pragma unroll
      for (int u = 0; u < N; ++u) c.add_vec(cur.v[u], cur.ok[u]);
      cur = next;
    }
    c.flush();
  }"""
_NO_COUNT = (_H, """    const uint32_t b = v.x & 255u;""", """    sink ^= v.x ^ v.y ^ v.z ^ v.w;
    if (sink != 0x9E3779B9u) return;
    const uint32_t b = v.x & 255u;""")
_NO_COUNT_SINK = (_H, "  uint32_t* mine;  // this lane's copy", "  uint32_t sink = 0;\n  uint32_t* mine;  // this lane's copy")
_NO_COUNT_TOTAL = (_H, "    return s;\n", "    return s + (sink == 0x9E3779B9u);\n")
# hashed in place of loaded: lane-varying bytes, about as spread as random data
_NO_LOADS = [(_HC, "__ldg(pv + i)", "make_uint4(uint32_t(i) * 2654435761u, uint32_t(i) * 2246822519u, "
              "uint32_t(i) * 3266489917u, uint32_t(i) * 668265263u)"),
             (_CC, "__ldg(row.vec() + j)", "make_uint4(uint32_t(j * 977 + q) * 2654435761u, "
              "uint32_t(j * 977 + q) * 2246822519u, uint32_t(j * 977 + q) * 3266489917u, "
              "uint32_t(j * 977 + q) * 668265263u)")]
_NO_FLAT = (_H, "    if (v.x == b * 0x01010101u && v.y == v.x && v.z == v.x && v.w == v.x) {",
            "    if (false) {")

def _between(rel: str, start: str, end: str, root: Path = ROOT) -> str:
    """The text of ``root``'s ``rel`` from ``start`` through ``end``."""
    text = (root / PKG / rel).read_text()
    i = text.index(start)
    return text[i:text.index(end, i) + len(end)]


def _counter(text: str, name: str, rounds: bool) -> list:
    """Edits that make ``name`` (defined by ``text``) the kernels' counter."""
    edits = [(_H, _STRUCT, "struct CountLaneCopies {"),
             (_H, "// N vectors of one thread", text + f"using HistCounter = {name};\n\n"
              "// N vectors of one thread")]
    return edits + ([(_H, _LOOP, _ROUNDS)] if rounds else [])


def _grid(blocks_per_sm: int) -> tuple:
    return (_KH, "HIST_GRID_BLOCKS = 3 * 132", f"HIST_GRID_BLOCKS = {blocks_per_sm} * 132")


# label -> (edits, whether the copy keeps the result); one design choice
# changed in each; the copies marked † count wrong on purpose, to show what
# the rest costs
AB_VARIANTS = {
    "(a) per-warp bins": (_counter(_WARP, "CountWarpAtomics", False), True),
    "(b) 8-bit counters, load-add-store": (_counter(_COUNT_BYTES, "CountBytes<false>", True), True),
    "(b) 8-bit counters, atomic adds": (_counter(_COUNT_BYTES, "CountBytes<true>", True), True),
    "(c) __match_any_sync before the atomic": (_counter(_WARP + _MATCH, "CountWarpMatch", False),
                                               True),
    "(d) without the flat-vector atomic": ([_NO_FLAT], True),
    "hist256 with 3 loads a group": ([(_HC, "kHistLoads = 1;", "kHistLoads = 3;")], True),
    "hist256_tiles with 1 load a group": ([(_CC, "kTileLoads = 3;", "kTileLoads = 1;")], True),
    "hist256_tiles without the aligned-row skip": ([(_CC, "ragged && r < nrows", "r < nrows")],
                                                   True),
    "grid of 2 blocks per SM": ([_grid(2)], True),
    "grid of 4 blocks per SM": ([_grid(4)], True),
    "† no counting (loads and walk only)": ([_NO_COUNT, _NO_COUNT_SINK, _NO_COUNT_TOTAL], False),
    "† no loads (walk and counting, hashed bytes)": (_NO_LOADS, False),
    "† neither (walk only)": ([_NO_COUNT, _NO_COUNT_SINK, _NO_COUNT_TOTAL] + _NO_LOADS, False),
}
# --- the handoff of the fused kernels (--abfold): copies of this tree
_TAIL = _between(_H, "  // tail: begin", "  // tail: end") if (ROOT / PKG / _H).is_file() else ""
_ACC = [  # (a): atomics into the group's accumulator row, kept at 0 between launches
    (_H, "  rows[int64_t(member) * 256 + t] = bin;", "  if (bin) atomicAdd(rows + t, bin);"),
    (_H, _TAIL, "  bin = __ldcg(rows + t);\n  rows[t] = 0;"),
    (_HC, "partial + b * gridDim.x * 256", "partial + b * 256"),
    (_CC, "partial + tile * gridDim.y * 256", "partial + tile * 256"),
    (_KH, """    n_rows = groups * members
    tickets = stream_workspace(device, groups, zeroed=True).data_ptr()""",
     """    acc = stream_workspace(device, groups * 257, zeroed=True)  # the rows, then the counters
    return None, acc.data_ptr(), acc.data_ptr() + groups * 256 * 4""")]
_SCALAR_TAIL = [(_H, _TAIL, """  uint32_t s = 0;
#pragma unroll 8
  for (int k = 0; k < members; ++k) s += __ldcg(rows + int64_t(k) * 256 + t);
  bin = s;""")]
_CLUSTER = [  # (c): a tile's band blocks as one cluster, no scratch and no ticket
    (_CC, """  if (!last_of_group(sum, partial + tile * gridDim.y * 256, blockIdx.y, gridDim.y,
                     tickets + tile))
    return;""", """  if (gridDim.y > 1) {
    __shared__ uint32_t ctot[256];
    cg::cluster_group cluster = cg::this_cluster();
    ctot[threadIdx.x] = sum;
    cluster.sync();
    if (cluster.block_rank() != 0) {
      cluster.sync();
      return;
    }
    uint32_t s = 0;
    for (int r = 0; r < int(gridDim.y); ++r) s += cluster.map_shared_rank(ctot, r)[threadIdx.x];
    sum = s;
    cluster.sync();
  }"""),
    (_CC, "  hist256_tiles_kernel<<<grid, kCountThreads", """  if (grid_y > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kCountThreads);
    cfg.dynamicSmemBytes = HistCounter::kSmemBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = unsigned(grid_y);
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, hist256_tiles_kernel, x, hist, lut, clip_abs,
                                             scale, partial, tickets, int(H), int(W), gh, gw,
                                             int(th), int(tw), int(band_rows), int(bands));
    return int(e != cudaSuccess ? e : cudaGetLastError());
  }
  hist256_tiles_kernel<<<grid, kCountThreads"""),
    ("kernels/clahe.py", "    return band_rows, bands, min(bands, MAX_GRID_Y)",
     "    return band_rows, bands, min(bands, 8)  # a portable cluster")]


def _tail_loads(n: int) -> list:
    return [(_H, "constexpr int kTailLoads = 8;", f"constexpr int kTailLoads = {n};")]


# label -> edits; this tree is design (b) with the 16-byte tail, 8 loads
# in flight a thread
FOLD_AB_VARIANTS = {
    "(a) atomics into a per-stream accumulator": _ACC,
    "(b) scalar tail, 8 loads in flight (first version)": _SCALAR_TAIL,
    "(b) 16-byte tail, 4 loads in flight": _tail_loads(4),
    "(b) 16-byte tail, 16 loads in flight": _tail_loads(16),
    "(c) tiles: a cluster of the band blocks (hist256 as (b))": _CLUSTER,
}
# --- u16 CLAHE (--ab16): copies of this tree
_B16, _KP = "kernels/csrc/clahe.cu", "kernels/clahe.py"


def _b16_const(name: str, old: int, new: int) -> tuple:
    return (_B16, f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def _b16_items(threads: int, vecs: int) -> tuple:
    return (_KP, "B16_ITEMS, B16_MAX_PIECE_VECS = 512 * 4, 256",
            f"B16_ITEMS, B16_MAX_PIECE_VECS = {threads} * {vecs}, 256")


# four-array staging: the four LUT rows' entries as they are (one 16-byte
# store each), a quad read as four 2-byte loads
_FOUR_ARRAYS = r"""__device__ __forceinline__ void stage_quads16(uint4* smem, const uint16_t* __restrict__ r00,
                                              const uint16_t* __restrict__ r01,
                                              const uint16_t* __restrict__ r10,
                                              const uint16_t* __restrict__ r11, int g) {
  smem[g] = __ldg(reinterpret_cast<const uint4*>(r00) + g);
  smem[kB16Chunk / 8 + g] = __ldg(reinterpret_cast<const uint4*>(r01) + g);
  smem[kB16Chunk / 4 + g] = __ldg(reinterpret_cast<const uint4*>(r10) + g);
  smem[3 * kB16Chunk / 8 + g] = __ldg(reinterpret_cast<const uint4*>(r11) + g);
}

// the staged quad of value v (in the chunk)
__device__ __forceinline__ uint2 quad_at(const uint4* smem, uint32_t v) {
  const uint16_t* s = reinterpret_cast<const uint16_t*>(smem);
  v &= kB16Chunk - 1;
  return make_uint2(s[v] | uint32_t(s[kB16Chunk + v]) << 16,
                    s[2 * kB16Chunk + v] | uint32_t(s[3 * kB16Chunk + v]) << 16);
}"""
# the first cluster design of stage A (rejected): the ranks split the value
# range, rank r's int32 counters in its shared memory, and each pixel added
# into its owner's counters, a peer's through distributed shared memory
_VALUE_SPLIT = r"""constexpr int kRankBins = 65536 / kHist16Ranks;
constexpr int kRoundPixels = 65535;     // (the launcher's round count; one round here)
constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }
constexpr int kRankShift = ilog2(kRankBins);

struct Count16 {
  static constexpr int kSmemBytes = kRankBins * 4;
  uint32_t* w;
  uint32_t rank;
  __device__ __forceinline__ void zero() {
    uint4* z = reinterpret_cast<uint4*>(w);
    for (int i = threadIdx.x; i < kSmemBytes / 16; i += kHist16Threads) z[i] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void add(uint32_t v, uint32_t n) {
    const uint32_t owner = v >> kRankShift;
    uint32_t* p = w + (v & (kRankBins - 1));
    if (owner == rank) {
      atomicAdd(p, n);
    } else {
      atomicAdd(cg::this_cluster().map_shared_rank(p, owner), n);
    }
  }
  __device__ __forceinline__ void add_one(uint32_t v) { add(v, 1u); }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    const uint32_t b = v.x & 0xffffu;
    if (v.x == b * 0x10001u && v.y == v.x && v.z == v.x && v.w == v.x) {
      add(b, 8u);
      return;
    }
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      add(q[i] & 0xffffu, 1u);
      add(q[i] >> 16, 1u);
    }
  }
};

template <bool kLut>
__global__ void __cluster_dims__(1, kHist16Ranks, 1)
__launch_bounds__(kHist16Threads, kHist16MinBlocks)
hist65536_tiles_kernel(const uint16_t* __restrict__ x, int32_t* __restrict__ hist,
                       uint16_t* __restrict__ lut, int32_t* __restrict__ scratch, int32_t clip_abs,
                       float scale, int H, int W, int gh, int gw, int th, int tw) {
  extern __shared__ __align__(16) uint32_t count_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  Count16 c;
  c.w = count_smem;
  c.rank = uint32_t(rank);
  c.zero();
  cluster.sync();
  const int64_t tile = blockIdx.x;
  const int ntiles = gh * gw;
  const int64_t b = tile / ntiles;
  const int t = int(tile - b * ntiles);
  const int ty = t / gw, tx = t - (t / gw) * gw;
  const uint16_t* plane = x + b * int64_t(H) * W;
  const Piece pc = tile_piece(plane, W, tx * tw, tw);
  const int share = th / kHist16Ranks + (th % kHist16Ranks != 0);
  const int64_t s0 = int64_t(rank) * share;
  const int r0 = s0 < th ? int(s0) : th;
  count_tile_rows<uint16_t, kHist16Loads, kHist16Threads / 32>(
      c, plane, H, W, ty * th + r0, min(share, th - r0), pc.c0, pc.len, pc.cp, pc.npad, pc.ragged);
  cluster.sync();
  if (!kLut) {
    const uint4* src = reinterpret_cast<const uint4*>(count_smem);
    uint4* dst = reinterpret_cast<uint4*>(hist + tile * 65536 + rank * kRankBins);
    for (int i = threadIdx.x; i < Count16::kSmemBytes / 16; i += kHist16Threads) dst[i] = src[i];
    return;
  }
  using L = Lut16Layout<kHist16Ranks, kHist16Threads>;
  const int i_lane = L::first_bin(rank);
  const int32_t* h = reinterpret_cast<const int32_t*>(count_smem) + (i_lane - rank * kRankBins);
  int32_t ex = 0, mine[L::kRounds], incl[L::kRounds];
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) {
    mine[r] = 0;
#pragma unroll
    for (int j = 0; j < kLut16Bins; ++j) {
      const int32_t v = h[r * 32 * kLut16Bins + j];
      if (clip_abs > 0) ex += max(v - clip_abs, 0);
      mine[r] += clip_abs > 0 ? min(v, clip_abs) : v;
    }
    incl[r] = warp_inclusive_scan(mine[r]);
  }
  int32_t wclip = 0;
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) wclip += __shfl_sync(0xffffffffu, incl[r], 31);
  const int2 ctx = tile_context<kHist16Ranks, L::kWarps>(wclip, warp_total(ex), rank, cluster);
  cluster_arrive();
  const int32_t raise = ctx.x >> 16, resid = ctx.x & 65535;
  const int step = max(65536 / max(resid, 1), 1);
  int32_t before = ctx.y;
  uint16_t* o = lut + tile * 65536 + i_lane;
#pragma unroll
  for (int r = 0; r < L::kRounds; ++r) {
    int32_t cr[kLut16Bins];
#pragma unroll
    for (int j = 0; j < kLut16Bins; ++j)
      cr[j] = clip_abs > 0 ? min(h[r * 32 * kLut16Bins + j], clip_abs) : h[r * 32 * kLut16Bins + j];
    int32_t cum = before + incl[r] - mine[r];
    *reinterpret_cast<uint4*>(o + r * 32 * kLut16Bins) =
        lut16_octet(cr, cum, i_lane + r * 32 * kLut16Bins, raise, resid, step, scale);
    before += __shfl_sync(0xffffffffu, incl[r], 31);
  }
  cluster_wait();
}
"""
# stage A's add (csrc/clahe.cu::Count16::add) and its merge's halves; as
# constant increments (+1 in a low half, 1 << 16 in a high one) with 0 and
# 65535 both in low halves (half16: the low half where v's lowest bit
# equals its highest)
_ADD16 = "    atomicAdd(&w[v >> 1], n << ((v & 1u) << 4));"
_ADD16_CONSTANT = """    uint32_t* p = &w[v >> 1];
    if ((v ^ (v >> 15)) & 1u) {
      atomicAdd(p, n << 16);
    } else {
      atomicAdd(p, n);
    }"""
_MERGE16 = """      c[2 * k] += int32_t(d[k] & 0xffffu);
      c[2 * k + 1] += int32_t(d[k] >> 16);"""
_MERGE16_HALF16 = """      const int32_t lo = int32_t(d[k] & 0xffffu), up = int32_t(d[k] >> 16);
      c[2 * k] += (i0 >> 15) ? up : lo;
      c[2 * k + 1] += (i0 >> 15) ? lo : up;"""
# a vector of 8 pixels of at most two values: one add each (pixel 0's
# value, and the first other one's), through 16-bit lane compares
_VEC16 = """    const uint32_t b = v.x & 0xffffu;
    if (v.x == b * 0x10001u && v.y == v.x && v.z == v.x && v.w == v.x) {
      add(b, 8u);
      return;
    }
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};"""
_VEC16_TWO = """    const uint32_t b = v.x & 0xffffu;
    const uint32_t q[4] = {v.x, v.y, v.z, v.w};
    uint32_t m0 = 0;  // bit k: pixel k equals pixel 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t e = __vcmpeq2(q[i], b * 0x10001u);
      m0 |= ((e & 1u) | ((e >> 15) & 2u)) << (2 * i);
    }
    if (m0 == 0xffu) {
      add(b, 8u);
      return;
    }
    const int k1 = __ffs(int(~m0 & 0xffu)) - 1;  // the first pixel of another value
    uint32_t w1 = q[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) w1 = (k1 >> 1) == i ? q[i] : w1;
    const uint32_t c1 = (k1 & 1) ? w1 >> 16 : w1 & 0xffffu;
    uint32_t m1 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t e = __vcmpeq2(q[i], c1 * 0x10001u);
      m1 |= ((e & 1u) | ((e >> 15) & 2u)) << (2 * i);
    }
    if ((m0 | m1) == 0xffu) {
      add(b, uint32_t(__popc(m0)));
      add(c1, uint32_t(__popc(m1)));
      return;
    }"""
_STAGE_A_START = "constexpr int kRankBins = 65536 / kHist16Ranks;"
_STAGE_A_END = "  cluster_wait();    // the cluster's reads of this block's counters and pair are done\n}\n"


def _stage_a(ranks: int, threads: int, min_blocks: int) -> list:
    return [_b16_const("kHist16Ranks", 2, ranks), _b16_const("kHist16Threads", 1024, threads),
            _b16_const("kHist16MinBlocks", 1, min_blocks)]


def _ab16_variants() -> dict:
    """label -> (edits, whether the copy keeps the result)."""
    one_sm = _b16_const("kB16MinBlocks", 2, 1)
    return {
        "chunks of 4096 values": ([_b16_const("kB16Shift", 13, 12)], True),
        "chunks of 16384 values, one block a SM": ([_b16_const("kB16Shift", 13, 14), one_sm],
                                                   True),
        "16 pixels a thread": ([_b16_const("kB16Vecs", 4, 2), _b16_items(512, 2)], True),
        "64 pixels a thread, one block a SM": ([_b16_const("kB16Vecs", 4, 8), one_sm,
                                                _b16_items(512, 8)], True),
        "1024 threads, one block a SM": ([_b16_const("kB16Threads", 512, 1024), one_sm,
                                          _b16_items(1024, 4)], True),
        "without the one-chunk path": ([(_B16, "if (__all_sync(0xffffffffu, all_here || ch < cmin"
                                         " || ch > cmax)) {", "if (false) {")], True),
        "four-array staging": ([
            (_B16, _between(_B16, "__device__ __forceinline__ void stage_quads16(", "\n}\n"),
             _FOUR_ARRAYS.split("\n\n// the staged quad")[0] + "\n"),
            (_B16, _between(_B16, "__device__ __forceinline__ uint2 quad_at(", "\n}\n"),
             _FOUR_ARRAYS.split("(in the chunk)\n")[1] + "\n")], True),
        "† staging without loads": ([(_B16, "const uint4 a = __ldg(reinterpret_cast<const uint4*>"
                                      "(r00) + g);", "const uint4 a = make_uint4(g, 1, 2, 3);")]
                                    + [(_B16, f"const uint4 {n} = __ldg(reinterpret_cast<const "
                                        f"uint4*>(r{i}) + g);", f"const uint4 {n} = a;")
                                       for n, i in (("b", "01"), ("c", "10"), ("d", "11"))],
                                    False),
        "† no blending": ([(_B16, "  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, "
                            "fy);\n", "  return q.x ^ q.y ^ __float_as_uint(fx) ^ "
                            "__float_as_uint(fy);\n  const float gx = __fsub_rn(1.0f, fx), gy = "
                            "__fsub_rn(1.0f, fy);\n")], False),
        # stage A's cluster (this tree: 2 blocks of 1024 threads a tile, one a SM)
        "stage A, R = 4 (a quarter of the rows a block)": (_stage_a(4, 1024, 1), True),
        "stage A, 512 threads": (_stage_a(2, 512, 1), True),
        "stage A, 512 threads, 4 loads a group": (_stage_a(2, 512, 1)
                                                   + [_b16_const("kHist16Loads", 2, 4)], True),
        "stage A, value split (each pixel into its owner's counters, remote atomics)": (
            [(_B16, _between(_B16, _STAGE_A_START, _STAGE_A_END), _VALUE_SPLIT)], True),
        "stage A, constant-increment adds, 0 and 65535 in low halves": (
            [(_B16, _ADD16, _ADD16_CONSTANT), (_B16, _MERGE16, _MERGE16_HALF16)], True),
        "stage A, a vector of two values in two adds": ([(_B16, _VEC16, _VEC16_TWO)], True),
        "stage A, 1 load a group": ([_b16_const("kHist16Loads", 2, 1)], True),
        "stage A, 4 loads a group": ([_b16_const("kHist16Loads", 2, 4)], True),
        "stage A without the flat-vector atomic": (
            [(_B16, "if (v.x == b * 0x10001u && v.y == v.x && v.z == v.x && v.w == v.x) {",
              "if (false) {")], True),
    }


# --- stage B at S = 65536 and K5's wide route (--ablut): copies of this tree
def _lut16(blocks: int, threads: int, min_blocks: int) -> list:
    return [(_CC, "constexpr int kLut16Blocks = 8;", f"constexpr int kLut16Blocks = {blocks};"),
            (_CC, "constexpr int kLut16Threads = 512;",
             f"constexpr int kLut16Threads = {threads};"),
            (_CC, "constexpr int kLut16MinBlocks = 3;",
             f"constexpr int kLut16MinBlocks = {min_blocks};")]


def _wide(loads: int = 4, per_sm: int = 8, streaming: bool = True) -> list:
    edits = [(_HC, "constexpr int kWideLoads = 4;", f"constexpr int kWideLoads = {loads};"),
             (_HC, "constexpr int kWideGrid = 8 * 132;",
              f"constexpr int kWideGrid = {per_sm} * 132;")]
    if not streaming:
        edits.append((_HC, "__stcs(dst + 32 * k + lane, map_vec(tab, w));",
                      "dst[32 * k + lane] = map_vec(tab, w);"))
    return edits


# this tree: stage B in clusters of 8 blocks of 512 threads, 3 blocks a SM;
# K5's wide route with 4 chunks in flight a warp, 8 blocks a SM in the grid,
# streaming stores
LUT_AB_VARIANTS = {
    "stage B, 2 blocks a SM (no register cap)": _lut16(8, 512, 1),
    "stage B, 4 blocks a SM (at most 32 registers)": _lut16(8, 512, 4),
    "stage B, 8 blocks of 256 threads (4 rounds), 6 a SM": _lut16(8, 256, 6),
    "stage B, 8 blocks of 1024 threads (1 round), 2 a SM": _lut16(8, 1024, 2),
    "stage B, clusters of 4 blocks of 1024 threads, 1 a SM": _lut16(4, 1024, 1),
    "stage B, clusters of 2 blocks of 1024 threads, 1 a SM": _lut16(2, 1024, 1),
    "K5 wide, plain stores": _wide(streaming=False),
    "K5 wide, 2 chunks in flight a warp": _wide(loads=2),
    "K5 wide, 8 chunks in flight a warp": _wide(loads=8),
    "K5 wide, 4 blocks a SM": _wide(per_sm=4),
    "K5 wide, 16 blocks a SM": _wide(per_sm=16),
    "K5 wide, 2 chunks in flight, 4 blocks a SM, plain stores (its first version)":
        _wide(loads=2, per_sm=4, streaming=False),
}


# the 8-bit counters take more than 48 KB of dynamic shared memory
_SMEM = [(path, f"  {kernel}<<<", "  cudaFuncSetAttribute(" + kernel +
          ", cudaFuncAttributeMaxDynamicSharedMemorySize, HistCounter::kSmemBytes);\n"
          f"  {kernel}<<<")
         for path, kernel in ((_HC, "hist256_kernel"), (_CC, "hist256_tiles_kernel"))]


def ab_tree(label: str, edits, source: Path = ROOT, keep=("hist.cu", "clahe.cu")) -> Path:
    """The package of ``source`` (this checkout) under build/hist_ab/ with
    ``edits`` applied, building only the sources in ``keep``."""
    out = ROOT / "build" / "hist_ab" / re.sub(r"\W+", "_", label).strip("_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(source / PKG, out / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for src in (out / PKG / "kernels" / "csrc").glob("*.cu"):
        if src.name not in keep:
            src.unlink()
    edits = list(edits) + _SMEM + [("kernels/_build.py", "        fn = getattr(lib, name)\n",
                            "        fn = getattr(lib, name, None)\n        if fn is None:\n"
                            "            continue\n")]
    for rel, old, new in edits:
        path = out / PKG / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"torch_hist_profile: --ab cannot patch {rel} for {label!r}")
        path.write_text(text.replace(old, new))
    return out


def _setup(root: Path):
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import imageenhancement_mp_tpu_torch as port

    assert Path(port.__file__).resolve().parent == root / PKG
    sys.path.insert(1, str(ROOT))
    from chip_smoke import k1_planes
    return np, torch, port, k1_planes


def _time_ms(torch, fn, device_paced: bool) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if device_paced:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def _kernel_cases(np, torch, k1_planes) -> dict:
    """name -> (kernel call, plain call) for both kernels on each kind of plane."""
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import hist as kh
    from imageenhancement_mp_tpu_torch.ops import clahe as tc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(61)
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    cases = {}
    for kind in KINDS:
        x8 = torch.from_numpy(k1_planes((8, 1080, 1920), kind, rng)).to(dev)
        g4 = torch.from_numpy(k1_planes((2, 2160, 3840), kind, rng)).to(dev)
        cases[f"hist256 8x1080x1920 {kind}"] = (lambda x=x8: kh.hist256(x),
                                                lambda x=x8: kh.hist256_plain(x))
        cases[f"hist256_tiles 2x2160x3840 8x8 {kind}"] = (
            lambda x=g4: kc.hist256_tiles(x, *geo), lambda x=g4: kc.tile_hists_plain(x, *geo))
    return cases


def _fold_cases(np, torch, k1_planes) -> dict:
    """name -> (call, plain call): the fused kernels, count + LUT on
    8x1080x1920 and tiles + LUT on config 5's 2x2160x3840 (grid 8x8, clip
    2.0), on each kind of plane (numpy seed 66).  A tree without them runs
    its own route: the fill, the count kernel, the scan kernel."""
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import hist as kh
    from imageenhancement_mp_tpu_torch.ops import clahe as tc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(66)
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    area = geo[2] * geo[3]
    eq = getattr(kh, "hist256_equalize_lut", None) or (
        lambda x: kh.equalize_lut256(kh.hist256(x), x[0].numel()))
    tl = getattr(kc, "tile_luts256", None) or (
        lambda x, *g: kc.clahe_lut(kc.hist256_tiles(x, *g[:4]), area, g[4]))
    cases = {}
    for kind in KINDS:
        x8 = torch.from_numpy(k1_planes((8, 1080, 1920), kind, rng)).to(dev)
        g4 = torch.from_numpy(k1_planes((2, 2160, 3840), kind, rng)).to(dev)
        cases[f"count + LUT 8x1080x1920 {kind}"] = (
            lambda x=x8: eq(x),
            lambda x=x8: kh.equalize_lut256_plain(kh.hist256_plain(x), x[0].numel()))
        cases[f"tiles + LUT 2x2160x3840 8x8 {kind}"] = (
            lambda x=g4: tl(x, *geo, 2.0),
            lambda x=g4: kc.clahe_lut_plain(kc.tile_hists_plain(x, *geo), area, 2.0))
    return cases


def _path_inputs(np, torch) -> tuple:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(62)
    x8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(dev)
    g4 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    return x8, g4


def _path_cases(np, torch, port) -> dict:
    x8, g4 = _path_inputs(np, torch)
    cfg5 = port.get_preset("denoise_clahe_sharpen")
    return {"equalize_unsharp 8x1080x1920": lambda: port.equalize_unsharp(x8),
            "config 5 2x2160x3840": lambda: cfg5(g4)}


def _u16_cases(np, torch, port) -> dict:
    """``--u16``: u16 CLAHE's stages and the whole clahe call on
    2x2160x3840 (grid 8x8), each on the planes of chip_smoke.py::u16_planes
    (numpy seed 63).  Stage A is the tree's own: hist65536_tiles where the
    tree has it, else tile_hists_plain (the parent's route on the card);
    stages A and B are _stages_ab.  Then pooled equalizeHist
    (``equalize_hist(x, per_frame=False)``) on 8x1080x1920 gray and RGB."""
    from chip_smoke import U16_PLANES, u16_planes
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.ops import clahe as tc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(63)
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    stage_a = getattr(kc, "hist65536_tiles", kc.tile_hists_plain)
    stages_ab = _stages_ab(kc, geo[2] * geo[3])
    tables = (*tc._coord_tables(2160, geo[2], 8, dev), *tc._coord_tables(3840, geo[3], 8, dev))
    cases = {}
    for kind in U16_PLANES[:4]:
        g = torch.from_numpy(u16_planes((2, 2160, 3840), kind, rng)).to(dev)
        h = stage_a(g, *geo)
        lut = kc.clahe_lut(h, geo[2] * geo[3], 2.0)
        cases[f"u16 stage A {kind}"] = lambda g=g: stage_a(g, *geo)
        cases[f"u16 stages A+B {kind}"] = lambda g=g: stages_ab(g, *geo, 2.0)
        cases[f"clahe_blend u16 {kind}"] = lambda g=g, lut=lut: kc.clahe_blend(g, lut, 8, 8,
                                                                               *tables)
        cases[f"clahe u16 2x2160x3840 {kind}"] = lambda g=g: port.clahe(g, 2.0, (8, 8))
    for shape in ((8, 1080, 1920), (8, 1080, 1920, 3)):
        x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        cases[f"pooled equalize_hist {'x'.join(map(str, shape))}"] = (
            lambda x=x: port.equalize_hist(x, per_frame=False))
    return cases


def _lut_cases(np, torch) -> dict:
    """``--u16`` and ``--ablut``: name -> (call, plain call).  K5 and K13 at
    chip_smoke.py's timed shape, 8x1080x1920 u8: apply_lut256 with [8, 256]
    u8 tables, apply_lut256_wide with f32 and i16 tables, apply_luts_multi
    with K = 9 u8 and f32 tables; K5 also L2-cold (each call takes the next
    of four inputs, 66 MB of planes, so its input left the 50 MB L2 since
    its last use); clahe_lut at S = 256 on config 5's tiles (2x2160x3840 u8,
    grid 8x8) and at S = 65536 on the u16 tiles of each kind of
    chip_smoke.py::u16_planes."""
    import itertools

    from chip_smoke import U16_PLANES, u16_planes
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import hist as kh
    from imageenhancement_mp_tpu_torch.ops import clahe as tc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(64)
    xs = [torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(dev)
          for _ in range(4)]
    x = xs[0]
    u8 = torch.from_numpy(rng.integers(0, 256, (8, 256), dtype=np.uint8)).to(dev)
    f32 = torch.from_numpy(rng.standard_normal((8, 256)).astype(np.float32)).to(dev)
    i16 = torch.from_numpy(rng.integers(-32768, 32768, (8, 256)).astype(np.int16)).to(dev)
    m8 = torch.from_numpy(rng.integers(0, 256, (8, 9, 256), dtype=np.uint8)).to(dev)
    m32 = torch.from_numpy(rng.standard_normal((8, 9, 256)).astype(np.float32)).to(dev)
    cases = {}
    for label, lut in (("apply_lut256 u8", u8), ("apply_lut256_wide f32", f32),
                       ("apply_lut256_wide i16", i16)):
        nxt = itertools.cycle(xs).__next__
        cases[f"{label} 8x1080x1920"] = (lambda lut=lut: kh.apply_lut256(x, lut),
                                         lambda lut=lut: kh.apply_lut256_plain(x, lut))
        cases[f"{label} 8x1080x1920 L2-cold"] = (
            lambda lut=lut, nxt=nxt: kh.apply_lut256(nxt(), lut),
            lambda lut=lut: kh.apply_lut256_plain(x, lut))
    for label, luts in (("u8", m8), ("f32", m32)):
        cases[f"apply_luts_multi K=9 {label} 8x1080x1920"] = (
            lambda luts=luts: kh.apply_luts_multi(x, luts),
            lambda luts=luts: kh.apply_luts_multi_plain(x, luts))
    # a yardstick, no kernel of the port: torch's fill of the f32 output
    # (66 MB written)
    out32 = torch.empty((8, 1080, 1920), dtype=torch.float32, device=dev)
    cases["torch fill_ of an [8, 1080, 1920] f32 tensor"] = (lambda: out32.fill_(1.0),
                                                              lambda: out32.fill_(1.0))
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    area = geo[2] * geo[3]
    g8 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    h8 = kc.tile_hists_plain(g8, *geo)
    cases["clahe_lut S=256 config 5 tiles"] = (lambda: kc.clahe_lut(h8, area, 2.0),
                                               lambda: kc.clahe_lut_plain(h8, area, 2.0))
    for kind in U16_PLANES[:4]:
        h = kc.tile_hists_plain(torch.from_numpy(u16_planes((2, 2160, 3840), kind, rng)).to(dev),
                                *geo)
        cases[f"clahe_lut S=65536 {kind}"] = (lambda h=h: kc.clahe_lut(h, area, 2.0),
                                              lambda h=h: kc.clahe_lut_plain(h, area, 2.0))
    return cases


def measure(root: Path, u16: bool) -> dict:
    """Back-to-back and device-paced times of every case in the tree under
    ``root`` (ms)."""
    np, torch, port, k1_planes = _setup(root)
    if u16:
        cases = {**_u16_cases(np, torch, port),
                 **{name: fn for name, (fn, _) in _lut_cases(np, torch).items()}}
    else:
        cases = {name: fn for name, (fn, _) in _kernel_cases(np, torch, k1_planes).items()}
        cases.update({name: fn for name, (fn, _) in _fold_cases(np, torch, k1_planes).items()})
        cases.update(_path_cases(np, torch, port))
    out = {}
    for name, fn in cases.items():
        out[f"{name}, back to back"] = _time_ms(torch, fn, False)
        out[f"{name}, device-paced"] = _time_ms(torch, fn, True)
    if not u16:
        for name, fn in _path_cases(np, torch, port).items():
            out[f"{name}, host us per call"] = _host_us(torch, fn)
    return out


def _host_us(torch, fn) -> float:
    """The host's enqueue time per call (us): the median over RUNS runs of
    CALLS calls between two host clock reads, the device left to run them
    and drained between runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def _stages_ab(kc, area: int):
    """u16 stages A and B of a tree: its ``tile_luts65536``, or (a tree
    without it) its ``hist65536_tiles`` then ``clahe_lut``."""
    fused = getattr(kc, "tile_luts65536", None)
    if fused is not None:
        return fused
    return lambda g, *geo: kc.clahe_lut(kc.hist65536_tiles(g, *geo[:4]), area, geo[4])


def _u16_kernel_cases(np, torch) -> dict:
    """``--ab16``: name -> (kernel call, plain call) for u16 stage A (the
    tree's own, as in _u16_cases), stages A and B (_stages_ab, clip 2.0)
    and the u16 blend on 2x2160x3840 (grid 8x8), on each kind of
    chip_smoke.py::u16_planes (numpy seed 65)."""
    from chip_smoke import U16_PLANES, u16_planes
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.ops import clahe as tc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(65)
    geo = tc.tile_geometry(2160, 3840, (8, 8))
    area = geo[2] * geo[3]
    stage_a = getattr(kc, "hist65536_tiles", kc.tile_hists_plain)
    stages_ab = _stages_ab(kc, area)
    tables = (*tc._coord_tables(2160, geo[2], 8, dev), *tc._coord_tables(3840, geo[3], 8, dev))
    cases = {}
    for kind in U16_PLANES:
        g = torch.from_numpy(u16_planes((2, 2160, 3840), kind, rng)).to(dev)
        lut = kc.clahe_lut(kc.tile_hists_plain(g, *geo), area, 2.0)
        cases[f"u16 stage A {kind}"] = (lambda g=g: stage_a(g, *geo),
                                        lambda g=g: kc.tile_hists_plain(g, *geo))
        cases[f"u16 stages A+B {kind}"] = (
            lambda g=g: stages_ab(g, *geo, 2.0),
            lambda g=g: kc.clahe_lut_plain(kc.tile_hists_plain(g, *geo), area, 2.0))
        cases[f"clahe_blend u16 {kind}"] = (
            lambda g=g, lut=lut: kc.clahe_blend(g, lut, 8, 8, *tables),
            lambda g=g, lut=lut: kc.clahe_blend_plain(g, lut, 8, 8, *tables))
    return cases


def measure_ab(root: Path, check: bool, u16: bool, lut: bool = False, fold: bool = False) -> dict:
    """Device-paced times of the kernels on each kind of plane in the tree
    under ``root`` (ms), each held to its plain version first where
    ``check``: K1's two (with ``u16``, u16 CLAHE's stage A and blend; with
    ``lut``, stage B and the LUT applies of _lut_cases)."""
    np, torch, _, k1_planes = _setup(root)
    out = {}
    cases = (_lut_cases(np, torch) if lut else _u16_kernel_cases(np, torch) if u16
             else _kernel_cases(np, torch, k1_planes))
    if fold:
        port = sys.modules["imageenhancement_mp_tpu_torch"]
        cases = {**_fold_cases(np, torch, k1_planes), **_kernel_cases(np, torch, k1_planes)}
        x8, g4 = _path_inputs(np, torch)
        cfg5 = port.get_preset("denoise_clahe_sharpen")
        cases["equalize_unsharp 8x1080x1920"] = (lambda: port.equalize_unsharp(x8),
                                                 lambda: _plain_equalize_unsharp(x8))
        cases["config 5 2x2160x3840"] = (lambda: cfg5(g4), lambda: _plain_config5(g4))
    for name, (fn, plain) in cases.items():
        got, want = fn(), plain()
        if isinstance(got, tuple):  # apply_luts_multi's K outputs
            got, want = torch.stack(got), torch.stack(want)
        if check and not torch.equal(got, want):
            raise SystemExit(f"torch_hist_profile: {name} differs from its plain version in {root}")
        out[name] = _time_ms(torch, fn, True)
    return out


def _plain_equalize_unsharp(x):
    """equalize_unsharp(x) through the plain versions of its kernels."""
    from imageenhancement_mp_tpu_torch.kernels import conv as kv
    from imageenhancement_mp_tpu_torch.kernels import hist as kh
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    luts = kh.equalize_lut256_plain(kh.hist256_plain(x), x[0].numel())
    return kv.sep_conv_u8_plain(x, *q8_taps(5, 0.0), 1.0, luts)


def _plain_config5(x):
    """Config 5 through the plain versions of its kernels."""
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import conv as kv
    from imageenhancement_mp_tpu_torch.kernels import median as km
    from imageenhancement_mp_tpu_torch.ops import clahe as tc
    from imageenhancement_mp_tpu_torch.ops.filters import q8_taps

    m = km.median_blur_plain(x, 5)
    B, H, W = m.shape
    gh, gw, th, tw = tc.tile_geometry(H, W, (8, 8))
    luts = kc.clahe_lut_plain(kc.tile_hists_plain(m, gh, gw, th, tw), th * tw, 2.0)
    tables = (*tc._coord_tables(H, th, gh, m.device), *tc._coord_tables(W, tw, gw, m.device))
    out = kc.clahe_blend_plain(m, luts, gh, gw, *tables)
    return kv.sep_conv_u8_plain(out, *q8_taps(5, 0.0), 1.0)


def profile(root: Path, label: str, smi: str, u16: bool) -> None:
    """torch.profiler split and busy share, and host enqueue time per call."""
    np, torch, port, _ = _setup(root)
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    paths = ({k: fn for k, fn in _u16_cases(np, torch, port).items()
              if k.startswith(("clahe u16", "pooled"))}
             if u16 else _path_cases(np, torch, port))
    for name, fn in paths.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(RUNS):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            enqueue.append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels: dict[str, list] = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                k = kernels.setdefault(ev.name, [0.0, 0])
                k[0] += ev.time_range.elapsed_us()
                k[1] += 1
        rows = sorted(((t, key, n) for key, (t, n) in kernels.items()), reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"[{label}] {name}: host enqueue {statistics.median(enqueue):.1f} us per call "
              f"(median of {RUNS} runs of {CALLS}); under torch.profiler {CALLS} calls: wall "
              f"{wall_us / CALLS:.1f} us per call, device busy {busy / CALLS:.2f} us per call "
              f"({100 * busy / wall_us:.1f} %)  [{smi}]")
        for dt, key, n in rows[:8]:
            print(f"    {dt / CALLS:9.2f} us per call  {100 * dt / busy:5.1f} %  x{n / CALLS:g}  "
                  f"{key[:90]}")


def sass(root: Path, label: str, u16: bool = False) -> None:
    """SASS opcode histogram of the two counting kernels (with ``u16``, of
    both instances of hist65536_tiles_kernel, stage B at S = 65536 and the
    u16 blend), and ptxas's registers and spills for them."""
    kernels = (r"(hist65536_tiles_kernel\w*|clahe_lut16_kernel|clahe_blend_u16_kernel\w*)" if u16
               else r"(hist256\w*kernel)")
    sys.path.insert(0, str(root))
    from imageenhancement_mp_tpu_torch.kernels import _build

    lib = Path(_build.library()._name)
    entry = ""
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif re.search(kernels, entry) and ("Used" in line or "spill" in line):
            print(f"[{label}] ptxas {re.search(kernels, entry).group(1)}: "
                  f"{line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(kernels, m.group(1))
            name = k.group(1) if k else None
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m and not m.group(1).startswith("NOP"):
            counts[name][m.group(1)] += 1
    for name, c in counts.items():
        print(f"[{label}] SASS {name}: {sum(c.values())} instructions besides NOPs; " +
              ", ".join(f"{op} {n}" for op, n in c.most_common(24)))


def host_probe(root: Path, label: str, smi: str) -> None:
    """``--host``: the host's time per call (us, median of 5 runs of 3000
    calls, each run drained) of the count wrappers and their pieces in the
    tree under ``root``, with the launch made and with it stubbed."""
    np, torch, _, _ = _setup(root)
    from imageenhancement_mp_tpu_torch import kernels as kp
    from imageenhancement_mp_tpu_torch.kernels import _build
    from imageenhancement_mp_tpu_torch.kernels import clahe as kc
    from imageenhancement_mp_tpu_torch.kernels import hist as kh

    dev = torch.device("cuda", 0)
    x, g = _path_inputs(np, torch)
    _build.library()

    def us(fn, n=3000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            runs.append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
        return statistics.median(runs)

    h = kh.hist256(x)
    eq = getattr(kh, "hist256_equalize_lut", None) or (lambda y: kh.equalize_lut256(kh.hist256(y),
                                                                                   y[0].numel()))
    tl = ((lambda y: kc.tile_luts256(y, 8, 8, 270, 480, 2.0)) if hasattr(kc, "tile_luts256") else
          (lambda y: kc.clahe_lut(kc.hist256_tiles(y, 8, 8, 270, 480), 270 * 480, 2.0)))
    cases = {
        "torch.empty((8, 256)) int32": lambda: torch.empty((8, 256), dtype=torch.int32, device=dev),
        "torch.zeros((8, 256)) int32": lambda: torch.zeros((8, 256), dtype=torch.int32, device=dev),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)": lambda: torch._C._cuda_getCurrentRawStream(0),
        "hist256(x)": lambda: kh.hist256(x),
        "count + LUT (x)": lambda: eq(x),
        "equalize_lut256(h)": lambda: kh.equalize_lut256(h, 1080 * 1920),
        "tiles + LUT (g)": lambda: tl(g),
    }
    if hasattr(kh, "handoff_scratch"):
        cases["handoff_scratch(dev, 8, 49)"] = lambda: kh.handoff_scratch(dev, 8, 49)
        cases["stream_workspace(dev, 8, zeroed=True)"] = lambda: kp.stream_workspace(dev, 8, True)
    out = {k: us(fn) for k, fn in cases.items()}
    for mod in (kh, kc):
        mod.launch = lambda *a: None
    for k in ("hist256(x)", "count + LUT (x)", "tiles + LUT (g)"):
        out[f"{k}, launch stubbed"] = us(cases[k])
    print(f"[{label}] host us per call: " + "; ".join(f"{k} {v:.2f}" for k, v in out.items())
          + f"  [{smi}]")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another tree, timed between the parent and this one")
    ap.add_argument("--u16", action="store_true",
                    help="u16 CLAHE's stages and call on five kinds of plane, and K5/K13, "
                         "in place of K1's cases")
    ap.add_argument("--ab", action="store_true",
                    help="time this checkout against copies with one design choice changed each")
    ap.add_argument("--ab16", action="store_true",
                    help="time this checkout against copies with one u16 CLAHE design choice "
                         "changed each, and the parent")
    ap.add_argument("--ablut", action="store_true",
                    help="time this checkout against copies with one choice of stage B at "
                         "S = 65536 or of K5's wide route changed each, and the parent")
    ap.add_argument("--abfold", action="store_true",
                    help="time the fused kernels and both paths in this checkout against copies "
                         "with one choice of the handoff changed each, and the parent")
    ap.add_argument("--only", metavar="REGEX",
                    help="with an A/B mode: only the copies whose label matches (this tree and "
                         "the parent always run)")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, this, this, parent (each a process per tree)")
    ap.add_argument("--host", action="store_true",
                    help="the host's us per call of the count wrappers and their pieces, per tree")
    ap.add_argument("--fold", action="store_true", help=argparse.SUPPRESS)  # --abfold's cases
    ap.add_argument("--lut", action="store_true", help=argparse.SUPPRESS)  # --ablut's cases
    ap.add_argument("--measure-ab", type=Path, help=argparse.SUPPRESS)  # one A/B tree, in a child
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    ap.add_argument("--inspect", type=Path, help=argparse.SUPPRESS)  # profile, in a child
    ap.add_argument("--sass", type=Path, help=argparse.SUPPRESS)  # SASS, in a child
    ap.add_argument("--host-tree", type=Path, help=argparse.SUPPRESS)  # --host, in a child
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    ap.add_argument("--smi", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_hist_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve(), args.u16)))
        return
    if args.measure_ab:
        print(json.dumps(measure_ab(args.measure_ab.resolve(), args.check, args.u16, args.lut,
                                    args.fold)))
        return
    if args.inspect:
        profile(args.inspect.resolve(), args.label, args.smi, args.u16)
        return
    if args.sass:
        sass(args.sass.resolve(), args.label, args.u16)
        return
    if args.host_tree:
        host_probe(args.host_tree.resolve(), args.label, args.smi)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.ab or args.ab16 or args.ablut or args.abfold:
        if args.abfold:
            # the paths run the median and the conv too
            keep = ("hist.cu", "clahe.cu", "conv.cu", "median.cu")
            ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits, keep=keep), True)
                                           for label, edits in FOLD_AB_VARIANTS.items()]
        elif args.ablut:
            ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits), True)
                                           for label, edits in LUT_AB_VARIANTS.items()]
        elif args.ab16:
            ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits), keep)
                                           for label, (edits, keep) in _ab16_variants().items()]
        else:
            ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits), keep)
                                           for label, (edits, keep) in AB_VARIANTS.items()]
        if args.only:
            ab = [t for t in ab if t[0] == "this" or re.search(args.only, t[0])]
        if args.parent:
            ab.append(("parent", args.parent.resolve(), True))
        builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                    "from imageenhancement_mp_tpu_torch.kernels import _build; "
                                    "_build.library()", str(root)]) for _, root, _ in ab]
        failed = [label for (label, _, _), b in zip(ab, builds) if b.wait()]
        tolerant = args.abfold or args.ab16  # an A/B copy may fail; this tree and the parent not
        if failed and not tolerant or "this" in failed or "parent" in failed:
            raise SystemExit("torch_hist_profile: a build of the A/B trees failed")
        for label in failed:  # an A/B copy that does not build is reported, not timed
            print(f"  {label}: did not build")
        ab = [t for t in ab if t[0] not in failed]
        times: dict[str, list[dict]] = {}
        for label, root, keep in ab + ab[::-1]:
            child = subprocess.run([sys.executable, __file__, "--measure-ab", str(root)]
                                   + (["--check"] if keep else []) + ["--u16"] * args.ab16
                                   + ["--lut"] * args.ablut + ["--fold"] * args.abfold,
                                   capture_output=True, text=True)
            if child.returncode:
                if not tolerant or label in ("this", "parent"):
                    raise SystemExit(f"torch_hist_profile: {label} failed:\n{child.stderr[-3000:]}")
                print(f"  {label}: failed: {child.stderr.strip().splitlines()[-1:]}")
                continue
            times.setdefault(label, []).append(json.loads(child.stdout.strip().splitlines()[-1]))
        for label, rs in times.items():
            print(f"  {label}: " + "; ".join(f"{k} {' / '.join(f'{r[k]:.4f}' for r in rs)}"
                                           for k in rs[0]) + f" ms, device-paced  [{smi}]")
        if not (args.ablut or args.abfold):
            for label, root, _ in ab[:1] if args.ab16 else ab[:2]:
                subprocess.run([sys.executable, __file__, "--sass", str(root), "--label", label]
                               + ["--u16"] * args.ab16, check=True)
        return
    trees = [("this", ROOT)]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    if args.host:
        for label, root in trees + trees[::-1]:
            subprocess.run([sys.executable, __file__, "--host-tree", str(root), "--label", label,
                            "--smi", smi], check=True)
        return
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees.insert(-1, (label, Path(path).resolve()))
    if len(trees) > 1:
        trees = (trees + trees[::-1]) * max(args.turns, 1)
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__, "--measure", str(root)]
                               + ["--u16"] * args.u16, check=True, capture_output=True, text=True)
        runs.setdefault(label, []).append(json.loads(child.stdout.strip().splitlines()[-1]))
        print(f"{label} ({root}) done", flush=True)
    keys = dict.fromkeys(k for rs in runs.values() for r in rs for k in r)
    for key in keys:
        cells = {label: [r[key] for r in rs if key in r] for label, rs in runs.items()}
        unit = "us" if key.endswith("us per call") else "ms"
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} {unit} "
                                       f"(median {statistics.median(ts):.4f})"
                                       for label, ts in cells.items() if ts) + f"  [{smi}]")
    for label, root in dict(trees).items():
        subprocess.run([sys.executable, __file__, "--inspect", str(root), "--label", label,
                        "--smi", smi] + ["--u16"] * args.u16, check=True)


if __name__ == "__main__":
    main()
