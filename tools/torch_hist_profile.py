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
bins per lane index.  Every line carries the card's name and power limit.
Exits non-zero when torch sees no CUDA device.
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
  __device__ __forceinline__ void add_byte(uint32_t v) { atomicAdd(&extra[v], 1u); }
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
  __device__ __forceinline__ void add_byte(uint32_t v) { atomicAdd(&mine[v], 1u); }
  __device__ __forceinline__ void add_vec(uint4 v, bool valid) {
    if (!valid) return;
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) add_byte((w[i / 4] >> (8 * (i % 4))) & 255u);
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
# the 8-bit counters take more than 48 KB of dynamic shared memory
_SMEM = [(path, f"  {kernel}<<<", "  cudaFuncSetAttribute(" + kernel +
          ", cudaFuncAttributeMaxDynamicSharedMemorySize, HistCounter::kSmemBytes);\n"
          f"  {kernel}<<<")
         for path, kernel in ((_HC, "hist256_kernel"), (_CC, "hist256_tiles_kernel"))]


def ab_tree(label: str, edits) -> Path:
    """This checkout's package under build/hist_ab/ with ``edits`` applied,
    building only hist.cu and clahe.cu."""
    out = ROOT / "build" / "hist_ab" / re.sub(r"\W+", "_", label).strip("_")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / PKG, out / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for src in (out / PKG / "kernels" / "csrc").glob("*.cu"):
        if src.name not in ("hist.cu", "clahe.cu"):
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


def _path_cases(np, torch, port) -> dict:
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(62)
    x8 = torch.from_numpy(rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)).to(dev)
    g4 = torch.from_numpy(rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)).to(dev)
    cfg5 = port.get_preset("denoise_clahe_sharpen")
    return {"equalize_unsharp 8x1080x1920": lambda: port.equalize_unsharp(x8),
            "config 5 2x2160x3840": lambda: cfg5(g4)}


def measure(root: Path) -> dict:
    """Back-to-back and device-paced times of every case in the tree under
    ``root`` (ms)."""
    np, torch, port, k1_planes = _setup(root)
    cases = {name: fn for name, (fn, _) in _kernel_cases(np, torch, k1_planes).items()}
    cases.update(_path_cases(np, torch, port))
    out = {}
    for name, fn in cases.items():
        out[f"{name}, back to back"] = _time_ms(torch, fn, False)
        out[f"{name}, device-paced"] = _time_ms(torch, fn, True)
    return out


def measure_ab(root: Path, check: bool) -> dict:
    """Device-paced times of both kernels on each kind of plane in the tree
    under ``root`` (ms), each held to its plain version first where
    ``check``."""
    np, torch, _, k1_planes = _setup(root)
    out = {}
    for name, (fn, plain) in _kernel_cases(np, torch, k1_planes).items():
        if check and not torch.equal(fn(), plain()):
            raise SystemExit(f"torch_hist_profile: {name} differs from its plain version in {root}")
        out[name] = _time_ms(torch, fn, True)
    return out


def profile(root: Path, label: str, smi: str) -> None:
    """torch.profiler split and busy share, and host enqueue time per call."""
    np, torch, port, _ = _setup(root)
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, fn in _path_cases(np, torch, port).items():
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


def sass(root: Path, label: str) -> None:
    """SASS opcode histogram of the two counting kernels, and ptxas's
    registers and spills for them."""
    sys.path.insert(0, str(root))
    from imageenhancement_mp_tpu_torch.kernels import _build

    lib = Path(_build.library()._name)
    entry = ""
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "hist256" in entry and ("Used" in line or "spill" in line):
            print(f"[{label}] ptxas {re.search(r'(hist256\w*kernel)', entry).group(1)}: "
                  f"{line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(hist256\w*kernel)", m.group(1))
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a parent tree holding imageenhancement_mp_tpu_torch")
    ap.add_argument("--tree", action="append", default=[], metavar="LABEL=PATH",
                    help="another tree, timed between the parent and this one")
    ap.add_argument("--ab", action="store_true",
                    help="time this checkout against copies with one design choice changed each")
    ap.add_argument("--measure-ab", type=Path, help=argparse.SUPPRESS)  # one A/B tree, in a child
    ap.add_argument("--check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one tree, in a child
    ap.add_argument("--inspect", type=Path, help=argparse.SUPPRESS)  # profile, in a child
    ap.add_argument("--sass", type=Path, help=argparse.SUPPRESS)  # SASS, in a child
    ap.add_argument("--label", default="this", help=argparse.SUPPRESS)
    ap.add_argument("--smi", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_hist_profile: torch.cuda.is_available() is False")
    if args.measure:
        print(json.dumps(measure(args.measure.resolve())))
        return
    if args.measure_ab:
        print(json.dumps(measure_ab(args.measure_ab.resolve(), args.check)))
        return
    if args.inspect:
        profile(args.inspect.resolve(), args.label, args.smi)
        return
    if args.sass:
        sass(args.sass.resolve(), args.label)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.ab:
        ab = [("this", ROOT, True)] + [(label, ab_tree(label, edits), keep)
                                       for label, (edits, keep) in AB_VARIANTS.items()]
        if args.parent:
            ab.append(("parent", args.parent.resolve(), True))
        builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                    "from imageenhancement_mp_tpu_torch.kernels import _build; "
                                    "_build.library()", str(root)]) for _, root, _ in ab]
        if any(b.wait() for b in builds):
            raise SystemExit("torch_hist_profile: a build of the A/B trees failed")
        times: dict[str, list[dict]] = {}
        for label, root, keep in ab + ab[::-1]:
            child = subprocess.run([sys.executable, __file__, "--measure-ab", str(root)]
                                   + (["--check"] if keep else []), check=True,
                                   capture_output=True, text=True)
            times.setdefault(label, []).append(json.loads(child.stdout.strip().splitlines()[-1]))
        for label, rs in times.items():
            print(f"  {label}: " + "; ".join(f"{k} {' / '.join(f'{r[k]:.4f}' for r in rs)}"
                                           for k in rs[0]) + f" ms, device-paced  [{smi}]")
        for label, root, _ in ab[:2]:
            subprocess.run([sys.executable, __file__, "--sass", str(root), "--label", label],
                           check=True)
        return
    trees = [("this", ROOT)]
    if args.parent:
        trees.insert(0, ("parent", args.parent.resolve()))
    for spec in args.tree:
        label, _, path = spec.partition("=")
        trees.insert(-1, (label, Path(path).resolve()))
    if len(trees) > 1:
        trees = trees + trees[::-1]
    runs: dict[str, list[dict]] = {}
    for label, root in trees:
        child = subprocess.run([sys.executable, __file__, "--measure", str(root)], check=True,
                               capture_output=True, text=True)
        runs.setdefault(label, []).append(json.loads(child.stdout.strip().splitlines()[-1]))
        print(f"{label} ({root}) done", flush=True)
    keys = dict.fromkeys(k for rs in runs.values() for r in rs for k in r)
    for key in keys:
        cells = {label: [r[key] for r in rs if key in r] for label, rs in runs.items()}
        print(f"  {key}: " + "; ".join(f"{label} {' / '.join(f'{t:.4f}' for t in ts)} ms"
                                       for label, ts in cells.items() if ts) + f"  [{smi}]")
    for label, root in dict(trees).items():
        subprocess.run([sys.executable, __file__, "--inspect", str(root), "--label", label,
                        "--smi", smi], check=True)


if __name__ == "__main__":
    main()
