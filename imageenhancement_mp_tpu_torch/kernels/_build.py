"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

``kernels/csrc/*.cu`` compile with one nvcc process per source, all started
together, and link into ``build/ie_torch_kernels/<hash>/libie_kernels.so``
under the repository root, where ``<hash>`` covers the sources, the headers
they share (``csrc/*.cuh``) and the flags, so an edited source or header
builds anew and an unchanged one loads the library
already built.  The sources export plain C functions; each takes device
pointers and a stream as ``void*``, launches one kernel on that stream and
returns the ``cudaError_t`` of ``cudaGetLastError()``.  :func:`launch`
raises when that is not 0 and counts the launch in :data:`launch_counts`;
under a torch profiler each launch is an ``ie.launch.<name>`` span
(``tracing.py``).

Nothing here runs at import: the first CUDA tensor that reaches a kernel
wrapper triggers the build.  A missing nvcc or a failed build raises with
nvcc's output in the message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from imageenhancement_mp_tpu_torch.tracing import span

__all__ = ["NVCC_FLAGS", "library", "launch", "launch_counts", "reset_launch_counts"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ie_torch_kernels"

# -fmad=false and no --use_fast_math: the kernels' roundings are the ones
# their sources write (explicit __fmaf_rn / __fmul_rn where cv2 fuses).
# -Xptxas=-v only reports registers and shared memory into nvcc.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
# C entry point -> argument types, the stream last.
_SIGNATURES = {
    "ie_hist256": (_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P),
    "ie_hist256_lut": (_P, _P, _I64, _I64, _I64, _I64, _I64, _P, _P, _P),
    "ie_equalize_lut256": (_P, _P, _I64, _I64, _P),
    "ie_apply_lut256": (_P, _P, _I64, _P, _I64, _I64, _P),
    "ie_sep_conv_u8": (_P, _P, _I64, _I64, _I64, _P, _I32, _P, _I32, _P, _P, _I32, _I32, _I32,
                       _I32, _I32, _F32, _F32, _P),
    "ie_median": (_P, _P, _I64, _I64, _I64, _I32, _I32, _P),
    "ie_hist256_tiles": (_P, _P, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _I64, _I64, _I64,
                         _P, _P, _P),
    "ie_tile_luts256": (_P, _P, _I32, _F32, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _I64, _I64,
                        _I64, _P, _P, _P),
    "ie_clahe_lut": (_P, _P, _I64, _I32, _I32, _F32, _P),
    "ie_hist65536_tiles": (_P, _P, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _P),
    "ie_tile_luts65536": (_P, _P, _P, _I32, _F32, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _P),
    "ie_clahe_blend": (_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _P, _P, _I32,
                       _I32, _P, _I32, _I32, _I32, _P),
    "ie_bilateral": (_P, _P, _I64, _I64, _I64, _P, _I32, _P, _I32, _P, _I32, _P),
    "ie_athresh": (_P, _P, _P, _I64, _I64, _I64, _P, _I32, _I32, _I32, _I32, _F32, _I32, _P),
    "ie_warp_gather_u8": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I32, _I32, _I32,
                          _I32, *(_F32,) * 9, _P),
    "ie_take_table": (_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P),
    "ie_apply_lut256_wide": (_P, _P, _I64, _P, _I64, _I64, _I32, _P),
    "ie_apply_luts_multi": (_P, _P, _I64, _P, _I64, _I64, _I32, _P),
    "ie_median_unsharp": (_P, _P, _I64, _I64, _I64, _I32, _P, _I32, _F32, _F32, _P),
}

# One plain integer per kernel wrapper: the launches made in this process.
# Shard threads launch at once (parallel/mesh.py): every update holds the lock.
launch_counts: dict[str, int] = {name[3:]: 0 for name in _SIGNATURES}
_COUNTS_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNTS_LOCK:
        for name in launch_counts:
            launch_counts[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").is_file():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA kernels "
        "are built from imageenhancement_mp_tpu_torch/kernels/csrc at first use")


def _source_digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none.
    Threads that ask at once wait for one build."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _source_digest(sources + sorted(CSRC.glob("*.cuh")))
    so = out_dir / "libie_kernels.so"
    if not so.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), os.getpid()
        objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        tmp = out_dir / f"libie_kernels.{tag}.so"
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        failed = [(cmd, proc.returncode, out)
                  for cmd, proc, out in zip(cmds, procs, outputs) if proc.returncode != 0]
        if not failed:
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            outputs.append(proc.stdout)
            if proc.returncode != 0:
                failed.append((link, proc.returncode, proc.stdout))
        (out_dir / "nvcc.log").write_text("".join(outputs))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{out}" for cmd, rc, out in failed))
        os.replace(tmp, so)  # atomic: a concurrent loader sees no partial file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ie_error_string.argtypes = (ctypes.c_int,)
    lib.ie_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream, raise on a CUDA
    error, and count the launch.  ``args`` are the C entry point's arguments
    before the stream: tensor pointers as ``data_ptr()`` ints."""
    lib = library()
    with span("ie.launch." + name), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, "ie_" + name)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name}: CUDA error {err} ({lib.ie_error_string(err).decode()})")
    with _COUNTS_LOCK:
        launch_counts[name] += 1
