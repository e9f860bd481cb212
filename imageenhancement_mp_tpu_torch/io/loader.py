"""FrameLoader: native multithreaded frame prefetcher (ctypes binding).

The streaming runtime's host-side IO (SURVEY.md §3.5 — the reference's
``cv2.imread`` per-image loop, whose decode is OpenCV C++).  Worker threads
in native/frameloader.cpp read + decode PGM/PPM/raw frames ahead of the
consumer, preserving order, so disk IO overlaps device compute when fed
into ``pipeline.stream_frames``.

The shared library is compiled from source with g++ on first use and cached
under ``build/ie_torch_io/`` at the repository root; if no C++ toolchain (or
zlib or libjpeg) is available a pure-Python fallback with a thread pool
provides the same iterator contract.  A copy of the JAX package's
``io/loader.py``: the port imports nothing of that package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ie_torch_io"
_SRC = _NATIVE_DIR / "frameloader.cpp"
_LIB = BUILD_DIR / "_frameloader.so"
_lock = threading.Lock()
_lib = None
_native_failed = False


def build_native_lib(src: Path, lib: Path) -> ctypes.CDLL | None:
    """Compile-and-cache bootstrap shared by the native loader and writer
    (io/writer.py).  Caller holds its module lock.  Returns None when no
    C++ toolchain is available (callers fall back to pure Python)."""
    if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
        try:
            return ctypes.CDLL(str(lib))
        except OSError:
            # stale/truncated cache (interrupted build) — remove and
            # rebuild below
            lib.unlink(missing_ok=True)
    # each process builds into a file of its own and renames it into place,
    # so a process never loads another's half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [
                "g++",
                "-O2",
                "-std=c++17",
                "-shared",
                "-fPIC",
                "-pthread",
                str(src),
                "-lz",
                "-ljpeg",
                "-o",
                str(tmp),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, lib)
        return ctypes.CDLL(str(lib))
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _build_lib() -> ctypes.CDLL | None:
    global _native_failed
    with _lock:
        lib = build_native_lib(_SRC, _LIB)
        if lib is None:
            _native_failed = True
        return lib


def _get_lib() -> ctypes.CDLL | None:
    global _lib
    if _lib is None and not _native_failed:
        lib = _build_lib()
        if lib is not None:
            lib.fl_create.restype = ctypes.c_void_p
            lib.fl_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_long,
            ]
            lib.fl_next.restype = ctypes.c_long
            lib.fl_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.fl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _parse_png(data: bytes) -> np.ndarray:
    """Minimal 8/16-bit non-interlaced PNG decode (fallback path)."""
    import struct
    import zlib

    pos = 8
    idat = b""
    w = h = bit = color = interlace = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            w, h, bit, color, _, _, interlace = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    ch = {0: 1, 2: 3, 4: 2, 6: 4}.get(color)
    if bit not in (8, 16) or interlace != 0 or ch is None:
        raise ValueError("unsupported PNG variant")
    bpp = ch * (bit // 8)  # filter left-offset = bytes per pixel
    stride = w * bpp
    max_raw = (stride + 1) * h
    if max_raw > 512 * 1024 * 1024:
        raise ValueError("PNG dimensions exceed decode limit")
    raw_b = zlib.decompressobj().decompress(idat, max_raw)
    if len(raw_b) != max_raw:
        raise ValueError("PNG IDAT length mismatch")
    raw = np.frombuffer(raw_b, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        filt = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if filt > 4:
            raise ValueError(f"invalid PNG filter byte {filt}")
        if filt == 0:
            cur = line
        elif filt == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if filt == 1:
                    v = line[x] + a
                elif filt == 3:
                    v = line[x] + (a + b) // 2
                else:
                    p_ = a + b - c
                    pa, pb, pc = abs(p_ - a), abs(p_ - b), abs(p_ - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    v = line[x] + pred
                cur[x] = v & 255
        out[y] = cur
        prev = cur
    bytes_ = out.astype(np.uint8)
    if bit == 16:  # PNG samples are big-endian
        pairs = bytes_.reshape(h, w * ch, 2).astype(np.uint16)
        arr = (pairs[..., 0] << 8) | pairs[..., 1]
    else:
        arr = bytes_
    return arr.reshape(h, w, ch) if ch > 1 else arr.reshape(h, w)


def _parse_pnm(path: str) -> np.ndarray:
    """Pure-Python PGM/PPM/PNG/raw fallback (same formats as the native loader)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return _parse_png(data)
    if data[:3] == b"\xff\xd8\xff":
        # JPEG fallback: defer to cv2/PIL (no pure-Python baseline decoder)
        try:
            import cv2

            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError(f"{path}: JPEG decode failed")
            return img[..., ::-1] if img.ndim == 3 else img  # BGR -> RGB
        except ImportError:
            from io import BytesIO

            from PIL import Image

            return np.asarray(Image.open(BytesIO(data)))
    if data[:2] in (b"P5", b"P6"):
        parts = []
        i = 2
        while len(parts) < 3:
            while i < len(data) and data[i : i + 1].isspace():
                i += 1
            if data[i : i + 1] == b"#":
                while i < len(data) and data[i] != 0x0A:
                    i += 1
                continue
            j = i
            while j < len(data) and not data[j : j + 1].isspace():
                j += 1
            parts.append(int(data[i:j]))
            i = j
        i += 1  # single whitespace after maxval
        w, h, maxv = parts
        if not 1 <= maxv <= 65535:
            raise ValueError(f"{path}: PNM maxval {maxv} out of range")
        ch = 3 if data[:2] == b"P6" else 1
        if maxv > 255:  # PNM spec: 2-byte big-endian samples above 255
            arr = np.frombuffer(data, ">u2", count=w * h * ch, offset=i)
            arr = arr.astype(np.uint16)
        else:
            arr = np.frombuffer(data, np.uint8, count=w * h * ch, offset=i)
        return arr.reshape((h, w, ch) if ch == 3 else (h, w))
    return np.frombuffer(data, np.uint8)


def bounded_map(fn, items, threads: int):
    """ThreadPool map with bounded read-ahead (2·threads+2 in flight).

    Unlike ``Executor.map`` this never submits more work than the window,
    so decoded results cannot pile up faster than the consumer drains them.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    window = 2 * max(1, threads) + 2
    with ThreadPoolExecutor(max(1, threads)) as ex:
        pending: deque = deque()
        for item in items:
            pending.append(ex.submit(fn, item))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class FrameError(IOError):
    """A single frame failed to decode.

    Raised from the loader iterator by default; with
    ``FrameLoader(..., on_error="sentinel")`` it is *yielded* in the failed
    frame's slot instead, so iteration stays aligned with ``paths`` and
    continues past the bad file.
    """

    def __init__(self, path: str, code: int | None = None, cause: BaseException | None = None):
        detail = f"code {code}" if code is not None else repr(cause)
        super().__init__(f"frame load failed ({detail}): {path}")
        self.path = path
        self.code = code
        self.__cause__ = cause


class FrameLoader:
    """Order-preserving prefetching iterator over frame files.

    ``for frame in FrameLoader(paths, threads=4): ...`` yields uint8 arrays
    ([H,W] for gray, [H,W,C] for color, flat for raw blobs) from PGM/PPM/
    PNG/JPEG/raw files; 16-bit PGM/PPM (maxval>255) and 16-bit PNG decode
    to uint16.  Color frames are in the file's natural RGB(A) channel order
    (PIL convention — note cv2.imread would return BGR).

    ``on_error="raise"`` (default) raises :class:`FrameError` at the failed
    frame, ending iteration; ``on_error="sentinel"`` yields the
    :class:`FrameError` in that slot and continues with the next file.
    """

    def __init__(
        self,
        paths: Sequence[str | os.PathLike],
        threads: int = 4,
        max_frame_bytes: int = 64 * 1024 * 1024,
        force_fallback: bool = False,
        on_error: str = "raise",
    ):
        if on_error not in ("raise", "sentinel"):
            raise ValueError(f"on_error must be 'raise' or 'sentinel', got {on_error!r}")
        self.paths = [str(p) for p in paths]
        self.threads = max(1, threads)
        self.max_frame_bytes = max_frame_bytes
        self._force_fallback = force_fallback
        self.on_error = on_error

    @property
    def native(self) -> bool:
        return not self._force_fallback and _get_lib() is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        lib = None if self._force_fallback else _get_lib()
        if lib is None:
            yield from self._iter_fallback()
            return
        c_paths = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        h = lib.fl_create(c_paths, len(self.paths), self.threads, self.max_frame_bytes)
        if not h:
            raise RuntimeError("fl_create failed")
        try:
            buf = np.empty(self.max_frame_bytes, np.uint8)
            bufp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            w = ctypes.c_int()
            hh = ctypes.c_int()
            ch = ctypes.c_int()
            depth = ctypes.c_int()
            for path in self.paths:
                n = lib.fl_next(h, bufp, self.max_frame_bytes, w, hh, ch, depth)
                if n == 0:
                    return
                if n < 0:
                    # the native stream continues past a failed frame
                    err = FrameError(path, code=n)
                    if self.on_error == "raise":
                        raise err
                    yield err
                    continue
                flat = buf[:n].copy()
                if depth.value == 16:
                    flat = flat.view(np.uint16)
                if ch.value > 1:
                    yield flat.reshape(hh.value, w.value, ch.value)
                elif ch.value == 1:
                    yield flat.reshape(hh.value, w.value)
                else:
                    yield flat  # raw blob: shape unknown
        finally:
            lib.fl_destroy(h)

    def _iter_fallback(self) -> Iterator[np.ndarray]:
        def parse(path: str):
            try:
                return _parse_pnm(path)
            except Exception as e:  # decode/IO failure for this frame only
                return FrameError(path, cause=e)

        for item in bounded_map(parse, self.paths, self.threads):
            if isinstance(item, FrameError) and self.on_error == "raise":
                raise item
            yield item
