"""FrameWriter: native multithreaded frame encoder/writer (ctypes binding).

The output half of the streaming runtime (io/loader.py is the input half;
the reference writes with ``cv2.imwrite`` per image, SURVEY.md §3.5).
Worker threads in native/framewriter.cpp encode (PGM/PPM/PNG/JPEG/raw) and
write frames behind the consumer, so disk IO overlaps device compute:
``save()`` queues and returns immediately; ``flush()`` waits and reports
per-frame failures.

The shared library is compiled from source with g++ on first use and cached
under ``build/ie_torch_io/`` (io/loader.py); without a C++ toolchain a
pure-Python fallback with a thread pool provides the same contract (PNG via
zlib, JPEG via cv2/Pillow).  A copy of the JAX package's ``io/writer.py``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from imageenhancement_mp_tpu_torch.io.loader import BUILD_DIR, FrameError, build_native_lib

_NATIVE_DIR = Path(__file__).parent / "native"
_SRC = _NATIVE_DIR / "framewriter.cpp"
_LIB = BUILD_DIR / "_framewriter.so"
_lock = threading.Lock()
_lib = None
_native_failed = False

__all__ = ["FrameWriter", "encode_frame"]


def _build_lib() -> ctypes.CDLL | None:
    global _native_failed
    with _lock:
        lib = build_native_lib(_SRC, _LIB)  # shared bootstrap (io/loader.py)
        if lib is None:
            _native_failed = True
        return lib


def _get_lib() -> ctypes.CDLL | None:
    global _lib
    if _lib is None and not _native_failed:
        lib = _build_lib()
        if lib is not None:
            lib.fw_create.restype = ctypes.c_void_p
            lib.fw_create.argtypes = [ctypes.c_int, ctypes.c_long]
            lib.fw_submit.restype = ctypes.c_long
            lib.fw_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.fw_flush.restype = ctypes.c_long
            lib.fw_flush.argtypes = [ctypes.c_void_p]
            lib.fw_failure.restype = ctypes.c_long
            lib.fw_failure.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                ctypes.c_char_p, ctypes.c_long,
            ]
            lib.fw_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _canon_frame(frame: np.ndarray) -> tuple[np.ndarray, int, int, int, int]:
    """Validate + canonicalize to (contiguous array, w, h, ch, depth)."""
    frame = np.ascontiguousarray(frame)
    if frame.dtype == np.uint8:
        depth = 8
    elif frame.dtype == np.uint16:
        depth = 16
    else:
        raise TypeError(f"FrameWriter takes uint8/uint16 frames, got {frame.dtype}")
    if frame.ndim == 2:
        h, w, ch = frame.shape[0], frame.shape[1], 1
    elif frame.ndim == 3 and 1 <= frame.shape[2] <= 4:
        h, w, ch = frame.shape
    else:
        raise ValueError(f"expected [H,W] or [H,W,C<=4], got {frame.shape}")
    return frame, w, h, ch, depth


# ---------------------------------------------------------------- fallback


def _encode_pnm(frame: np.ndarray, w: int, h: int, ch: int, depth: int) -> bytes:
    if ch not in (1, 3):
        raise ValueError(f"PNM supports 1 or 3 channels, got {ch}")
    maxv = 65535 if depth == 16 else 255
    header = f"P{'6' if ch == 3 else '5'}\n{w} {h}\n{maxv}\n".encode()
    data = frame.astype(">u2").tobytes() if depth == 16 else frame.tobytes()
    return header + data


def _encode_png(frame: np.ndarray, w: int, h: int, ch: int, depth: int) -> bytes:
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    samples = (
        frame.astype(">u2").view(np.uint8) if depth == 16 else frame
    ).reshape(h, -1)
    # filter "Up" after the first row (matches the native encoder)
    filt = np.zeros((h, 1), np.uint8)
    filt[1:] = 2
    rows = samples.astype(np.int16)
    rows[1:] -= samples[:-1].astype(np.int16)
    raw = np.concatenate([filt, rows.astype(np.uint8)], axis=1).tobytes()
    zdat = zlib.compress(raw, 6)

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data))
        )

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zdat)
        + chunk(b"IEND", b"")
    )


def _encode_jpeg(frame: np.ndarray, ch: int, depth: int, quality: int) -> bytes:
    if depth != 8 or ch not in (1, 3):
        raise ValueError("JPEG output is 8-bit gray/RGB only")
    try:
        import cv2

        bgr = frame[..., ::-1] if ch == 3 else frame
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("cv2 JPEG encode failed")
        return buf.tobytes()
    except ImportError:
        from io import BytesIO

        from PIL import Image

        out = BytesIO()
        Image.fromarray(frame if ch == 3 else frame.reshape(frame.shape[:2])).save(
            out, format="JPEG", quality=quality
        )
        return out.getvalue()


def encode_frame(path: str, frame: np.ndarray, quality: int = 95) -> bytes:
    """Encode a frame for ``path``'s extension (the Python fallback encoder;
    the native encoder in framewriter.cpp produces equivalent files)."""
    frame, w, h, ch, depth = _canon_frame(frame)
    ext = Path(path).suffix.lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        return _encode_pnm(frame, w, h, ch, depth)
    if ext == ".png":
        return _encode_png(frame, w, h, ch, depth)
    if ext in (".jpg", ".jpeg"):
        return _encode_jpeg(frame, ch, depth, quality)
    return frame.tobytes()


# ------------------------------------------------------------------ writer


class FrameWriter:
    """Asynchronous frame writer: ``save()`` queues, workers encode+write.

    >>> with FrameWriter(threads=4) as fw:
    ...     for i, frame in enumerate(enhanced_frames):
    ...         fw.save(f"out/{i:04d}.png", frame)
    ... # __exit__ flushes; fw.failures lists FrameError per failed file

    Formats by extension: ``.pgm/.ppm`` (8/16-bit PNM), ``.png`` (8/16-bit
    gray/RGB/RGBA), ``.jpg/.jpeg`` (8-bit, ``quality=``), else raw bytes.
    Color frames are taken in RGB(A) channel order (the FrameLoader
    convention).  ``flush()`` waits for the queue to drain and returns the
    failures accumulated since construction.
    """

    def __init__(
        self,
        threads: int = 4,
        max_queue_bytes: int = 256 * 1024 * 1024,
        force_fallback: bool = False,
    ):
        self.threads = max(1, threads)
        self.max_queue_bytes = max_queue_bytes
        self._force_fallback = force_fallback
        self.failures: list[FrameError] = []
        self._h = None
        self._closed = False
        self._lib = None if force_fallback else _get_lib()
        if self._lib is not None:
            self._h = self._lib.fw_create(self.threads, max_queue_bytes)
            if not self._h:
                raise RuntimeError("fw_create failed")
        else:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(self.threads)
            self._pending: list = []
            # backpressure state mirroring the native queue cap: bytes of
            # frame copies queued but not yet written
            self._qbytes = 0
            self._qcond = threading.Condition()

    @property
    def native(self) -> bool:
        return self._h is not None

    def save(self, path: str | os.PathLike, frame: np.ndarray, quality: int = 95):
        """Queue one frame for encode+write.  Returns immediately (may block
        briefly when the encode queue is full).  Raises on invalid frames;
        IO/encode failures surface via ``flush()``/``failures``."""
        if self._closed:
            raise RuntimeError("FrameWriter is closed")
        path = str(path)
        frame, w, h, ch, depth = _canon_frame(frame)
        quality = min(100, max(1, int(quality)))  # same clamp on both backends
        if self._h is not None:
            rc = self._lib.fw_submit(
                self._h,
                path.encode(),
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                w, h, ch, depth, quality,
            )
            if rc < 0:
                raise ValueError(f"fw_submit rejected frame (code {rc}): {path}")
            return
        # the native path copies the buffer synchronously inside fw_submit
        # and blocks while the queue holds max_queue_bytes of copies; match
        # both halves of that contract here so a caller-reused buffer can't
        # change under the encode worker and a slow disk can't grow memory
        # without bound
        nbytes = frame.nbytes
        with self._qcond:
            while self._qbytes > 0 and self._qbytes + nbytes > self.max_queue_bytes:
                self._qcond.wait()
            self._qbytes += nbytes
        frame = frame.copy()

        def run():
            try:
                data = encode_frame(path, frame, quality)
                with open(path, "wb") as f:
                    f.write(data)
                return None
            except Exception as e:  # per-frame failure
                return FrameError(path, cause=e)
            finally:
                with self._qcond:
                    self._qbytes -= nbytes
                    self._qcond.notify_all()

        self._pending.append(self._pool.submit(run))

    def flush(self) -> list[FrameError]:
        """Wait for all queued writes; return (and record) the failure list."""
        if self._closed:
            return self.failures
        if self._h is not None:
            nfail = self._lib.fw_flush(self._h)
            seen = len(self.failures)
            buf = ctypes.create_string_buffer(4096)
            code = ctypes.c_long()
            for k in range(seen, nfail):
                self._lib.fw_failure(self._h, k, ctypes.byref(code), buf, 4096)
                self.failures.append(FrameError(buf.value.decode(), code=code.value))
            return self.failures
        for fut in self._pending:
            res = fut.result()
            if res is not None:
                self.failures.append(res)
        self._pending = []
        return self.failures

    def close(self):
        if self._h is not None:
            self.flush()
            self._lib.fw_destroy(self._h)
            self._h = None
        elif getattr(self, "_pool", None) is not None:
            self.flush()
            self._pool.shutdown()
            self._pool = None
        self._closed = True

    def __enter__(self) -> "FrameWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            if self._h is not None:
                self._lib.fw_destroy(self._h)
                self._h = None
        except Exception:
            pass
