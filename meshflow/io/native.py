"""ctypes bindings for the native C++ video IO runtime.

native/videoio.cpp provides a libavformat/libavcodec decoder with a
background prefetch thread (decode overlaps device compute) and a matching
encoder.  The library is built for this host at first use
(utils/native_build.py); where libav is missing it is not available and
io.video falls back to cv2.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from meshflow.utils import native_build


def load_library() -> Optional[ctypes.CDLL]:
    lib = native_build.load("videoio")
    if lib is None or getattr(lib, "_mf_videoio_bound", False):
        return lib
    lib.mf_reader_open.restype = ctypes.c_void_p
    lib.mf_reader_open.argtypes = [ctypes.c_char_p]
    lib.mf_reader_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint),
    ]
    lib.mf_reader_read.restype = ctypes.c_long
    lib.mf_reader_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
    ]
    lib.mf_reader_close.argtypes = [ctypes.c_void_p]
    lib.mf_writer_open.restype = ctypes.c_void_p
    lib.mf_writer_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_uint,
    ]
    lib.mf_writer_write.restype = ctypes.c_long
    lib.mf_writer_write.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long,
    ]
    lib.mf_writer_close.restype = ctypes.c_int
    lib.mf_writer_close.argtypes = [ctypes.c_void_p]
    lib._mf_videoio_bound = True
    return lib


def available() -> bool:
    return load_library() is not None


def unavailable_reason() -> str:
    """Why the library is not available here ("available" if it is)."""
    if available():
        return "available"
    return native_build.error("videoio") or "not built"


class NativeReader:
    """Streaming decoder with background prefetch."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise IOError("native video IO library (libav) not available")
        self._lib = lib
        self._handle = lib.mf_reader_open(path.encode())
        if not self._handle:
            raise IOError(f"Could not open video at <{path}>.")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        nb = ctypes.c_long()
        fourcc = ctypes.c_uint()
        lib.mf_reader_info(
            self._handle,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
            ctypes.byref(nb), ctypes.byref(fourcc),
        )
        self.width = w.value
        self.height = h.value
        self.fps = fps.value
        self.num_frames = nb.value
        self.fourcc = int(fourcc.value)

    def read(self, max_frames: int) -> np.ndarray:
        """Up to max_frames BGR frames, (n, H, W, 3) uint8 (n=0 at EOF)."""
        buf = np.empty((max_frames, self.height, self.width, 3), np.uint8)
        got = self._lib.mf_reader_read(
            self._handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            max_frames,
        )
        return buf[:got]

    def close(self):
        if self._handle:
            self._lib.mf_reader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeWriter:
    def __init__(self, path: str, width: int, height: int, fps: float, fourcc: int):
        lib = load_library()
        if lib is None:
            raise IOError("native video IO library (libav) not available")
        self._lib = lib
        self._handle = lib.mf_writer_open(
            path.encode(), width, height, fps, fourcc & 0xFFFFFFFF
        )
        if not self._handle:
            raise IOError(f"Could not open a video encoder for <{path}>.")

    def write(self, frames: np.ndarray) -> int:
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        return self._lib.mf_writer_write(
            self._handle,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frames.shape[0],
        )

    def close(self) -> int:
        if self._handle:
            rc = self._lib.mf_writer_close(self._handle)
            self._handle = None
            return rc
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
