"""Native (C++) runtime components, bound via ctypes.

This package holds the compiled host-side workers of the framework --
today the H.264 video-encode worker (``videoenc.cc``), which restores the
reference's exact codec contract (libx264 / yuv420p / crf 20, reference
io/video_recorder.py:17-52) and moves per-frame encode work off the Python
thread.

No pybind11 exists in this image, so binding is plain ctypes against an
extern-"C" API, and the shared library is built on first use with g++
(cached in ``_build/`` next to this file, keyed on source mtime). Every
consumer degrades gracefully: if the toolchain or the ffmpeg dev libraries
are absent, ``load_videoenc()`` returns None and callers fall back to their
pure-Python/cv2 paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_cache: dict = {}

_VENC_LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]


def _build(src_name: str, lib_name: str, link_flags) -> Optional[str]:
    """Compile ``src_name`` into ``_build/lib_name`` if stale; return path."""
    src = os.path.join(_DIR, src_name)
    out = os.path.join(_BUILD_DIR, lib_name)
    try:
        if (
            os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)
        ):
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", out,
            *link_flags,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            _cache[lib_name + ":err"] = proc.stderr[-2000:]
            return None
        return out
    except (OSError, subprocess.SubprocessError) as exc:
        _cache[lib_name + ":err"] = str(exc)
        return None


def build_error(lib_name: str = "libvideoenc.so") -> Optional[str]:
    """Compiler stderr of the last failed build of ``lib_name``, if any."""
    return _cache.get(lib_name + ":err")


def load_videoenc() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the video-encode worker library.

    Returns the CDLL with argtypes/restypes configured, or None when the
    library cannot be built or loaded (callers must fall back). Set
    LBM2D_NO_NATIVE=1 to force the fallback paths without touching the
    toolchain (used by tests to pin the cv2 reference behavior).
    """
    if os.environ.get("LBM2D_NO_NATIVE"):
        return None
    with _LOCK:
        if "videoenc" in _cache:
            return _cache["videoenc"]
        lib = None
        path = _build("videoenc.cc", "libvideoenc.so", _VENC_LIBS)
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                lib.venc_open.restype = ctypes.c_void_p
                lib.venc_open.argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
                lib.venc_send_i420.restype = ctypes.c_int
                lib.venc_send_i420.argtypes = [
                    ctypes.c_void_p, u8p, u8p, ctypes.c_int,
                ]
                lib.venc_send_rgb.restype = ctypes.c_int
                lib.venc_send_rgb.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int]
                lib.venc_close.restype = ctypes.c_int
                lib.venc_close.argtypes = [ctypes.c_void_p]
                lib.venc_backend.restype = ctypes.c_char_p
                lib.venc_backend.argtypes = []
                lib.venc_codec_name.restype = ctypes.c_char_p
                lib.venc_codec_name.argtypes = [ctypes.c_void_p]
                lib.venc_last_error.restype = ctypes.c_char_p
                lib.venc_last_error.argtypes = []
                if not lib.venc_backend():  # no usable encoder inside
                    lib = None
            except OSError as exc:
                _cache["libvideoenc.so:err"] = str(exc)
                lib = None
        _cache["videoenc"] = lib
        return lib


class NativeVideoEncoder:
    """Thin RAII wrapper over the C worker for one output file.

    Frames are queued to a dedicated native thread; ``send_*`` returns
    after one memcpy. ``close()`` drains the queue, flushes the encoder,
    and finalizes the mp4 container.
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        fps: int = 30,
        crf: int = 20,
        threads: int = 1,
        queue_cap: int = 8,
    ):
        lib = load_videoenc()
        if lib is None:
            raise RuntimeError(
                f"native video encoder unavailable: {build_error()}"
            )
        self._lib = lib
        self._handle = lib.venc_open(
            path.encode(), width, height, fps, crf, threads, queue_cap
        )
        if not self._handle:
            raise RuntimeError(
                "venc_open failed: "
                + lib.venc_last_error().decode(errors="replace")
            )
        self.codec = lib.venc_codec_name(self._handle).decode()
        self.width = width
        self.height = height

    def _ptr(self, arr):
        import numpy as np

        a = np.ascontiguousarray(arr, dtype=np.uint8)
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def send_i420(self, y8, uv8, flip: bool = True) -> None:
        """y8: [H, W] u8; uv8: [H/2, W/2, 2] u8 interleaved UV."""
        ya, yp = self._ptr(y8)
        uva, uvp = self._ptr(uv8)
        rc = self._lib.venc_send_i420(self._handle, yp, uvp, int(flip))
        if rc != 0:
            raise RuntimeError(f"venc_send_i420 failed ({rc})")

    def send_rgb(self, rgb8, flip: bool = True) -> None:
        """rgb8: [H, W, 3] u8."""
        ra, rp = self._ptr(rgb8)
        rc = self._lib.venc_send_rgb(self._handle, rp, int(flip))
        if rc != 0:
            raise RuntimeError(f"venc_send_rgb failed ({rc})")

    def close(self) -> None:
        if self._handle:
            rc = self._lib.venc_close(self._handle)
            self._handle = None
            if rc != 0:
                raise RuntimeError(f"venc_close failed ({rc})")

    def __del__(self):  # last-resort cleanup; close() is the real API
        try:
            self.close()
        except Exception:
            pass
