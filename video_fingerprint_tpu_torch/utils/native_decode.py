"""ctypes bindings for the native decode worker (native/vfp_decode.cc).

Port of video_fingerprint_tpu/utils/native_decode.py: the same C ABI and
the same g++ flags and libav libraries, with the library built on first use
into the port's own directory (ops/_build.py). The worker fuses
demux -> decode -> scale -> crop and never hands full-resolution RGB to
Python. It is an opt-in fast path: `available()` gates it, `LIBRARY.error`
says why it is off, and the cv2 path in data/decode.py stays the default.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from video_fingerprint_tpu_torch.ops._build import HostLibrary

FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vfp_decode_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vfp_decode_probe.restype = ctypes.c_int
    lib.vfp_decode_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
    ]
    lib.vfp_decode_scan.restype = ctypes.c_int
    lib.vfp_decode_clip.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, u8p,
    ]
    lib.vfp_decode_clip.restype = ctypes.c_int


LIBRARY = HostLibrary("vfp_decode", FLAGS, LIBS, bind=_bind)


def available() -> bool:
    return LIBRARY.load() is not None


def probe(path) -> Optional[Tuple[int, float, int, int]]:
    """(total_frames, fps, width, height), or None."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    frames = ctypes.c_longlong(0)
    fps = ctypes.c_double(0)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.vfp_decode_probe(str(path).encode(), ctypes.byref(frames),
                              ctypes.byref(fps), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return int(frames.value), float(fps.value), int(w.value), int(h.value)


def decode_scan(path, max_frames: int, size: int,
                skip_rate: Optional[int] = None) -> Optional[np.ndarray]:
    """Fused subsampled decode for the attention scan: (n, size, size, 3)
    uint8 (short-side scale + center crop per frame), or None on failure.
    skip_rate None lets the worker take max(1, total // max_frames)."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    out = np.empty((max_frames, size, size, 3), np.uint8)
    n = lib.vfp_decode_scan(str(path).encode(), max_frames, int(skip_rate or 0), size,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n <= 0:
        return None
    return out[:n]


def decode_clip(path, start_frame: int, num_frames: int,
                size: int) -> Optional[np.ndarray]:
    """Fused contiguous-window decode for the 3D path: (num_frames, size,
    size, 3) uint8, a short read padded by repeating its last frame; None on
    failure."""
    lib = LIBRARY.load()
    if lib is None:
        return None
    out = np.zeros((num_frames, size, size, 3), np.uint8)
    n = lib.vfp_decode_clip(str(path).encode(), int(start_frame), num_frames, size,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n <= 0:
        return None
    if n < num_frames:  # repeat the last decoded frame (reference dataset.py:189-195)
        out[n:] = out[n - 1]
    return out
