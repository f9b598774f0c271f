"""ctypes bindings for the native host-preprocessing runtime (native/vfp_host.cc).

Port of video_fingerprint_tpu/utils/native.py: the same C ABI and the same
g++ flags, with the library built on first use into the port's own
directory (ops/_build.py). When the toolchain is missing, `available()` is
False and callers take the cv2 path, as the JAX package's do;
`LIBRARY.error` then says why.
"""

from __future__ import annotations

import ctypes

import numpy as np

from video_fingerprint_tpu_torch.ops._build import HostLibrary

FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def _bind(lib: ctypes.CDLL) -> None:
    lib.vfp_init.argtypes = [ctypes.c_int]
    lib.vfp_init.restype = ctypes.c_int
    lib.vfp_preprocess_frames.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.vfp_preprocess_frames.restype = None
    lib.vfp_fill_batch_row.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.vfp_fill_batch_row.restype = None
    lib.vfp_init(0)


LIBRARY = HostLibrary("vfp_host", FLAGS, bind=_bind)


def available() -> bool:
    return LIBRARY.load() is not None


def _require() -> ctypes.CDLL:
    lib = LIBRARY.load()
    if lib is None:
        raise RuntimeError(f"native vfp_host library unavailable: {LIBRARY.error}")
    return lib


def preprocess_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB -> (T, size, size, 3) float32 in [0, 1]: fused
    short-side resize + center crop + normalize on the library's thread
    pool. Raises RuntimeError when the library is unavailable."""
    lib = _require()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    out = np.empty((t, size, size, 3), np.float32)
    lib.vfp_preprocess_frames(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size)
    return out


def fill_batch_row(clip: np.ndarray, batch: np.ndarray, row: int) -> None:
    """Copy a (t, s, s, 3) f32 clip into batch[row] of a (B, bucket, s, s, 3)
    f32 batch and zero the padding tail."""
    lib = _require()
    clip = np.ascontiguousarray(clip, dtype=np.float32)
    if (batch.dtype != np.float32 or not batch.flags.c_contiguous or batch.ndim != 5
            or not 0 <= row < batch.shape[0] or clip.shape[0] > batch.shape[1]
            or clip.shape[1:] != batch.shape[2:]):
        raise ValueError(f"clip {clip.shape} does not fit row {row} of {batch.shape} "
                         f"{batch.dtype} (C-contiguous float32 needed)")
    bucket, size = batch.shape[1], batch.shape[2]
    lib.vfp_fill_batch_row(
        clip.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), clip.shape[0],
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), row, bucket, size)
