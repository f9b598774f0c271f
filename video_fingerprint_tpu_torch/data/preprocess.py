"""Frame preprocessing (host side): resize, crop, stack, bucket.

A copy of video_fingerprint_tpu/data/preprocess.py, with cv2 imported
inside the functions that use it. The resizes and crops are
bit-exact with the reference's scan (same cv2 calls, same integer
arithmetic), which eval parity depends on: the attention scan's short-side
resize and center crop, and the 3D scan's square center crop and resize.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def resize_short_side_center_crop(frame: np.ndarray, size: int) -> np.ndarray:
    """Aspect-preserving short-side resize to `size` (INTER_AREA), then a
    center crop with a floor-division origin (fingerprint.py:190-208)."""
    import cv2

    h, w = frame.shape[:2]
    if h < w:
        new_h, new_w = size, int(w * size / h)
    else:
        new_w, new_h = size, int(h * size / w)
    frame = cv2.resize(frame, (new_w, new_h), interpolation=cv2.INTER_AREA)
    h, w = frame.shape[:2]
    sh, sw = (h - size) // 2, (w - size) // 2
    return frame[sh : sh + size, sw : sw + size]


def square_center_crop_resize(frame: np.ndarray, size: int) -> np.ndarray:
    """Center crop to a square, then an INTER_LINEAR resize to `size`: the
    3D scan's variant (fingerprint.py:152-166)."""
    h, w = frame.shape[:2]
    if h == size and w == size:
        return frame
    import cv2

    if h > w:
        start = (h - w) // 2
        frame = frame[start : start + w, :, :]
    elif w > h:
        start = (w - h) // 2
        frame = frame[:, start : start + h, :]
    return cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)


def frames_to_clip(frames: Sequence[np.ndarray]) -> np.ndarray:
    """uint8 RGB frames -> (T, H, W, C) float32 in [0, 1]."""
    clip = np.stack(frames).astype(np.float32)
    clip /= 255.0
    return clip


def frames_to_clip_u8(frames: Sequence[np.ndarray]) -> np.ndarray:
    """uint8 RGB frames -> (T, H, W, C) uint8; the scan divides by 255 on
    the device, so the copy to it moves 4x fewer bytes."""
    return np.stack(frames)


def preprocess_frames(
    frames: Sequence[np.ndarray], size: int, normalize: bool = True
) -> np.ndarray:
    """Resize + crop each frame and stack to (T, H, W, C): float32 in [0, 1]
    when `normalize`, else uint8 (the scan normalizes on the device, so the
    host-to-device copy moves 4x fewer bytes)."""
    resized = [resize_short_side_center_crop(f, size) for f in frames]
    return frames_to_clip(resized) if normalize else frames_to_clip_u8(resized)


def bucket_for_length(t: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= t (last bucket if t exceeds all)."""
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]


def default_buckets(max_frames: int) -> List[int]:
    """The length-bucket ladder bounded by max_frames (one compiled shape per
    bucket in the JAX package; padding waste <= ~30 %)."""
    ladder = [16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512]
    return [b for b in ladder if b < max_frames] + [max_frames]
