"""Scan-time frame preprocessing (host side): resize, crop, stack, bucket.

A copy of the scan's part of video_fingerprint_tpu/data/preprocess.py, with
cv2 imported inside the function that uses it. The resize and crop are
bit-exact with the reference's scan (same cv2 call, same integer
arithmetic), which eval parity depends on.
"""

from __future__ import annotations

from typing import Sequence

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


def preprocess_frames(
    frames: Sequence[np.ndarray], size: int, normalize: bool = True
) -> np.ndarray:
    """Resize + crop each frame and stack to (T, H, W, C): float32 in [0, 1]
    when `normalize`, else uint8 (the scan normalizes on the device, so the
    host-to-device copy moves 4x fewer bytes)."""
    clip = np.stack([resize_short_side_center_crop(f, size) for f in frames])
    if not normalize:
        return clip
    clip = clip.astype(np.float32)
    clip /= 255.0
    return clip


def bucket_for_length(t: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= t (last bucket if t exceeds all)."""
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]
