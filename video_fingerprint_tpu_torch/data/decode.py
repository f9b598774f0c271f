"""Video decode for the scan (host side).

A copy of the scan's decode in video_fingerprint_tpu/data/decode.py, with
the codec packages imported inside the functions that use them, so the
scanner imports on a machine without OpenCV:

  - "pyav":   PyAV, used when importable (the reference's decoder);
  - "opencv": cv2.VideoCapture (ffmpeg inside the wheel) otherwise.

Frames are RGB24 uint8. A decode failure gives an empty list, as the
reference's scan does (fingerprint.py:105-107).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import List

import numpy as np


@lru_cache(maxsize=1)
def default_backend() -> str:
    try:
        import av  # noqa: F401
    except ImportError:
        return "opencv"
    return "pyav"


def decode_subsampled(path: Path | str, max_frames: int) -> List[np.ndarray]:
    """Decode every skip-th frame up to `max_frames` frames, skip =
    max(1, total // max_frames): the reference's subsampling policy
    (fingerprint.py:90-91). Skipped frames are grabbed but not converted.
    """
    try:
        if default_backend() == "pyav":
            return _decode_subsampled_av(path, max_frames)
        return _decode_subsampled_cv2(path, max_frames)
    except Exception:  # an unreadable file decodes to nothing, as in the reference
        return []


def _derive_skip(total: int, max_frames: int) -> int:
    return max(1, total // max_frames) if total > max_frames else 1


def _decode_subsampled_cv2(path, max_frames) -> List[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return []
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    skip = _derive_skip(total, max_frames)
    frames: List[np.ndarray] = []
    i = 0
    while len(frames) < max_frames:
        if i % skip == 0:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
        elif not cap.grab():  # decode-skip: no conversion, no copy out
            break
        i += 1
    cap.release()
    return frames


def _decode_subsampled_av(path, max_frames) -> List[np.ndarray]:
    import av

    container = av.open(str(path))
    stream = container.streams.video[0]
    total = stream.frames
    if total == 0 and stream.duration:
        total = int(stream.duration * stream.average_rate)
    skip = _derive_skip(total, max_frames)
    frames: List[np.ndarray] = []
    for i, frame in enumerate(container.decode(stream)):
        if i % skip == 0:
            frames.append(frame.to_ndarray(format="rgb24"))
            if len(frames) >= max_frames:
                break
    container.close()
    return frames
