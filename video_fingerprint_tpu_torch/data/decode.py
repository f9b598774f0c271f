"""Video decode for the scan and the training pipeline (host side).

A copy of video_fingerprint_tpu/data/decode.py, with the codec packages
imported inside the functions that use them, so the port imports on a
machine without OpenCV:

  - "pyav":   PyAV, used when importable (the reference's decoder);
  - "opencv": cv2.VideoCapture (ffmpeg inside the wheel) otherwise.

Frames are RGB24 uint8. A decode failure gives an empty list in the
attention scan (fingerprint.py:105-107), a clip padded with black 480x640
frames in the 3D scan's windows (dataset.py:160-195), and 30 black frames
in training (dataset.py:151-153, `black_fallback_frames`).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@lru_cache(maxsize=1)
def default_backend() -> str:
    try:
        import av  # noqa: F401
    except ImportError:
        return "opencv"
    return "pyav"


@dataclasses.dataclass(frozen=True)
class VideoInfo:
    total_frames: int
    fps: float
    duration: float
    width: int = 0
    height: int = 0


def probe(path: Path | str) -> Optional[VideoInfo]:
    """Video metadata, or None when the file does not open (reference
    `_get_video_info`, fingerprint.py:111-129)."""
    try:
        if default_backend() == "pyav":
            import av

            container = av.open(str(path))
            stream = container.streams.video[0]
            total = stream.frames
            if total == 0 and stream.duration:
                total = int(stream.duration * stream.average_rate)
            fps = float(stream.average_rate or 0)
            w, h = stream.codec_context.width, stream.codec_context.height
            container.close()
        else:
            import cv2

            cap = cv2.VideoCapture(str(path))
            if not cap.isOpened():
                return None
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            fps = float(cap.get(cv2.CAP_PROP_FPS))
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            cap.release()
        duration = total / fps if fps > 0 else 0.0
        return VideoInfo(total_frames=total, fps=fps, duration=duration, width=w, height=h)
    except Exception:  # an unreadable file has no metadata, as in the reference
        return None


def decode_clip(path: Path | str, start_frame: int, num_frames: int) -> List[np.ndarray]:
    """`num_frames` contiguous frames from `start_frame`, padded by repeating
    the last frame, or with black 480x640 frames when nothing decoded
    (reference `_load_clip_frames`, dataset.py:160-195).

    PyAV seeks by timestamp and drops the frames decoded before it (the
    reference passes a frame index to `container.seek`, which PyAV reads in
    time_base units; the JAX package fixes that the same way); cv2 seeks
    with CAP_PROP_POS_FRAMES."""
    kept = _decode_span(path, start_frame, num_frames, None)
    frames = [kept[i] for i in range(len(kept))]
    while len(frames) < num_frames:
        frames.append(frames[-1].copy() if frames
                      else np.zeros((480, 640, 3), dtype=np.uint8))
    return frames[:num_frames]


def decode_frames(path: Path | str, indices: Sequence[int]) -> List[np.ndarray]:
    """The frames at `indices` (ascending, repeats allowed), one an index:
    the span from indices[0] to indices[-1] is decoded as `decode_clip`
    decodes it, and only the frames asked for are converted to RGB arrays.
    A frame past the video's end is the last frame that decoded, and every
    frame is black when nothing decoded, as `decode_clip` pads: the result
    is `decode_clip(path, indices[0], indices[-1] - indices[0] + 1)` at the
    indices' offsets."""
    first = int(indices[0])
    kept = _decode_span(path, first, int(indices[-1]) - first + 1,
                        {int(i) - first for i in indices})
    last = kept[max(kept)] if kept else np.zeros((480, 640, 3), dtype=np.uint8)
    return [kept.get(int(i) - first, last) for i in indices]


def _decode_span(path, start_frame: int, num_frames: int,
                 wanted: Optional[Set[int]]) -> Dict[int, np.ndarray]:
    """{offset: RGB frame} of the first `num_frames` frames from
    `start_frame` that decode, those at offsets in `wanted` only (every one
    for None), and the last that decoded where the video ends inside the
    span (which pads what follows); empty when decoding fails (the callers
    pad, as the reference does)."""
    walk = _decode_span_av if default_backend() == "pyav" else _decode_span_cv2
    try:
        kept, decoded = walk(path, start_frame, num_frames, wanted)
        if 0 < decoded < num_frames and decoded - 1 not in kept:
            kept.update(walk(path, start_frame, decoded, {decoded - 1})[0])
        return kept
    except Exception:
        return {}


def _decode_span_av(path, start_frame, num_frames, wanted) -> Tuple[Dict[int, np.ndarray], int]:
    import av

    container = av.open(str(path))
    stream = container.streams.video[0]
    fps = float(stream.average_rate or 0)
    target_pts = 0
    if start_frame > 0 and fps > 0 and stream.time_base:
        target_pts = int(start_frame / fps / stream.time_base)
        container.seek(target_pts, stream=stream)
    kept, offset = {}, 0
    for frame in container.decode(stream):
        if frame.pts is not None and frame.pts < target_pts:
            continue
        if wanted is None or offset in wanted:
            kept[offset] = frame.to_ndarray(format="rgb24")
        offset += 1
        if offset >= num_frames:
            break
    container.close()
    return kept, offset


def _decode_span_cv2(path, start_frame, num_frames, wanted) -> Tuple[Dict[int, np.ndarray], int]:
    import cv2

    kept, decoded = {}, 0
    cap = cv2.VideoCapture(str(path))
    if cap.isOpened():
        if start_frame > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        while decoded < num_frames and cap.grab():  # decodes; `retrieve` converts
            if wanted is None or decoded in wanted:
                ok, bgr = cap.retrieve()
                if not ok:
                    break
                kept[decoded] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            decoded += 1
    cap.release()
    return kept, decoded


def decode_subsampled(path: Path | str, max_frames: int,
                      skip_rate: Optional[int] = None) -> List[np.ndarray]:
    """Decode every skip-th frame up to `max_frames` frames. skip_rate=None
    derives skip = max(1, total // max_frames), the reference's subsampling
    policy (fingerprint.py:90-91, dataset.py:134); an explicit skip_rate
    (the train-time speed jitter) wins outright. Skipped frames are grabbed
    but not converted.
    """
    try:
        if default_backend() == "pyav":
            return _decode_subsampled_av(path, max_frames, skip_rate)
        return _decode_subsampled_cv2(path, max_frames, skip_rate)
    except Exception:  # an unreadable file decodes to nothing, as in the reference
        return []


def _derive_skip(total: int, max_frames: int, skip_rate: Optional[int]) -> int:
    """An explicit skip_rate is kept even below total // max_frames: the
    speed jitter's slow half (speed < 1) samples the first part of the video
    densely and the max_frames cap truncates (reference dataset.py:128-134)."""
    if skip_rate:
        return max(1, skip_rate)
    return max(1, total // max_frames) if total > max_frames else 1


def _decode_subsampled_cv2(path, max_frames, skip_rate) -> List[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        return []
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    skip = _derive_skip(total, max_frames, skip_rate)
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


def _decode_subsampled_av(path, max_frames, skip_rate) -> List[np.ndarray]:
    import av

    container = av.open(str(path))
    stream = container.streams.video[0]
    total = stream.frames
    if total == 0 and stream.duration:
        total = int(stream.duration * stream.average_rate)
    skip = _derive_skip(total, max_frames, skip_rate)
    frames: List[np.ndarray] = []
    for i, frame in enumerate(container.decode(stream)):
        if i % skip == 0:
            frames.append(frame.to_ndarray(format="rgb24"))
            if len(frames) >= max_frames:
                break
    container.close()
    return frames


def black_fallback_frames(n: int = 30) -> List[np.ndarray]:
    """The training decode-failure fallback (reference dataset.py:151-153)."""
    return [np.zeros((480, 640, 3), dtype=np.uint8) for _ in range(n)]
