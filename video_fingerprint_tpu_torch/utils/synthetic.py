"""Synthetic test videos: a copy of video_fingerprint_tpu/utils/synthetic.py
(make_corpus, and the near-duplicate families of make_hard_corpus), with
cv2 imported where it is used.

Procedurally generated mp4s stand in for a dataset download, so a scan can
be driven end to end on any machine with OpenCV.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def synthetic_frames(seed: int, num_frames: int, height: int = 96,
                     width: int = 128) -> np.ndarray:
    """Deterministic moving-pattern frames, (T, H, W, 3) uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    fx = rng.uniform(0.02, 0.12, size=3)
    fy = rng.uniform(0.02, 0.12, size=3)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    speed = rng.uniform(0.1, 0.5, size=3)
    base = rng.uniform(40, 200, size=3)

    frames = np.empty((num_frames, height, width, 3), np.uint8)
    for t in range(num_frames):
        for c in range(3):
            wave = np.sin(fx[c] * xx + fy[c] * yy + phase[c] + speed[c] * t)
            img = base[c] + 55 * wave
            frames[t, :, :, c] = np.clip(img, 0, 255).astype(np.uint8)
        bx = int((t * 3 + seed * 7) % (width - 16))
        by = int((t * 2 + seed * 13) % (height - 16))
        frames[t, by : by + 16, bx : bx + 16] = (seed * 37) % 255
    return frames


def write_video(path: Path, frames: np.ndarray, fps: float = 25.0) -> Path:
    import cv2

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {path}")
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def synthetic_frames_near(seed: int, base_seed: int, num_frames: int,
                          height: int = 96, width: int = 128,
                          mix: float = 0.25) -> np.ndarray:
    """A near-duplicate distractor of the `base_seed` video: (1 - mix) of
    its pixels from the base pattern, `mix` from a pattern of its own, so
    distinct video ids built on one base are hard negatives."""
    base = synthetic_frames(base_seed, num_frames, height, width).astype(np.float32)
    uniq = synthetic_frames(seed, num_frames, height, width).astype(np.float32)
    return np.clip((1 - mix) * base + mix * uniq, 0, 255).astype(np.uint8)


def make_hard_corpus(directory: Path, num_families: int = 6, per_family: int = 4,
                     num_frames: int = 48, mix: float = 0.25,
                     seed0: int = 0) -> list[Path]:
    """`num_families` base patterns, each spawning `per_family` distinct
    videos that share (1 - mix) of their content; every file is its own
    video id, so family siblings are hard cross-video negatives."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for f in range(num_families):
        base_seed = seed0 + 1000 + f
        for j in range(per_family):
            paths.append(write_video(
                directory / f"family{f}_v{j}.mp4",
                synthetic_frames_near(seed0 + f * per_family + j, base_seed,
                                      num_frames, mix=mix)))
    return paths


def make_corpus(directory: Path, num_unique: int = 4, num_frames: int = 48,
                duplicates: int = 2, seed0: int = 0) -> list[Path]:
    """`num_unique` distinct videos, the first `duplicates` of which get a
    byte-for-byte copy (guaranteed duplicate pairs)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(num_unique):
        paths.append(write_video(directory / f"video_{i}.mp4",
                                 synthetic_frames(seed0 + i, num_frames)))
    for i in range(duplicates):
        dup = directory / f"video_{i}_copy.mp4"
        dup.write_bytes(paths[i].read_bytes())
        paths.append(dup)
    return paths
