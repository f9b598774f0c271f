"""What every traffic generator shares: whole counts and even spacing from
a mix's shares and ranges, the scan decoder's frame plans, and the
rendering of synthetic video frames.

A mix is a data file, `benchmark/traffic/<name>.json`, whose `kind` names
the driver that reads it (`benchmark/drivers/<kind>.py`): each kind's
generator lives in its driver and builds on the helpers here.

Every seed gets the same sizes: lengths are evenly spaced over their
ranges (`evenly`) and classes split by whole counts (`class_sizes`), so a
seed changes the content and the order of the work, never its amount.

Videos are made of scenes: a source video of L frames is cut into one to
four scenes at random points, each scene a random 8 x 8 grid of colours
of its own that pans slowly (a whole number of pixels at each frame, over
a quarter to one and a half frame widths in the scene), as a long take
does. A few scenes of their own keep long videos apart in the embedding
space of random weights, where a video panning over many cycles of one
grid, or cutting between many grids, would average out to nearly the same
embedding as every other long video. Frames are drawn and rendered on the
device and kept on the host as uint8, as a decoder leaves them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

GRID = 8  # colour blocks per side of a frame
RENDER_CHUNK = 4096  # frames rendered per device pass


def evenly(lo: float, hi: float, n: int) -> np.ndarray:
    """n points evenly spaced over [lo, hi], at the centres of n equal bins."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / max(n, 1)


def class_sizes(total: int, shares: List[float]) -> List[int]:
    """Whole counts in proportion to `shares`, summing to `total`."""
    raw = [total * s / sum(shares) for s in shares]
    sizes = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(raw)), key=lambda i: raw[i] - sizes[i], reverse=True):
        if sum(sizes) == total:
            break
        sizes[i] += 1
    return sizes


def subsample_times(source: int, max_frames: int) -> np.ndarray:
    """The frames the scan's decoder keeps of a `source`-frame video: every
    skip-th, skip = source // max_frames above max_frames, at most
    max_frames (fingerprint.py:90-91)."""
    skip = max(1, source // max_frames) if source > max_frames else 1
    return np.arange(0, source, skip)[:max_frames]


def window_plan(source: int, clip_length: int) -> List[Tuple[int, int]]:
    """(start, length) windows of a 3D scan (fingerprint.py:293-318): the
    whole video up to clip_length frames, else min(5, max(3, source // (2
    clip_length))) evenly strided windows of clip_length frames."""
    if source <= clip_length:
        return [(0, source)]
    n = min(5, max(3, source // (clip_length * 2)))
    stride = (source - clip_length) // (n - 1)
    return [(i * stride, clip_length) for i in range(n)]


class Scenes:
    """The scenes of every content (a source video and its copies): where
    each starts, its grid and its velocity in pixels a frame."""

    def __init__(self, rng: np.random.Generator, sources: Sequence[int], size: int):
        self.starts, self.offset = [], []
        vy, vx, total = [], [], 0
        for length in sources:
            n = int(min(rng.integers(1, 5), max(1, length // 10)))
            cuts = np.sort(rng.choice(np.arange(1, length), n - 1, replace=False)) \
                if n > 1 else np.zeros(0, np.int64)
            starts = np.concatenate([[0], cuts]).astype(np.int64)
            ends = np.concatenate([cuts, [length]]).astype(np.int64)
            travel = rng.uniform(0.25, 1.5, n) * size  # pixels over the scene
            angle = rng.uniform(0, 2 * np.pi, n)
            speed = travel / np.maximum(ends - starts, 1)
            vy.append(speed * np.sin(angle))
            vx.append(speed * np.cos(angle))
            self.starts.append(starts)
            self.offset.append(total)
            total += n
        self.count = total
        self.vy, self.vx = np.concatenate(vy), np.concatenate(vx)

    def frames(self, content: int, times: np.ndarray):
        """(scene, row shift, column shift) of each source frame of `content`."""
        starts = self.starts[content]
        local = np.searchsorted(starts, times, side="right") - 1
        scene = self.offset[content] + local
        dt = times - starts[local]
        return (scene, np.floor(self.vy[scene] * dt).astype(np.int64),
                np.floor(self.vx[scene] * dt).astype(np.int64))


def render(gen: torch.Generator, scenes: Scenes, clip_content: List[int],
           clip_times: List[np.ndarray], size: int, device: torch.device) -> np.ndarray:
    """(F, size, size, 3) uint8 host frames of every clip, in order: a frame
    of a scene is the scene's grid shifted by its pan so far, wrapping at
    the frame's edge."""
    grids = torch.randint(0, 256, (scenes.count, GRID, GRID, 3), generator=gen, device=device,
                          dtype=torch.uint8)
    cell = size // GRID
    images = grids.repeat_interleave(cell, 1).repeat_interleave(cell, 2).reshape(-1, 3)
    params = [scenes.frames(c, t) for c, t in zip(clip_content, clip_times)]
    scene, dy, dx = (torch.from_numpy(np.concatenate([p[i] for p in params]))
                     for i in range(3))
    total = scene.shape[0]
    host = np.empty((total, size, size, 3), np.uint8)
    out = torch.from_numpy(host)
    axis = torch.arange(size, device=device)
    for lo in range(0, total, RENDER_CHUNK):
        g = scene[lo:lo + RENDER_CHUNK].to(device)
        ys = (axis[None, :] + dy[lo:lo + RENDER_CHUNK].to(device)[:, None]) % size
        xs = (axis[None, :] + dx[lo:lo + RENDER_CHUNK].to(device)[:, None]) % size
        flat = (g[:, None, None] * size + ys[:, :, None]) * size + xs[:, None, :]
        out[lo:lo + len(g)].copy_(images[flat])
    return host


def calibration_clips(config: dict, seed: int, device: torch.device, clips: int = 16
                      ) -> torch.Tensor:
    """(clips, T, S, S, 3) uint8 clips of the traffic's kind on `device`, for
    BatchNorm statistics: T = 32 frames (attention) or clip_length (3D)."""
    rng = np.random.default_rng([seed, 2])
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    T = config.get("clip_length", 128) if config["model_type"] != "attention" else 32
    frames = render(gen, Scenes(rng, [T] * clips, config["frame_size"]), list(range(clips)),
                    [np.arange(T)] * clips, config["frame_size"], device)
    return torch.from_numpy(frames).to(device).view(clips, T, *frames.shape[1:])
