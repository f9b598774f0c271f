"""Reference embeddings of a whole library, computed in blocks so they fit.

The frame CNN runs over blocks of `frame_block` frames; the attention
model's temporal head then runs on the videos of one length together, up
to `video_block` at a time, each at its own length. The 3D model runs its
windows in blocks of the same length and reduces each video's windows
itself. Inputs are (T, H, W, 3) uint8 host arrays, as the program gets
them; outputs are (n, E) float32 on the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import models

FRAME_BLOCK = 8192
VIDEO_BLOCK = 32
WINDOW_BLOCK = 64


def attention_embeddings(clips: Sequence[np.ndarray], sd, heads: int, device,
                         quant: models.Quant = None) -> np.ndarray:
    """One embedding per clip, the clip at its own length."""
    by_length = defaultdict(list)
    for i, clip in enumerate(clips):
        by_length[clip.shape[0]].append(i)
    out = np.zeros((len(clips), sd["final_projection.3.weight"].shape[0]), np.float32)
    with torch.no_grad(), models.exact_float32():
        for T, members in sorted(by_length.items()):
            for lo in range(0, len(members), VIDEO_BLOCK):
                block = members[lo:lo + VIDEO_BLOCK]
                frames = np.concatenate([clips[i] for i in block])
                feats = torch.cat([
                    models.frame_features(torch.from_numpy(frames[f:f + FRAME_BLOCK]).to(device),
                                          sd, quant)
                    for f in range(0, len(frames), FRAME_BLOCK)])
                emb = models.attention_head(feats.view(len(block), T, -1), sd, heads, quant)
                out[block] = emb.cpu().numpy()
    return out


def cnn3d_embeddings(videos: Sequence[List[np.ndarray]], sd, frame_stride: int, device,
                     quant: models.Quant = None) -> np.ndarray:
    """One embedding per video from its windows: a single window's as it is,
    several windows' mean renormalized."""
    windows = [(v, w) for v, clips in enumerate(videos) for w in range(len(clips))]
    by_length = defaultdict(list)
    for v, w in windows:
        by_length[videos[v][w].shape[0]].append((v, w))
    per_window = {}
    with torch.no_grad(), models.exact_float32():
        for T, members in sorted(by_length.items()):
            for lo in range(0, len(members), WINDOW_BLOCK):
                block = members[lo:lo + WINDOW_BLOCK]
                x = torch.from_numpy(np.stack([videos[v][w] for v, w in block])).to(device)
                emb = models.cnn3d_forward(x, sd, frame_stride, quant)
                for key, e in zip(block, emb):
                    per_window[key] = e
        out = [models.mean_of_windows(torch.stack([per_window[(v, w)]
                                                   for w in range(len(clips))]))
               for v, clips in enumerate(videos)]
    return torch.stack(out).cpu().numpy()


def library_embeddings(config: dict, videos: Sequence[List[np.ndarray]], sd, device,
                       quant: Optional[models.Quant] = None) -> np.ndarray:
    """(n, E) reference embeddings of n videos, each a list of clips (one
    clip for the attention model, its windows for the 3D model)."""
    if config["model_type"] == "attention":
        return attention_embeddings([v[0] for v in videos], sd, config["num_heads"], device,
                                    quant)
    return cnn3d_embeddings(videos, sd, config["frame_stride"], device, quant)
