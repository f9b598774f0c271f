"""Contrastive pair samplers: a copy of video_fingerprint_tpu/data/pairs.py
(the same distributions as the reference, driven by an explicit
np.random.Generator, so the same seed gives the JAX package's pairs).

Attention mode (dataset.py:355-401): a pair of extracts from one video —
  ~33% exact temporal overlap, ~33% partial overlap with controlled offset,
  ~33% trimmed/extended variants. Validation: full video vs random extract.
3D mode (dataset.py:457-476): exact-same-clip 40%, else offset <= clip_len/3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _randint(rng: np.random.Generator, lo: int, hi: int) -> int:
    """Inclusive-range randint like the stdlib's random.randint."""
    return int(rng.integers(lo, hi + 1)) if hi >= lo else lo


def sample_extract_pair(
    n_frames: int,
    rng: np.random.Generator,
    min_extract_ratio: float = 0.5,
    train: bool = True,
) -> Tuple[slice, slice]:
    """Returns two slices into the frame list."""
    if not train:
        extract_len = _randint(rng, int(n_frames * min_extract_ratio), n_frames)
        start = _randint(rng, 0, n_frames - extract_len)
        return slice(0, n_frames), slice(start, start + extract_len)

    min_length = int(n_frames * min_extract_ratio)
    len1 = _randint(rng, min_length, n_frames)
    len2 = _randint(rng, min_length, n_frames)
    start1 = _randint(rng, 0, n_frames - len1)

    duplicate_type = rng.random()
    if duplicate_type < 0.33:  # exact overlap
        start2, len2 = start1, len1
    elif duplicate_type < 0.66:  # partial overlap
        overlap = _randint(rng, min_length // 3, max(min_length // 3, min(len1, len2) // 2))
        max_offset = max(0, min(len1, len2) - overlap)
        offset = _randint(rng, -max_offset, max_offset)
        start2 = max(0, min(start1 + offset, n_frames - len2))
    else:  # trimmed / extended
        quarter = max(1, len1 // 4)
        if rng.random() > 0.5:
            start2 = start1 + _randint(rng, 0, quarter)
            len2 = len1 - _randint(rng, 0, quarter)
        else:
            start2 = max(0, start1 - _randint(rng, 0, quarter))
            len2 = min(n_frames - start2, len1 + _randint(rng, 0, quarter))
    len2 = max(1, len2)
    start2 = max(0, min(start2, n_frames - len2))
    return slice(start1, start1 + len1), slice(start2, start2 + len2)


def sample_clip_start(
    total_frames: int,
    clip_length: int,
    rng: np.random.Generator,
    train: bool = True,
    clip_idx: int = 0,
) -> int:
    """3D-mode clip start (dataset.py:403-422)."""
    if total_frames <= clip_length:
        return 0
    if train:
        return _randint(rng, 0, total_frames - clip_length)
    if clip_idx == 0:
        return (total_frames - clip_length) // 2
    num_positions = 5
    position = clip_idx % num_positions
    return position * (total_frames - clip_length) // (num_positions - 1)


def sample_clip_pair_starts(
    total_frames: int,
    clip_length: int,
    rng: np.random.Generator,
    train: bool = True,
    clip_idx: int = 0,
) -> Tuple[int, int]:
    """3D-mode pair: 40% exact same clip, else offset <= clip_len/3."""
    start1 = sample_clip_start(total_frames, clip_length, rng, train, clip_idx)
    if not train:
        return start1, sample_clip_start(total_frames, clip_length, rng, train, clip_idx)
    if rng.random() < 0.4:
        return start1, start1
    max_offset = clip_length // 3
    offset = _randint(rng, -max_offset, max_offset)
    start2 = max(0, min(start1 + offset, max(0, total_frames - clip_length)))
    return start1, start2
