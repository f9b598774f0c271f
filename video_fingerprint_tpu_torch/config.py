"""Typed training/serving configuration: a copy of
video_fingerprint_tpu/config.py (the same keys, defaults and derived LRs),
with `device` defaulting to "cuda".

The reference assembles an ad-hoc dict in `main` (train.py:783-807) and embeds
it in checkpoints; the scanner reads it back with per-key defaults
(fingerprint.py:37-41). This dataclass is the typed source of truth with the
exact same key names, so `to_dict()` round-trips into the checkpoint contract
and `from_dict()` accepts reference-written configs (unknown keys preserved).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Config:
    # optimization
    batch_size: int = 8
    epochs: int = 50
    learning_rate: float = 1e-4
    lr_spatial: Optional[float] = None    # derived: lr * 0.1 (train.py:787)
    lr_attention: Optional[float] = None  # derived: lr * 0.5 (train.py:788)
    weight_decay: float = 1e-4
    triplet_weight: float = 0.3
    triplet_margin: float = 0.3
    patience: int = 10

    # data
    frame_size: int = 64
    max_frames: int = 500
    clip_length: int = 128
    frame_stride: int = 32
    min_extract_ratio: float = 0.5
    num_workers: int = 4
    data_dir: str = ""

    # model
    model_type: str = "attention"
    embedding_dim: int = 256
    spatial_dim: int = 128
    temporal_dim: int = 256
    num_attention_blocks: int = 4

    # framework additions (the JAX package defaults device to "tpu")
    device: str = "cuda"
    seed: int = 0
    mask_padding: bool = True
    profile: bool = False
    command_line: str = ""

    # unknown keys from external configs are preserved for round-trip
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.model_type not in ("attention", "3d", "cnn3d"):
            raise ValueError(f"unknown model_type {self.model_type!r}")
        if self.lr_spatial is None:
            self.lr_spatial = self.learning_rate * 0.1
        if self.lr_attention is None:
            self.lr_attention = self.learning_rate * 0.5
        if not 0 < self.min_extract_ratio <= 1:
            raise ValueError("min_extract_ratio must be in (0, 1]")
        if self.batch_size < 1 or self.epochs < 1:
            raise ValueError("batch_size and epochs must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d.update(d.pop("extras"))
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)} - {"extras"}
        known = {k: v for k, v in d.items() if k in names}
        extras = {k: v for k, v in d.items() if k not in names}
        # the reference stores use_amp; accept and park it in extras
        return cls(**known, extras=extras)
