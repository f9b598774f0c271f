"""What the scanner needs to know of each model family, in one place.

`FingerprintScanner` reads one `ModelFamily` built from the checkpoint's
config (`family_for`) and branches on nothing else:

- `frame_size`, `clip_length`: the staged frames' side and a window's
  frames, the config's or the family's defaults;
- `build`: the model, from the config's widths;
- `prepare`: the memory layout the model's convs take on a card;
- `clip_range`, `bucket`, `warmup_lengths`: the clip lengths the batching
  stage takes and the padded length of each;
- `forward`: a staged (B, T, H, W, 3) batch and its (B, T) mask -> (B, E);
- `windowed`: a video is a list of windows, each embedded alone and
  reduced to the video's embedding (`reduce_windows`), with `window_plan`
  and `frames_of` (the offsets in a window of the frames the model takes,
  None for every frame); otherwise a video is one subsampled clip;
- `host_floats`: the decode producer may stage float32 clips normalized on
  the host (the native preprocess path).

The families: the attention model (masked length buckets), the 3D CNN
(windows of up to clip_length frames in stride-multiple buckets, whose zero
padding is the model's own) and TimeSformer (windows of clip_length
frames, num_frames sampled from each, one bucket).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
from torch import nn

from video_fingerprint_tpu_torch.data import preprocess
from video_fingerprint_tpu_torch.models import create_model

MIN_FRAMES = 10  # reference minimum (fingerprint.py:238-240)
MODEL_TYPES = ("attention", "3d", "cnn3d", "timesformer")


class ModelFamily:
    windowed = False
    host_floats = False
    FRAME_SIZE = 64  # the staged frames' side, where the config names none

    def __init__(self, config: dict):
        self.frame_size = config.get("frame_size", self.FRAME_SIZE)

    def build(self, config: dict, fused: bool) -> nn.Module:
        raise NotImplementedError

    def prepare(self, model: nn.Module) -> None:
        """Lay the model out as the card's kernels take it (nothing by default)."""

    @property
    def clip_range(self) -> Tuple[int, int]:
        raise NotImplementedError

    def bucket(self, num_frames: int) -> int:
        raise NotImplementedError

    def warmup_lengths(self, num_frames: Optional[int]) -> Set[int]:
        raise NotImplementedError

    def forward(self, model: nn.Module, frames: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return model(frames)


class AttentionFamily(ModelFamily):
    host_floats = True

    def __init__(self, config: dict, buckets: Sequence[int]):
        super().__init__(config)
        self.max_frames = config.get("max_frames", 500)
        self.buckets = tuple(buckets)

    def build(self, config: dict, fused: bool) -> nn.Module:
        return create_model("attention", spatial_dim=config.get("spatial_dim", 128),
                            temporal_dim=config.get("temporal_dim", 256),
                            embedding_dim=config.get("embedding_dim", 256),
                            num_attention_blocks=config.get("num_attention_blocks", 4),
                            fused=fused)

    def prepare(self, model: nn.Module) -> None:
        model.spatial_encoder.to(memory_format=torch.channels_last)

    @property
    def clip_range(self) -> Tuple[int, int]:
        return 1, self.max_frames

    def bucket(self, num_frames: int) -> int:
        return preprocess.bucket_for_length(num_frames, self.buckets)

    def warmup_lengths(self, num_frames: Optional[int]) -> Set[int]:
        if num_frames is None:
            return set(self.buckets)
        return {self.bucket(min(num_frames, self.max_frames))}

    def forward(self, model, frames, mask):
        return model.forward_flat(frames.view((-1,) + tuple(frames.shape[2:])),
                                  frames.shape[0], mask)


class WindowedFamily(ModelFamily):
    windowed = True
    CLIP_LENGTH = 128  # a window's frames, where the config names none

    def __init__(self, config: dict):
        super().__init__(config)
        self.clip_length = config.get("clip_length", self.CLIP_LENGTH)

    def window_plan(self, total_frames: int) -> List[Tuple[int, int]]:
        """Windows (start, length) of a video of total_frames frames: one
        window of the whole video up to clip_length frames, else
        min(5, max(3, total // (2 * clip_length))) evenly strided windows of
        clip_length frames (fingerprint.py:293-318)."""
        L = self.clip_length
        if total_frames <= L:
            return [(0, total_frames)]
        n = min(5, max(3, total_frames // (L * 2)))
        stride = (total_frames - L) // (n - 1)
        return [(i * stride, L) for i in range(n)]

    def frames_of(self, length: int) -> Optional[np.ndarray]:
        """Offsets in a window of `length` frames of the frames the model
        takes; None for all of them."""
        return None


class Cnn3dFamily(WindowedFamily):
    def __init__(self, config: dict):
        super().__init__(config)
        self.frame_stride = config.get("frame_stride", 32)

    def build(self, config: dict, fused: bool) -> nn.Module:
        return create_model("3d", embedding_dim=config.get("embedding_dim", 256),
                            frame_stride=self.frame_stride, fused=fused)

    def prepare(self, model: nn.Module) -> None:
        model.encoder.to(memory_format=torch.channels_last_3d)

    @property
    def clip_range(self) -> Tuple[int, int]:
        return 1, self.clip_length

    def bucket(self, num_frames: int) -> int:
        """The next multiple of frame_stride, capped at clip_length. The model
        zero-pads time to that multiple anyway (models/cnn3d.py), so a clip
        padded there embeds as its own length does, and short videos share
        batches."""
        stride = max(1, self.frame_stride)
        return min(self.clip_length, -(-num_frames // stride) * stride)

    def warmup_lengths(self, num_frames: Optional[int]) -> Set[int]:
        lengths = {self.clip_length}
        if num_frames is not None and num_frames < self.clip_length:
            lengths.add(self.bucket(max(MIN_FRAMES, num_frames)))
        return lengths


class TimesformerFamily(WindowedFamily):
    """Windows of clip_length frames (256 by default, 8 frames at a sampling
    rate of 32), num_frames sampled from each."""

    KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "patch_size", "num_frames", "layer_norm_eps", "qkv_bias", "embedding_dim",
            "mean", "std")

    FRAME_SIZE = 224
    CLIP_LENGTH = 256

    def __init__(self, config: dict):
        super().__init__(config)
        self.num_frames = config.get("num_frames", 8)

    def build(self, config: dict, fused: bool) -> nn.Module:
        kwargs = {k: config[k] for k in self.KEYS if k in config}
        return create_model("timesformer", image_size=self.frame_size, **kwargs)

    def frames_of(self, length: int) -> np.ndarray:
        """floor(i * length / num_frames) for i < num_frames: every
        (length / num_frames)-th frame of a full window (i * 32 at 256 / 8),
        and frames repeated in a window shorter than num_frames."""
        return np.arange(self.num_frames) * length // self.num_frames

    @property
    def clip_range(self) -> Tuple[int, int]:
        return self.num_frames, self.num_frames

    def bucket(self, num_frames: int) -> int:
        return self.num_frames

    def warmup_lengths(self, num_frames: Optional[int]) -> Set[int]:
        return {self.num_frames}


def family_for(model_type: str, config: dict, buckets: Sequence[int] = ()) -> ModelFamily:
    """The family of a checkpoint's model_type (its config's widths);
    `buckets` are the attention model's length buckets, max_frames last."""
    if model_type == "attention":
        return AttentionFamily(config, buckets)
    if model_type in ("3d", "cnn3d"):
        return Cnn3dFamily(config)
    if model_type == "timesformer":
        return TimesformerFamily(config)
    raise ValueError(f"Unknown model type: {model_type}")
