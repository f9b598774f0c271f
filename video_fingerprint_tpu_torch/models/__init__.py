"""Model registry, keyed by the same strings as the reference factory
(reference model.py:585-610) so checkpoint-embedded configs round-trip.

A reference quirk is kept, as the JAX package keeps it: the factory's 3D
`frame_stride` default is 16 (model.py:606), while the scanner reads 32
when a checkpoint's config names none."""

from __future__ import annotations

from torch import nn

from video_fingerprint_tpu_torch.models.attention import VideoFingerprintAttention
from video_fingerprint_tpu_torch.models.cnn3d import VideoFingerprint3D
from video_fingerprint_tpu_torch.models.timesformer import VideoFingerprintTimesformer

__all__ = ["create_model", "VideoFingerprintAttention", "VideoFingerprint3D",
           "VideoFingerprintTimesformer"]


def create_model(model_type: str = "attention", **kwargs) -> nn.Module:
    """Create a fingerprint model (an nn.Module, float32, in train mode as
    torch creates every module; call .eval() for inference).

    kwargs: spatial_dim, temporal_dim, embedding_dim, num_attention_blocks
    (attention), embedding_dim, frame_stride, dropout (3D), the reference's
    keys, fused (BN folded into the convs; weights from models/fuse.py) and,
    for attention, s2d (the space-to-depth first conv, off by default; with
    fused, weights from fuse_state_dict(s2d=True)); for "timesformer",
    VideoFingerprintTimesformer's keyword arguments (the names of
    `transformers`' TimesformerConfig: hidden_size, num_hidden_layers,
    num_attention_heads, intermediate_size, image_size, patch_size,
    num_frames, layer_norm_eps, qkv_bias; and embedding_dim, mean, std),
    TimeSformer-Base's by default.
    """
    if model_type == "attention":
        return VideoFingerprintAttention(
            spatial_dim=kwargs.get("spatial_dim", 128),
            temporal_dim=kwargs.get("temporal_dim", 256),
            embedding_dim=kwargs.get("embedding_dim", 256),
            num_attention_blocks=kwargs.get("num_attention_blocks", 4),
            fused=kwargs.get("fused", False),
            s2d=kwargs.get("s2d", False),
        )
    if model_type in ("3d", "cnn3d"):
        return VideoFingerprint3D(
            embedding_dim=kwargs.get("embedding_dim", 256),
            frame_stride=kwargs.get("frame_stride", 16),
            dropout=kwargs.get("dropout", 0.2),
            fused=kwargs.get("fused", False),
        )
    if model_type == "timesformer":
        return VideoFingerprintTimesformer(**kwargs)
    raise ValueError(f"Unknown model type: {model_type}")
