"""Model registry, keyed by the same strings as the reference factory
(reference model.py:585-610) so checkpoint-embedded configs round-trip."""

from __future__ import annotations

from video_fingerprint_tpu_torch.models.attention import VideoFingerprintAttention

__all__ = ["create_model", "VideoFingerprintAttention"]


def create_model(model_type: str = "attention", **kwargs) -> VideoFingerprintAttention:
    """Create a fingerprint model (an nn.Module, float32, in train mode as
    torch creates every module; call .eval() for inference).

    kwargs: spatial_dim, temporal_dim, embedding_dim, num_attention_blocks
    (the reference's keys) and fused (BN folded into the convs; weights from
    models/fuse.py).
    """
    if model_type == "attention":
        return VideoFingerprintAttention(
            spatial_dim=kwargs.get("spatial_dim", 128),
            temporal_dim=kwargs.get("temporal_dim", 256),
            embedding_dim=kwargs.get("embedding_dim", 256),
            num_attention_blocks=kwargs.get("num_attention_blocks", 4),
            fused=kwargs.get("fused", False),
        )
    if model_type in ("3d", "cnn3d"):
        raise NotImplementedError(
            "the 3D-CNN model is not ported yet (ROADMAP.md, module item 7)")
    raise ValueError(f"Unknown model type: {model_type}")
