"""Attention-based video fingerprint model.

Port of video_fingerprint_tpu/models/attention.py (reference model.py:182-298):
frame CNN -> temporal projection + positional encoding -> 2 multi-scale
temporal conv blocks -> 4 temporal attention blocks -> masked triple pooling
-> projection head -> L2 norm. An optional (B, T) frame-validity mask keeps
padded frames out of the convs, the attention keys and the pooling, so a
masked padded batch equals the unpadded forward; mask=None reproduces the
reference exactly.

The compute dtype is the parameters' dtype: `model.to(torch.bfloat16)`
computes in bf16 as the JAX model does with dtype=jnp.bfloat16; the
embedding is always returned in f32. `model.train()` selects the train
forward (batch statistics in BatchNorm, dropout, plain-math attention);
`model.eval()` the scan's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from video_fingerprint_tpu_torch.models.layers import (
    PositionalEncoding,
    SpatialEncoder,
    TemporalAttentionBlock,
    TemporalConvBlock,
)
from video_fingerprint_tpu_torch.ops.attention import MASKED_BIAS


class VideoFingerprintAttention(nn.Module):
    """Video -> L2-normalized embedding via frame CNN + temporal attention."""

    def __init__(self, spatial_dim: int = 128, temporal_dim: int = 256,
                 embedding_dim: int = 256, num_attention_blocks: int = 4,
                 num_heads: int = 8, fused: bool = False, s2d: bool = False):
        super().__init__()
        self.spatial_dim = spatial_dim
        self.spatial_encoder = SpatialEncoder(spatial_dim, fused=fused, s2d=s2d)
        self.temporal_projection = nn.Linear(spatial_dim, temporal_dim)
        self.pos_encoding = PositionalEncoding(temporal_dim)
        self.temporal_conv_blocks = nn.ModuleList(
            TemporalConvBlock(temporal_dim, (3, 5, 7, 11), fused=fused)
            for _ in range(2)
        )
        self.attention_blocks = nn.ModuleList(
            TemporalAttentionBlock(temporal_dim, num_heads)
            for _ in range(num_attention_blocks)
        )
        # reference model.py:215-217: Sequential(Conv1d(dim, dim, 1), ReLU)
        self.temporal_pool = nn.Sequential(nn.Conv1d(temporal_dim, temporal_dim, 1),
                                           nn.ReLU())
        self.final_projection = nn.Sequential(
            nn.Linear(3 * temporal_dim, temporal_dim), nn.ReLU(), nn.Dropout(0.1),
            nn.Linear(temporal_dim, embedding_dim),
        )
        self.temperature = nn.Parameter(torch.full((1,), 0.07))

    @property
    def dtype(self) -> torch.dtype:
        return self.temporal_projection.weight.dtype

    def temporal_encoding(self, features: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, spatial_dim) -> (B, T, temporal_dim)."""
        x = self.pos_encoding(self.temporal_projection(features))
        for conv_block in self.temporal_conv_blocks:
            # zero masked positions so the conv's zero padding matches an
            # unpadded sequence of the true length
            x_in = x if mask is None else x * mask[:, :, None].to(x.dtype)
            x = x + conv_block(x_in)
        for attn_block in self.attention_blocks:
            x = attn_block(x, mask=mask)
        return x

    def adaptive_pooling(self, features: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean | max | learned per-channel softmax over T, concatenated."""
        conv = self.temporal_pool[0]
        logits = F.relu(F.linear(features, conv.weight[:, :, 0], conv.bias))
        if mask is None:
            avg_pool = features.mean(dim=1)
            max_pool = features.amax(dim=1)
            weighted_pool = (features * torch.softmax(logits, dim=1)).sum(dim=1)
        else:
            m = mask[:, :, None].to(features.dtype)
            valid = m > 0
            denom = m.sum(dim=1).clamp_min(1.0)
            avg_pool = (features * m).sum(dim=1) / denom
            max_pool = torch.where(valid, features, MASKED_BIAS).amax(dim=1)
            weights = torch.softmax(torch.where(valid, logits, MASKED_BIAS), dim=1)
            weighted_pool = (features * weights * m).sum(dim=1)
        return torch.cat([avg_pool, max_pool, weighted_pool], dim=1)

    def forward_from_features(self, feats: torch.Tensor,
                              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, spatial_dim) per-frame features -> (B, embedding_dim) f32."""
        pooled = self.adaptive_pooling(self.temporal_encoding(feats, mask), mask)
        embedding = self.final_projection(pooled).float()
        # torch F.normalize(p=2, eps=1e-12): x / max(||x||, eps)
        norm = torch.linalg.vector_norm(embedding, dim=1, keepdim=True)
        return embedding / norm.clamp_min(1e-12)

    def input_from_frames(self, flat_frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames -> the spatial encoder's (N, C, H, W) input.
        uint8 frames are normalized by /255 on the device, in the compute
        dtype; float frames (already in [0, 1]) are cast to it. The
        (N, H, W, C) buffer is viewed as NCHW with channels-last strides,
        which costs nothing."""
        x = flat_frames.permute(0, 3, 1, 2)
        return x.to(self.dtype) / 255.0 if x.dtype == torch.uint8 else x.to(self.dtype)

    def _encode_flat(self, flat_frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames -> (N, spatial_dim). Where K6 engages (a
        card's uint8 frames under the fused bf16 eval model: `stem_engages`)
        the frames go to the spatial encoder as they are and K6 does the /255
        with conv0; all others go through input_from_frames."""
        if self.spatial_encoder.stem_engages(flat_frames):
            return self.spatial_encoder(flat_frames)
        return self.spatial_encoder(self.input_from_frames(flat_frames))

    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, T, spatial_dim), the per-frame CNN alone
        (JAX models/attention.py:81-95); the train step's extract reuse
        gathers rows of its output."""
        B, T = frames.shape[:2]
        flat = frames.reshape((B * T,) + tuple(frames.shape[2:]))
        return self._encode_flat(flat).reshape(B, T, self.spatial_dim)

    def forward_flat(self, flat_frames: torch.Tensor, batch_size: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B*T, H, W, C) pre-flattened frames -> (B, embedding_dim)."""
        T = flat_frames.shape[0] // batch_size
        feats = self._encode_flat(flat_frames).reshape(batch_size, T, self.spatial_dim)
        return self.forward_from_features(feats, mask)

    def forward(self, video: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, H, W, C) -> (B, embedding_dim), L2-normalized."""
        B = video.shape[0]
        return self.forward_flat(video.reshape((-1,) + tuple(video.shape[2:])), B, mask)
