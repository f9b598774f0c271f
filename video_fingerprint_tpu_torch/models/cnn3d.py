"""Strided 3D-CNN fingerprint model, eval mode.

Port of video_fingerprint_tpu/models/cnn3d.py (reference model.py:406-512):
four Conv3d blocks, the first striding time by `frame_stride`, a mean over
H and W, a temporal conv1d, a softmax attention over the remaining T', an
attention-weighted sum plus the mean over T', a two-layer projector and an
L2 norm. Submodules carry the reference's state_dict keys (`encoder.{0..3}`,
`temporal_conv`, `temporal_attention`, `projector.{0,3}`, `temperature`),
so a reference `.pth` loads strictly.

Videos enter as (B, T, H, W, C), the layout the scanner stages. The model
views them as NCDHW with channels-last-3d strides, which costs nothing and
is the layout cuDNN takes directly. The compute dtype is the parameters'
dtype; the embedding is always returned in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_fingerprint_tpu_torch.models.layers import Conv3DBlock


class VideoFingerprint3D(nn.Module):
    """Video -> L2-normalized embedding via a strided 3D CNN."""

    def __init__(self, embedding_dim: int = 256, frame_stride: int = 32,
                 dropout: float = 0.2, fused: bool = False):
        super().__init__()
        s = self.frame_stride = frame_stride
        # (in, out, kernel, stride, padding); the reference's channel
        # comments say 512, its code (followed here and in JAX) 16..128
        blocks = [(3, 16, (s, 5, 5), (s, 2, 2), (0, 2, 2)),
                  (16, 32, 3, (1, 2, 2), 1),
                  (32, 64, 3, (2, 2, 2), 1),
                  (64, 128, 3, (1, 2, 2), 1)]
        self.encoder = nn.Sequential(*(Conv3DBlock(*b, fused=fused) for b in blocks))
        self.temporal_conv = nn.Conv1d(128, 128, 3, padding=1)
        self.temporal_attention = nn.Conv1d(128, 1, 1)
        self.projector = nn.Sequential(nn.Linear(128, 128), nn.ReLU(), nn.Dropout(dropout),
                                       nn.Linear(128, embedding_dim))
        self.temperature = nn.Parameter(torch.full((1,), 0.07))
        # the reference's _initialize_weights (model.py:458-470); the
        # temporal conv1ds keep torch's default init, as there
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.01)
                nn.init.zeros_(m.bias)

    @property
    def dtype(self) -> torch.dtype:
        return self.temporal_conv.weight.dtype

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, C) uint8 or float -> (B, embedding_dim) f32, unit norm.

        uint8 is divided by 255 in the compute dtype. T is zero-padded to a
        multiple of frame_stride after that, so a short clip equals its
        zero-padded version (JAX cnn3d.py:86-90).
        """
        if video.dtype == torch.uint8:
            video = video.to(self.dtype) / 255.0
        else:
            video = video.to(self.dtype)
        pad = -video.shape[1] % self.frame_stride
        if pad:
            video = F.pad(video, (0, 0, 0, 0, 0, 0, 0, pad))
        x = self.encoder(video.permute(0, 4, 1, 2, 3))  # NCDHW, channels-last-3d
        features = x.mean(dim=(3, 4))  # (B, 128, T')
        temporal = self.temporal_conv(features)
        weights = torch.softmax(self.temporal_attention(temporal), dim=2)  # (B, 1, T')
        combined = (temporal * weights).sum(dim=2) + temporal.mean(dim=2)
        embedding = self.projector(combined).float()
        # torch F.normalize(p=2, eps=1e-12): x / max(||x||, eps)
        norm = torch.linalg.vector_norm(embedding, dim=1, keepdim=True)
        return embedding / norm.clamp_min(1e-12)
