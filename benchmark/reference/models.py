"""Plain float32 forwards of the two fingerprint models, from their equations.

Written from the upstream reference (github.com/Alexandre-nk-Perdereau/
video-fingerprint, model.py:74-179 for the layers, :182-298 for
VideoFingerprintAttention, :393-512 for VideoFingerprint3D). Both functions
read a state dict in that reference's key layout, and neither imports
anything of the program under test:

- eval BatchNorm is computed unfused, from running statistics;
- every video runs at its own length, without padding or masks;
- every conv, linear and attention product runs in float32 with TF32 off
  (`exact_float32`), unless the caller passes `quant`, which rounds both
  operands of each product first (the control's lower precision).

With `stats` (a dict) each BatchNorm normalizes by its batch's statistics
and writes them into `stats` under the state dict's running-statistics
keys, unbiased as torch's train mode does: one pass over seeded clips sets
the statistics of freshly drawn weights (reference/weights.py).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5  # BatchNorm and LayerNorm, torch's default in the reference
KERNELS_1D = (3, 5, 7, 11)  # the temporal conv block's branches (model.py:124)
# (conv index, BatchNorm index, kernel padding) of the frame CNN's Sequential
SPATIAL = ((0, 1, 2), (3, 4, 1), (6, 7, 1), (9, 10, 1))

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
StateDict = Dict[str, torch.Tensor]


@contextmanager
def exact_float32():
    """cuBLAS and cuDNN in full float32 inside the block (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _conv(x, sd: StateDict, key: str, quant: Quant, **kwargs) -> torch.Tensor:
    w = sd[f"{key}.weight"]
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[w.dim()]
    return fn(_q(quant, x), _q(quant, w), sd[f"{key}.bias"], **kwargs)


def _linear(x, sd: StateDict, key: str, quant: Quant) -> torch.Tensor:
    w = sd[f"{key}.weight"]
    if w.dim() == 3:  # a 1x1 Conv1d used pointwise
        w = w[:, :, 0]
    return F.linear(_q(quant, x), _q(quant, w), sd[f"{key}.bias"])


def _batch_norm(x, sd: StateDict, key: str, stats: Optional[dict]) -> torch.Tensor:
    dims = [0] + list(range(2, x.dim()))
    if stats is None:
        mean, var = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
    else:
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        n = x.numel() // x.shape[1]
        stats[f"{key}.running_mean"] = mean
        stats[f"{key}.running_var"] = var * n / max(n - 1, 1)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = sd[f"{key}.weight"] / torch.sqrt(var + EPS)
    return (x - mean.view(shape)) * scale.view(shape) + sd[f"{key}.bias"].view(shape)


def _normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.vector_norm(e, dim=1, keepdim=True).clamp_min(1e-12)


def positional_table(frames: int, dim: int, device) -> torch.Tensor:
    """The sinusoidal table of model.py:74-90, in float32 as it computes it."""
    position = torch.arange(frames, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros(frames, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def frame_features(frames: torch.Tensor, sd: StateDict, quant: Quant = None,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> (N, spatial_dim): four stride-2 convs,
    each with BatchNorm and ReLU, a mean over the frame, a linear layer."""
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    for conv, bn, pad in SPATIAL:
        x = _conv(x, sd, f"spatial_encoder.encoder.{conv}", quant, stride=2, padding=pad)
        x = F.relu(_batch_norm(x, sd, f"spatial_encoder.encoder.{bn}", stats))
    return _linear(x.mean(dim=(2, 3)), sd, "spatial_encoder.encoder.14", quant)


def attention_head(features: torch.Tensor, sd: StateDict, heads: int, quant: Quant = None,
                   stats: Optional[dict] = None, normalize: bool = True) -> torch.Tensor:
    """(B, T, spatial_dim) features of B videos of T frames each -> (B, E)
    unit embeddings: projection plus positional table, two multi-scale
    temporal conv blocks (residual), the pre-LN attention blocks, mean |
    max | learned softmax pooling over T, the two-layer projection."""
    B, T, _ = features.shape
    x = _linear(features, sd, "temporal_projection", quant)
    C = x.shape[-1]
    x = x + positional_table(T, C, x.device)
    for block in range(2):
        xt = x.transpose(1, 2)
        branches = []
        for j, k in enumerate(KERNELS_1D):
            key = f"temporal_conv_blocks.{block}.convs.{j}"
            groups = sd[f"{key}.0.weight"].shape[0]
            y = _conv(xt, sd, f"{key}.0", quant, padding=k // 2, groups=groups)
            branches.append(F.relu(_batch_norm(y, sd, f"{key}.1", stats)))
        x = x + torch.cat(branches, dim=1).transpose(1, 2)
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("attention_blocks.")})
    D = C // heads
    for i in range(n_blocks):
        key = f"attention_blocks.{i}"
        h = F.layer_norm(x, (C,), sd[f"{key}.norm1.weight"], sd[f"{key}.norm1.bias"], EPS)
        qkv = F.linear(_q(quant, h), _q(quant, sd[f"{key}.attn.in_proj_weight"]),
                       sd[f"{key}.attn.in_proj_bias"])
        q, k, v = qkv.view(B, T, 3, heads, D).permute(2, 0, 3, 1, 4)
        p = torch.softmax(_q(quant, q) @ _q(quant, k).transpose(-1, -2) / math.sqrt(D), dim=-1)
        o = (_q(quant, p) @ _q(quant, v)).transpose(1, 2).reshape(B, T, C)
        x = x + _linear(o, sd, f"{key}.attn.out_proj", quant)
        h = F.layer_norm(x, (C,), sd[f"{key}.norm2.weight"], sd[f"{key}.norm2.bias"], EPS)
        h = F.gelu(_linear(h, sd, f"{key}.conv1", quant))
        x = x + _linear(h, sd, f"{key}.conv2", quant)
    weights = torch.softmax(F.relu(_linear(x, sd, "temporal_pool.0", quant)), dim=1)
    pooled = torch.cat([x.mean(dim=1), x.amax(dim=1), (x * weights).sum(dim=1)], dim=1)
    e = _linear(F.relu(_linear(pooled, sd, "final_projection.0", quant)), sd,
                "final_projection.3", quant)
    return _normalize(e) if normalize else e


def cnn3d_blocks(stride: int):
    """(kernel, stride, padding) of the four Conv3d blocks (model.py:420-430)."""
    return (((stride, 5, 5), (stride, 2, 2), (0, 2, 2)), (3, (1, 2, 2), 1),
            (3, (2, 2, 2), 1), (3, (1, 2, 2), 1))


def cnn3d_forward(clips: torch.Tensor, sd: StateDict, frame_stride: int, quant: Quant = None,
                  stats: Optional[dict] = None, normalize: bool = True) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 windows -> (B, E) unit embeddings: T zero-padded
    to a multiple of frame_stride, four Conv3d blocks with BatchNorm and
    ReLU, a mean over the frame, a temporal conv, attention weights over
    the remaining steps, the weighted sum plus the mean, the projector."""
    x = clips.float() / 255.0
    pad = -x.shape[1] % frame_stride
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, pad))
    x = x.permute(0, 4, 1, 2, 3)
    for i, (_, stride, padding) in enumerate(cnn3d_blocks(frame_stride)):
        x = _conv(x, sd, f"encoder.{i}.conv", quant, stride=stride, padding=padding)
        x = F.relu(_batch_norm(x, sd, f"encoder.{i}.bn", stats))
    temporal = _conv(x.mean(dim=(3, 4)), sd, "temporal_conv", quant, padding=1)
    weights = torch.softmax(_conv(temporal, sd, "temporal_attention", quant), dim=2)
    combined = (temporal * weights).sum(dim=2) + temporal.mean(dim=2)
    e = _linear(F.relu(_linear(combined, sd, "projector.0", quant)), sd, "projector.3", quant)
    return _normalize(e) if normalize else e


def mean_of_windows(window_embeddings: torch.Tensor) -> torch.Tensor:
    """One 3D video's embedding from its (n, E) windows': a single window's
    as it is, several windows' mean renormalized (fingerprint.py:300-318)."""
    if window_embeddings.shape[0] == 1:
        return window_embeddings[0]
    return _normalize(window_embeddings.mean(dim=0, keepdim=True))[0]
