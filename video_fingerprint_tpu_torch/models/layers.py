"""Layers of the fingerprint models, in eval and train mode.

Submodules are named after the upstream reference's state_dict keys
(reference model.py:74-179; the key table is utils/torch_compat.py), so a
reference `.pth` loads with a strict `load_state_dict`. Sequences are
(B, T, C) as in the JAX package; frames enter the spatial encoder as NCHW
views of channels-last memory, the layout cuDNN takes directly.

Convs, projections and the MLP are cuDNN/cuBLAS calls, but for the bf16
eval spatial encoder's first conv on a card's uint8 frames, which is the
hand-written stem kernel in ops/stem.py. In eval mode the attention
itself is the hand-written kernel in ops/attention.py; in train
mode it is plain torch math with dropout on the weights, as the JAX
package computes it outside its Pallas kernel (models/layers.py:320-332
there). Dropout sits where the JAX package has it (nn.Dropout modules,
which hold no parameters, so the state_dict keys do not change); BatchNorm
in train mode is torch's, whose momentum 0.1 and unbiased running variance
are what the JAX `TorchBatchNorm` does. When the process is one rank of
several (parallel/distributed.py), train-mode BatchNorm takes the
statistics of the global batch instead, as JAX does under GSPMD
(`_global_batch_norm`).
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_fingerprint_tpu_torch.ops import stem
from video_fingerprint_tpu_torch.ops.attention import MASKED_BIAS, multihead_attention
from video_fingerprint_tpu_torch.parallel.distributed import all_reduce_sum, world_size

PE_MAX_LEN = 10000  # reference model.py:80 registers a 10000-row table


@lru_cache(maxsize=8)
def _sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table to (B, T, C); keeps the reference's
    persistent buffer `pe` of shape (1, 10000, C). Row t of the table does
    not depend on its length, so slicing it equals the JAX package's
    per-length `positional_encoding`; past the buffer's rows the table is
    built for T, as JAX builds it for any T."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(_sinusoidal_table(max_len, d_model).copy())[None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        if T <= self.pe.shape[1]:
            pe = self.pe[:, :T]
        else:
            pe = torch.from_numpy(_sinusoidal_table(T, x.shape[2]))[None].to(x.device)
        return x + pe.to(x.dtype)


def _global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm over the global batch of every rank (JAX
    models/layers.py:111-124): per channel, sum x, sum x^2 and the count in
    f32, summed over the ranks by one differentiable all_reduce; mean and
    E[x^2] from them, var = max(E[x^2] - mean^2, 0), and the running
    variance updated unbiased with the global count."""
    if bn.num_batches_tracked is not None:
        bn.num_batches_tracked.add_(1)
    m = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
    C = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                     xf.new_full((1,), x.numel() / C)]))
    n = sums[2 * C]
    mean = sums[:C] / n
    var = torch.clamp(sums[C:2 * C] / n - mean * mean, min=0.0)
    if m:  # momentum 0 (a recomputed forward) leaves the statistics as they are
        with torch.no_grad():
            unbiased = var * n / torch.clamp(n - 1, min=1.0)
            bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1.0 - m) * bn.running_var + m * unbiased)
    shape = (1, C) + (1,) * (x.dim() - 2)
    y = (xf - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    return (y * bn.weight.view(shape) + bn.bias.view(shape)).to(x.dtype)


class _GlobalStats:
    """A torch BatchNorm that normalizes by the global batch's statistics
    in train mode under more than one rank; otherwise torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and world_size() > 1:
            self._check_input_dim(x)
            return _global_batch_norm(self, x)
        return super().forward(x)


class BatchNorm1d(_GlobalStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_GlobalStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(_GlobalStats, nn.BatchNorm3d):
    pass


def _bn_or_identity(bn: nn.Module, fused: bool) -> nn.Module:
    return nn.Identity() if fused else bn


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2): each 2x2 block of pixels becomes
    one pixel of 4C channels, channel (u * 2 + v) * C + c holding channel c
    of the block's pixel (u, v), the packing of JAX SpatialEncoder's
    (n, h, w, c) -> (n, h/2, w/2, 4c) reshape (layers.py:243-258). The
    result is channels-last in memory, as the encoder's convs take it."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs an even frame size, got {h}x{w}")
    nhwc = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    blocks = nhwc.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    return blocks.permute(0, 3, 1, 2)


class SpatialEncoder(nn.Module):
    """4x stride-2 conv (+BN) + ReLU, global mean, Linear. (N, 3, H, W) -> (N, out).

    fused=True drops the BatchNorms: their eval affine is folded into the
    conv weights by models/fuse.py. s2d=True takes the space-to-depth layout
    of the first conv (JAX `s2d`, off by default): the input's 2x2 blocks
    become 12 channels and conv0 a 3x3 stride-1 conv with padding 1, whose
    weights come from models/fuse.py (fuse_state_dict(s2d=True)).

    Where `stem_engages` them, forward takes a card's (N, H, W, 3) uint8
    frames as they are: K6 (ops/stem.py) then does their /255, conv0, its
    bias and its ReLU in one kernel, and encoder[3:] goes on from there.
    """

    def __init__(self, out_dim: int = 128, fused: bool = False, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        layers = []
        in_ch = 3
        for ch, k, p in [(32, 5, 2), (64, 3, 1), (128, 3, 1), (256, 3, 1)]:
            conv = (nn.Conv2d(4 * in_ch, ch, 3, stride=1, padding=1) if s2d and in_ch == 3
                    else nn.Conv2d(in_ch, ch, k, stride=2, padding=p))
            layers += [conv, _bn_or_identity(BatchNorm2d(ch), fused), nn.ReLU()]
            in_ch = ch
        layers += [nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(in_ch, out_dim)]
        self.encoder = nn.Sequential(*layers)  # indices 0..14 as in the reference

    def stem_engages(self, frames: torch.Tensor) -> bool:
        """Whether K6 computes conv0 for these frames: uint8 frames on a card,
        eval mode, bf16, conv0 the 5x5 stride-2 3 -> 32 conv with its
        BatchNorm folded, no s2d, and no gradient to keep (K6 has no
        backward). Their shape and layout do not decide: K6 raises on frames
        it does not take."""
        conv0 = self.encoder[0]
        return (frames.dtype == torch.uint8 and frames.is_cuda
                and not self.training and not self.s2d
                and isinstance(self.encoder[1], nn.Identity)
                and conv0.weight.dtype == torch.bfloat16
                and (conv0.in_channels, conv0.out_channels, conv0.kernel_size,
                     conv0.stride, conv0.padding)
                == (stem.CIN, stem.COUT, (stem.KSIZE,) * 2, (stem.STRIDE,) * 2,
                    (stem.PAD,) * 2)
                and not (torch.is_grad_enabled() and conv0.weight.requires_grad))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:  # (N, H, W, 3) frames, where stem_engages them
            conv0 = self.encoder[0]
            x = stem.stem_conv(x, conv0.weight, conv0.bias).permute(0, 3, 1, 2)
            for layer in itertools.islice(self.encoder, 3, None):
                x = layer(x)
            return x
        return self.encoder(space_to_depth(x) if self.s2d else x)


class MultiHeadSelfAttention(nn.Module):
    """nn.MultiheadAttention(batch_first=True)'s parameters, with an optional
    (B, T) key-padding mask. Eval: the hand-written kernel
    (ops/attention.py). Train: plain math with dropout on the weights."""

    def __init__(self, dim: int, num_heads: int = 8, drop: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.attn_drop = nn.Dropout(drop)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        B, T, C = x.shape
        H = self.num_heads
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        # (B, T, 3, H, D) -> three (B, H, T, D) views of the one projection
        q, k, v = qkv.view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4).unbind(0)
        if self.training:
            out = self._train_attention(q, k, v, mask)
        else:
            out = multihead_attention(q, k, v, mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))

    def _train_attention(self, q, k, v, mask):
        """JAX models/layers.py:320-332: f32 scores (autocast off, so bf16
        q and k multiply exactly and accumulate in f32) divided by sqrt(D),
        masked keys replaced by finfo(f32).min / 2, softmax, dropout, then
        the weights in v's dtype times v."""
        with torch.autocast(q.device.type, enabled=False):
            scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :].to(torch.bool), MASKED_BIAS)
        attn = self.attn_drop(torch.softmax(scores, dim=-1))
        return torch.matmul(attn.to(v.dtype), v)


class TemporalAttentionBlock(nn.Module):
    """Pre-LN MHA + residual; pre-LN 1x1-conv MLP (exact GELU) + residual;
    dropout on the attention output and both MLP layers in train mode."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 4,
                 drop: float = 0.1):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiHeadSelfAttention(dim, num_heads, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.conv1 = nn.Conv1d(dim, dim * mlp_ratio, 1)
        self.conv2 = nn.Conv1d(dim * mlp_ratio, dim, 1)
        self.drop_attn = nn.Dropout(drop)
        self.drop_mlp1 = nn.Dropout(drop)
        self.drop_mlp2 = nn.Dropout(drop)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = x + self.drop_attn(self.attn(self.norm1(x), mask=mask))
        # 1x1 Conv1d on (B, T, C) is a pointwise linear layer
        h = F.linear(self.norm2(x), self.conv1.weight[:, :, 0], self.conv1.bias)
        h = self.drop_mlp1(F.gelu(h))
        h = F.linear(h, self.conv2.weight[:, :, 0], self.conv2.bias)
        return x + self.drop_mlp2(h)


class TemporalConvBlock(nn.Module):
    """Parallel grouped Conv1d (+BN) + ReLU branches, concatenated on channels.

    (B, T, C) -> (B, T, C). Each branch maps C -> C / len(kernel_sizes) with
    groups = C / len(kernel_sizes) and `k // 2` padding.
    """

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (3, 5, 7, 11),
                 fused: bool = False):
        super().__init__()
        n = len(kernel_sizes)
        if dim % n != 0:
            raise ValueError(f"len(kernel_sizes)={n} must divide dim={dim}")
        branch = dim // n
        self.convs = nn.ModuleList(
            nn.Sequential(
                nn.Conv1d(dim, branch, k, padding=k // 2, groups=branch),
                _bn_or_identity(BatchNorm1d(branch), fused),
                nn.ReLU(),
            )
            for k in kernel_sizes
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xt = x.transpose(1, 2)
        return torch.cat([conv(xt) for conv in self.convs], dim=1).transpose(1, 2)


class Conv3DBlock(nn.Module):
    """Conv3d (+BN3d) + ReLU on (B, C, T, H, W), the 3D model's encoder block
    (reference model.py:393-403). Submodules `conv` and `bn` carry the
    reference's state_dict keys; fused=True drops the BatchNorm, whose eval
    affine models/fuse.py folds into the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride, padding,
                 fused: bool = False):
        super().__init__()
        self.conv = nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride, padding=padding)
        self.bn = _bn_or_identity(BatchNorm3d(out_ch), fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))
