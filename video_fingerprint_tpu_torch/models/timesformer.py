"""TimeSformer-Base with divided space-time attention, as a fingerprint model.

Bertasius, Wang and Torresani, "Is Space-Time Attention All You Need for
Video Understanding?" (ICML 2021, arXiv:2102.05095), configuration
`TimeSformer_divST_8x32_224`; the forward is that of `transformers`'
`TimesformerEmbeddings` + `TimesformerLayer` (attention_type
"divided_space_time") + the final LayerNorm, and the submodules carry
`TimesformerModel`'s state_dict keys, so a published checkpoint loads with a
strict `load_state_dict` (with the head's two keys beside it). In place of
the Kinetics classifier the CLS token goes through `fingerprint_head`,
Linear(hidden, embedding_dim), and an L2 norm.

A clip is (B, T, H, W, 3) frames, uint8 or float in [0, 1], T =
num_frames. They are normalised on the device ((x - mean) / std per
channel) and cut into P x P patches, whose embedding is one GEMM over
(kh, kw, c)-ordered patch rows. The residual stream is kept as the CLS
token (B, C) and the patch tokens (B, N, T, C), patch-major as the
reference orders them. Each layer:

- temporal half (`temporal`): LayerNorm, then each patch attends over its
  own T frames (B*N sequences of T), the attention's output projection,
  `temporal_dense` and the residual add; the CLS token does not take part;
- spatial half (`spatial`): the CLS token copied into each frame, the
  stream laid out frame-major (B, T, 1 + N, C) in one copy, LayerNorm, each
  frame's 1 + N tokens attend (B*T sequences), the output projection; the
  CLS outputs are averaged over the frames and added to the CLS token, the
  patch outputs added back to the patch-major stream;
- the pre-LN MLP (GELU), on the CLS token and the patch tokens alike.

Both attentions run on `ops/attention.py::multihead_attention` (K1 on a
card, its plain version on the CPU), given (B, H, T, D) strided views of
the qkv projection, so no copy is made for them. The halves are modules
without parameters, so a profiler hook can time each; they open the spans
`tsf.temporal` and `tsf.spatial`, and each forward counts its rows in
`tsf.windows` (utils/trace.py). The compute dtype is the parameters'
dtype; the embedding is returned in f32. Eval only: the kernel has no
backward, and training this model is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_fingerprint_tpu_torch.ops.attention import multihead_attention
from video_fingerprint_tpu_torch.utils import trace

# the sampling's normalisation (TimeSformer_divST_8x32_224: DATA.MEAN / STD)
MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)


class TimesformerSelfAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size, bias=qkv_bias)


class TimesformerSelfOutput(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)


class TimesformerAttention(nn.Module):
    """Multi-head self-attention over (S, T, C) sequences and its output
    projection."""

    def __init__(self, hidden_size: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.attention = TimesformerSelfAttention(hidden_size, num_heads, qkv_bias)
        self.output = TimesformerSelfOutput(hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S, T, C = x.shape
        H = self.attention.num_heads
        qkv = self.attention.qkv(x).view(S, T, 3, H, C // H)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (S, H, T, D) views
        o = multihead_attention(q, k, v)  # on a card a view of (S, T, H, D) storage
        return self.output.dense(o.transpose(1, 2).reshape(S, T, C))


class TimesformerIntermediate(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)


class TimesformerOutput(nn.Module):
    def __init__(self, intermediate_size: int, hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(intermediate_size, hidden_size)


class _TemporalHalf(nn.Module):
    """A layer's temporal half: patches (B, N, T, C) -> patches."""

    def forward(self, layer: "TimesformerLayer", patches: torch.Tensor) -> torch.Tensor:
        with trace.span("tsf.temporal"):
            B, N, T, C = patches.shape
            h = layer.temporal_layernorm(patches).view(B * N, T, C)
            out = layer.temporal_dense(layer.temporal_attention(h))
            return patches + out.view(B, N, T, C)


class _SpatialHalf(nn.Module):
    """A layer's spatial half: (cls (B, C), patches (B, N, T, C)) -> both."""

    def forward(self, layer: "TimesformerLayer", cls: torch.Tensor, patches: torch.Tensor):
        with trace.span("tsf.spatial"):
            B, N, T, C = patches.shape
            frames = patches.new_empty((B, T, 1 + N, C))
            frames[:, :, 0] = cls[:, None]
            frames[:, :, 1:] = patches.transpose(1, 2)
            h = layer.layernorm_before(frames).view(B * T, 1 + N, C)
            out = layer.attention(h).view(B, T, 1 + N, C)
            cls = cls + out[:, :, 0].mean(dim=1)
            return cls, patches + out[:, :, 1:].transpose(1, 2)


class TimesformerLayer(nn.Module):
    """One divided space-time block (keys of `transformers`' TimesformerLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 layer_norm_eps: float, qkv_bias: bool):
        super().__init__()
        C = hidden_size
        self.attention = TimesformerAttention(C, num_heads, qkv_bias)
        self.intermediate = TimesformerIntermediate(C, intermediate_size)
        self.output = TimesformerOutput(intermediate_size, C)
        self.layernorm_before = nn.LayerNorm(C, eps=layer_norm_eps)
        self.layernorm_after = nn.LayerNorm(C, eps=layer_norm_eps)
        self.temporal_layernorm = nn.LayerNorm(C, eps=layer_norm_eps)
        self.temporal_attention = TimesformerAttention(C, num_heads, qkv_bias)
        self.temporal_dense = nn.Linear(C, C)
        self.temporal = _TemporalHalf()
        self.spatial = _SpatialHalf()

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)

    def forward(self, cls: torch.Tensor, patches: torch.Tensor):
        patches = self.temporal(self, patches)
        cls, patches = self.spatial(self, cls, patches)
        return self.mlp(cls), self.mlp(patches)


class TimesformerPatchEmbeddings(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, num_channels: int = 3):
        super().__init__()
        self.projection = nn.Conv2d(num_channels, hidden_size, patch_size, stride=patch_size)


class TimesformerEmbeddings(nn.Module):
    def __init__(self, hidden_size: int, image_size: int, patch_size: int, num_frames: int):
        super().__init__()
        num_patches = (image_size // patch_size) ** 2
        self.patch_embeddings = TimesformerPatchEmbeddings(hidden_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, num_patches + 1, hidden_size))
        self.time_embeddings = nn.Parameter(torch.zeros(1, num_frames, hidden_size))


class TimesformerEncoder(nn.Module):
    def __init__(self, num_layers: int, **layer_kwargs):
        super().__init__()
        self.layer = nn.ModuleList(TimesformerLayer(**layer_kwargs) for _ in range(num_layers))


class VideoFingerprintTimesformer(nn.Module):
    """(B, T, H, W, 3) clip -> L2-normalised embedding via TimeSformer's CLS token."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 12,
                 num_attention_heads: int = 12, intermediate_size: int = 3072,
                 image_size: int = 224, patch_size: int = 16, num_frames: int = 8,
                 layer_norm_eps: float = 1e-6, qkv_bias: bool = True,
                 embedding_dim: int = 256, mean: Sequence[float] = MEAN,
                 std: Sequence[float] = STD):
        super().__init__()
        self.patch_size, self.num_frames = patch_size, num_frames
        self.embeddings = TimesformerEmbeddings(hidden_size, image_size, patch_size, num_frames)
        self.encoder = TimesformerEncoder(
            num_hidden_layers, hidden_size=hidden_size, num_heads=num_attention_heads,
            intermediate_size=intermediate_size, layer_norm_eps=layer_norm_eps,
            qkv_bias=qkv_bias)
        self.layernorm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.fingerprint_head = nn.Linear(hidden_size, embedding_dim)
        self.mean, self.std = tuple(mean), tuple(std)
        # (shift, scale) float32 rows per (device, uint8 input): kept out of the
        # buffers, which a cast of the model to bf16 would round
        self._affine: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.layernorm.weight.dtype

    def _normalisation(self, device: torch.device, from_uint8: bool):
        """(shift, scale) over a patch row's (kh, kw, c) columns, so that
        shift + x * scale = (x / 255 - mean) / std (uint8) or (x - mean) / std."""
        key = (device, from_uint8)
        if key not in self._affine:
            mean, std = torch.tensor(self.mean), torch.tensor(self.std)
            scale = 1.0 / (std * 255.0) if from_uint8 else 1.0 / std
            reps = self.patch_size ** 2
            self._affine[key] = ((-mean / std).repeat(reps).to(device),
                                 scale.repeat(reps).to(device))
        return self._affine[key]

    def embed(self, video: torch.Tensor):
        """(B, T, H, W, 3) -> (cls (B, C), patch tokens (B, N, T, C)), with the
        position and time embeddings added."""
        B, T, Hh, Ww, _ = video.shape
        if T != self.num_frames:
            raise ValueError(f"expected clips of {self.num_frames} frames, got {T}")
        P, emb = self.patch_size, self.embeddings
        rows = (video.reshape(B * T, Hh // P, P, Ww // P, P, 3).permute(0, 1, 3, 2, 4, 5)
                .reshape(-1, P * P * 3))
        shift, scale = self._normalisation(video.device, video.dtype == torch.uint8)
        x = torch.addcmul(shift, rows, scale).to(self.dtype)  # normalised in float32
        w = emb.patch_embeddings.projection.weight  # (C, 3, P, P) -> (kh, kw, c) columns
        tokens = F.linear(x, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
                          emb.patch_embeddings.projection.bias)
        C = tokens.shape[-1]
        pos = emb.position_embeddings[0]
        tokens = tokens.view(B, T, -1, C) + pos[1:]
        patches = tokens.transpose(1, 2).contiguous()
        patches += emb.time_embeddings[0]
        cls = (emb.cls_token[0, 0] + pos[0]).expand(B, C)
        return cls, patches

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        trace.count("tsf.windows", video.shape[0])
        cls, patches = self.embed(video)
        for layer in self.encoder.layer:
            cls, patches = layer(cls, patches)
        embedding = self.fingerprint_head(self.layernorm(cls)).float()
        norm = torch.linalg.vector_norm(embedding, dim=1, keepdim=True)
        return embedding / norm.clamp_min(1e-12)
