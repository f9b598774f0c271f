"""Seeded weights for both models, in the upstream reference's state dict layout.

Every conv and linear weight and bias is drawn from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) (torch's default initialization), LayerNorm and BatchNorm
scales are 1 and shifts 0, and `temperature` is 0.07. All draws come from
one call on the caller's generator, so the weights are made on the device
in float32 in one pass. With BatchNorm statistics left at mean 0 and
variance 1, random weights map every clip to nearly one embedding, so
`calibrate` measures them on seeded clips first (clips of the benchmark's
traffic): one train-mode pass, as torch computes it with a cumulative
average over one batch. It then centres the last layer's output on a
sample of the traffic's own videos: without that, the shared part of
random-weight features puts every pair of distinct videos near cosine 1.

`save_pth` writes the reference's checkpoint format: {"model_state_dict",
"config"}, which the program under test loads as a user's checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.reference import models

SPATIAL_CHANNELS = (32, 64, 128, 256)  # model.py:95-110
CNN3D_CHANNELS = (16, 32, 64, 128)  # model.py:420-430

Spec = List[Tuple[str, Tuple[int, ...], str, int]]  # (key, shape, rule, fan_in)


def _bn(spec: Spec, key: str, n: int) -> None:
    spec += [(f"{key}.weight", (n,), "one", 0), (f"{key}.bias", (n,), "zero", 0),
             (f"{key}.running_mean", (n,), "zero", 0), (f"{key}.running_var", (n,), "one", 0),
             (f"{key}.num_batches_tracked", (), "count", 0)]


def _dense(spec: Spec, key: str, weight_shape: Tuple[int, ...]) -> None:
    fan_in = math.prod(weight_shape[1:])
    spec += [(f"{key}.weight", weight_shape, "draw", fan_in),
             (f"{key}.bias", (weight_shape[0],), "draw", fan_in)]


def _norm(spec: Spec, key: str, n: int) -> None:
    spec += [(f"{key}.weight", (n,), "one", 0), (f"{key}.bias", (n,), "zero", 0)]


def attention_spec(config: dict) -> Spec:
    S, C, E = config["spatial_dim"], config["temporal_dim"], config["embedding_dim"]
    spec: Spec = []
    cin = 3
    for (conv, bn, _), ch in zip(models.SPATIAL, SPATIAL_CHANNELS):
        k = 5 if conv == 0 else 3
        _dense(spec, f"spatial_encoder.encoder.{conv}", (ch, cin, k, k))
        _bn(spec, f"spatial_encoder.encoder.{bn}", ch)
        cin = ch
    _dense(spec, "spatial_encoder.encoder.14", (S, cin))
    _dense(spec, "temporal_projection", (C, S))
    branch = C // len(models.KERNELS_1D)
    for block in range(2):
        for j, k in enumerate(models.KERNELS_1D):
            key = f"temporal_conv_blocks.{block}.convs.{j}"
            _dense(spec, f"{key}.0", (branch, C // branch, k))
            _bn(spec, f"{key}.1", branch)
    for i in range(config["num_attention_blocks"]):
        key = f"attention_blocks.{i}"
        _norm(spec, f"{key}.norm1", C)
        spec += [(f"{key}.attn.in_proj_weight", (3 * C, C), "draw", C),
                 (f"{key}.attn.in_proj_bias", (3 * C,), "draw", C)]
        _dense(spec, f"{key}.attn.out_proj", (C, C))
        _norm(spec, f"{key}.norm2", C)
        _dense(spec, f"{key}.conv1", (4 * C, C, 1))
        _dense(spec, f"{key}.conv2", (C, 4 * C, 1))
    _dense(spec, "temporal_pool.0", (C, C, 1))
    _dense(spec, "final_projection.0", (C, 3 * C))
    _dense(spec, "final_projection.3", (E, C))
    spec.append(("temperature", (1,), "temperature", 0))
    return spec


def cnn3d_spec(config: dict) -> Spec:
    s, E = config["frame_stride"], config["embedding_dim"]
    spec: Spec = []
    cin = 3
    for i, ((kernel, _, _), ch) in enumerate(zip(models.cnn3d_blocks(s), CNN3D_CHANNELS)):
        kernel = kernel if isinstance(kernel, tuple) else (kernel,) * 3
        _dense(spec, f"encoder.{i}.conv", (ch, cin) + kernel)
        _bn(spec, f"encoder.{i}.bn", ch)
        cin = ch
    _dense(spec, "temporal_conv", (cin, cin, 3))
    _dense(spec, "temporal_attention", (1, cin, 1))
    _dense(spec, "projector.0", (cin, cin))
    _dense(spec, "projector.3", (E, cin))
    spec.append(("temperature", (1,), "temperature", 0))
    return spec


def seeded_state_dict(config: dict, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Float32 weights on the generator's device, drawn in one call."""
    spec = attention_spec(config) if config["model_type"] == "attention" else cnn3d_spec(config)
    total = sum(math.prod(shape) for _, shape, rule, _ in spec if rule == "draw")
    device = generator.device
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    sd: Dict[str, torch.Tensor] = {}
    offset = 0
    for key, shape, rule, fan_in in spec:
        if rule == "draw":
            n = math.prod(shape)
            sd[key] = (u[offset:offset + n] / math.sqrt(fan_in)).view(shape)
            offset += n
        elif rule == "count":
            sd[key] = torch.ones((), dtype=torch.int64, device=device)
        elif rule == "temperature":
            sd[key] = torch.full(shape, 0.07, device=device)
        else:
            sd[key] = torch.full(shape, 1.0 if rule == "one" else 0.0, device=device)
    return sd


def calibrate(sd: Dict[str, torch.Tensor], config: dict, clips: torch.Tensor,
              centre_on: Sequence[torch.Tensor]) -> None:
    """Set every BatchNorm's running statistics from one train-mode pass over
    `clips`, (B, T, H, W, 3) uint8 on the weights' device; then the last
    layer's bias to minus the mean of its output over `centre_on`, clips of
    the traffic (each (T, H, W, 3), its own length), so that the
    embeddings of distinct videos spread over the sphere rather than all
    lie near one direction."""
    stats: dict = {}
    head = "final_projection.3" if config["model_type"] == "attention" else "projector.3"
    with torch.no_grad(), models.exact_float32():
        if config["model_type"] == "attention":
            B, T = clips.shape[:2]
            feats = models.frame_features(clips.reshape((B * T,) + clips.shape[2:]), sd,
                                          stats=stats)
            models.attention_head(feats.view(B, T, -1), sd, config["num_heads"], stats=stats)
        else:
            models.cnn3d_forward(clips, sd, config["frame_stride"], stats=stats)
        sd.update(stats)
        sd[f"{head}.bias"].zero_()
        outs = []
        for clip in centre_on:
            if config["model_type"] == "attention":
                feats = models.frame_features(clip, sd)
                outs.append(models.attention_head(feats[None], sd, config["num_heads"],
                                                  normalize=False))
            else:
                outs.append(models.cnn3d_forward(clip[None], sd, config["frame_stride"],
                                                 normalize=False))
        sd[f"{head}.bias"] -= torch.cat(outs).mean(dim=0)


def checkpoint_config(config: dict) -> dict:
    """The keys the reference's scanner reads from a checkpoint's config."""
    keys = ("model_type", "embedding_dim", "frame_size", "max_frames", "spatial_dim",
            "temporal_dim", "num_attention_blocks", "clip_length", "frame_stride")
    return {k: config[k] for k in keys if k in config}


def save_pth(sd: Dict[str, torch.Tensor], config: dict, path) -> None:
    torch.save({"model_state_dict": {k: v.detach().cpu() for k, v in sd.items()},
                "config": checkpoint_config(config)}, path)
