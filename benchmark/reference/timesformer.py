"""Plain float32 TimeSformer (divided space-time attention), its seeded weights
and their calibration, and the embeddings of a library of sampled windows.

Written from `transformers`' `TimesformerEmbeddings`, `TimesformerLayer`
(attention_type "divided_space_time") and `TimesformerModel` (the final
LayerNorm), which follow facebookresearch/TimeSformer's vit.py; the state
dict has `TimesformerModel`'s keys, plus the fingerprint head's
(`fingerprint_head`, Linear(hidden_size, embedding_dim)), whose output is
L2-normalised. It imports nothing of the program under test:

- every window runs on its own frames, with no padding, cache or batching
  trick; windows go through in blocks of WINDOW_BLOCK only so that they fit;
- the normalisation is the sampling's: x / 255, then (x - mean) / std per
  channel, in float32; the patch embedding is the strided Conv2d;
- every conv, linear and attention product runs in float32 with TF32 off
  (`models.exact_float32`), unless the caller passes `quant`, which rounds
  both operands of each product first (the control's lower precision).

Weights (`seeded_state_dict`): every linear and conv weight and bias is
drawn from U(-a, a) with a = sqrt(3) / sqrt(fan_in), a standard deviation of
1 / sqrt(fan_in) (the variance-keeping scale); the CLS token and the
position and time embeddings at the standard deviation 0.02 of `transformers`'
initialisation; LayerNorm scales 1 and shifts 0. At `transformers`'
initialisation (every weight at 0.02, which is 1 / sqrt(3 * 768) at this
width, and zero biases) a 12-layer stack leaves the CLS token nearly the
same for every video; at the variance-keeping scale each block passes on
as much of the video's content as it is given. `calibrate` then sets the
head's bias to minus the mean of its output over clips of the library, as
reference/weights.py does for the other models, so that unrelated videos
spread over the sphere.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models

WINDOW_BLOCK = 16  # windows a reference pass takes
EMBEDDING_STD = 0.02  # the CLS token, position and time embeddings
StateDict = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str, float]]  # (key, shape, rule, std)


def frames_of(length: int, num_frames: int) -> np.ndarray:
    """Offsets in a window of `length` frames of the `num_frames` frames the
    model takes: floor(i * length / num_frames), i.e. i * 32 in a window of
    256 frames sampled at 8, with frames repeated where length < num_frames."""
    return np.arange(num_frames) * length // num_frames


def _dense(spec: Spec, key: str, shape: Tuple[int, ...]) -> None:
    std = 1.0 / math.sqrt(math.prod(shape[1:]))
    spec += [(f"{key}.weight", shape, "draw", std), (f"{key}.bias", (shape[0],), "draw", std)]


def _norm(spec: Spec, key: str, n: int) -> None:
    spec += [(f"{key}.weight", (n,), "one", 0.0), (f"{key}.bias", (n,), "zero", 0.0)]


def spec_of(config: dict) -> Spec:
    """Every tensor of the state dict, in `TimesformerModel`'s order, and the head."""
    C, I, P = config["hidden_size"], config["intermediate_size"], config["patch_size"]
    N = (config["frame_size"] // P) ** 2
    spec: Spec = [("embeddings.cls_token", (1, 1, C), "draw", EMBEDDING_STD),
                  ("embeddings.position_embeddings", (1, N + 1, C), "draw", EMBEDDING_STD),
                  ("embeddings.time_embeddings", (1, config["num_frames"], C), "draw",
                   EMBEDDING_STD)]
    _dense(spec, "embeddings.patch_embeddings.projection", (C, 3, P, P))
    for i in range(config["num_hidden_layers"]):
        key = f"encoder.layer.{i}"
        for attention in ("attention", "temporal_attention"):
            _dense(spec, f"{key}.{attention}.attention.qkv", (3 * C, C))
            _dense(spec, f"{key}.{attention}.output.dense", (C, C))
        _dense(spec, f"{key}.intermediate.dense", (I, C))
        _dense(spec, f"{key}.output.dense", (C, I))
        for norm in ("layernorm_before", "layernorm_after", "temporal_layernorm"):
            _norm(spec, f"{key}.{norm}", C)
        _dense(spec, f"{key}.temporal_dense", (C, C))
    _norm(spec, "layernorm", C)
    _dense(spec, "fingerprint_head", (config["embedding_dim"], C))
    return spec


def seeded_state_dict(config: dict, generator: torch.Generator) -> StateDict:
    """Float32 weights on the generator's device, drawn in one call."""
    spec = spec_of(config)
    total = sum(math.prod(shape) for _, shape, rule, _ in spec if rule == "draw")
    device = generator.device
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    sd: StateDict = {}
    offset = 0
    for key, shape, rule, std in spec:
        if rule == "draw":
            n = math.prod(shape)
            sd[key] = (u[offset:offset + n] * (math.sqrt(3.0) * std)).view(shape)
            offset += n
        else:
            sd[key] = torch.full(shape, 1.0 if rule == "one" else 0.0, device=device)
    return sd


def _q(quant: models.Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def _linear(x, sd: StateDict, key: str, quant: models.Quant) -> torch.Tensor:
    return F.linear(_q(quant, x), _q(quant, sd[f"{key}.weight"]), sd[f"{key}.bias"])


def _layer_norm(x, sd: StateDict, key: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], sd[f"{key}.weight"], sd[f"{key}.bias"], eps)


def _attention(x, sd: StateDict, key: str, heads: int, quant: models.Quant) -> torch.Tensor:
    """`TimeSformerAttention` on (S, T, C): self-attention, output projection."""
    S, T, C = x.shape
    qkv = _linear(x, sd, f"{key}.attention.qkv", quant)
    q, k, v = qkv.reshape(S, T, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    p = torch.softmax((_q(quant, q) @ _q(quant, k).transpose(-2, -1)) * (C // heads) ** -0.5,
                      dim=-1)
    o = (_q(quant, p) @ _q(quant, v)).transpose(1, 2).reshape(S, T, C)
    return _linear(o, sd, f"{key}.output.dense", quant)


def _layer(h, sd: StateDict, key: str, config: dict, quant: models.Quant) -> torch.Tensor:
    """`TimesformerLayer` (divided space-time) on (B, 1 + N T, C), patch-major."""
    B, C, T = h.shape[0], h.shape[2], config["num_frames"]
    N = (h.shape[1] - 1) // T
    heads, eps = config["num_attention_heads"], config["layer_norm_eps"]
    # temporal: each patch over its T frames
    temporal = h[:, 1:].reshape(B * N, T, C)
    r = _attention(_layer_norm(temporal, sd, f"{key}.temporal_layernorm", eps), sd,
                   f"{key}.temporal_attention", heads, quant)
    r = _linear(r.reshape(B, N * T, C), sd, f"{key}.temporal_dense", quant)
    temporal = h[:, 1:] + r
    # spatial: the CLS token and each frame's N patches
    init_cls = h[:, :1]
    spatial = temporal.reshape(B, N, T, C).permute(0, 2, 1, 3).reshape(B * T, N, C)
    spatial = torch.cat((init_cls.repeat(1, T, 1).reshape(B * T, 1, C), spatial), dim=1)
    r = _attention(_layer_norm(spatial, sd, f"{key}.layernorm_before", eps), sd,
                   f"{key}.attention", heads, quant)
    cls = r[:, 0].reshape(B, T, C).mean(dim=1, keepdim=True)
    r = r[:, 1:].reshape(B, T, N, C).permute(0, 2, 1, 3).reshape(B, N * T, C)
    h = torch.cat((init_cls, temporal), dim=1) + torch.cat((cls, r), dim=1)
    # the MLP
    m = F.gelu(_linear(_layer_norm(h, sd, f"{key}.layernorm_after", eps), sd,
                       f"{key}.intermediate.dense", quant))
    return h + _linear(m, sd, f"{key}.output.dense", quant)


def forward(clips: torch.Tensor, sd: StateDict, config: dict, quant: models.Quant = None,
            normalize: bool = True) -> torch.Tensor:
    """(B, T, S, S, 3) uint8 windows of num_frames sampled frames -> (B, E)
    embeddings (unit norm unless `normalize` is False)."""
    B, T, S = clips.shape[:3]
    P, C = config["patch_size"], config["hidden_size"]
    mean = torch.tensor(config["mean"], dtype=torch.float32, device=clips.device)
    std = torch.tensor(config["std"], dtype=torch.float32, device=clips.device)
    x = ((clips.float() / 255.0 - mean) / std).reshape(B * T, S, S, 3).permute(0, 3, 1, 2)
    key = "embeddings.patch_embeddings.projection"
    e = F.conv2d(_q(quant, x), _q(quant, sd[f"{key}.weight"]), sd[f"{key}.bias"], stride=P)
    e = e.flatten(2).transpose(1, 2)
    e = torch.cat((sd["embeddings.cls_token"].expand(B * T, -1, -1), e), dim=1)
    e = e + sd["embeddings.position_embeddings"]
    cls = e[:B, :1]  # as `transformers` takes it: every frame's CLS token is the same
    N = e.shape[1] - 1
    patches = e[:, 1:].reshape(B, T, N, C).permute(0, 2, 1, 3).reshape(B * N, T, C)
    patches = patches + sd["embeddings.time_embeddings"]
    h = torch.cat((cls, patches.reshape(B, N * T, C)), dim=1)
    for i in range(config["num_hidden_layers"]):
        h = _layer(h, sd, f"encoder.layer.{i}", config, quant)
    out = _linear(_layer_norm(h[:, 0], sd, "layernorm", config["layer_norm_eps"]), sd,
                  "fingerprint_head", quant)
    return models._normalize(out) if normalize else out


def calibrate(sd: StateDict, config: dict, centre_on: Sequence[torch.Tensor]) -> None:
    """Set the head's bias to minus the mean of its output over `centre_on`,
    (T, S, S, 3) uint8 windows of the traffic on the weights' device."""
    sd["fingerprint_head.bias"].zero_()
    with torch.no_grad(), models.exact_float32():
        outs = [forward(torch.stack(list(centre_on[lo:lo + WINDOW_BLOCK])), sd, config,
                        normalize=False)
                for lo in range(0, len(centre_on), WINDOW_BLOCK)]
    sd["fingerprint_head.bias"] -= torch.cat(outs).mean(dim=0)


def library_embeddings(config: dict, videos: Sequence[List[np.ndarray]], sd: StateDict,
                       device, quant: models.Quant = None) -> np.ndarray:
    """(n, E) embeddings of n videos, each a list of (T, S, S, 3) uint8 host
    windows: a single window's embedding as it is, several windows' mean
    renormalised (fingerprint.py:300-318)."""
    windows = [(v, w) for v, clips in enumerate(videos) for w in range(len(clips))]
    per_window = {}
    with torch.no_grad(), models.exact_float32():
        for lo in range(0, len(windows), WINDOW_BLOCK):
            block = windows[lo:lo + WINDOW_BLOCK]
            x = torch.from_numpy(np.stack([videos[v][w] for v, w in block])).to(device)
            for key, e in zip(block, forward(x, sd, config, quant)):
                per_window[key] = e
        by_video = defaultdict(list)
        for (v, _), e in sorted(per_window.items()):
            by_video[v].append(e)
        out = [models.mean_of_windows(torch.stack(by_video[v])) for v in range(len(videos))]
    return torch.stack(out).cpu().numpy()


CHECKPOINT_KEYS = ("model_type", "hidden_size", "num_hidden_layers", "num_attention_heads",
                   "intermediate_size", "patch_size", "frame_size", "num_frames",
                   "layer_norm_eps", "qkv_bias", "embedding_dim", "mean", "std", "clip_length")


def save_pth(sd: StateDict, config: dict, path) -> None:
    """The weights as a checkpoint the scanner loads: {"model_state_dict",
    "config"}, the config holding the model's widths and sampling."""
    torch.save({"model_state_dict": {k: v.detach().cpu() for k, v in sd.items()},
                "config": {k: config[k] for k in CHECKPOINT_KEYS if k in config}}, path)
