"""What the benchmark legs share: the seeded attention model, seeded clips,
the card's description and the cumulative JSON line.

A leg prints its whole result so far as one JSON line after each stage;
the orchestrator (tools/bench.py) reads the last line it can parse, so a
leg cut off by its timeout still leaves the stages it finished.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model

H100_BF16_PEAK_FLOPS = 989.4e12  # dense bf16, NVIDIA H100 SXM data sheet, 700 W


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def widths_args(parser) -> None:
    """The attention model's width flags (default: create_model's, the
    full-width model)."""
    parser.add_argument("--spatial_dim", type=int, default=None)
    parser.add_argument("--temporal_dim", type=int, default=None)
    parser.add_argument("--embedding_dim", type=int, default=None)
    parser.add_argument("--depth", type=int, default=None, help="attention blocks")


def model_kwargs(args) -> Dict[str, int]:
    """create_model's keyword arguments for the width flags given."""
    given = {"spatial_dim": args.spatial_dim, "temporal_dim": args.temporal_dim,
             "embedding_dim": args.embedding_dim, "num_attention_blocks": args.depth}
    return {k: v for k, v in given.items() if v is not None}


def panning_clips(generator: torch.Generator, videos: int, frames: int,
                  size: int = 64) -> torch.Tensor:
    """(videos * frames, size, size, 3) uint8 on the generator's device:
    each video a random 8x8 grid of coloured blocks of its own, panning
    sideways by 1-3 pixels a frame. Clip-level structure keeps distinct
    videos apart in the embedding space of random weights, where i.i.d.
    pixel noise would average out to nearly one embedding."""
    device = generator.device
    grid = torch.randint(0, 256, (videos, 8, 8, 3), generator=generator, device=device,
                         dtype=torch.uint8)
    speed = torch.randint(1, 4, (videos,), generator=generator, device=device)
    cell = size // 8
    image = grid.repeat_interleave(cell, 1).repeat_interleave(cell, 2)  # (V, y, x, 3)
    t = torch.arange(frames, device=device)
    cols = (torch.arange(size, device=device)[None, None, :]
            + speed[:, None, None] * t[None, :, None]) % size     # (V, T, x)
    v = torch.arange(videos, device=device)[:, None, None]
    panned = image[v, :, cols]                                     # (V, T, x, y, 3)
    return panned.transpose(2, 3).reshape(videos * frames, size, size, 3).contiguous()


def seeded_state_dict(seed: int, **widths: int) -> Dict[str, np.ndarray]:
    """A seeded attention model (`widths`: create_model's keywords) in the
    reference state_dict layout, made on the CPU in float32, so every device and process gets the same bits.
    Its BatchNorm statistics are measured on 4 seeded 16-frame panning
    clips (a cumulative average in train mode): with the init's mean 0 /
    var 1 every clip maps to nearly one embedding."""
    torch.manual_seed(seed)
    model = create_model("attention", **widths)
    for module in model.modules():
        if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
            module.reset_running_stats()
            module.momentum = None
    calib = panning_clips(torch.Generator().manual_seed(seed), 4, 16)
    with torch.no_grad():
        model.train().forward_flat(calib, 4)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def describe_card(device: torch.device) -> dict:
    """The device a leg measured on: the card's name and, where nvidia-smi
    answers, its power limit."""
    if device.type != "cuda":
        return {"device": "cpu"}
    out = {"device": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        out["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None
    except (OSError, subprocess.TimeoutExpired):
        out["smi"] = None
    return out
