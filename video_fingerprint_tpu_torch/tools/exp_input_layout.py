"""Probe: does the uint8 input's C = 3 minor dimension slow its convert?

Port of tools/exp_input_layout.py. The same uint8 bytes are read as
(N, 64, 64, 3) frames and as a flat (N, 64, 192) array, converted to bf16
/ 255, alone and feeding conv0. Legs, each K iterations captured in one
CUDA graph, every iteration adding the f32 sum of its output to a scalar:

  c3_convert     (N, 64, 64, 3) uint8 -> bf16 (the production read)
  flat_convert   (N, 64, 192) uint8, the same bytes -> bf16
  flat_reshape   the flat convert viewed back as (N, 64, 64, 3)
  c3_conv0       convert + conv0 (production)
  flat_conv0     the flat convert viewed as frames -> conv0

Iteration i converts as the JAX loop does, x.to(bf16) / 255 + i * 1e-3
(in bf16), so no iteration repeats another. conv0 is the benchmark
headline's (`bench_headline.fused_model`: the seeded full-width attention
model, BatchNorm folded by models/fuse.py, bf16), run as
models/layers.py::SpatialEncoder runs it: the frames viewed as NCHW with
channels-last strides, cuDNN's conv with its bias, then ReLU. In PyTorch a
reshape of a contiguous tensor is a view, so the flat legs differ from the
C = 3 legs only in the tensor's shape at the convert. The graph is replayed
once untimed and then REPS times, each replay timed by CUDA events; a leg's
number is the median replay over K, in ms. A leg that raises prints
`<name>_error`, as the probe does.

The JAX tool's environment variables: EXP_N frames (16,384), EXP_K
iterations per graph (20), EXP_REPS replays (3). With --device cpu the legs
run eagerly and are timed by the host clock (for the tests; not a device
time).

    python -m video_fingerprint_tpu_torch.tools.exp_input_layout [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.bench_headline import fused_model
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.timing import loop_ms

HW = 64
SEED = 0


def conv0_layer(device: torch.device, dtype: torch.dtype) -> torch.nn.Module:
    """The seeded fused model's conv0 with its ReLU (SpatialEncoder's
    encoder[0:3]: conv, the folded BatchNorm's Identity, ReLU), in `dtype`
    on `device`, channels-last on a card."""
    return fused_model(SEED, device, dtype).spatial_encoder.encoder[0:3]


def frames_conv0(conv0: torch.nn.Module):
    """(N, 64, 64, 3) frames in the compute dtype -> conv0's output: the
    NHWC buffer viewed as NCHW, as the model's input_from_frames does."""
    return lambda frames: conv0(frames.permute(0, 3, 1, 2))


def offset(i: int) -> float:
    """The JAX loop's bf16 offset of iteration i, i.astype(bf16) * bf16(1e-3),
    as a Python float (worked out on the host: a CUDA graph may capture the
    add)."""
    return float(torch.tensor(float(i), dtype=torch.bfloat16)
                 * torch.tensor(1e-3, dtype=torch.bfloat16))


def step(x: torch.Tensor, body):
    """Iteration i of a leg: x converted as the JAX loop converts it, x.to(bf16)
    / 255 + offset(i), through body."""
    return lambda i, acc: body(x.to(torch.bfloat16) / 255.0 + offset(i))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = int(os.environ.get("EXP_N", 16384))
    k = int(os.environ.get("EXP_K", 20))
    reps = int(os.environ.get("EXP_REPS", 3))
    print(f"# {json.dumps({'n': n, 'k': k, **describe_card(device)})}", flush=True)
    conv0 = frames_conv0(conv0_layer(device, torch.bfloat16))
    rng = np.random.default_rng(0)
    x_c3 = torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)).to(device)
    x_flat = x_c3.reshape(n, HW, HW * 3)  # the same bytes

    results = {}
    legs = (("c3_convert_ms", x_c3, lambda xb: xb),
            ("flat_convert_ms", x_flat, lambda xb: xb),
            ("flat_reshape_ms", x_flat, lambda xb: xb.reshape(n, HW, HW, 3)),
            ("c3_conv0_ms", x_c3, conv0),
            ("flat_conv0_ms", x_flat, lambda xb: conv0(xb.reshape(n, HW, HW, 3))))
    with torch.no_grad():
        for name, x, body in legs:
            try:
                results[name] = loop_ms(step(x, body), k, reps, device)
                print(json.dumps({name: results[name]}), flush=True)
            except Exception as exc:  # noqa: BLE001 - the probe reports a failed leg
                results[f"{name}_error"] = repr(exc)[:200]
                print(json.dumps({name: results[f"{name}_error"]}), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
