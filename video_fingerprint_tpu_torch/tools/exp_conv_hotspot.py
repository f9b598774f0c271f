"""Spatial-conv hotspot probe: where conv0's time goes, and whether a
layout-level rewrite beats cuDNN's conv.

Port of tools/exp_conv_hotspot.py over `profile_extraction.conv0_probes`:
conv0 (5x5 stride 2, Cin = 3, Cout = 32) feeds the tensor cores a
contraction of 75 and 32 output channels. Probes, each followed by a sum to
f32 (the same consumer in every probe, as in the JAX tool) and run with
cudnn.benchmark off and on:

  convert_sum    uint8 -> bf16 / 255 and the sum (the input-read floor)
  conv0_u8       convert + conv0 + bias + relu (the headline's first op)
  conv0_wideG    conv0 widened to G adjacent output pixels per application
                 (`widen_kernel`, copied from the JAX tool): a (5, 5 + 2 (G
                 - 1)) kernel of G * 32 output channels at stride (2, 2G),
                 G = 4, 8; about 2.2x conv0's products
  conv1_*        conv0 as the 5x5 stride-2 conv on Cin = 3 against the
                 space-to-depth 3x3 stride-1 conv on Cin = 12
                 (`models/fuse.py::space_to_depth_kernel`), f32 and bf16

and the correctness of the rewrites on 64 frames: the G = 4 output unpacked
against conv0's (f32), the s2d conv against the 5x5 conv (max abs).

The JAX tool's environment variables are flags: --n frames (EXP_N), --k
calls per CUDA graph (EXP_K), --reps captures per probe (EXP_REPS).

    python -m video_fingerprint_tpu_torch.tools.exp_conv_hotspot [--n 16384]
    python -m video_fingerprint_tpu_torch.tools.exp_conv_hotspot --device cpu --n 64
"""

from __future__ import annotations

import argparse
import sys

import torch

from video_fingerprint_tpu_torch.tools.bench_common import describe_card, emit
from video_fingerprint_tpu_torch.tools.bench_headline import fused_model
from video_fingerprint_tpu_torch.tools.profile_extraction import SEED, conv0_probes, seeded_frames
from video_fingerprint_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=16384, help="frames (EXP_N)")
    ap.add_argument("--k", type=int, default=20, help="calls per CUDA graph (EXP_K)")
    ap.add_argument("--reps", type=int, default=3, help="captures per probe, median (EXP_REPS)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = fused_model(SEED, device, torch.bfloat16)
    flat = seeded_frames(SEED, 1, args.n, device)
    emit({"n": args.n, "k": args.k, **describe_card(device)})
    emit({"n": args.n, **conv0_probes(model, flat, device, args.reps, args.k)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
