"""Full-stack roofline decomposition of the headline's extraction forward.

Port of tools/exp_stack_roofline.py over `profile_extraction.stack_legs`:
each stage of the fused bf16 attention forward (the headline program),
measured cumulatively on the card, beside the bounds of the stages so far,
so the gap between the whole forward and the sum of per-stage bounds is a
number. Legs: convert (uint8 -> bf16 / 255), conv0, conv0..1, conv0..2,
conv0..3, spatial (+ pool + linear), full (`forward_flat`), each with
cudnn.benchmark off and on (profile_extraction.py says how they are timed
and counted).

The JAX tool's environment variables are flags: --n frames (EXP_N), --b
videos (EXP_B, so T = n / b), --k calls captured per CUDA graph (EXP_K, the
JAX in-graph iterations per timed call), --reps captures per leg (EXP_REPS,
the median). Its v5e peaks are not carried over: the bounds are the H100's.

    python -m video_fingerprint_tpu_torch.tools.exp_stack_roofline [--n 16384 --b 128]
    python -m video_fingerprint_tpu_torch.tools.exp_stack_roofline --device cpu --n 8 --b 2 \\
        --spatial_dim 16 --temporal_dim 32 --embedding_dim 32
"""

from __future__ import annotations

import argparse
import sys

import torch

from video_fingerprint_tpu_torch.tools.bench_common import describe_card, emit, model_kwargs, widths_args
from video_fingerprint_tpu_torch.tools.bench_headline import fused_model
from video_fingerprint_tpu_torch.tools.profile_extraction import SEED, seeded_frames, stack_legs
from video_fingerprint_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=16384, help="frames (EXP_N)")
    ap.add_argument("--b", type=int, default=128, help="videos, T = n / b (EXP_B)")
    ap.add_argument("--k", type=int, default=20, help="calls per CUDA graph (EXP_K)")
    ap.add_argument("--reps", type=int, default=3, help="captures per leg, median (EXP_REPS)")
    widths_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.n % args.b:
        raise ValueError(f"--n {args.n} is not a multiple of --b {args.b}")
    device = resolve_device(args.device)
    model = fused_model(SEED, device, torch.bfloat16, **model_kwargs(args))
    flat = seeded_frames(SEED, args.b, args.n // args.b, device)
    emit({"n": args.n, "k": args.k, "b": args.b, "t": args.n // args.b, **describe_card(device)})
    legs = stack_legs(model, flat, args.b, device, args.reps, args.k)
    emit({"n": args.n, "b": args.b, **legs})
    return 0


if __name__ == "__main__":
    sys.exit(main())
