"""Train-step throughput: a metric sync every step against one every window.

Port of tools/bench_train_step.py. A trainer that reads the loss back
after every step makes the host wait for the device each step; one that
reads it once per `--window` steps lets the host run ahead. This measures
the steps/s of both on the attention train step
(training/train_step.py::make_train_step) with one batch resident on the
device (no decode), f32 clips in [0, 1] as the JAX tool's, f32 compute or
bf16 with --bf16 (the train CLI's --bf16).

Both regimes dispatch every step from the host, as the JAX tool does, so
the keys keep their names: `steps_per_sec_sync_every_step`,
`steps_per_sec_sync_every_<window>` and `speedup`. The timer stops only
after the last step is done: steps past the last window boundary are
drained by a final read-back.

    python -m video_fingerprint_tpu_torch.tools.bench_train_step [--batch 64]
        [--frames 64] [--steps 30] [--window 10] [--bf16] [--device cuda|cpu]

Prints one JSON line; `device` is the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training.optim import make_optimizer
from video_fingerprint_tpu_torch.training.train_step import draw_extracts, make_train_step
from video_fingerprint_tpu_torch.utils.device import resolve_device

EXTRACT_RATIO = 0.5  # the JAX step's default extract_ratio
HW = 64


def read_loss(metrics) -> float:
    """The deliberate sync point: the loss read back to the host."""
    return float(metrics["loss"])


def run(step_once, steps: int, sync_every: int, sync=read_loss) -> float:
    """Steps/s of `steps` calls of step_once(i), with sync(metrics) after
    every `sync_every`-th step and once more for a tail past the last
    window boundary, before the timer stops."""
    t0 = time.perf_counter()
    last = None
    for i in range(steps):
        metrics = step_once(i)
        if (i + 1) % sync_every == 0:
            last = sync(metrics)
    if steps % sync_every != 0 or last is None:
        last = sync(metrics)
    elapsed = time.perf_counter() - t0
    if not np.isfinite(last):
        raise FloatingPointError(f"loss {last}")
    return steps / elapsed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 model compute (the train CLI's --bf16)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None, sync=read_loss) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    B, T = args.batch, args.frames
    torch.manual_seed(0)
    model = create_model("attention").to(device)
    opt = make_optimizer("attention", model, 1e-4, total_steps=1000)
    step = make_train_step(model, opt, "attention", bf16=args.bf16)
    rng = np.random.default_rng(0)
    batch = {"clip1": torch.from_numpy(rng.random((B, T, HW, HW, 3), dtype=np.float32)),
             "clip2": torch.from_numpy(rng.random((B, T, HW, HW, 3), dtype=np.float32)),
             "video_id": torch.arange(B),
             "mask1": torch.ones((B, T), dtype=torch.bool),
             "mask2": torch.ones((B, T), dtype=torch.bool)}
    batch = {k: v.to(device) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(1)
    count = 0

    def step_once(_):
        nonlocal count
        metrics = step(batch, draw_extracts(gen, B, T, EXTRACT_RATIO), count)
        count += 1
        return metrics

    sync(step_once(0))  # warm
    per_step = run(step_once, args.steps, 1, sync)
    windowed = run(step_once, args.steps, args.window, sync)
    print(json.dumps({
        "batch": B, "frames": T, "steps": args.steps,
        "steps_per_sec_sync_every_step": per_step,
        f"steps_per_sec_sync_every_{args.window}": windowed,
        "speedup": windowed / per_step,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "dtype": "bfloat16" if args.bf16 else "float32",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
