"""Augmentation placement: host (cv2 per frame) against device (inside the
train step).

Port of tools/bench_device_augment.py. Measures (a) the train loader's
samples/s with the full host augmentation pipeline against the device
mode's host subset (resize and JPEG only; data/dataset.py::create_dataloader,
augment_mode), and (b) train steps/s with device augment off and on
(training/train_step.py::make_train_step, device_augment=True, both sides'
draws from ops/device_augment.py::draw) on batches resident on the device.
The JAX step donates its state (donate_argnums); this step updates the
model and the optimizer in place, which is the same.

Both rates are the JAX tool's regime: the loader's wall clock over one
epoch after a warm epoch, and `steps` dispatched steps after a warm one,
timed to the read-back of the last loss. The corpus comes from
utils/synthetic.py::make_corpus, cached under --cache-dir.

    python -m video_fingerprint_tpu_torch.tools.bench_device_augment [--videos 12]
        [--frames 80] [--batch 8] [--steps 12] [--device cuda|cpu]

Prints a comment line naming the device, then one JSON line with the JAX
tool's keys.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from video_fingerprint_tpu_torch.data.dataset import create_dataloader
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.training.optim import make_optimizer
from video_fingerprint_tpu_torch.training.train_step import (
    draw_augmentations,
    draw_extracts,
    make_train_step,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

DEFAULT_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache" / "augbench"
EXTRACT_RATIO = 0.5  # the JAX step's default extract_ratio
HW = 64


def bench_loader(video_dir, augment_mode: str, batch: int, workers: int) -> float:
    """Samples/s of one epoch, after a warm epoch that fills the decode
    cache, so both modes measure augmentation, not decode."""
    loader = create_dataloader(str(video_dir), batch_size=batch, num_workers=workers,
                               max_frames=96, mode="train", model_type="attention",
                               augment_mode=augment_mode)
    for _ in loader:
        pass
    n = 0
    t0 = time.perf_counter()
    for b in loader:
        n += b["clip1"].shape[0]
    return n / (time.perf_counter() - t0)


def bench_step(device_augment: bool, batch: int, frames: int, steps: int,
               device: torch.device) -> float:
    """Steps/s of the f32 attention train step on one uint8 batch on the
    device: one warm step, then `steps` steps to the last loss's read-back."""
    torch.manual_seed(0)
    model = create_model("attention").to(device)
    opt = make_optimizer("attention", model, 1e-4, total_steps=1000)
    step = make_train_step(model, opt, "attention", device_augment=device_augment)
    rng = np.random.default_rng(0)
    clips = {name: torch.from_numpy((rng.random((batch, frames, HW, HW, 3)) * 255)
                                    .astype(np.uint8)).to(device)
             for name in ("clip1", "clip2")}
    data = {**clips, "video_id": torch.arange(batch, device=device),
            "mask1": torch.ones((batch, frames), dtype=torch.bool, device=device),
            "mask2": torch.ones((batch, frames), dtype=torch.bool, device=device)}
    gen = torch.Generator().manual_seed(1)
    card_gen = torch.Generator(device=device).manual_seed(1)

    def one(i: int):
        draws = draw_extracts(gen, batch, frames, EXTRACT_RATIO)
        if device_augment:
            draws.update(draw_augmentations(card_gen, data))
        return step(data, draws, i)

    float(one(0)["loss"])  # warm
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = one(1 + i)
    last = float(metrics["loss"])  # the sync
    if not np.isfinite(last):
        raise FloatingPointError(f"loss {last}")
    return steps / (time.perf_counter() - t0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--videos", type=int, default=12)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--step_batch", type=int, default=16)
    ap.add_argument("--step_frames", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cache-dir", default=str(DEFAULT_CACHE))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {json.dumps(describe_card(device))}", flush=True)
    d = Path(args.cache_dir) / f"corpus_v{args.videos}_f{args.frames}"
    if not (d / ".complete").exists():
        make_corpus(d, num_unique=args.videos, num_frames=args.frames, duplicates=0)
        (d / ".complete").write_text("ok")

    host_sps = bench_loader(d, "host", args.batch, args.workers)
    device_mode_sps = bench_loader(d, "device", args.batch, args.workers)
    step_off = bench_step(False, args.step_batch, args.step_frames, args.steps, device)
    step_on = bench_step(True, args.step_batch, args.step_frames, args.steps, device)
    print(json.dumps({
        "loader_samples_per_sec_host_augment": host_sps,
        "loader_samples_per_sec_device_mode": device_mode_sps,
        "loader_speedup": device_mode_sps / host_sps,
        "train_steps_per_sec_augment_off": step_off,
        "train_steps_per_sec_device_augment": step_on,
        "device_augment_step_overhead_pct": (step_off / step_on - 1) * 100,
        "step_batch": args.step_batch, "step_frames": args.step_frames,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
