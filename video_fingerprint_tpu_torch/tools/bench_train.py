"""Training throughput: steps/s of the attention train step on one card.

Port of tools/bench_train.py. Both shapes are the trainer's configuration
(training/train_step.py: bf16 compute with f32 parameters, the clipped
AdamW update, batches resident on the card, no decode):

  1. B = 64 clip pairs, T = 64, full masks; plain and with
     --fast_extracts (the extract forwards reuse the full forward's
     per-frame features);
  2. batch 8 in the T = 512 bucket, ragged masks, device augment, with
     remat off and on: does the shape fit the card without remat, and what
     does remat cost?

The JAX leg's number of record chains R steps in one `lax.fori_loop`.
Capturing the whole optimizer step in a CUDA graph is still to do, so this
leg reports the dispatched regime only: `timings` windows of `steps`
steps, each step dispatched from the host with its extract draws (and
augment draws) made as the trainer makes them, the loss read back at the
end of each window; the median window's steps/s, under the JAX leg's key
names with `_dispatched`. MFU counts products and convs
(utils/flops.py, not XLA's count) against the H100's dense bf16 peak.
Running out of memory is a result (`<tag>_error: "OOM"`); any other
failure makes the leg exit 1.

    python -m video_fingerprint_tpu_torch.tools.bench_train [--steps 10]
        [--device cuda|cpu] [--skip_t512]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.tools.bench_common import (
    H100_BF16_PEAK_FLOPS,
    describe_card,
    emit,
    model_kwargs,
    widths_args,
)
from video_fingerprint_tpu_torch.training.optim import make_optimizer
from video_fingerprint_tpu_torch.training.train_step import (
    draw_augmentations,
    draw_extracts,
    make_train_step,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.flops import train_step_flops

EXTRACT_RATIO = 0.5  # the trainer's default min_extract_ratio (config.py)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=10, help="dispatched steps per window")
    ap.add_argument("--timings", type=int, default=3, help="timed windows (median)")
    ap.add_argument("--warm", type=int, default=3, help="untimed steps first")
    ap.add_argument("--skip_t512", action="store_true", help="only the first shape")
    ap.add_argument("--batch", type=int, default=64, help="shape-1 batch")
    ap.add_argument("--frames", type=int, default=64, help="shape-1 frames")
    ap.add_argument("--long_batch", type=int, default=8, help="shape-2 batch")
    ap.add_argument("--long_frames", type=int, default=512, help="shape-2 bucket")
    ap.add_argument("--seed", type=int, default=0)
    widths_args(ap)
    return ap.parse_args(argv)


def make_batch(rng, B: int, T: int, masked: bool, device) -> dict:
    """uint8 64x64 clip pairs; with `masked`, true lengths drawn up to the
    bucket (the first clip sets it), as a max_frames = 500 corpus collated
    into the 512 bucket."""
    batch = {"clip1": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "clip2": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "video_id": np.arange(B, dtype=np.int64)}
    if masked:
        lens = rng.integers(T // 3, T + 1, size=(B,))
        lens[0] = T
        m = np.arange(T)[None, :] < lens[:, None]
    else:
        m = np.ones((B, T), bool)
    batch["mask1"], batch["mask2"] = m, m.copy()
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def measure(args, out: dict, tag: str, B: int, T: int, masked: bool, device_augment: bool,
            remat: bool, fast_extracts: bool, out_key: str) -> float | None:
    """Steps/s of one shape, written to out[out_key]; None after an OOM
    (recorded as out[tag + '_error'])."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    torch.manual_seed(args.seed)
    model = create_model("attention", **model_kwargs(args)).to(device)
    opt = make_optimizer("attention", model, 1e-4, total_steps=1000)
    step = make_train_step(model, opt, "attention", bf16=True, remat=remat,
                           device_augment=device_augment,
                           reuse_extract_features=fast_extracts)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    card_gen = torch.Generator(device=device).manual_seed(args.seed)
    n, batch = 0, None
    try:
        batch = make_batch(rng, B, T, masked, device)

        def one_step():
            nonlocal n
            draws = draw_extracts(gen, B, T, EXTRACT_RATIO)
            if device_augment:
                draws.update(draw_augmentations(card_gen, batch))
            metrics = step(batch, draws, n)
            n += 1
            return metrics

        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        for _ in range(args.warm):
            metrics = one_step()
        float(metrics["loss"])
        rates = []
        for _ in range(args.timings):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                metrics = one_step()
            loss = float(metrics["loss"])  # the window's sync point
            rates.append(args.steps / (time.perf_counter() - t0))
            if not np.isfinite(loss):
                raise FloatingPointError(f"{tag}: loss {loss}")
        sps = float(np.median(rates))
        out[out_key] = sps
        if cuda:
            out[f"{tag}_peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        fl = train_step_flops(model, B, T, remat=remat, fast_extracts=fast_extracts)
        out[f"train_tflops_per_step_{tag}"] = fl / 1e12
        out[f"train_mfu_{tag}_dispatched"] = fl * sps / H100_BF16_PEAK_FLOPS
        return sps
    except torch.cuda.OutOfMemoryError:
        out[f"{tag}_error"] = "OOM"
        return None
    finally:
        del model, opt, step, batch
        if cuda:
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    out = {"train_steps": args.steps, "train_timings": args.timings,
           "train_dtype": "bfloat16", **describe_card(device)}
    if device.type == "cuda":
        out["card_memory_gb"] = torch.cuda.get_device_properties(device).total_memory / 1e9

    tag1 = f"b{args.batch}_t{args.frames}"
    for fast in (False, True):
        tag = tag1 + ("_fast_extracts" if fast else "")
        measure(args, out, tag, args.batch, args.frames, masked=False, device_augment=False,
                remat=False, fast_extracts=fast,
                out_key=f"train_steps_per_sec_{tag}_bf16_dispatched")
        emit(out)
    if args.skip_t512:
        return 0

    for remat in (False, True):
        tag = (f"b{args.long_batch}_t{args.long_frames}_devaug_remat_"
               + ("on" if remat else "off"))
        measure(args, out, tag, args.long_batch, args.long_frames, masked=True,
                device_augment=True, remat=remat, fast_extracts=False,
                out_key=f"train_steps_per_sec_{tag}_dispatched")
        emit(out)
    off = f"b{args.long_batch}_t{args.long_frames}_devaug_remat_off"
    peak = out.get(f"{off}_peak_mem_gb")
    out["t512_fits_hbm_without_remat"] = (
        f"{off}_error" not in out
        and (peak is None or peak < out.get("card_memory_gb", float("inf"))))
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
