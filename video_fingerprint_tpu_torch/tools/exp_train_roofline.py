"""Train-step decomposition and the extract-feature-reuse decision.

Port of tools/exp_train_roofline.py. Splits the B = 64, T = 64 bf16
attention train step (training/train_step.py) into its forward and the rest,
with and without `reuse_extract_features` (the extract forwards embed
gathered rows of the full forward's per-frame features instead of encoding
the gathered pixels again):

  step_base   the full train step, two pixel forwards (the trainer's default)
  step_reuse  the full train step, reuse_extract_features=True
  fwd_base    the train-mode loss alone (make_loss_fn, no grad, no update)
  fwd_reuse   the loss alone, with feature reuse

The JAX legs chain R steps in one `lax.fori_loop`. Here each leg dispatches
R steps (or losses) from the host and syncs once, on the read-back of the
summed losses: the rates carry `_dispatched`. A leg runs one untimed window
first (`<tag>_compile_s_dispatched`: no compiler here, its seconds are the
allocator's and cuDNN's warm-up), then `--timings` windows, and reports the
median. The optimizer step is not captured in a CUDA graph here.

Operations come from utils/flops.py (`flops_source`): products and convs
counted from the layers' shapes (`train_step_flops`, `loss_flops`), not a
compiler's count; MFU is against the H100's dense bf16 peak, 989.4 TFLOP/s.
Derived: the backward and optimizer's ms per step, 1000 (1/step - 1/fwd),
per mode, and the speed-ups of reuse.

    python -m video_fingerprint_tpu_torch.tools.exp_train_roofline [--b 64]
        [--t 64] [--r 10] [--timings 3] [--only step_reuse,fwd_reuse]
        [--device cuda|cpu]

Prints the cumulative JSON line after each leg.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.tools.bench_common import (
    H100_BF16_PEAK_FLOPS,
    describe_card,
    model_kwargs,
    widths_args,
)
from video_fingerprint_tpu_torch.training.optim import make_optimizer
from video_fingerprint_tpu_torch.training.train_step import (
    compute_context,
    draw_extracts,
    make_loss_fn,
    make_train_step,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.flops import loss_flops, train_step_flops

EXTRACT_RATIO = 0.5
LEGS = (("step_base", False), ("step_reuse", True), ("fwd_base", False), ("fwd_reuse", True))
FLOPS_SOURCE = "utils/flops.py (analytic: products and convs from the layers' shapes)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--b", type=int, default=64, help="clip pairs per step (EXP_B)")
    ap.add_argument("--t", type=int, default=64, help="frames per clip (EXP_T)")
    ap.add_argument("--r", type=int, default=10, help="dispatched steps per window (EXP_R)")
    ap.add_argument("--timings", type=int, default=3, help="timed windows (EXP_TIMINGS)")
    ap.add_argument("--only", default="", help="comma-separated legs to run (EXP_ONLY)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    widths_args(ap)
    return ap.parse_args(argv)


def time_windows(run_window, r: int, timings: int, out: dict, tag: str) -> float:
    """The median rate over `timings` windows of r calls, after an untimed
    first window; run_window() returns the window's summed loss, read back
    (the sync)."""
    t0 = time.perf_counter()
    acc = run_window()
    out[f"{tag}_compile_s_dispatched"] = time.perf_counter() - t0
    rates = []
    for _ in range(timings):
        t0 = time.perf_counter()
        acc = run_window()
        rates.append(r / (time.perf_counter() - t0))
        if not np.isfinite(acc):
            raise FloatingPointError(f"{tag}: summed loss {acc}")
    return float(np.median(rates))


def derive(out: dict) -> None:
    """The backward and optimizer ms per step and the reuse speed-ups, where
    the four legs ran."""
    try:
        sb = out["step_base_steps_per_sec_dispatched"]
        sr = out["step_reuse_steps_per_sec_dispatched"]
        fb, fr = out["fwd_base_per_sec_dispatched"], out["fwd_reuse_per_sec_dispatched"]
    except KeyError:
        return
    out["bwd_opt_ms_base"] = 1000 * (1 / sb - 1 / fb)
    out["bwd_opt_ms_reuse"] = 1000 * (1 / sr - 1 / fr)
    out["reuse_step_speedup"] = sr / sb
    out["reuse_fwd_speedup"] = fr / fb


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    B, T, R = args.b, args.t, args.r
    only = {t for t in args.only.split(",") if t}
    out = {**describe_card(device), "B": B, "T": T, "R": R, "dtype": "bfloat16",
           "flops_source": FLOPS_SOURCE}
    rng = np.random.default_rng(0)
    batch = {"clip1": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "clip2": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "video_id": np.arange(B), "mask1": np.ones((B, T), bool),
             "mask2": np.ones((B, T), bool)}
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    for tag, reuse in LEGS:
        if only and tag not in only:
            continue
        torch.manual_seed(0)  # every leg starts from the same weights
        model = create_model("attention", **model_kwargs(args)).to(device).train()
        gen = torch.Generator().manual_seed(1)
        if tag.startswith("step"):
            opt = make_optimizer("attention", model, 1e-4, total_steps=1000)
            step = make_train_step(model, opt, "attention", bf16=True,
                                   reuse_extract_features=reuse)
            done = 0

            def run_window():
                nonlocal done
                acc = torch.zeros((), device=device)
                for _ in range(R):
                    acc += step(batch, draw_extracts(gen, B, T, EXTRACT_RATIO), done)["loss"]
                    done += 1
                return float(acc)

            rate = time_windows(run_window, R, args.timings, out, tag)
            fl = train_step_flops(model, B, T, fast_extracts=reuse)
            out[f"{tag}_steps_per_sec_dispatched"] = rate
            out[f"{tag}_mfu_dispatched"] = fl * rate / H100_BF16_PEAK_FLOPS
        else:
            loss_fn = make_loss_fn(model, "attention", reuse_extract_features=reuse)

            @torch.no_grad()
            def run_window():
                acc = torch.zeros((), device=device)
                with compute_context(device, bf16=True):
                    for _ in range(R):
                        acc += loss_fn(batch, draw_extracts(gen, B, T, EXTRACT_RATIO))[0].float()
                return float(acc)

            rate = time_windows(run_window, R, args.timings, out, tag)
            fl = loss_flops(model, B, T, fast_extracts=reuse)
            out[f"{tag}_per_sec_dispatched"] = rate
        out[f"{tag}_tflops"] = fl / 1e12
        out[f"{tag}_achieved_tflops_s_dispatched"] = fl * rate / 1e12
        print(json.dumps(out), flush=True)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    derive(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
