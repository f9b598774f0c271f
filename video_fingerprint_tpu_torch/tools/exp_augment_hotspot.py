"""Device time of each stage of the on-device augmentation pipeline.

Port of tools/exp_augment_hotspot.py. Times each stage of
ops/device_augment.py::apply_augmentations alone (color, flip, noise, blur,
letterbox + overlay, rotation) and the whole pipeline, on f32 clips at the
train step's per-frame parameters (`sample_params` with num_frames), to
find the stage that costs the most.

The JAX tool loops each stage K times in one `lax.fori_loop`. Here each
stage's K iterations are captured in one CUDA graph, each iteration's input
perturbed by the running sum of the outputs before it (so no iteration can
be skipped or reused), and the graph is replayed 3 times, each replay timed
by CUDA events: the median replay over K is `<stage>_ms_per_iter`, the
device time of one iteration, the JAX key's meaning. The noise stages draw
their Gaussian noise once from an explicit torch.Generator, as the JAX
stages use fixed keys.

On the CPU (`--device cpu`) every stage runs once and no time is measured
(the times are null): a CUDA graph needs a card.

    python -m video_fingerprint_tpu_torch.tools.exp_augment_hotspot [--batch 16]
        [--frames 64] [--k 8] [--device cuda|cpu]

Prints a comment line naming the device, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import device_augment as da
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.timing import capture_graph, replay_ms

HW = 64
STAGES = ("color", "flip", "noise", "blur", "letterbox_overlay", "rotation", "full_pipeline")


def _letterbox_overlay(params, x: torch.Tensor) -> torch.Tensor:
    """The letterbox and overlay steps of apply_augmentations, as the JAX
    tool's own `_letterbox_overlay` spells them."""
    B, H, W = x.shape[0], x.shape[2], x.shape[3]
    g = lambda name: params[name].reshape((B, 1, 1, 1, 1))  # noqa: E731
    # (B,) or per-frame (B, T) params, as in ops/device_augment
    fb = lambda p: p.reshape(p.shape + (1,) * (5 - p.ndim))  # noqa: E731
    bar = fb(params["letterbox_bar"])
    rows = torch.arange(H, device=x.device).reshape((1, 1, H, 1, 1))
    cols = torch.arange(W, device=x.device).reshape((1, 1, 1, W, 1))
    row_bar = (rows < bar) | (rows >= H - bar)
    col_bar = (cols < bar) | (cols >= W - bar)
    vert = fb(params["letterbox_vertical"]) > 0
    barred = torch.where(vert, torch.where(row_bar, 0.0, x), torch.where(col_bar, 0.0, x))
    x = torch.where(g("do_letterbox") > 0, barred, x)
    oy, ox, ohh, oww = (fb(params["overlay_box"][..., i]) for i in range(4))
    in_box = (rows >= oy) & (rows < oy + ohh) & (cols >= ox) & (cols < ox + oww)
    return torch.where(g("do_overlay") * in_box > 0, 0.7 * x + 0.3, x)


def make_stages(params, noise: torch.Tensor, pipeline_noise: torch.Tensor) -> dict:
    """{stage: fn(clips) -> clips}: the JAX tool's stage lambdas on the
    port's transforms, `noise` the noise stage's standard normal draw and
    `pipeline_noise` the whole pipeline's."""
    B = params["do_flip"].shape[0]
    g = lambda name: params[name].reshape((B, 1, 1, 1, 1))  # noqa: E731
    return {
        "color": lambda x: da._color(x, params),
        "flip": lambda x: torch.where(g("do_flip") > 0, x.flip(3), x),
        "noise": lambda x: torch.clamp(x + noise * g("noise_level"), 0.0, 1.0),
        "blur": lambda x: da._blur(x, params["blur_idx"]),
        "letterbox_overlay": lambda x: _letterbox_overlay(params, x),
        "rotation": lambda x: da._rotate_bilinear(x, params["rotation_angle"]),
        "full_pipeline": lambda x: da.apply_augmentations(params, x, pipeline_noise),
    }


def stage_ms(fn, clips: torch.Tensor, k: int) -> float | None:
    """Median device ms of one iteration over 3 replays of a graph of k
    perturbed iterations of fn; None on the CPU, where fn runs once."""
    acc = torch.zeros((), device=clips.device)

    def iteration():
        y = fn(clips + acc * 1e-12)
        acc.add_(y.sum() * 1e-30)

    if clips.device.type != "cuda":
        iteration()
        ms = None
    else:
        ms = statistics.median(replay_ms(capture_graph(iteration, k), k, timings=3))
    if not bool(torch.isfinite(acc)):
        raise FloatingPointError(f"non-finite stage output: {acc}")
    return ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {json.dumps(describe_card(device))}", flush=True)
    B, T = args.batch, args.frames
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.random((B, T, HW, HW, 3), np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = da.sample_params(gen, B, HW, num_frames=T)  # per-frame, the train step's shape
    noise = torch.randn(clips.shape, generator=gen, device=device)
    pipeline_noise = torch.randn(clips.shape, generator=gen, device=device)
    out = {"batch": B, "frames": T, "k": args.k}
    for name, fn in make_stages(params, noise, pipeline_noise).items():
        out[f"{name}_ms_per_iter"] = stage_ms(fn, clips, args.k)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
