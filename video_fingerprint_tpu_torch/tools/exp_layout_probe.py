"""Layout probe: one elementwise pass over (B, T, H, W, C = 3) against
(B, T, C, H, W), and the transpose round trip between them.

Port of tools/exp_layout_probe.py, which asks whether device augment
(ops/device_augment.py) should run channels-first. It times one
x * 1.0001 + 0.1 pass (one `torch.addcmul`: read x, write y) over f32 clips
in each layout, and the round trip channels-last -> channels-first ->
channels-last around a x 1.0001 pass, each transpose made real with
`.contiguous()` (in PyTorch a `movedim` alone is a view, and elementwise
ops follow their input's strides, so without it no byte would move; XLA
lays the transposes out in memory). Each leg is K iterations captured in
one CUDA graph; iteration i scales x by 1 + acc * 1e-12 (acc the running
sum, a 0-d tensor, so nothing is hoisted or skipped) and adds its output's
sum * 1e-30 to acc, the JAX loop's body; the sum reads the output once
more, in both layouts alike. The graph is replayed once untimed and then 3
times, each replay timed by CUDA events; a leg's number is the median
replay over K, in ms.

The JAX tool's flags: --batch 16 --frames 64 --k 16; --device cpu takes
the place of --cpu (the legs then run eagerly, timed by the host clock:
for the tests, not a device time).

    python -m video_fingerprint_tpu_torch.tools.exp_layout_probe [--batch 16]
        [--frames 64] [--k 16] [--device cuda|cpu]

Prints a comment line naming the device, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.timing import loop_ms

HW = 64
REPS = 3


def mult(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x * (1.0001 scale) + 0.1 in one pass."""
    return torch.addcmul(torch.full((), 0.1, device=x.device), x, scale * 1.0001)


def roundtrip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """channels-last -> channels-first (in memory), x 1.0001, and back."""
    y = x.movedim(-1, 2).contiguous() * (scale * 1.0001)
    return y.movedim(2, -1).contiguous()


def body(fn, x: torch.Tensor):
    """The JAX loop's body: y = fn(x, 1 + acc * 1e-12), whose sum loop_ms
    adds to acc with weight 1e-30."""
    return lambda i, acc: fn(x, 1.0 + acc * 1e-12)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {json.dumps(describe_card(device))}", flush=True)
    B, T = args.batch, args.frames
    rng = np.random.default_rng(0)
    nhwc = torch.from_numpy(rng.random((B, T, HW, HW, 3), np.float32)).to(device)
    nchw = nhwc.movedim(-1, 2).contiguous()
    with torch.no_grad():
        out = {"batch": B, "frames": T, "k": args.k,
               "mult_nhwc_ms": loop_ms(body(mult, nhwc), args.k, REPS, device, 1e-30),
               "mult_nchw_ms": loop_ms(body(mult, nchw), args.k, REPS, device, 1e-30),
               "transpose_roundtrip_ms": loop_ms(body(roundtrip, nhwc), args.k, REPS,
                                                 device, 1e-30)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
