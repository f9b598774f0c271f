"""Probe: the spatial conv stack in int8 against the production bf16 stack.

Port of tools/exp_int8_conv.py. Int8 activations halve the bytes that
cross each conv boundary, and the input is already uint8 pixels, which
conv0 can take with a zero-point shift alone, without the uint8 -> bf16
convert. Legs, each K iterations captured in one CUDA graph:

  bf16_stack   uint8 -> bf16 / 255 -> conv0..3 (cuDNN, channels-last, bias
               and ReLU)                                     [production]
  int8_stack   uint8 -> conv0..3 on K4 (ops/conv_int8.py: the shift to
               int8 folded into conv0's loads, int32 sums, a fused scale +
               bias + ReLU + requantize epilogue to int8, bf16 after conv3)
  bf16_conv0   convert + conv0 only
  int8_conv0   int8 conv0 only (no convert)

Weights and scales are the JAX probe's own draws (`probe_weights`, numpy
seed 0): float weights and biases, per-output-channel symmetric int8
weights, requant scales 0.05; then the uint8 frames from the same
generator. They time the paths, not accuracy. Each iteration takes the
frames plus its index (uint8, wrapping, as the probe's `x + i`) and adds
the f32 sum of the leg's output to a scalar, so nothing is skipped. The
graph is replayed once untimed and then REPS times, each replay timed by
CUDA events; a leg's number is the median replay over K, in ms (the JAX
key's meaning: device time per iteration). A leg that raises prints its
repr under its key, as the probe does.

The JAX tool's environment variables: EXP_N frames (16,384), EXP_K
iterations per graph (20), EXP_REPS replays (3). With --device cpu the
legs run eagerly on the plain versions and are timed by the host clock
(for the tests; not a device time).

    python -m video_fingerprint_tpu_torch.tools.exp_int8_conv [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.ops.conv_int8 import conv_int8, pack_weight
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.timing import loop_ms

HW = 64
SPECS = ((5, 3, 32), (3, 32, 64), (3, 64, 128), (3, 128, 256))  # (k, Cin, Cout)
LEGS = ("bf16_conv0_ms", "int8_conv0_ms", "bf16_stack_ms", "int8_stack_ms")


def probe_weights(rng: np.random.Generator):
    """The JAX probe's draws, in its order (tools/exp_int8_conv.py:51-64):
    float HWIO weights, biases, symmetric int8 weights and their
    per-output-channel scales, and the activations' requant scales."""
    ws_f = [rng.normal(0, 0.1, (k, k, ci, co)).astype(np.float32) for k, ci, co in SPECS]
    bs_f = [rng.normal(0, 0.1, co).astype(np.float32) for _, _, co in SPECS]
    ws_q, w_scales = [], []
    for w in ws_f:
        s = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        ws_q.append(np.clip(np.round(w / s), -127, 127).astype(np.int8))
        w_scales.append(s.astype(np.float32))
    a_scales = [np.float32(0.05)] * len(SPECS)
    return ws_f, bs_f, ws_q, w_scales, a_scales


def int8_layers(ws_q, w_scales, bs_f, a_scales, device):
    """Per layer (packed weights, w_scale, bias, requant) on `device`."""
    return [(pack_weight(torch.from_numpy(w).to(device)), torch.from_numpy(s).to(device),
             torch.from_numpy(b).to(device), float(a))
            for w, s, b, a in zip(ws_q, w_scales, bs_f, a_scales)]


def bf16_layers(ws_f, bs_f, device):
    """Per layer (OIHW bf16 weight, bf16 bias, padding), channels-last on a card."""
    out = []
    for w, b in zip(ws_f, bs_f):
        wt = torch.from_numpy(w).permute(3, 2, 0, 1).to(device, torch.bfloat16)
        if device.type == "cuda":
            wt = wt.contiguous(memory_format=torch.channels_last)
        out.append((wt, torch.from_numpy(b).to(device, torch.bfloat16), w.shape[0] // 2))
    return out


def bf16_stack(layers, depth: int):
    """uint8 NHWC frames -> the bf16 stack's NCHW (channels-last) output."""
    def body(x):
        y = x.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0
        for w, b, pad in layers[:depth]:
            y = torch.relu(F.conv2d(y, w, b, stride=2, padding=pad))
        return y
    return body


def int8_stack(layers, depth: int):
    """uint8 NHWC frames -> the int8 stack's NHWC output (bf16 after the
    last layer, int8 between layers)."""
    def body(x):
        y = x
        for i, (pw, w_scale, bias, requant) in enumerate(layers[:depth]):
            y = conv_int8(y, pw, w_scale, bias, None if i == depth - 1 else requant)
        return y
    return body


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

    rng = np.random.default_rng(0)
    ws_f, bs_f, ws_q, w_scales, a_scales = probe_weights(rng)
    x = torch.from_numpy(rng.integers(0, 256, (n, HW, HW, 3), dtype=np.uint8)).to(device)
    q_layers = int8_layers(ws_q, w_scales, bs_f, a_scales, device)
    f_layers = bf16_layers(ws_f, bs_f, device)

    results = {}
    with torch.no_grad():
        bodies = (bf16_stack(f_layers, 1), int8_stack(q_layers, 1),
                  bf16_stack(f_layers, len(SPECS)), int8_stack(q_layers, len(SPECS)))
        for name, body in zip(LEGS, bodies):
            try:
                results[name] = loop_ms(lambda i, acc: body(x + i), k, reps, device)
            except Exception as exc:  # noqa: BLE001 - the probe reports a failed leg
                results[name] = repr(exc)[:300]
            print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
