"""The conv-block probe: can a hand-written conv match the library for one
layer of the spatial encoder?

The layer is the encoder's third conv (3x3, stride 2, 64 -> 128 channels,
16x16 -> 8x8, + bias + ReLU), in bf16 with f32 accumulation. The port of
tools/exp_pallas_convblock.py; its Pallas kernels are the hand-written CUDA
kernel of ops/convblock.py here. One JSON line per leg:

  numerics      both kernel entry points against the plain version and an
                f64 oracle on 256 seeded frames (on the CPU: the plain version
                against the oracle, and the parity split against the full
                input)
  cudnn_nhwc    F.conv2d on a channels-last bf16 (N, 64, 16, 16) tensor,
                + bias + ReLU: the library's time for the layer (timed only)
  cuda_cyxf     the kernel on the parity split xe, xo (64, 16, 8, N)
  cuda_strided  the kernel on x (64, 16, 16, N)

Times are CUDA events over back-to-back calls after a warm-up.

    python -m video_fingerprint_tpu_torch.tools.convblock_probe                # card
    python -m video_fingerprint_tpu_torch.tools.convblock_probe --device cpu   # numerics only
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.ops import convblock as cb
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.timing import cuda_ms

NUMERICS_FRAMES = 256


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _seeded_inputs(device: torch.device, n: int):
    """The JAX probe's numerics inputs (numpy seed 0): x (64, 16, 16, n),
    w2d (128, 576) and b (128, 1), all bf16."""
    rng = np.random.default_rng(0)
    x_nhwc = rng.standard_normal((n, cb.HW_IN, cb.HW_IN, cb.CIN)).astype(np.float32)
    k_hwio = (rng.standard_normal((3, 3, cb.CIN, cb.COUT)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cb.COUT) * 0.1).astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(3, 1, 2, 0)))
    return (x.to(device, torch.bfloat16), cb.hwio_to_w2d(k_hwio).to(device),
            torch.from_numpy(b).reshape(cb.COUT, 1).to(device, torch.bfloat16))


def leg_numerics(device: torch.device) -> dict:
    x, w2d, b = _seeded_inputs(device, NUMERICS_FRAMES)
    with full_fp32():
        plain = cb._conv_torch(x, w2d, b)
    oracle = cb.f64_oracle(x, w2d, b)
    deltas = {}
    err, ok = cb.compare(plain, oracle, cb.VS_F64)
    _require(ok, f"plain version vs f64 oracle: max abs {err}")
    deltas["plain_vs_f64"] = err
    parity = cb.conv_parity(*cb.split_parity(x), w2d, b)
    strided = cb.conv_strided(x, w2d, b)
    _require(torch.equal(parity, strided), "conv_parity and conv_strided differ")
    if device.type == "cuda":
        torch.cuda.synchronize()
        for name, got in (("conv_parity", parity), ("conv_strided", strided)):
            err, ok = cb.compare(got, plain, cb.ONE_ULP)
            _require(ok, f"{name} vs plain: max abs {err}")
            deltas[f"{name}_vs_plain"] = err
            err, ok = cb.compare(got, oracle, cb.VS_F64)
            _require(ok, f"{name} vs f64 oracle: max abs {err}")
            deltas[f"{name}_vs_f64"] = err
    return {"leg": "numerics", "device": _device_name(device),
            "frames": NUMERICS_FRAMES, "max_abs_delta": deltas}


def random_inputs(device: torch.device, n: int, seed: int = 1):
    """Seeded x (64, 16, 16, n), w2d (128, 576) and b (128, 1), bf16, made
    on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((cb.CIN, cb.HW_IN, cb.HW_IN, n), generator=g, device=device)
    w2d = torch.randn((cb.COUT, cb.K), generator=g, device=device) * 0.1
    b = torch.randn((cb.COUT, 1), generator=g, device=device) * 0.1
    return x.to(torch.bfloat16), w2d.to(torch.bfloat16), b.to(torch.bfloat16)


def cudnn_leg(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor):
    """The library's call for the layer: F.conv2d on a channels-last bf16
    (N, 64, 16, 16) copy of x, + bias + ReLU."""
    x_nhwc = x.permute(3, 0, 1, 2).contiguous(memory_format=torch.channels_last)
    w_oihw = w2d.reshape(cb.COUT, 3, 3, cb.CIN).permute(0, 3, 1, 2).contiguous()
    return lambda: torch.relu_(F.conv2d(x_nhwc, w_oihw, b.reshape(cb.COUT), stride=2, padding=1))


def timed_legs(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor, window_ms: float):
    """The library, K2 and K3 on the same inputs, on the card."""
    xe, xo = (t.contiguous() for t in cb.split_parity(x))
    legs = (
        ("cudnn_nhwc", cudnn_leg(x, w2d, b)),
        ("cuda_cyxf", lambda: cb.conv_parity(xe, xo, w2d, b)),
        ("cuda_strided", lambda: cb.conv_strided(x, w2d, b)),
    )
    for name, fn in legs:
        yield {"leg": name, "device": _device_name(x.device), "frames": x.shape[3],
               "ms": cuda_ms(fn, window_ms)}


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16384,
                    help="frames of the timed legs (the JAX probe's EXP_N)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the numerics leg only")
    ap.add_argument("--window-ms", type=float, default=100.0,
                    help="device time each timed leg fills")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA card; pass --device cpu")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    print(json.dumps(leg_numerics(device)), flush=True)
    if device.type == "cuda":
        for row in timed_legs(*random_inputs(device, args.frames), args.window_ms):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
