"""Stage profile of the attention fingerprint forward on one card.

Port of tools/profile_extraction.py, with the cumulative legs of
tools/exp_stack_roofline.py and the conv0 probes of tools/exp_conv_hotspot.py
(`exp_stack_roofline.py` and `exp_conv_hotspot.py` beside this module are
thin entry points over its functions). It answers where the headline's
forward spends its time, stage by stage, against each stage's bound.

Workload: the benchmark headline's model (`bench_headline.fused_model`:
the seeded full-width attention model, BatchNorm folded, bf16, the spatial
encoder channels-last) on B = 512 videos x T = 128 seeded 64x64 uint8
frames resident on the card.

Legs, each in ms per batch:

  split    the JAX tool's split: the full `forward_flat`, the spatial
           encoder alone (`_encode_flat`) and the temporal stack alone
           (`forward_from_features` on seeded features), for f32 (TF32
           off) and bf16 with BatchNorm as is, and fused-f32 / fused-bf16
  stack    cumulative prefixes of the fused bf16 `forward_flat` (`stages`
           chained): convert (uint8 -> bf16 / 255), conv0, conv0..1,
           conv0..2, conv0..3, spatial (+ pool + linear), full. A leg's
           difference with the one before is that stage's own time. Each
           leg stands beside its byte bound (each stage's input read once
           and its output written once, at 3.35 TB/s) and its operation
           bound (the layers' products, `utils/flops.py`, at 989.4 TFLOP/s
           dense bf16). Eager PyTorch fuses nothing across stages, so no
           reduce is appended (it would add a read of each leg's output that
           the forward never makes); the JAX legs summed in-graph instead.
  conv0    the JAX conv hotspot's probes (each followed by a sum to f32, as
           there): convert_sum, conv0_u8 (convert + conv0 + bias + relu) and
           conv0_wideG (G adjacent output pixels packed into the channels,
           G = 4, 8); and the JAX profile's layout variant: conv0 as a 5x5
           stride-2 conv on Cin = 3 against the space-to-depth 3x3 stride-1
           conv on Cin = 12 (with its relayout), in f32 and bf16
  kernels  the device kernels of one full bf16 forward by name and CUDA
           time (torch.profiler, a range per stage): the longest of the
           forward with K1's share and the traced share of the forward's
           time, and each stage's longest; `--trace DIR` also writes the
           profiler's chrome trace there (the JAX `--trace`)

The stack and conv0 legs run with `torch.backends.cudnn.benchmark` off (the
port's default, which the scan and the headline run) and again with it on;
the flag is restored after each leg. Timing is CUDA events over CUDA-graph
replay (`utils/timing.py::graph_ms`); a stage whose capture fails raises.
With --device cpu (small widths, for the tests) each leg runs once, the
stages are checked to chain to `forward_flat`, and every time is null: a
CUDA graph needs a card.

    python -m video_fingerprint_tpu_torch.tools.profile_extraction [--trace DIR]
    python -m video_fingerprint_tpu_torch.tools.profile_extraction --device cpu \\
        --batch 2 --frames 4 --spatial_dim 16 --temporal_dim 32 --embedding_dim 32
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import statistics
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import space_to_depth_kernel
from video_fingerprint_tpu_torch.models.layers import space_to_depth
from video_fingerprint_tpu_torch.ops import attention as attn
from video_fingerprint_tpu_torch.tools.bench_common import (
    H100_BF16_PEAK_FLOPS,
    describe_card,
    emit,
    model_kwargs,
    panning_clips,
    seeded_state_dict,
    widths_args,
)
from video_fingerprint_tpu_torch.tools.bench_headline import _event_ms, fused_model
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.flops import head_flops, spatial_conv_flops
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.timing import graph_ms

B, T, HW = 512, 128, 64
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
STACK_LEGS = ("convert", "conv0", "conv0_1", "conv0_2", "conv0_3", "spatial", "full")
WIDE_GROUPS = (4, 8)
SEED = 0
TOP_KERNELS = 12


def stages(model: nn.Module) -> List[Tuple[str, Callable]]:
    """The per-frame CNN of `forward_flat` as (name, callable) stages, the
    model's own modules in its order: chained, then
    `forward_from_features`, they are `forward_flat`."""
    if model.spatial_encoder.s2d:
        raise ValueError("the stage profile takes the standard conv0 layout (s2d=False)")
    enc = model.spatial_encoder.encoder
    return ([("convert", model.input_from_frames)]
            + [(f"conv{i}", enc[3 * i:3 * i + 3]) for i in range(4)]
            + [("pool_linear", enc[12:])])


def chained_forward(model: nn.Module, flat_frames: torch.Tensor, batch: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`forward_flat` as the stages chained."""
    x = flat_frames
    for _, stage in stages(model):
        x = stage(x)
    return model.forward_from_features(x.reshape(batch, -1, x.shape[-1]), mask)


def stack_leg(model: nn.Module, leg: str, batch: int) -> Callable:
    """flat frames -> the output of cumulative leg `leg` (STACK_LEGS)."""
    if leg == "full":
        return lambda flat: model.forward_flat(flat, batch)
    depth = {"convert": 1, "conv0": 2, "conv0_1": 3, "conv0_2": 4, "conv0_3": 5,
             "spatial": 6}[leg]
    chain = [stage for _, stage in stages(model)[:depth]]

    def run(flat):
        x = flat
        for stage in chain:
            x = stage(x)
        return x
    return run


def stack_counts(model: nn.Module, frames: int, batch: int, frame_size: int = HW,
                 elem_bytes: int = 2) -> Dict[str, Dict[str, int]]:
    """Bytes and operations of each cumulative leg on `frames` frames in
    `batch` videos: every stage reads its input once and writes its output
    once (uint8 frames in, activations of `elem_bytes`, the f32 embedding
    out); operations are the layers' products (utils/flops.py)."""
    convs = [m for m in model.spatial_encoder.encoder if isinstance(m, nn.Conv2d)]
    conv_flops = spatial_conv_flops(model, frame_size)
    linear = model.spatial_encoder.encoder[-1]
    size, channels = frame_size, 3
    pixels = frames * size * size * channels
    stage = {"convert": (pixels + pixels * elem_bytes, 0)}
    for i, conv in enumerate(convs):
        read = frames * channels * size * size * elem_bytes
        size = (size + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
        channels = conv.out_channels
        stage[f"conv{i}"] = (read + frames * channels * size * size * elem_bytes,
                             frames * conv_flops[i])
    stage["pool_linear"] = (frames * (channels * size * size + linear.out_features) * elem_bytes,
                            frames * 2 * linear.in_features * linear.out_features)
    embedding = model.final_projection[-1].out_features
    stage["head"] = (frames * linear.out_features * elem_bytes + batch * embedding * 4,
                     batch * head_flops(model, frames // batch))
    order = ["convert", "conv0", "conv1", "conv2", "conv3", "pool_linear", "head"]
    out, nbytes, flops = {}, 0, 0
    for leg, name in zip(STACK_LEGS, order):
        nbytes += stage[name][0]
        flops += stage[name][1]
        out[leg] = {"bytes": nbytes, "flops": flops}
    return out


def bound(nbytes: int, flops: int, bytes_per_s: float = H100_BYTES_PER_S,
          flops_per_s: float = H100_BF16_PEAK_FLOPS) -> Dict[str, object]:
    """The least time for `nbytes` and `flops` on an H100: the larger of
    the two times, and which one it is."""
    byte_ms, flop_ms = nbytes / bytes_per_s * 1e3, flops / flops_per_s * 1e3
    return {"byte_bound_ms": byte_ms, "flop_bound_ms": flop_ms,
            "bound_ms": max(byte_ms, flop_ms),
            "bound_by": "bytes" if byte_ms >= flop_ms else "operations"}


def widen_kernel(w: np.ndarray, b: np.ndarray, group: int):
    """(5, 5, 3, 32) HWIO stride-2 kernel -> (5, 5 + 2 (group - 1), 3,
    group * 32) that computes `group` adjacent output pixels per application
    (stride 2 * group): copied from the root tool."""
    kh, kw, cin, cout = w.shape
    wide = np.zeros((kh, kw + 2 * (group - 1), cin, group * cout), w.dtype)
    for g in range(group):
        wide[:, 2 * g:2 * g + kw, :, g * cout:(g + 1) * cout] = w
    return wide, np.tile(b, group)


def wide_conv0(conv0: nn.Conv2d, group: int, frame_size: int = HW):
    """conv0's weights widened by `group` (torch OIHW), and the conv:
    (N, 3, H, W) -> (N, group * 32, H / 2, W / (2 group)), output pixel
    j = group q + g of channel c at [:, g * 32 + c, :, q]. The JAX
    padding ((2, 2), (2, pad_hi)) is asymmetric, so the input is padded
    first."""
    w = conv0.weight.detach().float().permute(2, 3, 1, 0).cpu().numpy()
    b = conv0.bias.detach().float().cpu().numpy()
    wide, bias = widen_kernel(w, b, group)
    kw = wide.shape[1]
    out_w = frame_size // 2
    pad_hi = max(0, 2 * group * (out_w // group - 1) + kw - (frame_size + 2))
    weight = torch.from_numpy(wide).permute(3, 2, 0, 1).contiguous()
    weight = weight.to(device=conv0.weight.device, dtype=conv0.weight.dtype)
    bias = torch.from_numpy(bias).to(device=conv0.weight.device, dtype=conv0.weight.dtype)

    def conv(x):
        return F.relu(F.conv2d(F.pad(x, (2, pad_hi, 2, 2)), weight, bias, stride=(2, 2 * group)))
    return conv


def unpack_wide(y: torch.Tensor, group: int) -> torch.Tensor:
    """wide_conv0's output -> conv0's (N, 32, H / 2, W / 2)."""
    n, c, h, q = y.shape
    return y.reshape(n, group, c // group, h, q).permute(0, 2, 3, 4, 1).reshape(
        n, c // group, h, q * group)


@contextlib.contextmanager
def cudnn_benchmark(on: bool):
    """torch.backends.cudnn.benchmark set to `on` inside the block and
    restored after it."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = on
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def leg_ms(fn: Callable, device: torch.device, reps: int = 1, calls: int = 1
           ) -> Optional[float]:
    """Device ms per call of fn() by CUDA-graph replay (`calls` calls per
    graph, the median of `reps` captures); on the CPU, fn runs once and the
    time is None."""
    if device.type != "cuda":
        fn()
        return None
    return statistics.median(graph_ms(fn, calls=calls) for _ in range(reps))


def _benchmark_pair(fn: Callable, device: torch.device, reps: int, calls: int
                    ) -> Dict[str, Optional[float]]:
    out = {}
    for on in (False, True):
        with cudnn_benchmark(on):
            out["benchmark_on" if on else "benchmark_off"] = leg_ms(fn, device, reps, calls)
    return out


def seeded_frames(seed: int, videos: int, frames: int, device: torch.device) -> torch.Tensor:
    """(videos * frames, 64, 64, 3) uint8 seeded panning clips on `device`."""
    return panning_clips(torch.Generator(device=device).manual_seed(seed), videos, frames, HW)


def split_legs(args, device: torch.device, flat: torch.Tensor) -> Dict[str, dict]:
    """The JAX tool's full / spatial / temporal split per configuration."""
    kwargs = model_kwargs(args)
    sd = seeded_state_dict(SEED, **kwargs)
    spatial_dim = create_model("attention", **kwargs).spatial_dim
    feats = torch.from_numpy(np.random.default_rng(SEED).random(
        (args.batch, args.frames, spatial_dim)).astype(np.float32)).to(device)
    out = {}
    for name, dtype, fused in (("f32", torch.float32, False), ("bf16", torch.bfloat16, False),
                               ("fused-f32", torch.float32, True),
                               ("fused-bf16", torch.bfloat16, True)):
        if fused:
            model = fused_model(SEED, device, dtype, **kwargs)
        else:
            model = create_model("attention", **kwargs)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
            model.to(device=device, dtype=dtype).eval()
            if device.type == "cuda":
                model.spatial_encoder.to(memory_format=torch.channels_last)
        precision = full_fp32() if dtype == torch.float32 else contextlib.nullcontext()
        f = feats.to(dtype)
        with torch.no_grad(), precision:
            row = {"full_ms": leg_ms(lambda: model.forward_flat(flat, args.batch), device),
                   "spatial_ms": leg_ms(lambda: model._encode_flat(flat), device),
                   "temporal_ms": leg_ms(lambda: model.forward_from_features(f), device)}
        if row["full_ms"]:
            row["videos_per_s"] = args.batch / row["full_ms"] * 1e3
        out[name] = row
        emit({"leg": "split", "config": name, **row})
        del model
    return out


def stack_legs(model: nn.Module, flat: torch.Tensor, batch: int, device: torch.device,
               reps: int = 1, calls: int = 1) -> Dict[str, dict]:
    """Each cumulative leg's ms (cudnn.benchmark off and on) beside its
    bounds, and each stage's own ms (the difference with the leg before)."""
    counts = stack_counts(model, flat.shape[0], batch, flat.shape[1],
                          torch.finfo(model.dtype).bits // 8)
    out, prev = {}, None
    with torch.no_grad():
        for leg in STACK_LEGS:
            fn = stack_leg(model, leg, batch)
            row = {**_benchmark_pair(lambda: fn(flat), device, reps, calls), **counts[leg],
                   **bound(counts[leg]["bytes"], counts[leg]["flops"])}
            if prev is not None and row["benchmark_off"] is not None:
                row["own_ms"] = {k: row[k] - prev[k] for k in ("benchmark_off", "benchmark_on")}
            out[leg] = prev = row
            emit({"leg": "stack", "name": leg, **row})
    return out


def conv0_probes(model: nn.Module, flat: torch.Tensor, device: torch.device,
                 reps: int = 1, calls: int = 1) -> Dict[str, dict]:
    """The conv hotspot's conv0 probes and the s2d layout variant, each
    with cudnn.benchmark off and on; the widened conv's output unpacked
    against conv0's in f32 (TF32 off), and the s2d conv's against the 5x5
    conv's in f32 and bf16, on 64 frames (max abs)."""
    convert = model.input_from_frames
    conv0 = model.spatial_encoder.encoder[0:3]
    total = lambda y: y.sum(dtype=torch.float32)
    out = {}
    with torch.no_grad():
        probes = {"convert_sum": lambda: total(convert(flat)),
                  "conv0_u8": lambda: total(conv0(convert(flat)))}
        wides = {g: wide_conv0(conv0[0], g, flat.shape[1]) for g in WIDE_GROUPS}
        for g, wide in wides.items():
            probes[f"conv0_wide{g}"] = lambda wide=wide: total(wide(convert(flat)))
        for name, fn in probes.items():
            out[name] = _benchmark_pair(fn, device, reps, calls)
            emit({"leg": "conv0", "name": name, **out[name]})
        c32 = copy.deepcopy(conv0[0]).float()
        x64 = flat[:64].permute(0, 3, 1, 2).float() / 255.0
        with full_fp32():
            out["wide4_vs_ref_maxerr"] = (unpack_wide(wide_conv0(c32, 4, flat.shape[1])(x64), 4)
                                          - F.relu(c32(x64))).abs().max().item()

        w5 = conv0[0].weight.detach().float()
        w3 = torch.from_numpy(space_to_depth_kernel(w5.cpu().numpy())).to(device)
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            precision = full_fp32() if dtype == torch.float32 else contextlib.nullcontext()
            x = flat.permute(0, 3, 1, 2).to(dtype) / 255.0
            k5, k3 = w5.to(dtype), w3.to(dtype)
            plain = lambda: total(F.conv2d(x, k5, stride=2, padding=2))
            s2d = lambda: total(F.conv2d(space_to_depth(x), k3, stride=1, padding=1))
            with precision:
                out[f"conv1_{dname}_k5s2_cin3"] = _benchmark_pair(plain, device, reps, calls)
                out[f"conv1_{dname}_s2d_k3s1_cin12"] = _benchmark_pair(s2d, device, reps, calls)
                xs = x[:64]
                out[f"s2d_{dname}_vs_k5s2_maxerr"] = (
                    F.conv2d(space_to_depth(xs), k3, stride=1, padding=1).float()
                    - F.conv2d(xs, k5, stride=2, padding=2).float()).abs().max().item()
            emit({"leg": "conv0", "layout": dname,
                  "k5s2_cin3": out[f"conv1_{dname}_k5s2_cin3"],
                  "s2d_k3s1_cin12": out[f"conv1_{dname}_s2d_k3s1_cin12"],
                  "s2d_vs_k5s2_maxerr": out[f"s2d_{dname}_vs_k5s2_maxerr"]})
            del x
    return out


def _kernels_under(event) -> List:
    """The device kernels launched under a profiler CPU event, its
    descendants' included."""
    out = list(event.kernels)
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def _by_name(kernels, top: int) -> dict:
    ms: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for k in kernels:
        ms[k.name] = ms.get(k.name, 0.0) + k.duration / 1e3
        calls[k.name] = calls.get(k.name, 0) + 1
    total = sum(ms.values())
    rows = sorted(ms.items(), key=lambda kv: -kv[1])
    return {"device_ms": total, "kernel_names": len(rows),
            "kernels": [{"name": n[:120], "ms": t, "calls": calls[n],
                         "share": t / total} for n, t in rows[:top]]}


def kernel_attribution(model: nn.Module, flat: torch.Tensor, batch: int,
                       trace: Optional[str] = None) -> dict:
    """The device kernels of one forward (`stages` chained, then the head)
    by name and CUDA time, from one torch.profiler window with a range per
    stage: the forward's `TOP_KERNELS` longest with K1's share, and each
    stage's 3 longest (the kernels its torch ops launched; K1's are in the
    forward's list only). Run it before any CUDA graph is captured in the
    process: on the H100 machine, profiler windows opened after graph captures
    recorded only part of the forward's kernels (`traced_share` says how
    much). With `trace`, the chrome trace goes into that folder."""
    from torch.profiler import ProfilerActivity, profile, record_function

    head = ("head", lambda f: model.forward_from_features(f.reshape(batch, -1, f.shape[-1])))
    named = stages(model) + [head]
    chained_forward(model, flat, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x = flat
        for name, stage in named:
            with record_function(f"stage:{name}"):
                x = stage(x)
        torch.cuda.synchronize()
    per_stage = {}
    for event in prof.events():
        name = event.name.removeprefix("stage:")
        if event.name.startswith("stage:") and str(event.device_type).endswith("CPU"):
            per_stage[name] = _kernels_under(event)
    if set(per_stage) != {name for name, _ in named}:
        raise RuntimeError(f"torch.profiler recorded the stages {sorted(per_stage)}")
    # the forward's kernels from the whole window: K1, launched through
    # ctypes under no torch op, is attached to no stage's range
    rows = sorted(((e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
                   for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
                   and not e.key.startswith("stage:")), key=lambda r: -r[1])
    rows = [r for r in rows if r[1] > 0]
    if not rows:
        raise RuntimeError("torch.profiler recorded no device kernel")
    total = sum(ms for _, ms, _ in rows)
    k1 = sum(ms for name, ms, _ in rows if "attention_f32" in name or "attention_bf16" in name)
    out = {"device_ms": total, "kernel_names": len(rows), "k1_ms": k1, "k1_share": k1 / total,
           "kernels": [{"name": n[:120], "ms": ms, "calls": c, "share": ms / total}
                       for n, ms, c in rows[:TOP_KERNELS]],
           "stages": {name: _by_name(ks, 3) for name, ks in per_stage.items()}}
    if trace:
        Path(trace).mkdir(parents=True, exist_ok=True)
        out["trace"] = str(Path(trace) / "forward_trace.json")
        prof.export_chrome_trace(out["trace"])
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--frames", type=int, default=T)
    ap.add_argument("--trace", default=None, help="write a chrome trace of the full forward to DIR")
    widths_args(ap)
    return ap.parse_args(argv)


def run(args) -> dict:
    device = resolve_device(args.device)
    model = fused_model(SEED, device, torch.bfloat16, **model_kwargs(args))
    flat = seeded_frames(SEED, args.batch, args.frames, device)
    result = {"batch": args.batch, "frames": args.frames, "frame_size": HW,
              "parameters": sum(p.numel() for p in model.parameters()), **describe_card(device)}
    with torch.no_grad():
        ours = chained_forward(model, flat, args.batch)
        ref = model.forward_flat(flat, args.batch)
    result["chained_vs_forward_flat_maxerr"] = (ours - ref).abs().max().item()
    if device.type == "cuda":  # the kernels first: graph captures upset the profiler
        with torch.no_grad():
            forward = lambda: model.forward_flat(flat, args.batch)
            result["kernels"] = kernel_attribution(model, flat, args.batch, args.trace)
            attn.launches = 0
            forward()
            torch.cuda.synchronize()
            result["k1_launches_per_forward"] = attn.launches
            result["headline_forward_ms"] = _event_ms(forward)
        result["kernels"]["traced_share"] = (result["kernels"]["device_ms"]
                                             / result["headline_forward_ms"])
    result["split"] = split_legs(args, device, flat)
    result["stack"] = stack_legs(model, flat, args.batch, device)
    result["conv0"] = conv0_probes(model, flat, device)
    emit(result)
    return result


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
