"""K1 against the plain attention and SDPA at every scan bucket.

Port of tools/exp_pallas_attention_buckets.py. The model's temporal
attention runs on (B·H, T, D) instances with T the scan bucket (32 to 512)
and H = 8. The JAX tool times its Pallas kernel against the jnp einsum chain
(`use_pallas=False`); this times K1, the hand-written kernel
(ops/attention.py::fused_attention on the card, csrc/attention.cu), against
the plain version (`_attention_torch`, the einsum chain's counterpart) and,
as a yardstick only, F.scaled_dot_product_attention: the port never calls
SDPA. Inputs are the JAX tool's numpy draws (normal, seed 0, q, k, v per
bucket), no mask, in f32 as in JAX or in bf16 (`--dtype`); f32 runs with
TF32 off.

Each time is the device time of one CUDA graph holding `--reps` calls,
replayed `--timings` times (each replay timed by CUDA events), median per
call: the counterpart of the JAX tool's `--reps` calls per dispatch. K1's
launch count is checked: the capture of a graph launches it `--reps` times
(once per call), after one warm-up call. Each row also holds K1's largest
difference from the plain version and the least time the card could take
(q, k, v read and o written once at 3.35 TB/s, or 4·BH·T²·D operations at
67 TFLOP/s in f32, 989 TFLOP/s in bf16, whichever is larger).

On the CPU (`--device cpu`) no kernel runs and nothing is timed: the
rows hold the bound, the plain version's largest output and null times.

    python -m video_fingerprint_tpu_torch.tools.exp_attention_buckets [--batch 16]
        [--reps 24] [--dim 32 [4 16 64]] [--dtype float32 [bfloat16]]
        [--device cuda|cpu]

Prints one JSON line per (D, dtype, T) and a final decision line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.ops import attention as attn
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils import trace
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.timing import capture_graph, replay_ms

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bucket_inputs(rng, BH: int, T: int, D: int):
    """q, k, v (BH, T, D) f32 numpy: the JAX tool's draws for one bucket."""
    return tuple(rng.normal(size=(BH, T, D)).astype(np.float32) for _ in range(3))


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version with no mask, TF32 off."""
    with full_fp32():
        return attn._attention_torch(q, k, v, attn._key_bias(None, q.shape[:2], q.device))


def bound_us(BH: int, T: int, D: int, dtype_name: str):
    """(least µs per call, "bytes" or "operations")."""
    elt = 4 if dtype_name == "float32" else 2
    t_bytes = 4 * BH * T * D * elt / PEAK_BYTES_PER_S * 1e6
    t_ops = 4 * BH * T * T * D / PEAK_FLOPS[dtype_name] * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _us(fn, reps: int, timings: int) -> float:
    return statistics.median(replay_ms(capture_graph(fn, reps), reps, timings)) * 1e3


def row_for(q, k, v, dtype_name: str, reps: int, timings: int) -> dict:
    """One bucket: K1 against the plain version, then (on the card) the
    three device times."""
    BH, T, D = q.shape
    ref = plain(q, k, v)
    bound, bound_by = bound_us(BH, T, D, dtype_name)
    row = {"T": T, "BH": BH, "D": D, "dtype": dtype_name, "bound_us_per_call": bound,
           "bound_by": bound_by}
    if not q.is_cuda:
        row.update(plain_us_per_call=None, k1_us_per_call=None, sdpa_us_per_call=None,
                   k1_speedup=None, k1_vs_sdpa=None, k1_launches_per_replay=None,
                   k1_vs_plain_max_abs_err=None, plain_max_abs=float(ref.abs().max()))
        return row
    out = attn.fused_attention(q, k, v)
    err = float((out.float() - ref.float()).abs().max())
    if not err <= TOLERANCE[dtype_name]:
        raise AssertionError(f"K1 vs plain at T={T} D={D} {dtype_name}: max abs err {err}")
    before = trace.counter("k1.launches")
    k1 = _us(lambda: attn.fused_attention(q, k, v), reps, timings)
    # the warm-up call runs off the graph
    launches = trace.counter("k1.launches") - before - 1
    if launches != reps:
        raise AssertionError(f"K1 launched {launches} times in a graph of {reps} calls")
    plain_us = _us(lambda: plain(q, k, v), reps, timings)
    with full_fp32():
        sdpa = _us(lambda: F.scaled_dot_product_attention(q, k, v), reps, timings)
    row.update(plain_us_per_call=plain_us, k1_us_per_call=k1, sdpa_us_per_call=sdpa,
               k1_speedup=plain_us / k1, k1_vs_sdpa=sdpa / k1,
               k1_launches_per_replay=launches, k1_vs_plain_max_abs_err=err)
    return row


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16,
                    help="videos per scan batch (the bucketed batch)")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dim", type=int, nargs="+", default=[32], help="head widths D")
    ap.add_argument("--reps", type=int, default=24, help="attention calls per graph")
    ap.add_argument("--buckets", type=int, nargs="*", default=[32, 64, 128, 256, 512])
    ap.add_argument("--timings", type=int, default=3)
    ap.add_argument("--dtype", nargs="+", default=["float32"], choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"# {json.dumps(describe_card(device))}", flush=True)
    BH = args.batch * args.heads
    rows = []
    for D in args.dim:
        for dtype_name in args.dtype:
            rng = np.random.default_rng(0)
            for T in args.buckets:
                q, k, v = (torch.from_numpy(x).to(device, DTYPES[dtype_name])
                           for x in bucket_inputs(rng, BH, T, D))
                rows.append(row_for(q, k, v, dtype_name, args.reps, args.timings))
                print(json.dumps(rows[-1]), flush=True)
    timed = [r for r in rows if r["k1_speedup"] is not None]
    wins = [(r["D"], r["dtype"], r["T"]) for r in timed if r["k1_speedup"] > 1.05]
    print(json.dumps({
        "decision": ("no timing on the CPU" if not timed else
                     f"K1 beats the plain version by > 5% at (D, dtype, T) = {wins}"
                     if wins else "K1 beats the plain version nowhere"),
        "table": rows,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
