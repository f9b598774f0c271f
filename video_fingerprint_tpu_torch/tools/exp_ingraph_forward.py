"""In-graph forward throughput: K forwards in one CUDA graph against K
forwards dispatched back to back.

Port of tools/exp_ingraph_forward.py. The JAX probe puts K forwards inside
one program (a `lax.fori_loop`, the input picked per iteration, a scalar
sum read back) to see whether the headline's pipelined dispatch pays a
per-dispatch tax. Here the program is a CUDA graph:

  ingraph    one graph of K forwards over the N_STAGED staged batches in
             turn (forward i reads batch i % 2), each adding the f32 sum of
             its embeddings to a scalar; replayed once untimed, then once
             per rep, each replay timed by CUDA events (device time)
  pipelined  K eager forwards queued back to back, then one wait (host
             clock), the headline's pipelined regime

Workload: the benchmark headline's model (`bench_headline.fused_model`:
the seeded full-width attention model, BatchNorm folded, bf16, the spatial
encoder channels-last) on B = 512 videos x T = 128 seeded 64x64 uint8
frames, `forward_flat`. The two batches (805 MB each) are staged once and
serve both legs (JAX stacks a third copy for its dynamic index; a graph
can name each batch directly).

The JAX tool's environment variables: EXP_B (512), EXP_T (128), EXP_K
forwards per graph (12), EXP_REPS (3). With --device cpu (for the tests)
the in-graph leg runs its K forwards eagerly (no graph: it needs a card),
and both legs are timed by the host clock, not a device time.

    python -m video_fingerprint_tpu_torch.tools.exp_ingraph_forward [--device cuda|cpu]

Prints a comment line, then {"ingraph": videos/s, "reps_s": [...]}, then
the result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.bench_headline import fused_model
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.timing import capture_graph, replay_ms

HW = 64
N_STAGED = 2
SEED = 0


def staged_batches(seed: int, batch: int, frames: int, device: torch.device):
    """N_STAGED seeded (batch * frames, 64, 64, 3) uint8 batches on device
    (the JAX probe's numpy draws)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, (batch * frames, HW, HW, 3),
                                          dtype=np.uint8)).to(device)
            for _ in range(N_STAGED)]


def ingraph_loop(model, staged, batch: int, k: int):
    """(acc, run): run() makes k forwards, forward i on staged[i % 2],
    adding the f32 sum of its embeddings to the scalar acc."""
    acc = torch.zeros((), dtype=torch.float32, device=staged[0].device)

    def run():
        for i in range(k):
            acc.add_(model.forward_flat(staged[i % N_STAGED], batch).sum(dtype=torch.float32))
    return acc, run


def ingraph_sum(model, staged, batch: int, k: int) -> float:
    """The in-graph leg's scalar after one run: on a card one replay of the
    captured graph (after the capture's warm-up run), on the CPU the loop."""
    acc, run = ingraph_loop(model, staged, batch, k)
    if staged[0].is_cuda:
        graph = capture_graph(run, 1)
        acc.zero_()
        graph.replay()
    else:
        run()
    return float(acc)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    B = int(os.environ.get("EXP_B", 512))
    T = int(os.environ.get("EXP_T", 128))
    K = int(os.environ.get("EXP_K", 12))
    reps = int(os.environ.get("EXP_REPS", 3))
    cuda = device.type == "cuda"
    print(f"# {json.dumps({'B': B, 'T': T, 'K': K, **describe_card(device)})}", flush=True)
    model = fused_model(SEED, device, torch.bfloat16)
    staged = staged_batches(SEED, B, T, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    results = {}
    with torch.no_grad():
        acc, run = ingraph_loop(model, staged, B, K)
        if cuda:  # the capture's warm-up run builds and warms; replay_ms replays once more
            ts = [ms * K / 1e3 for ms in replay_ms(capture_graph(run, 1), K, timings=reps)]
        else:
            run()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(acc)):
            raise FloatingPointError(f"non-finite in-graph sum {acc}")
        in_t = statistics.median(ts) / K
        results["ingraph_ms_per_batch"] = in_t * 1e3
        results["ingraph_vps"] = B / in_t
        print(json.dumps({"ingraph": results["ingraph_vps"], "reps_s": ts}), flush=True)

        model.forward_flat(staged[0], B)  # warm
        sync()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            outs = [model.forward_flat(staged[i % N_STAGED], B) for i in range(K)]
            sync()
            ts.append(time.perf_counter() - t0)
        del outs
        pipe_t = statistics.median(ts) / K
        results["pipelined_ms_per_batch"] = pipe_t * 1e3
        results["pipelined_vps"] = B / pipe_t
        results["ingraph_over_pipelined"] = pipe_t / in_t
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
