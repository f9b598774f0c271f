"""The streaming validation metrics at the 10^5-embedding scale.

Port of tools/bench_streaming_metrics.py. The reference's validation
materializes the N x N similarity matrix, 40 GB at N = 100,000;
ops/metrics.py::streaming_validation_metrics computes the same metrics
(discrimination at thresholds, R@k, mAP, the tie-corrected AUC) block by
block in O(block * N) device memory. This times it on a clustered corpus
(group members share a direction plus noise), built with the JAX tool's
numpy draws in the same order, so the two tools score the same
embeddings.

The JAX tool first times `_intra_pair_sims`, its group-by-group intra-pair
similarities. The port collects those values in the first pass over the
blocks (`intra_values`); that pass is timed under the same comment line.
Then the whole metric suite, cold (`streaming_metrics_s`) and warm, each
wall-clock to the host's float results.

    python -m video_fingerprint_tpu_torch.tools.bench_streaming_metrics
        [--n 100000] [--groups 20000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import metrics as M
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils.device import resolve_device


def make_corpus(n: int, groups: int, dim: int, seed: int = 0):
    """(embeddings (n, dim) unit f32, ids (n,) int32): the JAX tool's draws."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((groups, dim)).astype(np.float32)
    ids = rng.integers(0, groups, (n,)).astype(np.int32)
    emb = centers[ids] + 0.35 * rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, ids


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--groups", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    card = describe_card(device)
    emb, ids = make_corpus(args.n, args.groups, args.dim)
    print(f"# backend={device.type} n={args.n} groups={args.groups} block={args.block} "
          f"{json.dumps(card)}", flush=True)

    e_dev, ids_dev = torch.from_numpy(emb).to(device), torch.from_numpy(ids).to(device)
    intra, dt = _timed(lambda: M.intra_values(e_dev, ids_dev, args.block), device)
    print(f"# intra_pair_sims: {dt:.1f}s ({intra.shape[0]} pairs)", flush=True)
    del e_dev, ids_dev, intra

    run = lambda: M.streaming_validation_metrics(  # noqa: E731
        emb, ids, block_rows=args.block, device=device)
    m, cold = _timed(run, device)
    _, warm = _timed(run, device)
    print(f"# warm second run: {warm:.2f}s (first {cold:.2f}s)", flush=True)
    print(json.dumps({
        "streaming_metrics_n": args.n,
        "streaming_metrics_s": cold,
        "streaming_metrics_warm_s": warm,
        "auc_roc": m["auc_roc"],
        "R@1": m["R@1"],
        "mAP": m["mAP"],
        "separation_gap": m["separation_gap"],
        "block_rows": args.block,
        "device_mem_per_block_mb": args.block * args.n * 4 / 1e6,
        "dense_equivalent_mb": args.n * args.n * 4 / 1e6,
        "device": card["device"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
