"""Matmul precision for the dedup top-k: speed and accuracy of three products.

Port of tools/exp_topk_precision.py. The similarity matmul of the 100k
self-search is timed and scored at three precisions, which on the card are
three products (`PRECISIONS`):

  HIGHEST  f32 inputs, f32 products and sums, TF32 off (utils/precision.py::
           full_fp32, what ops/topk.py runs);
  HIGH     f32 inputs through TF32 tensor cores (10-bit mantissa products);
  DEFAULT  bf16-rounded inputs, f32 accumulation and an f32 result.

This probe owns its products: ops/topk.py::topk_search has no precision
argument, and what the scanner and the index compute stays full f32. Each
precision runs the exact search of ops/topk.py (query tiles of QUERY_BLOCK,
corpus blocks of CORPUS_BLOCK, the per-block top-k with ties to the lower
index, the merge) on its own product, timed on the wall clock to a
synchronised result, median of 5 after a warm call (the JAX tool's
methodology). Accuracy against HIGHEST: the largest |score difference| over
every returned score, the top-k index agreement on 2,000 sampled rows, and
the duplicate-pair decisions that flip at 0.95 and 0.99, on a corpus with
planted near-duplicate clusters (`make_corpus`, bit-equal to the JAX
tool's).

    python -m video_fingerprint_tpu_torch.tools.exp_topk_precision [--n 100000]
        [--device cuda|cpu]

The other top-k probes import `make_corpus`, `bench` and `product` from here.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.precision import full_fp32

PRECISIONS = {
    "HIGHEST": "f32 inputs and products, TF32 off",
    "HIGH": "f32 inputs through TF32 tensor cores",
    "DEFAULT": "bf16-rounded inputs, f32 accumulation, f32 result",
}


def make_corpus(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """Unit-norm embeddings with ~10% of rows in planted near-dup clusters:
    a base vector plus noise scaled to land cosine sims around 0.93-0.995,
    straddling both reference thresholds (the JAX tool's draws)."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, dim)).astype(np.float32)
    n_clusters = max(1, n // 40)
    rows = n // 10
    base = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    which = rng.integers(0, n_clusters, size=rows)
    # cos ~ 1/sqrt(1+s^2) for unit base + s*unit noise: s in [0.1, 0.4]
    s = rng.uniform(0.1, 0.4, size=rows).astype(np.float32)[:, None]
    e[:rows] = base[which] + s * rng.normal(size=(rows, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(fn, n: int, device: torch.device, reps: int = 5):
    """({qps, median_s, warmup_s}, the last result): fn() on the wall clock
    to a synchronised result, median of `reps` after one warm call."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    warm = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return {"qps": n / dt, "median_s": dt, "warmup_s": warm}, out


@contextmanager
def _tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def product(q: torch.Tensor, c: torch.Tensor, precision: str,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q @ c.T at `precision` (PRECISIONS). DEFAULT may store its result in
    bf16 (`out_dtype`); its f32 result on the card is one bf16 GEMM with an
    f32 output, on the CPU the same value from the bf16-rounded inputs
    upcast (their products are exact in f32)."""
    if precision == "HIGH":
        with _tf32():
            return q @ c.t()
    if precision == "HIGHEST":
        with full_fp32():
            return q @ c.t()
    qb, cb = q.to(torch.bfloat16), c.to(torch.bfloat16)
    with topk._bf16_f32_reduction():
        if out_dtype == torch.bfloat16:
            return qb @ cb.t()
        if q.is_cuda:
            return torch.mm(qb, cb.t(), out_dtype=torch.float32)
    with full_fp32():
        return qb.float() @ cb.float().t()


def exact_search(queries: torch.Tensor, corpus: torch.Tensor, k: int, precision: str):
    """ops/topk.py's exact search (query tiles x corpus blocks, per-block
    top-k with ties to the lower index, merged) over `precision`'s product."""
    n = corpus.shape[0]
    out_s, out_i = [], []
    for qlo in range(0, queries.shape[0], topk.QUERY_BLOCK):
        q = queries[qlo:qlo + topk.QUERY_BLOCK]
        cand_s, cand_i = [], []
        for clo in range(0, n, topk.CORPUS_BLOCK):
            sims = product(q, corpus[clo:clo + topk.CORPUS_BLOCK], precision)
            s, i = topk._topk_low_index_ties(sims, min(k, sims.shape[1]))
            cand_s.append(s)
            cand_i.append(i + clo)
        s, i = topk._merge(cand_s, cand_i, k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def index_agreement(i_x: np.ndarray, i_ref: np.ndarray, k: int) -> float:
    """Mean share of the reference's top-k indices found, over ~2,000 rows."""
    n = i_ref.shape[0]
    return float(np.mean([len(np.intersect1d(i_x[r], i_ref[r])) / k
                          for r in range(0, n, max(1, n // 2000))]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    e = torch.from_numpy(make_corpus(args.n, args.dim)).to(device)
    results, out = {}, {}
    for name in PRECISIONS:
        r, (s, i) = bench(lambda: exact_search(e, e, args.k, name), args.n, device)
        out[name] = (s.cpu().numpy(), i.cpu().numpy())
        results[name] = r
        print(f"# {name}: {r}", flush=True)
    s_ref, i_ref = out["HIGHEST"]
    for name in ("HIGH", "DEFAULT"):
        s_x, i_x = out[name]
        results[name]["max_abs_score_delta"] = float(np.max(np.abs(s_x - s_ref)))
        results[name]["topk_index_agreement"] = index_agreement(i_x, i_ref, args.k)
        for thr in (0.95, 0.99):
            # duplicate-pair decisions: (query, neighbour) pairs above thr
            results[name][f"decision_mismatch@{thr}"] = int(np.sum((s_x >= thr) != (s_ref >= thr)))
    print(json.dumps({"n": args.n, "k": args.k, "dim": args.dim, **results,
                      "precisions": PRECISIONS, **describe_card(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
