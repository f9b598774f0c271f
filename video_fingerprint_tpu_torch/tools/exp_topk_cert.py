"""Approximate top-k with an exactness certificate, per recall target.

Port of tools/exp_topk_cert.py. The approximate stage
(ops/topk.py::_approx_topk, approx_max_k's PartialReduce) recovers
exactness through a per-row certificate computed from the same similarity
block (ops/topk.py::_certificate, strict form):

    s, i = approx(sims, k); s_k = s[:, k-1]
    ok = count(sims > s_k) == count(s > s_k)

If ok, the returned score multiset is the exact top-k: every element above
s_k is accounted for, and the rest are ties at s_k. Rows that fail would be
recomputed by the exact search; that pays only if few fail, and the failure
share moves with the recall target.

Per recall target (0.95, 0.99, 0.999): the certified first stage's time
(approx + certificate over query blocks of `--query_block`, f32 with TF32
off), the share of rows and of query blocks that fail, whether every
certified row's sorted scores equal the exact search's bit for bit, and
the rate with the failed blocks re-run exact (an upper bound, as in JAX).
Wall clock to a synchronised result, median of 5 after a warm call
(exact: 3).

    python -m video_fingerprint_tpu_torch.tools.exp_topk_cert [--n 100000]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.exp_topk_blocked import per_block, single
from video_fingerprint_tpu_torch.tools.exp_topk_precision import bench, make_corpus
from video_fingerprint_tpu_torch.utils.device import resolve_device

RECALLS = (0.95, 0.99, 0.999)


def certify(sims: torch.Tensor, scores: torch.Tensor, k: int) -> torch.Tensor:
    """(rows,) bool: `scores`, elements of `sims`, are provably each row's
    exact top-k score multiset (the strict certificate)."""
    return topk._certificate(sims, scores, k, None, False, 0.0)


def certified(sims: torch.Tensor, k: int, recall: float):
    s, i = topk._approx_topk(sims, k, recall)
    return s, i, certify(sims, s, k)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--query_block", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    e = torch.from_numpy(make_corpus(args.n, args.dim)).to(device)
    Q, k = args.query_block, args.k
    results = {}
    r, ref = bench(lambda: per_block(lambda s: single(s, k), e, e, Q), args.n, device,
                   reps=3)
    results["exact_warmup_s"] = r.pop("warmup_s")
    results["exact"] = r
    print(f"# exact: {results['exact']}", flush=True)
    s_ref = ref[0].cpu().numpy()

    for recall in RECALLS:
        r, out = bench(lambda: per_block(lambda s: certified(s, k, recall), e, e, Q),
                       args.n, device)
        s, ok = out[0].cpu().numpy(), out[2].cpu().numpy()
        good = np.flatnonzero(ok)
        # certified rows must hold the exact score multiset bit for bit
        r["cert_rows_exact"] = bool(np.array_equal(np.sort(s[good], axis=1),
                                                   np.sort(s_ref[good], axis=1)))
        r["cert_fail_frac"] = float(1.0 - ok.mean())
        r["cert_fail_rows"] = int((~ok).sum())
        # the re-run's granularity is the query block: an upper bound with
        # the exact time weighted by the share of blocks that failed
        blocks_failed = np.unique(np.flatnonzero(~ok) // Q).size
        n_blocks = -(-args.n // Q)
        r["blocks_failed"] = int(blocks_failed)
        eff_s = r["median_s"] + results["exact"]["median_s"] * blocks_failed / n_blocks
        r["effective_qps_with_rerun"] = args.n / eff_s
        results[f"certified@{recall}"] = r
        print(f"# certified@{recall}: {r}", flush=True)
    print(json.dumps({"n": args.n, "k": k, **results, **describe_card(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
