"""The production certified top-k, repairs included, checked against exact.

Port of tools/exp_topk_production.py. For each (certificate, recall
target) it times the whole call of ops/topk.py::topk_search
(`method="certified"`: the first stage, the certificate, the exact repair
of the rows that fail it) on the 10^5 self-search with planted near
duplicates, and checks the result against `method="exact"` on the host:

  - the strict certificate (no `exact_above`): each row's sorted score
    multiset equals exact's bit for bit (`strict_exact`);
  - the threshold certificate (`exact_above` = --thr): each row's
    {index: score} pairs at or above the threshold equal exact's, or at
    least their score multisets do (ties at the k-th place may swap equal
    scores' indices), everything duplicate grouping reads
    (`thr_complete`, `first_bad_row` where not).

Wall clock to a synchronised result, median of 5 after a warm call (exact:
3). The JAX tool has no certified-bf16 leg, so neither has this one.

    python -m video_fingerprint_tpu_torch.tools.exp_topk_production [--n 100000]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops.topk import topk_search
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.exp_topk_precision import bench, make_corpus
from video_fingerprint_tpu_torch.utils.device import resolve_device


def verify_strict(s: np.ndarray, s_ref: np.ndarray) -> bool:
    """Every row's sorted scores equal the exact search's, bit for bit."""
    return bool(np.array_equal(np.sort(s, axis=1), np.sort(s_ref, axis=1)))


def verify_thr(s, i, s_ref, i_ref, thr: float):
    """(ok, first bad row or -1): each row's (index, score) pairs with score
    >= thr equal the exact search's, or failing that their score multisets
    do (ties at the k-th place can swap equal-score indices). Rows whose
    pairs match slot by slot pass without the set comparison."""
    above, above_ref = s >= thr, s_ref >= thr
    same = np.all(above == above_ref, axis=1) & np.all(
        ~above_ref | ((i == i_ref) & (s == s_ref)), axis=1)
    for row in np.flatnonzero(~same):
        ref_pairs = {(int(ii), float(ss)) for ss, ii in zip(s_ref[row], i_ref[row]) if ss >= thr}
        got_pairs = {(int(ii), float(ss)) for ss, ii in zip(s[row], i[row]) if ss >= thr}
        if ref_pairs != got_pairs and (sorted(p[1] for p in ref_pairs)
                                       != sorted(p[1] for p in got_pairs)):
            return False, row
    return True, -1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--thr", type=float, default=0.95)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    e = torch.from_numpy(make_corpus(args.n, args.dim)).to(device)
    k = args.k
    results = {"n": args.n, "k": k, "thr": args.thr}

    def timed(reps, **kwargs):
        r, (s, i) = bench(lambda: topk_search(e, e, k, **kwargs), args.n, device, reps)
        return {"qps": r["qps"], "median_s": r["median_s"]}, s.cpu().numpy(), i.cpu().numpy()

    r, s_ref, i_ref = timed(3, method="exact")
    results["exact"] = r
    print(f"# exact: {r}", flush=True)
    for recall in (0.95, 0.99):
        r, s, _ = timed(5, method="certified", recall_target=recall)
        r["strict_exact"] = verify_strict(s, s_ref)
        results[f"certified_strict@r{recall}"] = r
        print(f"# certified_strict@r{recall}: {r}", flush=True)
    for recall in (0.95, 0.99):
        r, s, i = timed(5, method="certified", exact_above=args.thr,
                        recall_target=recall)
        ok, bad_row = verify_thr(s, i, s_ref, i_ref, args.thr)
        r["thr_complete"] = ok
        if not ok:
            r["first_bad_row"] = bad_row
        results[f"certified_thr@r{recall}"] = r
        print(f"# certified_thr@r{recall}: {r}", flush=True)
    print(json.dumps({**results, **describe_card(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
