"""Top-k algorithms for the dedup search: the floor, full width, blocked, approximate.

Port of tools/exp_topk_blocked.py. On query blocks of `--query_block` rows
against the whole corpus (one (Q, N) similarity block each, f32 with TF32
off, the precision of ops/topk.py) it times:

  a) matmul + row max only: the floor, no top-k at all;
  b) the full-width top-k: ops/topk.py::_topk_low_index_ties on each block
     (torch.topk, ties to the lower index);
  c) the blocked exact two-stage: the top-k of each column tile of
     `--tile`, then the top-k of the n_tiles·k tile winners. Exact: every
     element of the global top-k is in its tile's top-k; it must equal (b),
     indices included;
  d) the approximate stage ops/topk.py::_approx_topk (approx_max_k's
     PartialReduce, recall target 0.95), with its measured recall.

Each is timed on the wall clock to a synchronised result, median of 5
after a warm call (the JAX tool's methodology).

    python -m video_fingerprint_tpu_torch.tools.exp_topk_blocked [--n 100000]
        [--tile 2048] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.exp_topk_precision import (
    bench,
    index_agreement,
    make_corpus,
    product,
)
from video_fingerprint_tpu_torch.utils.device import resolve_device


def per_block(fn, queries: torch.Tensor, corpus: torch.Tensor, block: int):
    """fn(sims) over the query blocks' (Q, N) similarities, results
    concatenated along the queries."""
    parts = [fn(product(queries[lo:lo + block], corpus, "HIGHEST"))
             for lo in range(0, queries.shape[0], block)]
    return tuple(torch.cat(p) for p in zip(*parts))


def maxonly(sims: torch.Tensor):
    return sims.max(dim=1)


def single(sims: torch.Tensor, k: int):
    return topk._topk_low_index_ties(sims, k)


def blocked(sims: torch.Tensor, k: int, tile: int):
    """The exact two-stage: per-tile top-k, then the top-k of the winners by
    (score desc, index asc). Columns past N pad the last tile with -inf."""
    q, n = sims.shape
    n_tiles = -(-n // tile)
    if n_tiles * tile != n:
        sims = torch.nn.functional.pad(sims, (0, n_tiles * tile - n), value=-math.inf)
    s1, i1 = topk._topk_low_index_ties(sims.reshape(q * n_tiles, tile), min(k, tile))
    cols = i1.reshape(q, n_tiles, -1) + (torch.arange(n_tiles, device=sims.device)
                                         * tile)[None, :, None]
    return topk._order(s1.reshape(q, -1), cols.reshape(q, -1), k)


def approx(sims: torch.Tensor, k: int, recall: float = 0.95):
    return topk._approx_topk(sims, k, recall)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--query_block", type=int, default=1024)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    e = torch.from_numpy(make_corpus(args.n, args.dim)).to(device)
    Q, k = args.query_block, args.k
    run = lambda fn: bench(lambda: per_block(fn, e, e, Q), args.n, device)  # noqa: E731
    results = {}
    results["maxonly"], _ = run(maxonly)
    results["single_topk"], ref = run(lambda s: single(s, k))
    results["blocked_exact"], blk = run(lambda s: blocked(s, k, args.tile))
    results["approx_0.95"], apx = run(lambda s: approx(s, k, 0.95))
    for name in ("maxonly", "single_topk", "blocked_exact", "approx_0.95"):
        print(f"# {name}: {results[name]}", flush=True)

    s_ref, i_ref = (t.cpu().numpy() for t in ref)
    s_blk, i_blk = (t.cpu().numpy() for t in blk)
    results["blocked_max_score_delta"] = float(np.max(np.abs(s_blk - s_ref)))
    results["blocked_index_agreement"] = index_agreement(i_blk, i_ref, k)
    results["blocked_equals_exact"] = bool((i_blk == i_ref).all() and (s_blk == s_ref).all())
    results["approx_recall_measured"] = index_agreement(apx[1].cpu().numpy(), i_ref, k)
    print(json.dumps({"n": args.n, "k": k, "tile": args.tile, **results,
                      **describe_card(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
