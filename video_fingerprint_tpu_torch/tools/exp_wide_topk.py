"""Exact search at 10^6-wide rows, stage by stage: time and peak memory.

Port of tools/exp_wide_topk.py. The JAX tool isolated a TPU worker crash
of the full-width top-k at 10^6-wide rows, stage by stage. On the card the
same stages are measured at the same (query block, width) points: each
leg's wall ms to a synchronised result and the peak device memory it
allocated (`torch.cuda.max_memory_allocated` after a reset), with a warm
call before a timed one:

  block{256,1024}_sims     one (query block, N) f32 similarity block
                           (TF32 off), materialized;
  block{256,1024}_chunked  the same block and the column-chunked top-k
                           over it: ops/topk.py::_topk_low_index_ties per
                           chunk of CORPUS_BLOCK (65,536) columns, merged;
  exact_search_qb{256,1024}_64k  ops/topk.py::_exact_plain, the blocked
                           exact search (score blocks of query tile x
                           CORPUS_BLOCK rows; on a card the port's exact
                           search is the kernel of csrc/topk.cu), over
                           65,536 queries with a query tile of 256 or 1024
                           rows;

over a random unit corpus of 10^6 x 256 drawn on the device from seed 0
(the JAX tool draws its own with numpy; the legs do not depend on the
values).

Each leg prints and flushes its name before it starts, so a leg that
fails names itself; a leg's error ends the probe with exit 1 after
printing it. The last line gathers every leg.

    python -m video_fingerprint_tpu_torch.tools.exp_wide_topk [--n 1000000]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager

import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.exp_topk_precision import product, sync
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.precision import full_fp32

D, K = 256, 20
QUERIES = 65_536


def chunked_topk(sims: torch.Tensor, k: int):
    """Top-k of wide rows per CORPUS_BLOCK columns, merged."""
    cand_s, cand_i = [], []
    for lo in range(0, sims.shape[1], topk.CORPUS_BLOCK):
        s, i = topk._topk_low_index_ties(sims[:, lo:lo + topk.CORPUS_BLOCK],
                                         min(k, sims.shape[1] - lo))
        cand_s.append(s)
        cand_i.append(i + lo)
    return topk._merge(cand_s, cand_i, k)


@contextmanager
def query_tile(rows: int):
    """ops/topk.py's query tile set to `rows` inside the block."""
    saved = topk.QUERY_BLOCK
    topk.QUERY_BLOCK = rows
    try:
        yield
    finally:
        topk.QUERY_BLOCK = saved


def leg(out: dict, name: str, fn, device: torch.device) -> None:
    """Run fn once, announced first; record its ms and peak memory."""
    print(json.dumps({"leg": name}), flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    try:
        fn()
        sync(device)
    except Exception as exc:  # the probe's result is which leg failed and how
        print(json.dumps({name: repr(exc)[:200]}), flush=True)
        raise
    row = {"ms": (time.perf_counter() - t0) * 1e3,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                           if device.type == "cuda" else None)}
    out[name] = row
    print(json.dumps({name: row}), flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus rows (EXP_N)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"# backend={device.type} {json.dumps(describe_card(device))}", flush=True)
    out = {"n": args.n}
    leg(out, "health", lambda: torch.ones((8, 8), device=device) @ torch.ones((8, 8),
                                                                           device=device), device)
    # a random unit corpus, drawn on the device (set-up, not a leg)
    corpus = torch.randn((args.n, D), generator=torch.Generator(device).manual_seed(0),
                         device=device)
    corpus /= corpus.norm(dim=1, keepdim=True)
    for qb in (256, 1024):
        q = corpus[:qb]
        for stage, fn in (("sims", lambda: product(q, corpus, "HIGHEST")),
                          ("chunked", lambda: chunked_topk(product(q, corpus, "HIGHEST"), K))):
            leg(out, f"block{qb}_{stage}_warm", fn, device)
            leg(out, f"block{qb}_{stage}", fn, device)
    queries = corpus[:QUERIES]  # all of a corpus smaller than that
    problem = topk._Problem(queries, corpus)
    for qb in (256, 1024):
        def exact():
            with query_tile(qb), full_fp32():
                return topk._exact_plain(problem, K)

        name = f"exact_search_qb{qb}_{len(queries) // 1024}k"
        leg(out, f"{name}_warm", exact, device)
        leg(out, name, exact, device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
