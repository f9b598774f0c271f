"""Exact inner-product top-k for duplicate search.

The `method="exact"` contract of video_fingerprint_tpu/ops/topk.py::
topk_search / topk_cosine: every query's k best corpus rows by inner
product, self-matches kept, ties broken by the lower corpus index first (as
`lax.top_k` breaks them). Queries go in tiles, so the full (M, N) score
matrix never exists at once. Scores are float32 with TF32 off: duplicate
thresholds sit at 0.95-0.99 and need errors near 1e-6, not TF32's 1e-3.

The selection modes "certified" and "certified-bf16" (the JAX `method=`
argument) are not ported yet (ROADMAP.md, module item 13).
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_fingerprint_tpu_torch.utils.precision import full_fp32

QUERY_BLOCK = 1024  # queries per score tile: 1024 x N f32 scores at a time


def _topk_low_index_ties(sims: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k largest per row, ordered by (score desc, index asc).

    torch.topk does not promise which of several equal scores it keeps, so
    the k-th score is taken from it and the set is rebuilt: every score
    above it, then the lowest-index scores equal to it.
    """
    m = sims.shape[0]
    kth = torch.topk(sims, k, dim=1).values[:, k - 1:k]
    above = sims > kth
    tied = sims == kth
    room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = above | (tied & (tied.cumsum(dim=1, dtype=torch.int32) <= room))
    idx = take.nonzero()[:, 1].view(m, k)  # ascending index within each row
    scores = sims.gather(1, idx)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return scores.gather(1, order), idx.gather(1, order)


def topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) queries x (N, D) corpus -> (scores (M, k) f32, indices (M, k) int64),
    on the queries' device."""
    if not 0 < k <= corpus.shape[0]:
        raise ValueError(f"k must be in [1, {corpus.shape[0]}], got {k}")
    queries = queries.float()
    corpus_t = corpus.float().to(queries.device).t()
    with full_fp32():
        parts = [_topk_low_index_ties(queries[lo:lo + QUERY_BLOCK] @ corpus_t, k)
                 for lo in range(0, queries.shape[0], QUERY_BLOCK)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def topk_cosine(embeddings: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-search: (N, D) embeddings -> (scores (N, k), indices (N, k))."""
    return topk_search(embeddings, embeddings, k)
