"""Exact inner-product top-k for duplicate search and the fingerprint index.

The `method="exact"` contract of video_fingerprint_tpu/ops/topk.py::
topk_search / topk_cosine: every query's k best corpus rows by inner
product, self-matches kept, ties broken by the lower corpus index first (as
`lax.top_k` breaks them). The search is complete at every score, so it is
also complete above any `exact_above` threshold: the argument is accepted
for the JAX signature and needs no work here.

Queries go in tiles of QUERY_BLOCK and the corpus in blocks of CORPUS_BLOCK
rows, so one score block holds 1024 x 65,536 f32 (256 MiB) whatever the
corpus size; each block's top-k is merged into the tile's. Scores are
float32 with TF32 off: duplicate thresholds sit at 0.95-0.99 and need
errors near 1e-6, not TF32's 1e-3.

A bfloat16 corpus (the index's bf16 storage, `stage_corpus`) stays bf16 on
the device; each block is upcast to f32 (exact for bf16 values) just before
its matmul. Queries are rounded to bf16 first, and sims are rescaled by
exact f32 reciprocal row norms of both sides (`_row_rnorm`), so reported
scores are true cosines of the stored vectors and byte-identical rows score
1.0 to within an f32 rounding (JAX ops/topk.py:224-273).

The selection modes "certified" and "certified-bf16" (the JAX `method=`
argument) are not ported (ROADMAP.md, module item 13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from video_fingerprint_tpu_torch.utils.precision import full_fp32

QUERY_BLOCK = 1024  # queries per tile
CORPUS_BLOCK = 1 << 16  # corpus rows per score block


def _order(scores: torch.Tensor, idx: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of each row by (score desc, index asc)."""
    by_index = torch.sort(idx, dim=1).indices
    scores, idx = scores.gather(1, by_index), idx.gather(1, by_index)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return scores.gather(1, order), idx.gather(1, order)


def _topk_low_index_ties(sims: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k largest per row, ordered by (score desc, index asc).

    torch.topk does not promise which of several equal scores it keeps.
    Where the k-th score also occurs outside its pick, the row's set is
    rebuilt from the full row: every score above the k-th, then the
    lowest-index scores equal to it.
    """
    scores, idx = torch.topk(sims, k, dim=1)
    kth = scores[:, k - 1:k]
    split = (sims == kth).sum(dim=1) > (scores == kth).sum(dim=1)
    rows = split.nonzero()[:, 0]
    if len(rows):
        part, cut = sims[rows], kth[rows]
        above = part > cut
        tied = part == cut
        room = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
        take = above | (tied & (tied.cumsum(dim=1, dtype=torch.int32) <= room))
        fixed = take.nonzero()[:, 1].view(len(rows), k)
        scores[rows], idx[rows] = part.gather(1, fixed), fixed
    return _order(scores, idx, k)


def _row_rnorm(x: torch.Tensor) -> torch.Tensor:
    """1/||row|| in f32 from the rows' values (a bf16 row is upcast block by
    block; its products are exact in f32), 0 for a zero row."""
    parts = []
    for lo in range(0, x.shape[0], CORPUS_BLOCK):
        block = x[lo:lo + CORPUS_BLOCK].float()
        norm2 = (block * block).sum(dim=1)
        parts.append(torch.where(norm2 > 0, torch.rsqrt(norm2), torch.zeros_like(norm2)))
    return torch.cat(parts) if parts else x.new_zeros((0,), dtype=torch.float32)


def stage_corpus(corpus, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An (N, D) corpus on `device`, uploaded once for repeated searches
    (the counterpart of JAX `stage_padded_corpus`; nothing is compiled per
    size here, so nothing is padded). dtype=torch.bfloat16 rounds on the
    host (to nearest even, as ml_dtypes does) before the copy, which halves
    both the copy and the device memory."""
    host = torch.from_numpy(np.ascontiguousarray(corpus, dtype=np.float32))
    return host.to(dtype).to(device)


def topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                exact_above: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) queries x (N, D) corpus -> (scores (M, k) f32, indices (M, k)
    int64), on the queries' device. A bf16 corpus is searched in the cosine
    domain of its stored rows (module docstring). `exact_above` is accepted
    and ignored: the search is exact at every score."""
    del exact_above  # complete above any threshold already
    n = corpus.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    corpus = corpus.to(queries.device)
    cosine = corpus.dtype == torch.bfloat16
    queries = queries.to(torch.bfloat16).float() if cosine else queries.float()
    if cosine:
        corpus_rnorm, query_rnorm = _row_rnorm(corpus), _row_rnorm(queries)
    out_s, out_i = [], []
    with full_fp32():
        for qlo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[qlo:qlo + QUERY_BLOCK]
            cand_s, cand_i = [], []
            for clo in range(0, n, CORPUS_BLOCK):
                block = corpus[clo:clo + CORPUS_BLOCK]
                sims = q @ block.float().t()
                if cosine:
                    sims = (sims * corpus_rnorm[None, clo:clo + CORPUS_BLOCK]
                            * query_rnorm[qlo:qlo + QUERY_BLOCK, None])
                s, i = _topk_low_index_ties(sims, min(k, block.shape[0]))
                cand_s.append(s)
                cand_i.append(i + clo)
            s, i = ((cand_s[0], cand_i[0]) if len(cand_s) == 1 else
                    _order(torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1), k))
            out_s.append(s)
            out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def topk_cosine(embeddings: torch.Tensor, k: int, exact_above: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-search: (N, D) embeddings -> (scores (N, k), indices (N, k))."""
    return topk_search(embeddings, embeddings, k, exact_above)
