"""Inner-product top-k for duplicate search and the fingerprint index.

The contracts of video_fingerprint_tpu/ops/topk.py::topk_search /
topk_cosine. Self-matches are kept, and the result holds, per `method`:

  - "exact": every query's k best corpus rows by inner product, ties
    broken by the lower corpus index first (as `lax.top_k` breaks them).
    It is complete at every score, so also above any `exact_above`.
  - "certified": an approximate first stage with a per-row exactness
    certificate, and the rows that fail it recomputed by the exact path.
    Without `exact_above` (the strict certificate) the result is each
    row's exact top-k score multiset; with it (the threshold certificate)
    every corpus row scoring >= exact_above is among the k returned, or the
    row's k are its exact top-k.
  - "certified-bf16": the threshold certificate over similarities from
    bf16-rounded operands stored in bf16, widened by the bf16 error bound,
    with each block's k candidates re-scored in f32 before the blocks merge
    (so the merge orders true scores) and before the repairs land.
    Requires `exact_above`.
  - "auto": "exact" on every device of the port. The JAX package picks a
    certified method on a TPU only, where approx_max_k runs on the
    PartialReduce unit; whether one pays on a GPU is for its measured
    times to show (chip_smoke.py, phase `index`).

The approximate first stage has `jax.lax.approx_max_k`'s meaning, the
PartialReduce algorithm of Chern et al., "TPU-KNN: K Nearest Neighbor
Search at Peak FLOP/s" (NeurIPS 2022): split each row into L bins (column j
in bin j mod L), keep each bin's maximum, take the exact top-k of the bin
maxima. L is XLA's choice for k and `recall_target` (`approx_bins`); the
default target is 0.99 for the strict certificate and 0.95 with a
threshold.

Queries go in tiles of QUERY_BLOCK and the corpus in blocks of CORPUS_BLOCK
rows, so one score block holds 1024 x 65,536 scores whatever the corpus
size; each block's top-k is merged into the tile's. The certified methods
certify each (tile, block) pair and a row only when every block
certified it. Scores are float32 with TF32 off: duplicate thresholds sit at
0.95-0.99 and need errors near 1e-6, not TF32's 1e-3.

A bfloat16 corpus (the index's bf16 storage, `stage_corpus`) stays bf16 on
the device; each block is upcast to f32 (exact for bf16 values) just before
its matmul. Queries are rounded to bf16 first, and sims are rescaled by
exact f32 reciprocal row norms of both sides (`_row_rnorm`), so reported
scores are true cosines of the stored vectors and byte-identical rows score
1.0 to within an f32 rounding (JAX ops/topk.py:224-273).

`repaired_rows` counts the rows the certified methods sent to the exact
repair since import.

`sharded_topk_search` and the ring `sharded_topk_cosine` run the same
searches over a corpus row-sharded across a device list
(`stage_sharded_corpus`; JAX ops/topk.py:875-1164), each shard's work being
the single-device search on its device, and across the ranks of a
torch.distributed process group, every rank holding one block of the
corpus and returning the same result (JAX's multi-process mesh).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch

from video_fingerprint_tpu_torch.parallel.distributed import (
    all_gather_stack,
    all_ranks_true,
    ring_shift,
)
from video_fingerprint_tpu_torch.utils.precision import full_fp32

QUERY_BLOCK = 1024  # queries per tile
CORPUS_BLOCK = 1 << 16  # corpus rows per score block
METHODS = ("auto", "exact", "certified", "certified-bf16")
# approx_max_k's reduction keeps at least this many bins (XLA's TPU tiling)
_MIN_BINS = 128

# Error bound of sims from bf16-rounded unit-norm operands, f32 accumulation,
# stored as bf16, against the f32 inner product (JAX ops/topk.py:172-190):
# 2 * 2^-8 + 2^-16 for the inputs' rounding, < 1e-5 accumulation over D <=
# 1024, 2^-9 for the stored value; 0.0099 in all, widened to 0.0105.
_BF16_DOT_EPS = 0.0105
# The same for a bf16-stored corpus, whose operands are exact: accumulation,
# the norm rescale and the stored value's 2^-9; 0.0021, widened to 0.003
# (JAX ops/topk.py:192-205).
_BF16_STORE_EPS = 0.003

repaired_rows = 0


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


def approx_bins(n: int, k: int, recall: float) -> int:
    """L, the number of bins approx_max_k reduces a row of n to for top-k at
    `recall` (XLA's ApproxTopKReductionOutputSize): with M bins a true
    top-k element collides with none of the other k - 1 with probability
    ((M - 1) / M)^(k - 1); solving for `recall` gives M = (k - 1) /
    ln(1 / recall), at least 128. Each bin spans a window of W columns, W
    the largest power of two within n / M, and L is n / W rounded up to a
    multiple of 128. n (no reduction) when W is 1. For k = 1 the maximum of
    the maxima is exact at any L: 128 bins."""
    if k == 1:
        return min(n, _MIN_BINS)
    if recall >= 1.0:
        return n
    m = min(max(int((1.0 - k) / math.log(recall)), _MIN_BINS), n)
    log2_window = (n // m).bit_length() - 1
    if log2_window <= 0:
        return n
    return -(-n // (_MIN_BINS << log2_window)) * _MIN_BINS


def _approx_topk(sims: torch.Tensor, k: int, recall: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """approx_max_k's PartialReduce on each row: the maximum of every bin
    (columns j with the same j mod L), then the exact top-k of the L
    maxima, sorted descending. The scores are elements of `sims`."""
    rows, n = sims.shape
    bins = approx_bins(n, k, recall)
    if bins >= n or bins < k:
        return torch.topk(sims, k, dim=1)
    window = -(-n // bins)
    if window * bins != n:  # pad the row with -inf to window * bins columns
        sims = torch.nn.functional.pad(sims, (0, window * bins - n), value=-math.inf)
    maxima, pos_in_bin = sims.view(rows, window, bins).max(dim=1)
    scores, bin_idx = torch.topk(maxima, k, dim=1)
    return scores, pos_in_bin.gather(1, bin_idx) * bins + bin_idx


def _certificate(sims: torch.Tensor, scores: torch.Tensor, k: int, thr: Optional[float],
                 lowp: bool, eps: float) -> torch.Tensor:
    """(rows,) bool: the approximate `scores` of this block are provably its
    exact top-k score multiset (strict: thr None), or hold every element
    >= thr (threshold), as JAX ops/topk.py::_tile_topk. The returned scores
    are elements of `sims`, so the counts compare the same values.

    strict: count(sims > s_k) == count(scores > s_k), s_k the k-th score.
    threshold: count(sims >= thr) == count(scores >= thr), and either fewer
    than k elements reach thr or the strict certificate holds.
    lowp (bf16 sims): the threshold lowered by eps; a bf16 tensor against a
    Python float compares on the bf16 grid, where no grid point lies
    between thr - eps and its rounding, so the set is that of the exact
    comparison. Rows with k or more such elements fail (a strict
    certificate cannot be read from noisy scores)."""
    if lowp:
        cut = thr - eps
        n_thr = (sims >= cut).sum(dim=1)
        return (n_thr == (scores >= cut).sum(dim=1)) & (n_thr < k)
    s_k = scores[:, k - 1:k]
    strict = (sims > s_k).sum(dim=1) == (scores > s_k).sum(dim=1)
    if thr is None:
        return strict
    n_thr = (sims >= thr).sum(dim=1)
    return (n_thr == (scores >= thr).sum(dim=1)) & ((n_thr < k) | strict)


@contextmanager
def _bf16_f32_reduction():
    """cuBLAS bf16 matmuls accumulate in f32 inside the block: the error
    bound of the bf16 first pass assumes it."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved


class _Problem:
    """Queries and corpus of one search on one device, with what the score
    blocks need: queries rounded to bf16 and both sides' exact reciprocal
    norms when the corpus is bf16 (the cosine domain)."""

    def __init__(self, queries: torch.Tensor, corpus: torch.Tensor):
        self.corpus = corpus.to(queries.device)
        self.cosine = self.corpus.dtype == torch.bfloat16
        self.queries = (queries.to(torch.bfloat16).float() if self.cosine
                        else queries.float())
        if self.cosine:
            self.corpus_rnorm = _row_rnorm(self.corpus)
            self.query_rnorm = _row_rnorm(self.queries)

    def rows(self, index: torch.Tensor) -> "_Problem":
        """The same corpus against the queries at `index`."""
        sub = object.__new__(_Problem)
        sub.corpus, sub.cosine = self.corpus, self.cosine
        sub.queries = self.queries[index]
        if self.cosine:
            sub.corpus_rnorm, sub.query_rnorm = self.corpus_rnorm, self.query_rnorm[index]
        return sub

    def sims(self, qlo: int, clo: int) -> torch.Tensor:
        """f32 scores of the query tile at qlo against the corpus block at clo."""
        q = self.queries[qlo:qlo + QUERY_BLOCK]
        block = self.corpus[clo:clo + CORPUS_BLOCK]
        sims = q @ block.float().t()
        if self.cosine:
            sims = (sims * self.corpus_rnorm[None, clo:clo + CORPUS_BLOCK]
                    * self.query_rnorm[qlo:qlo + QUERY_BLOCK, None])
        return sims

    def sims_bf16(self, qlo: int, clo: int) -> torch.Tensor:
        """bf16 scores for the certified-bf16 first pass: a bf16 product of
        the bf16-rounded operands with f32 accumulation, or for a bf16
        corpus the f32 cosine rounded to bf16 (its operands are exact)."""
        if self.cosine:
            return self.sims(qlo, clo).to(torch.bfloat16)
        q = self.queries[qlo:qlo + QUERY_BLOCK].to(torch.bfloat16)
        with _bf16_f32_reduction():
            return q @ self.corpus[clo:clo + CORPUS_BLOCK].to(torch.bfloat16).t()


def _merge(cand_s, cand_i, k):
    if len(cand_s) == 1:
        return cand_s[0], cand_i[0]
    return _order(torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1), k)


def _exact(p: _Problem, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = p.corpus.shape[0]
    out_s, out_i = [], []
    for qlo in range(0, p.queries.shape[0], QUERY_BLOCK):
        cand_s, cand_i = [], []
        for clo in range(0, n, CORPUS_BLOCK):
            s, i = _topk_low_index_ties(p.sims(qlo, clo), min(k, CORPUS_BLOCK, n - clo))
            cand_s.append(s)
            cand_i.append(i + clo)
        s, i = _merge(cand_s, cand_i, k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


def _certified(p: _Problem, k: int, recall: float, thr: Optional[float], lowp: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The approximate first stage per (tile, block) with its certificate:
    (scores, indices, ok) where ok is the AND over the blocks."""
    n = p.corpus.shape[0]
    eps = _BF16_STORE_EPS if p.cosine else _BF16_DOT_EPS
    out_s, out_i, out_ok = [], [], []
    for qlo in range(0, p.queries.shape[0], QUERY_BLOCK):
        cand_s, cand_i, ok = [], [], None
        for clo in range(0, n, CORPUS_BLOCK):
            sims = p.sims_bf16(qlo, clo) if lowp else p.sims(qlo, clo)
            kk = min(k, CORPUS_BLOCK, n - clo)
            s, i = _approx_topk(sims, kk, recall)
            block_ok = _certificate(sims, s, kk, thr, lowp, eps)
            ok = block_ok if ok is None else ok & block_ok
            if lowp:  # f32 scores before the blocks merge, so the merge is exact
                s, i = _rescore(p, s.float(), i + clo, qlo)
            else:
                i = i + clo
            cand_s.append(s)
            cand_i.append(i)
        s, i = _merge(cand_s, cand_i, k)
        out_s.append(s)
        out_i.append(i)
        out_ok.append(ok)
    return torch.cat(out_s), torch.cat(out_i), torch.cat(out_ok)


def _rescore(p: _Problem, scores: torch.Tensor, idx: torch.Tensor, qlo: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score the (M, k) candidates of the M queries from qlo on in f32
    (TF32 off) and re-sort each row by (score desc, index asc); slots
    holding -inf stay -inf. A bf16 corpus scores in the cosine domain of
    the bf16-rounded queries, as the certificate and the exact repairs do
    (JAX ops/topk.py:375-422)."""
    rows = slice(qlo, qlo + idx.shape[0])
    cand = p.corpus[idx].float()  # (M, k, D): only the candidates upcast
    hi = torch.einsum("md,mkd->mk", p.queries[rows], cand)
    if p.cosine:
        cn2 = (cand * cand).sum(dim=-1)
        crn = torch.where(cn2 > 0, torch.rsqrt(cn2), torch.zeros_like(cn2))
        hi = hi * crn * p.query_rnorm[rows, None]
    hi = torch.where(torch.isneginf(scores), -math.inf, hi)
    return _order(hi, idx, idx.shape[1])


def _resolve_method(k: int, n: int, method: str, exact_above: Optional[float],
                    recall_target: Optional[float]) -> Tuple[str, float]:
    """The method to run ("auto" is "exact") and the recall target, after
    the checks every search makes."""
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    if method not in METHODS:
        raise ValueError(f"unknown top-k method {method!r}")
    if method == "auto":
        method = "exact"
    if method == "certified-bf16" and exact_above is None:
        raise ValueError(
            "method='certified-bf16' needs exact_above: the widened "
            "certificate is threshold-only (strict exactness cannot be "
            "certified from single-pass bf16 scores)")
    if recall_target is None:
        recall_target = 0.99 if exact_above is None else 0.95
    return method, recall_target


def _first_stage(p: _Problem, k: int, method: str, recall: float,
                 thr: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores, indices, ok) of one problem: exact (every row ok), or the
    certified first stage whose failed rows the caller repairs."""
    if method == "exact":
        s, i = _exact(p, k)
        return s, i, torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    return _certified(p, k, recall, thr, method == "certified-bf16")


def topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                exact_above: Optional[float] = None, method: str = "auto",
                recall_target: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) queries x (N, D) corpus -> (scores (M, k) f32, indices (M, k)
    int64), on the queries' device, by `method` (module docstring). A bf16
    corpus is searched in the cosine domain of its stored rows.
    recall_target: the approximate stage's target, None for 0.99 (strict)
    or 0.95 (with exact_above)."""
    global repaired_rows
    method, recall_target = _resolve_method(k, corpus.shape[0], method, exact_above,
                                            recall_target)
    p = _Problem(queries, corpus)
    with full_fp32():
        scores, idx, ok = _first_stage(p, k, method, recall_target, exact_above)
        bad = (~ok).nonzero()[:, 0]
        if len(bad):
            repaired_rows += len(bad)
            scores[bad], idx[bad] = _exact(p.rows(bad), k)
        return scores, idx


def topk_cosine(embeddings: torch.Tensor, k: int, exact_above: Optional[float] = None,
                method: str = "auto", recall_target: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Self-search: (N, D) embeddings -> (scores (N, k), indices (N, k))."""
    return topk_search(embeddings, embeddings, k, exact_above, method, recall_target)


# ------------------------------------------------------------------ sharded
#
# The corpus-sharded searches of JAX ops/topk.py:875-1164 over a device list
# (parallel/mesh.py): shard i of the row-sharded corpus lives on
# devices[i], and each shard's local work is the single-device search above
# on that device. Under a process group of W > 1 ranks (parallel/
# distributed.py) the shards of every rank together make the corpus, as
# JAX's mesh spans processes when process_count() > 1: each rank stages and
# searches its own block, the ranks exchange candidate lists (the search)
# or tiles (the ring) through collectives, and every rank returns the same
# result, the counterpart of JAX `_replicate_for_host` (:827-849). Results
# come back on devices[0], ordered by (score desc, index asc) as the
# single-device search orders them.


class ShardedCorpus:
    """An (N, D) corpus row-sharded over the devices of W ranks (W = 1
    without a process group). It is cut into W blocks of `block` =
    ceil(N / W) rows: rank r holds block r alone, padded on the host to
    d * rows rows, and its `shards[i]` holds the block's rows
    [i*rows, (i+1)*rows) on devices[i], so it starts at global row
    r*block + i*rows. Global shard g is shard g mod d of rank g // d; every
    rank has the same d and rows. The padded rows are zero and never
    scored (`valid`)."""

    def __init__(self, shards, n: int, world: int, rank: int, block: int):
        self.shards = list(shards)
        self.n = n
        self.rows = self.shards[0].shape[0]
        self.devices = [s.device for s in self.shards]
        self.world, self.rank, self.block = world, rank, block

    def span(self, g: int) -> Tuple[int, int]:
        """Global shard g's first row and its count of valid rows."""
        d = len(self.shards)
        base = (g // d) * self.block
        first = base + (g % d) * self.rows
        return first, max(0, min(self.rows, min(self.n, base + self.block) - first))

    def offset(self, i: int) -> int:
        """This rank's shard i's first global row."""
        return self.span(self.rank * len(self.shards) + i)[0]

    def valid(self, i: int) -> torch.Tensor:
        """This rank's shard i's corpus rows, without its padding."""
        return self.shards[i][:self.span(self.rank * len(self.shards) + i)[1]]

    def block_rows(self, r: int) -> int:
        """The count of valid rows rank r holds."""
        return max(0, min(self.block, self.n - r * self.block))


def stage_sharded_corpus(corpus, devices=None, dtype: Optional[torch.dtype] = None
                         ) -> ShardedCorpus:
    """Pad the corpus on the host and copy one row shard to each device
    (JAX stage_sharded_corpus): the full matrix never lands on one device,
    so each device holds N/d rows. Pass the result to `sharded_topk_search`
    to reuse it across searches. dtype=torch.bfloat16 rounds on the host
    first (half the copy and the memory), as `stage_corpus` does; None
    keeps a bfloat16 tensor's storage and stores anything else in f32.

    Under a process group of W > 1 ranks every rank passes the same full
    corpus (as every JAX process does) and stages only its own block of
    ceil(N / W) rows over its own devices (`devices`, by default the rank's
    card: parallel/mesh.py::as_devices); no rank holds another's rows.
    The ranks check that they staged alike (N, D, devices, dtype)."""
    from video_fingerprint_tpu_torch.parallel import distributed
    from video_fingerprint_tpu_torch.parallel.mesh import as_devices

    devices = as_devices(devices)
    if dtype is None:
        dtype = (torch.bfloat16 if getattr(corpus, "dtype", None) == torch.bfloat16
                 else torch.float32)
    if isinstance(corpus, torch.Tensor):
        host = corpus.detach().to("cpu", torch.float32)
    else:
        host = torch.from_numpy(np.ascontiguousarray(corpus, dtype=np.float32))
    n, d = host.shape[0], len(devices)
    world, rank = distributed.world_size(), distributed.rank()
    block = -(-n // world)
    host = host[rank * block:(rank + 1) * block]
    rows = max(1, -(-block // d))
    host = torch.nn.functional.pad(host, (0, 0, 0, d * rows - host.shape[0])).to(dtype)
    staged = ShardedCorpus((host[i * rows:(i + 1) * rows].to(dev)
                            for i, dev in enumerate(devices)), n, world, rank, block)
    mine = torch.tensor([n, host.shape[1], d, int(dtype == torch.bfloat16)],
                        device=devices[0])
    every = all_gather_stack(mine)
    if not bool((every == mine).all()):
        raise ValueError("the ranks staged different corpora: (N, D, devices, bf16) "
                         f"per rank {every.tolist()}")
    return staged


def _merge_on(device, cand_s, cand_i, k):
    """Merge candidate lists on `device`, keeping the first k."""
    cand_s = [s.to(device) for s in cand_s]
    cand_i = [i.to(device) for i in cand_i]
    return _order(torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1), k)


def _merge_shards(corpus: ShardedCorpus, cand_s, cand_i, k: int, m: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidate lists of this rank's shards (m rows each, global ids)
    -> the k best per row on devices[0]: this rank's best min(k, block),
    padded with (-inf, N) where it holds fewer rows, gathered from every
    rank and merged, so every rank gets the same k (the padding never
    enters them: the ranks together offer at least k real ones)."""
    home = corpus.devices[0]
    c = min(k, corpus.block)
    s = torch.full((m, c), -math.inf, device=home)
    i = torch.full((m, c), corpus.n, dtype=torch.int64, device=home)
    if cand_s:
        ls, li = _merge_on(home, cand_s, cand_i, c)
        s[:, :ls.shape[1]], i[:, :ls.shape[1]] = ls, li
    every_s, every_i = all_gather_stack(s), all_gather_stack(i)  # (W, m, c)
    return _order(every_s.transpose(0, 1).reshape(m, -1),
                  every_i.transpose(0, 1).reshape(m, -1), k)


def _gather_rows(corpus: ShardedCorpus, scores, idx, ok, k: int):
    """This rank's (rows of its block, k) ring results -> the (N, k) results
    of every rank, the same on every rank (each rank's rows padded to
    `block` for the gather, the padding dropped after it)."""
    home, b = corpus.devices[0], corpus.block
    s = torch.full((b, k), -math.inf, device=home)
    i = torch.zeros((b, k), dtype=torch.int64, device=home)
    o = torch.ones(b, dtype=torch.uint8, device=home)
    m = scores.shape[0]
    s[:m], i[:m], o[:m] = scores, idx, ok.to(torch.uint8)
    every = [all_gather_stack(x) for x in (s, i, o)]
    counts = [corpus.block_rows(r) for r in range(corpus.world)]
    s, i, o = (torch.cat([x[r, :c] for r, c in enumerate(counts)]) for x in every)
    return s, i, o.bool()


def _corpus_rows(corpus: ShardedCorpus, rows: torch.Tensor) -> torch.Tensor:
    """The corpus rows at global ids `rows` (the same on every rank), f32 on
    devices[0] of every rank: each rank fills the rows it holds, and the
    ranks' copies are gathered and summed (exact: every other term is
    zero)."""
    home = corpus.devices[0]
    out = torch.zeros((len(rows), corpus.shards[0].shape[1]), device=home)
    for i, shard in enumerate(corpus.shards):
        start = corpus.offset(i)
        sel = ((rows >= start) & (rows < start + len(corpus.valid(i)))).nonzero()[:, 0]
        if len(sel):
            out[sel] = shard[(rows[sel] - start).to(shard.device)].float().to(home)
    return all_gather_stack(out).sum(dim=0)


def sharded_topk_search(queries, corpus, k: int, devices=None,
                        exact_above: Optional[float] = None, method: str = "auto",
                        recall_target: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-sharded query-vs-corpus k-NN (JAX sharded_topk_search): the
    corpus is row-sharded over `devices` (all of the card's platform when
    None; under a process group, the rank's card), the (M, D) queries go to
    every shard. Each shard finds its min(k, rows) best with global column
    ids (its offset added), and one merge on devices[0] keeps the k best.
    Returns (scores (M, k), indices (M, k)) on devices[0], equal to
    `topk_search(method="exact")`.

    `corpus` is an (N, D) array or tensor, staged by `stage_sharded_corpus`,
    or a `ShardedCorpus` from it (then `devices` is its own). The methods
    are `topk_search`'s; a certified row is kept only if every shard
    certified it, and the other rows are repaired by an exact pass over the
    same staged shards.

    Under a process group of W > 1 ranks every rank passes the same queries
    and the same corpus (or its own `ShardedCorpus` of it); each searches
    its block, the ranks' candidate lists are gathered and merged, a row is
    certified only if every rank certified it (one all_reduce), the repairs
    go through the same merge, and every rank returns the same result."""
    global repaired_rows
    if not isinstance(corpus, ShardedCorpus):
        corpus = stage_sharded_corpus(corpus, devices)
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
    method, recall_target = _resolve_method(k, corpus.n, method, exact_above, recall_target)
    home = corpus.devices[0]
    m = queries.shape[0]
    if m == 0:
        return (torch.zeros((0, k), dtype=torch.float32, device=home),
                torch.zeros((0, k), dtype=torch.int64, device=home))
    with full_fp32():
        # every shard's work is launched before any result is merged, so
        # shards on different cards overlap
        problems = [(_Problem(queries.to(dev), corpus.valid(i)), corpus.offset(i))
                    for i, dev in enumerate(corpus.devices) if len(corpus.valid(i))]
        stages = [_first_stage(p, min(k, p.corpus.shape[0]), method, recall_target,
                               exact_above) for p, _ in problems]
        scores, idx = _merge_shards(corpus, [s for s, _, _ in stages],
                                    [j + off for (_, j, _), (_, off) in zip(stages, problems)],
                                    k, m)
        ok = torch.ones(m, dtype=torch.bool, device=home)
        for _, _, shard_ok in stages:
            ok &= shard_ok.to(home)
        bad = (~all_ranks_true(ok)).nonzero()[:, 0]
        if len(bad):
            repaired_rows += len(bad)
            fixes = [_exact(p.rows(bad.to(p.queries.device)), min(k, p.corpus.shape[0]))
                     for p, _ in problems]
            scores[bad], idx[bad] = _merge_shards(
                corpus, [s for s, _ in fixes],
                [j + off for (_, j), (_, off) in zip(fixes, problems)], k, len(bad))
    return scores, idx


def sharded_topk_cosine(embeddings, k: int, devices=None,
                        exact_above: Optional[float] = None, method: str = "auto",
                        recall_target: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring-sharded self-search (JAX sharded_topk_cosine): the (N, D)
    embeddings are row-sharded over `devices`, each shard's rows are both
    its queries and the corpus tile it sends round the ring. At step 0 each
    shard searches its own tile, which seeds its running top-k; at step t
    every tile moves to the next shard of the ring (a device-to-device
    copy; under a process group the last shard of each rank sends to the
    first shard of the next rank, and the first receives from the previous
    rank) and each shard merges its search of the tile it now holds, the
    one that started t places before it. After one step per shard of the
    ring every shard has met every tile. Returns (scores (N, k), indices
    (N, k)) on devices[0]; under a group every rank's rows are gathered, so
    every rank returns the same (N, k).

    Certified methods: a row is certified only if every tile certified it;
    the others are repaired by an exact `sharded_topk_search` over the same
    staged shards."""
    global repaired_rows
    corpus = embeddings if isinstance(embeddings, ShardedCorpus) else \
        stage_sharded_corpus(embeddings, devices)
    method, recall_target = _resolve_method(k, corpus.n, method, exact_above, recall_target)
    d, home = len(corpus.shards), corpus.devices[0]
    ring = corpus.world * d
    mine = [corpus.rank * d + i for i in range(d)]  # this rank's shards in the ring
    queries = [corpus.valid(i) for i in range(d)]
    tiles = list(corpus.shards)  # padded, so the tile a rank sends has one shape
    carry = [None] * d
    with full_fp32():
        for step in range(ring):
            if step:  # rotate: shard i receives the tile shard i-1 of the ring held
                tiles = [t.to(corpus.devices[i])
                         for i, t in enumerate([ring_shift(tiles[-1])] + tiles[:-1])]
            for i, tile in enumerate(tiles):
                start, count = corpus.span((mine[i] - step) % ring)  # the tile's origin
                if not len(queries[i]) or not count:
                    continue
                s, j, ok = _first_stage(_Problem(queries[i], tile[:count]), min(k, count),
                                        method, recall_target, exact_above)
                j = j + start
                if carry[i] is None:
                    carry[i] = (s, j, ok)
                else:
                    cs, cj, cok = carry[i]
                    cs, cj = _order(torch.cat([cs, s], dim=1), torch.cat([cj, j], dim=1),
                                    min(k, cs.shape[1] + s.shape[1]))
                    carry[i] = (cs, cj, cok & ok)
        parts = [c for c in carry if c is not None]
        if parts:
            scores = torch.cat([s.to(home) for s, _, _ in parts])
            idx = torch.cat([j.to(home) for _, j, _ in parts])
            ok = torch.cat([o.to(home) for _, _, o in parts])
        else:  # a rank past the end of the corpus
            scores = torch.zeros((0, k), device=home)
            idx = torch.zeros((0, k), dtype=torch.int64, device=home)
            ok = torch.ones(0, dtype=torch.bool, device=home)
        scores, idx, ok = _gather_rows(corpus, scores, idx, ok, k)
    bad = (~ok).nonzero()[:, 0]
    if len(bad):
        repaired_rows += len(bad)
        fix_s, fix_i = sharded_topk_search(_corpus_rows(corpus, bad), corpus, k,
                                           method="exact")
        scores[bad], idx[bad] = fix_s.to(home), fix_i.to(home)
    return scores, idx
