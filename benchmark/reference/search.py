"""Exact top-k and the duplicate grouping, plain, for judging the program's.

`exact_topk` scores every (query, corpus row) pair with one product in
float32 with TF32 off (or float64), block by block, and keeps each row's
k best scores, ordered by (score descending, index ascending); which of
several rows tied at the k-th score is kept is not specified. `greedy_groups` is the
grouping of the reference scanner's k-NN route (fingerprint.py:515-548):
in order, each video not yet taken takes every neighbour of its k at or
above the threshold that is not yet taken, and a group of two or more is
kept. `groupings` is that grouping from float64 scores of all pairs, with
each pair that float32 could put on either side of the threshold decided
both ways.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Tuple

import numpy as np
import torch

from benchmark.reference.models import exact_float32

QUERY_BLOCK = 1024
# float32 scores of unit vectors of 256 dims lie within this of float64's
AMBIGUOUS = 1e-5
CORPUS_BLOCK = 1 << 16


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, D) x (N, D) in the corpus's dtype -> (scores (M, k), indices (M, k))."""
    out_s, out_i = [], []
    with exact_float32():
        for qlo in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[qlo:qlo + QUERY_BLOCK]
            cand_s, cand_i = [], []
            for clo in range(0, corpus.shape[0], CORPUS_BLOCK):
                sims = q @ corpus[clo:clo + CORPUS_BLOCK].t()
                s, i = torch.topk(sims, min(k, sims.shape[1]), dim=1)
                cand_s.append(s)
                cand_i.append(i + clo)
            s, i = torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1)
            by_index = torch.argsort(i, dim=1)
            s, i = s.gather(1, by_index), i.gather(1, by_index)
            order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
            out_s.append(s.gather(1, order))
            out_i.append(i.gather(1, order))
    return torch.cat(out_s), torch.cat(out_i)


def greedy_groups(scores: np.ndarray, indices: np.ndarray, threshold: float) -> List[List[int]]:
    """Groups of row numbers from each row's (score, index) neighbours."""
    taken = set()
    groups = []
    for i in range(scores.shape[0]):
        if i in taken:
            continue
        group = []
        for s, j in zip(scores[i], indices[i]):
            if s >= threshold and int(j) not in taken:
                taken.add(int(j))
                group.append(int(j))
        if len(group) > 1:
            groups.append(group)
    return groups


def groupings(embeddings: np.ndarray, threshold: float, device, k: int = 20,
              most: int = 6) -> Iterator[List[List[int]]]:
    """The groups of n fingerprints, by float64 scores of all pairs: one
    grouping for each way of deciding the pairs (at most `most` of them)
    whose score lies within AMBIGUOUS of the threshold, where float32
    arithmetic may fall on either side. Almost always there is none, and
    one grouping."""
    e = torch.from_numpy(np.asarray(embeddings, np.float64)).to(device)
    sims = e @ e.t()
    near = ((sims - threshold).abs() <= AMBIGUOUS).triu(1).nonzero().tolist()[:most]
    for above in itertools.product((False, True), repeat=len(near)):
        decided = sims.clone()
        for (a, b), up in zip(near, above):
            decided[a, b] = decided[b, a] = threshold + (2 if up else -2) * AMBIGUOUS
        scores, idx = torch.sort(decided, dim=1, descending=True, stable=True)
        k = min(k, e.shape[0])
        yield greedy_groups(scores[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy(), threshold)
