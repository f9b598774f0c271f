"""Duplicate groups from search candidates, in numpy (reference fingerprint.py:450-548).
An item is a fingerprint or corpus entry copied with "similarity" (a float32 score as a
Python float). Threshold tests compare float32 arrays with a Python float: in float32."""

from collections import Counter
from typing import Callable, List

import numpy as np


def library_groups(sims, idx, threshold: float, paths, fingerprints) -> List[List[dict]]:
    """Greedy groups over each row's candidates at or above the threshold: the
    (N, N) matrix's in index order (idx None; a row with fewer than two takes
    none; fingerprint.py:482-513), or the top-k's, (N, k) with idx their rows,
    in rank order (fingerprint.py:515-548). A taken row anchors nothing; a
    candidate joins unless taken; a group of one is dropped, its item taken."""
    hits = sims >= threshold
    if idx is None:
        hits &= np.count_nonzero(hits, axis=1)[:, None] > 1
        idx = np.broadcast_to(np.arange(len(sims)), sims.shape)
    processed, groups = set(), []
    for i in range(len(sims)):
        if i in processed:
            continue
        group = []
        for j, score in zip(idx[i][hits[i]].tolist(), sims[i][hits[i]].tolist()):
            if j not in processed:
                processed.add(j)
                group.append(dict(fingerprints[paths[j]], similarity=score))
        if len(group) > 1:
            groups.append(group)
    return groups


def against_groups(sims: np.ndarray, idx: np.ndarray, threshold: float, paths,
                   fingerprints, meta: Callable[[int], dict]) -> List[List[dict]]:
    """Query i (paths[i]) against its (M, k) corpus scores and indices in
    rank order: [query with similarity 1.0, hits...] when a hit other than
    an entry of the query's own path clears the threshold. meta(j), corpus
    entry j, is read for hits only; no corpus entry is taken across queries."""
    hits, groups = sims >= threshold, []
    for qi in np.flatnonzero(hits.any(axis=1)).tolist():
        path = paths[qi]
        group = [dict(fingerprints[path], similarity=1.0)]
        for j, score in zip(idx[qi][hits[qi]].tolist(), sims[qi][hits[qi]].tolist()):
            entry = meta(j)
            if entry.get("path") != path:
                group.append(dict(entry, similarity=score))
        if len(group) > 1:
            groups.append(group)
    return tag_exact_duplicates(groups, missing_hash_ok=True)


def tag_exact_duplicates(groups: List[List[dict]], missing_hash_ok=False):
    """Mark each item whose file_hash (md5 of the file's first MiB) another
    item of its group shares (fingerprint.py:475-479). A scanned library's
    items all carry one (KeyError otherwise); a saved corpus may lack them
    (missing_hash_ok), and a missing or None hash then marks nothing."""
    for group in groups:
        hashes = [item.get("file_hash") if missing_hash_ok else item["file_hash"]
                  for item in group]
        counts = Counter(h for h in hashes if h is not None or not missing_hash_ok)
        for item, h in zip(group, hashes):
            item["exact_duplicate"] = counts[h] > 1
    return groups
