"""Duplicate grouping (inference/dedup.py) against the loops it replaced.

The oracle below is the scanner's grouping as it stood before the module:
the direct and top-k routes' greedy loops, the `--against` loop and the two
exact-duplicate taggings, verbatim but for the search that fed them, which
is an argument here. Each case runs the scanner's own entry points
(`find_duplicates` on either route, `find_duplicates_against`) with the
search's answer given, and asserts the whole output equal to the oracle's:
the groups, every item dict in order, `similarity` bit for bit and
`exact_duplicate`. The direct route is also held against the JAX
package's scanner on seeded embeddings, and the sharding rule of the
searches (ops/topk.py::shard_search) at its edges."""

import struct
import zlib

import numpy as np
import pytest
import torch

from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
from video_fingerprint_tpu_torch.ops import topk as topk_mod
from video_fingerprint_tpu_torch.ops.topk import shard_search, topk_cosine

CPU = torch.device("cpu")
DIM = 8


# ---------------------------------------------------------------- the oracle


def oracle_direct(sims, paths, fingerprints, threshold):
    processed = set()
    groups = []
    for i in range(len(sims)):
        if i in processed:
            continue
        similar = np.where(sims[i] >= threshold)[0]
        if len(similar) > 1:
            group = []
            for idx in similar:
                if idx not in processed:
                    processed.add(int(idx))
                    item = dict(fingerprints[paths[idx]])
                    item["similarity"] = float(sims[i, idx])
                    group.append(item)
            if len(group) > 1:
                groups.append(group)
    return groups


def oracle_topk(sims, idx, paths, fingerprints, threshold):
    n = len(sims)
    processed = set()
    groups = []
    for i in range(n):
        if i in processed:
            continue
        group = []
        for sim, j in zip(sims[i], idx[i]):
            if sim >= threshold and int(j) not in processed:
                processed.add(int(j))
                item = dict(fingerprints[paths[int(j)]])
                item["similarity"] = float(sim)
                group.append(item)
        if len(group) > 1:
            groups.append(group)
    return groups


def oracle_tag_library(groups):
    for group in groups:
        hashes = [item["file_hash"] for item in group]
        for item in group:
            item["exact_duplicate"] = hashes.count(item["file_hash"]) > 1
    return groups


def oracle_against(sims, idx, paths, fingerprints, similarity_threshold, index):
    groups = []
    for qi, path in enumerate(paths):
        anchor = dict(fingerprints[path])
        anchor["similarity"] = 1.0
        group = [anchor]
        for sim, j in zip(sims[qi], idx[qi]):
            if sim < similarity_threshold:
                continue
            meta = index.meta(int(j))
            if meta.get("path") == path:
                continue
            item = dict(meta)
            item["similarity"] = float(sim)
            group.append(item)
        if len(group) > 1:
            groups.append(group)

    for group in groups:
        hashes = [item.get("file_hash") for item in group]
        for item in group:
            h = item.get("file_hash")
            item["exact_duplicate"] = h is not None and hashes.count(h) > 1
    return groups


# ---------------------------------------------------------------- helpers


def _canon(value):
    """A value as == can compare it whole: arrays by dtype, shape and bytes,
    floats by their bits, every value with its type."""
    if isinstance(value, np.ndarray):
        return ("ndarray", value.dtype.str, value.shape, value.tobytes())
    if isinstance(value, float):
        return ("float", struct.pack("<d", value))
    if isinstance(value, dict):
        return ("dict", tuple((k, _canon(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, tuple(_canon(v) for v in value))
    return (type(value).__name__, value)


def _assert_same(got, want):
    assert _canon(got) == _canon(want)


def _ranked(scores, k):
    """Each row's k best columns by (score desc, index asc), as the exact
    search orders them, and their scores."""
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def _fingerprints(n, hashes, prefix="v"):
    rng = np.random.default_rng(n)
    paths = [f"{prefix}{j:03d}" for j in range(n)]
    fps = {}
    for j, p in enumerate(paths):
        fp = {"embedding": rng.standard_normal(DIM).astype(np.float32), "path": p,
              "name": p + ".mp4", "size": 100 + j}
        if hashes[j] is not ...:  # Ellipsis: no file_hash key at all
            fp["file_hash"] = hashes[j]
        fps[p] = fp
    return paths, fps


def _bare_scanner(devices=(CPU,)):
    program = FingerprintScanner.__new__(FingerprintScanner)
    program.device, program.devices = CPU, list(devices)
    program.embedding_dim = DIM
    program.model_identity = {"model_type": "attention", "embedding_dim": DIM}
    return program


def _edge(threshold):
    """float32(threshold) and the float32 one ulp below it."""
    at = np.float32(threshold)
    return at, np.nextafter(at, np.float32(-np.inf))


# ---------------------------------------------------------------- library cases


def _library_case(name, threshold):
    """(n x n float32 similarity matrix, file hashes) of a named case."""
    at, below = _edge(threshold)
    rng = np.random.default_rng(zlib.crc32(f"{name} {threshold}".encode()))
    if name == "one_video":
        return np.ones((1, 1), np.float32), ["h"]
    n = {"more_than_k": 32}.get(name, 14)
    m = rng.uniform(0.0, 0.5, (n, n)).astype(np.float32)
    np.fill_diagonal(m, 1.0)
    hashes = [f"h{j}" for j in range(n)]
    if name == "ties":
        for a in (0, 3, 5):  # three exact copies: every pair ties at 1.0
            for b in (0, 3, 5):
                m[a, b] = 1.0
        m[1, [7, 8, 9]] = m[[7, 8, 9], 1] = np.float32(0.996)  # tied candidates of row 1
        m[7, 8] = m[8, 7] = np.float32(0.9995)
        hashes[3] = hashes[0]
    elif name == "threshold_edge":
        m[0, 4] = m[4, 0] = at
        m[1, 6] = m[6, 1] = below
        m[2, 9], m[9, 2] = at, below  # asymmetric at the edge
        m[9, 11] = m[11, 9] = at
        m[10, 10] = below  # a self-score under the threshold
        m[10, 12] = m[12, 10] = at
    elif name == "more_than_k":
        block = rng.uniform(float(at), 1.0, (25, 25)).astype(np.float32)
        m[:25, :25] = np.maximum(block, block.T)
        np.fill_diagonal(m, 1.0)
        hashes = [f"h{j % 5}" for j in range(n)]
    elif name == "lone_hits":
        m[2, 2] = m[5, 5] = below  # rows whose one hit is another row
        m[2, 7] = at
        m[5, 3] = np.float32(0.999)
        m[7, 3] = m[3, 7] = np.float32(0.998)
        m[3, 8] = m[8, 3] = np.float32(0.997)
    elif name == "repeated_hashes":
        m[:6, :6] = np.float32(0.999)
        m[8:12, 8:12] = at
        hashes = ["a", "a", "b", None, None, "a", "c", "c", "d", "d", "d", None, "e", "e"]
    elif name.startswith("seeded"):
        m = (np.float32(threshold) + rng.normal(0, 2e-3, (n, n))).astype(np.float32)
        m[rng.random((n, n)) < 0.05] = at
        m[rng.random((n, n)) < 0.05] = below
        m[rng.random((n, n)) < 0.4] = np.float32(0.3)
        hashes = [f"h{j}" for j in rng.integers(0, 5, n)]
    return m, hashes


LIBRARY_CASES = ["ties", "threshold_edge", "more_than_k", "lone_hits", "repeated_hashes",
                 "one_video", "seeded0", "seeded1", "seeded2"]


@pytest.mark.parametrize("threshold", [0.95, 0.99])
@pytest.mark.parametrize("route", ["direct", "topk"])
@pytest.mark.parametrize("case", LIBRARY_CASES)
def test_library_groups_equal_the_parent_loops(case, route, threshold, monkeypatch):
    """find_duplicates on either route, the search's answer given: the
    direct route's matrix, or the top-k route's min(20, n) best of it."""
    m, hashes = _library_case(case, threshold)
    paths, fps = _fingerprints(len(m), hashes)
    k = min(20, len(m))
    scores, idx = _ranked(m, k)
    program = _bare_scanner()
    monkeypatch.setattr(program, "_similarities_full", lambda e: m.copy(), raising=False)
    monkeypatch.setattr(scanner_mod, "topk_cosine", lambda e, kk, exact_above: (
        torch.from_numpy(scores.copy()), torch.from_numpy(idx.copy())))
    got = program.find_duplicates(fps, threshold,
                                  topk_threshold=0 if route == "topk" else 100)
    if len(m) < 2:
        want = []
    elif route == "topk":
        want = oracle_tag_library(oracle_topk(scores, idx, paths, fps, threshold))
    else:
        want = oracle_tag_library(oracle_direct(m, paths, fps, threshold))
    _assert_same(got, want)
    if case == "more_than_k" and route == "topk":
        assert (scores >= threshold).sum(axis=1).max() == k  # more than k clear it
        assert len(m[0][m[0] >= np.float32(threshold)]) > k
    if case not in ("one_video",):
        assert got, "the case should form groups"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_route_on_the_real_search_equals_the_parent_loop(seed):
    """The search itself (topk_cosine on the CPU), then both groupings."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((150, DIM)).astype(np.float32)
    e[10] = e[11] = e[3]
    e[40:70] = e[20] + rng.normal(0, 1e-3, (30, DIM)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    paths, fps = _fingerprints(len(e), [f"h{j % 7}" for j in range(len(e))])
    for j, p in enumerate(paths):
        fps[p]["embedding"] = e[j]
    got = _bare_scanner().find_duplicates(fps, 0.999)
    s, i = topk_cosine(torch.from_numpy(e), 20, exact_above=0.999)
    want = oracle_tag_library(oracle_topk(s.numpy(), i.numpy(), paths, fps, 0.999))
    _assert_same(got, want)
    assert ["v003", "v010", "v011"] in [[it["path"] for it in g] for g in got]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_direct_route_matches_the_jax_scanner(seed):
    """n <= 100: the port's full matrix against the JAX package's, the
    groups whole but for similarities within 2e-6."""
    rng = np.random.default_rng(100 + seed)
    e = rng.standard_normal((60, 16)).astype(np.float32)
    e[7] = e[2]
    e[30] = e[2]
    e[12] = e[5] + 0.01 * rng.standard_normal(16).astype(np.float32)
    e[13] = e[5] + 0.01 * rng.standard_normal(16).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    threshold = 0.99
    exact = e.astype(np.float64) @ e.T.astype(np.float64)
    assert np.abs(exact - threshold).min() > 1e-5  # no pair near the threshold
    paths = [f"v{j:02d}" for j in range(len(e))]
    fps = {p: {"embedding": e[j], "path": p, "size": j, "file_hash": f"h{j % 4}"}
           for j, p in enumerate(paths)}
    ours = _bare_scanner().find_duplicates(fps, threshold)
    ref = JaxScanner.__new__(JaxScanner).find_duplicates(fps, threshold)
    assert len(ours) == len(ref) >= 2
    for g_ours, g_ref in zip(ours, ref):
        assert [it["path"] for it in g_ours] == [it["path"] for it in g_ref]
        for a, b in zip(g_ours, g_ref):
            np.testing.assert_allclose(a["similarity"], b["similarity"], rtol=0, atol=2e-6)
            _assert_same({k: v for k, v in a.items() if k != "similarity"},
                         {k: v for k, v in b.items() if k != "similarity"})


# ---------------------------------------------------------------- --against


class _Index:
    """A saved corpus whose search answers with the given scores, ranked as
    the exact search ranks them; it records every `meta` read."""

    model_identity = {}
    dim = DIM

    def __init__(self, scores, metas):
        self.scores, self.metas, self.reads, self.searches = scores, metas, [], 0

    def __len__(self):
        return len(self.metas)

    def search(self, queries, k=20, exact_above=None):
        self.searches += 1
        return _ranked(self.scores[:len(queries)], min(k, len(self.metas)))

    def meta(self, i):
        self.reads.append(i)
        return self.metas[i]


def _against_case(name, threshold):
    """(queries' fingerprints, query paths, (M x N) scores, corpus metas, k)."""
    at, below = _edge(threshold)
    rng = np.random.default_rng(zlib.crc32(f"{name} {threshold}".encode()))
    nq, nc, k = (6, 40, 5) if name == "more_than_k" else (8, 24, 6)
    if name == "empty_index":
        nc = 0
    qpaths, qfps = _fingerprints(nq, [f"q{j % 3}" for j in range(nq)], prefix="q")
    if name == "no_queries":
        qpaths, qfps = [], {}
    scores = rng.uniform(0.0, 0.5, (nq, nc)).astype(np.float32)
    metas = [{"path": f"c{j:03d}", "name": f"c{j}.mp4", "size": j,
              "file_hash": f"q{j % 4}"} for j in range(nc)]
    if name == "ties":
        scores[0, [3, 5, 9]] = np.float32(0.998)
        scores[1, [2, 4]] = 1.0
        scores[1, [6, 7, 8]] = np.float32(0.996)
    elif name == "threshold_edge":
        scores[0, 1], scores[0, 2] = at, below
        scores[2, 3] = below
        scores[3, [4, 5]] = at
    elif name == "own_path":
        metas[4]["path"] = qpaths[0]  # the query itself is in the corpus
        metas[6]["path"] = qpaths[1]
        scores[0, [4, 7]] = 1.0, np.float32(0.999)
        scores[1, 6] = 1.0  # its only hit is itself: no group
        scores[2, 4] = np.float32(0.997)  # another query's own entry joins
    elif name == "hashes":
        scores[:, :8] = np.float32(0.999)
        del metas[1]["file_hash"]
        metas[2]["file_hash"] = None
        metas[3]["file_hash"] = None
        metas[5]["file_hash"] = metas[4]["file_hash"] = "q0"
        qfps[qpaths[1]]["file_hash"] = None
        del qfps[qpaths[2]]["file_hash"]
    elif name == "more_than_k":
        scores[0, :30] = rng.uniform(float(at), 1.0, 30).astype(np.float32)
        scores[1, 10:25] = at
    elif name.startswith("seeded"):
        scores = (np.float32(threshold) + rng.normal(0, 2e-3, (nq, nc))).astype(np.float32)
        scores[rng.random((nq, nc)) < 0.05] = at
        scores[rng.random((nq, nc)) < 0.05] = below
        scores[rng.random((nq, nc)) < 0.5] = np.float32(0.2)
        for j in rng.choice(nc, 4, replace=False):
            metas[j]["path"] = qpaths[rng.integers(nq)]
        for j in rng.choice(nc, 3, replace=False):
            metas[j]["file_hash"] = None
    return qfps, qpaths, scores, metas, k


AGAINST_CASES = ["ties", "threshold_edge", "own_path", "hashes", "more_than_k",
                 "empty_index", "no_queries", "seeded0", "seeded1", "seeded2"]


@pytest.mark.parametrize("threshold", [0.95, 0.99])
@pytest.mark.parametrize("case", AGAINST_CASES)
def test_against_groups_equal_the_parent_loop(case, threshold):
    """find_duplicates_against, the index's answer given: the groups, the
    corpus entries read (hits only, in rank order) and one search a call."""
    qfps, qpaths, scores, metas, k = _against_case(case, threshold)
    got_index = _Index(scores, metas)
    got = _bare_scanner().find_duplicates_against(qfps, got_index, threshold, k=k)
    if not qfps or not metas:
        want, hits = [], []
    else:
        sims, idx = _ranked(scores, min(k, len(metas)))
        want = oracle_against(sims, idx, qpaths, qfps, threshold, _Index(scores, metas))
        hits = idx[sims >= np.float32(threshold)].tolist()
        assert want or case.startswith("seeded"), "the case should form groups"
    _assert_same(got, want)
    assert got_index.reads == hits
    assert got_index.searches == (1 if qfps and metas else 0)


def test_against_groups_on_a_real_index_equal_the_parent_loop():
    """A CPU FingerprintIndex searched for real, with planted copies, a
    query's own entry in the corpus and hashes that repeat or are missing."""
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((300, DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    metas = [{"path": f"c{j:03d}", "size": j, "file_hash": f"h{j % 9}"} for j in range(300)]
    metas[11]["file_hash"] = None
    del metas[12]["file_hash"]
    index = FingerprintIndex(dim=DIM, device="cpu")
    index.add(corpus, metas)
    queries = corpus[[5, 11, 12, 40, 41, 99]] + rng.normal(0, 1e-4, (6, DIM)).astype(np.float32)
    queries[3] = corpus[40]
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    qpaths = ["q0", "q1", "q2", "c040", "q4", "q5"]
    qfps = {p: {"embedding": queries[j], "path": p, "file_hash": f"h{j % 2}"}
            for j, p in enumerate(qpaths)}
    got = _bare_scanner().find_duplicates_against(qfps, index, 0.999, k=20)
    sims, idx = index.search(queries, k=20, exact_above=0.999)
    want = oracle_against(sims, idx, qpaths, qfps, 0.999, index)
    _assert_same(got, want)
    assert [g[0]["path"] for g in got] == ["q0", "q1", "q2", "q4", "q5"]


# ---------------------------------------------------------------- sharding rule


@pytest.mark.parametrize("devices,world,n,sharded", [
    (1, 1, 10**6, False),
    (2, 1, 15, False), (2, 1, 16, True),
    (8, 1, 63, False), (8, 1, 64, True),
    (1, 2, 15, False), (1, 2, 16, True),
    (4, 2, 63, False), (4, 2, 64, True),
])
def test_shard_search_needs_two_shards_of_eight_rows(devices, world, n, sharded, monkeypatch):
    """Shards are the devices times the process group's ranks."""
    monkeypatch.setattr(topk_mod, "world_size", lambda: world)
    assert shard_search(n, [CPU] * devices) is sharded


@pytest.mark.parametrize("n,sharded", [(15, False), (16, True)])
def test_dedup_and_index_shard_by_the_one_rule(n, sharded, monkeypatch):
    """Over two devices both the scan's top-k route and the index search
    take the sharded search from 16 rows on."""
    calls = []
    plain_topk, plain_search = scanner_mod.topk_cosine, topk_mod.topk_search
    monkeypatch.setattr(scanner_mod, "sharded_topk_cosine",
                        lambda e, k, devices, exact_above: calls.append("ring")
                        or plain_topk(torch.from_numpy(e), k, exact_above=exact_above))
    monkeypatch.setattr(topk_mod, "sharded_topk_search",
                        lambda q, corpus, k, exact_above: calls.append("sharded")
                        or plain_search(torch.from_numpy(q), torch.from_numpy(
                            np.ascontiguousarray(e)), k, exact_above=exact_above))
    monkeypatch.setattr(topk_mod, "stage_sharded_corpus", lambda corpus, devices, dtype: None)
    rng = np.random.default_rng(n)
    e = rng.standard_normal((n, DIM)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    fps = {f"v{j}": {"embedding": e[j], "file_hash": str(j)} for j in range(n)}
    _bare_scanner([CPU, CPU]).find_duplicates(fps, 0.99, topk_threshold=0)
    index = FingerprintIndex(dim=DIM, device="cpu", devices=[CPU, CPU])
    index.add(e)
    index.search(e[:3], k=4)
    assert calls == (["ring", "sharded"] if sharded else [])
