"""The port's exact top-k search on the CPU, beside its kernel for the card
(video_fingerprint_tpu_torch/csrc/topk.cu, whose own tests run on the card
in tests/test_torch_port_kernels.py).

A CPU problem runs the plain path: no kernel launch, the JAX package's
exact result. `topk_search(method="exact")` reads no certificate back
(no host wait outside the exact search itself), while the certified
methods still wait on theirs. The kernel's grid plan covers the corpus
with whole tiles in one wave, and its selection (running thresholds,
candidate lists cut by rank, the final cut and the merge of the chunks'
lists), emulated here on score matrices full of ties across tile and
chunk edges, gives the (score desc, index asc) top-k.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_fingerprint_tpu.ops import topk as jax_topk
from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.utils import trace

INT_MAX = 2**31 - 1


@pytest.fixture(scope="module")
def embeddings():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(333, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[[10, 11]] = e[3]  # a tie group, as tests/test_torch_port_scan.py plants
    return e


def _bf16_cosine_oracle(queries, corpus):
    """Cosines of the bf16-rounded rows, in float64."""
    def unit(x):
        x = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return unit(queries) @ unit(corpus).T


@pytest.mark.parametrize("k", [1, 5, 20, 333])
def test_cpu_exact_runs_the_plain_path_f32(embeddings, k):
    """f32 storage on the CPU: no kernel launch, and the JAX package's exact
    rows and scores."""
    e = torch.from_numpy(embeddings)
    before = trace.counter("topk.launches")
    s, i = topk.topk_search(e[:100], e, k, method="exact")
    assert trace.counter("topk.launches") == before
    rs, ri = jax_topk.topk_search(embeddings[:100], embeddings, k, method="exact")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=0, atol=2e-6)
    for row in (3, 10, 11):
        assert list(i.numpy()[row, :min(k, 3)]) == [3, 10, 11][:k]


@pytest.mark.parametrize("k", [1, 20])
def test_cpu_exact_runs_the_plain_path_bf16(embeddings, k):
    """bf16 storage on the CPU: no kernel launch, the cosines of the stored
    rows, and the rows of the float64 oracle wherever its scores lie 1e-5
    apart."""
    e = torch.from_numpy(embeddings)
    before = trace.counter("topk.launches")
    s, i = topk.topk_search(e[:100], e.to(torch.bfloat16), k, method="exact")
    assert trace.counter("topk.launches") == before
    sims = _bf16_cosine_oracle(embeddings[:100], embeddings)
    order = np.lexsort((np.broadcast_to(np.arange(sims.shape[1]), sims.shape), -sims))
    np.testing.assert_allclose(s.numpy(), np.take_along_axis(sims, i.numpy(), 1), atol=2e-6)
    top = np.take_along_axis(sims, order[:, :k + 1], 1)
    gaps = -np.diff(top, axis=1)
    above = np.concatenate([np.full((len(top), 1), np.inf), gaps[:, :k - 1]], axis=1)
    apart = (above > 1e-5) & (gaps[:, :k] > 1e-5)
    np.testing.assert_array_equal(i.numpy()[apart], order[:, :k][apart])


def _syncs_outside_exact(monkeypatch, fn):
    """`topk.sync` spans fn records outside the exact searches it calls."""
    inside = []
    plain = topk._exact

    def counted(p, k):
        before = sum(s.name == "topk.sync" for s in trace.recorded().spans)
        out = plain(p, k)
        inside.append(sum(s.name == "topk.sync" for s in trace.recorded().spans) - before)
        return out

    monkeypatch.setattr(topk, "_exact", counted)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    total = sum(s.name == "topk.sync" for s in trace.recorded().spans)
    trace.clear()
    return total - sum(inside)


@pytest.mark.parametrize("method,thr,waits", [("exact", None, 0), ("exact", 0.9, 0),
                                              ("certified", None, 1), ("certified", 0.9, 1),
                                              ("certified-bf16", 0.9, 1)])
def test_only_certified_methods_wait_on_their_certificate(embeddings, monkeypatch, method,
                                                          thr, waits):
    """The exact method's rows are exact by construction: topk_search reads
    no certificate back; each certified method waits once on its own."""
    e = torch.from_numpy(embeddings)
    assert _syncs_outside_exact(
        monkeypatch, lambda: topk.topk_search(e, e, 10, exact_above=thr, method=method)
    ) == waits


@pytest.mark.parametrize("ring", [False, True], ids=["search", "ring"])
@pytest.mark.parametrize("method,thr", [("exact", None), ("exact", 0.9), ("certified", 0.9),
                                        ("certified-bf16", 0.9)])
def test_sharded_searches_wait_only_on_a_certificate(embeddings, monkeypatch, ring, method, thr):
    """The sharded search and the ring over two CPU shards: the exact
    method gathers and waits on no certificate; the certified methods still
    wait on theirs (and on the rows their repairs gather)."""
    e = torch.from_numpy(embeddings)
    if ring:
        def search():
            return topk.sharded_topk_cosine(e, 10, devices=["cpu"] * 2, exact_above=thr,
                                            method=method)
    else:
        def search():
            return topk.sharded_topk_search(e[:40], e, 10, devices=["cpu"] * 2,
                                            exact_above=thr, method=method)
    waits = _syncs_outside_exact(monkeypatch, search)
    assert waits == 0 if method == "exact" else waits >= 1
    want_s, want_i = topk.topk_search(e if ring else e[:40], e, 10, method="exact")
    got_s, got_i = search()
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=1e-6)
    if method == "exact":
        assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("k,cap", [(1, 32), (20, 32), (31, 32), (32, 64), (33, 64), (64, 128),
                                   (200, 256), (256, 512)])
def test_list_capacity(k, cap):
    assert topk.list_capacity(k) == cap


@pytest.mark.parametrize("m,n,slots", [(256, 1_000_000, 264), (1, 20, 264), (5, 1000, 264),
                                       (1030, 200_003, 264), (1030, 65_537, 132),
                                       (100_000, 100_000, 264), (4096, 1_000_000, 264),
                                       (256, 129, 1), (700, 128, 3), (256, 1_000_000, 132)])
def test_kernel_plan_covers_the_corpus_in_one_wave(m, n, slots):
    """Whole 128-row tiles, every chunk holding rows, the corpus covered,
    and query tiles x chunks within the card's blocks where one query tile
    a chunk fits."""
    q_tiles, chunks, rows = topk.kernel_plan(m, n, slots)
    assert q_tiles == math.ceil(m / 128)
    assert rows % 128 == 0 and rows >= 128
    assert (chunks - 1) * rows < n <= chunks * rows
    assert q_tiles * chunks <= max(slots, q_tiles)
    if (m, n, slots) == (256, 1_000_000, 132):  # the search-against-1m call on an H100
        assert (chunks, rows) == (66, 15232)


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="card"):
        topk.topk_kernel(torch.zeros((4, 8)), torch.zeros((30, 8)), 5)


def _key(entry):
    return (-entry[0], entry[1])


def _emulate(scores: np.ndarray, k: int, chunk_rows: int, rng) -> np.ndarray:
    """csrc/topk.cu's selection over an (M, N) score matrix: per chunk and
    row, 128-column tiles whose scores that beat the row's threshold enter
    its list of list_capacity(k) entries in a random order (the shared
    atomics'); a full list is cut to its k best, which sets the threshold,
    and the rest are tried again; the last cut pads a short list with
    (-inf, INT_MAX); the merge pops the best head of the chunks' lists k
    times. Returns the (M, k) rows."""
    m, n = scores.shape
    cap = topk.list_capacity(k)
    out = np.empty((m, k), dtype=np.int64)
    for r in range(m):
        lists = []
        for c0 in range(0, n, chunk_rows):
            thr, buf = (-math.inf, INT_MAX), []
            for t0 in range(c0, min(n, c0 + chunk_rows), 128):
                pending = rng.permutation(np.arange(t0, min(n, c0 + chunk_rows, t0 + 128)))
                pending = pending.tolist()
                while pending:
                    left = []
                    for j in pending:
                        entry = (float(scores[r, j]), j)
                        if _key(entry) >= _key(thr):
                            continue
                        if len(buf) < cap:
                            buf.append(entry)
                        else:
                            left.append(j)
                    if left:
                        buf = sorted(buf, key=_key)[:k]
                        thr = buf[k - 1]
                    pending = left
            buf = sorted(buf, key=_key)[:k]
            lists.append(buf + [(-math.inf, INT_MAX)] * (k - len(buf)))
        heads = [0] * len(lists)
        for j in range(k):
            c = min((c for c in range(len(lists)) if heads[c] < k),
                    key=lambda c: _key(lists[c][heads[c]]))
            out[r, j] = lists[c][heads[c]][1]
            heads[c] += 1
    return out


@pytest.mark.parametrize("m,n,k,slots", [(3, 700, 20, 6), (2, 300, 1, 3), (2, 130, 64, 2),
                                         (4, 2000, 5, 4), (2, 20, 20, 1), (1, 1000, 100, 8)])
def test_kernel_selection_gives_the_low_index_top_k(m, n, k, slots):
    """Scores on a coarse grid (ties everywhere, across tiles and chunks)
    and one row of equal scores: the emulated selection returns the
    (score desc, index asc) top-k."""
    rng = np.random.default_rng(n + k)
    scores = np.round(rng.uniform(-1, 1, (m, n)), 1).astype(np.float32)
    scores[0] = 0.5
    _, _, chunk_rows = topk.kernel_plan(m, n, slots)
    got = _emulate(scores, k, chunk_rows, rng)
    want = np.lexsort((np.broadcast_to(np.arange(n), scores.shape), -scores))[:, :k]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.arange(k))
