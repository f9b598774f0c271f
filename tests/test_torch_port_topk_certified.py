"""The port's certified top-k methods (video_fingerprint_tpu_torch/ops/
topk.py, method="certified" / "certified-bf16") against the contracts of
the JAX package's (video_fingerprint_tpu/ops/topk.py:487-634), on the CPU.

Mirrors tests/test_topk.py: the strict certificate returns exact's score
multiset; the threshold certificate returns every row above the threshold;
certified-bf16 is complete above the threshold, requires one, widens its
certificate by the bf16 error bound, and reports f32 re-scored scores
(within 1e-5 of the true similarity, 2e-5 in bf16 storage's cosine
domain); the re-score sorts and keeps -inf; bf16 storage works in the
cosine domain of the bf16-rounded queries and stored rows. The port's own:
the bin count equals XLA's for approx_max_k, a small L makes the
approximate stage fail rows that the exact repair then fixes, and corpus
blocks smaller than the corpus make a row's certificate the AND over its
blocks.
"""

import numpy as np
import pytest
import torch

from tools.exp_topk_precision import make_corpus
from video_fingerprint_tpu.ops import topk as jax_topk
from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.utils import trace


@pytest.fixture(scope="module")
def embeddings():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(333, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(topk, "QUERY_BLOCK", 128)


def _bf16(x: np.ndarray) -> np.ndarray:
    """The f32 values of x rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def _qdirs(x: np.ndarray) -> np.ndarray:
    """Directions of the bf16-stored rows, in float64."""
    q = _bf16(x).astype(np.float64)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _search(queries, corpus, k, **kw):
    s, i = topk.topk_search(torch.from_numpy(queries) if isinstance(queries, np.ndarray)
                            else queries,
                            torch.from_numpy(corpus) if isinstance(corpus, np.ndarray)
                            else corpus, k, **kw)
    return s.numpy(), i.numpy()


def _complete(s, i, sims, k, thr, tol):
    """Every row's candidates hold all corpus rows with sim >= thr (rows
    with k or more such: the true top-k score multiset)."""
    for row in range(len(sims)):
        want = set(np.flatnonzero(sims[row] >= thr).tolist())
        if len(want) >= k:
            top = np.sort(sims[row])[::-1][:k]
            np.testing.assert_allclose(np.sort(s[row])[::-1], top, atol=tol)
        else:
            got = {int(j) for ss, j in zip(s[row], i[row]) if ss >= thr - tol}
            assert want <= got, (row, want - got)


@pytest.mark.parametrize("n,k,recall", [(65536, 20, 0.99), (65536, 20, 0.95),
                                        (16960, 20, 0.99), (1_000_000, 20, 0.95),
                                        (333, 20, 0.7), (600, 20, 0.95), (1000, 1, 0.95),
                                        (4096, 64, 0.9)])
def test_approx_bins_equal_xla(n, k, recall):
    from jax._src.lib import _jax

    xla = _jax.approx_top_k_reduction_output_size(n, 2, k, recall, False)[0]
    assert topk.approx_bins(n, k, recall) == xla


def test_certified_strict_matches_exact(embeddings, small_tiles):
    """The strict certificate returns exact's per-row score multiset, and
    the scores are the sims at the returned indices (JAX
    tests/test_topk.py:34-49)."""
    k = 20
    s_ref, _ = _search(embeddings, embeddings, k, method="exact")
    s, i = _search(embeddings, embeddings, k, method="certified")
    np.testing.assert_array_equal(np.sort(s, axis=1), np.sort(s_ref, axis=1))
    sims = embeddings @ embeddings.T
    np.testing.assert_allclose(np.sort(np.take_along_axis(sims, i, axis=1), 1),
                               np.sort(s, 1), atol=1e-6)
    js, _ = jax_topk.topk_cosine(embeddings, k, query_block=128, method="certified")
    np.testing.assert_allclose(np.sort(s, 1), np.sort(np.asarray(js), 1), atol=1e-6)


def test_certified_threshold_complete(small_tiles):
    """With exact_above, every corpus row >= thr is among a row's candidates
    on a corpus with planted near-duplicate clusters (JAX
    tests/test_topk.py:52-78)."""
    e = make_corpus(600, 64, seed=3)
    k, thr = 20, 0.95
    s, i = _search(e, e, k, method="certified", exact_above=thr)
    sims = e @ e.T
    assert (sims >= thr).sum(axis=1).max() > 1  # the threshold bites
    _complete(s, i, sims, k, thr, 1e-6)


def test_certified_bf16_threshold_complete(small_tiles):
    """certified-bf16 keeps completeness above thr and reports re-scored f32
    scores, sorted descending (JAX tests/test_topk.py:380-412)."""
    e = make_corpus(600, 64, seed=3)
    k, thr = 20, 0.95
    s, i = _search(e, e, k, method="certified-bf16", exact_above=thr)
    sims = e @ e.T
    _complete(s, i, sims, k, thr, 1e-5)
    live = np.isfinite(s)
    np.testing.assert_allclose(s[live], np.take_along_axis(sims, i, axis=1)[live], atol=1e-5)
    assert (np.diff(s, axis=1) <= 1e-6).all()


def test_certified_bf16_widens_certificate():
    """Rows whose items fall inside (thr - eps, thr), reachable by bf16
    noise, cannot self-certify when k or more such items exist (JAX
    tests/test_topk.py:415-446)."""
    rng = np.random.default_rng(11)
    dim, thr = 64, 0.95
    base = rng.normal(size=dim)
    base /= np.linalg.norm(base)
    target = thr - topk._BF16_DOT_EPS / 2
    others = []
    for _ in range(30):
        noise = rng.normal(size=dim)
        noise -= (noise @ base) * base
        noise /= np.linalg.norm(noise)
        others.append(target * base + np.sqrt(1 - target ** 2) * noise)
    corpus = np.asarray([base] + others, np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    p = topk._Problem(torch.from_numpy(corpus[:1]), torch.from_numpy(corpus))
    _, _, ok = topk._certified(p, 8, 0.95, thr, lowp=True)
    assert not bool(ok[0])
    sims = corpus[:1] @ corpus.T
    assert (sims >= thr).sum() == 1 and (sims >= thr - topk._BF16_DOT_EPS).sum() > 8
    # the search still answers exactly for that row: the repair ran
    before = trace.counter("topk.repaired_rows")
    s, i = _search(corpus[:1], corpus, 8, method="certified-bf16", exact_above=thr)
    assert trace.counter("topk.repaired_rows") == before + 1
    np.testing.assert_allclose(s[0], np.sort(sims[0])[::-1][:8], atol=1e-6)


def test_certified_bf16_requires_threshold_and_methods_are_checked():
    e = torch.eye(8, 16)
    with pytest.raises(ValueError, match="exact_above"):
        topk.topk_cosine(e, 2, method="certified-bf16")
    with pytest.raises(ValueError, match="unknown top-k method"):
        topk.topk_cosine(e, 2, method="approx")


def test_auto_is_exact(embeddings):
    e = torch.from_numpy(embeddings)
    before = trace.counter("topk.repaired_rows")
    for a, b in zip(topk.topk_cosine(e, 10, exact_above=0.9),
                    topk.topk_cosine(e, 10, exact_above=0.9, method="exact")):
        assert torch.equal(a, b)
    assert trace.counter("topk.repaired_rows") == before


def test_rescore_sorts_and_keeps_neginf():
    """JAX tests/test_topk.py:458-476."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(37, 16)).astype(np.float32)
    corpus = rng.normal(size=(50, 16)).astype(np.float32)
    k = 6
    idx = np.stack([rng.choice(50, size=k, replace=False) for _ in range(37)])
    scores = (q[:, None, :] * corpus[idx]).sum(-1).astype(np.float32)
    scores[1::2, -1] = -np.inf
    p = topk._Problem(torch.from_numpy(q), torch.from_numpy(corpus))
    s2, i2 = (t.numpy() for t in topk._rescore(p, torch.from_numpy(scores),
                                               torch.from_numpy(idx)))
    assert (np.diff(s2, axis=1) <= 1e-6).all()
    assert np.isneginf(s2[1::2, -1]).all()
    live = np.isfinite(s2)
    true = (q[:, None, :] * corpus[i2]).sum(-1)
    np.testing.assert_allclose(s2[live], true[live], rtol=1e-5, atol=1e-5)


def test_bf16_storage_certified_matches_exact(embeddings, small_tiles):
    """Strict certificate and repair on a bf16 corpus: exact's score
    multiset of the stored vectors (recall 0.7 forces repairs; JAX
    tests/test_topk.py:729-741)."""
    e16 = torch.from_numpy(embeddings).to(torch.bfloat16)
    k = 20
    s_ref, _ = _search(e16, e16, k, method="exact")
    before = trace.counter("topk.repaired_rows")
    s, _ = _search(e16, e16, k, method="certified", recall_target=0.7)
    assert trace.counter("topk.repaired_rows") > before
    np.testing.assert_allclose(np.sort(s, 1), np.sort(s_ref, 1), atol=1e-6)
    sims = _qdirs(embeddings) @ _qdirs(embeddings).T
    o = np.take_along_axis(sims, np.argsort(-sims, axis=1)[:, :k], axis=1)
    np.testing.assert_allclose(np.sort(s, 1), np.sort(o, 1), atol=2e-5)


def test_bf16_storage_certified_bf16_complete(small_tiles):
    """JAX tests/test_topk.py:744-774: complete above thr against the
    quantized truth, scores within 2e-5 of the quantized sims."""
    e = make_corpus(600, 64, seed=5)
    eq = _qdirs(e)
    e16 = torch.from_numpy(e).to(torch.bfloat16)
    k, thr = 20, 0.95
    s, i = _search(e16, e16, k, method="certified-bf16", exact_above=thr)
    sims = eq @ eq.T
    _complete(s, i, sims, k, thr, 2e-5)
    live = np.isfinite(s)
    np.testing.assert_allclose(s[live], np.take_along_axis(sims, i, axis=1)[live], atol=2e-5)


def test_rescore_uses_quantized_query_domain(small_tiles):
    """JAX tests/test_topk.py:877-920: off-grid f32 queries against a bf16
    corpus score in cos(bf16 query, stored direction), the domain of the
    certificate and of the repairs."""
    e = make_corpus(600, 64, seed=11)
    rng = np.random.default_rng(7)
    q = e[:80] + 1e-3 * rng.normal(size=(80, e.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k, thr = 20, 0.95
    s, i = _search(q, torch.from_numpy(e).to(torch.bfloat16), k, method="certified-bf16",
                   exact_above=thr)
    sims = _qdirs(q) @ _qdirs(e).T
    live = np.isfinite(s)
    np.testing.assert_allclose(s[live], np.take_along_axis(sims, i, axis=1)[live], atol=2e-5)
    for row in range(len(q)):
        want = set(np.flatnonzero(sims[row] >= thr).tolist())
        if len(want) < k:
            got = {int(j) for ss, j in zip(s[row], i[row]) if ss >= thr - 2e-5}
            assert want <= got, (row, want - got)


@pytest.mark.parametrize("method,kw", [("exact", {}), ("certified", {"recall_target": 0.7}),
                                       ("certified-bf16", {"exact_above": 0.999999})])
def test_bf16_identical_rows_score_one(method, kw):
    """Byte-identical stored rows score 1.0 within an f32 ulp on every path
    (JAX tests/test_topk.py:679-708)."""
    rng = np.random.default_rng(23)
    e = rng.normal(size=(64, 32)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[17] = e[3]
    e16 = torch.from_numpy(e).to(torch.bfloat16)
    s, i = _search(e16, e16, 2, method=method, **kw)
    assert set(i[3].tolist()) == {3, 17}
    np.testing.assert_allclose(s[3], [1.0, 1.0], atol=1e-6)


@pytest.mark.parametrize("thr", [None, 0.25], ids=["strict", "threshold"])
def test_small_bins_fail_rows_and_the_repair_fixes_them(thr, small_tiles):
    """recall 0.3 with k = 20 makes L small (256 bins for 600 columns), so
    the approximate stage misses elements and fails rows (at a threshold of
    0.25, about 2 standard deviations of a random 64-d cosine, a row has
    some 14 elements above it to collide); the repaired result meets the
    contract anyway."""
    e = make_corpus(600, 64, seed=3)
    k = 20
    assert topk.approx_bins(600, k, 0.3) < 600
    p = topk._Problem(torch.from_numpy(e), torch.from_numpy(e))
    with torch.no_grad():
        _, _, ok = topk._certified(p, k, 0.3, thr, lowp=False)
    failed = int((~ok).sum())
    assert failed > 50
    before = trace.counter("topk.repaired_rows")
    s, i = _search(e, e, k, method="certified", exact_above=thr, recall_target=0.3)
    assert trace.counter("topk.repaired_rows") - before == failed
    s_ref, _ = _search(e, e, k, method="exact")
    if thr is None:
        np.testing.assert_array_equal(np.sort(s, 1), np.sort(s_ref, 1))
    else:
        _complete(s, i, e @ e.T, k, thr, 1e-6)


@pytest.mark.parametrize("method,thr", [("certified", None), ("certified", 0.25),
                                        ("certified-bf16", 0.25)])
def test_blocks_smaller_than_the_corpus(monkeypatch, method, thr):
    """Corpus blocks of 300 rows over 600 (256 bins each at recall 0.7):
    each (tile, block) pair is certified on its own and a row only when
    both its blocks are (the ok vector equals the AND of the per-block
    certificates computed here, and some rows pass one block and fail the
    other); the merged, repaired result meets the contract."""
    block, tile = 300, 64
    monkeypatch.setattr(topk, "QUERY_BLOCK", tile)
    monkeypatch.setattr(topk, "CORPUS_BLOCK", block)
    e = make_corpus(600, 64, seed=3)
    k, recall, lowp = 20, 0.7, method == "certified-bf16"
    assert topk.approx_bins(block, k, recall) < block
    p = topk._Problem(torch.from_numpy(e), torch.from_numpy(e))
    _, _, ok = topk._certified(p, k, recall, thr, lowp)
    per_block = []
    for clo in range(0, 600, block):
        tiles = []
        for qlo in range(0, 600, tile):
            sims = p.sims_bf16(qlo, clo) if lowp else p.sims(qlo, clo)
            s, _ = topk._approx_topk(sims, k, recall)
            tiles.append(topk._certificate(sims, s, k, thr, lowp, topk._BF16_DOT_EPS))
        per_block.append(torch.cat(tiles))
    stacked = torch.stack(per_block)
    assert torch.equal(ok, stacked.all(dim=0))
    assert bool((stacked.any(dim=0) & ~stacked.all(dim=0)).any())
    before = trace.counter("topk.repaired_rows")
    s, i = _search(e, e, k, method=method, exact_above=thr, recall_target=recall)
    assert trace.counter("topk.repaired_rows") - before == int((~ok).sum()) > 0
    if thr is None:
        s_ref, _ = _search(e, e, k, method="exact")
        np.testing.assert_array_equal(np.sort(s, 1), np.sort(s_ref, 1))
    else:
        _complete(s, i, e @ e.T, k, thr, 1e-5)
