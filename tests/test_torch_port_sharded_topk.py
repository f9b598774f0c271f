"""The port's corpus-sharded searches (video_fingerprint_tpu_torch/ops/topk.py:
stage_sharded_corpus, sharded_topk_search, the ring sharded_topk_cosine)
and the index's sharded branch, on the CPU over device lists of d in
{2, 4, 8} entries, against the JAX functions over make_mesh("corpus",
jax.devices()[:d]) (tests/test_topk.py:81-270, :479-843).

Exact: indices equal JAX's and scores within 1e-5 of them, in f32 and bf16
storage (bf16: the cosine domain of the stored rows). Certified, on a
2,048-row corpus with planted near-duplicate clusters, recall_target 0.7 so
the approximate stage fails rows and the exact repair runs: strict gives
the oracle's top-k score multiset (1e-5; 2e-5 in bf16 storage); the
threshold methods ("certified" and "certified-bf16" at 0.95) return every
row above the threshold, with scores within 1e-5 (2e-5) of the true
similarity at their indices. Also: k larger than a shard, a corpus smaller
than the shard count, zero queries, a staged corpus reused, and
certified-bf16 without a threshold refused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.exp_topk_precision import make_corpus
from video_fingerprint_tpu.ops import topk as jax_topk
from video_fingerprint_tpu.parallel.mesh import make_mesh
from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.utils import trace

SHARDS = [2, 4, 8]


@pytest.fixture(scope="module")
def embeddings():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(333, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


def _devices(d):
    return ["cpu"] * d


def _mesh(d):
    return make_mesh("corpus", jax.devices()[:d])


def _np(pair):
    return tuple(np.asarray(x) for x in pair)


def _stored(x, storage):
    """The rows as a search of `storage` sees them (bf16: their unit
    directions after rounding), float64."""
    if storage == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float64)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("d", SHARDS)
def test_sharded_search_exact_matches_jax(embeddings, d, storage):
    q = embeddings[:45] * 1.5  # unnormalized queries: bf16 scores are cosines
    k = 20
    ref_staged = jax_topk.stage_sharded_corpus(
        embeddings, _mesh(d), dtype="bf16" if storage == "bf16" else None)
    s_ref, i_ref = _np(jax_topk.sharded_topk_search(q, ref_staged, k, mesh=_mesh(d),
                                                    method="exact"))
    staged = topk.stage_sharded_corpus(
        embeddings, _devices(d), torch.bfloat16 if storage == "bf16" else torch.float32)
    assert len(staged.shards) == d and staged.shards[0].shape[0] == -(-333 // d)
    s, i = _np(topk.sharded_topk_search(q, staged, k))
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)
    # and equal to the single-device search
    corpus = torch.from_numpy(embeddings)
    s1, i1 = _np(topk.topk_search(torch.from_numpy(q),
                                  corpus.bfloat16() if storage == "bf16" else corpus, k))
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, s1, rtol=0, atol=1e-6)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("d", SHARDS)
def test_ring_exact_matches_jax(embeddings, d, storage):
    k = 20
    if storage == "bf16":
        ref_in, ours_in = (jnp.asarray(embeddings, jnp.bfloat16),
                           torch.from_numpy(embeddings).bfloat16())
    else:
        ref_in, ours_in = embeddings, embeddings
    s_ref, i_ref = _np(jax_topk.sharded_topk_cosine(ref_in, k, mesh=_mesh(d), query_block=64,
                                                    method="exact"))
    s, i = _np(topk.sharded_topk_cosine(ours_in, k, devices=_devices(d)))
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def clustered():
    e = make_corpus(2048, 64, seed=3)
    return e, {s: _stored(e, s) for s in ("f32", "bf16")}


def _check_contract(s, i, sims, k, thr, tol):
    """Strict (thr None): the oracle's top-k score multiset. Threshold:
    every row at or above thr returned (rows with k or more such: the
    oracle's top-k scores). Every returned score is the similarity at its
    index."""
    for row in range(len(s)):
        top = np.sort(sims[row])[::-1][:k]
        want = set(np.flatnonzero(sims[row] >= thr).tolist()) if thr is not None else set()
        if thr is None or len(want) >= k:
            np.testing.assert_allclose(np.sort(s[row])[::-1], top, rtol=0, atol=tol)
        else:
            assert want <= set(i[row].tolist()), (row, want - set(i[row].tolist()))
    np.testing.assert_allclose(s, np.take_along_axis(sims, i, axis=1), rtol=0, atol=tol)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("method,thr", [("certified", None), ("certified", 0.95),
                                        ("certified-bf16", 0.95)],
                         ids=["strict", "threshold", "bf16"])
@pytest.mark.parametrize("d", SHARDS)
def test_certified_contracts_both_paths(clustered, d, method, thr, storage):
    e, stored = clustered
    k, tol = 20, (1e-5 if storage == "f32" else 2e-5)
    dtype = torch.bfloat16 if storage == "bf16" else torch.float32
    staged = topk.stage_sharded_corpus(e, _devices(d), dtype)
    sims = stored[storage] @ stored[storage].T
    before = trace.counter("topk.repaired_rows")
    s, i = _np(topk.sharded_topk_cosine(staged, k, method=method, exact_above=thr,
                                        recall_target=0.7))
    _check_contract(s, i, sims, k, thr, tol)
    q = e[:200]
    s, i = _np(topk.sharded_topk_search(q, staged, k, method=method, exact_above=thr,
                                        recall_target=0.7))
    _check_contract(s, i, sims[:200], k, thr, tol)
    if thr is None:  # the strict certificate fails rows at recall 0.7
        assert trace.counter("topk.repaired_rows") > before


def test_k_past_a_shard_and_tiny_corpus_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    c = rng.normal(size=(13, 16)).astype(np.float32)  # 2 rows per shard, k = 9
    s_ref, i_ref = _np(jax_topk.sharded_topk_search(q, c, 9, mesh=_mesh(8), method="exact"))
    s, i = _np(topk.sharded_topk_search(q, c, 9, devices=_devices(8)))
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)
    e = rng.normal(size=(5, 16)).astype(np.float32)  # fewer rows than shards
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    s_ref, i_ref = _np(jax_topk.sharded_topk_cosine(e, 5, mesh=_mesh(8), query_block=8,
                                                    method="exact"))
    s, i = _np(topk.sharded_topk_cosine(e, 5, devices=_devices(8)))
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)


def test_zero_queries_staged_reuse_and_refusals(embeddings):
    staged = topk.stage_sharded_corpus(embeddings, _devices(8))
    s, i = topk.sharded_topk_search(np.zeros((0, 64), np.float32), staged, 5)
    assert s.shape == (0, 5) and i.shape == (0, 5)
    q = embeddings[:9]
    s1, i1 = topk.sharded_topk_search(q, staged, 5)
    s2, i2 = topk.sharded_topk_search(q, embeddings, 5, devices=_devices(8))
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    for fn in (lambda: topk.sharded_topk_cosine(embeddings, 4, devices=_devices(2),
                                                method="certified-bf16"),
               lambda: topk.sharded_topk_search(q, staged, 4, method="certified-bf16")):
        with pytest.raises(ValueError, match="exact_above"):
            fn()
    with pytest.raises(ValueError, match="k must be"):
        topk.sharded_topk_search(q, staged, 334)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_index_sharded_branch_equals_single_device(embeddings, storage):
    """333 rows >= 8 x 8: the index takes the sharded branch over 8 devices
    (JAX inference/index.py:192-208) and answers as the single-device
    search does; below 8 rows per device it stays on one device."""
    q = embeddings[:17]
    single = FingerprintIndex(dim=64, device="cpu", storage=storage)
    single.add(embeddings)
    s1, i1 = single.search(q, k=10)
    index = FingerprintIndex(dim=64, device="cpu", storage=storage, devices=_devices(8))
    index.add(embeddings)
    s, i = index.search(q, k=10)
    assert index._staged_sharded is not None and index._staged is None
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, s1, rtol=0, atol=1e-6)
    sims = _stored(embeddings[:17], storage) @ _stored(embeddings, storage).T
    np.testing.assert_allclose(s, np.take_along_axis(sims, i, axis=1), rtol=0, atol=2e-5)
    index.add(embeddings[:5])  # a change drops the staged shards
    assert index._staged_sharded is None
    assert index.search(q, k=10)[0].shape == (17, 10)
    small = FingerprintIndex(dim=64, device="cpu", storage=storage, devices=_devices(8))
    small.add(embeddings[:63])
    small.search(q, k=10)
    assert small._staged_sharded is None and small._staged is not None
