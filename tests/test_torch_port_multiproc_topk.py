"""The port's corpus-sharded searches across processes (ops/topk.py under a
torch.distributed group; JAX `_replicate_for_host`, ops/topk.py:827-849,
and the process_count() > 1 branches at :929-933 and :1059-1065), on the
CPU with W in {2, 4} gloo ranks spawned through tests/torch_port_ranks.py,
one spawn per W for every case.

Every rank passes the same corpus and queries and stages only its block of
ceil(N / W) rows. Gates:

  - exact, f32 and bf16 storage, the query search and the ring: indices
    equal JAX's sharded functions over an in-process CPU mesh of the same
    shard count (tests/test_topk.py's functions; JAX's own multi-process
    test is slow-marked) and the port's one-process search, scores within
    1e-5 of both;
  - certified (strict, and at recall 0.7 so the repair runs), certified at
    0.95 and certified-bf16 at 0.95, both storages, both searches: strict
    gives the oracle's top-k score multiset, the threshold methods every
    row above 0.95, scores within 1e-5 (2e-5 in bf16 storage) of the true
    similarity at their indices (test_torch_port_sharded_topk.py's
    contracts);
  - N not divisible by W, k larger than a rank's block, a corpus with fewer
    rows than shards (a rank holds none), zero queries, two devices per
    rank: equal to JAX;
  - every rank's result identical, the blocks disjoint and covering N;
  - FingerprintIndex.search and the scanner's duplicate groups under W
    ranks equal one process's;
  - the collectives alone; the ported run_dedup worker under
    `torch.distributed.run` with 2 ranks prints its OK line.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.torch_port_ranks import REPO_ROOT, run_ranks
from tools.exp_topk_precision import make_corpus
from video_fingerprint_tpu.ops import topk as jax_topk
from video_fingerprint_tpu.parallel.mesh import make_mesh
from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.training.checkpoint import save_checkpoint
from video_fingerprint_tpu_torch.utils.torch_compat import state_dict_to_variables

WORLDS = [2, 4]
STORAGES = ["f32", "bf16"]
CERTIFIED = {"strict": ("certified", None), "threshold": ("certified", 0.95),
             "bf16": ("certified-bf16", 0.95)}
K = 20


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _arrays():
    rng = np.random.default_rng(0)
    e = _unit(rng.normal(size=(333, 64)))
    small = np.random.default_rng(2)
    dup_rng = np.random.default_rng(4)
    dup = dup_rng.normal(size=(80, 256))
    dup[40:50] = dup[:10] + 0.01 * dup_rng.normal(size=(10, 256))  # planted near copies
    dup = _unit(dup)
    clustered = make_corpus(2048, 64, seed=3)
    return {"embeddings": e, "queries": e[:45] * 1.5, "clustered": clustered,
            "clustered_q": clustered[:200],
            "c13": small.normal(size=(13, 16)).astype(np.float32),
            "q3": small.normal(size=(3, 16)).astype(np.float32),
            "e3": _unit(small.normal(size=(3, 16))),
            "q0": np.zeros((0, 64), np.float32), "dup": dup}


def _case(name, kind, corpus, k, storage="f32", method="exact", thr=None, recall=None,
          queries=None, local=1):
    return {"name": name, "kind": kind, "corpus": corpus, "queries": queries, "k": k,
            "storage": storage, "method": method, "thr": thr, "recall": recall,
            "local": local}


def _cases():
    out = []
    for storage in STORAGES:
        out.append(_case(f"search_{storage}", "search", "embeddings", K, storage,
                         queries="queries"))
        out.append(_case(f"ring_{storage}", "ring", "embeddings", K, storage))
        for label, (method, thr) in CERTIFIED.items():
            for kind in ("search", "ring"):
                out.append(_case(f"{kind}_{label}_{storage}", kind, "clustered", K, storage,
                                 method, thr, 0.7, queries="clustered_q"))
    out += [_case("k_past_block", "search", "c13", 9, queries="q3"),
            _case("tiny_ring", "ring", "e3", 3),
            _case("zero_queries", "search", "embeddings", 5, queries="q0"),
            _case("two_local_search", "search", "embeddings", K, queries="queries", local=2),
            _case("two_local_ring", "ring", "embeddings", K, local=2)]
    return out


ARRAYS = _arrays()
CASES = {c["name"]: c for c in _cases()}


def _fingerprints():
    return {f"v{i:02d}": {"embedding": ARRAYS["dup"][i], "path": f"v{i:02d}",
                          "file_hash": str(i)} for i in range(80)}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A small attention checkpoint for the scanner (its model never runs)."""
    torch.manual_seed(0)
    dims = dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)
    model = create_model("attention", **dims)
    sd = {k: v.numpy() for k, v in model.state_dict().items() if k != "pos_encoding.pe"}
    v = state_dict_to_variables(sd, "attention")
    path = tmp_path_factory.mktemp("ckpt") / "m.ckpt"
    save_checkpoint(path, v["params"], v["batch_stats"],
                    {"model_type": "attention", "frame_size": 64, "max_frames": 500,
                     "embedding_dim": 256, **dims})
    return str(path)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"W{w}")
def ranks(request, checkpoint, tmp_path_factory):
    world = request.param
    inputs = {"arrays": ARRAYS, "cases": list(CASES.values()), "checkpoint": checkpoint,
              "fingerprints": _fingerprints()}
    outs = run_ranks("search", world, tmp_path_factory.mktemp(f"search{world}"), inputs,
                     timeout=300)
    return world, outs


def _got(ranks, name):
    _, outs = ranks
    r0 = outs[0]["cases"][name]
    return r0["scores"], r0["idx"]


def _jax(case, shards):
    """JAX's sharded function over a mesh of `shards` CPU devices."""
    mesh = make_mesh("corpus", jax.devices()[:shards])
    corpus = ARRAYS[case["corpus"]]
    dtype = "bf16" if case["storage"] == "bf16" else None
    if case["kind"] == "ring":
        x = jax.numpy.asarray(corpus, jax.numpy.bfloat16) if dtype else corpus
        s, i = jax_topk.sharded_topk_cosine(x, case["k"], mesh=mesh, query_block=64,
                                            method="exact")
    else:
        staged = jax_topk.stage_sharded_corpus(corpus, mesh, dtype=dtype)
        s, i = jax_topk.sharded_topk_search(ARRAYS[case["queries"]], staged, case["k"],
                                            mesh=mesh, method="exact")
    return np.asarray(s), np.asarray(i)


def _one_process(case):
    corpus = torch.from_numpy(ARRAYS[case["corpus"]])
    if case["storage"] == "bf16":
        corpus = corpus.bfloat16()
    q = corpus if case["kind"] == "ring" else torch.from_numpy(ARRAYS[case["queries"]])
    s, i = topk.topk_search(q, corpus, case["k"], method="exact")
    return s.numpy(), i.numpy()


def _check_exact(ranks, name, shards):
    case = CASES[name]
    s, i = _got(ranks, name)
    s_ref, i_ref = _jax(case, shards)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5)
    s1, i1 = _one_process(case)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, s1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("storage", STORAGES)
def test_search_exact_matches_jax_and_one_process(ranks, storage):
    _check_exact(ranks, f"search_{storage}", ranks[0])


@pytest.mark.parametrize("storage", STORAGES)
def test_ring_exact_matches_jax_and_one_process(ranks, storage):
    _check_exact(ranks, f"ring_{storage}", ranks[0])


def _stored(x, storage):
    if storage == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float64)


def _check_contract(s, i, sims, k, thr, tol):
    """Strict (thr None): the oracle's top-k score multiset. Threshold:
    every row at or above thr returned (rows with k or more such: the
    oracle's top-k scores). Every score the similarity at its index."""
    for row in range(len(s)):
        top = np.sort(sims[row])[::-1][:k]
        want = set(np.flatnonzero(sims[row] >= thr).tolist()) if thr is not None else set()
        if thr is None or len(want) >= k:
            np.testing.assert_allclose(np.sort(s[row])[::-1], top, rtol=0, atol=tol)
        else:
            assert want <= set(i[row].tolist()), (row, want - set(i[row].tolist()))
    np.testing.assert_allclose(s, np.take_along_axis(sims, i, axis=1), rtol=0, atol=tol)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("label", list(CERTIFIED))
def test_certified_contracts(ranks, label, storage):
    _, thr = CERTIFIED[label]
    tol = 1e-5 if storage == "f32" else 2e-5
    stored = _stored(ARRAYS["clustered"], storage)
    sims = stored @ stored.T
    for kind, rows in (("ring", sims), ("search", sims[:200])):
        name = f"{kind}_{label}_{storage}"
        s, i = _got(ranks, name)
        _check_contract(s, i, rows, K, thr, tol)
        repaired = {out["cases"][name]["repaired"] for out in ranks[1]}
        assert len(repaired) == 1, (name, repaired)  # every rank repaired the same rows
        if thr is None:  # the strict certificate fails rows at recall 0.7
            assert repaired.pop() > 0, name


def test_k_past_a_block_tiny_corpus_and_zero_queries(ranks):
    world = ranks[0]
    _check_exact(ranks, "k_past_block", world)  # 13 rows: a block of 7 or 4, k = 9
    _check_exact(ranks, "tiny_ring", world)  # 3 rows over W ranks
    if world == 4:  # the last rank holds no row
        assert ranks[1][3]["cases"]["tiny_ring"]["held"] == [(3, 0)]
    s, i = _got(ranks, "zero_queries")
    assert s.shape == (0, 5) and i.shape == (0, 5) and i.dtype == np.int64


def test_two_devices_per_rank_match_jax(ranks):
    world = ranks[0]
    for name in ("two_local_search", "two_local_ring"):
        _check_exact(ranks, name, 2 * world)
        assert len(ranks[1][0]["cases"][name]["held"]) == 2


def test_every_rank_identical_and_blocks_disjoint(ranks):
    world, outs = ranks
    for name, case in CASES.items():
        for r in range(1, world):
            for key in ("scores", "idx"):
                np.testing.assert_array_equal(outs[r]["cases"][name][key],
                                              outs[0]["cases"][name][key], err_msg=name)
        n = len(ARRAYS[case["corpus"]])
        block = -(-n // world)
        held = [span for out in outs for span in out["cases"][name]["held"] if span[1]]
        covered = sorted(row for start, count in held for row in range(start, start + count))
        assert covered == list(range(n)), name
        for r, out in enumerate(outs):
            for start, count in out["cases"][name]["held"]:
                assert count == 0 or r * block <= start < start + count <= (r + 1) * block


def test_index_and_scanner_equal_one_process(ranks, checkpoint, capsys):
    world, outs = ranks
    for storage in STORAGES:
        single = FingerprintIndex(dim=64, device="cpu", storage=storage)
        single.add(ARRAYS["embeddings"])
        s1, i1 = single.search(ARRAYS["queries"], k=10)
        for out in outs:
            got = out["index"][storage]
            assert got["sharded"], storage  # 333 rows >= 8 x W shards
            np.testing.assert_array_equal(got["idx"], i1)
            np.testing.assert_allclose(got["scores"], s1, rtol=0, atol=1e-6)
    scanner = FingerprintScanner(checkpoint, device="cpu")
    groups = scanner.find_duplicates(_fingerprints(), 0.99, topk_threshold=10)
    want = sorted(sorted(item["path"] for item in g) for g in groups)
    assert want == [[f"v{i:02d}", f"v{i + 40:02d}"] for i in range(10)]
    for out in outs:
        assert out["scanner"]["ring_calls"] == 1  # 80 videos >= 8 x W shards
        assert out["scanner"]["groups"] == want


def test_collectives(ranks):
    world, outs = ranks
    for r, out in enumerate(outs):
        c = out["collectives"]
        assert torch.equal(c["gather"], torch.stack([torch.arange(5) + 10 * j
                                                     for j in range(world)]))
        assert c["and"].tolist() == [True, False, True]
        assert c["sum"].tolist() == [float(sum(range(world))), float(world)]
        assert c["shift"].tolist() == [float((r - 1) % world)] * 3


def test_multiproc_dedup_worker_under_the_launcher():
    """The port of JAX tools/multihost_smoke_worker.py::run_dedup (JAX
    tests/test_multihost.py:147) under torch.distributed.run, 2 gloo ranks."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "video_fingerprint_tpu_torch.tools.multiproc_dedup", "--device", "cpu"],
        cwd=REPO_ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("sharded dedup over 2 processes OK") == 2, proc.stdout
