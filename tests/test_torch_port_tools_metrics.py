"""The port's streaming-metrics tool (video_fingerprint_tpu_torch/tools/
bench_streaming_metrics.py) against the JAX tool and the JAX package, on
the CPU at n = 3,000 embeddings in 600 groups:

- its clustered corpus is bit-equal to the JAX tool's numpy draws
  (tools/bench_streaming_metrics.py:39-43, repeated here);
- `intra_values`, the port's first pass, equals JAX `_intra_pair_sims`
  (1e-6: the same products summed in another order);
- auc_roc, R@1, mAP and separation_gap equal JAX
  streaming_validation_metrics on that corpus within 1e-6;
- the tool runs end to end with --device cpu and prints the JAX tool's keys.
"""

import json

import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops import metrics as jax_metrics
from video_fingerprint_tpu_torch.ops import metrics as port_metrics
from video_fingerprint_tpu_torch.tools import bench_streaming_metrics as bsm

N, GROUPS, DIM = 3000, 600, 256
KEYS = ("auc_roc", "R@1", "mAP", "separation_gap")


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_tool_draws(n, groups, dim):
    """The JAX tool's corpus, line for line."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((groups, dim)).astype(np.float32)
    ids = rng.integers(0, groups, (n,)).astype(np.int32)
    emb = centers[ids] + 0.35 * rng.standard_normal((n, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, ids


@pytest.fixture(scope="module")
def corpus():
    return bsm.make_corpus(N, GROUPS, DIM)


def test_corpus_is_the_jax_tools(corpus):
    emb, ids = corpus
    ref_emb, ref_ids = _jax_tool_draws(N, GROUPS, DIM)
    assert emb.dtype == ref_emb.dtype and ids.dtype == ref_ids.dtype
    assert np.array_equal(emb, ref_emb) and np.array_equal(ids, ref_ids)


def test_intra_values_match_jax(corpus):
    emb, ids = corpus
    ours = port_metrics.intra_values(torch.from_numpy(emb), torch.from_numpy(ids)).numpy()
    ref = jax_metrics._intra_pair_sims(emb, ids)
    assert ours.shape == ref.shape and ours.shape[0] > N
    assert float(np.abs(ours - ref).max()) <= 1e-6


def test_metrics_match_jax(corpus):
    emb, ids = corpus
    ours = port_metrics.streaming_validation_metrics(emb, ids, block_rows=256, device="cpu")
    ref = jax_metrics.streaming_validation_metrics(emb, ids, block_rows=256)
    for key in KEYS:
        assert abs(ours[key] - ref[key]) <= 1e-6, (key, ours[key], ref[key])
    assert 0.5 < ours["auc_roc"] <= 1.0 and ours["separation_gap"] > 0


def test_tool_runs_on_cpu(capsys):
    assert bsm.main(["--device", "cpu", "--n", str(N), "--groups", str(GROUPS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# backend=cpu n=3000 groups=600 block=256")
    assert any(line.startswith("# intra_pair_sims:") for line in lines)
    out = json.loads(lines[-1])
    assert {"streaming_metrics_n", "streaming_metrics_s", *KEYS, "block_rows",
            "device_mem_per_block_mb", "dense_equivalent_mb"} <= set(out)
    assert out["streaming_metrics_n"] == N and out["streaming_metrics_s"] > 0
    assert out["device_mem_per_block_mb"] == 256 * N * 4 / 1e6
    assert out["dense_equivalent_mb"] == N * N * 4 / 1e6
