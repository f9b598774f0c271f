"""The port's validation metrics (video_fingerprint_tpu_torch/ops/metrics.py)
against the JAX package's: dense and streaming, on embeddings whose
similarities are exact in f32 and full of ties (entries k/4 with small
integers k), so the tie-corrected AUC, R@k and the stable-order mAP are
compared exactly (within 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest

from video_fingerprint_tpu.ops import metrics as jm
from video_fingerprint_tpu_torch.ops import metrics as tm

TOL = 1e-6


def _tied(n=70, d=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n // 3, n).astype(np.int32)
    base = rng.integers(-2, 3, (n // 3, d)).astype(np.float32) / 4
    emb = base[ids] + rng.integers(-1, 2, (n, d)).astype(np.float32) / 4
    emb[5] = emb[6]  # an exact duplicate row
    return emb, ids


def _jax_dense(emb, ids):
    out = {k: float(v) for k, v in jm.discrimination_metrics(jnp.asarray(emb),
                                                              jnp.asarray(ids)).items()}
    out.update({k: float(v) for k, v in jm.retrieval_metrics(jnp.asarray(emb),
                                                             jnp.asarray(ids)).items()})
    return out


def _compare(ours, ref):
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=TOL, atol=TOL, err_msg=k)


def test_dense_matches_jax():
    emb, ids = _tied()
    ours = tm.discrimination_metrics(emb, ids)
    ours.update(tm.retrieval_metrics(emb, ids))
    _compare(ours, _jax_dense(emb, ids))


@pytest.mark.parametrize("block_rows", [16, 256])
def test_streaming_matches_dense_jax_and_streaming_jax(block_rows):
    """Block sizes below and above N: the streaming metrics equal the JAX
    package's dense metrics and its own streaming path."""
    emb, ids = _tied()
    ours = tm.streaming_validation_metrics(emb, ids, block_rows=block_rows)
    _compare(ours, _jax_dense(emb, ids))
    _compare(ours, jm.streaming_validation_metrics(emb, ids, block_rows=block_rows))


def test_weighted_auc_ties():
    scores = np.array([0.5, 0.5, 0.2, 0.9, 0.2, 0.5], np.float32)
    pos = np.array([1, 0, 1, 1, 0, 0], np.float32)
    ref = float(jm.weighted_auc(jnp.asarray(scores), jnp.asarray(pos), jnp.asarray(1 - pos)))
    import torch

    ours = float(tm.weighted_auc(torch.from_numpy(scores), torch.from_numpy(pos),
                                 torch.from_numpy(1 - pos)))
    assert ours == pytest.approx(ref, abs=TOL)


def test_no_positive_pairs():
    """Every id distinct: no intra pairs, AUC 0.5, R@k 0, in both paths."""
    rng = np.random.default_rng(1)
    emb = rng.integers(-2, 3, (12, 8)).astype(np.float32) / 4
    ids = np.arange(12, dtype=np.int32)
    dense = tm.discrimination_metrics(emb, ids)
    dense.update(tm.retrieval_metrics(emb, ids))
    _compare(dense, _jax_dense(emb, ids))
    _compare(tm.streaming_validation_metrics(emb, ids, block_rows=5), dense)
