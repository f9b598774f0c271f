"""The port's losses (video_fingerprint_tpu_torch/ops/losses.py) against the
JAX package's on the same seeded embeddings: values and gradients (torch
autograd against jax.grad) within 1e-5, f32 on the CPU. Includes a batch
with no positive pair (the triplet term is then 0) and the 3D model's
hard-negative term."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops import losses as jl
from video_fingerprint_tpu_torch.ops import losses as tl

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _unit(rng, n, d=32):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _check(jax_fn, torch_fn, arrays, key=None):
    """Value and grads of jax_fn(*arrays) and torch_fn(*tensors), where a
    dict result is reduced by `key` and a tuple by its first element."""
    def pick(out):
        if isinstance(out, dict):
            return out[key]
        return out[0] if isinstance(out, tuple) else out

    ref, grads = jax.value_and_grad(lambda *a: pick(jax_fn(*a)),
                                    argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    ours = pick(torch_fn(*ts))
    ours.backward()
    np.testing.assert_allclose(float(ours), float(ref), rtol=TOL, atol=TOL)
    for t, g in zip(ts, grads):
        ours_g = t.grad.numpy() if t.grad is not None else np.zeros_like(t.detach().numpy())
        np.testing.assert_allclose(ours_g, np.asarray(g), rtol=TOL, atol=TOL)


def test_pairwise_l2():
    rng = np.random.default_rng(0)
    e = _unit(rng, 6)
    # off the diagonal: a row's distance to itself is a rounded zero
    w = np.arange(36.0, dtype=np.float32).reshape(6, 6) * (1 - np.eye(6, dtype=np.float32))
    _check(lambda x: jnp.sum(jl.pairwise_l2(x) * w),
           lambda x: torch.sum(tl.pairwise_l2(x) * torch.from_numpy(w)), [e])
    # identical rows: the +1e-12 guard keeps the value and the grads finite
    # (the grads there depend on the rounding of a zero distance, so only
    # finiteness is compared)
    e[3] = e[1]
    x = torch.tensor(e, requires_grad=True)
    d = tl.pairwise_l2(x)
    d.sum().backward()
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jl.pairwise_l2(jnp.asarray(e))),
                               atol=1e-3)
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("ids", [[0, 1, 0, 2, 1, 3], [0, 1, 2, 3, 4, 5]],
                         ids=["positives", "no_positives"])
def test_triplet_loss(ids):
    rng = np.random.default_rng(1)
    e = _unit(rng, 6)
    vid = np.asarray(ids, np.int32)
    _check(lambda x: jl.triplet_loss(x, jnp.asarray(vid), 0.3),
           lambda x: tl.triplet_loss(x, torch.from_numpy(vid), 0.3), [e])
    _, n_ref = jl.triplet_loss(jnp.asarray(e), jnp.asarray(vid), 0.3)
    _, n = tl.triplet_loss(torch.from_numpy(e), torch.from_numpy(vid), 0.3)
    assert int(n) == int(n_ref)
    if len(set(ids)) == len(ids):
        assert int(n) == 0


def test_infonce_symmetric():
    rng = np.random.default_rng(2)
    a, b = _unit(rng, 5), _unit(rng, 5)
    t = np.array([0.07], np.float32)
    _check(jl.infonce_symmetric, tl.infonce_symmetric, [a, b, t])


@pytest.mark.parametrize("key", ["loss", "loss_full", "loss_extract", "loss_extract_cross",
                                 "loss_triplet"])
def test_attention_contrastive_loss(key):
    rng = np.random.default_rng(3)
    embs = [_unit(rng, 4) for _ in range(4)]
    t = np.array([0.07], np.float32)
    vid = np.array([0, 1, 0, 2], np.int32)
    _check(lambda *a: jl.attention_contrastive_loss(*a, video_ids=jnp.asarray(vid)),
           lambda *a: tl.attention_contrastive_loss(*a, video_ids=torch.from_numpy(vid)),
           embs + [t], key)


@pytest.mark.parametrize("key", ["loss", "loss_standard", "loss_hard", "loss_triplet"])
def test_cnn3d_contrastive_loss(key):
    """B = 10: k = 3 hard negatives per row, picked on detached logits."""
    rng = np.random.default_rng(4)
    a, b = _unit(rng, 10), _unit(rng, 10)
    t = np.array([0.07], np.float32)
    vid = np.array([0, 1, 2, 3, 4, 0, 5, 6, 7, 8], np.int32)
    _check(lambda *x: jl.cnn3d_contrastive_loss(*x, video_ids=jnp.asarray(vid)),
           lambda *x: tl.cnn3d_contrastive_loss(*x, video_ids=torch.from_numpy(vid)),
           [a, b, t], key)
