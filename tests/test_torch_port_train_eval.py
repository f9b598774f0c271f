"""The port's eval step and its --bf16 train step against the JAX package's,
on the same weights, batch and draws (the small attention model of
test_torch_port_train_step.py: spatial_dim 16, temporal_dim 32, one block,
32x32 frames, T = 8, B = 4, ragged masks; dropout off in both).

Tolerances: eval embeddings 1e-5 absolute, eval losses 1e-5 relative,
accuracy equal. bf16 (params f32, compute bf16 in both packages: flax
dtype=bfloat16, torch autocast): loss 2e-2 relative and grad norm 5e-2
relative for one step; the two frameworks round to bf16 at other places.
"""

from typing import Optional

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training import optim as jax_optim
from video_fingerprint_tpu.training import train_step as jax_ts
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training import optim, train_step
from video_fingerprint_tpu_torch.utils.torch_compat import (
    attention_state_dict_to_variables,
    attention_variables_to_state_dict,
)

B, T, HW = 4, 8, 32
DIMS = dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _NoDropout(flax.linen.Module):
    rate: float = 0.0
    deterministic: Optional[bool] = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(autouse=True)
def _no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


@pytest.fixture(scope="module")
def setup():
    """The port's seeded init in flax layout with random BN running
    statistics, and a uint8 batch with ragged masks."""
    torch.manual_seed(1)
    sd = {k: v.detach().numpy() for k, v in create_model("attention", **DIMS).state_dict().items()}
    v = attention_state_dict_to_variables(sd)
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    clips = rng.integers(0, 256, (2, B, T, HW, HW, 3), dtype=np.uint8)
    masks = np.ones((2, B, T), bool)
    masks[0, 2, 4:] = False
    masks[1, 0, 6:] = False
    clips[~masks] = 0
    batch = {"clip1": clips[0], "clip2": clips[1], "mask1": masks[0], "mask2": masks[1],
             "video_id": np.array([0, 1, 2, 1], np.int32)}
    return {"params": v["params"], "batch_stats": stats}, batch


def _port_model(variables):
    m = create_model("attention", **DIMS)
    sd = attention_variables_to_state_dict(variables)
    m.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()}, strict=True)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return m


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}


def _draws(k_len, e_rng1, e_rng2):
    return {"lengths": torch.from_numpy(np.asarray(
                jax_ts.sample_extract_lengths(k_len, B, T, 0.5)).astype(np.int64)),
            "u1": torch.from_numpy(np.asarray(jax.random.uniform(e_rng1, (B,)))),
            "u2": torch.from_numpy(np.asarray(jax.random.uniform(e_rng2, (B,))))}


@pytest.mark.parametrize("reuse", [True, False], ids=["reuse", "pixels"])
def test_eval_step_matches_jax(setup, reuse):
    """Loss, embeddings and accuracy of the eval step (the attention runs
    through the kernel's plain version on the CPU)."""
    variables, batch = setup
    model = jax_create_model("attention", **DIMS)
    eval_fn = jax.jit(jax_ts.make_eval_step(model, "attention",
                                            reuse_extract_features=reuse))
    rng = jax.random.PRNGKey(11)
    ref, e1, e2 = eval_fn(variables["params"], variables["batch_stats"], batch, rng)
    port = _port_model(variables)
    ours, o1, o2 = train_step.make_eval_step(port, "attention", reuse_extract_features=reuse)(
        _torch_batch(batch), _draws(*jax.random.split(rng, 3)))
    np.testing.assert_allclose(o1.numpy(), np.asarray(e1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(o2.numpy(), np.asarray(e2), rtol=0, atol=1e-5)
    for key in ("loss", "loss_full", "loss_extract", "loss_extract_cross"):
        np.testing.assert_allclose(float(ours[key]), float(ref[key]), rtol=1e-5)
    assert float(ours["acc"]) == float(ref["acc"])


def test_bf16_train_step_matches_jax_bf16(setup):
    """--bf16: one step of the bf16 model in both packages (step 5 of a
    10-step schedule, so the LR is not 0), params kept in f32."""
    variables, batch = setup
    model = jax_create_model("attention", dtype=jnp.bfloat16, **DIMS)
    tx = jax_optim.make_optimizer("attention", variables["params"], 1e-3, total_steps=10)
    state = jax_ts.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              step=jnp.asarray(5, jnp.int32))
    rng = jax.random.PRNGKey(5)
    new_state, ref = jax.jit(jax_ts.make_train_step(model, tx, "attention"))(state, batch, rng)

    _, e_rng1, _ = jax.random.split(jax.random.fold_in(rng, 5), 3)
    port = _port_model(variables)
    opt = optim.make_optimizer("attention", port, 1e-3, total_steps=10)
    ours = train_step.make_train_step(port, opt, "attention", bf16=True)(
        _torch_batch(batch), _draws(*jax.random.split(e_rng1, 3)), 5)
    np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]), rtol=2e-2)
    np.testing.assert_allclose(float(ours["grad_norm"]), float(ref["grad_norm"]), rtol=5e-2)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(np.asarray(x).dtype == np.float32
               for x in jax.tree_util.tree_leaves(new_state.params))
    assert all(torch.isfinite(p).all() for p in port.parameters())


def test_remat_equals_plain_forward(setup):
    """--remat recomputes each forward in the backward: the same loss,
    grads and BatchNorm running statistics as the stored-activation step
    (the running statistics updated once), for both extract paths."""
    variables, batch = setup
    rng = jax.random.PRNGKey(5)
    draws = _draws(*jax.random.split(rng, 3))
    for reuse in (False, True):
        results = []
        for remat in (False, True):
            port = _port_model(variables).train()
            loss, _ = train_step.make_loss_fn(port, "attention", remat=remat,
                                              reuse_extract_features=reuse)(
                _torch_batch(batch), draws)
            loss.backward()
            results.append((loss.item(),
                            [p.grad.clone() for p in port.parameters()],
                            [b.clone() for n, b in port.named_buffers() if "running" in n]))
        (l0, g0, s0), (l1, g1, s1) = results
        assert l0 == pytest.approx(l1, rel=1e-6)
        for a, b in zip(g0 + s0, g1 + s1):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
