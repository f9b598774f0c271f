"""The port's train and eval steps (video_fingerprint_tpu_torch/training)
against the JAX package's, on the same weights, batch and random draws.

A small attention model (spatial_dim 16, temporal_dim 32: 8 heads of D = 4,
one attention block, 32x32 frames, T = 8, B = 4, ragged masks) runs two
train steps in both packages, f32 on the CPU, with dropout off (the JAX
package's flax.linen.Dropout replaced by an identity for the test, the
port's rate set to 0) and the JAX step's extract draws fed to the port.
Tolerances: loss 1e-5 relative and grad norm 1e-4 relative at each step;
the AdamW moments after the first step (which runs at LR 0, so they hold
the clipped grads) 2e-2 relative in global L2 norm, and the counts equal;
the BatchNorm running statistics and the params after two steps 1e-4
absolute. An Adam step divides the first moment by the root of the second,
so an element with a grad near 0 turns rounding differences into steps
that differ by a fraction of the LR: up to 0.1 % of the param elements may
lie past 1e-4, all within twice the LR.

Why the moments' tolerance: the train-mode BatchNorm backward reduces over
every frame and pixel of the batch (16,384 values per channel at the first
conv here) in f32, and on the CPU that error depends on the summation
order: the port's own spatial-encoder grads move by percents between one
and eight threads. Loss and grad norm are scalars that average it out. The
measured gap of the moments here is 7.6e-3.
"""

import re
from typing import Optional

import flax.linen
from flax import serialization
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
    adamw_to_opt_state,
    attention_state_dict_to_variables,
    attention_variables_to_state_dict,
)

B, T, HW = 4, 8, 32
DIMS = dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)
LR, TOTAL_STEPS = 1e-3, 10
LOSS_RTOL, NORM_RTOL, MOMENT_RTOL, PARAM_ATOL = 1e-5, 1e-4, 2e-2, 1e-4


class _NoDropout(flax.linen.Module):
    rate: float = 0.0
    deterministic: Optional[bool] = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(autouse=True)
def _no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    """Seeded weights (the port's init carried to flax layout, which spares
    a JAX init) with random BN running statistics, and a uint8 batch with
    ragged masks (padding frames zero) and one repeated video id."""
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in create_model("attention", **DIMS).state_dict().items()}
    v = attention_state_dict_to_variables(sd)
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    clips = rng.integers(0, 256, (2, B, T, HW, HW, 3), dtype=np.uint8)
    masks = np.ones((2, B, T), bool)
    masks[0, 1, 5:] = False
    masks[1, 2, 3:] = False
    masks[1, 3, 6:] = False
    clips[~masks] = 0
    batch = {"clip1": clips[0], "clip2": clips[1], "mask1": masks[0], "mask2": masks[1],
             "video_id": np.array([0, 1, 0, 2], np.int32)}
    return variables, batch


def _port_model(variables):
    m = create_model("attention", **DIMS)
    sd = attention_variables_to_state_dict(variables)
    m.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()}, strict=True)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return m


def _jax_draws(rng, step, ratio):
    """The extract draws inside the JAX train step at `step`
    (train_step.py:195, :213-220 after the fold_in of :322)."""
    rng = jax.random.fold_in(rng, step)
    _, e_rng1, _ = jax.random.split(rng, 3)
    k_len, e_rng1, e_rng2 = jax.random.split(e_rng1, 3)
    lengths = jax_ts.sample_extract_lengths(k_len, B, T, ratio)
    u1 = jax.random.uniform(e_rng1, (B,))
    u2 = jax.random.uniform(e_rng2, (B,))
    return {"lengths": torch.from_numpy(np.asarray(lengths).astype(np.int64)),
            "u1": torch.from_numpy(np.asarray(u1)), "u2": torch.from_numpy(np.asarray(u2))}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()}


def test_sample_extracts_with_jax_draws(setup):
    """The gather, the start clamp by the true lengths and the index map
    equal JAX's for the same draws."""
    _, batch = setup
    rng = jax.random.PRNGKey(7)
    k_len, k_u = jax.random.split(rng)
    lengths = jax_ts.sample_extract_lengths(k_len, B, T, 0.5)
    tl = jnp.sum(jnp.asarray(batch["mask1"]), axis=1)
    ex, m, idx = jax_ts.sample_extracts(k_u, jnp.asarray(batch["clip1"]), lengths, tl)
    u = jax.random.uniform(k_u, (B,))
    ours = train_step.sample_extracts(
        torch.from_numpy(batch["clip1"]), torch.from_numpy(np.asarray(lengths)),
        torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(tl)))
    for a, b in zip(ours, (ex, m, idx)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("reuse", [False, True], ids=["pixels", "fast_extracts"])
def test_two_train_steps_match_jax(setup, reuse):
    variables, batch = setup
    model = jax_create_model("attention", **DIMS)
    tx = jax_optim.make_optimizer("attention", variables["params"], LR,
                                  total_steps=TOTAL_STEPS)
    state = jax_ts.TrainState(params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              step=jnp.asarray(0, jnp.int32))
    step_fn = jax.jit(jax_ts.make_train_step(model, tx, "attention",
                                             reuse_extract_features=reuse))
    rng = jax.random.PRNGKey(5)

    port = _port_model(variables)
    opt = optim.make_optimizer("attention", port, LR, total_steps=TOTAL_STEPS)
    port_step = train_step.make_train_step(port, opt, "attention",
                                           reuse_extract_features=reuse)
    tbatch = _torch_batch(batch)
    for step in range(2):
        state, ref = step_fn(state, batch, rng)
        ours = port_step(tbatch, _jax_draws(rng, step, 0.5), step)
        np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(ours["grad_norm"]), float(ref["grad_norm"]),
                                   rtol=NORM_RTOL)
        assert float(ours["acc"]) == float(ref["acc"])
        assert int(ours["num_triplets"]) == int(ref["num_triplets"])
        if step == 0:  # the first update runs at LR 0: the moments hold the grads
            _check_moments(adamw_to_opt_state(opt, port, "attention"), state.opt_state)

    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    _check_updated(attention_state_dict_to_variables(sd), state, variables)


# Conv biases that feed a train-mode BatchNorm have a true gradient of 0 (the
# batch mean removes them): their grads are rounding noise in both packages,
# which Adam turns into steps of up to the LR. They are held to that bound.
_BN_FED_BIAS = re.compile(r"\['conv\d+'\]\['conv'\]\['bias'\]$")


def _check_updated(got, state, initial):
    """Params and BN running statistics after the steps within PARAM_ATOL
    of JAX's; the updates are not vacuous."""
    start = _flat(initial["params"])
    for section in ("params", "batch_stats"):
        a, b = _flat(got[section]), _flat(jax.device_get(getattr(state, section)))
        assert a.keys() == b.keys()
        for key in a:
            if section == "params" and _BN_FED_BIAS.search(key):
                for x in (a[key], b[key]):
                    assert np.abs(x - start[key]).max() <= 1.01 * LR, key
                continue
            if section == "batch_stats":
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=PARAM_ATOL,
                                           err_msg=key)
                continue
            err = np.abs(a[key] - b[key])
            assert err.max() <= 2 * LR, (key, err.max())
            assert np.mean(err > PARAM_ATOL) <= 1e-3, (key, np.sort(err.ravel())[-5:])
    moved = max(np.abs(_flat(got["params"])[k] - start[k]).max() for k in start)
    assert moved > 5 * PARAM_ATOL


def _check_moments(ours, jax_opt_state):
    """The port's AdamW moments and counts, carried to optax's layout,
    against the JAX optimizer state after the same steps: every leaf
    present in both, counts equal, each moment within MOMENT_RTOL of JAX's
    in global L2 norm."""
    a, b = _flat(ours), _flat(serialization.to_state_dict(jax_opt_state))
    assert a.keys() == b.keys()
    for moment in ("['mu']", "['nu']"):
        keys = [k for k in a if moment in k]
        x = np.concatenate([a[k].ravel() for k in keys])
        y = np.concatenate([b[k].ravel() for k in keys])
        assert np.linalg.norm(x - y) <= MOMENT_RTOL * np.linalg.norm(y), moment
    for key in a:
        if key.endswith("['count']"):
            assert int(a[key]) == int(b[key]), key
