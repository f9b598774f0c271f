"""The port's 3D-model train and eval steps against the JAX package's: a 3D
model at frame_stride 4 (T = 8 frames, 32x32, B = 4), the same weights and
uint8 batch, dropout off in both (flax.linen.Dropout replaced by an
identity for the test, the port's rate 0), f32 on the CPU.

Tolerances: the loss and its three terms 1e-5 relative at the first step,
1e-4 at the second, the grad norm ten times those; BatchNorm running
statistics 5e-4 absolute (a running mean carries its conv's bias, see
below); eval embeddings 1e-5 absolute. The 3D schedule
has no warmup, so the first update already moves every param by AdamW's
first step, +-LR times the sign of its grad: an element whose grad is near
0 (and every BN-fed conv bias, whose true gradient is 0) may step the other
way in one package, which the second step's loss then carries. Params after
two steps: all within twice the LR of JAX's, at most 0.1 % of the elements
past 1e-4.
"""

import re
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
    cnn3d_state_dict_to_variables,
    cnn3d_variables_to_state_dict,
)

B, T, HW, STRIDE = 4, 8, 32, 4
LR = 1e-3


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


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(2)
    sd = {k: v.detach().numpy()
          for k, v in create_model("3d", frame_stride=STRIDE).state_dict().items()}
    variables = cnn3d_state_dict_to_variables(sd)
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 256, (2, B, T, HW, HW, 3), dtype=np.uint8)
    batch = {"clip1": clips[0], "clip2": clips[1],
             "video_id": np.array([0, 1, 0, 2], np.int32)}
    return variables, batch


def _port_model(variables):
    m = create_model("3d", frame_stride=STRIDE)
    sd = cnn3d_variables_to_state_dict(variables)
    m.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in sd.items()}, strict=True)
    for mod in m.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    return m


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(x)) for k, x in batch.items()}


def test_two_train_steps_match_jax(setup):
    variables, batch = setup
    model = jax_create_model("3d", frame_stride=STRIDE)
    tx = jax_optim.make_optimizer("3d", variables["params"], LR, epochs=2, steps_per_epoch=1)
    state = jax_ts.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              step=jnp.asarray(0, jnp.int32))
    step_fn = jax.jit(jax_ts.make_train_step(model, tx, "3d"))
    port = _port_model(variables)
    opt = optim.make_optimizer("3d", port, LR, epochs=2, steps_per_epoch=1)
    port_step = train_step.make_train_step(port, opt, "3d")
    for step in range(2):
        state, ref = step_fn(state, batch, jax.random.PRNGKey(3))
        ours = port_step(_torch_batch(batch), None, step)
        rtol = 1e-5 if step == 0 else 1e-4
        for key in ("loss", "loss_standard", "loss_hard", "loss_triplet"):
            np.testing.assert_allclose(float(ours[key]), float(ref[key]), rtol=rtol,
                                       atol=1e-7, err_msg=key)
        np.testing.assert_allclose(float(ours["grad_norm"]), float(ref["grad_norm"]),
                                   rtol=10 * rtol)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    got = cnn3d_state_dict_to_variables(sd)
    start = _flat(variables["params"])
    bn_fed_bias = re.compile(r"\['block\d'\]\['conv'\]\['conv'\]\['bias'\]$")
    for section in ("params", "batch_stats"):
        a, b = _flat(got[section]), _flat(jax.device_get(getattr(state, section)))
        assert a.keys() == b.keys()
        for key in a:
            if section == "params" and bn_fed_bias.search(key):
                for x in (a[key], b[key]):
                    assert np.abs(x - start[key]).max() <= 2 * LR, key
                continue
            if section == "batch_stats":
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=5e-4, err_msg=key)
                continue
            err = np.abs(a[key] - b[key])
            assert err.max() <= 2 * LR, (key, err.max())
            assert np.mean(err > 1e-4) <= 1e-3, (key, np.sort(err.ravel())[-5:])
    moved = max(np.abs(_flat(got["params"])[k] - start[k]).max() for k in start)
    assert moved > 5e-4


def test_eval_step_matches_jax(setup):
    variables, batch = setup
    model = jax_create_model("3d", frame_stride=STRIDE)
    ref, e1, e2 = jax.jit(jax_ts.make_eval_step(model, "3d"))(
        variables["params"], variables["batch_stats"], batch, jax.random.PRNGKey(0))
    ours, o1, o2 = train_step.make_eval_step(_port_model(variables), "3d")(
        _torch_batch(batch), None)
    np.testing.assert_allclose(o1.numpy(), np.asarray(e1), rtol=0, atol=1e-5)
    np.testing.assert_allclose(o2.numpy(), np.asarray(e2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]), rtol=1e-5)
    assert float(ours["acc"]) == float(ref["acc"])
