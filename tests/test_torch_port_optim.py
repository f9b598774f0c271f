"""The port's optimizer (video_fingerprint_tpu_torch/training/optim.py)
against the JAX package's optax chain: both schedules at every step, and
two steps of the global-norm clip + AdamW on a small parameter tree with
the three LR groups and grads whose norm is above 1, f32, within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_fingerprint_tpu.training import optim as jo
from video_fingerprint_tpu_torch.training import optim as to


def test_warmup_cosine_floor_every_step():
    total = 57
    ref = jo.warmup_cosine_floor(1.0, total)
    ours = to.warmup_cosine_floor(total)
    for step in range(total + 5):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-7)
    assert ours(0) == 0.0  # the first update runs at LR 0


def test_epoch_cosine_annealing_every_step():
    ref = jo.epoch_cosine_annealing(1.0, 7, 5)
    ours = to.epoch_cosine_annealing(7, 5)
    for step in range(45):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-7)


def test_current_lr():
    for step in (0, 3, 9, 40):
        for mt in ("attention", "3d"):
            np.testing.assert_allclose(
                to.current_lr(mt, 3e-4, step, 50, 5, 10),
                jo.current_lr(mt, 3e-4, step, 50, 5, 10), rtol=1e-6)


class _Tiny(torch.nn.Module):
    """Top-level names as the attention model's: one parameter per group."""

    def __init__(self, arrays):
        super().__init__()
        self.spatial_encoder = torch.nn.ParameterDict({"w": torch.nn.Parameter(arrays[0])})
        self.attention_blocks = torch.nn.ModuleList([torch.nn.ParameterDict(
            {"w": torch.nn.Parameter(arrays[1])})])
        self.head = torch.nn.ParameterDict({"b": torch.nn.Parameter(arrays[2])})
        self.temperature = torch.nn.Parameter(arrays[3])


@pytest.mark.parametrize("model_type", ["attention", "3d"])
def test_two_clipped_adamw_steps_match_optax(model_type):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2), (1,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 3).astype(np.float32) for s in shapes] for _ in range(2)]
    tree = lambda xs: {"spatial_encoder": {"w": xs[0]}, "attention_blocks_0": {"w": xs[1]},
                       "head": {"b": xs[2]}, "temperature": xs[3]}
    params = jax.tree_util.tree_map(jnp.asarray, tree(init))
    tx = jo.make_optimizer(model_type, params, 1e-2, total_steps=10, epochs=3,
                           steps_per_epoch=1)
    state = tx.init(params)

    model = _Tiny([torch.from_numpy(a.copy()) for a in init])
    opt = to.make_optimizer(model_type, model, 1e-2, total_steps=10, epochs=3,
                            steps_per_epoch=1)
    if model_type == "attention":
        assert [g["label"] for g in opt.param_groups] == ["spatial", "attention", "other"]
        assert [len(g["params"]) for g in opt.param_groups] == [1, 1, 2]
    params_in_order = [model.spatial_encoder["w"], model.attention_blocks[0]["w"],
                       model.head["b"], model.temperature]
    for step in range(2):
        g_tree = jax.tree_util.tree_map(jnp.asarray, tree(grads[step]))
        assert float(optax.global_norm(g_tree)) > 1.0
        updates, state = tx.update(g_tree, state, params)
        params = optax.apply_updates(params, updates)

        for p, g in zip(params_in_order, grads[step]):
            p.grad = torch.from_numpy(g.copy())
        norm = to.clip_by_global_norm([p.grad for p in params_in_order], 1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g_tree)), rtol=1e-6)
        to.set_learning_rates(opt, step)
        opt.step()
        want = [params["spatial_encoder"]["w"], params["attention_blocks_0"]["w"],
                params["head"]["b"], params["temperature"]]
        for p, ref in zip(params_in_order, want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)


def test_clip_below_max_norm_leaves_grads():
    g = [torch.tensor([0.3, -0.4])]
    norm = to.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(0.5)
    assert torch.equal(g[0], torch.tensor([0.3, -0.4]))
