"""The port's data-parallel training (video_fingerprint_tpu_torch/parallel/,
training/) on the CPU, ranks in gloo groups of spawned processes
(tests/torch_port_ranks.py), against a single process and the JAX package.

  - Global BatchNorm: W in {2, 4} ranks give the single-process train-mode
    BatchNorm output, input grads, summed affine grads and running
    statistics on the concatenated batch (1e-5; the global path computes
    var = E[x^2] - mean^2 as JAX does, torch's own a two-pass variance).
  - A 2-rank train step against JAX's step jitted with the batch sharded
    over a 2-device 'data' mesh (tests/test_train_step.py:104-130), same
    weights, global batch and extract draws, dropout off: attention with and
    without --fast_extracts and with --remat at
    test_torch_port_train_step.py's constants,
    the 3D model at test_torch_port_train3d.py's; params within twice the
    LR, at most 0.1 % of all param elements past 1e-4 (Adam's first steps
    turn near-zero grads into steps of either sign). Both ranks end with
    the same weights bit for bit.
  - Training equivalence (JAX tests/test_multihost.py:48-101): 4 steps of
    the Trainer plus a validation ending in a partial batch under 2 ranks
    and under 1, dropout off (dropout draws are per rank): losses within
    rtol 2e-4, val loss, intra/inter similarity, gap and the robustness
    cosines within rtol 2e-4, atol 2e-5; the two ranks report identical
    numbers.
  - wraparound_pad_batch / slice_replicated_blocks equal JAX's for the
    layouts of nprocs 1, 2, 4 (tests/test_distributed.py:161-206).
  - The train CLI under 2 gloo ranks for one epoch (JAX
    tests/test_multihost.py:104-144): rank 0 writes the full artifact set,
    rank 1 writes no file, the run-dir name is rank 0's, and both ranks
    print the same validation numbers.
"""

import re
from typing import Optional

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.torch_port_ranks import free_port, run_ranks
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.parallel.mesh import make_mesh
from video_fingerprint_tpu.training import optim as jax_optim
from video_fingerprint_tpu.training import train_step as jax_ts
from video_fingerprint_tpu.training import trainer as jax_trainer
from video_fingerprint_tpu_torch.config import Config
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training import trainer as port_trainer
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus
from video_fingerprint_tpu_torch.utils.torch_compat import (
    state_dict_to_variables,
    variables_to_state_dict,
)

B, T, HW = 4, 8, 32
DIMS = dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)
LR, TOTAL_STEPS = 1e-3, 10
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4  # test_torch_port_train_step.py:51


class _NoDropout(flax.linen.Module):
    rate: float = 0.0
    deterministic: Optional[bool] = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ global BN


@pytest.mark.parametrize("world", [2, 4])
def test_global_batchnorm_matches_concatenated_batch(tmp_path, world):
    rng = np.random.default_rng(world)
    inputs, refs = {}, {}
    for name, shape, cls in (("1d", (8, 6, 10), torch.nn.BatchNorm1d),
                             ("2d", (8, 5, 6, 7), torch.nn.BatchNorm2d),
                             ("3d", (8, 4, 3, 5, 6), torch.nn.BatchNorm3d)):
        C = shape[1]
        x = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)),
                 "bias": torch.from_numpy(rng.normal(size=C).astype(np.float32)),
                 "running_mean": torch.from_numpy(rng.normal(size=C).astype(np.float32)),
                 "running_var": torch.from_numpy(rng.uniform(0.5, 2, C).astype(np.float32)),
                 "num_batches_tracked": torch.tensor(3)}
        inputs[name] = {"x": x, "g": g, "state": state}
        bn = cls(C)
        bn.load_state_dict(state)
        bn.train()
        xr = x.clone().requires_grad_(True)
        y = bn(xr)
        (y * g).sum().backward()
        refs[name] = (y.detach(), xr.grad, bn.weight.grad, bn.bias.grad, bn.state_dict())
    outs = run_ranks("bn", world, tmp_path, inputs)
    for name, (y, x_grad, w_grad, b_grad, state) in refs.items():
        got = [o[name] for o in outs]
        torch.testing.assert_close(torch.cat([g["y"] for g in got]), y, rtol=0, atol=1e-5)
        torch.testing.assert_close(torch.cat([g["x_grad"] for g in got]), x_grad,
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(sum(g["w_grad"] for g in got), w_grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(sum(g["b_grad"] for g in got), b_grad, rtol=1e-5, atol=1e-5)
        for g in got:
            for key, ref in state.items():
                torch.testing.assert_close(g["state"][key], ref, rtol=0, atol=1e-6)
                assert torch.equal(g["state"][key], got[0]["state"][key])


# ------------------------------------------- a 2-rank step against JAX's DP step


def _jax_draws(rng, step, ratio):
    """The extract draws inside the JAX train step at `step` for the global
    batch (train_step.py:195, :213-220 after the fold_in of :322)."""
    rng = jax.random.fold_in(rng, step)
    _, e_rng1, _ = jax.random.split(rng, 3)
    k_len, e_rng1, e_rng2 = jax.random.split(e_rng1, 3)
    lengths = jax_ts.sample_extract_lengths(k_len, B, T, ratio)
    return {"lengths": torch.from_numpy(np.asarray(lengths).astype(np.int64)),
            "u1": torch.from_numpy(np.array(jax.random.uniform(e_rng1, (B,)))),
            "u2": torch.from_numpy(np.array(jax.random.uniform(e_rng2, (B,))))}


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory, monkeypatch_module):
    """JAX's step on a 2-device 'data' mesh and the port's on 2 gloo ranks,
    2 steps each, for attention (pixels, fast extracts, remat: the
    collectives run again in the recomputed forward, the BN statistics
    update once) and 3D."""
    monkeypatch_module.setattr(flax.linen, "Dropout", _NoDropout)
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 256, (2, B, T, HW, HW, 3), dtype=np.uint8)
    masks = np.ones((2, B, T), bool)
    masks[0, 1, 5:] = False
    masks[1, 2, 3:] = False
    masks[1, 3, 6:] = False
    clips[~masks] = 0
    attn_batch = {"clip1": clips[0], "clip2": clips[1], "mask1": masks[0],
                  "mask2": masks[1], "video_id": np.array([0, 1, 0, 2], np.int32)}
    batch3d = {k: attn_batch[k] for k in ("clip1", "clip2", "video_id")}
    mesh = make_mesh("data", jax.devices()[:2])
    repl, bsh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    step_rng = jax.random.PRNGKey(5)

    cases, refs = {}, {}
    for name, model_type, reuse, remat in (("pixels", "attention", False, False),
                                           ("fast_extracts", "attention", True, False),
                                           ("remat", "attention", False, True),
                                           ("3d", "3d", False, False)):
        dims = DIMS if model_type == "attention" else {"frame_stride": 4}
        torch.manual_seed(0)
        sd = {k: v.detach().numpy()
              for k, v in create_model(model_type, **dims).state_dict().items()}
        v = state_dict_to_variables(sd, model_type)
        stats = jax.tree_util.tree_map(
            lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
            v["batch_stats"])
        variables = {"params": v["params"], "batch_stats": stats}
        opt = ({"total_steps": TOTAL_STEPS} if model_type == "attention"
               else {"epochs": 2, "steps_per_epoch": 1})
        batch = attn_batch if model_type == "attention" else batch3d
        tx = jax_optim.make_optimizer(model_type, variables["params"], LR, **opt)
        state = jax.device_put(jax_ts.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]), step=jnp.asarray(0, jnp.int32)), repl)
        step_fn = jax.jit(jax_ts.make_train_step(jax_create_model(model_type, **dims), tx,
                                                 model_type, reuse_extract_features=reuse,
                                                 remat=remat))
        sharded = {k: jax.device_put(x, bsh) for k, x in batch.items()}
        metrics = []
        for i in range(2):
            state, m = step_fn(state, sharded, jax.device_put(step_rng, repl))
            metrics.append({k: float(np.asarray(x).ravel()[0]) for k, x in m.items()})
        refs[name] = (variables, metrics, jax.device_get(state))
        cases[name] = {
            "model_type": model_type, "dims": dims, "reuse": reuse, "remat": remat,
            "lr": LR, "opt": opt,
            "state": variables_to_state_dict(
                jax.tree_util.tree_map(np.asarray, variables), model_type),
            "batch": batch,
            "draws": [_jax_draws(step_rng, i, 0.5) if model_type == "attention" else None
                      for i in range(2)]}
    outs = run_ranks("step", 2, tmp_path_factory.mktemp("dp_step"), {"cases": cases})
    return refs, outs


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


_BN_FED_BIAS = {"attention": re.compile(r"\['conv\d+'\]\['conv'\]\['bias'\]$"),
                "3d": re.compile(r"\['block\d'\]\['conv'\]\['conv'\]\['bias'\]$")}


@pytest.mark.parametrize("name", ["pixels", "fast_extracts", "remat", "3d"])
def test_two_rank_step_matches_jax_data_parallel_step(dp_steps, name):
    refs, outs = dp_steps
    variables, ref_metrics, ref_state = refs[name]
    model_type = "3d" if name == "3d" else "attention"
    ours = [o[name] for o in outs]
    for key, x in ours[0]["state"].items():  # the ranks hold the same model
        np.testing.assert_array_equal(x, ours[1]["state"][key], err_msg=key)
    for i, (got, ref) in enumerate(zip(ours[0]["metrics"], ref_metrics)):
        assert got == ours[1]["metrics"][i]
        rtol = LOSS_RTOL if model_type == "attention" or i == 0 else 1e-4
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=rtol)
        norm_rtol = NORM_RTOL if model_type == "attention" else 10 * rtol
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=norm_rtol)
        assert got["acc"] == ref["acc"]
        assert int(got["num_triplets"]) == int(ref["num_triplets"])

    got = state_dict_to_variables(ours[0]["state"], model_type)
    start = _flat(variables["params"])
    bn_atol = PARAM_ATOL if model_type == "attention" else 5e-4
    past, total = 0, 0
    for section in ("params", "batch_stats"):
        a, b = _flat(got[section]), _flat(getattr(ref_state, section))
        assert a.keys() == b.keys()
        for key in a:
            if section == "batch_stats":
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=bn_atol, err_msg=key)
            elif _BN_FED_BIAS[model_type].search(key):  # true grad 0: steps within the LR
                for x in (a[key], b[key]):
                    assert np.abs(x - start[key]).max() <= 2.01 * LR, key
            else:
                err = np.abs(a[key] - b[key])
                assert err.max() <= 2 * LR, (key, err.max())
                past += int((err > PARAM_ATOL).sum())
                total += err.size
    # Adam turns a near-zero grad's rounding (here also the ranks' order of
    # summation) into a step of either sign: up to 0.1 % of the elements
    assert past <= 1e-3 * total, (past, total)
    moved = max(np.abs(_flat(got["params"])[k] - start[k]).max() for k in start)
    assert moved > 5 * PARAM_ATOL


# ----------------------------------------- Trainer: 2 ranks against 1 rank


def _equiv_inputs(run_base):
    Te, hw = 8, 16

    def global_batch(seed, rows):
        rng = np.random.default_rng(seed)
        lengths = rng.integers(Te // 2, Te + 1, (2, rows))
        masks = np.arange(Te)[None, None, :] < lengths[:, :, None]
        clips = (rng.random((2, rows, Te, hw, hw, 3)) * 255).astype(np.uint8)
        clips[~masks] = 0
        return {"clip1": clips[0], "clip2": clips[1], "mask1": masks[0], "mask2": masks[1],
                "video_id": (seed * 100 + np.arange(rows) % 3).astype(np.int32)}

    config = Config(batch_size=4, epochs=1, learning_rate=1e-3, frame_size=hw, max_frames=Te,
                    patience=10, model_type="attention", device="cpu", seed=0, **DIMS).to_dict()
    return {"dims": DIMS, "config": config, "run_base": str(run_base),
            "train": [global_batch(10 + i, 4) for i in range(4)],
            # one full and one partial val batch (1 row per rank under 2 ranks)
            "val": [global_batch(70, 4), global_batch(71, 2)]}


def test_two_ranks_train_and_validate_like_one(tmp_path):
    inputs = _equiv_inputs(tmp_path / "runs")
    two = run_ranks("equiv", 2, tmp_path / "two", inputs)
    one = run_ranks("equiv", 1, tmp_path / "one", inputs)[0]
    assert two[0]["losses"] == two[1]["losses"]
    assert two[0]["val"] == two[1]["val"]
    assert len(one["losses"]) == 4 and one["losses"][0] != one["losses"][-1]
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=2e-4)
    keys = ["loss", "intra_sim_mean", "inter_sim_mean", "separation_gap"]
    keys += [k for k in one["val"] if k.startswith("extract_sim_")]
    assert len(keys) == 9
    np.testing.assert_allclose([two[0]["val"][k] for k in keys],
                               [one["val"][k] for k in keys], rtol=2e-4, atol=2e-5)
    # rank 1 wrote nothing; the single-rank run wrote its artifacts
    assert not [p for p in (tmp_path / "runs" / "world2_rank1").rglob("*") if p.is_file()]
    assert (tmp_path / "runs" / "world2_rank0" / "config.json").exists()


@pytest.mark.parametrize("nprocs", [1, 2, 4])
def test_wraparound_and_block_slicing_match_jax(nprocs):
    rng = np.random.default_rng(3)
    true_local, padded_local, dim = 3, 4, 16
    base = rng.normal(size=(nprocs * true_local, dim)).astype(np.float32)
    ids = np.arange(nprocs * true_local, dtype=np.int32)
    blocks = {"port": [], "jax": []}
    for p in range(nprocs):
        local = {"emb": base[p * true_local:(p + 1) * true_local],
                 "video_id": ids[p * true_local:(p + 1) * true_local]}
        ours = port_trainer.wraparound_pad_batch(local, padded_local)
        ref = jax_trainer.wraparound_pad_batch(local, padded_local)
        for key in local:
            np.testing.assert_array_equal(ours[key], ref[key])
        blocks["port"].append(ours["emb"])
        blocks["jax"].append(ref["emb"])
    layout = np.concatenate(blocks["port"])
    got = port_trainer.slice_replicated_blocks(layout, nprocs, padded_local, true_local)
    np.testing.assert_array_equal(got, jax_trainer.slice_replicated_blocks(
        np.concatenate(blocks["jax"]), nprocs, padded_local, true_local))
    np.testing.assert_array_equal(got, base)
    unpadded = port_trainer.wraparound_pad_batch({"emb": base}, len(base))
    assert unpadded["emb"] is base


# --------------------------------------------------- the train CLI, 2 ranks


def test_train_cli_two_ranks_single_writer(tmp_path):
    corpus = tmp_path / "videos"
    make_corpus(corpus, num_unique=8, num_frames=20, duplicates=0)
    argv = ["--data_dir", str(corpus), "--batch_size", "4", "--epochs", "1",
            "--num_workers", "0", "--device", "cpu", "--max_frames", "16"]
    outs = run_ranks("cli", 2, tmp_path / "work", {"argv": argv, "cwd": str(tmp_path)},
                     env={"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())})
    assert [o["rc"] for o in outs] == [0, 0]
    runs0 = [p for p in (tmp_path / "rank0" / "runs").iterdir() if not p.is_symlink()]
    assert len(runs0) == 1
    run0 = runs0[0]
    for artifact in ("config.json", "training_info.txt", "training_log.txt",
                     "training_summary.txt", "checkpoints/last.ckpt",
                     "checkpoints/best.ckpt", "checkpoints/epoch_0.ckpt"):
        assert (run0 / artifact).exists(), artifact
    # rank 1 knows rank 0's run-dir name (its checkpoint directory) and
    # wrote no file
    run1 = tmp_path / "rank1" / "runs" / run0.name
    assert (run1 / "checkpoints").is_dir()
    assert not [p for p in (tmp_path / "rank1").rglob("*") if p.is_file()]
    val = [re.findall(r"Val   - Loss: .*|AUC-ROC: .*|Separation gap: .*", o["log"])
           for o in outs]
    assert len(val[0]) >= 3 and val[0] == val[1]
    assert "Data parallel: rank 1/2" in outs[1]["log"]
