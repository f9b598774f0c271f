"""The JAX package's Trainer.resume takes a `.ckpt` written by the port's
trainer: weights, BatchNorm statistics, the optax moments converted from
AdamW's, the update counts, the epoch/step counters and the bests come
out equal (small attention model, spatial_dim 16, temporal_dim 32, one
block, 32x32 frames, one epoch on a seeded mp4 corpus on the CPU)."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from video_fingerprint_tpu.data.dataset import create_dataloader as jax_create_dataloader
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.training import trainer as jax_trainer
from video_fingerprint_tpu_torch.config import Config
from video_fingerprint_tpu_torch.data.dataset import create_dataloader
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training import trainer as port_trainer
from video_fingerprint_tpu_torch.training.trainer import Trainer
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus
from video_fingerprint_tpu_torch.utils.torch_compat import adamw_to_opt_state

DIMS = dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """TensorBoard logging is left out of these runs: importing it costs
    seconds (it pulls in TensorFlow where that is installed)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_trainer, "_make_tb_writer", lambda logdir: port_trainer._NullWriter())
        mp.setattr(jax_trainer, "_make_tb_writer", lambda logdir: jax_trainer._NullWriter())
        yield


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_jax_trainer_resumes_the_ports_ckpt(tmp_path, monkeypatch):
    corpus = tmp_path / "videos"
    make_corpus(corpus, num_unique=4, num_frames=24, duplicates=1)
    config = Config(batch_size=2, epochs=2, frame_size=32, max_frames=16, num_workers=0,
                    device="cpu", data_dir=str(corpus), **DIMS).to_dict()
    loader_args = dict(batch_size=2, num_workers=0, frame_size=32, max_frames=16, seed=0)
    torch.manual_seed(0)
    port = Trainer(create_model("attention", **DIMS),
                   *[create_dataloader(corpus, mode=m, **loader_args) for m in ("train", "val")],
                   dict(config, epochs=1), tmp_path / "port_run")
    port.train()
    path = port.checkpoint_dir / "last.ckpt"

    # the JAX trainer's own init is an eager flax init; jit it (same values)
    init = jax_trainer.init_train_state
    monkeypatch.setattr(jax_trainer, "init_train_state",
                        lambda model, tx, rng, shape: jax.jit(
                            lambda r: init(model, tx, r, shape))(rng))
    ref = jax_trainer.Trainer(
        jax_create_model("attention", **DIMS),
        *[jax_create_dataloader(corpus, mode=m, **loader_args) for m in ("train", "val")],
        dict(config, device="cpu"), tmp_path / "jax_run")
    ref.resume(path)
    assert (ref.epoch, ref.global_step) == (1, port.global_step) == (1, 2)
    assert ref.best_auc_roc == pytest.approx(port.best_auc_roc)
    assert ref.best_sep_gap == pytest.approx(port.best_sep_gap)
    assert int(ref.state.step) == 2
    variables = port.variables()
    for section in ("params", "batch_stats"):
        a, b = _flat(jax.device_get(getattr(ref.state, section))), _flat(variables[section])
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    a = _flat(serialization.to_state_dict(jax.device_get(ref.state.opt_state)))
    b = _flat(adamw_to_opt_state(port.optimizer, port.model, "attention"))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
