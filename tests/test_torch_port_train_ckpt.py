"""Checkpoints of the port's trainer in the JAX package's `.ckpt` format,
both ways, on a small attention model (spatial_dim 16, temporal_dim 32,
one block, 32x32 frames) trained one epoch on a seeded mp4 corpus on the
CPU:

- JAX `load_checkpoint` reads the port's best.ckpt (weights and BN
  statistics equal the port's), and the JAX scanner then gives the port
  scanner's embeddings (cosine >= 0.9999);
- the port resumes from its own last.ckpt and from a JAX-written `.ckpt`
  (weights, BN statistics, AdamW moments, counters and bests), and
  warm-starts from a reference `.pth` (weights only, fresh optimizer).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from video_fingerprint_tpu.inference.scanner import FingerprintScanner as JaxScanner
from video_fingerprint_tpu.training import checkpoint as jax_ckpt
from video_fingerprint_tpu.training.optim import make_optimizer as jax_make_optimizer
from video_fingerprint_tpu_torch.config import Config
from video_fingerprint_tpu_torch.data.dataset import create_dataloader
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.training import trainer as port_trainer
from video_fingerprint_tpu_torch.training.trainer import Trainer
from video_fingerprint_tpu_torch.utils.synthetic import make_corpus
from video_fingerprint_tpu_torch.utils.torch_compat import (
    adamw_to_opt_state,
    attention_variables_to_state_dict,
)

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
        yield


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(a, b):
    a, b = _flat(a), _flat(b)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    make_corpus(root, num_unique=4, num_frames=24, duplicates=1)
    return root


def _trainer(corpus, run_dir, epochs=1):
    config = Config(batch_size=2, epochs=epochs, frame_size=32, max_frames=16,
                    num_workers=0, device="cpu", data_dir=str(corpus), **DIMS).to_dict()
    torch.manual_seed(0)
    model = create_model("attention", **DIMS)
    loaders = [create_dataloader(corpus, batch_size=2, num_workers=0, frame_size=32,
                                 max_frames=16, mode=mode, seed=0) for mode in ("train", "val")]
    return Trainer(model, *loaders, config, run_dir)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    trainer = _trainer(corpus, tmp_path_factory.mktemp("run"))
    trainer.train()
    return trainer


def test_jax_loads_and_scans_the_ports_best_ckpt(trained, corpus):
    path = trained.checkpoint_dir / "best.ckpt"
    payload = jax_ckpt.load_checkpoint(path)
    _assert_trees_equal(payload["model"], trained.variables())
    assert payload["config"] == json.loads(json.dumps(trained.config, default=str))
    assert payload["train"]["epoch"] == 0
    assert payload["train"]["global_step"] == trained.global_step == 2
    video = corpus / "video_1.mp4"
    ref = JaxScanner(str(path), device="cpu").extract_fingerprint(video)
    ours = FingerprintScanner(str(path), device="cpu").extract_fingerprint(video)
    assert float(np.dot(ours, ref)) >= 0.9999


def _moments(trainer):
    return adamw_to_opt_state(trainer.optimizer, trainer.model, "attention")


def test_port_resumes_its_own_ckpt(trained, corpus, tmp_path):
    resumed = _trainer(corpus, tmp_path, epochs=3)
    resumed.resume(trained.checkpoint_dir / "last.ckpt")
    assert (resumed.epoch, resumed.global_step) == (1, 2)
    assert resumed.best_auc_roc == trained.best_auc_roc
    _assert_trees_equal(resumed.variables(), trained.variables())
    _assert_trees_equal(_moments(resumed), _moments(trained))
    assert int(_flat(_moments(resumed))["['1']['inner_states']['other']['inner_state']"
                                        "['0']['count']"]) == 2
    resumed.train()  # the next epochs run from the carried state
    assert resumed.global_step == 6


def test_port_resumes_a_jax_ckpt(trained, corpus, tmp_path):
    """A `.ckpt` written by the JAX package (its optax state after one
    update with seeded grads) resumes in the port with everything carried."""
    params = jax.tree_util.tree_map(jnp.asarray, trained.variables()["params"])
    tx = jax_make_optimizer("attention", params, 1e-4, total_steps=8)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype),
                                   params)
    update = jax.jit(tx.update)
    for _ in range(3):
        _, state = update(grads, state, params)
    opt_sd = serialization.to_state_dict(state)
    path = tmp_path / "jax.ckpt"
    bests = {"best_val_loss": 1.5, "best_val_acc": 0.5, "best_auc_roc": 0.75,
             "best_sep_gap": 0.125}
    jax_ckpt.save_checkpoint(path, params, trained.variables()["batch_stats"],
                             trained.config, opt_state_sd=opt_sd, epoch=4, global_step=3,
                             bests=bests)
    resumed = _trainer(corpus, tmp_path / "run", epochs=6)
    resumed.resume(path)
    assert (resumed.epoch, resumed.global_step) == (5, 3)
    assert (resumed.best_val_loss, resumed.best_val_acc, resumed.best_auc_roc,
            resumed.best_sep_gap) == (1.5, 0.5, 0.75, 0.125)
    _assert_trees_equal(resumed.variables(), trained.variables())
    ours = _flat(_moments(resumed))
    ref = _flat(jax.device_get(opt_sd))
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_port_warm_starts_from_a_pth(trained, corpus, tmp_path):
    sd = attention_variables_to_state_dict(trained.variables())
    path = tmp_path / "ref.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "config": {"model_type": "attention", **DIMS}}, path)
    resumed = _trainer(corpus, tmp_path / "run")
    resumed.resume(path)
    assert (resumed.epoch, resumed.global_step) == (0, 0)
    assert not resumed.optimizer.state
    _assert_trees_equal(resumed.variables(), trained.variables())
    with pytest.raises(ValueError, match="model_type"):
        torch.save({"model_state_dict": create_model("3d").state_dict(),
                    "config": {"model_type": "3d"}}, path)
        resumed.resume(path)


def test_validate_dense_and_streaming_agree(trained):
    """The trainer's validation on either side of streaming_metrics_threshold
    (dense N x N below it, the blocked path above) gives the same metrics."""
    dense = trained.validate()
    trained.config["streaming_metrics_threshold"] = 0
    try:
        streaming = trained.validate()
    finally:
        trained.config["streaming_metrics_threshold"] = 8192
    assert dense.keys() == streaming.keys()
    for key in dense:
        assert streaming[key] == pytest.approx(dense[key], rel=1e-5, abs=1e-6), key
