"""The space-to-depth first conv and the checkpoint tools of the port,
against the JAX package.

  - s2d (video_fingerprint_tpu_torch/models/fuse.py, layers.py; JAX
    models/fuse.py:46-112, layers.py:243-258): `space_to_depth_kernel`
    equals JAX's bit for bit (OIHW against HWIO), the 2x2 packing equals
    JAX's reshape, the s2d fold equals JAX's `fuse_variables(s2d=True)`,
    and the fused s2d model equals JAX's create_model(fused=True, s2d=True)
    (f32, atol 1e-4, cosine >= 0.9999, with and without a ragged mask) and
    the port's standard fused model; the fold stays off by default.
  - tools/convert_checkpoint.py and tools/export_torch_checkpoint.py
    (JAX tools/ of the same names): on the same seeded .pth / .ckpt, for
    both model families, the port's tools write the JAX tools' payloads
    (the .ckpt byte for byte) and state_dicts; a missing input exits 1.
  - Orbax directories are refused with the reason (orbax.checkpoint
    imports jax) and the route through the JAX package.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import convert_checkpoint as jax_convert
from tools import export_torch_checkpoint as jax_export
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.models.fuse import fuse_variables
from video_fingerprint_tpu.models.fuse import space_to_depth_kernel as jax_s2d_kernel
from video_fingerprint_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from video_fingerprint_tpu_torch.cli import train as train_cli
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict, space_to_depth_kernel
from video_fingerprint_tpu_torch.models.layers import space_to_depth
from video_fingerprint_tpu_torch.tools import convert_checkpoint, export_torch_checkpoint
from video_fingerprint_tpu_torch.training.checkpoint import load_any, load_checkpoint
from video_fingerprint_tpu_torch.utils.torch_compat import variables_to_state_dict

DIMS = dict(spatial_dim=32, temporal_dim=32, embedding_dim=32, num_attention_blocks=1)
HW, B, T = 32, 2, 8
HWIO_TO_OIHW = (3, 2, 0, 1)


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _with_stats(v, seed):
    """Variables as numpy with random BN running statistics."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"], "batch_stats": stats})


@pytest.fixture(scope="module")
def variables():
    model = jax_create_model("attention", **DIMS)
    return _with_stats(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, HW, HW, 3))), 3)


@pytest.fixture(scope="module")
def video():
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (B, T, HW, HW, 3), dtype=np.uint8)
    mask = np.ones((B, T), bool)
    mask[1, 5:] = False
    return frames, mask


def _port_fused(variables, s2d):
    model = create_model("attention", fused=True, s2d=s2d, **DIMS)
    sd = fuse_state_dict(variables_to_state_dict(variables, "attention"), s2d=s2d)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def _cos(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("c,o", [(3, 32), (2, 7)])
def test_space_to_depth_kernel_equals_jax(c, o):
    k5 = np.random.default_rng(c).normal(size=(5, 5, c, o)).astype(np.float32)
    ours = space_to_depth_kernel(np.ascontiguousarray(k5.transpose(HWIO_TO_OIHW)))
    np.testing.assert_array_equal(ours, jax_s2d_kernel(k5).transpose(HWIO_TO_OIHW))


def test_space_to_depth_packing_equals_jax():
    x = np.random.default_rng(1).normal(size=(2, 6, 8, 3)).astype(np.float32)
    n, h, w, c = x.shape
    ref = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    ref = ref.reshape(n, h // 2, w // 2, 4 * c)  # JAX layers.py:251-253
    ours = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)
    with pytest.raises(ValueError, match="even"):
        space_to_depth(torch.zeros(1, 3, 5, 4))


def test_s2d_fold_equals_jax(variables):
    ours = fuse_state_dict(variables_to_state_dict(variables, "attention"), s2d=True)
    ref = fuse_variables(variables, s2d=True)["params"]["spatial_encoder"]
    for i, idx in enumerate((0, 3, 6, 9)):
        conv = ref[f"conv{i}"]["conv"]
        np.testing.assert_array_equal(ours[f"spatial_encoder.encoder.{idx}.weight"],
                                      np.transpose(conv["kernel"], HWIO_TO_OIHW))
        np.testing.assert_array_equal(ours[f"spatial_encoder.encoder.{idx}.bias"],
                                      conv["bias"])
    assert ours["spatial_encoder.encoder.0.weight"].shape == (32, 12, 3, 3)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "ragged"])
def test_s2d_forward_matches_jax(variables, video, masked):
    frames, mask = video
    m = mask if masked else None
    jm = jax_create_model("attention", fused=True, s2d=True, **DIMS)
    ref = np.asarray(jm.apply(fuse_variables(variables, s2d=True), jnp.asarray(frames),
                              mask=m))
    with torch.inference_mode():
        ours = _port_fused(variables, s2d=True)(
            torch.from_numpy(frames), None if m is None else torch.from_numpy(m)).numpy()
    assert ours.shape == ref.shape == (B, DIMS["embedding_dim"])
    assert _cos(ours, ref).min() >= 0.9999
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_s2d_equals_standard_fused_and_is_off_by_default(variables, video):
    frames, mask = video
    with torch.inference_mode():
        a = _port_fused(variables, s2d=False)(torch.from_numpy(frames),
                                              torch.from_numpy(mask)).numpy()
        b = _port_fused(variables, s2d=True)(torch.from_numpy(frames),
                                             torch.from_numpy(mask)).numpy()
    assert _cos(a, b).min() >= 0.999999
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    conv0 = create_model("attention", fused=True).spatial_encoder.encoder[0]
    assert conv0.kernel_size == (5, 5) and conv0.stride == (2, 2)
    sd = fuse_state_dict(variables_to_state_dict(variables, "attention"))
    assert sd["spatial_encoder.encoder.0.weight"].shape == (32, 3, 5, 5)
    with pytest.raises(ValueError, match="attention"):
        fuse_state_dict({}, "3d", s2d=True)


# ------------------------------------------------------------------- tools

MODELS = {
    "attention": ({"model_type": "attention", "frame_size": 64, "max_frames": 500, **DIMS},
                  (1, 4, HW, HW, 3)),
    "3d": ({"model_type": "3d", "frame_size": 64, "clip_length": 16, "frame_stride": 4,
            "embedding_dim": 256}, (1, 16, HW, HW, 3)),
}
COUNTERS = {"epoch": 7, "global_step": 1234, "best_val_loss": 0.25, "best_val_acc": 0.875,
            "best_auc_roc": 0.9375}


def _jax_variables(model_type, seed):
    config, example = MODELS[model_type]
    dims = {k: v for k, v in config.items()
            if k not in ("model_type", "frame_size", "max_frames", "clip_length")}
    model = jax_create_model(model_type, **dims)
    return _with_stats(model.init(jax.random.PRNGKey(seed), jnp.zeros(example)), seed), config


def _run_jax_tool(tool, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", [tool.__file__, *map(str, args)])
    return tool.main()


@pytest.mark.parametrize("counters", [True, False], ids=["counters", "defaults"])
@pytest.mark.parametrize("model_type", list(MODELS))
def test_convert_checkpoint_equals_jax_tool(tmp_path, monkeypatch, model_type, counters):
    variables, config = _jax_variables(model_type, 1)
    sd = variables_to_state_dict(variables, model_type)
    pth = tmp_path / "in.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                "config": config, **(COUNTERS if counters else {})}, pth)
    assert _run_jax_tool(jax_convert, monkeypatch, pth, tmp_path / "jax.ckpt") == 0
    assert convert_checkpoint.main([str(pth), str(tmp_path / "port.ckpt")]) == 0
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    payload = load_checkpoint(tmp_path / "port.ckpt")
    assert payload["config"] == config
    train = payload["train"]
    want = COUNTERS if counters else {"epoch": 0, "global_step": 0, "best_val_loss": np.inf,
                                      "best_val_acc": 0.0, "best_auc_roc": 0.0}
    assert (train["epoch"], train["global_step"]) == (want["epoch"], want["global_step"])
    assert train["bests"] == {k: want[k] for k in ("best_val_loss", "best_val_acc",
                                                   "best_auc_roc")}
    back, _ = load_any(tmp_path / "port.ckpt")
    for key, value in variables_to_state_dict(back, model_type).items():
        np.testing.assert_array_equal(value, sd[key], key)


@pytest.mark.parametrize("model_type", list(MODELS))
def test_export_checkpoint_equals_jax_tool(tmp_path, monkeypatch, model_type):
    variables, config = _jax_variables(model_type, 2)
    ckpt = tmp_path / "in.ckpt"
    jax_save_checkpoint(ckpt, variables["params"], variables["batch_stats"], config,
                        epoch=COUNTERS["epoch"], global_step=COUNTERS["global_step"],
                        bests={k: COUNTERS[k] for k in ("best_val_loss", "best_val_acc")})
    assert _run_jax_tool(jax_export, monkeypatch, ckpt, tmp_path / "jax.pth") == 0
    assert export_torch_checkpoint.main([str(ckpt), str(tmp_path / "port.pth")]) == 0
    ref = torch.load(tmp_path / "jax.pth", weights_only=False)
    ours = torch.load(tmp_path / "port.pth", weights_only=False)
    assert ours.keys() == ref.keys()
    for key in ref:
        if key != "model_state_dict":
            assert ours[key] == ref[key], key
    assert ours["best_auc_roc"] == 0.0 and ours["epoch"] == COUNTERS["epoch"]
    assert ours["model_state_dict"].keys() == ref["model_state_dict"].keys()
    for key, value in ref["model_state_dict"].items():
        assert torch.equal(ours["model_state_dict"][key], value), key
    model = create_model(model_type, **{k: v for k, v in config.items()
                                        if k in DIMS or k == "frame_stride"})
    model.load_state_dict(ours["model_state_dict"], strict=True)


def test_tools_refuse_a_missing_input(tmp_path, capsys):
    for tool in (convert_checkpoint, export_torch_checkpoint):
        assert tool.main([str(tmp_path / "nope"), str(tmp_path / "out")]) == 1
        assert "does not exist" in capsys.readouterr().out


def test_orbax_refusal_says_why(tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="imports jax") as err:
        load_any(tmp_path)
    assert "save_checkpoint" in str(err.value)
    assert train_cli.main(["--data_dir", str(tmp_path), "--orbax"]) == 2
    out = capsys.readouterr().out
    assert "not ported" in out and "orbax.checkpoint" in out
