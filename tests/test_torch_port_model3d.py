"""The port's 3D-CNN model (video_fingerprint_tpu_torch/models/cnn3d.py)
against the JAX create_model("3d"), on the same weights carried over by the
port's utils/torch_compat.py, and the port's 3D BN fold against the JAX one.
Small size: frame_stride 4, 16-frame clips of 64x64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.models.fuse import fuse_variables
from video_fingerprint_tpu_torch.models import VideoFingerprint3D, create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.utils.torch_compat import (
    state_dict_to_variables,
    variables_to_state_dict,
)

COS_F32, ATOL_F32 = 0.9999, 1e-4
STRIDE = 4


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
def variables():
    """JAX init at frame_stride 4 + random BN running stats, as numpy."""
    model = jax_create_model("3d", frame_stride=STRIDE)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 64, 64, 3)))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": stats})


def _port_model(state_dict, fused=False, stride=STRIDE):
    m = create_model("3d", frame_stride=stride, fused=fused)
    m.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in state_dict.items()},
                      strict=True)
    return m.eval()


def _check(ours, ref, cos_min, atol=None):
    assert ours.shape == ref.shape and ours.dtype == np.float32
    cos = np.sum(ours * ref, axis=1) / (np.linalg.norm(ours, axis=1)
                                        * np.linalg.norm(ref, axis=1))
    assert cos.min() >= cos_min, cos
    if atol is not None:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("stride,count", [(16, 409_170), (32, 428_370)])
def test_param_count(stride, count):
    """The factory's default stride is 16 (the reference quirk); the
    scanner's default 32 gives the train CLI's 3D model."""
    m = create_model("3d") if stride == 16 else create_model("3d", frame_stride=stride)
    assert m.frame_stride == stride
    assert sum(p.numel() for p in m.parameters()) == count
    if stride == 32:
        v = jax_create_model("3d", frame_stride=32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 64, 3)))
        assert sum(x.size for x in jax.tree_util.tree_leaves(v["params"])) == count


def test_state_dict_roundtrip(variables):
    """variables -> state_dict -> variables -> state_dict is lossless, and
    the state_dict has exactly the reference's keys (strict load)."""
    sd = variables_to_state_dict(variables, "3d")
    assert set(sd) == set(create_model("3d", frame_stride=STRIDE).state_dict())
    back = state_dict_to_variables(sd, "cnn3d")
    a, b = _flat(variables), _flat(back)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    again = variables_to_state_dict(back, "cnn3d")
    for key in sd:
        np.testing.assert_array_equal(again[key], sd[key])
    with pytest.raises(ValueError):
        variables_to_state_dict(variables, "nope")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("T", [16, 14])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_forward_matches_jax(variables, dtype, T, fused):
    """uint8 and float input, T a multiple of the stride and not, standard
    and BN-folded layouts."""
    rng = np.random.default_rng(11)
    video = rng.integers(0, 256, (2, T, 64, 64, 3), dtype=np.uint8)
    if dtype == "float32":
        video = video.astype(np.float32) / 255.0
    jv = fuse_variables(variables, "3d") if fused else variables
    ref = np.asarray(jax_create_model("3d", frame_stride=STRIDE, fused=fused)
                     .apply(jv, jnp.asarray(video)))
    sd = variables_to_state_dict(variables, "3d")
    model = _port_model(fuse_state_dict(sd, "3d") if fused else sd, fused=fused)
    with torch.inference_mode():
        ours = model(torch.from_numpy(video)).numpy()
    _check(ours, ref, COS_F32, ATOL_F32)


def test_fuse_matches_jax_fold(variables):
    """The port's 3D fold gives the JAX fold's weights exactly (transposed)."""
    fused_sd = fuse_state_dict(variables_to_state_dict(variables, "3d"), "3d")
    assert not any(".bn." in k for k in fused_sd)
    jax_fused = fuse_variables(variables, "3d")["params"]
    for i in range(4):
        conv = jax_fused[f"block{i}"]["conv"]["conv"]
        np.testing.assert_array_equal(fused_sd[f"encoder.{i}.conv.weight"],
                                      np.transpose(conv["kernel"], (4, 3, 0, 1, 2)))
        np.testing.assert_array_equal(fused_sd[f"encoder.{i}.conv.bias"], conv["bias"])
    with pytest.raises(ValueError):
        fuse_state_dict({}, "nope")


def test_short_clip_equals_zero_padded():
    """A 20-frame clip at stride 16 embeds as its zero-padded 32-frame
    version (the model pads with zeros after the uint8 -> float step), in
    uint8 and in float (tests/test_models.py:75-83)."""
    torch.manual_seed(0)
    model = create_model("3d").eval()
    assert model.frame_stride == 16
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, (1, 20, 64, 64, 3), dtype=np.uint8)
    padded = np.zeros((1, 32, 64, 64, 3), np.uint8)
    padded[:, :20] = clip
    with torch.inference_mode():
        a = model(torch.from_numpy(clip)).numpy()
        b = model(torch.from_numpy(padded)).numpy()
        c = model(torch.from_numpy(clip.astype(np.float32) / 255.0)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(c, a, rtol=0, atol=1e-6)
    assert isinstance(model, VideoFingerprint3D)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-6)


def test_bf16_matches_jax_bf16(variables):
    rng = np.random.default_rng(2)
    video = rng.integers(0, 256, (2, 16, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(jax_create_model("3d", frame_stride=STRIDE, dtype=jnp.bfloat16)
                     .apply(variables, jnp.asarray(video)))
    model = _port_model(variables_to_state_dict(variables, "3d")).to(torch.bfloat16)
    with torch.inference_mode():
        ours = model(torch.from_numpy(video)).numpy()
    _check(ours, ref, 0.999)
