"""The port's attention model (video_fingerprint_tpu_torch/models) against
the JAX create_model("attention"), on the same weights carried over by the
port's utils/torch_compat.py, and the port's BN fold against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.models.fuse import fuse_variables
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.utils.torch_compat import (
    attention_state_dict_to_variables,
    attention_variables_to_state_dict,
)

COS_F32, ATOL_F32 = 0.9999, 1e-4
COS_BF16 = 0.999  # bf16 rounds at other places in the two frameworks


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def variables():
    """JAX init + random BN running stats (mean != 0, var != 1), as numpy."""
    model = jax_create_model("attention")
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3)))
    rng = np.random.default_rng(3)
    stats = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.5, a.shape).astype(np.float32) ** 2 + 0.5,
        v["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": stats})


def _port_model(state_dict, fused=False):
    m = create_model("attention", fused=fused)
    m.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in state_dict.items()},
                      strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def port_model(variables):
    return _port_model(attention_variables_to_state_dict(variables))


@pytest.fixture(scope="module")
def video():
    """B = 2, T = 16 uint8 frames and a mask with a ragged second row."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (2, 16, 64, 64, 3), dtype=np.uint8)
    mask = np.ones((2, 16), bool)
    mask[1, 9:] = False
    return frames, mask


def _check(ours, ref, cos_min, atol=None):
    assert ours.shape == ref.shape and ours.dtype == np.float32
    cos = np.sum(ours * ref, axis=1) / (np.linalg.norm(ours, axis=1)
                                        * np.linalg.norm(ref, axis=1))
    assert cos.min() >= cos_min, cos
    if atol is not None:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_param_count(port_model):
    assert sum(p.numel() for p in port_model.parameters()) == 3_959_169


def test_state_dict_roundtrip(variables, port_model):
    """flax variables -> state_dict -> flax variables is lossless, and the
    state_dict has exactly the reference's keys (strict load above)."""
    sd = attention_variables_to_state_dict(variables)
    assert set(sd) == set(port_model.state_dict())
    back = attention_state_dict_to_variables(sd)
    flat = lambda t: {jax.tree_util.keystr(p): x
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(variables), flat(back)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(variables, port_model, video, masked):
    frames, mask = video
    B, T = mask.shape
    jm = jax_create_model("attention")
    m = mask if masked else None
    ref = np.asarray(jm.apply(variables, jnp.asarray(frames.reshape(B * T, 64, 64, 3)),
                              B, mask=m, method="forward_flat"))
    with torch.inference_mode():
        ours = port_model.forward_flat(
            torch.from_numpy(frames.reshape(B * T, 64, 64, 3)), B,
            None if m is None else torch.from_numpy(m)).numpy()
    _check(ours, ref, COS_F32, ATOL_F32)


def test_masked_padded_equals_unpadded(port_model):
    rng = np.random.default_rng(3)
    T_real, T_pad = 12, 20
    real = rng.random((1, T_real, 64, 64, 3), dtype=np.float32)
    padded = np.zeros((1, T_pad, 64, 64, 3), np.float32)
    padded[:, :T_real] = real
    mask = np.arange(T_pad)[None] < T_real
    with torch.inference_mode():
        a = port_model(torch.from_numpy(real)).numpy()
        b = port_model(torch.from_numpy(padded), torch.from_numpy(mask)).numpy()
    _check(b, a, 0.9999, atol=1e-5)


def test_fuse_matches_jax_fold_and_standard_forward(variables, port_model, video):
    """The port's fold gives the JAX fold's weights exactly (transposed), and
    the fused model computes the standard model's function."""
    sd = attention_variables_to_state_dict(variables)
    fused_sd = fuse_state_dict(sd)
    assert not any(".running_" in k for k in fused_sd)
    jax_fused = fuse_variables(variables)["params"]
    convs = [(jax_fused["spatial_encoder"][f"conv{i}"]["conv"],
              f"spatial_encoder.encoder.{idx}", (3, 2, 0, 1))
             for i, idx in enumerate((0, 3, 6, 9))]
    convs += [(jax_fused[f"temporal_conv_blocks_{b}"][f"conv{j}"]["conv"],
               f"temporal_conv_blocks.{b}.convs.{j}.0", (2, 1, 0))
              for b in range(2) for j in range(4)]
    for conv, key, to_torch in convs:
        np.testing.assert_array_equal(
            fused_sd[f"{key}.weight"], np.transpose(conv["kernel"], to_torch), key)
        np.testing.assert_array_equal(fused_sd[f"{key}.bias"], conv["bias"], key)

    frames, mask = video
    fused = _port_model(fused_sd, fused=True)
    with torch.inference_mode():
        a = port_model(torch.from_numpy(frames), torch.from_numpy(mask)).numpy()
        b = fused(torch.from_numpy(frames), torch.from_numpy(mask)).numpy()
    _check(b, a, 0.999999)
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5)


def test_bf16_matches_jax_bf16(variables, video):
    frames, mask = video
    B, T = mask.shape
    jm = jax_create_model("attention", dtype=jnp.bfloat16)
    ref = np.asarray(jm.apply(variables, jnp.asarray(frames), mask=mask))
    model = _port_model(attention_variables_to_state_dict(variables)).to(torch.bfloat16)
    with torch.inference_mode():
        ours = model(torch.from_numpy(frames), torch.from_numpy(mask)).numpy()
    _check(ours, ref, COS_BF16)


def test_create_model_3d_not_ported():
    """Both 3D keys build the 3D model since it was ported (its tests are in
    test_torch_port_model3d.py); an unknown key still raises."""
    from video_fingerprint_tpu_torch.models import VideoFingerprint3D

    for key in ("3d", "cnn3d"):
        assert isinstance(create_model(key), VideoFingerprint3D)
    with pytest.raises(ValueError):
        create_model("nope")
