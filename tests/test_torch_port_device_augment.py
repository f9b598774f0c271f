"""The port's device augmentations (video_fingerprint_tpu_torch/ops/
device_augment.py) against the JAX package's, on the same parameters and
the same Gaussian noise (the JAX draw fed to the port), f32 on the CPU.

Tolerances: every transform but color within 1e-5 absolute. Color goes
through an HSV round trip whose sector, floor(6h), may fall the other way
for a pixel on a sector boundary under a different rounding, so color (and
any pipeline that includes it) is held by the share of elements within
1e-5: at least 99.99 %. `sample_params` is held to the reference's rates
within binomial tolerance (4.5 standard deviations) and to its ranges; the
two packages' RNGs differ, so the draws are not compared.

Two train steps with device_augment=True (attention and 3D) equal JAX's on
the same weights, batch and fed draws: the loss within 1e-5 relative at the
first step and 1e-4 at the second (the gate of test_torch_port_train3d.py),
the accuracy equal, the grad norm within 1e-3 relative. The augmented clips
themselves agree to 1.5e-6; the grad norm's looser bound is the train-mode
BatchNorm backward's summation noise on this batch: the port's own grad
norm moves by up to 3.3e-4 relative between 1, 2 and 4 CPU threads here
(measured), beyond the 1e-4 that test_torch_port_train_step.py's batch
happens to stay within.
"""

from typing import Optional

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops import device_augment as jda
from video_fingerprint_tpu_torch.ops import device_augment as tda

B, T, HW = 2, 6, 64
ATOL = 1e-5
COLOR_SHARE = 0.9999


def _to_torch(params):
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())
    return out


def _forced(rng, per_frame: bool, **gates):
    """Numpy-seeded params with the named gates on (1.0) and the rest off;
    letterbox/overlay/rotation per frame when per_frame."""
    fshape = (B, T) if per_frame else (B,)
    p = {name: np.zeros((B,), np.float32) for name in
         ("do_color", "do_flip", "do_letterbox", "do_overlay", "do_rotation")}
    for name, value in gates.items():
        p[name] = np.full((B,), value, np.float32)
    oh = rng.integers(10, 21, fshape)
    ow = rng.integers(30, 61, fshape)
    p.update({
        "brightness": rng.uniform(0.5, 1.5, B).astype(np.float32),
        "contrast": rng.uniform(0.5, 1.5, B).astype(np.float32),
        "saturation": rng.uniform(0.5, 1.5, B).astype(np.float32),
        "hue_shift": rng.uniform(-0.1, 0.1, B).astype(np.float32),
        "noise_level": (gates.get("noise", 0.0)
                        * rng.uniform(0.02, 0.1, B)).astype(np.float32),
        "blur_idx": np.full((B,), gates.get("blur", 0), np.int32),
        "letterbox_bar": rng.integers(5, 16, fshape).astype(np.int32),
        "letterbox_vertical": (rng.random(fshape) > 0.5).astype(np.float32),
        "overlay_box": np.stack([rng.integers(0, HW - oh + 1), rng.integers(0, HW - ow + 1),
                                 oh, ow], axis=-1).astype(np.int32),
        "rotation_angle": (p["do_rotation"].reshape((B,) + (1,) * (len(fshape) - 1))
                           * rng.uniform(-5, 5, fshape)).astype(np.float32),
    })
    p.pop("noise", None)
    p.pop("blur", None)
    return p


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    return rng.random((B, T, HW, HW, 3), np.float32)


def _both(params, clips, key):
    """(port, JAX) outputs of apply_augmentations on the same params and the
    JAX noise draw of `key`."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = np.asarray(jda.apply_augmentations(jp, jnp.asarray(clips), key))
    noise = np.asarray(jax.random.normal(key, clips.shape, jnp.float32))
    ours = tda.apply_augmentations(_to_torch(params), torch.from_numpy(clips),
                                   torch.from_numpy(noise.copy())).numpy()
    return ours, ref


def _hold(ours, ref, with_color: bool):
    err = np.abs(ours - ref)
    assert np.isfinite(ours).all() and ours.shape == ref.shape
    if with_color:
        share = float(np.mean(err <= ATOL))
        assert share >= COLOR_SHARE, (share, float(err.max()))
    else:
        assert float(err.max()) <= ATOL, float(err.max())


CASES = {
    "color": dict(do_color=1.0),
    "flip": dict(do_flip=1.0),
    "noise": dict(noise=1.0),
    "blur3": dict(blur=1),
    "blur5": dict(blur=2),
    "blur7": dict(blur=3),
    "letterbox": dict(do_letterbox=1.0),
    "overlay": dict(do_overlay=1.0),
    "rotation": dict(do_rotation=1.0),
    "all": dict(do_color=1.0, do_flip=1.0, noise=1.0, blur=3, do_letterbox=1.0,
                do_overlay=1.0, do_rotation=1.0),
}


@pytest.mark.parametrize("per_frame", [False, True], ids=["per_clip", "per_frame"])
@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax(clips, case, per_frame):
    rng = np.random.default_rng(len(case) * 7 + per_frame)
    params = _forced(rng, per_frame, **CASES[case])
    ours, ref = _both(params, clips, jax.random.PRNGKey(3))
    if case != "color":
        assert np.abs(ref - clips).max() > 1e-3, "the transform did nothing"
    _hold(ours, ref, with_color=case in ("color", "all"))


def test_sampled_draw_matches_jax(clips):
    """A JAX-sampled draw with per-frame params (gates as drawn)."""
    key = jax.random.PRNGKey(11)
    k_params, k_noise = jax.random.split(key)
    params = jda.sample_params(k_params, B, HW, num_frames=T)
    ours, ref = _both({k: np.asarray(v) for k, v in params.items()}, clips, k_noise)
    _hold(ours, ref, with_color=True)


def test_mask_rezeroes_padding_like_jax(clips):
    """augment_clips with a mask: padded frames zero after contrast,
    letterbox and overlay moved them, as JAX's augment_clips."""
    mask = np.ones((B, T), bool)
    mask[0, 4:] = False
    mask[1, 2:] = False
    padded = clips * mask[:, :, None, None, None]
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jda.augment_clips(key, jnp.asarray(padded), jnp.asarray(mask)))
    k_params, k_noise = jax.random.split(key)
    params = jda.sample_params(k_params, B, HW, num_frames=T)
    drawn = {"params": _to_torch(params),
             "noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, padded.shape)))}
    ours = tda.apply_drawn(drawn, torch.from_numpy(padded), torch.from_numpy(mask)).numpy()
    assert (ours[~mask] == 0).all()
    _hold(ours, ref, with_color=True)


def test_sample_params_rates_and_ranges():
    g = torch.Generator().manual_seed(0)
    n, frames = 4096, 8
    p = tda.sample_params(g, n, HW, num_frames=frames)
    for key in ("letterbox_bar", "letterbox_vertical", "rotation_angle"):
        assert p[key].shape == (n, frames), key
    assert p["overlay_box"].shape == (n, frames, 4)
    for key in ("do_color", "do_flip", "blur_idx", "brightness",
                "hue_shift", "noise_level", "do_rotation"):
        assert p[key].shape == (n,), key
    rates = {"do_color": 0.7, "do_flip": 0.5, "noise": 0.3, "blur": 0.5,
             "do_letterbox": 0.3, "do_overlay": 0.2, "do_rotation": 0.2}
    got = {"noise": (p["noise_level"] > 0).float().mean(),
           "blur": (p["blur_idx"] > 0).float().mean()}
    for key, rate in rates.items():
        share = float(got[key] if key in got else p[key].mean())
        assert abs(share - rate) <= 4.5 * np.sqrt(rate * (1 - rate) / n), (key, share)
    for key, lo, hi in (("brightness", 0.5, 1.5), ("contrast", 0.5, 1.5),
                        ("saturation", 0.5, 1.5), ("hue_shift", -0.1, 0.1)):
        assert lo <= float(p[key].min()) and float(p[key].max()) <= hi, key
        assert float(p[key].max() - p[key].min()) > 0.9 * (hi - lo), key
    active = p["noise_level"][p["noise_level"] > 0]
    assert 0.02 <= float(active.min()) and float(active.max()) <= 0.1
    assert set(p["blur_idx"].unique().tolist()) == {0, 1, 2, 3}
    assert set(p["letterbox_bar"].unique().tolist()) == set(range(5, 16))
    oy, ox, oh, ow = p["overlay_box"].unbind(-1)
    assert set(oh.unique().tolist()) == set(range(10, 21))
    assert set(ow.unique().tolist()) == set(range(30, 61))
    # the reference's inclusive bound: the box may touch the frame's edge
    assert bool((oy >= 0).all() and (oy + oh <= HW).all() and (oy + oh == HW).any())
    assert bool((ox >= 0).all() and (ox + ow <= HW).all() and (ox + ow == HW).any())
    ang = p["rotation_angle"]
    gated = p["do_rotation"] > 0
    assert bool((ang[~gated] == 0).all())
    assert -5 <= float(ang.min()) and float(ang.max()) <= 5 and float(ang.abs().max()) > 4.9
    # per-frame draws vary along a clip
    assert bool((p["letterbox_bar"].float().std(dim=1) > 0).all())
    assert p["rotation_angle"].dtype == torch.float32 and p["blur_idx"].dtype == torch.int64


def test_augment_clips_is_deterministic_per_generator(clips):
    x = torch.from_numpy(clips)
    a = tda.augment_clips(torch.Generator().manual_seed(7), x)
    b = tda.augment_clips(torch.Generator().manual_seed(7), x)
    c = tda.augment_clips(torch.Generator().manual_seed(8), x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1


# -------------------------------------------------------------- train step

class _NoDropout(flax.linen.Module):
    rate: float = 0.0
    deterministic: Optional[bool] = None

    @flax.linen.compact
    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture
def _no_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


@pytest.fixture(scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


SB, ST, SHW = 4, 8, 32


def _jax_step_draws(rng, step, model_type):
    """The augmentation and extract draws inside the JAX train step at
    `step` (train_step.py:195, :204-209, :213-220 after the fold_in of
    :322), as the port's `draws` argument."""
    rng = jax.random.fold_in(rng, step)
    d_rng, e_rng1, _ = jax.random.split(rng, 3)
    a_rng1, a_rng2, _ = jax.random.split(d_rng, 3)
    draws = {}
    for side, a_rng in (("aug1", a_rng1), ("aug2", a_rng2)):
        k_params, k_noise = jax.random.split(a_rng)
        params = jda.sample_params(k_params, SB, SHW, num_frames=ST)
        noise = jax.random.normal(k_noise, (SB, ST, SHW, SHW, 3), jnp.float32)
        draws[side] = {"params": _to_torch(params),
                       "noise": torch.from_numpy(np.array(noise))}
    if model_type == "attention":
        from video_fingerprint_tpu.training import train_step as jax_ts

        k_len, e_rng1, e_rng2 = jax.random.split(e_rng1, 3)
        lengths = jax_ts.sample_extract_lengths(k_len, SB, ST, 0.5)
        draws.update({
            "lengths": torch.from_numpy(np.asarray(lengths).astype(np.int64)),
            "u1": torch.from_numpy(np.asarray(jax.random.uniform(e_rng1, (SB,)))),
            "u2": torch.from_numpy(np.asarray(jax.random.uniform(e_rng2, (SB,))))})
    return draws


@pytest.mark.parametrize("model_type", ["attention", "3d"])
def test_train_step_with_device_augment_matches_jax(_no_dropout, _few_threads, model_type):
    from video_fingerprint_tpu.models import create_model as jax_create_model
    from video_fingerprint_tpu.training import optim as jax_optim
    from video_fingerprint_tpu.training import train_step as jax_ts
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.training import optim, train_step
    from video_fingerprint_tpu_torch.utils.torch_compat import (
        state_dict_to_variables,
        variables_to_state_dict,
    )

    dims = (dict(spatial_dim=16, temporal_dim=32, num_attention_blocks=1)
            if model_type == "attention" else dict(frame_stride=4))
    torch.manual_seed(0)
    sd = {k: v.detach().numpy() for k, v in create_model(model_type, **dims).state_dict().items()}
    variables = state_dict_to_variables(sd, model_type)
    rng = np.random.default_rng(3)
    clips = rng.integers(0, 256, (2, SB, ST, SHW, SHW, 3), dtype=np.uint8)
    batch = {"clip1": clips[0], "clip2": clips[1], "video_id": np.array([0, 1, 0, 2], np.int32)}
    if model_type == "attention":
        masks = np.ones((2, SB, ST), bool)
        masks[0, 1, 5:] = False
        masks[1, 2, 3:] = False
        clips[~masks] = 0
        batch.update(mask1=masks[0], mask2=masks[1])

    kw = dict(epochs=2, steps_per_epoch=1) if model_type == "3d" else dict(total_steps=10)
    tx = jax_optim.make_optimizer(model_type, variables["params"], 1e-3, **kw)
    state = jax_ts.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]),
                              step=jnp.asarray(0, jnp.int32))
    step_fn = jax.jit(jax_ts.make_train_step(jax_create_model(model_type, **dims), tx,
                                             model_type, device_augment=True))
    port = create_model(model_type, **dims)
    port.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in
                          variables_to_state_dict(variables, model_type).items()}, strict=True)
    for mod in port.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    opt = optim.make_optimizer(model_type, port, 1e-3, **kw)
    port_step = train_step.make_train_step(port, opt, model_type, device_augment=True)
    tbatch = {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()}
    key = jax.random.PRNGKey(5)
    for step in range(2):
        state, ref = step_fn(state, batch, key)
        draws = _jax_step_draws(key, step, model_type)
        ours = port_step(tbatch, draws, step)
        np.testing.assert_allclose(float(ours["loss"]), float(ref["loss"]),
                                   rtol=1e-5 if step == 0 else 1e-4)
        np.testing.assert_allclose(float(ours["grad_norm"]), float(ref["grad_norm"]),
                                   rtol=1e-3)
        assert float(ours["acc"]) == float(ref["acc"])
