"""The port's augmentation tools (video_fingerprint_tpu_torch/tools/
exp_augment_hotspot.py and bench_device_augment.py) against the JAX tools,
on the CPU:

- every hotspot stage equals the JAX tool's stage lambda (the same
  expressions over video_fingerprint_tpu/ops/device_augment.py) on the same
  parameters (a JAX draw, converted; and every gate forced on) and the same
  inputs, the noise stages fed the JAX noise draws: within 1e-5, and for
  color and the whole pipeline by the share of elements within 1e-5
  (>= 99.99 %: a pixel on an HSV sector boundary may round the other way,
  as tests/test_torch_port_device_augment.py holds it);
- the tool's `_letterbox_overlay` equals the JAX tool's (1e-5);
- bench_device_augment runs end to end with --device cpu on a 3-video
  corpus (0 workers, B = 2, T = 8) and prints exactly the JAX tool's keys;
  the hotspot runs each stage once on the CPU, with null times.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from tools import exp_augment_hotspot as jax_hotspot
from video_fingerprint_tpu.ops import device_augment as jda
from video_fingerprint_tpu_torch.tools import bench_device_augment, exp_augment_hotspot

B, T, HW = 2, 4, 64
ATOL = 1e-5
SHARE = 0.9999
SHARED = ("color", "full_pipeline")  # held by the share of elements within ATOL


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_stages(params, B):
    """The JAX tool's stage lambdas (tools/exp_augment_hotspot.py:60-73)."""
    da = jda
    return {
        "color": lambda x: da._color(x, params),
        "flip": lambda x: jnp.where(
            params["do_flip"].reshape((B, 1, 1, 1, 1)) > 0, x[:, :, :, ::-1, :], x),
        "noise": lambda x: jnp.clip(
            x + jax.random.normal(jax.random.PRNGKey(1), x.shape, x.dtype)
            * params["noise_level"].reshape((B, 1, 1, 1, 1)), 0.0, 1.0),
        "blur": lambda x: da._blur(x, params["blur_idx"]),
        "letterbox_overlay": lambda x: jax_hotspot._letterbox_overlay(jnp, params, x),
        "rotation": lambda x: da._rotate_bilinear(x, params["rotation_angle"]),
        "full_pipeline": lambda x: da.apply_augmentations(params, x, jax.random.PRNGKey(2)),
    }


def _params(forced: bool):
    """A JAX per-frame draw as numpy; `forced` turns every gate on."""
    p = jda.sample_params(jax.random.PRNGKey(0), batch=B, frame_size=HW, num_frames=T)
    p = {k: np.asarray(v) for k, v in p.items()}
    if forced:
        for name in ("do_color", "do_flip", "do_letterbox", "do_overlay", "do_rotation"):
            p[name] = np.ones((B,), np.float32)
        p["noise_level"] = np.full((B,), 0.05, np.float32)
        p["blur_idx"] = np.array([2, 3], np.int32)
        p["rotation_angle"] = np.full((B, T), 3.5, np.float32)
    return p


def _to_torch(params):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v.copy())
            for k, v in params.items()}


def _hold(ours, ref, by_share: bool):
    err = np.abs(ours - ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    if by_share:
        assert float(np.mean(err <= ATOL)) >= SHARE, float(err.max())
    else:
        assert float(err.max()) <= ATOL, float(err.max())


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(0).random((B, T, HW, HW, 3), np.float32)


@pytest.mark.parametrize("forced", [False, True], ids=["sampled", "gates_on"])
@pytest.mark.parametrize("stage", exp_augment_hotspot.STAGES)
def test_hotspot_stage_matches_jax(clips, stage, forced):
    params = _params(forced)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = np.asarray(_jax_stages(jp, B)[stage](jnp.asarray(clips)))
    noise, pipeline_noise = (
        torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), clips.shape,
                                                      jnp.float32)).copy())
        for seed in (1, 2))
    ours = exp_augment_hotspot.make_stages(_to_torch(params), noise, pipeline_noise)[stage](
        torch.from_numpy(clips)).numpy()
    _hold(ours, ref, stage in SHARED)


def test_letterbox_overlay_matches_jax_tool(clips):
    params = _params(forced=True)
    ref = np.asarray(jax_hotspot._letterbox_overlay(
        jnp, {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(clips)))
    ours = exp_augment_hotspot._letterbox_overlay(_to_torch(params), torch.from_numpy(clips))
    _hold(ours.numpy(), ref, by_share=False)
    assert not np.array_equal(ref, clips)  # the forced gates changed something


def test_hotspot_runs_on_cpu(capsys):
    assert exp_augment_hotspot.main(["--device", "cpu", "--batch", "2", "--frames", "2",
                                     "--k", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 2 and out["frames"] == 2 and out["k"] == 2
    assert all(out[f"{s}_ms_per_iter"] is None for s in exp_augment_hotspot.STAGES)


def _jax_keys(path: Path) -> set:
    """The keys of the JAX tool's printed JSON object."""
    src = path.read_text()
    start = src.index("print(json.dumps({")
    return set(re.findall(r'"(\w+)":', src[start:src.index("}))", start)]))


def test_bench_device_augment_runs_with_jax_keys(tmp_path, capsys):
    argv = ["--device", "cpu", "--videos", "3", "--frames", "16", "--batch", "2",
            "--workers", "0", "--steps", "1", "--step_batch", "2", "--step_frames", "8",
            "--cache-dir", str(tmp_path)]
    assert bench_device_augment.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# ") and json.loads(lines[0][2:])["device"] == "cpu"
    out = json.loads(lines[-1])
    assert set(out) == _jax_keys(REPO_ROOT / "tools" / "bench_device_augment.py")
    assert out["step_batch"] == 2 and out["step_frames"] == 8
    for key in ("loader_samples_per_sec_host_augment", "loader_samples_per_sec_device_mode",
                "train_steps_per_sec_augment_off", "train_steps_per_sec_device_augment"):
        assert out[key] > 0, key
    assert out["loader_speedup"] == pytest.approx(out["loader_samples_per_sec_device_mode"]
                                                  / out["loader_samples_per_sec_host_augment"])
    assert (tmp_path / "corpus_v3_f16" / ".complete").exists()
