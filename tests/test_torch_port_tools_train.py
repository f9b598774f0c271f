"""The port's train-step tools (video_fingerprint_tpu_torch/tools/
bench_train_step.py and exp_train_roofline.py) on the CPU at small widths:

- `run` with 5 steps and a window of 2 reads the loss back after steps 2
  and 4 and once more after step 5 (the tail drain), before its timer
  stops; with a window of 1, after every step;
- bench_train_step end to end (the full-width model, B = 2, T = 8,
  --steps 5 --window 2) syncs 1 + 5 + 3 times and prints the JAX tool's
  keys, the rates > 0;
- exp_train_roofline at spatial / temporal / embedding widths 16 / 32 / 32,
  B = 2, T = 8, R = 2 prints its four legs (rates with `_dispatched`),
  their operation counts from utils/flops.py, and the derived keys, with
  bwd_opt_ms_* = 1000 (1/step - 1/fwd).
"""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.tools import bench_train_step, exp_train_roofline
from video_fingerprint_tpu_torch.training.train_step import draw_extracts, make_loss_fn
from video_fingerprint_tpu_torch.utils.flops import loss_flops

SMALL = ["--spatial_dim", "16", "--temporal_dim", "32", "--embedding_dim", "32"]


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("window, syncs_after", [(2, [2, 4, 5]), (1, [1, 2, 3, 4, 5]),
                                                 (5, [5]), (10, [5])])
def test_run_syncs_per_window_and_drains_the_tail(window, syncs_after):
    events = []

    def step_once(i):
        events.append(("step", i + 1))
        return {"loss": float(i)}

    def sync(metrics):
        events.append(("sync", int(metrics["loss"]) + 1))
        return metrics["loss"]

    rate = bench_train_step.run(step_once, 5, window, sync)
    assert rate > 0
    assert [n for kind, n in events if kind == "sync"] == syncs_after
    assert events[-1] == ("sync", 5)  # the last step is read back before the timer stops


def test_bench_train_step_runs(capsys):
    syncs = []

    def sync(metrics):
        syncs.append(1)
        return bench_train_step.read_loss(metrics)

    argv = ["--device", "cpu", "--batch", "2", "--frames", "8", "--steps", "5",
            "--window", "2"]
    assert bench_train_step.main(argv, sync=sync) == 0
    assert len(syncs) == 1 + 5 + 3  # warm, every step, every 2nd and the tail
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"batch", "frames", "steps", "steps_per_sec_sync_every_step",
            "steps_per_sec_sync_every_2", "speedup", "device"} <= set(out)
    assert out["device"] == "cpu" and out["steps"] == 5
    assert out["steps_per_sec_sync_every_step"] > 0 and out["steps_per_sec_sync_every_2"] > 0
    assert out["speedup"] == pytest.approx(out["steps_per_sec_sync_every_2"]
                                           / out["steps_per_sec_sync_every_step"])


def test_train_roofline_legs_and_derived_keys(capsys):
    argv = ["--device", "cpu", "--b", "2", "--t", "8", "--r", "2", "--timings", "2", *SMALL]
    assert exp_train_roofline.main(argv) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 5  # one line per leg, then the derived line
    out = lines[-1]
    assert out["B"] == 2 and out["T"] == 8 and out["R"] == 2 and out["flops_source"]
    for tag in ("step_base", "step_reuse"):
        assert out[f"{tag}_steps_per_sec_dispatched"] > 0
        assert 0 < out[f"{tag}_mfu_dispatched"] < 1
    for tag in ("fwd_base", "fwd_reuse"):
        assert out[f"{tag}_per_sec_dispatched"] > 0
    for tag, _ in exp_train_roofline.LEGS:
        assert out[f"{tag}_tflops"] > 0 and out[f"{tag}_achieved_tflops_s_dispatched"] > 0
        assert out[f"{tag}_compile_s_dispatched"] > 0
    # reuse encodes every frame once: fewer operations, forward and step
    assert out["step_reuse_tflops"] < out["step_base_tflops"]
    assert out["fwd_reuse_tflops"] < out["fwd_base_tflops"] < out["step_base_tflops"]
    for mode in ("base", "reuse"):
        step = out[f"step_{mode}_steps_per_sec_dispatched"]
        fwd = out[f"fwd_{mode}_per_sec_dispatched"]
        assert out[f"bwd_opt_ms_{mode}"] == pytest.approx(1000 * (1 / step - 1 / fwd), rel=1e-12)
    assert out["reuse_step_speedup"] == pytest.approx(
        out["step_reuse_steps_per_sec_dispatched"] / out["step_base_steps_per_sec_dispatched"])
    assert out["reuse_fwd_speedup"] == pytest.approx(
        out["fwd_reuse_per_sec_dispatched"] / out["fwd_base_per_sec_dispatched"])


def test_train_roofline_only_runs_the_named_legs(capsys):
    argv = ["--device", "cpu", "--b", "2", "--t", "8", "--r", "1", "--timings", "1",
            "--only", "fwd_reuse", *SMALL]
    assert exp_train_roofline.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fwd_reuse_per_sec_dispatched"] > 0
    assert "step_base_steps_per_sec_dispatched" not in out and "bwd_opt_ms_base" not in out


@pytest.mark.parametrize("fast", [False, True], ids=["base", "reuse"])
def test_loss_flops_match_flop_counter(fast):
    """utils/flops.py::loss_flops, the fwd legs' count, against
    FlopCounterMode on the loss alone (the plain CPU path, where attention
    is matmuls), as tests/test_torch_port_bench_legs.py holds the step's."""
    B, T = 3, 8
    torch.manual_seed(0)
    model = create_model("attention", spatial_dim=16, temporal_dim=32, embedding_dim=32).train()
    rng = np.random.default_rng(0)
    batch = {"clip1": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "clip2": rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8),
             "mask1": np.ones((B, T), bool), "mask2": np.ones((B, T), bool),
             "video_id": np.arange(B)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = make_loss_fn(model, "attention", reuse_extract_features=fast)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        loss_fn(batch, draw_extracts(torch.Generator().manual_seed(0), B, T, 0.5))
    assert loss_flops(model, B, T, fast_extracts=fast) == pytest.approx(
        counter.get_total_flops(), rel=1e-3)
