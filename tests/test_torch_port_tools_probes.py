"""The probes of the headline's input and conv stack, ported
(video_fingerprint_tpu_torch/tools/exp_input_layout.py, exp_layout_probe.py,
exp_int8_conv.py, exp_ingraph_forward.py), on the CPU at tiny sizes through
the JAX tools' environment variables and flags:

- each prints exactly the JAX tool's keys in its last line, each time or
  rate > 0 (host-clock times on the CPU: no device figure);
- exp_input_layout's conv0 (the seeded fused model's, carried across) equals
  JAX's lax.conv_general_dilated + bias + ReLU on the same weights, within
  1e-4 in f32;
- exp_ingraph_forward's in-graph loop sums the same K embeddings as K eager
  forwards, within 1e-4 in f32;
- exp_int8_conv's draws are the JAX probe's, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from video_fingerprint_tpu_torch.tools import (
    exp_ingraph_forward,
    exp_input_layout,
    exp_int8_conv,
    exp_layout_probe,
)
from video_fingerprint_tpu_torch.tools.bench_headline import fused_model

CPU = torch.device("cpu")
# the last JSON line's keys of each JAX tool (tools/<name>.py)
JAX_KEYS = {
    "exp_int8_conv": ["bf16_conv0_ms", "int8_conv0_ms", "bf16_stack_ms", "int8_stack_ms"],
    "exp_input_layout": ["c3_convert_ms", "flat_convert_ms", "flat_reshape_ms",
                         "c3_conv0_ms", "flat_conv0_ms"],
    "exp_layout_probe": ["batch", "frames", "k", "mult_nhwc_ms", "mult_nchw_ms",
                         "transpose_roundtrip_ms"],
    "exp_ingraph_forward": ["ingraph_ms_per_batch", "ingraph_vps", "pipelined_ms_per_batch",
                            "pipelined_vps", "ingraph_over_pipelined"],
}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(module, argv, capsys):
    assert module.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# ")
    return [json.loads(line) for line in lines[1:]]


@pytest.mark.parametrize("name, argv, env", [
    ("exp_int8_conv", [], {"EXP_N": "3", "EXP_K": "2", "EXP_REPS": "2"}),
    ("exp_input_layout", [], {"EXP_N": "3", "EXP_K": "2", "EXP_REPS": "2"}),
    ("exp_layout_probe", ["--batch", "2", "--frames", "3", "--k", "2"], {}),
    ("exp_ingraph_forward", [], {"EXP_B": "2", "EXP_T": "4", "EXP_K": "2", "EXP_REPS": "2"}),
])
def test_tool_prints_jax_keys(name, argv, env, capsys, monkeypatch):
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    module = {"exp_int8_conv": exp_int8_conv, "exp_input_layout": exp_input_layout,
              "exp_layout_probe": exp_layout_probe,
              "exp_ingraph_forward": exp_ingraph_forward}[name]
    lines = _run(module, [*argv, "--device", "cpu"], capsys)
    final = lines[-1]
    assert list(final) == JAX_KEYS[name], final
    assert all(isinstance(v, (int, float)) and v > 0 for v in final.values()), final
    if name == "exp_layout_probe":
        assert (final["batch"], final["frames"], final["k"]) == (2, 3, 2)
    elif name == "exp_ingraph_forward":
        assert lines[0]["ingraph"] == final["ingraph_vps"] and len(lines[0]["reps_s"]) == 2
    else:  # one line per leg, then the result
        assert [list(line) for line in lines[:-1]] == [[k] for k in JAX_KEYS[name]]


def test_input_layout_conv0_matches_jax():
    conv0 = exp_input_layout.conv0_layer(CPU, torch.float32)
    w = conv0[0].weight.detach().numpy()   # (32, 3, 5, 5), BatchNorm folded
    b = conv0[0].bias.detach().numpy()
    x = np.random.default_rng(0).random((3, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        ours = exp_input_layout.frames_conv0(conv0)(torch.from_numpy(x))
    y = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                                 (2, 2), ((2, 2), (2, 2)),
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                 precision=lax.Precision.HIGHEST)
    ref = np.asarray(jax.nn.relu(y + jnp.asarray(b)))
    assert ours.shape == (3, 32, 32, 32)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-4)


def test_input_layout_offsets_are_jax_bf16():
    for i in (0, 1, 7, 19):
        ref = float(jnp.asarray(i).astype(jnp.bfloat16) * jnp.bfloat16(1e-3))
        assert exp_input_layout.offset(i) == ref


def test_ingraph_sum_equals_eager_forwards():
    model = fused_model(0, CPU, torch.float32)
    staged = exp_ingraph_forward.staged_batches(0, 2, 4, CPU)
    k = 3
    with torch.no_grad():
        got = exp_ingraph_forward.ingraph_sum(model, staged, 2, k)
        ref = sum(float(model.forward_flat(staged[i % 2], 2).sum()) for i in range(k))
    assert abs(got - ref) <= 1e-4


def test_int8_probe_draws_equal_jax_tool():
    """The port draws the JAX probe's weights and scales in its order, so the
    frames that follow from the generator are the probe's too."""
    ws_f, bs_f, ws_q, w_scales, a_scales = exp_int8_conv.probe_weights(
        np.random.default_rng(0))
    rng = np.random.default_rng(0)
    for (k, ci, co), wf, bf, wq, s in zip(exp_int8_conv.SPECS, ws_f, bs_f, ws_q, w_scales):
        np.testing.assert_array_equal(wf, rng.normal(0, 0.1, (k, k, ci, co)).astype(np.float32))
        assert wq.dtype == np.int8 and wq.shape == (k, k, ci, co)
        ref = np.abs(wf).reshape(-1, co).max(axis=0) / 127.0
        np.testing.assert_array_equal(s, ref.astype(np.float32))
        np.testing.assert_array_equal(wq, np.clip(np.round(wf / ref), -127, 127).astype(np.int8))
    for (_, _, co), bf in zip(exp_int8_conv.SPECS, bs_f):
        np.testing.assert_array_equal(bf, rng.normal(0, 0.1, co).astype(np.float32))
    assert a_scales == [np.float32(0.05)] * 4
