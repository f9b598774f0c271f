"""The port's attention bucket probe (video_fingerprint_tpu_torch/tools/
exp_attention_buckets.py) on the CPU: its inputs are the JAX tool's numpy
draws, and its plain leg equals JAX `fused_attention(..., use_pallas=False)`
(the JAX tool's jnp leg) within 1e-5 in f32 at T = 32 and 64, B·H = 16,
D = 32 and D = 4; the tool runs end to end with no kernel and no timing."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_fingerprint_tpu.ops.attention import fused_attention
from video_fingerprint_tpu_torch.tools import exp_attention_buckets as eab

BH = 16


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("D", [32, 4])
def test_plain_leg_matches_jax(D):
    rng = np.random.default_rng(0)
    for T in (32, 64):
        q, k, v = eab.bucket_inputs(rng, BH, T, D)
        ref = np.asarray(fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         use_pallas=False))
        ours = eab.plain(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
        assert ours.shape == (BH, T, D)
        assert float(np.abs(ours - ref).max()) <= 1e-5, (T, D)


def test_bound_counts():
    # bf16 at T = 128, D = 32: 4 * 128 * 128 * 32 * 2 bytes against 4 * 128 * 128^2 * 32 ops
    us, by = eab.bound_us(128, 128, 32, "bfloat16")
    assert by == "bytes" and us == pytest.approx(4 * 128 * 128 * 32 * 2 / 3.35e12 * 1e6)
    us, by = eab.bound_us(128, 512, 32, "float32")
    assert by == "operations" and us == pytest.approx(4 * 128 * 512 ** 2 * 32 / 67e12 * 1e6)


def test_tool_runs_on_cpu(capsys):
    argv = ["--device", "cpu", "--batch", "2", "--buckets", "32", "64", "--dim", "32", "4"]
    assert eab.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines[1:-1]]
    final = json.loads(lines[-1])
    assert [(r["D"], r["T"]) for r in rows] == [(32, 32), (32, 64), (4, 32), (4, 64)]
    assert final["table"] == rows and final["decision"] == "no timing on the CPU"
    for r in rows:
        assert r["BH"] == BH and r["dtype"] == "float32"
        assert r["k1_us_per_call"] is None and r["plain_us_per_call"] is None
        assert r["plain_max_abs"] > 0
