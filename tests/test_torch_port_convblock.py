"""The port's conv-block conv (video_fingerprint_tpu_torch/ops/convblock.py)
against the JAX probe's (tools/exp_pallas_convblock.py): both Pallas kernels
in interpret mode and XLA's lax.conv_general_dilated, and, at the scan's own
layer, against the port model's encoder[6:9] on the fused JAX weights.

On the CPU the port runs its plain version; the hand-written CUDA kernel is
held against that plain version on the card (tests/test_torch_port_kernels.py
and chip_smoke.py).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT
from video_fingerprint_tpu.models import create_model as jax_create_model
from video_fingerprint_tpu.models.fuse import fuse_variables
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.ops import convblock as cb
from video_fingerprint_tpu_torch.utils.torch_compat import attention_variables_to_state_dict

FRAMES = 256  # two of the Pallas grid's 128-frame steps


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_convblock", REPO_ROOT / "tools" / "exp_pallas_convblock.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def inputs():
    """The JAX probe's numerics inputs, rounded to bf16 once and handed to
    both frameworks as the same values: x (64, 16, 16, N), the HWIO kernel
    and the bias, as float32 arrays holding bf16 values."""
    rng = np.random.default_rng(0)
    x_nhwc = rng.standard_normal((FRAMES, 16, 16, 64)).astype(np.float32)
    k_hwio = (rng.standard_normal((3, 3, 64, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    return bf16(np.ascontiguousarray(x_nhwc.transpose(3, 1, 2, 0))), bf16(k_hwio), bf16(b)


def _port_args(x, k_hwio, b):
    return (torch.from_numpy(x).to(torch.bfloat16), cb.hwio_to_w2d(k_hwio),
            torch.from_numpy(b).reshape(128, 1).to(torch.bfloat16))


def _assert_one_ulp(got, ref):
    assert got.shape == ref.shape == (128, 8, 8, FRAMES) and got.dtype == torch.bfloat16
    err, ok = cb.compare(got, ref, cb.ONE_ULP)
    assert ok, err


@pytest.mark.parametrize("strided", [False, True], ids=["parity_K2", "strided_K3"])
def test_plain_matches_pallas_and_xla(probe, inputs, strided):
    x, k_hwio, b = inputs
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    w2d_j = jb(np.transpose(k_hwio, (3, 0, 1, 2)).reshape(128, 576))
    conv = probe.make_pallas_conv(interpret=True, strided=strided)
    if strided:
        pallas = conv(jb(x), None, w2d_j, jb(b.reshape(128, 1)))
    else:
        pallas = conv(jb(x[:, :, 0::2]), jb(x[:, :, 1::2]), w2d_j, jb(b.reshape(128, 1)))
    xla = jax.lax.conv_general_dilated(
        jb(x.transpose(3, 1, 2, 0)), jb(k_hwio), (2, 2), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.float32)
    xla = jnp.maximum(xla + b, 0.0).astype(jnp.bfloat16).transpose(3, 1, 2, 0)

    tx, w2d, tb = _port_args(x, k_hwio, b)
    ours = cb.conv_strided(tx, w2d, tb) if strided else cb.conv_parity(
        *cb.split_parity(tx), w2d, tb)
    for ref in (pallas, xla):
        _assert_one_ulp(ours, torch.from_numpy(np.asarray(ref, np.float32)))
    # and within half an ulp of the exact function
    err, ok = cb.compare(ours, cb.f64_oracle(tx, w2d, tb), cb.VS_F64)
    assert ok, err


@pytest.mark.parametrize("n", [FRAMES, 200])
def test_parity_split_equals_full_input(inputs, n):
    """conv_parity on split_parity's views computes conv_strided's result
    bit for bit, ragged frame counts included."""
    x, k_hwio, b = inputs
    tx, w2d, tb = _port_args(np.ascontiguousarray(x[..., :n]), k_hwio, b)
    full = cb.conv_strided(tx, w2d, tb)
    assert full.shape == (128, 8, 8, n)
    assert torch.equal(cb.conv_parity(*cb.split_parity(tx), w2d, tb), full)


def test_hwio_to_w2d_layouts(inputs):
    """The probe's (dy, dx, ci) column order from a flax HWIO kernel, and
    the same w2d from a torch OIHW Conv2d weight."""
    _, k_hwio, _ = inputs
    w2d = cb.hwio_to_w2d(k_hwio)
    assert w2d.shape == (128, 576) and w2d.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w2d.float().numpy(), np.transpose(k_hwio, (3, 0, 1, 2)).reshape(128, 576))
    oihw = torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))
    assert torch.equal(cb.hwio_to_w2d(oihw), w2d)
    with pytest.raises(ValueError, match="weight"):
        cb.hwio_to_w2d(np.zeros((3, 3, 32, 64), np.float32))


def test_scan_layer_on_fused_jax_weights():
    """The layer the probe stands for: the fused JAX kernel of
    spatial_encoder/conv2 through hwio_to_w2d and conv_strided, on the bf16
    port model's encoder[:6] activations, equals the port's encoder[6:9]."""
    model = jax_create_model("attention")
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 64, 64, 3)))
    rng = np.random.default_rng(3)
    # BN statistics of their own (means near 0, variances near 1), so the
    # folded layer is not the identity fold and ReLU leaves much alive
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0.0, 0.05, a.shape) if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    variables = jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                                    "batch_stats": stats})
    conv2 = fuse_variables(variables)["params"]["spatial_encoder"]["conv2"]["conv"]
    port = create_model("attention", fused=True)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          fuse_state_dict(attention_variables_to_state_dict(variables)).items()},
                         strict=True)
    encoder = port.to(torch.bfloat16).eval().spatial_encoder.encoder

    frames = torch.from_numpy(rng.integers(0, 256, (64, 64, 64, 3), dtype=np.uint8))
    with torch.inference_mode():
        act = encoder[:6](frames.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0)
        ref = encoder[6:9](act).permute(1, 2, 3, 0)
        b = torch.from_numpy(np.asarray(conv2["bias"])).reshape(128, 1).to(torch.bfloat16)
        ours = cb.conv_strided(act.permute(1, 2, 3, 0).contiguous(),
                               cb.hwio_to_w2d(conv2["kernel"]), b)
    assert ours.shape == ref.shape == (128, 8, 8, 64)
    assert float((ref > 0).float().mean()) > 0.1  # ReLU leaves much alive
    err, ok = cb.compare(ours, ref, cb.ONE_ULP)
    assert ok, err


@pytest.mark.parametrize("entry", ["conv_parity", "conv_strided"])
def test_wrapper_raises_on_a_device_without_kernel(entry):
    meta = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16, device="meta")
    w2d, b = meta(128, 576), meta(128, 1)
    with pytest.raises(RuntimeError, match="no conv kernel"):
        if entry == "conv_parity":
            cb.conv_parity(meta(64, 16, 8, 4), meta(64, 16, 8, 4), w2d, b)
        else:
            cb.conv_strided(meta(64, 16, 16, 4), w2d, b)


def test_probe_runs_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "video_fingerprint_tpu_torch.tools.convblock_probe",
         "--device", "cpu"], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["leg"] == "numerics" and row["device"] == "cpu"
    assert 0 < row["max_abs_delta"]["plain_vs_f64"] < 0.1
