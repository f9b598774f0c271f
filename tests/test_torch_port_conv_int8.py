"""K4's plain version (video_fingerprint_tpu_torch/ops/conv_int8.py) against
the JAX probe's int8 conv (tools/exp_int8_conv.py:79-93: an XLA int8 conv,
preferred_element_type int32, then the f32 dequantize + bias + ReLU and the
requantize, jitted as the probe jits it), on the probe's four layer shapes
and weights and seeded numpy inputs:

- the int32 sums are equal;
- the requantized int8 is within 1 LSB, on at most 0.1 % of the elements
  (XLA may fold the division by the constant scale into a multiplication,
  or contract y * w_s + b, where the plain version rounds each step);
- the bf16 output of the last conv is within 1 bf16 ulp, relative;
- the same for the four-layer stack, each layer fed JAX's output before it,
  at the probe's requant scale and at scales that spread the outputs over
  the int8 range (the probe's 0.05 saturates most of them);
- the uint8 -> int8 shift and the border of a uint8 frame (int8 0, pixel
  128) on their own.

The kernel itself runs only on a card (chip_smoke.py holds it to this plain
version bit for bit); on the CPU the wrapper runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from video_fingerprint_tpu_torch.ops import conv_int8 as ci
from video_fingerprint_tpu_torch.tools import exp_int8_conv as eic
from video_fingerprint_tpu_torch.utils import trace

N = 4


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def probe():
    """The JAX probe's weights (its own draws, numpy seed 0)."""
    ws_f, bs_f, ws_q, w_scales, a_scales = eic.probe_weights(np.random.default_rng(0))
    return {"bias": bs_f, "w": ws_q, "w_scale": w_scales, "requant": a_scales}


def _jax_conv_int8(x_i8, w_q, w_s, b, requant_s, last):
    """The probe's conv_int8 (tools/exp_int8_conv.py:79-93), jitted, with its
    int32 sums beside the output."""
    k = w_q.shape[0]
    pad = ((2, 2), (2, 2)) if k == 5 else ((1, 1), (1, 1))

    @jax.jit
    def f(x):
        y32 = lax.conv_general_dilated(x, jnp.asarray(w_q), window_strides=(2, 2),
                                       padding=pad,
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
        yf = jax.nn.relu(y32.astype(jnp.float32) * jnp.asarray(w_s) + jnp.asarray(b))
        if last:
            return y32, yf.astype(jnp.bfloat16)
        return y32, jnp.clip(jnp.round(yf / requant_s), -127, 127).astype(jnp.int8)

    y32, out = f(jnp.asarray(x_i8))
    return np.array(y32), np.array(out)


def _shifted(x_u8):
    """The probe's (x.astype(int16) - 128).astype(int8)."""
    return (x_u8.astype(np.int16) - 128).astype(np.int8)


def _assert_int8_close(ours, ref, what):
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, (what, diff.max())
    assert (diff > 0).mean() <= 1e-3, (what, (diff > 0).mean())


def _assert_bf16_close(ours, ref, what):
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    assert np.all(np.abs(ours - ref) <= 2.0 ** -7 * np.abs(ref)), what


def _ours(x, layer, probe, requant, last):
    w = torch.from_numpy(probe["w"][layer])
    acc = ci.conv_acc_plain(torch.from_numpy(x), w).numpy()
    out = ci.conv_int8(torch.from_numpy(x), w, torch.from_numpy(probe["w_scale"][layer]),
                       torch.from_numpy(probe["bias"][layer]), None if last else requant)
    return acc, out


def _check_layer(x, layer, probe, requant, last):
    """x: the layer's input (uint8 frames for conv0); returns JAX's output."""
    x_i8 = _shifted(x) if x.dtype == np.uint8 else x
    ref_acc, ref = _jax_conv_int8(x_i8, probe["w"][layer], probe["w_scale"][layer],
                                  probe["bias"][layer], np.float32(requant), last)
    acc, out = _ours(x, layer, probe, requant, last)
    what = f"conv{layer} requant={requant}"
    np.testing.assert_array_equal(acc, ref_acc, err_msg=what)
    if last:
        assert out.dtype == torch.bfloat16
        _assert_bf16_close(out, ref, what)
    else:
        assert out.dtype == torch.int8
        _assert_int8_close(out.numpy(), ref, what)
    return ref


@pytest.mark.parametrize("layer", range(4), ids=[f"conv{i}" for i in range(4)])
def test_layer_matches_jax(probe, layer):
    """Each layer shape on seeded inputs: int8 out at the probe's scale, bf16
    out as the last layer."""
    rng = np.random.default_rng(10 + layer)
    k, cin, _ = eic.SPECS[layer]
    size = 64 >> layer
    if layer == 0:
        x = rng.integers(0, 256, (N, size, size, cin), dtype=np.uint8)
    else:
        x = rng.integers(-127, 128, (N, size, size, cin)).astype(np.int8)
    _check_layer(x, layer, probe, probe["requant"][layer], last=False)
    _check_layer(x, layer, probe, probe["requant"][layer], last=True)


@pytest.mark.parametrize("scales", ["probe", "spread"])
def test_stack_matches_jax(probe, scales):
    """The four-layer stack, each layer fed JAX's output before it; conv3
    gives bf16. "spread": each requant scale the layer's largest JAX output
    over 100, so the int8 values fill the range and rounding decides."""
    x = np.random.default_rng(3).integers(0, 256, (N, 64, 64, 3), dtype=np.uint8)
    for layer in range(4):
        last = layer == 3
        requant = probe["requant"][layer]
        if scales == "spread" and not last:
            x_i8 = _shifted(x) if x.dtype == np.uint8 else x
            _, y = _jax_conv_int8(x_i8, probe["w"][layer], probe["w_scale"][layer],
                                  probe["bias"][layer], np.float32(1.0), True)
            requant = float(np.float32(np.asarray(y, np.float32).max() / 100.0))
        x = _check_layer(x, layer, probe, requant, last)
    assert x.shape == (N, 4, 4, 256)


def test_uint8_shift_and_border(probe):
    """uint8 pixels are shifted to int8 as x - 128; the padding reads int8 0
    (pixel 128): frames of 128 give all-zero sums, borders included, and a
    uint8 frame's sums equal its shifted int8 frame's and JAX's."""
    u = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(ci._as_int8(torch.from_numpy(u)).numpy(), _shifted(u))
    w = torch.from_numpy(probe["w"][0])
    gray = torch.full((2, 64, 64, 3), 128, dtype=torch.uint8)
    assert not ci.conv_acc_plain(gray, w).any()
    frames = np.full((2, 64, 64, 3), 255, dtype=np.uint8)
    frames[1, 20:40, 10:30] = 0
    acc = ci.conv_acc_plain(torch.from_numpy(frames), w).numpy()
    np.testing.assert_array_equal(
        acc, ci.conv_acc_plain(torch.from_numpy(_shifted(frames)), w).numpy())
    ref, _ = _jax_conv_int8(_shifted(frames), probe["w"][0], probe["w_scale"][0],
                            probe["bias"][0], np.float32(0.05), False)
    np.testing.assert_array_equal(acc, ref)
    assert acc[0, 0, 0].tolist() != acc[0, 5, 5].tolist()  # the border sees the padding


def test_pack_weight_and_cpu_dispatch(probe):
    """pack_weight: (Cout, Kpad) in (dy, dx, ci) order, zero past k * k * Cin
    (conv0: 75 -> 96); conv_int8 on a CPU tensor is the plain version, and
    another device raises."""
    launched = trace.counter("conv_int8.conv_int8")
    w = torch.from_numpy(probe["w"][0])
    pw = ci.pack_weight(w)
    assert pw.matrix.shape == (32, 96) and (pw.ksize, pw.cin) == (5, 3)
    assert not pw.matrix[:, 75:].any()
    assert torch.equal(pw.matrix[:, :75], w.permute(3, 0, 1, 2).reshape(32, 75))
    x = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3),
                                                          dtype=np.uint8))
    args = (torch.from_numpy(probe["w_scale"][0]), torch.from_numpy(probe["bias"][0]))
    assert torch.equal(ci.conv_int8(x, pw, *args, 0.05), ci.conv_int8_plain(x, w, *args, 0.05))
    assert torch.equal(ci.conv_int8_acc(x, w), ci.conv_acc_plain(x, pw))
    assert trace.counter("conv_int8.conv_int8") == launched
    with pytest.raises(RuntimeError, match="no int8 conv kernel"):
        ci.conv_int8(x.to("meta"), pw, *args, 0.05)
