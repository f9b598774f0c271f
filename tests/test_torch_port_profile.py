"""The stage profile (video_fingerprint_tpu_torch/tools/profile_extraction.py
and its thin entry points exp_stack_roofline.py / exp_conv_hotspot.py) on
the CPU:

- its stages, the model's own modules chained, equal `forward_flat` bit for
  bit in f32 (BatchNorm folded and as is, with and without a frame mask);
- `widen_kernel` equals the root tool's, and the widened conv0 equals the
  JAX conv with that kernel (JAX's asymmetric padding, stride (2, 2G)) and,
  unpacked, the plain conv0 (f32, 1e-5: the same products summed in
  another order);
- the space-to-depth kernel equals the JAX package's (exactly), and the
  s2d conv equals the JAX 5x5 stride-2 conv (f32, 1e-5);
- the roofline counts equal a hand count at N = 16,384 frames (128 videos),
  the full leg's operations `utils/flops.py::forward_flops`;
- each tool runs end to end at small widths, with no time measured (a CUDA
  graph needs a card).
"""

import numpy as np
import pytest
import torch

from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict, space_to_depth_kernel
from video_fingerprint_tpu_torch.models.layers import space_to_depth
from video_fingerprint_tpu_torch.tools import exp_conv_hotspot, exp_stack_roofline
from video_fingerprint_tpu_torch.tools import profile_extraction as pe
from video_fingerprint_tpu_torch.tools.bench_common import seeded_state_dict
from video_fingerprint_tpu_torch.utils.flops import forward_flops

SMALL = {"spatial_dim": 16, "temporal_dim": 32, "embedding_dim": 32}


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _model(fused: bool, **widths):
    sd = seeded_state_dict(0, **widths)
    model = create_model("attention", fused=fused, **widths)
    sd = fuse_state_dict(sd) if fused else sd
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "fused"])
def test_stages_chain_to_forward_flat(fused):
    model = _model(fused, **SMALL)
    B, T = 3, 6
    flat = pe.seeded_frames(0, B, T, torch.device("cpu"))
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[1, 4:] = False
    with torch.no_grad():
        for m in (None, mask):
            ours = pe.chained_forward(model, flat, B, m)
            ref = model.forward_flat(flat, B, m)
            assert torch.equal(ours, ref)
        legs = {leg: pe.stack_leg(model, leg, B)(flat) for leg in pe.STACK_LEGS}
    assert torch.equal(legs["spatial"], model._encode_flat(flat))
    assert torch.equal(legs["full"], model.forward_flat(flat, B))
    assert legs["conv0_3"].shape == (B * T, 256, 4, 4)


@pytest.mark.parametrize("group", pe.WIDE_GROUPS)
def test_widened_conv0_matches_root_tool_and_jax(group):
    import jax
    import jax.numpy as jnp
    from jax import lax

    from tools.exp_conv_hotspot import widen_kernel as root_widen_kernel

    rng = np.random.default_rng(group)
    w = rng.normal(size=(5, 5, 3, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    ours, ours_b = pe.widen_kernel(w, b, group)
    ref, ref_b = root_widen_kernel(w, b, group)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours_b, ref_b)

    conv0 = torch.nn.Conv2d(3, 32, 5, stride=2, padding=2)
    with torch.no_grad():
        conv0.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        conv0.bias.copy_(torch.from_numpy(b))
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        wide = pe.wide_conv0(conv0, group)(xt)
        plain = torch.relu(conv0(xt))
    pad_hi = max(0, 2 * group * (32 // group - 1) + ref.shape[1] - 66)
    y = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(ref), (2, 2 * group),
                                 ((2, 2), (2, pad_hi)),
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                 precision=jax.lax.Precision.HIGHEST)
    y = np.asarray(jax.nn.relu(y + ref_b))
    np.testing.assert_allclose(wide.permute(0, 2, 3, 1).numpy(), y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pe.unpack_wide(wide, group).numpy(), plain.numpy(),
                               rtol=0, atol=1e-5)


def test_s2d_conv_matches_jax():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from video_fingerprint_tpu.models.fuse import space_to_depth_kernel as jax_s2d_kernel

    rng = np.random.default_rng(3)
    w5 = rng.normal(size=(32, 3, 5, 5)).astype(np.float32)  # OIHW
    k3 = space_to_depth_kernel(w5)
    np.testing.assert_array_equal(k3.transpose(2, 3, 1, 0),
                                  jax_s2d_kernel(w5.transpose(2, 3, 1, 0)))
    x = rng.random((2, 64, 64, 3), dtype=np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours = torch.nn.functional.conv2d(space_to_depth(xt), torch.from_numpy(k3), padding=1)
    ref = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w5.transpose(2, 3, 1, 0)),
                                   (2, 2), ((2, 2), (2, 2)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)


def test_roofline_counts_by_hand():
    model = create_model("attention", fused=True)
    N, B = 16_384, 128
    e = 2
    counts = pe.stack_counts(model, N, B)
    hand, flops = [N * 64 * 64 * 3 * (1 + e)], [0]
    for (c_in, s_in), (c_out, s_out, k) in zip(
            [(3, 64), (32, 32), (64, 16), (128, 8)],
            [(32, 32, 5), (64, 16, 3), (128, 8, 3), (256, 4, 3)]):
        hand.append(N * (c_in * s_in ** 2 + c_out * s_out ** 2) * e)
        flops.append(N * 2 * s_out ** 2 * c_out * c_in * k * k)
    hand.append(N * (256 * 16 + 128) * e)
    flops.append(N * 2 * 256 * 128)
    hand.append(N * 128 * e + B * 256 * 4)
    for i, leg in enumerate(pe.STACK_LEGS[:-1]):
        assert counts[leg] == {"bytes": sum(hand[:i + 1]), "flops": sum(flops[:i + 1])}, leg
    assert counts["full"]["bytes"] == sum(hand)
    assert counts["full"]["flops"] == forward_flops(model, B, N // B, 64)
    b = pe.bound(counts["conv0"]["bytes"], counts["conv0"]["flops"])
    assert b["byte_bound_ms"] == pytest.approx(sum(hand[:2]) / 3.35e12 * 1e3)
    assert b["flop_bound_ms"] == pytest.approx(flops[1] / 989.4e12 * 1e3)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["byte_bound_ms"]


def test_tools_run_on_cpu(capsys):
    result = pe.run(pe.parse_args(["--device", "cpu", "--batch", "2", "--frames", "4",
                                   "--spatial_dim", "16", "--temporal_dim", "32",
                                   "--embedding_dim", "32"]))
    assert result["chained_vs_forward_flat_maxerr"] == 0.0
    assert set(result["split"]) == {"f32", "bf16", "fused-f32", "fused-bf16"}
    assert all(v is None for row in result["split"].values() for v in row.values())
    assert list(result["stack"]) == list(pe.STACK_LEGS)
    assert all(result["stack"][leg]["benchmark_off"] is None for leg in pe.STACK_LEGS)
    assert result["conv0"]["wide4_vs_ref_maxerr"] <= 1e-5  # f32, sums in another order
    assert result["conv0"]["s2d_f32_vs_k5s2_maxerr"] <= 1e-5
    assert "kernels" not in result  # the profiler's device kernels need a card
    assert exp_stack_roofline.main(["--device", "cpu", "--n", "8", "--b", "2",
                                    "--spatial_dim", "16", "--temporal_dim", "32",
                                    "--embedding_dim", "32"]) == 0
    assert exp_conv_hotspot.main(["--device", "cpu", "--n", "64"]) == 0
    assert '"conv0_wide8"' in capsys.readouterr().out
