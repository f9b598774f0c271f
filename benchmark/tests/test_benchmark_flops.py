"""The frozen operation count and each per-layer reader, on hand-computed shapes."""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest

from conftest import REPO
from benchmark.harness import flops
from benchmark.harness.trace import DeviceOp, Trace

FULL = {"model_type": "attention", "spatial_dim": 128, "temporal_dim": 256, "embedding_dim": 256,
        "num_attention_blocks": 4, "num_heads": 8, "frame_size": 64, "max_frames": 500,
        "precision": "bf16"}
CNN3D = {"model_type": "3d", "embedding_dim": 256, "frame_stride": 32, "clip_length": 128,
         "frame_size": 64, "precision": "bf16"}


def _reader(name):
    path = REPO / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reading(config, work, ops, window_us=1e6, ranges=()):
    trace = Trace(start=0.0, end=window_us, ops=ops, ranges=list(ranges))
    return SimpleNamespace(cell=SimpleNamespace(config=config), trace=trace, work=work)


@pytest.mark.parametrize("frames", [1, 10, 128, 333, 500])
def test_benchmark_frozen_count_equals_the_programs(frames):
    from video_fingerprint_tpu_torch.models import create_model
    from video_fingerprint_tpu_torch.utils import flops as program_flops

    model = create_model("attention")
    assert flops.attention_video_flops(FULL, frames) == \
        program_flops.forward_flops(model, 1, frames)
    assert flops.frame_flops(FULL) == program_flops.frame_flops(model)


def test_benchmark_3d_count_by_hand():
    # 128 frames, stride 32: 4 x 32 x 32 outputs of 16 channels, each 3*32*25
    # multiply-adds; then 4x16x16x32x(16*27), 2x8x8x64x(32*27), 2x4x4x128x(64*27)
    macs = [4 * 32 * 32 * 16 * 3 * 32 * 25, 4 * 16 * 16 * 32 * 16 * 27,
            2 * 8 * 8 * 64 * 32 * 27, 2 * 4 * 4 * 128 * 64 * 27]
    assert flops.cnn3d_encoder_flops(CNN3D, 128) == 2 * sum(macs)
    head = 2 * (2 * (128 * 128 * 3 + 128) + 128 * 128 + 128 * 256)
    assert flops.cnn3d_window_flops(CNN3D, 128) == 2 * sum(macs) + head
    assert flops.cnn3d_encoder_flops(CNN3D, 100) == flops.cnn3d_encoder_flops(CNN3D, 128)
    assert flops.cnn3d_encoder_out_bytes(CNN3D, 128) == 128 * 2 * 4 * 4 * 2


def test_benchmark_k1_roofline_by_hand():
    # one video of 500 frames, 4 blocks of C = 256: 4 T^2 C = 2.56e8 operations
    # (0.2587 us at 989.4e12) against 4 T C 2 + T = 1,024,500 bytes (0.30582 us
    # at 3.35e12): byte-bound; K1's kernels took 10 us in all
    ops = [DeviceOp("void (anonymous namespace)::attention_bf16<32, true>(Params, float)",
                    "kernel", 0.0, 10.0)]
    share = _reader("k1_roofline.attn")(_reading(FULL, {"video_frames": [500]}, ops))
    assert share == pytest.approx(100 * 4 * (4 * 500 * 256 * 2 + 500) / 3.35e12 / 10e-6)


def test_benchmark_encoder_roofline_by_hand():
    frames = 1000
    conv_ops = 2 * (2457600 + 4718592 * 3 + 256 * 128)
    assert flops.frame_flops(FULL) == conv_ops
    ops = [DeviceOp("conv", "kernel", 0.0, 500.0, ("bench.scan", "bench.spatial_encoder")),
           DeviceOp("elsewhere", "kernel", 600.0, 900.0, ("bench.scan",))]
    ranges = [("bench.spatial_encoder", 0.0, 550.0)]
    share = _reader("encoder_roofline.attn")(
        _reading(FULL, {"video_frames": [frames]}, ops, ranges=ranges))
    assert share == pytest.approx(100 * frames * conv_ops / 989.4e12 / 500e-6)


def test_benchmark_topk_roofline_by_hand():
    # 256 queries x 10^6 rows x 256: 1.31e11 operations (0.1325 ms) against
    # 1.024e9 + 262,144 + 61,440 bytes (0.30577 ms): byte-bound
    work = {"calls": 3, "queries_per_call": 256, "index_rows": 10**6, "dim": 256, "k": 20}
    ops = [DeviceOp("gemm", "kernel", i * 1e4, i * 1e4 + 1e4, ("bench.find_duplicates_against",))
           for i in range(3)]
    share = _reader("topk_roofline.search")(_reading(FULL, work, ops, window_us=3e4))
    least = (4 * 10**6 * 256 + 4 * 256 * 256 + 12 * 256 * 20) / 3.35e12
    assert share == pytest.approx(100 * 3 * least / 30e-3)
    assert share < 100


def test_benchmark_mfu_readers_by_hand():
    ops = [DeviceOp("k", "kernel", 0.0, 1.0)]
    mfu = _reader("mfu.scan")(_reading(FULL, {"video_frames": [500, 10]}, ops, window_us=2e6))
    total = flops.attention_video_flops(FULL, 500) + flops.attention_video_flops(FULL, 10)
    assert mfu == pytest.approx(100 * total / 2.0 / 989.4e12)
    mfu3d = _reader("mfu.scan")(_reading(CNN3D, {"video_frames": [[128, 128, 128]]}, ops))
    assert mfu3d == pytest.approx(100 * 3 * flops.cnn3d_window_flops(CNN3D, 128) / 989.4e12)
    work = {"calls": 10, "queries_per_call": 256, "index_rows": 10**6, "dim": 256, "k": 20}
    assert _reader("mfu.search")(_reading(FULL, work, ops)) == \
        pytest.approx(100 * 10 * 2 * 256 * 10**6 * 256 / 989.4e12)


@pytest.mark.parametrize("name", ["encoder_roofline.attn", "k1_roofline.attn",
                                  "encoder_roofline.cnn3d", "topk_roofline.search",
                                  "device_idle_share.scan"])
def test_benchmark_reader_without_kernels_reads_nothing(name):
    work = {"video_frames": [], "calls": 0, "queries_per_call": 1, "index_rows": 1, "dim": 1,
            "k": 1}
    assert _reader(name)(_reading(FULL, work, [])) is None
