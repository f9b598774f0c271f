"""The TimeSformer cell's parts: the frozen operation count, the traffic's
windows against the scanner's, the per-layer readers on synthetic readings,
and a small cell of the "sampled_window_scan" kind run whole on the CPU, with
its control, declared as data the way the cell is."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import COPIES, REPO, make_tiny_root
from benchmark.drivers import library_scan, sampled_window_scan
from benchmark.harness import flops, flops_timesformer, main, spec
from benchmark.harness.trace import DeviceOp, Trace
from video_fingerprint_tpu_torch.inference.family import family_for
from video_fingerprint_tpu_torch.utils import trace

CELL = "timesformer-library-long"
CONFIG = json.loads((REPO / "benchmark" / "configs" / "timesformer-base-full.json").read_text())
MIX = json.loads((REPO / "benchmark" / "traffic" / f"{CELL}.json").read_text())
TINY_CONFIG = {"model_type": "timesformer", "hidden_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 4, "intermediate_size": 256, "layer_norm_eps": 1e-6,
               "qkv_bias": True, "patch_size": 8, "frame_size": 32, "num_frames": 4,
               "clip_length": 16, "mean": [0.45, 0.45, 0.45], "std": [0.225, 0.225, 0.225],
               "embedding_dim": 32, "precision": "bf16"}
TINY_MIX = {"kind": "sampled_window_scan", "videos": 24, "batch_size": 8, "threshold": 0.99,
            "lengths": [{"share": 0.7, "source_frames": [33, 80]},
                        {"share": 0.3, "source_frames": [10, 16]}],
            "copies": COPIES, "check_videos": 12}
# above the program's readings at this size on the CPU (bf16: 3.0e-4 to 4.4e-4
# on four seeds when this was written), below the float8 control's (0.026 to
# 0.078 on three)
TINY_LIMITS = {"embedding_gap": 2e-3, "group_mismatch": 0, "missing_videos": 0}
CPU = torch.device("cpu")


def test_timesformer_window_flops_term_by_term():
    C, T, N, H, D, L, I, E = 768, 8, 196, 12, 64, 12, 3072, 256
    terms = {
        "patch_embedding": T * N * 768 * C,  # 16 x 16 x 3 pixels a patch
        "temporal_linear": L * N * T * (3 * C * C + C * C + C * C),
        "spatial_linear": L * T * (N + 1) * (3 * C * C + C * C),
        "mlp": L * (1 + N * T) * (C * I + I * C),
        "temporal_attention": L * (N * H) * 2 * T * T * D,
        "spatial_attention": L * (T * H) * 2 * (N + 1) ** 2 * D,
        "head": C * E,
    }
    assert flops_timesformer.window_macs(CONFIG) == terms
    total = flops_timesformer.window_flops(CONFIG)
    assert total == 2 * sum(terms.values()) == 391_660_339_200
    assert round(total / 1e9, 1) == 391.7  # "391.6 GFLOP" truncated
    temporal = terms["temporal_linear"] + terms["temporal_attention"]
    assert round(100 * temporal / sum(terms.values())) == 28  # the temporal half's share


def test_timesformer_k1_least_time():
    """Both kinds are bound by bytes at D = 64: q, k, v, o of 2,352 instances
    of 8 frames and 96 of 197 tokens, in bf16, every layer."""
    least = flops_timesformer.k1_least_seconds(CONFIG, flops.BF16_PEAK_FLOPS,
                                               flops.HBM_BYTES_PER_S)
    nbytes = 12 * (196 * 12 * 4 * 8 * 64 * 2 + 8 * 12 * 4 * 197 * 64 * 2)
    assert least == pytest.approx(nbytes / flops.HBM_BYTES_PER_S, rel=1e-12)


@pytest.mark.parametrize("source", [10, 64, 128, 257, 700, 1279, 1281, 2048, 3000, 6000])
def test_timesformer_traffic_windows_match_the_scanner(source):
    """The traffic's window plan and sampled frame times are the scanner's, for
    sources across the mix's length classes."""
    family = family_for("timesformer", CONFIG)
    want = [start + family.frames_of(length) for start, length in family.window_plan(source)]
    got = sampled_window_scan.sampled_windows(source, CONFIG)
    assert [w.tolist() for w in got] == [w.tolist() for w in want]
    assert all(0 <= w.min() and w.max() < source for w in got)


def test_timesformer_mix_sizes():
    """About 1,990 windows a scan (2.4 GB of uint8 frames staged), the same
    for every seed."""
    windows = []
    for seed in (1, 2**31 + 7):
        originals, copies, _ = library_scan._library_plan(MIX, np.random.default_rng([seed, 1]))
        sources = list(originals) + [src for _, _, src in copies]
        windows.append(sum(len(sampled_window_scan.sampled_windows(int(s), CONFIG))
                           for s in sources))
    assert windows[0] == windows[1]
    assert 1900 <= windows[0] <= 2100
    staged = windows[0] * CONFIG["num_frames"] * flops.frame_bytes(CONFIG)
    assert 2.2e9 < staged < 2.6e9


def _reading(config, ops=(), ranges=(), work=None):
    return SimpleNamespace(cell=SimpleNamespace(config=config),
                           trace=Trace(start=0.0, end=2e6, ops=list(ops), ranges=list(ranges)),
                           work=work or {"video_frames": [[8] * 5, [8] * 3]})


def _read(name, reading):
    return spec.metric_reader(REPO / "benchmark", name)(reading)


def test_timesformer_metric_readers_on_synthetic_readings(monkeypatch):
    k1 = DeviceOp("attention_bf16_kernel", "kernel", 0.0, 100.0, ("bench.window",))
    temporal = DeviceOp("gemm", "kernel", 100.0, 400.0, ("bench.window", "bench.temporal"))
    other = DeviceOp("gemm", "kernel", 400.0, 1000.0, ("bench.window",))
    ops = [k1, temporal, other]
    windows = 8
    mfu = _read("mfu.timesformer", _reading(CONFIG, ops))
    assert mfu == pytest.approx(100 * windows * 391_660_339_200 / 2.0 / flops.BF16_PEAK_FLOPS)
    least = windows * flops_timesformer.k1_least_seconds(CONFIG, flops.BF16_PEAK_FLOPS,
                                                         flops.HBM_BYTES_PER_S)
    assert _read("k1_roofline.timesformer", _reading(CONFIG, ops)) == pytest.approx(
        100 * least / 100e-6)
    assert _read("temporal_share.timesformer", _reading(CONFIG, ops)) == pytest.approx(30.0)
    record = trace.Record(counts={"k1.rows_launched": 14_592, "k1.rows_useful": 3_144})
    monkeypatch.setattr(trace, "recorded", lambda: record)
    fill = _read("k1_tile_fill.timesformer", _reading(CONFIG, ops))
    assert round(fill, 1) == 21.5
    # nothing to read: another model, no device work, no such kernels or counters
    attention_config = {"model_type": "attention"}
    assert _read("mfu.timesformer", _reading(attention_config, ops)) is None
    assert _read("k1_roofline.timesformer", _reading(attention_config, ops)) is None
    assert _read("k1_tile_fill.timesformer", _reading(CONFIG)) is None
    assert _read("temporal_share.timesformer", _reading(CONFIG, [k1, other])) is None
    monkeypatch.setattr(trace, "recorded", lambda: trace.Record())
    assert _read("k1_tile_fill.timesformer", _reading(CONFIG, ops)) is None


def test_timesformer_cell_is_declared():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = spec.load_cell(REPO, CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "sampled_window_scan"
    assert [m["name"] for m in cell.end_to_end] == ["scan_videos_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert {"mfu.timesformer", "k1_roofline.timesformer", "temporal_share.timesformer",
            "k1_tile_fill.timesformer", "device_idle_share.scan"} <= names
    assert "mfu.scan" not in names
    entry = next(c for c in bench["configs"] if c["name"] == cell.config_name)
    assert entry["reduced"] == cell.config["reduced"] == []


@pytest.fixture(scope="module")
def tiny_timesformer_root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("checkout"))
    bench = root / "benchmark"
    (bench / "configs" / "tiny-timesformer.json").write_text(json.dumps(TINY_CONFIG))
    (bench / "traffic" / "tiny-tsf-scan.json").write_text(json.dumps(TINY_MIX))
    (bench / "limits" / "tiny-tsf-scan.json").write_text(json.dumps(TINY_LIMITS))
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "tiny-timesformer", "source": "a test's", "reduced": [],
                            "file": "benchmark/configs/tiny-timesformer.json",
                            "why": "a test's"})
    data["workloads"].append({"name": "tiny-tsf-scan", "config": "tiny-timesformer",
                              "traffic": "tiny-tsf-scan", "chips": 1, "why": "a test's"})
    for metric in data["end_to_end"] + data["per_layer"]:
        if CELL in metric.get("workloads", ()):
            metric["workloads"].append("tiny-tsf-scan")
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    return root


def test_timesformer_tiny_cell_runs_correct(tiny_timesformer_root):
    root = tiny_timesformer_root
    line = main.run_cell(root, "tiny-tsf-scan", 2**31 + 11, 0.5, False, CPU, time.perf_counter(),
                         root / "benchmark")
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"scan_videos_per_s", "setup_s"}
    assert line["checks"]["embedding_gap"]["value"] < TINY_LIMITS["embedding_gap"]
    assert line["checks"]["group_mismatch"]["value"] == 0
    traced = main.run_cell(root, "tiny-tsf-scan", 2**31 + 12, 0.5, True, CPU, time.perf_counter(),
                           root / "benchmark")
    assert traced["correct"] is True
    # no device trace on the CPU: only the operations over the window are read
    assert set(traced["metrics"]) <= {"mfu.timesformer"}


def test_timesformer_tiny_control_is_outside_the_limit(tiny_timesformer_root):
    root = tiny_timesformer_root
    cell = spec.load_cell(root, "tiny-tsf-scan", root / "benchmark")
    kind = spec.driver(root / "benchmark", cell)
    numbers = kind.control(cell, 2**31 + 13, CPU, root)
    assert numbers["embedding_gap"] > TINY_LIMITS["embedding_gap"]


def test_timesformer_planted_copies_reported():
    """The driver's report of a scan's planted copies: a byte copy grouped
    with its original, a trimmed copy left out, and the cosines."""
    videos = [library_scan.Video(path=f"v{i}", file_hash="", source=300) for i in range(4)]
    videos[2].copy_of, videos[2].byte_copy = 0, True
    videos[3].copy_of = 1
    trimmed = np.array([0.1, 0.995, 0.0])
    embeddings = [[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0], trimmed]
    fingerprints = {v.path: {"embedding": np.asarray(e)} for v, e in zip(videos, embeddings)}
    state = {"library": SimpleNamespace(videos=videos)}
    got = sampled_window_scan.planted(state, fingerprints, [["v0", "v2"]])
    unrelated = 0.1 / np.linalg.norm(trimmed)
    assert got == pytest.approx({
        "groups": 1, "videos_grouped": 2, "unrelated_cos_max": unrelated,
        "byte_copies": 1, "byte_copies_grouped": 1, "byte_copy_cos_min": 1.0,
        "trimmed_copies": 1, "trimmed_copies_grouped": 0,
        "trimmed_copy_cos_min": 0.995 / np.linalg.norm(trimmed)})
