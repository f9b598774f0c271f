"""The per-layer metrics read from the program's own spans and counters
(video_fingerprint_tpu_torch/utils/trace.py), on a synthetic record and
window: their percentages, and nothing where the program has no trace
module, recorded nothing, or the window ran nothing on a card."""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest

from conftest import REPO
from benchmark.harness import spec
from benchmark.harness.trace import DeviceOp, Trace
from video_fingerprint_tpu_torch.utils import trace

BENCH = REPO / "benchmark"
WINDOW_US = 2e6  # a 2 s window
SELF_SECONDS = {"embed.fill": 0.5, "embed.slot_wait": 0.1, "embed.readback_wait": 0.3,
                "embed.forward": 0.04, "embed.batch": 0.2, "against.prepare": 0.02,
                "against.group": 0.18, "topk.sync": 0.6, "index.upload": 0.01,
                "index.readback": 0.09, "index.search": 0.16, "against.call": 0.05}
COUNTS = {"embed.frames_staged": 510_720, "embed.frames_useful": 461_564}
EXPECTED = {
    "stage_fill_share.scan": 25.0,  # 0.5 s of 2 s
    "stage_wait_share.scan": 20.0,  # 0.1 + 0.3
    "forward_dispatch_share.scan": 2.0,
    "padded_frame_share.scan": 100.0 * 49_156 / 510_720,
    "against_host_share.search": 10.0,  # 0.02 + 0.18
    "topk_wait_share.search": 35.0,  # 0.6 + 0.01 + 0.09
    "topk_launch_share.search": 8.0,
}


def _reading(ops=True):
    busy = [DeviceOp("k", "kernel", 0.0, 10.0)] if ops else []
    return SimpleNamespace(trace=Trace(start=0.0, end=WINDOW_US, ops=busy), work={})


@pytest.fixture
def record(monkeypatch):
    synthetic = trace.Record(self_seconds=dict(SELF_SECONDS), counts=dict(COUNTS))
    monkeypatch.setattr(trace, "recorded", lambda: synthetic)
    return synthetic


def test_benchmark_program_metrics_are_declared():
    per_layer = json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
    declared = {m["name"]: m for m in per_layer}
    for name in EXPECTED:
        assert declared[name]["source"] in ("program_span", "program_counter")
        assert declared[name]["workloads"] == (["search-against-1m"] if name.endswith("search")
                                               else ["attn-library-long"])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_benchmark_program_metric_on_a_synthetic_record(record, name):
    assert spec.metric_reader(BENCH, name)(_reading()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_benchmark_program_metric_absent_without_the_trace_module(record, monkeypatch, name):
    """The parent commit's program has no utils/trace.py: the reader gives
    nothing and raises nothing."""
    monkeypatch.setitem(sys.modules, "video_fingerprint_tpu_torch.utils.trace", None)
    assert spec.metric_reader(BENCH, name)(_reading()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_benchmark_program_metric_absent_when_nothing_was_recorded(monkeypatch, name):
    monkeypatch.setattr(trace, "recorded", lambda: trace.Record())
    assert spec.metric_reader(BENCH, name)(_reading()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_benchmark_program_metric_absent_without_device_work(record, name):
    assert spec.metric_reader(BENCH, name)(_reading(ops=False)) is None
