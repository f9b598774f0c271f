"""window_reduce_share.scan, read from the program's `scan.reduce_windows`
spans (video_fingerprint_tpu_torch/utils/trace.py): its percentage of a
synthetic window, and nothing where the program has no trace module,
recorded no such span (the attention scan, or a program older than the
span), or the window ran nothing on a card."""

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
NAME = "window_reduce_share.scan"
WINDOW_US = 2e6  # a 2 s window


def _reading(ops=True):
    busy = [DeviceOp("k", "kernel", 0.0, 10.0)] if ops else []
    return SimpleNamespace(trace=Trace(start=0.0, end=WINDOW_US, ops=busy), work={})


@pytest.fixture
def record(monkeypatch):
    synthetic = trace.Record(self_seconds={"scan.reduce_windows": 0.03, "embed.fill": 1.2},
                             counts={"scan.windows_reduced": 2180, "scan.videos_reduced": 512})
    monkeypatch.setattr(trace, "recorded", lambda: synthetic)
    return synthetic


def test_benchmark_window_reduce_share_is_declared_for_the_3d_cell():
    declared = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())
                ["per_layer"]}
    assert declared[NAME]["source"] == "program_span"
    assert declared[NAME]["moves"] == "scan_videos_per_s"
    assert declared[NAME]["workloads"] == ["cnn3d-library-long"]


def test_benchmark_window_reduce_share_on_a_recorded_span(record):
    # 0.03 s of self time in a 2 s window; the other spans are not its
    assert spec.metric_reader(BENCH, NAME)(_reading()) == pytest.approx(1.5)


@pytest.mark.parametrize("case", ["no trace module", "no span", "no device work"])
def test_benchmark_window_reduce_share_absent(record, monkeypatch, case):
    if case == "no trace module":  # a program without utils/trace.py
        monkeypatch.setitem(sys.modules, "video_fingerprint_tpu_torch.utils.trace", None)
    elif case == "no span":  # an attention scan, or a program without the span
        monkeypatch.setattr(trace, "recorded",
                            lambda: trace.Record(self_seconds={"embed.fill": 1.2}))
    assert spec.metric_reader(BENCH, NAME)(_reading(ops=case != "no device work")) is None
